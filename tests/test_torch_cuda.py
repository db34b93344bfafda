"""GPU-only tests: each CUDA kernel of the port against its plain PyTorch
version, and the wrapper's argument checks; the port's paths on the card
against the CPU (encoders, reader, BM25, the image towers and the face
cascade) and without host reads where a serving step must not wait. They
skip without a GPU (a CUDA kernel has no CPU mode). This file imports no JAX, so it also runs on
a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""
import copy

import numpy as np
import pytest
import torch

from torch_helpers import bf16_ulp_distance, within_reorder_bound
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import dpr as tdpr
from viquae_torch.models import layers as TL
from viquae_torch.ops import mips as tm
from viquae_torch.ops import mips_fused as tmf
from viquae_torch.ops import packing

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _int_inputs(dev, q_count, n, dim, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-4, 5, (q_count, dim), generator=gen, device=dev)
    kb = torch.randint(-4, 5, (n, dim), generator=gen, device=dev)
    return q.to(torch.bfloat16), kb.to(torch.bfloat16)


@pytest.mark.parametrize("q_count,n,dim,valid", [
    (77, 1024, 64, 1000), (77, 1024, 64, 0), (1, 128, 8, 128),
    (130, 512, 40, 300), (64, 256, 768, 256),
])
def test_kernel_bit_identical_on_integers(cuda, q_count, n, dim, valid):
    """Integer inputs in [-4, 4]: every f32 sum is exact (d <= 768 keeps
    them below 2^24), so kernel and plain version agree bit for bit —
    ragged query edge, d not a multiple of the depth step, and a
    valid_rows that cuts a segment included."""
    q, kb = _int_inputs(cuda, q_count, n, dim, seed=q_count + n)
    before = tmf.fused_score_segmax_qmajor.launches
    s, m = tmf.fused_score_segmax_qmajor(q, kb, valid)
    torch.cuda.synchronize()
    assert tmf.fused_score_segmax_qmajor.launches == before + 1
    ps, pm = tmf.fused_score_segmax_qmajor_plain(q, kb, valid)
    assert torch.equal(s.view(torch.int16), ps.view(torch.int16))
    assert torch.equal(m.view(torch.int16), pm.view(torch.int16))


def test_kernel_within_reorder_bound_on_gaussian(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((300, 768), generator=gen, device=cuda).to(torch.bfloat16)
    kb = torch.randn((8192, 768), generator=gen, device=cuda).to(
        torch.bfloat16)
    s, m = tmf.fused_score_segmax_qmajor(q, kb, 8000)
    ps, _ = tmf.fused_score_segmax_qmajor_plain(q, kb, 8000)
    a, b = s.float().cpu().numpy(), ps.float().cpu().numpy()
    # near-zero scores come from cancellation: there the two summation
    # orders may differ by many ulps of the tiny result, so the criterion
    # is the float32 reordering bound plus one bf16 ulp
    assert within_reorder_bound(q.float().cpu().numpy(),
                                kb.float().cpu().numpy(), a, b).all()
    assert (bf16_ulp_distance(a, b) == 0).mean() >= 0.999
    own = s.view(300, -1, 128).amax(-1)
    assert torch.equal(m.view(torch.int16), own.view(torch.int16))


def test_topk_fused_on_gpu_matches_plain_selection(cuda):
    q, kb = _int_inputs(cuda, 50, 2048, 64, seed=3)
    for chunks in (1, 2):
        s, i = tmf.topk_fused(q, kb, 30, valid_rows=2000, chunks=chunks)
        ps, pi = tmf.segment_topk(
            *tmf.fused_score_segmax_qmajor_plain(q, kb, 2000), 30)
        assert i.max().item() < 2000
        np.testing.assert_array_equal(s.cpu().numpy(), ps.cpu().numpy())
        if chunks == 1:
            np.testing.assert_array_equal(i.cpu().numpy(), pi.cpu().numpy())


def test_dense_index_on_gpu_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    kb = rng.integers(-4, 5, (1000, 32)).astype(np.float32)
    q = rng.integers(-4, 5, (20, 32)).astype(np.float32)
    gpu = tm.DenseIndex(kb, mode="fused", device=cuda).search_batch(q, k=10)
    cpu = tm.DenseIndex(kb, mode="fused", device="cpu").search_batch(q, k=10)
    np.testing.assert_array_equal(gpu[0], cpu[0])
    np.testing.assert_array_equal(gpu[1], cpu[1])


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, kb = _int_inputs(cuda, 8, 256, 64, seed=1)
    with pytest.raises(TypeError):
        tmf.fused_score_segmax_qmajor(q.float(), kb, 256)
    with pytest.raises(ValueError, match="contiguous"):
        tmf.fused_score_segmax_qmajor(q.t().contiguous().t(), kb, 256)
    with pytest.raises(ValueError, match="multiple of 128"):
        tmf.fused_score_segmax_qmajor(q, kb[:200], 200)
    with pytest.raises(ValueError, match="multiple of 8"):
        tmf.fused_score_segmax_qmajor(q[:, :60].contiguous(),
                               kb[:, :60].contiguous(), 256)
    with pytest.raises(ValueError, match="valid_rows"):
        tmf.fused_score_segmax_qmajor(q, kb, 257)
    with pytest.raises(ValueError, match="CUDA device"):
        tmf.fused_score_segmax_qmajor(q.cpu(), kb, 256)
    # contiguous, but 2 bytes past a 16-byte boundary
    shifted = torch.empty(256 * 64 + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(256, 64)
    shifted.copy_(kb)
    with pytest.raises(ValueError, match="16-byte"):
        tmf.fused_score_segmax_qmajor(q, shifted, 256)


def test_bf16_gemm_dense_matches_f32_upcast(cuda):
    """On the card ``dense`` takes bf16 operands to a tensor-core GEMM with
    an f32 result; the CPU takes the f32 product of the upcast operands.
    The products are exact in f32 either way, so the two differ only in
    how the f32 sums are taken. Each is within g_d(v) sum_i |x_i w_i| of
    the exact sum, with v = 2^-24 for round-to-nearest adds and 2^-23 for
    tensor-core adds that truncate, so they differ by at most the sum of
    the two."""
    torch.manual_seed(0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    lin = torch.nn.Linear(768, 3072, device=cuda, dtype=torch.bfloat16)
    x = torch.randn((640, 768), generator=gen, device=cuda).to(torch.bfloat16)
    got = TL.dense(lin, x, torch.bfloat16)
    ref = TL._dot_f32_upcast(x, lin.weight) + lin.bias

    def gamma(v, d=768):
        return d * v / (1 - d * v)

    assert got.dtype == ref.dtype == torch.float32
    bound = (gamma(2.0 ** -24) + gamma(2.0 ** -23)) * (
        x.float().abs() @ lin.weight.float().abs().t())
    assert ((got - ref).abs() <= bound).all()


def test_bf16_gemm_encoder_matches_f32_upcast(cuda, monkeypatch):
    """The packed DPR encoder with bf16 weights and compute, its dense
    layers on the bf16 GEMM, against the same forward with every dense
    product taken on the upcast operands. Each dense output is cast to bf16
    again before the next product, and the attention probabilities are
    rounded to bf16, so the last-place differences of the f32 sums can
    flip a rounding: the CLS outputs agree to within bf16 resolution,
    rtol = atol = 2e-2 (as test_torch_bert holds the port to JAX)."""
    cfg = tdpr.DPRConfig(bert=tbert.BertConfig(
        vocab_size=3000, hidden_size=256, num_hidden_layers=4,
        num_attention_heads=4, intermediate_size=1024,
        max_position_embeddings=64, add_pooler=False))
    model = convert.params_from_jax(convert.init_tree(cfg, seed=0), cfg,
                                    device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1000, 3000, n).astype(np.int32)
            for n in rng.integers(8, 40, 200)]
    p = packing.pack_token_sequences(seqs, 64, pad_rows_to=32, n_cls=256)
    canvas = [torch.from_numpy(a).to(cuda) for a in (
        p.input_ids, p.segment_ids, p.position_ids, p.cls_rows, p.cls_cols)]
    with torch.no_grad():
        got = tdpr.apply_packed(model, cfg, *canvas,
                                compute_dtype=torch.bfloat16)[:200]
        monkeypatch.setattr(TL, "_dot_f32", TL._dot_f32_upcast)
        ref = tdpr.apply_packed(model, cfg, *canvas,
                                compute_dtype=torch.bfloat16)[:200]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)


# ---- kernel B2 (kb-major) ------------------------------------------------
def _b2_equal(a, b):
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(bits), b.view(bits))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("q_count,n,dim", [
    (77, 1024, 64), (1, 128, 8), (130, 512, 40), (64, 256, 768),
    (200, 384, 24),
])
def test_b2_bit_identical_on_integers(cuda, dtype, q_count, n, dim):
    """Integer inputs in [-4, 4]: every f32 sum is exact, so the kb-major
    kernel and its plain version agree bit for bit in scores_t and
    segmax_t — ragged query edge and d not a multiple of the depth step
    included."""
    q, kb = _int_inputs(cuda, q_count, n, dim, seed=q_count + n)
    q, kb = q.to(dtype), kb.to(dtype)
    before = tmf.fused_score_segmax.launches
    s, m = tmf.fused_score_segmax(q, kb)
    torch.cuda.synchronize()
    assert tmf.fused_score_segmax.launches == before + 1
    assert s.shape == (n, q_count) and s.dtype == dtype
    assert m.shape == (n // 128, q_count) and m.dtype == torch.float32
    ps, pm = tmf.fused_score_segmax_plain(q, kb)
    assert _b2_equal(s, ps) and _b2_equal(m, pm)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_b2_within_reorder_bound_on_gaussian(cuda, dtype):
    """Gaussian inputs: each f32 sum lies within the float32 reordering
    bound of the plain version's (plus one bf16 ulp for the rounded bf16
    scores); the maxima are of unrounded sums, so within the bound alone."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((300, 768), generator=gen, device=cuda).to(dtype)
    kb = torch.randn((4096, 768), generator=gen, device=cuda).to(dtype)
    s, m = tmf.fused_score_segmax(q, kb)
    ps, pm = tmf.fused_score_segmax_plain(q, kb)
    qn, kbn = q.float().cpu().numpy(), kb.float().cpu().numpy()
    a, b = s.float().cpu().numpy().T, ps.float().cpu().numpy().T
    if dtype == torch.bfloat16:
        assert within_reorder_bound(qn, kbn, a, b).all()
        assert (bf16_ulp_distance(a, b) == 0).mean() >= 0.999
    d = qn.shape[1]
    bound = 2 * d * 2.0 ** -24 / (1 - d * 2.0 ** -24) * (
        np.abs(kbn) @ np.abs(qn).T)
    if dtype == torch.float32:
        assert (np.abs(a.T - b.T) <= bound).all()
    seg_bound = bound.reshape(-1, 128, 300).max(1)
    assert (np.abs(m.cpu().numpy() - pm.cpu().numpy()) <= seg_bound).all()


def test_b2_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, kb = _int_inputs(cuda, 8, 256, 64, seed=2)
    with pytest.raises(TypeError, match="one dtype"):
        tmf.fused_score_segmax(q.float(), kb)
    with pytest.raises(TypeError, match="one dtype"):
        tmf.fused_score_segmax(q.half(), kb.half())
    with pytest.raises(ValueError, match="contiguous"):
        tmf.fused_score_segmax(q.t().contiguous().t(), kb)
    with pytest.raises(ValueError, match="multiple of 128"):
        tmf.fused_score_segmax(q, kb[:200])
    with pytest.raises(ValueError, match="multiple of 4"):
        tmf.fused_score_segmax(q[:, :62].float().contiguous(),
                               kb[:, :62].float().contiguous())
    with pytest.raises(ValueError, match="CUDA device"):
        tmf.fused_score_segmax(q.cpu(), kb)
    shifted = torch.empty(256 * 64 + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(256, 64)
    shifted.copy_(kb)
    with pytest.raises(ValueError, match="16-byte"):
        tmf.fused_score_segmax(q, shifted)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_topk_pallas_on_gpu_matches_cpu(cuda, dtype):
    """Integer inputs past bf16's mantissa: the same sums on the card and
    the CPU, so the same ids and scores, boundary segment included."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randint(-30, 31, (50, 16), generator=gen, device=cuda).to(dtype)
    kb = torch.randint(-30, 31, (2000, 16), generator=gen,
                       device=cuda).to(dtype)
    for valid in (None, 1900, 1792):
        s, i = tmf.topk_pallas(q, kb, 30, valid_rows=valid)
        cs, ci = tmf.topk_pallas(q.cpu(), kb.cpu(), 30, valid_rows=valid)
        np.testing.assert_array_equal(i.cpu().numpy(), ci.numpy())
        np.testing.assert_array_equal(s.cpu().numpy(), cs.numpy())


# ---- the shared Hopper mainloop (128 x 256 tiles, persistent) -----------
# Shapes that stress the tiling of B1 and B2 (both dtypes): N not a multiple
# of the 256-column tile (the last B1 tile half empty), more tiles than SMs
# (the persistent loop wraps), a ragged query edge against the 128- and
# 256-query tiles, d below, between and at multiples of the 64-deep stage.
_TILING_SHAPES = [
    (77, 384, 64), (130, 640, 40), (1257, 1408, 24), (1, 1408, 8),
    (1, 384, 768), (1280, 65664, 768),
]


@pytest.mark.parametrize("q_count,n,dim", _TILING_SHAPES)
def test_b1_tiling_bit_identical_on_integers(cuda, q_count, n, dim):
    """valid_rows = 0, one that cuts the last (half-empty) 256-column tile
    and N: scores and maxima bit for bit against the plain version."""
    q, kb = _int_inputs(cuda, q_count, n, dim, seed=q_count * 7 + n + dim)
    for valid in (0, n - 64, n):
        s, m = tmf.fused_score_segmax_qmajor(q, kb, valid)
        ps, pm = tmf.fused_score_segmax_qmajor_plain(q, kb, valid)
        torch.cuda.synchronize()
        assert torch.equal(s.view(torch.int16), ps.view(torch.int16)), valid
        assert torch.equal(m.view(torch.int16), pm.view(torch.int16)), valid


@pytest.mark.parametrize("q_count,n,dim", _TILING_SHAPES)
def test_b2_bf16_tiling_bit_identical_on_integers(cuda, q_count, n, dim):
    q, kb = _int_inputs(cuda, q_count, n, dim, seed=q_count * 5 + n + dim)
    s, m = tmf.fused_score_segmax(q, kb)
    ps, pm = tmf.fused_score_segmax_plain(q, kb)
    torch.cuda.synchronize()
    assert _b2_equal(s, ps) and _b2_equal(m, pm)


# B2's f32 path (128 x 128 tiles, 32-deep stages, persistent): a ragged
# query edge against the 128-query tile (1, 77, 130, 1257), d below, between
# and at multiples of the stage depth (8, 24, 40, 768), a single segment,
# more tiles than SMs (the persistent loop wraps, the ring and the two
# maxima buffers are reused), Q % 8 != 0 and Q % 4 != 0 (score rows that
# start off a sector or a 16-byte boundary).
_F32_TILING_SHAPES = _TILING_SHAPES + [
    (130, 128, 32), (1257, 4096, 768), (129, 640, 36), (1280, 128, 768),
]


@pytest.mark.parametrize("q_count,n,dim", _F32_TILING_SHAPES)
def test_b2_f32_tiling_bit_identical_on_integers(cuda, q_count, n, dim):
    q, kb = _int_inputs(cuda, q_count, n, dim, seed=q_count * 3 + n + dim)
    q, kb = q.float(), kb.float()
    s, m = tmf.fused_score_segmax(q, kb)
    ps, pm = tmf.fused_score_segmax_plain(q, kb)
    torch.cuda.synchronize()
    assert _b2_equal(s, ps) and _b2_equal(m, pm)


def test_b2_f32_tiling_within_reorder_bound_on_gaussian(cuda):
    """Gaussian f32 inputs at Q = 1,257, N = 32,768 (the persistent loop
    wraps, the last query tile is ragged): every sum and every segment max
    within the float32 reordering bound of the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    q = torch.randn((1257, 768), generator=gen, device=cuda)
    kb = torch.randn((32768, 768), generator=gen, device=cuda) / 768 ** 0.5
    s, m = tmf.fused_score_segmax(q, kb)
    ps, pm = tmf.fused_score_segmax_plain(q, kb)
    d = q.shape[1]
    bound = 2 * d * 2.0 ** -24 / (1 - d * 2.0 ** -24) * (kb.abs() @ q.abs().T)
    assert bool(((s - ps).abs() <= bound).all())
    seg_bound = bound.view(-1, 128, 1257).amax(1)
    assert bool(((m - pm).abs() <= seg_bound).all())
    own = s.view(-1, 128, 1257).amax(1)
    assert torch.equal(m, own)


def test_topk_fused_chunks_start_mid_kb(cuda):
    """chunks=3 scores slabs that start mid-KB (new tensor maps over
    offset pointers): the card's results equal the CPU's."""
    q, kb = _int_inputs(cuda, 130, 1408, 40, seed=11)
    s, i = tmf.topk_fused(q, kb, 40, valid_rows=1300, chunks=3)
    cs, ci = tmf.topk_fused(q.cpu(), kb.cpu(), 40, valid_rows=1300, chunks=3)
    np.testing.assert_array_equal(s.cpu().numpy(), cs.numpy())
    np.testing.assert_array_equal(i.cpu().numpy(), ci.numpy())


def test_back_to_back_calls_rebuild_descriptors(cuda):
    """Two shapes launched back to back, checked only after both: each
    call encodes its own tensor maps."""
    qa, kba = _int_inputs(cuda, 77, 640, 24, seed=12)
    qb, kbb = _int_inputs(cuda, 1257, 1408, 768, seed=13)
    b1 = [tmf.fused_score_segmax_qmajor(qa, kba, 600),
          tmf.fused_score_segmax_qmajor(qb, kbb, 1408)]
    b2 = [tmf.fused_score_segmax(qa, kba), tmf.fused_score_segmax(qb, kbb)]
    torch.cuda.synchronize()
    for (s, m), (q, kb, valid) in zip(b1, [(qa, kba, 600), (qb, kbb, 1408)]):
        ps, pm = tmf.fused_score_segmax_qmajor_plain(q, kb, valid)
        assert torch.equal(s.view(torch.int16), ps.view(torch.int16))
        assert torch.equal(m.view(torch.int16), pm.view(torch.int16))
    for (s, m), (q, kb) in zip(b2, [(qa, kba), (qb, kbb)]):
        ps, pm = tmf.fused_score_segmax_plain(q, kb)
        assert _b2_equal(s, ps) and _b2_equal(m, pm)


def test_tiling_within_reorder_bound_on_gaussian(cuda):
    """Gaussian inputs at Q = 1,280, N = 65,664 (the persistent loop wraps
    several times): B1's and B2's scores within the float32 reordering
    bound plus one bf16 ulp and >= 99.9 % bitwise; B1's maxima are those of
    its own scores, B2's within the bound of their segment."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    q = torch.randn((1280, 768), generator=gen, device=cuda).to(
        torch.bfloat16)
    kb = (torch.randn((65664, 768), generator=gen, device=cuda)
          / 768 ** 0.5).to(torch.bfloat16)
    qn, kbn = q.float().cpu().numpy(), kb.float().cpu().numpy()
    s, m = tmf.fused_score_segmax_qmajor(q, kb, 65600)
    ps, _ = tmf.fused_score_segmax_qmajor_plain(q, kb, 65600)
    a, b = s.float().cpu().numpy(), ps.float().cpu().numpy()
    assert within_reorder_bound(qn, kbn, a, b).all()
    assert (bf16_ulp_distance(a, b) == 0).mean() >= 0.999
    own = s.view(1280, -1, 128).amax(-1)
    assert torch.equal(m.view(torch.int16), own.view(torch.int16))
    del s, m, ps
    st, mt = tmf.fused_score_segmax(q, kb)
    pst, pmt = tmf.fused_score_segmax_plain(q, kb)
    a, b = st.float().cpu().numpy().T, pst.float().cpu().numpy().T
    assert within_reorder_bound(qn, kbn, a, b).all()
    assert (bf16_ulp_distance(a, b) == 0).mean() >= 0.999
    d = qn.shape[1]
    bound = 2 * d * 2.0 ** -24 / (1 - d * 2.0 ** -24) * (
        np.abs(kbn) @ np.abs(qn).T)
    seg_bound = bound.reshape(-1, 128, 1280).max(1)
    assert (np.abs(mt.cpu().numpy() - pmt.cpu().numpy()) <= seg_bound).all()


def test_single_pass_and_streaming_on_gpu_match_cpu(cuda):
    """topk_global (bf16 and f32) and the streamed index (pinned chunks,
    side-stream uploads) give the CPU's results on integer inputs."""
    rng = np.random.default_rng(5)
    kb = rng.integers(-4, 5, (3000, 32)).astype(np.float32)
    q = rng.integers(-4, 5, (40, 32)).astype(np.float32)
    for dtype in (torch.bfloat16, torch.float32):
        for mode in ("global", "approx"):
            gpu = tm.DenseIndex(kb, mode=mode, dtype=dtype,
                                device=cuda).search_batch(q, k=25)
            cpu = tm.DenseIndex(kb, mode=mode, dtype=dtype,
                                device="cpu").search_batch(q, k=25)
            np.testing.assert_array_equal(gpu[1], cpu[1])
            np.testing.assert_array_equal(gpu[0], cpu[0])
        stream = tm.StreamingDenseIndex(kb, chunk_rows=512, dtype=dtype,
                                        device=cuda)
        assert stream._chunks[0].is_pinned()
        gpu = stream.search_batch(q, k=25)
        cpu = tm.StreamingDenseIndex(kb, chunk_rows=512, dtype=dtype,
                                     device="cpu").search_batch(q, k=25)
        np.testing.assert_array_equal(gpu[1], cpu[1])
        np.testing.assert_array_equal(gpu[0], cpu[0])


# ---- the reader and the answer path ----------------------------------------
class _WordTokenizer:
    """``w<i>`` -> id 5 + i, with what the embedder and the answer pipeline
    call (the GPU machine need not have the ``transformers`` package)."""

    cls_token_id, sep_token_id = 2, 3

    def __call__(self, texts, truncation=True, max_length=None,
                 add_special_tokens=True):
        single = isinstance(texts, str)
        out = []
        for text in ([texts] if single else texts):
            ids = [5 + int(w[1:]) for w in text.split()]
            if add_special_tokens:
                ids = ([self.cls_token_id] + ids[: max_length - 2]
                       + [self.sep_token_id])
            out.append(ids[:max_length])
        return {"input_ids": out[0] if single else out}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i) - 5}" for i in ids
                        if not (skip_special_tokens and int(i) < 5))


def _reader_batch(cfg, n, m, seq, seed):
    rng = np.random.default_rng(seed)
    ids = np.zeros((n * m, seq), np.int32)
    mask = np.zeros((n * m, seq), np.int32)
    tt = np.zeros((n * m, seq), np.int32)
    for r, ln in enumerate(rng.integers(seq // 3, seq + 1, n * m)):
        ids[r, :ln] = rng.integers(5, cfg.bert.vocab_size, ln)
        mask[r, :ln] = 1
        tt[r, ln // 4: ln] = 1
    return ids, mask, tt


def test_reader_step_bf16_matches_f32_upcast(cuda, monkeypatch):
    """A 4-layer reader step in bf16 on the tensor-core GEMM against the
    same forward with every dense product taken on the upcast operands:
    logits on real tokens within bf16 resolution, rtol = atol = 2e-2."""
    from viquae_torch.models import qa as tqa

    cfg = tqa.ReaderConfig(bert=tbert.BertConfig(
        vocab_size=3000, hidden_size=256, num_hidden_layers=4,
        num_attention_heads=4, intermediate_size=1024,
        max_position_embeddings=128, add_pooler=False), fuse_ir_score=True)
    model = convert.reader_from_jax(convert.init_reader_tree(cfg, seed=0),
                                    cfg, device=cuda, dtype=torch.bfloat16)
    ids, mask, tt = _reader_batch(cfg, 4, 6, 128, seed=0)
    args = [torch.from_numpy(a).to(cuda) for a in (ids, mask, tt)]
    scores = torch.linspace(-2, 2, len(ids), device=cuda)

    def forward():
        with torch.no_grad():
            return tqa.reader_apply(
                model, cfg, args[0], attention_mask=args[1],
                token_type_ids=args[2], passage_scores=scores, m_passages=6,
                compute_dtype=torch.bfloat16)

    got = forward()
    monkeypatch.setattr(TL, "_dot_f32", TL._dot_f32_upcast)
    ref = forward()
    real = args[1] > 0
    assert got.start_logits.dtype == torch.float32
    assert torch.isfinite(got.start_logits).all()
    torch.testing.assert_close(got.start_logits[real], ref.start_logits[real],
                               rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.end_logits[real], ref.end_logits[real],
                               rtol=2e-2, atol=2e-2)


def test_get_best_spans_on_gpu_equals_cpu(cuda):
    from viquae_torch.models import qa as tqa

    gen = torch.Generator().manual_seed(0)
    start = torch.rand((8, 6, 64), generator=gen)
    end = torch.rand((8, 6, 64), generator=gen)
    start[0], end[0] = 1.0 / 384, 1.0 / 384          # every entry ties
    start[1, 3], end[1, 3] = start[1, 1], end[1, 1]  # two passages tie
    weights = 1 + torch.rand((8, 6), generator=gen)
    for w in (None, weights, weights - 3):
        for first in (True, False):
            cpu = tqa.get_best_spans(start, end, weights=w,
                                     cannot_be_first_token=first)
            gpu = tqa.get_best_spans(
                start.to(cuda), end.to(cuda),
                weights=None if w is None else w.to(cuda),
                cannot_be_first_token=first)
            for a, b in zip(cpu, gpu):
                assert b.is_cuda and torch.equal(a, b.cpu())


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_answer_pipeline_on_gpu_equals_cpu(cuda, packed):
    """The whole answer path in f32 at a tiny size: the card gives the
    CPU's passage ids and answers (scores within 1e-4: the two encoders
    sum in different orders)."""
    from viquae_torch.ir.embedding import PackedTextEmbedder
    from viquae_torch.ir.qa_serving import AnswerPipeline
    from viquae_torch.ir.serving import FusedRetrievalPipeline
    from viquae_torch.models import qa as tqa

    bcfg = tbert.BertConfig(
        vocab_size=300, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, add_pooler=False)
    dcfg = tdpr.DPRConfig(bert=bcfg)
    rcfg = tqa.ReaderConfig(bert=bcfg, fuse_ir_score=True)
    d_tree = convert.init_tree(dcfg, seed=0, stddev=0.2)
    r_tree = convert.init_reader_tree(rcfg, seed=1, stddev=0.2)
    rng = np.random.default_rng(0)
    tok = _WordTokenizer()
    kb_rows = [{"passage_tokens": tok(" ".join(
        f"w{j}" for j in rng.integers(0, 200, rng.integers(8, 20))),
        add_special_tokens=False)["input_ids"]} for _ in range(60)]
    kb_mat = rng.normal(size=(60, 32)).astype(np.float32)
    queries = [" ".join(f"w{j}" for j in rng.integers(
        0, 200, rng.integers(4, 9))) for _ in range(13)]

    def run(device):
        emb = PackedTextEmbedder(
            tdpr.make_packed_apply(dcfg),
            convert.params_from_jax(d_tree, dcfg, device=device), tok,
            row_len=24, batch_size=8, compute_dtype=torch.float32,
            device=device)
        index = tm.DenseIndex(kb_mat, mode="global", dtype=torch.float32,
                              device=device)
        pipe = AnswerPipeline(
            FusedRetrievalPipeline(emb, index, batch_size=8, k=5), kb_rows,
            rcfg, convert.reader_from_jax(r_tree, rcfg, device=device), tok,
            m_passages=3, reader_seq=48, questions_per_step=4,
            passage_tokens_key="passage_tokens", packed_reader=packed,
            compute_dtype=torch.float32, device=device)
        return pipe.run(queries)

    on_gpu, on_cpu = run(cuda), run("cpu")
    for a, b in zip(on_gpu, on_cpu):
        assert a["passage_ids"] == b["passage_ids"]
        assert a["answer"] == b["answer"]
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4,
                                   rtol=1e-4)


def test_reader_step_enqueues_without_waiting_for_the_device(cuda):
    """``read`` and ``read_packed`` on uploaded tensors only enqueue work.
    An op that waits for the stream inside them (a scalar tensor copied
    from the host, an ``.item()``) makes the serving loop's prefetch thread
    wait for the step it has just enqueued, so the next batch's host
    assembly no longer overlaps the device. torch's sync debug mode raises
    on such a wait."""
    from viquae_torch.ir.qa_serving import AnswerPipeline
    from viquae_torch.models import qa as tqa

    cfg = tqa.ReaderConfig(bert=tbert.BertConfig(
        vocab_size=300, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, add_pooler=False), fuse_ir_score=True)
    reader = convert.reader_from_jax(convert.init_reader_tree(cfg, seed=0),
                                     cfg, device=cuda, dtype=torch.bfloat16)
    pipe = AnswerPipeline(None, [], cfg, reader, _WordTokenizer(),
                          m_passages=3, reader_seq=48, questions_per_step=4,
                          device=cuda)
    ids, mask, tt = _reader_batch(cfg, 4, 3, 48, seed=1)
    canvas = pipe.pack_pairs(ids, mask, tt)
    padded = pipe.upload(ids, mask, tt)
    packed = pipe.upload(*canvas, mask)
    scores = torch.linspace(-1, 1, len(ids), device=cuda)
    pipe.read(*padded, scores)         # warm-up: library handles, pools
    pipe.read_packed(*packed, scores)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # the uploads too: they go through pinned staging buffers, so a
        # step's inputs go up while the step before it still runs
        spans = pipe.read(*pipe.upload(ids, mask, tt), scores)
        spans_packed = pipe.read_packed(*pipe.upload(*canvas, mask), scores)
        with pytest.raises(RuntimeError, match="synchroniz"):
            torch.from_numpy(ids).to(cuda)   # what the uploads used to be
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(spans, spans_packed):
        assert a.shape == b.shape == (4,)


# ---- uploads, streams, device BM25, hybrid --------------------------------
def test_upload_values_survive_buffer_reuse(cuda):
    """Many uploads in a row, far more than staging blocks in flight: every
    tensor on the card holds its own array's values (a block handed out
    again before its copy had run would show another array's), in every
    dtype the pipelines send."""
    from viquae_torch.core.device import upload

    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 1000, (257, 33)).astype(dtype)
              for _ in range(100)
              for dtype in (np.int32, np.float32, np.int64)]
    big = rng.standard_normal((1280, 2048)).astype(np.float32)
    on_card = [upload(a, cuda) for a in arrays]
    big_card = [upload(big * j, cuda) for j in range(6)]
    bf = torch.from_numpy(big[:64]).to(torch.bfloat16)
    bf_card = upload(bf, cuda)
    torch.cuda.synchronize()
    for a, t in zip(arrays, on_card):
        assert t.is_cuda and t.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(t.cpu().numpy(), a)
    for j, t in enumerate(big_card):
        np.testing.assert_array_equal(t.cpu().numpy(), big * j)
    assert torch.equal(bf_card.cpu(), bf)
    assert upload(np.zeros((0, 4), np.int32), cuda).shape == (0, 4)


def _tiny_retrieval_parts(cuda, batch_size=16):
    from viquae_torch.ir.embedding import PackedTextEmbedder
    from viquae_torch.ops import bm25

    bcfg = tbert.BertConfig(
        vocab_size=300, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, add_pooler=False)
    dcfg = tdpr.DPRConfig(bert=bcfg)
    tree = convert.init_tree(dcfg, seed=0, stddev=0.2)
    rng = np.random.default_rng(0)
    kb = rng.normal(size=(512, 32)).astype(np.float32)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 200, 30))
             for _ in range(512)]
    queries = [" ".join(f"w{j}" for j in rng.integers(
        0, 200, rng.integers(4, 9))) for _ in range(40)]
    host = bm25.BM25Index.build(texts, k1=0.5, b=0.3)

    def embedder(device, dtype=torch.float32):
        return PackedTextEmbedder(
            tdpr.make_packed_apply(dcfg),
            convert.params_from_jax(tree, dcfg, device=device), _WordTokenizer(),
            row_len=24, batch_size=batch_size, compute_dtype=dtype,
            device=device)

    return embedder, kb, host, queries


@pytest.mark.parametrize("which", ["fused", "multi-index", "hybrid-host",
                                   "hybrid-device"])
def test_canvas_streams_enqueue_without_waiting_for_the_device(cuda, which):
    """A serving loop's per-batch dispatch (upload the canvas and the
    features, embed, search, fuse; for the hybrid loop the sparse leg too)
    waits for nothing on the card: every batch of the stream is enqueued
    under torch's sync debug mode, which raises on a wait."""
    from viquae_torch.ir import serving
    from viquae_torch.ops.bm25_device import DeviceBM25

    embedder, kb, host, queries = _tiny_retrieval_parts(cuda)
    emb = embedder(cuda, torch.bfloat16)
    fused = tm.DenseIndex(kb, mode="fused", device=cuda)
    args = ()
    if which == "fused":
        pipe = serving.FusedRetrievalPipeline(emb, fused, batch_size=16, k=5)
    elif which == "multi-index":
        rng = np.random.default_rng(1)
        img = tm.DenseIndex(rng.normal(size=(512, 24)), do_l2norm=True,
                            mode="global", dtype=torch.bfloat16, device=cuda)
        pipe = serving.MultiIndexRetrievalPipeline(
            emb, {"dpr": fused, "img": img}, {"dpr": 0.6, "img": 0.4}, "dpr",
            batch_size=16, k=5)
        args = ({"img": rng.normal(size=(40, 24)).astype(np.float32)}, {})
    else:
        sparse = host if which == "hybrid-host" else DeviceBM25(
            host, n_head=16, l_small=32, q_block=8, device=cuda)
        pipe = serving.HybridRetrievalPipeline(emb, fused, sparse,
                                               batch_size=16, k=5)
    list(pipe._canvas_stream(queries, *args))   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batches = list(pipe._canvas_stream(queries, *args))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [start for start, _, _, _ in batches] == [0, 16, 32]
    for _, _, scores, idx in batches:
        assert scores.is_cuda and scores.dtype == torch.bfloat16
        assert idx.dtype == torch.int32 and idx.shape == (16, 5)


def _lists_agree(ids_a, scores_a, ids_b, scores_b, rtol):
    """Two runs of one scorer whose f32 sums may differ in their last bits:
    scores positionwise within ``rtol``; where ids differ, the doc's score
    in the other list (or that list's last score, if it fell off the end)
    is within ``rtol`` of its own."""
    for ia, sa, ib, sb in zip(ids_a, scores_a, ids_b, scores_b):
        assert len(ia) == len(ib)
        np.testing.assert_allclose(sa, sb, rtol=rtol)
        other = dict(zip(ib, sb))
        for doc, score in zip(ia, sa):
            want = other.get(doc, sb[-1] if len(sb) else 0.0)
            assert abs(score - want) <= rtol * abs(want), (doc, score, want)


def test_device_bm25_on_gpu_matches_the_cpu_path(cuda):
    """One Zipf corpus, the port's DeviceBM25 on the card and on the CPU:
    the built arrays are equal bit for bit; the scores agree within 1e-5
    relative (atomic f32 adds land in any order; the CPU sums in lane
    order) and the ids wherever scores are further apart than that; the
    device rows are the lists under the pad convention; an overflow row is
    the host scorer's."""
    from viquae_torch.ops import bm25
    from viquae_torch.ops.bm25_device import DeviceBM25

    host = bm25.synth_zipf_index(3000, vocab_size=2000, mean_len=60, seed=1)
    kw = dict(n_head=64, l_small=64, l_mid=256, q_block=32)
    on_gpu, on_cpu = DeviceBM25(host, **kw), DeviceBM25(host, device="cpu",
                                                        **kw)
    assert on_gpu.device.type == "cuda"
    for name in ("head_dense", "tail_w"):
        assert torch.equal(getattr(on_gpu, name).cpu().view(torch.int16),
                           getattr(on_cpu, name).view(torch.int16)), name
    assert torch.equal(on_gpu.tail_docs.cpu(), on_cpu.tail_docs)
    rng = np.random.default_rng(3)
    queries = [" ".join(f"t{t}" for t in
                        (rng.zipf(1.2, 8).astype(np.int64) - 1) % 2000)
               for _ in range(70)]
    tails = np.flatnonzero(on_gpu.tail_df > 0)
    queries.append(" ".join(f"t{t}" for t in tails[-700:]))  # overflows
    g_s, g_i = on_gpu.search_batch(queries, k=20)
    assert on_gpu.last_overflow == 1
    c_s, c_i = on_cpu.search_batch(queries, k=20)
    _lists_agree(g_i, g_s, c_i, c_s, rtol=1e-5)
    h_s, h_i = host.search_batch(queries[-1:], k=20)
    assert g_i[-1] == h_i[0] and g_s[-1] == h_s[0]
    d_s, d_i = on_gpu.search_batch_device(queries, k=20)
    assert d_s.is_cuda and d_s.shape == d_i.shape == (96, 20)
    d_s, d_i = d_s.cpu().numpy(), d_i.cpu().numpy()
    keep = d_i != 2 ** 31 - 1
    assert np.isneginf(d_s[~keep]).all()
    _lists_agree([d_i[q][keep[q]].tolist() for q in range(len(queries))],
                 [d_s[q][keep[q]].tolist() for q in range(len(queries))],
                 g_i, g_s, rtol=1e-5)
    # two runs on the card agree with each other the same way
    g2_s, g2_i = on_gpu.search_batch(queries, k=20)
    _lists_agree(g2_i, g2_s, g_i, g_s, rtol=1e-5)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_hybrid_pipeline_on_gpu_equals_cpu(cuda, backend):
    """The hybrid loop in f32 at a tiny size, on the card and on the CPU:
    the same docs (>= 90 % a row: a near-tie may move) with fused scores
    within 2e-2, the bf16 wire format."""
    from viquae_torch.ir.serving import HybridRetrievalPipeline
    from viquae_torch.ops.bm25_device import DeviceBM25

    embedder, kb, host, queries = _tiny_retrieval_parts(cuda)

    def run(device):
        sparse = host if backend == "host" else DeviceBM25(
            host, n_head=16, l_small=32, q_block=8, device=device)
        index = tm.DenseIndex(kb, mode="global", dtype=torch.float32,
                              device=device)
        return HybridRetrievalPipeline(
            embedder(device), index, sparse, batch_size=16, k=10,
            k_bm25=12, compact_transfer=False).run_arrays(queries)

    (g_s, g_i), (c_s, c_i) = run(cuda), run("cpu")
    assert g_s.shape == c_s.shape == (40, 10)
    for q in range(40):
        got = dict(zip(g_i[q].tolist(), g_s[q].tolist()))
        want = dict(zip(c_i[q].tolist(), c_s[q].tolist()))
        shared = set(got) & set(want)
        assert len(shared) >= 9, (q, got, want)
        for d in shared:
            assert abs(got[d] - want[d]) <= 2e-2 * max(1.0, abs(want[d]))


# ---- the image and face chain ---------------------------------------------
def _close_rel(a, b, rel):
    a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
    assert np.isfinite(a).all() and a.shape == b.shape
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), (
        np.abs(a - b).max(), np.abs(b).max())


def _towers(device):
    """The four towers at published widths, depth cut to one block a
    stage, seeded: (name, module, apply, input side)."""
    from viquae_torch.models import arcface, clip, resnet

    res = resnet.ResNetConfig(stage_sizes=(1, 1, 1, 1))
    mrn = clip.ModifiedResNetConfig(stage_sizes=(1, 1, 1, 1))
    vit = clip.CLIPVisionConfig(num_layers=2)
    arc = arcface.ArcFaceConfig(stage_sizes=(1, 1, 1, 1))
    return [
        ("resnet50", resnet.init(res, seed=0, device=device),
         lambda m, x, cd: resnet.apply(m, res, x, cd), 224),
        ("clip_rn50", clip.modified_resnet_init(mrn, seed=1, device=device),
         lambda m, x, cd: clip.modified_resnet_apply(m, mrn, x, cd), 224),
        ("clip_vit_b32", clip.vit_init(vit, seed=2, device=device),
         lambda m, x, cd: clip.vit_apply(m, vit, x, cd or torch.float32)[
             "image_embeds"], 224),
        ("arcface_r50", arcface.init(arc, seed=3, device=device),
         lambda m, x, cd: arcface.apply(m, arc, x, cd), 112),
    ]


@pytest.mark.parametrize("which", range(4),
                         ids=["resnet50", "clip_rn50", "clip_vit_b32",
                              "arcface_r50"])
def test_image_towers_on_gpu_match_cpu(cuda, which):
    """Each tower on the card against the same weights on the CPU: f32
    within 1e-3 of the embedding scale (reordered f32 sums, TF32 off);
    bf16 compute_dtype within 5e-2."""
    name, model, apply, side = _towers(cuda)[which]
    x = torch.randn(4, side, side, 3, generator=torch.Generator().manual_seed(
        which)).to(cuda)
    on_gpu = apply(model, x, None)
    on_cpu = apply(model.to("cpu"), x.cpu(), None)
    _close_rel(on_gpu, on_cpu, 1e-3)
    model.to(cuda)
    _close_rel(apply(model, x, torch.bfloat16), on_cpu, 5e-2)


def _cascade_case(device, n=6, canvas=128):
    from viquae_torch.models import mtcnn

    cfg = mtcnn.MTCNNConfig(canvas=canvas, thresholds=(0.5, 0.5, 0.5))
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (n, canvas, canvas, 3), generator=gen)
    images[1, canvas // 2:] = 0                      # ties: flat padding
    hws = torch.tensor([[canvas, canvas]] * n, dtype=torch.float32)
    hws[1, 0] = canvas // 2
    return mtcnn.init(seed=3, device=device), cfg, images.float().to(
        device), hws.to(device)


def test_mtcnn_cascade_on_gpu_matches_cpu(cuda):
    """detect_faces_batch on the card against the CPU: valid masks equal,
    boxes within 1e-2 px where valid (the seed's stage probabilities lie
    >= 1e-4 from their thresholds, checked on the CPU run)."""
    from viquae_torch.models import mtcnn

    params, cfg, images, hws = _cascade_case(cuda)
    got = mtcnn.detect_faces_batch(params, images, hws, cfg)
    cpu = params.to("cpu")
    boxes, scores, regs, valid = mtcnn.pnet_stage(cpu, images.cpu(),
                                                  hws.cpu(), cfg)
    b1, v1 = mtcnn.stage1_nms(boxes, scores, regs, valid, cfg)
    p2, b2, v2 = mtcnn.rnet_stage(cpu, images.cpu(), b1, v1, cfg)
    p3, ref = mtcnn.onet_stage(cpu, images.cpu(), b2, v2, cfg)
    assert float((p2 - 0.5).abs()[v1].min()) > 1e-4
    assert float((p3 - 0.5).abs()[v2].min()) > 1e-4
    assert torch.equal(got["valid"].cpu(), ref["valid"])
    assert int(ref["valid"].sum()) > 0
    mask = ref["valid"]
    np.testing.assert_allclose(got["boxes"].cpu()[mask].numpy(),
                               ref["boxes"][mask].numpy(), atol=1e-2)


def test_batched_nms_on_gpu_matches_a_per_image_loop(cuda):
    """nms_fixed over a batch of rows in one call equals the same call
    row by row, on the card, with ties and an all-invalid row."""
    from viquae_torch.models import mtcnn

    gen = torch.Generator().manual_seed(1)
    boxes = torch.rand(32, 64, 4, generator=gen) * 100
    boxes[..., 2:] = boxes[..., :2] + 5 + torch.rand(32, 64, 2,
                                                     generator=gen) * 25
    scores = torch.rand(32, 64, generator=gen)
    scores[3] = 0.5
    valid = torch.rand(32, 64, generator=gen) < 0.7
    valid[5] = False
    boxes, scores, valid = boxes.to(cuda), scores.to(cuda), valid.to(cuda)
    for mode, cap in (("union", None), ("min", 16)):
        batched = mtcnn.nms_fixed(boxes, scores, valid, 0.5, mode, cap)
        for r in range(32):
            one = mtcnn.nms_fixed(boxes[r], scores[r], valid[r], 0.5, mode,
                                  cap)
            assert torch.equal(batched[r], one), (mode, r)


def test_cascade_and_face_leg_make_no_host_read_in_their_loops(cuda):
    """detect_faces_batch (pyramid, every NMS loop, RNet, ONet) and the
    face leg's device program enqueue without waiting for the device
    (torch's sync debug mode raises on a wait). The face leg's one read
    per sub-batch comes after the program and is not in it."""
    from viquae_torch.image.face_recognition import FaceQueryEncoder
    from viquae_torch.models import arcface, mtcnn

    params, cfg, images, hws = _cascade_case(cuda, n=4)
    acfg = arcface.ArcFaceConfig(stage_sizes=(1, 1, 1, 1), width=16,
                                 embedding_size=32)
    enc = FaceQueryEncoder(params, arcface.init(acfg, seed=0, device=cuda),
                           mtcnn_cfg=cfg, arcface_cfg=acfg, batch_size=4,
                           device=cuda)
    u8 = images.to(torch.uint8)
    mtcnn.detect_faces_batch(params, images, hws, cfg)      # warm-up
    enc._face_program(params, enc.embedder.params, u8, hws)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        det = mtcnn.detect_faces_batch(params, images, hws, cfg)
        emb, has, _ = enc._face_program(params, enc.embedder.params, u8, hws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert det["valid"].shape == (4, cfg.max_faces)
    assert emb.shape == (4, 32) and has.dtype == torch.bool


def test_image_legs_enqueue_without_waiting_for_the_device(cuda):
    """Phase 18's image legs (raw uint8 canvas upload -> preprocess ->
    ResNet / CLIP RN50 -> search -> fuse) add no wait on the device to the
    multi-index stream: every batch is enqueued under torch's sync debug
    mode. (The face leg reads back once per sub-batch, as the reference's
    does, and is left out.)"""
    from PIL import Image

    from viquae_torch.image.embedding import ImageEmbedder
    from viquae_torch.ir import serving
    from viquae_torch.models import clip, resnet

    embedder, kb, _, queries = _tiny_retrieval_parts(cuda)
    emb = embedder(cuda, torch.bfloat16)
    rng = np.random.default_rng(2)
    res = resnet.ResNetConfig(stage_sizes=(1, 1), width=8)
    mrn = clip.ModifiedResNetConfig(stage_sizes=(1, 1, 1, 1), width=8,
                                    output_dim=16, heads=4, image_size=64)
    encoders = {
        "imagenet": ImageEmbedder(
            lambda p, x: resnet.apply(p, res, x),
            resnet.init(res, seed=0, device=cuda), "imagenet",
            image_size=64, preprocessing="imagenet", device=cuda),
        "clip": ImageEmbedder(
            lambda p, x: clip.modified_resnet_apply(p, mrn, x),
            clip.modified_resnet_init(mrn, seed=1, device=cuda), "clip",
            image_size=64, preprocessing="clip", device=cuda)}
    indexes = {"dpr": tm.DenseIndex(kb, mode="fused", device=cuda)}
    for name, d in (("imagenet", 64), ("clip", 16)):
        indexes[name] = tm.DenseIndex(rng.normal(size=(512, d)),
                                      do_l2norm=True, mode="global",
                                      dtype=torch.bfloat16, device=cuda)
    pipe = serving.MultiIndexRetrievalPipeline(
        emb, indexes, {"dpr": 0.6, "imagenet": 0.2, "clip": 0.2}, "dpr",
        batch_size=16, k=5, image_encoders=encoders)
    images = [None if i % 4 == 3 else Image.fromarray(rng.integers(
        0, 255, (80, 100, 3), dtype=np.uint8)) for i in range(len(queries))]
    query_images = {"imagenet": images, "clip": images}
    list(pipe._canvas_stream(queries, {}, query_images))   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batches = list(pipe._canvas_stream(queries, {}, query_images))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [start for start, _, _, _ in batches] == [0, 16, 32]
    for _, _, scores, idx in batches:
        assert scores.is_cuda and idx.shape == (16, 5)


def test_face_query_encoder_on_gpu_matches_cpu(cuda):
    """The online face leg on the card against the CPU on the same images:
    the same faces found, landmarks within 1 px (on random pixels a box
    shift of 1e-3 px moves a crop's pixels by ~0.25 and the regressions
    after it, so the devices' f32 reorderings grow through the three
    stages), and the card's embeddings within 1e-3 of the embedding scale
    of the CPU's align + ArcFace on the card's landmarks; through
    ``__call__``, the redo path of an image larger than the canvas
    included, the same rows are NaN."""
    from PIL import Image

    from viquae_torch.image.face_recognition import FaceQueryEncoder
    from viquae_torch.models import arcface, mtcnn

    cfg = mtcnn.MTCNNConfig(canvas=128, thresholds=(0.5, 0.5, 0.5))
    acfg = arcface.ArcFaceConfig(stage_sizes=(1, 1, 1, 1), width=16,
                                 embedding_size=32)
    rng = np.random.default_rng(3)
    images = [None, Image.fromarray(rng.integers(0, 255, (128, 96, 3),
                                                 dtype=np.uint8)),
              Image.fromarray(rng.integers(0, 255, (200, 150, 3),
                                           dtype=np.uint8)),
              Image.fromarray(rng.integers(0, 255, (90, 128, 3),
                                           dtype=np.uint8))]
    m_params = mtcnn.init(seed=5, device="cpu")
    a_params = arcface.init(acfg, seed=6, device="cpu")
    encoders = {dev: FaceQueryEncoder(
        copy.deepcopy(m_params).to(dev), copy.deepcopy(a_params).to(dev),
        mtcnn_cfg=cfg, arcface_cfg=acfg, batch_size=4, device=dev)
        for dev in (cuda, torch.device("cpu"))}
    out = {dev: enc(images) for dev, enc in encoders.items()}
    np.testing.assert_array_equal(np.isnan(out[cuda]),
                                  np.isnan(out[torch.device("cpu")]))
    assert np.isfinite(out[cuda]).all(1).sum() >= 1

    canvas = torch.zeros(4, 128, 128, 3, dtype=torch.uint8)
    hws = torch.zeros(4, 2)
    for i in range(4):
        a = torch.from_numpy(rng.integers(0, 255, (100 + 8 * i, 128, 3),
                                          dtype=np.uint8))
        canvas[i, : a.shape[0]] = a
        hws[i] = torch.tensor(a.shape[:2], dtype=torch.float32)
    runs = {dev: enc._face_program(enc.mtcnn_params, enc.embedder.params,
                                   canvas.to(dev), hws.to(dev))
            for dev, enc in encoders.items()}
    (emb_g, has_g, lms_g), (_, has_c, lms_c) = (
        [t.cpu() for t in runs[d]] for d in (cuda, torch.device("cpu")))
    assert torch.equal(has_g, has_c) and bool(has_g.any())
    lm_err = float((lms_g - lms_c)[has_g].abs().max())
    assert lm_err <= 1.0, lm_err
    cpu = encoders[torch.device("cpu")]
    ref = cpu._align_embed(cpu.embedder.params, canvas.float(), lms_g)
    scale = float(ref[has_g].abs().max())
    assert float((emb_g - ref)[has_g].abs().max()) <= 1e-3 * scale
