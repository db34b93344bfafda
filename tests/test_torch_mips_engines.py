"""The port's single-device MIPS engines (viquae_torch/ops/mips.py:
_select_topk, topk_single, topk_global, every DenseIndex mode, add,
reconstruct, save/load, StreamingDenseIndex) against the JAX functions on
the same inputs, in the single-device cases of tests/test_mips.py.

Tolerances: f32 ids must match exactly (and bit for bit on integer-valued
inputs). f32 scores agree within 2e-5 (the JAX tests' own tolerance): the
two frameworks take the f32 sums of a product in different orders, which
moves the last bits of a score of magnitude ~10-30 by a few ulps (~4e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import bf16_ulp_distance
from viquae_torch.ops import mips as tm
from viquae_tpu.ops import mips as jm

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    kb = rng.standard_normal((10_037, 64)).astype(np.float32)
    queries = rng.standard_normal((33, 64)).astype(np.float32)
    return queries, kb


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _np(*tensors):
    return [np.asarray(t) for t in tensors]


def _assert_same(got, ref, exact_scores=False):
    (s, i), (ref_s, ref_i) = _np(*got), _np(*ref)
    assert i.dtype == np.int32 and s.dtype == np.float32
    np.testing.assert_array_equal(i, ref_i)
    if exact_scores:
        np.testing.assert_array_equal(s, ref_s)
    else:
        np.testing.assert_allclose(s, ref_s, **TOL)


def test_topk_single_parity(data):
    q, kb = data
    got = tm.topk_single(_t(q), _t(kb), 20, chunk_size=1024)
    ref = jm.topk_single(jnp.asarray(q), jnp.asarray(kb), 20, chunk_size=1024)
    _assert_same(got, ref)
    np.testing.assert_array_equal(got[1].numpy(),
                                  jm.exact_topk_numpy(q, kb, 20)[1])


def test_topk_single_tie_breaking_by_index():
    kb = np.tile(np.eye(4, dtype=np.float32), (5, 1))
    q = np.eye(4, dtype=np.float32)[:1]
    got = tm.topk_single(_t(q), _t(kb), 5, chunk_size=4)
    ref = jm.topk_single(jnp.asarray(q), jnp.asarray(kb), 5, chunk_size=4)
    np.testing.assert_array_equal(got[1][0].numpy(), [0, 4, 8, 12, 16])
    _assert_same(got, ref, exact_scores=True)


@pytest.mark.parametrize("engine", ["single", "global"])
def test_valid_rows_masking(data, engine):
    q, kb = data
    padded = np.concatenate([kb, 100 * np.ones((11, 64), np.float32)])
    if engine == "single":
        got = tm.topk_single(_t(q), _t(padded), 10, chunk_size=2048,
                             valid_rows=len(kb))
        ref = jm.topk_single(jnp.asarray(q), jnp.asarray(padded), 10,
                             chunk_size=2048, valid_rows=jnp.int32(len(kb)))
    else:
        got = tm.topk_global(_t(q), _t(padded), 10, valid_rows=len(kb),
                             compute_dtype=torch.float32)
        ref = jm.topk_global(jnp.asarray(q), jnp.asarray(padded), 10,
                             valid_rows=jnp.int32(len(kb)),
                             compute_dtype=jnp.float32)
    assert got[1].max() < len(kb)
    _assert_same(got, ref)


@pytest.mark.parametrize("k,chunk,mode", [(150, 100, "fast"),
                                          (20, 4096, "fast"),
                                          (20, 2048, "approx"),
                                          (20, 1000, "exact")],
                         ids=["k>chunk", "two-level", "approx", "exact"])
def test_topk_single_modes(data, k, chunk, mode):
    """k wider than a chunk, the two-level path (32 segments > k), approx
    (exact in both packages on the CPU: recall 1.0) and exact."""
    q, kb = data
    kb = kb[:8192] if mode == "fast" and k == 20 else kb
    got = tm.topk_single(_t(q), _t(kb), k, chunk_size=chunk, mode=mode)
    ref = jm.topk_single(jnp.asarray(q), jnp.asarray(kb), k,
                         chunk_size=chunk, mode=mode)
    _assert_same(got, ref)
    np.testing.assert_array_equal(got[1].numpy(),
                                  jm.exact_topk_numpy(q, kb, k)[1])


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_topk_global_parity(data, mode):
    q, kb = data
    padded = np.concatenate([kb, 100 * np.ones((13, 64), np.float32)])
    got = tm.topk_global(_t(q), _t(padded), 20, valid_rows=len(kb),
                         compute_dtype=torch.float32, mode=mode)
    ref = jm.topk_global(jnp.asarray(q), jnp.asarray(padded), 20,
                         valid_rows=jnp.int32(len(kb)),
                         compute_dtype=jnp.float32, mode=mode)
    _assert_same(got, ref)
    np.testing.assert_array_equal(got[1].numpy(),
                                  jm.exact_topk_numpy(q, kb, 20)[1])


def test_topk_global_bf16_matches_jax_on_integers():
    """bf16 compute: the f32 product is rounded to bf16 before the mask and
    the selection. Integer inputs keep every sum exact, so ids and scores
    are bit-identical, ties included. In mode "approx" the reference's
    approx_max_k returns the exact values on the CPU, but for bf16 scores
    it keeps an arbitrary one of several tied at the k-th value; the port
    keeps the lowest ids (the exact oracle), so ids are compared above the
    k-th value."""
    rng = np.random.default_rng(4)
    kb = rng.integers(-3, 4, (1500, 32)).astype(np.float32)
    q = rng.integers(-3, 4, (9, 32)).astype(np.float32)
    got = tm.topk_global(_t(q), _t(kb), 37, valid_rows=1400)
    ref = jm.topk_global(jnp.asarray(q), jnp.asarray(kb), 37,
                         valid_rows=jnp.int32(1400))
    _assert_same(got, ref, exact_scores=True)
    s, i = _np(*tm.topk_global(_t(q), _t(kb), 37, valid_rows=1400,
                               mode="approx"))
    ref_s, ref_i = _np(*jm.topk_global(jnp.asarray(q), jnp.asarray(kb), 37,
                                       valid_rows=jnp.int32(1400),
                                       mode="approx"))
    np.testing.assert_array_equal(s, ref_s)
    above = ref_s > ref_s[:, -1:]
    np.testing.assert_array_equal(i[above], ref_i[above])
    np.testing.assert_array_equal(i, jm.exact_topk_numpy(q, kb[:1400], 37)[1])


def test_select_topk_global_alias_and_tie_order():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((4, 1024)).astype(np.float32)
    scores[:, 300:310] = 5.0  # a tie group inside the top-k
    for mode in ("global", "fast", "exact", "approx"):
        s, i = tm._select_topk(_t(scores), 15, mode)
        ref_s, ref_i = jm._select_topk(jnp.asarray(scores), 15, mode)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    with pytest.raises(ValueError, match="unknown top-k mode"):
        tm._select_topk(_t(scores), 5, "nope")


def test_top_k_wide_rows_equal_one_sort(monkeypatch):
    """Rows wider than one sort block merge per-block top-k by
    (-value, position): the same values and positions as one stable sort,
    ties across blocks included."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 50, (3, 1000)).astype(np.float32))
    ref = tm.top_k(x, 70)
    monkeypatch.setattr(tm, "_TOPK_BLOCK", 128)
    got = tm.top_k(x, 70)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_topk_global_k_exceeds_pool(mode):
    rng = np.random.default_rng(0)
    kb = rng.standard_normal((128, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    got = tm.topk_global(_t(q), _t(kb), 500, compute_dtype=torch.float32,
                         mode=mode)
    ref = jm.topk_global(jnp.asarray(q), jnp.asarray(kb), 500,
                         compute_dtype=jnp.float32, mode=mode)
    assert got[0].shape == (4, 500)
    assert (got[1][:, 128:] == tm.INT32_MAX).all()
    _assert_same(got, ref)


@pytest.mark.parametrize("engine", ["single", "global"])
def test_pad_sentinel_convention(engine):
    rng = np.random.default_rng(2)
    kb = rng.standard_normal((64, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    fn_t = tm.topk_single if engine == "single" else tm.topk_global
    fn_j = jm.topk_single if engine == "single" else jm.topk_global
    got = fn_t(_t(q), _t(kb), 16, valid_rows=4, compute_dtype=torch.float32)
    ref = fn_j(jnp.asarray(q), jnp.asarray(kb), 16, valid_rows=jnp.int32(4),
               compute_dtype=jnp.float32)
    assert (got[1][:, 4:] == tm.INT32_MAX).all() and (got[1][:, :4] < 4).all()
    _assert_same(got, ref)


def test_dense_index_default_equals_jax_default(data):
    """DenseIndex(kb) takes the reference's defaults: mode "fast", f32."""
    q, kb = data
    index = tm.DenseIndex(kb, device="cpu")
    assert index.mode == "fast" and index.dtype == torch.float32
    s, i = index.search_batch(q, 10)
    ref_s, ref_i = jm.DenseIndex(kb).search_batch(q, 10)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "fast", "global", "approx"])
@pytest.mark.parametrize("do_l2norm", [False, True], ids=["ip", "l2norm"])
def test_dense_index_modes_match_jax(data, mode, do_l2norm):
    """Every f32 mode, with and without the L2 norm (normalized in f32 in
    both packages; the norms may differ in the last bit, which moves
    scores by ~1e-7 and no id)."""
    q, kb = data
    kb = kb[:3000]
    index = tm.DenseIndex(kb, do_l2norm=do_l2norm, mode=mode, chunk_size=512,
                          device="cpu")
    ref = jm.DenseIndex(kb, do_l2norm=do_l2norm, mode=mode, chunk_size=512)
    s, i = index.search_batch(q, k=10)
    ref_s, ref_i = ref.search_batch(q, k=10)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, **TOL)
    # device tensors in, device tensors out with sync=False
    s2, i2 = index.search_batch(torch.from_numpy(q), k=10, sync=False)
    assert isinstance(s2, torch.Tensor)
    np.testing.assert_array_equal(i2.numpy(), i)
    np.testing.assert_array_equal(s2.numpy(), s)


def test_dense_index_fast_mode_routes_by_score_bytes(data, monkeypatch):
    """mode "fast" takes the single pass while the (Q, N) scores fit in
    4 GiB and the chunked engine beyond; both give the same result."""
    q, kb = data
    index = tm.DenseIndex(kb, chunk_size=1024, device="cpu")
    calls = []
    real = tm.topk_single
    monkeypatch.setattr(tm, "topk_single",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    s, i = index.search_batch(q, 10)
    assert not calls
    monkeypatch.setattr(tm, "_SINGLE_PASS_BYTES", 33 * index.matrix.shape[0]
                        * 4 - 1)
    s_c, i_c = index.search_batch(q, 10)
    assert calls and calls[0]["chunk_size"] == 1024
    np.testing.assert_array_equal(i_c, i)
    np.testing.assert_allclose(s_c, s, **TOL)


@pytest.mark.parametrize("mode", ["fast", "global", "fused"])
def test_dense_index_add_matches_fresh_build(mode):
    """add() in place (inside the 128-row padding) and by growth, against
    a fresh build of the concatenated data (identical in the port) and
    against the JAX index that took the same adds."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((600, 32)).astype(np.float32)
    extra1 = rng.standard_normal((3, 32)).astype(np.float32)    # in padding
    extra2 = rng.standard_normal((700, 32)).astype(np.float32)  # grows
    q = rng.standard_normal((9, 32)).astype(np.float32)
    index = tm.DenseIndex(base, mode=mode, chunk_size=256, device="cpu")
    padded_rows = index.matrix.shape[0]
    index.add(extra1)
    assert index.matrix.shape[0] == padded_rows  # written in place
    index.add(extra2)
    assert index.n == 1303 and index.matrix.shape[0] == 1408
    s, i = index.search_batch(q, k=25)
    fresh = tm.DenseIndex(np.concatenate([base, extra1, extra2]), mode=mode,
                          chunk_size=256, device="cpu")
    s_f, i_f = fresh.search_batch(q, k=25)
    np.testing.assert_array_equal(i, i_f)
    np.testing.assert_array_equal(s, s_f)
    ref = jm.DenseIndex(base, mode=mode, chunk_size=256)
    ref.add(extra1)
    ref.add(extra2)
    ref_s, ref_i = ref.search_batch(q, k=25)
    if mode == "fused":
        # bf16 scores: f32 sums in another order can round one ulp apart
        assert np.mean(i == ref_i) >= 0.99
        assert bf16_ulp_distance(s, ref_s).max() <= 1
    else:
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_allclose(s, ref_s, **TOL)
    np.testing.assert_array_equal(index.search_batch(extra2[:2], k=1)[1][:, 0],
                                  [603, 604])


def test_dense_index_add_l2norm():
    rng = np.random.default_rng(6)
    base = rng.standard_normal((500, 32)).astype(np.float32)
    extra = 5.0 * rng.standard_normal((77, 32)).astype(np.float32)
    q = rng.standard_normal((7, 32)).astype(np.float32)
    index = tm.DenseIndex(base, do_l2norm=True, chunk_size=256, device="cpu")
    index.add(extra)
    s, i = index.search_batch(q, k=15)
    ref = jm.DenseIndex(base, do_l2norm=True, chunk_size=256)
    ref.add(extra)
    ref_s, ref_i = ref.search_batch(q, k=15)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, **TOL)
    with pytest.raises(ValueError, match="expected"):
        index.add(np.zeros((2, 31), np.float32))


def test_dense_index_reconstruct():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((100, 16)).astype(np.float32)
    for kwargs in (dict(), dict(do_l2norm=True), dict(mode="fused")):
        got = tm.DenseIndex(base, chunk_size=64, device="cpu",
                            **kwargs).reconstruct_batch([0, 17, 99])
        ref = jm.DenseIndex(base, chunk_size=64,
                            **kwargs).reconstruct_batch([0, 17, 99])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    with pytest.raises(IndexError):
        tm.DenseIndex(base, device="cpu").reconstruct_batch([100])
    assert tm.DenseIndex(base, device="cpu").reconstruct_batch(
        []).shape == (0, 16)


def test_dense_index_differential_fuzz():
    """tests/test_mips.py's randomized sweep (awkward N, d, k, Q, l2norm):
    every exact-selection mode against np.argsort and the JAX index."""
    rng = np.random.default_rng(42)
    for trial in range(8):
        n = int(rng.choice([37, 129, 800, 1000, 2049]))
        d = int(rng.choice([8, 32, 48]))
        q_count = int(rng.choice([1, 5, 17]))
        k = int(rng.choice([1, 3, min(64, n), min(n, 200)]))
        do_norm = bool(rng.integers(0, 2))
        kb = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((q_count, d)).astype(np.float32)
        kb_ref = kb if not do_norm else kb / np.maximum(
            np.linalg.norm(kb, axis=1, keepdims=True), 1e-12)
        q_ref = q if not do_norm else q / np.maximum(
            np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        ref_s, ref_i = jm.exact_topk_numpy(q_ref, kb_ref, min(k, n))
        for mode in ("fast", "global"):
            msg = f"{trial=} {mode=} {n=} {k=}"
            s, i = tm.DenseIndex(kb, do_l2norm=do_norm, mode=mode,
                                 chunk_size=256,
                                 device="cpu").search_batch(q, k=k)
            j_s, j_i = jm.DenseIndex(kb, do_l2norm=do_norm, mode=mode,
                                     chunk_size=256).search_batch(q, k=k)
            np.testing.assert_array_equal(i, ref_i, err_msg=msg)
            np.testing.assert_array_equal(i, j_i, err_msg=msg)
            np.testing.assert_allclose(s, ref_s, **TOL, err_msg=msg)
            np.testing.assert_allclose(s, j_s, **TOL, err_msg=msg)


def test_streaming_index_matches_exact():
    """Chunk boundaries, the tail chunk, k > chunk_rows, k > n and l2norm,
    against np.argsort, the JAX streaming index and DenseIndex."""
    rng = np.random.default_rng(9)
    kb = rng.standard_normal((1337, 32)).astype(np.float32)
    q = rng.standard_normal((7, 32)).astype(np.float32)
    index = tm.StreamingDenseIndex(kb, chunk_rows=256, dtype=torch.float32,
                                   device="cpu")
    ref = jm.StreamingDenseIndex(kb, chunk_rows=256, dtype=jnp.float32)
    for k in (20, 300):
        s, i = index.search_batch(q, k=k)
        ref_s, ref_i = ref.search_batch(q, k=k)
        np.testing.assert_array_equal(i, jm.exact_topk_numpy(q, kb, k)[1])
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_allclose(s, ref_s, **TOL)
    small = tm.StreamingDenseIndex(kb[:50], chunk_rows=256,
                                   dtype=torch.float32, device="cpu")
    s, i = small.search_batch(q, k=60)
    assert i.shape == (7, 60) and i.dtype == np.int32
    assert (i[:, 50:] == tm.INT32_MAX).all() and np.isneginf(s[:, 50:]).all()
    stream_n = tm.StreamingDenseIndex(kb, chunk_rows=512, do_l2norm=True,
                                      dtype=torch.float32, device="cpu")
    dense_n = tm.DenseIndex(kb, do_l2norm=True, mode="global", device="cpu")
    s_s, i_s = stream_n.search_batch(q, k=15)
    s_d, i_d = dense_n.search_batch(q, k=15)
    np.testing.assert_array_equal(i_s, i_d)
    np.testing.assert_allclose(s_s, s_d, **TOL)


def test_streaming_index_bf16_matches_jax_on_integers():
    """bf16 chunks: scores rounded to bf16, masked, selected per chunk and
    merged; integer inputs make the sums exact, so bit-identical."""
    rng = np.random.default_rng(12)
    kb = rng.integers(-3, 4, (700, 16)).astype(np.float32)
    q = rng.integers(-3, 4, (5, 16)).astype(np.float32)
    got = tm.StreamingDenseIndex(kb, chunk_rows=256,
                                 device="cpu").search_batch(q, k=40)
    ref = jm.StreamingDenseIndex(kb, chunk_rows=256).search_batch(q, k=40)
    _assert_same(got, ref, exact_scores=True)


def test_streaming_index_add():
    rng = np.random.default_rng(10)
    base = rng.standard_normal((300, 16)).astype(np.float32)
    extra = rng.standard_normal((270, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    index = tm.StreamingDenseIndex(base, chunk_rows=256, dtype=torch.float32,
                                   device="cpu")
    index.add(extra)  # fills chunk 1's padding and spills into chunk 2
    assert index.n == 570 and len(index._chunks) == 3
    s, i = index.search_batch(q, k=30)
    ref_s, ref_i = jm.exact_topk_numpy(q, np.concatenate([base, extra]), 30)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, **TOL)
    ref = jm.StreamingDenseIndex(base, chunk_rows=256, dtype=jnp.float32)
    ref.add(extra)
    _assert_same((s, i), ref.search_batch(q, k=30))


def test_streaming_index_empty_then_add():
    index = tm.StreamingDenseIndex(np.zeros((0, 16), np.float32),
                                   chunk_rows=256, dtype=torch.float32,
                                   device="cpu")
    q = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
    s, i = index.search_batch(q, k=5)
    assert s.shape == (3, 5) and (s == tm.NEG_INF).all()
    assert (i == tm.INT32_MAX).all()
    index.add(np.eye(16, dtype=np.float32)[:4] * 3.0)
    s, i = index.search_batch(q, k=2)
    assert (i != tm.INT32_MAX).all() and (i < 4).all()


def test_dense_index_rows_128_aligned():
    rng = np.random.default_rng(3)
    kb = rng.standard_normal((333, 16)).astype(np.float32)
    for mode in ("global", "approx", "fast", "exact", "fused"):
        index = tm.DenseIndex(kb, mode=mode, device="cpu")
        assert index.matrix.shape == (384, 16), mode
        assert not index.matrix[333:].any()
        _, i = index.search_batch(kb[:4], k=3)
        np.testing.assert_array_equal(i[:, 0], np.arange(4))  # self-hit
    with pytest.raises(ValueError, match="unknown top-k mode"):
        tm.DenseIndex(kb, mode="nope", device="cpu")


@pytest.mark.parametrize("kwargs", [dict(), dict(do_l2norm=True),
                                    dict(mode="fused")],
                         ids=["f32", "l2norm", "bf16"])
def test_npz_files_interchange_with_jax(tmp_path, kwargs):
    """A file saved by either package loads in the other, with the same
    vectors, do_l2norm, source_dtype and search results."""
    rng = np.random.default_rng(8)
    kb = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    port = tm.DenseIndex(kb, device="cpu", **kwargs)
    ref = jm.DenseIndex(kb, **kwargs)
    port.save(tmp_path / "port")
    ref.save(tmp_path / "jax.npz")
    ours, theirs = (np.load(tmp_path / "port.npz"),
                    np.load(tmp_path / "jax.npz"))
    assert sorted(ours.files) == sorted(theirs.files)
    assert str(ours["source_dtype"]) == str(theirs["source_dtype"])
    assert bool(ours["do_l2norm"]) == bool(theirs["do_l2norm"])
    np.testing.assert_allclose(ours["vectors"], theirs["vectors"],
                               rtol=1e-6, atol=1e-7)
    mode = kwargs.get("mode", "fast")
    in_port = tm.DenseIndex.load(tmp_path / "jax.npz", mode=mode,
                                 device="cpu")
    in_jax = jm.DenseIndex.load(tmp_path / "port", mode=mode)
    assert in_port.do_l2norm == in_jax.do_l2norm == kwargs.get("do_l2norm",
                                                               False)
    s, i = in_port.search_batch(q, k=7)
    ref_s, ref_i = in_jax.search_batch(q, k=7)
    assert np.mean(i == ref_i) >= 0.99
    np.testing.assert_allclose(s, ref_s, rtol=1e-2 if mode == "fused" else
                               2e-5, atol=1e-2 if mode == "fused" else 2e-5)
    np.testing.assert_array_equal(
        in_port.reconstruct_batch(np.arange(300)),
        port.reconstruct_batch(np.arange(300)) if mode == "fused"
        else theirs["vectors"])
