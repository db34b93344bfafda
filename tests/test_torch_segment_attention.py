"""The fused attention of a packed canvas (ops/segment_attention.py) and
its seam in ``layers.mha`` and the encoders.

On any host: the plain version :func:`segment_attention_plain`, which
works tile by tile as the kernel does (each tile's key range, the padding
queries' mean), against the plain path of ``mha``
(``layers.plain_attention`` with the bias from
``attention_bias_from_segments``), held to the order of the f32 sums, and
a planted check that a lost rounding point leaves that bound; which path
``mha`` takes, read from its counters; the wrapper's checks and the
arguments it hands to the C entry, with the launch stubbed.

On the card (``-m cuda``; they skip without one): the kernel against the
plain version at the reader's and the retriever's shapes, and the reader,
the packed embedder and the answer path with the kernel against the same
calls on the plain path. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_segment_attention.py -q
"""
import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from viquae_torch.core import profiling
from viquae_torch.kernels import build
from viquae_torch.models import layers as TL
from viquae_torch.ops import packing
from viquae_torch.ops import segment_attention as SA

torch.set_num_threads(2)

HD = SA.HEAD_DIM


def _segments(kind: str, rows: int, length: int, rng) -> torch.Tensor:
    """(rows, length) int32 segment ids, 0 = padding, of one layout."""
    seg = np.zeros((rows, length), np.int32)
    for r in range(rows):
        if kind == "one":               # one segment, then padding
            seg[r, : rng.integers(length // 2, length)] = 1
        elif kind == "several":         # packed runs of 5-40 tokens
            c, s = 0, 0
            while c < length - 4:
                n = int(rng.integers(5, 40))
                s += 1
                seg[r, c: c + n] = s
                c += n
            seg[r, c:] = 0
        elif kind == "crossing":        # 40..100 straddles a 64-token tile
            seg[r, :40], seg[r, 40:100], seg[r, 100:120] = 1, 2, 3
        elif kind == "singletons":      # length-1 segments among longer ones
            seg[r, :3], seg[r, 3], seg[r, 4], seg[r, 5:9] = 1, 2, 3, 4
            seg[r, 9] = 5
        elif kind == "padding_rows":    # every other row all padding
            if r % 2:
                seg[r, : length // 3] = 1
        else:
            raise ValueError(kind)
    return torch.from_numpy(seg)


def _qkv(rows, length, width, seed, device="cpu"):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    # logits of a few units, as a trained encoder's: some probabilities
    # near 1, many small
    q, k, v = (torch.randn((rows, length, width), generator=gen) * s
               for s in (2.0, 2.0, 1.0))
    return q.to(device), k.to(device), v.to(device)


EPS = 2.0 ** -24         # f32's unit roundoff


def _bounds(q, k, v, segment_ids, probs_dtype):
    """Per context entry of f32 q, k, v (R, L, width): (how far two orders
    of the f32 sums can move it, one bf16 rounding step of every
    probability on top of that).

    The kernel, its plain version and ``layers.plain_attention`` (the
    plain path of ``mha``) sum in other orders. Where both sides round
    every probability to the same value, each side's p . v over at most L
    keys is within L f32 ulps of P . |v| (P the probabilities) of the
    exact sum. With f32 probabilities the logits differ too: each is a sum
    of 64 products, within 64 ulps of |q| . |k| / 8 a side, and a change
    of d in the logits moves each probability by 2d relatively; the
    softmax's own sums, exp and division add L + 40 ulps a side (40 for
    the exponent's subtraction, whose terms beyond it are below 1e-14).
    A bf16 rounding step moves a probability by at most 2^-7 of it."""
    rows, length, width = q.shape
    bias = TL.attention_bias_from_segments(segment_ids)
    spread = TL.plain_attention(q, k, v.abs(), bias, HD, probs_dtype)
    rel = 2 * length * EPS
    if probs_dtype != torch.bfloat16:
        def heads(t):
            return t.abs().reshape(rows, length, -1, HD).transpose(1, 2)

        logit = 2 * HD * EPS * torch.matmul(
            heads(q), heads(k).transpose(-1, -2)).amax(-1) / 8  # (R, H, L)
        rel = rel + 2 * logit + 2 * (length + 40) * EPS
        rel = rel.transpose(1, 2).repeat_interleave(HD, dim=2)
    reorder = rel * spread
    return reorder, reorder + 2.0 ** -7 * spread


def _assert_within_reordering(got, want, q, k, v, segment_ids, probs_dtype):
    """``got`` is ``want`` but for the order of the f32 sums: every entry
    within the reordering bound of :func:`_bounds` but at most one in 10^3,
    and those within one bf16 rounding step. A probability whose two f32
    values straddle a bf16 rounding midpoint rounds to either neighbour,
    which moves the 64 entries of its (query, head) by one step of it: on
    the card the kernel's entries past the bound are 6.4e-5 and 6.9e-5 of
    all at the main path's shapes, the plain version's on the CPU none. A
    lost rounding point (f32 probabilities, or truncation in place of
    rounding to nearest) moves more than half the entries past the bound
    (``test_a_lost_rounding_point_leaves_the_bound``)."""
    reorder, step = _bounds(q, k, v, segment_ids, probs_dtype)
    err = (got - want).abs()
    over = float((err > reorder).float().mean())
    assert over <= 1e-3, f"{over:.2e} of the entries off by more than " \
        f"the f32 reordering"
    assert (err <= step).all()


def _share_past_reordering(a, b, q, k, v, segment_ids):
    """Of the entries of real queries, the share where bf16-rounded ``a``
    and ``b`` differ by more than the reordering bound."""
    reorder, _ = _bounds(q, k, v, segment_ids, torch.bfloat16)
    over = (a - b).abs() > reorder
    real = (segment_ids > 0)[..., None].to(over.device).expand_as(over)
    return float(over[real].float().mean())


def _assert_padding_queries_get_the_mean(ctx, v, segment_ids, probs_dtype):
    rows, length, width = v.shape
    uniform = torch.tensor(1.0 / length)
    if probs_dtype == torch.bfloat16:
        uniform = uniform.to(torch.bfloat16).float()
    for r in range(rows):
        pad = segment_ids[r] <= 0
        if pad.any():
            mean = uniform * v[r].sum(dim=0)
            torch.testing.assert_close(
                ctx[r][pad].cpu(), mean.expand(int(pad.sum()), width).cpu(),
                rtol=1e-5, atol=1e-6)


_LAYOUTS = [("one", 64, 12), ("one", 256, 12), ("several", 64, 12),
            ("several", 256, 12), ("crossing", 256, 12),
            ("singletons", 64, 12), ("padding_rows", 256, 12),
            ("several", 256, 6), ("one", 100, 6)]
_LAYOUT_IDS = ["one-64", "one-256", "several-64", "several-256",
               "crossing-256", "singletons-64", "padding-rows-256",
               "several-256-tp6", "one-100-tp6"]


def _layout(kind, length, heads):
    """A seeded canvas of 4 rows: (q, k, v, segment ids)."""
    rng = np.random.default_rng(length + heads)
    seg = _segments(kind, 4, length, rng)
    return _qkv(4, length, heads * HD, seed=length + heads) + (seg,)


@pytest.mark.parametrize("probs_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,length,heads", _LAYOUTS, ids=_LAYOUT_IDS)
def test_plain_version_equals_the_plain_path(kind, length, heads,
                                             probs_dtype):
    """Rows of 64 and 256 (and a ragged 100), 12 heads and a
    tensor-parallel shard of 6: the tile-by-tile version gives the plain
    path's context (``layers.plain_attention`` with the block-diagonal
    bias) but for the order of its f32 sums (``_bounds``), and its padding
    queries the mean of v."""
    q, k, v, seg = _layout(kind, length, heads)
    got = SA.segment_attention_plain(q, k, v, seg, probs_dtype)
    want = TL.plain_attention(q, k, v, TL.attention_bias_from_segments(seg),
                              HD, probs_dtype)
    assert got.shape == want.shape and got.dtype == torch.float32
    _assert_within_reordering(got, want, q, k, v, seg, probs_dtype)
    _assert_padding_queries_get_the_mean(got, v, seg, probs_dtype)
    # the wrapper takes the plain version for CPU tensors
    before = SA.segment_attention.launches
    assert torch.equal(SA.segment_attention(q, k, v, seg, probs_dtype), got)
    assert SA.segment_attention.launches == before


@pytest.mark.parametrize("kind,length,heads", _LAYOUTS, ids=_LAYOUT_IDS)
def test_a_lost_rounding_point_leaves_the_bound(kind, length, heads):
    """The reordering bound is far finer than the rounding point it
    guards: the plain version with f32 probabilities differs from it with
    bf16 ones past the bound at more than half the entries of real
    queries (0.69-0.995 here; those that stay are entries whose
    probabilities are exactly 0 or 1). Truncating in place of rounding to
    nearest moves half the probabilities by a whole bf16 step, so it
    leaves the bound as widely."""
    q, k, v, seg = _layout(kind, length, heads)
    rounded = SA.segment_attention_plain(q, k, v, seg, torch.bfloat16)
    kept = SA.segment_attention_plain(q, k, v, seg, torch.float32)
    assert _share_past_reordering(rounded, kept, q, k, v, seg) > 0.5


def _attn(width: int, seed: int, requires_grad=False) -> nn.ModuleDict:
    mod = TL.mha_init(width)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.15)
    return mod.requires_grad_(requires_grad)


def _counted(fn):
    """``fn()`` with tracing on: (its result, the attention counters)."""
    profiling.recorded()    # seen off, so that the profile starts afresh
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
        counters = profiling.recorded().counters
    return out, {name: counters.get(f"attention.{name}_calls", 0)
                 for name in ("fused", "plain")}


class _OnCard:
    """A CPU tensor that says it lies on a CUDA device, so that the
    selection and the wrapper take their kernel branch here; everything
    else is the tensor's own."""

    is_cuda = True

    def __init__(self, tensor):
        self._tensor = tensor

    def __getattr__(self, name):
        return getattr(self._tensor, name)


def _as_on_the_card(monkeypatch):
    """Let ``mha`` choose for CPU tensors as it would for the same tensors
    on the card (every other condition of ``takes_fused_attention``
    unchanged); the kernel's wrapper then runs its plain version."""
    choose = TL.takes_fused_attention
    monkeypatch.setattr(TL, "takes_fused_attention",
                        lambda x, *rest: choose(_OnCard(x), *rest))


# each case: (hidden size, heads, row length, mha keyword arguments, grad
# on with weights that require it); "fused" and "rate-0" take the kernel
_SELECTION = {
    "fused": (768, 12, 64, {}, False),
    "rate-0": (768, 12, 64, {"seed": 7, "dropout_rate": 0.0}, False),
    "grad": (768, 12, 64, {}, True),
    "dropout": (768, 12, 64, {"seed": 7, "dropout_rate": 0.1}, False),
    "mask-bias": (768, 12, 64, {"segments": False}, False),
    "cross": (768, 12, 64, {"kv": True}, False),
    "seq-axis": (768, 12, 64, {"seq_axis": "model"}, False),
    "head-dim-32": (384, 12, 64, {}, False),
    "long-rows": (128, 2, 520, {}, False),
    "f16": (768, 12, 64, {"compute_dtype": torch.float16}, False),
}


@pytest.mark.parametrize("case", list(_SELECTION))
def test_mha_takes_the_kernel_only_where_it_applies(monkeypatch, case):
    """``takes_fused_attention`` holds, for tensors on the card, only for
    packed self-attention without dropout or gradients, without a
    sequence axis, with heads of 64, rows of at most 512 and bf16 or f32
    probabilities; on the CPU ``mha`` never takes the kernel. Choosing as
    on the card, every ``mha`` call counts the path it took, and where it
    took the kernel's the output is the plain path's within one bf16
    rounding step of a probability passed through the output
    projection."""
    dim, n_heads, length, kw, grad = _SELECTION[case]
    kw = dict(kw)
    rng = np.random.default_rng(3)
    seg = _segments("several", 2, length, rng)
    x = torch.randn((2, length, dim), generator=torch.Generator()
                    .manual_seed(4))
    attn = _attn(dim, seed=5, requires_grad=grad)
    kw.setdefault("compute_dtype", torch.bfloat16)
    if kw.pop("segments", True):
        kw.update(segment_ids=seg, bias=TL.attention_bias_from_segments(seg))
    else:
        kw["bias"] = TL.attention_bias_from_mask(seg > 0)
    if kw.pop("kv", False):
        kw["kv"] = x.flip(1)
    fused = case in ("fused", "rate-0")

    def choice(x):
        return TL.takes_fused_attention(
            x, kw.get("kv"), kw.get("segment_ids"), n_heads,
            kw["compute_dtype"], kw.get("dropout_rate", 0.0),
            kw.get("seed"), kw.get("seq_axis"), attn.parameters())

    with torch.set_grad_enabled(grad):
        assert choice(_OnCard(x)) == fused
        assert not choice(x)
        want, counts = _counted(lambda: TL.mha(attn, x, n_heads=n_heads,
                                               **kw))
        assert counts == {"fused": 0, "plain": 1}
        _as_on_the_card(monkeypatch)
        got, counts = _counted(lambda: TL.mha(attn, x, n_heads=n_heads,
                                              **kw))
    assert counts == {"fused": int(fused), "plain": int(not fused)}
    if fused:
        # a context entry moves by at most 2^-7 max|v| (the rounding step
        # of its probabilities) and its bf16 rounding by 2^-8 of it
        v = TL.dense(attn["v"], x, kw["compute_dtype"])
        bound = 2.0 ** -6 * v.abs().amax() * attn["o"].weight.abs().sum(1)
        assert ((got - want).abs() <= bound).all()
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "training"])
def test_encoder_builds_the_bias_only_for_the_plain_path(monkeypatch, grad):
    """``bert.encode`` hands the layers the segment ids and a bias built
    where a layer first takes the plain path. Choosing as on the card: at
    inference every layer takes the kernel's path and no bias is built;
    with gradients (training) the bias is built once and every layer is
    plain."""
    from viquae_torch.models import bert as tbert

    _as_on_the_card(monkeypatch)
    built = []
    orig = TL.attention_bias_from_segments
    monkeypatch.setattr(TL, "attention_bias_from_segments",
                        lambda s: built.append(1) or orig(s))
    cfg = tbert.BertConfig(vocab_size=50, hidden_size=128,
                           num_hidden_layers=3, num_attention_heads=2,
                           intermediate_size=256, max_position_embeddings=64,
                           add_pooler=False)
    model = TL.seeded(tbert.Bert, cfg, seed=0, device="cpu")
    model.requires_grad_(grad)
    seg = _segments("several", 2, 64, np.random.default_rng(0))
    ids = torch.randint(1, 50, (2, 64), generator=torch.Generator()
                        .manual_seed(1))
    with torch.set_grad_enabled(grad):
        out, counts = _counted(lambda: tbert.apply(
            model, cfg, ids, segment_ids=seg, compute_dtype=torch.bfloat16))
    assert torch.isfinite(out["last_hidden_state"]).all()
    layers = cfg.num_hidden_layers
    assert counts == ({"fused": 0, "plain": layers} if grad
                      else {"fused": layers, "plain": 0})
    assert len(built) == (1 if grad else 0)


# ---- the wrapper's checks, with the launch stubbed ------------------------
@pytest.fixture
def launched(monkeypatch):
    calls = []
    monkeypatch.setattr(SA, "launch", lambda *args: calls.append(args))
    return calls


def test_wrapper_hands_strides_and_kinds_to_the_c_entry(launched):
    """q, k, v as column blocks of one (R, L, 3 x width) projection: the
    kernel reads them through their strides, without a copy."""
    qkv = torch.zeros((3, 100, 3 * 384))
    q, k, v = (_OnCard(t) for t in qkv.split(384, dim=2))
    seg = _OnCard(torch.zeros((3, 100), dtype=torch.int64))
    before = SA.segment_attention.launches
    ctx = SA.segment_attention(q, k, v, seg, torch.bfloat16)
    assert SA.segment_attention.launches == before + 1
    (lib, entry, *args), = launched
    assert (lib, entry) == ("segment_attention", "segment_attention_launch")
    assert args[0] is q and args[1] is k and args[2] is v and args[3] is seg
    assert args[4] is ctx and ctx.shape == (3, 100, 384)
    assert args[5:] == [3, 100, 6, 100 * 1152, 1152, 100 * 1152, 1152,
                        100 * 1152, 1152, 8, 1]
    # the stream is added by build.launch
    assert len(args) + 1 == len(build._SIGNATURES[lib][entry][0])


def _case(shape=(2, 64, 128), dtype=torch.float32, seg_dtype=torch.int32,
          seg_shape=None, tensor=None):
    q = tensor if tensor is not None else torch.zeros(shape, dtype=dtype)
    seg = torch.zeros(seg_shape or shape[:2], dtype=seg_dtype)
    return _OnCard(q), _OnCard(q), _OnCard(q), _OnCard(seg)


@pytest.mark.parametrize("make,error,match", [
    (lambda: _case(dtype=torch.bfloat16), TypeError, "float32"),
    (lambda: _case(seg_dtype=torch.int16), TypeError, "int32 or int64"),
    (lambda: _case(shape=(2, 64, 96)), ValueError, "64-wide heads"),
    (lambda: _case(shape=(1, 520, 64)), ValueError, "at most 512"),
    (lambda: _case(seg_shape=(2, 63)), ValueError, "segment_ids must"),
    (lambda: _case(tensor=torch.zeros((2, 128, 64)).transpose(1, 2)),
     ValueError, "last stride 1"),
    (lambda: _case(tensor=torch.zeros(2 * 64 * 128 + 1)[1:].view(
        2, 64, 128)), ValueError, "16-byte"),
    (lambda: (torch.zeros((2, 64, 128)),) + _case()[1:], ValueError,
     "CUDA device"),
], ids=["bf16", "int16-ids", "width-96", "long-rows", "ids-shape",
        "transposed", "off-16B", "q-on-cpu"])
def test_wrapper_rejects_what_the_kernel_does_not_take(launched, make, error,
                                                       match):
    with pytest.raises(error, match=match):
        SA.segment_attention(*make())
    assert not launched


def test_probabilities_are_f32_or_bf16():
    q = torch.zeros((1, 8, 64))
    with pytest.raises(TypeError, match="f32 or rounded to bf16"):
        SA.segment_attention(q, q, q, torch.ones((1, 8), dtype=torch.int32),
                             torch.float16)


# ---- on the card ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _packed_segments(rng, rows_hint, row_len, mean, spread, lo, hi):
    """Segment ids of a canvas that ``ops/packing`` packs from seeded
    lengths (normal(mean, spread) clipped to [lo, hi])."""
    lengths = np.clip(rng.normal(mean, spread, rows_hint * (row_len // mean)),
                      lo, hi).astype(int)
    seqs = [np.ones(n, np.int32) for n in lengths]
    return torch.from_numpy(packing.pack_token_sequences(
        seqs, row_len, pad_rows_to=8).segment_ids)


# the reader: pairs of ~146 tokens on rows of 256; the retriever: questions
# of ~18-20 tokens on rows of 64
_SHAPES = {"reader": (256, 146, 20, 40, 256, 384),
           "retriever": (64, 19, 7, 8, 64, 400)}


@pytest.mark.cuda
@pytest.mark.parametrize("probs_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_kernel_equals_plain_version_at_the_main_paths_shapes(cuda, shape,
                                                              probs_dtype):
    """Seeded canvases at the reader's and the retriever's shapes, 12
    heads: the kernel's context is its plain version's and the plain
    path's but for the order of the f32 sums (``_bounds``), its padding
    queries get the mean of v, and its bf16 and f32 probabilities differ
    past that bound (the rounding point is the kernel's)."""
    row_len, mean, spread, lo, hi, rows = _SHAPES[shape]
    seg = _packed_segments(np.random.default_rng(rows), rows, row_len,
                           mean, spread, lo, hi)
    q, k, v = _qkv(seg.shape[0], row_len, 12 * HD, seed=1, device=cuda)
    seg = seg.to(cuda)
    before = SA.segment_attention.launches
    got = SA.segment_attention(q, k, v, seg, probs_dtype)
    torch.cuda.synchronize()
    assert SA.segment_attention.launches == before + 1
    twin = SA.segment_attention_plain(q, k, v, seg, probs_dtype)
    _assert_within_reordering(got, twin, q, k, v, seg, probs_dtype)
    plain = TL.plain_attention(q, k, v, TL.attention_bias_from_segments(seg),
                               HD, probs_dtype)
    _assert_within_reordering(got, plain, q, k, v, seg, probs_dtype)
    _assert_padding_queries_get_the_mean(got, v, seg, probs_dtype)
    other = torch.float32 if probs_dtype == torch.bfloat16 else \
        torch.bfloat16
    assert _share_past_reordering(
        got, SA.segment_attention(q, k, v, seg, other), q, k, v, seg) > 0.5
    # int64 ids and q, k, v read as column blocks of one projection
    qkv = torch.cat([q, k, v], dim=2)
    again = SA.segment_attention(*qkv.split(12 * HD, dim=2), seg.long(),
                                 probs_dtype)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_kernel_edge_layouts_on_the_card(cuda):
    """Every CPU layout (length-1 segments, a segment across a tile edge,
    all-padding rows, a ragged row of 100, rows of 512) on the card."""
    rng = np.random.default_rng(0)
    for kind, length in (("singletons", 64), ("crossing", 256),
                         ("padding_rows", 256), ("one", 100),
                         ("several", 512)):
        seg = _segments(kind, 6, length, rng).to(cuda)
        q, k, v = _qkv(6, length, 12 * HD, seed=length, device=cuda)
        got = SA.segment_attention(q, k, v, seg)
        want = SA.segment_attention_plain(q, k, v, seg)
        _assert_within_reordering(got, want, q, k, v, seg, torch.bfloat16)
        _assert_padding_queries_get_the_mean(got, v, seg, torch.bfloat16)


@pytest.mark.cuda
def test_encoder_on_the_card_builds_no_bias_at_inference(cuda, monkeypatch):
    """On the card, with the selection as it is: a packed encoder at heads
    of 64 takes the kernel in every layer and builds no dense bias at
    inference; with gradients it builds the bias once and every layer is
    plain."""
    from viquae_torch.models import bert as tbert

    built = []
    orig = TL.attention_bias_from_segments
    monkeypatch.setattr(TL, "attention_bias_from_segments",
                        lambda s: built.append(1) or orig(s))
    cfg = tbert.BertConfig(vocab_size=50, hidden_size=128,
                           num_hidden_layers=3, num_attention_heads=2,
                           intermediate_size=256, max_position_embeddings=64,
                           add_pooler=False)
    model = TL.seeded(tbert.Bert, cfg, seed=0, device=cuda)
    seg = _segments("several", 2, 64, np.random.default_rng(0)).to(cuda)
    ids = torch.randint(1, 50, (2, 64), device=cuda)
    for grad in (False, True):
        model.requires_grad_(grad)
        built.clear()
        with torch.set_grad_enabled(grad):
            _, counts = _counted(lambda: tbert.apply(
                model, cfg, ids, segment_ids=seg,
                compute_dtype=torch.bfloat16))
        assert counts == ({"fused": 0, "plain": 3} if grad
                          else {"fused": 3, "plain": 0})
        assert len(built) == int(grad)


def _plain_on_the_card(monkeypatch):
    monkeypatch.setattr(TL, "takes_fused_attention", lambda *args: False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_reader_with_the_kernel_matches_the_plain_path(cuda, monkeypatch,
                                                       dtype):
    """A 4-layer packed reader at BERT-base's head size: logits with the
    kernel against the same forward on the plain path. In f32 only the
    order of the attention's sums differs: rtol = atol = 1e-4 after four
    layers. In bf16 a probability or an activation within an f32 ulp of a
    bf16 rounding boundary may round the other way, and the layers carry
    it on: within bf16 resolution, rtol = atol = 2e-2 (as
    tests/test_torch_cuda.py holds the bf16 GEMM to the upcast one)."""
    from viquae_torch.models import bert as tbert
    from viquae_torch.models import qa as tqa

    cfg = tqa.ReaderConfig(bert=tbert.BertConfig(
        vocab_size=3000, hidden_size=256, num_hidden_layers=4,
        num_attention_heads=4, intermediate_size=1024,
        max_position_embeddings=256, add_pooler=False), fuse_ir_score=False)
    model = TL.seeded(tqa.Reader, cfg, seed=0, device=cuda).to(dtype)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(5, 3000, n).astype(np.int32)
            for n in np.clip(rng.normal(146, 20, 96), 40, 256).astype(int)]
    p = packing.pack_token_sequences(seqs, 256, pad_rows_to=8)
    ids, seg, pos = (torch.from_numpy(a).to(cuda) for a in (
        p.input_ids, p.segment_ids, p.position_ids))
    tt = (pos > 8).int()
    n = len(seqs)
    gather = torch.zeros((n, 256), dtype=torch.int64)
    mask = torch.zeros((n, 256), dtype=torch.int32)
    for i, s in enumerate(seqs):
        start = int(p.cls_rows[i]) * 256 + int(p.cls_cols[i])
        gather[i, :len(s)] = torch.arange(start, start + len(s))
        mask[i, :len(s)] = 1
    gather, mask = gather.to(cuda), mask.to(cuda)

    def forward():
        with torch.no_grad():
            return tqa.reader_apply_packed(
                model, cfg, ids, seg, pos, tt, gather, mask, m_passages=8,
                compute_dtype=torch.bfloat16 if dtype == torch.bfloat16
                else torch.float32)

    before = SA.segment_attention.launches
    got = forward()
    assert SA.segment_attention.launches == before + 4
    _plain_on_the_card(monkeypatch)
    ref = forward()
    assert SA.segment_attention.launches == before + 4
    real = mask > 0
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in ((got.start_logits, ref.start_logits),
                 (got.end_logits, ref.end_logits)):
        assert torch.isfinite(a[real]).all()
        torch.testing.assert_close(a[real], b[real], rtol=tol, atol=tol)


@pytest.mark.cuda
def test_packed_embedder_with_the_kernel_matches_the_plain_path(cuda,
                                                                monkeypatch):
    """The DPR question tower through ``PackedTextEmbedder`` in bf16, rows
    of 64: CLS vectors with the kernel against the plain path within bf16
    resolution, rtol = atol = 2e-2 (the reason of the reader's test)."""
    from viquae_torch.ir.embedding import PackedTextEmbedder
    from viquae_torch.models import bert as tbert
    from viquae_torch.models import dpr as tdpr

    cfg = tdpr.DPRConfig(bert=tbert.BertConfig(
        vocab_size=300, hidden_size=256, num_hidden_layers=4,
        num_attention_heads=4, intermediate_size=1024,
        max_position_embeddings=64, add_pooler=False))
    model = TL.seeded(tbert.Bert, cfg.bert, seed=1, device=cuda).to(
        torch.bfloat16)
    tok = _WordTokenizer()
    rng = np.random.default_rng(1)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 290, n))
             for n in rng.integers(6, 30, 200)]

    def embed():
        emb = PackedTextEmbedder(tdpr.make_packed_apply(cfg), model, tok,
                                 row_len=64, batch_size=256,
                                 compute_dtype=torch.bfloat16, device=cuda)
        return emb(texts)[:200]

    before = SA.segment_attention.launches
    got = embed()
    assert SA.segment_attention.launches == before + 4
    _plain_on_the_card(monkeypatch)
    ref = embed()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)


class _WordTokenizer:
    """``w<i>`` -> id 5 + i, with what the embedder and the answer pipeline
    call (the tokenizer of tests/test_torch_cuda.py)."""

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


@pytest.mark.cuda
def test_answer_path_with_the_kernel_gives_the_plain_paths_answers(
        cuda, monkeypatch):
    """``AnswerPipeline.run`` in f32 at heads of 64, packed retrieval and
    reader: with the kernel it gives the plain path's passages, spans and
    answers (scores within 1e-4: only the order of the attention's sums
    differs)."""
    from viquae_torch.ir.embedding import PackedTextEmbedder
    from viquae_torch.ir.qa_serving import AnswerPipeline
    from viquae_torch.ir.serving import FusedRetrievalPipeline
    from viquae_torch.models import bert as tbert
    from viquae_torch.models import dpr as tdpr
    from viquae_torch.models import qa as tqa
    from viquae_torch.ops import mips as tm

    bcfg = tbert.BertConfig(
        vocab_size=300, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=128, add_pooler=False)
    dcfg = tdpr.DPRConfig(bert=bcfg)
    rcfg = tqa.ReaderConfig(bert=bcfg, fuse_ir_score=True)
    tower = TL.seeded(tbert.Bert, bcfg, seed=0, device=cuda,
                      linear_std=0.2, embed_std=0.2)
    reader = TL.seeded(tqa.Reader, rcfg, seed=1, device=cuda,
                       linear_std=0.2, embed_std=0.2)
    rng = np.random.default_rng(0)
    tok = _WordTokenizer()
    kb_rows = [{"passage_tokens": tok(" ".join(
        f"w{j}" for j in rng.integers(0, 200, rng.integers(8, 40))),
        add_special_tokens=False)["input_ids"]} for _ in range(60)]
    kb_mat = rng.normal(size=(60, 128)).astype(np.float32)
    queries = [" ".join(f"w{j}" for j in rng.integers(
        0, 200, rng.integers(4, 9))) for _ in range(13)]

    def run():
        emb = PackedTextEmbedder(
            tdpr.make_packed_apply(dcfg), tower, tok, row_len=24,
            batch_size=8, compute_dtype=torch.float32, device=cuda)
        index = tm.DenseIndex(kb_mat, mode="global", dtype=torch.float32,
                              device=cuda)
        pipe = AnswerPipeline(
            FusedRetrievalPipeline(emb, index, batch_size=8, k=5), kb_rows,
            rcfg, reader, tok, m_passages=3, reader_seq=64,
            questions_per_step=4, passage_tokens_key="passage_tokens",
            packed_reader=True, compute_dtype=torch.float32, device=cuda)
        return pipe.run(queries)

    before = SA.segment_attention.launches
    got = run()
    assert SA.segment_attention.launches > before
    _plain_on_the_card(monkeypatch)
    ref = run()
    for a, b in zip(got, ref):
        assert a["passage_ids"] == b["passage_ids"]
        assert a["answer"] == b["answer"]
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4,
                                   rtol=1e-4)
