"""The fused glue of the post-LN encoder block (ops/encoder_glue.py) and
its seam in ``bert._layer_forward``.

On any host: the plain twins against the plain path's own operations, bit
for bit; which path a block takes (``layers.takes_fused_glue``), read from
its counters, and that a block or a whole encoder choosing as on the card
(the twins in the kernels' place) gives the plain path's values bit for
bit; that a training step counts no fused block; the stated f32 bound of
kernel A and a planted check that a lost rounding point leaves it; the
wrappers' checks and the arguments they hand to the C entries, with the
launch stubbed.

On the card (``-m cuda``; they skip without one): each kernel against its
twin at the reader's and the retriever's canvases, and the packed reader
and ``PackedTextEmbedder`` with the kernels against the plain path. This
file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_encoder_glue.py -q
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from viquae_torch.core import profiling
from viquae_torch.kernels import build
from viquae_torch.models import bert as tbert
from viquae_torch.models import layers as TL
from viquae_torch.ops import encoder_glue as EG
from viquae_torch.ops import packing

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
U = 2.0 ** -24           # f32's unit roundoff
EPS = 1e-12


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _glue_operands(tokens, width, param_dtype, seed, device="cpu"):
    """Seeded operands of kernel A in its order (y, bias, x, weight,
    shift): a GEMM output y and a residual x (T, width) f32 of unit scale,
    x with a per-row offset, and bias, LayerNorm scale and shift drawn as
    the benchmark's weights are (N(0, 0.02), 1 + N(0, 0.1)) in
    ``param_dtype``."""
    gen = _gen(seed)
    y = torch.randn((tokens, width), generator=gen)
    x = torch.randn((tokens, width), generator=gen) \
        + 0.5 * torch.randn((tokens, 1), generator=gen)
    bias, weight, shift = (
        (base + torch.randn(width, generator=gen) * scale).to(param_dtype)
        for base, scale in ((0.0, 0.02), (1.0, 0.1), (0.0, 0.02)))
    return [t.to(device) for t in (y, bias, x, weight, shift)]


def _gelu_operands(tokens, width, bias_dtype, seed, device="cpu"):
    gen = _gen(seed)
    g = torch.randn((tokens, width), generator=gen) * 1.5
    bias = (torch.randn(width, generator=gen) * 0.02).to(bias_dtype)
    return g.to(device), bias.to(device)


def _ln_module(weight, shift):
    ln = torch.nn.LayerNorm(weight.shape[0], dtype=weight.dtype)
    with torch.no_grad():
        ln.weight.copy_(weight)
        ln.bias.copy_(shift)
    return ln


# ---- the twins are the plain path's operations ---------------------------
_TWIN_CASES = [(1, 128), (7, 256), (64, 768), (33, 1024)]


@pytest.mark.parametrize("param_dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("tokens,width", _TWIN_CASES,
                         ids=[f"{t}x{w}" for t, w in _TWIN_CASES])
def test_layernorm_twin_is_the_plain_paths_operations(tokens, width,
                                                      param_dtype):
    """Kernel A's twin is, bit for bit, what ``_layer_forward`` does after
    the o (or ``mlp.out``) product: ``_leave``'s bias add, the residual,
    ``layers.layer_norm``, and ``_matmul``'s cast of its output; the
    wrapper runs it for CPU tensors and launches nothing."""
    y, bias, x, weight, shift = _glue_operands(tokens, width, param_dtype,
                                               seed=tokens)
    lin = torch.nn.Linear(width, width, dtype=param_dtype)
    with torch.no_grad():
        lin.bias.copy_(bias)
    want = TL.layer_norm(_ln_module(weight, shift),
                         x + TL._leave(y, lin, None, None), EPS)
    out, low = EG.bias_residual_layernorm_plain(y, bias, x, weight, shift,
                                                EPS)
    assert out.dtype == F32 and low.dtype == BF16
    assert torch.equal(out, want) and torch.equal(low, want.to(BF16))
    before = EG.bias_residual_layernorm.launches
    again = EG.bias_residual_layernorm(y, bias, x, weight, shift, EPS)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, low)))
    assert EG.bias_residual_layernorm.launches == before


@pytest.mark.parametrize("act", ["gelu", "gelu_exact"])
@pytest.mark.parametrize("bias_dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("tokens,width", [(1, 256), (9, 512), (40, 3072)],
                         ids=["1x256", "9x512", "40x3072"])
def test_gelu_twin_is_the_plain_paths_operations(tokens, width, bias_dtype,
                                                 act):
    """Kernel B's twin is, bit for bit, ``dense``'s bias add, the block's
    GELU (``layers.ACT``) and the ``mlp.out`` GEMM's cast of its operand."""
    g, bias = _gelu_operands(tokens, width, bias_dtype, seed=width)
    want = TL.ACT[act](g + bias).to(BF16)
    assert torch.equal(EG.bias_gelu_plain(g, bias), want)
    before = EG.bias_gelu.launches
    assert torch.equal(EG.bias_gelu(g, bias), want)
    assert EG.bias_gelu.launches == before


# ---- kernel A's bound ----------------------------------------------------
def _layernorm_reference(y, bias, x, weight, shift, eps):
    """f64 values of kernel A's formula on the same (f32) operands:
    (out, t - mean, 1 / sqrt(var + eps))."""
    y, bias, x, weight, shift = (t.double() for t in (y, bias, x, weight,
                                                      shift))
    t = x + (y + bias)
    d = t - t.mean(dim=-1, keepdim=True)
    r = torch.rsqrt((d ** 2).mean(dim=-1, keepdim=True) + eps)
    return d * r * weight + shift, d, r


def _layernorm_bound(y, bias, x, weight, shift, eps):
    """Per entry: (f64 reference, how far an f32 evaluation of kernel A's
    formula, its sums in any order, can lie from it).

    First-order error analysis, u = 2^-24: t = x + (y + b) rounds twice,
    within 2u a (a = |x| + |y| + |b|); a sum of D terms in any order is
    within (D + 1) u of the sum of their moduli, so the mean is within
    dm = (2u sum(a) + (D + 1) u sum|t|) / D + u |mean| and each d = t -
    mean within e = 2u a + dm + u |d|; the variance within (sum(2 |d| e +
    e^2) / D) (1 + (D + 2) u) + (D + 2) u var; rsqrt (CUDA's rsqrtf: 2
    ulp) within half the relative error of var + eps plus 4u; the two
    products and the shift add 3u of the output. The whole is taken 1.01
    times for the terms of second order."""
    ref, d, r = _layernorm_reference(y, bias, x, weight, shift, eps)
    y, bias, x, weight, shift = (t.double() for t in (y, bias, x, weight,
                                                      shift))
    width = y.shape[-1]
    a = x.abs() + y.abs() + bias.abs()
    t = x + (y + bias)
    dm = (2 * U * a.sum(-1, keepdim=True)
          + (width + 1) * U * t.abs().sum(-1, keepdim=True)) / width \
        + U * t.mean(-1, keepdim=True).abs()
    e = 2 * U * a + dm + U * d.abs()
    var = (d ** 2).mean(-1, keepdim=True)
    dvar = (2 * d.abs() * e + e ** 2).mean(-1, keepdim=True) * (
        1 + (width + 2) * U) + (width + 2) * U * var
    rel_r = 0.5 * (dvar + U * (var + eps)) / (var + eps) + 4 * U
    bound = weight.abs() * r * (d.abs() * (rel_r + 2 * U) + e) \
        + U * ref.abs()
    return ref, 1.01 * bound


@pytest.mark.parametrize("param_dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("width", [128, 768])
def test_layernorm_twin_lies_within_the_bound(width, param_dtype):
    """The plain twin, an f32 evaluation with PyTorch's sums, lies within
    :func:`_layernorm_bound` of the f64 reference (as the kernel must on
    the card)."""
    ops = _glue_operands(300, width, param_dtype, seed=width + 1)
    out, _ = EG.bias_residual_layernorm_plain(*ops, EPS)
    ref, bound = _layernorm_bound(*ops, EPS)
    assert ((out.double() - ref).abs() <= bound).all()


def test_a_lost_rounding_point_leaves_the_bound():
    """The bound is far finer than a bf16 rounding step: the LayerNorm of
    t rounded to bf16 (a bf16 residual stream, or the sum made in bf16)
    leaves it at more than half the entries."""
    y, bias, x, weight, shift = _glue_operands(300, 768, BF16, seed=5)
    t = (x + (y + bias)).to(BF16).float()
    out, _ = EG.bias_residual_layernorm_plain(torch.zeros_like(y),
                                              torch.zeros_like(bias), t,
                                              weight, shift, EPS)
    ref, bound = _layernorm_bound(y, bias, x, weight, shift, EPS)
    assert float(((out.double() - ref).abs() > bound).double().mean()) > 0.5


# ---- which path a block takes --------------------------------------------
def _counted(fn):
    """``fn()`` with tracing on: (its result, the glue counters)."""
    profiling.recorded()    # seen off, so that the profile starts afresh
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
        counters = profiling.recorded().counters
    return out, {name: counters.get(f"glue.{name}_calls", 0)
                 for name in ("fused", "plain")}


class _OnCard:
    """A CPU tensor that says it lies on a CUDA device, so that the
    selection and the wrappers take their kernel branch here; everything
    else is the tensor's own."""

    is_cuda = True

    def __init__(self, tensor):
        self._tensor = tensor

    def __getattr__(self, name):
        return getattr(self._tensor, name)


def _as_on_the_card(monkeypatch):
    """Let ``_layer_forward`` choose for CPU tensors as it would for the
    same tensors on the card (every other condition of
    ``takes_fused_glue`` unchanged); the kernels' wrappers then run their
    plain twins."""
    choose = TL.takes_fused_glue
    monkeypatch.setattr(TL, "takes_fused_glue",
                        lambda x, *rest: choose(_OnCard(x), *rest))


_SMALL = dict(vocab_size=60, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=256,
              max_position_embeddings=64, add_pooler=False,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)

# each case: (config changes, _layer_forward keyword arguments, weights that
# require grad with grad on, whether the block takes the kernels)
_SELECTION = {
    "fused": ({}, {}, False, True),
    "grad": ({}, {}, True, False),
    "dropout": ({"hidden_dropout_prob": 0.1,
                 "attention_probs_dropout_prob": 0.1},
                {"seeds": (7, 8, 9)}, False, False),
    "rate-0": ({}, {"seeds": (7, 8, 9)}, False, True),
    "seq-axis": ({}, {"seq_axis": "model"}, False, False),
    "split-weights": ({}, {"split": True}, False, False),
    "moe": ({"moe_experts": 2, "moe_top_k": 1}, {}, False, False),
    "f32-compute": ({}, {"compute_dtype": F32}, False, False),
    "gelu-new": ({"hidden_act": "gelu_new"}, {}, False, False),
    "width-192": ({"hidden_size": 192, "num_attention_heads": 3}, {}, False,
                  False),
    "on-the-cpu": ({}, {"cpu": True}, False, False),
}


@pytest.mark.parametrize("case", list(_SELECTION))
def test_block_takes_the_kernels_only_where_they_apply(monkeypatch, case):
    """``takes_fused_glue`` holds, for tensors on the card, only for a
    dense block with the exact GELU in bf16 without dropout or gradients,
    without a sequence axis or split weights, at a width the kernels take;
    on the CPU a block never takes them. Choosing as on the card, every
    ``_layer_forward`` call counts the path it took, gives the plain
    path's output bit for bit (on the CPU the twins stand for the kernels)
    and, where it took the kernels, its bf16 copy."""
    changes, kw, grad, fused = _SELECTION[case]
    kw = dict(kw)
    cfg = tbert.BertConfig(**{**_SMALL, **changes})
    model = TL.seeded(tbert.Bert, cfg, seed=3, device="cpu",
                      linear_std=0.2, embed_std=0.2).requires_grad_(grad)
    layer = model.layers[1]
    if kw.pop("split", False):
        for lin in (layer["attention"]["o"], layer["mlp"]["out"]):
            lin.sharded = {"weight": (1, "model")}
    on_cpu = kw.pop("cpu", False)
    kw.setdefault("compute_dtype", BF16)
    seg = torch.from_numpy(np.repeat(np.arange(1, 5), 16)[None]
                           .repeat(2, 0).astype(np.int32))
    seeds = kw.get("seeds", (None, None, None))
    x = torch.randn((2, 64, cfg.hidden_size), generator=_gen(4))
    bias = TL.attention_bias_from_segments(seg)
    rates = (cfg.attention_probs_dropout_prob, cfg.hidden_dropout_prob,
             cfg.hidden_dropout_prob)

    def choice(t):
        return TL.takes_fused_glue(t, layer, kw["compute_dtype"],
                                   cfg.hidden_act, tuple(zip(rates, seeds)),
                                   kw.get("seq_axis"))

    def forward():
        return tbert._layer_forward(layer, x, bias, cfg, kw["compute_dtype"],
                                    seeds, None, kw.get("seq_axis"), seg)

    with torch.set_grad_enabled(grad):
        # "on-the-cpu" is "fused" but for the tensors' device
        assert choice(_OnCard(x)) == (fused or on_cpu)
        assert not choice(x)
        want, counts = _counted(forward)
        assert counts == {"fused": 0, "plain": 1} and want[2] is None
        if not on_cpu:
            _as_on_the_card(monkeypatch)
        got, counts = _counted(forward)
    assert counts == {"fused": int(fused), "plain": int(not fused)}
    assert torch.equal(got[0], want[0])
    if fused:
        assert got[1] is None and torch.equal(got[2], want[0].to(BF16))
    else:
        assert got[2] is None


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "padded"])
def test_encoder_as_on_the_card_equals_the_plain_encoder(monkeypatch,
                                                         packed):
    """A 3-layer encoder choosing as on the card takes the kernels' path in
    every layer and gives the plain encoder's states bit for bit, each
    layer's with ``output_hidden_states`` too."""
    cfg = tbert.BertConfig(**{**_SMALL, "num_hidden_layers": 3})
    model = TL.seeded(tbert.Bert, cfg, seed=0, device="cpu",
                      linear_std=0.2, embed_std=0.2)
    ids = torch.randint(1, 60, (2, 64), generator=_gen(1))
    seg = torch.from_numpy(np.repeat(np.arange(0, 4), 16)[None]
                           .repeat(2, 0).astype(np.int32))
    kw = ({"segment_ids": seg} if packed
          else {"attention_mask": (seg > 0).int()})

    def run():
        return tbert.apply(model, cfg, ids, compute_dtype=BF16,
                           output_hidden_states=True, **kw)

    want, counts = _counted(run)
    assert counts == {"fused": 0, "plain": 3}
    _as_on_the_card(monkeypatch)
    got, counts = _counted(run)
    assert counts == {"fused": 3, "plain": 0}
    assert torch.equal(got["last_hidden_state"], want["last_hidden_state"])
    assert len(got["hidden_states"]) == 4
    for a, b in zip(got["hidden_states"], want["hidden_states"]):
        assert a.dtype == F32 and torch.equal(a, b)


def test_a_training_step_counts_no_fused_block(monkeypatch):
    """A ``Trainer`` step of a bf16 biencoder choosing as on the card:
    every block of the step takes the plain path (the weights require
    grad); the evaluation after it, without gradients, takes the
    kernels'."""
    from viquae_torch.train import objectives, optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    _as_on_the_card(monkeypatch)
    cfg = tbert.BertConfig(**_SMALL)
    towers = torch.nn.ModuleDict({
        name: TL.seeded(tbert.Bert, cfg, seed=s, device="cpu")
        .requires_grad_(True) for s, name in enumerate(("q", "c"))})
    ids = torch.randint(5, 60, (8, 16), generator=_gen(2))
    batch = {"q": ids, "c": ids.flip(1), "labels": torch.arange(8)}

    def loss_fn(params, batch, generator=None, deterministic=False):
        q, c = (tbert.apply(params[name], cfg, batch[name],
                            compute_dtype=BF16)["last_hidden_state"][:, 0]
                for name in ("q", "c"))
        return objectives.biencoder_loss(q, c, batch["labels"])

    trainer = Trainer(loss_fn, towers,
                      optim.make_optimizer(towers, lr=1e-3, total_steps=2),
                      TrainerConfig(max_steps=1, log_every=0))
    _, counts = _counted(lambda: trainer.fit(lambda step: batch))
    assert counts == {"fused": 0, "plain": 4}
    _, counts = _counted(lambda: trainer.evaluate([batch]))
    assert counts == {"fused": 4, "plain": 0}


# ---- the wrappers' checks, with the launch stubbed ------------------------
@pytest.fixture
def launched(monkeypatch):
    calls = []
    monkeypatch.setattr(EG, "launch", lambda *args: calls.append(args))
    return calls


def _signature(lib, entry):
    return build._SIGNATURES[lib][entry][0]


def test_layernorm_wrapper_hands_the_c_entry_its_arguments(launched):
    y, bias, x, weight, shift = (_OnCard(t) for t in _glue_operands(
        12, 768, BF16, seed=0))
    before = EG.bias_residual_layernorm.launches
    out, low = EG.bias_residual_layernorm(y, bias, x, weight, shift, 1e-5)
    assert EG.bias_residual_layernorm.launches == before + 1
    (lib, entry, *args), = launched
    assert (lib, entry) == ("encoder_glue", "bias_residual_layernorm_launch")
    assert args[0] is y and args[1] is bias and args[2] is x
    assert args[3] is weight and args[4] is shift
    assert args[5] is out and out.shape == (12, 768) and out.dtype == F32
    assert args[6] is low and low.shape == (12, 768) and low.dtype == BF16
    assert args[7:] == [12, 768, 1, 1e-5]
    # the stream is added by build.launch
    assert len(args) + 1 == len(_signature(lib, entry))


def test_gelu_wrapper_hands_the_c_entry_its_arguments(launched):
    g, bias = (_OnCard(t) for t in _gelu_operands(2 * 5, 3072, F32, seed=0))
    g = _OnCard(g._tensor.view(2, 5, 3072))
    before = EG.bias_gelu.launches
    h = EG.bias_gelu(g, bias)
    assert EG.bias_gelu.launches == before + 1
    (lib, entry, *args), = launched
    assert (lib, entry) == ("encoder_glue", "bias_gelu_launch")
    assert args[0] is g and args[1] is bias
    assert args[2] is h and h.shape == (2, 5, 3072) and h.dtype == BF16
    assert args[3:] == [10, 3072, 0]
    assert len(args) + 1 == len(_signature(lib, entry))


def _layernorm_case(width=256, rows=4, y=None, x=None, bias_dtype=BF16,
                    weight_dtype=BF16, bias_len=None):
    y = y if y is not None else torch.zeros((rows, width))
    x = x if x is not None else torch.zeros((rows, width))
    bias = torch.zeros(bias_len or width, dtype=bias_dtype)
    return (_OnCard(y), _OnCard(bias), _OnCard(x),
            _OnCard(torch.ones(width, dtype=weight_dtype)),
            _OnCard(torch.zeros(width, dtype=BF16)), EPS)


@pytest.mark.parametrize("make,error,match", [
    (lambda: _layernorm_case(y=torch.zeros((4, 256), dtype=BF16)),
     TypeError, "float32"),
    (lambda: _layernorm_case(x=torch.zeros((5, 256))), ValueError,
     "one shape"),
    (lambda: _layernorm_case(width=192), ValueError, "128-column"),
    (lambda: _layernorm_case(width=2048), ValueError, "128-column"),
    (lambda: _layernorm_case(y=torch.zeros((256, 4)).t()), ValueError,
     "contiguous"),
    (lambda: _layernorm_case(y=torch.zeros(4 * 256 + 1)[1:].view(4, 256)),
     ValueError, "16-byte"),
    (lambda: _layernorm_case(bias_dtype=torch.float16), TypeError,
     "one type"),
    (lambda: _layernorm_case(weight_dtype=F32), TypeError, "one type"),
    (lambda: _layernorm_case(bias_len=128), ValueError, r"\(256,\)"),
    (lambda: (torch.zeros((4, 256)),) + _layernorm_case()[1:], ValueError,
     "CUDA device"),
], ids=["y-bf16", "x-shape", "width-192", "width-2048", "transposed",
        "off-16B", "bias-f16", "mixed-types", "bias-length", "y-on-cpu"])
def test_layernorm_wrapper_rejects_what_the_kernel_does_not_take(
        launched, make, error, match):
    with pytest.raises(error, match=match):
        EG.bias_residual_layernorm(*make())
    assert not launched


@pytest.mark.parametrize("make,error,match", [
    (lambda: (torch.zeros((4, 64), dtype=BF16), torch.zeros(64)),
     TypeError, "float32"),
    (lambda: (torch.zeros((4, 12)), torch.zeros(12)), ValueError,
     "8-column"),
    (lambda: (torch.zeros((1, 8200)), torch.zeros(8200)), ValueError,
     "8-column"),
    (lambda: (torch.zeros((64, 4)).t(), torch.zeros(64)), ValueError,
     "contiguous"),
    (lambda: (torch.zeros((4, 64)), torch.zeros(64, dtype=torch.float16)),
     TypeError, "one type"),
    (lambda: (torch.zeros((4, 64)), torch.zeros(32)), ValueError,
     r"\(64,\)"),
], ids=["g-bf16", "width-12", "width-8200", "transposed", "bias-f16",
        "bias-length"])
def test_gelu_wrapper_rejects_what_the_kernel_does_not_take(
        launched, make, error, match):
    with pytest.raises(error, match=match):
        EG.bias_gelu(*(_OnCard(t) for t in make()))
    assert not launched


def test_gelu_wrapper_rejects_operands_off_the_card(launched):
    with pytest.raises(ValueError, match="CUDA device"):
        EG.bias_gelu(torch.zeros((4, 64)), _OnCard(torch.zeros(64)))
    assert not launched


# ---- on the card ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


# tokens of the reader's canvas (376 rows of 256) and of the retriever's
# (392 rows of 64), at BERT-base's widths
_SHAPES = {"reader": 376 * 256, "retriever": 392 * 64}


@pytest.mark.cuda
@pytest.mark.parametrize("param_dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_layernorm_kernel_at_the_main_paths_shapes(cuda, shape,
                                                   param_dtype):
    """Kernel A at the reader's and the retriever's canvases, D 768: every
    entry within :func:`_layernorm_bound` of the f64 reference, as its
    twin's; its bf16 output is its f32 output rounded, bit for bit."""
    ops = _glue_operands(_SHAPES[shape], 768, param_dtype, seed=7,
                         device=cuda)
    before = EG.bias_residual_layernorm.launches
    out, low = EG.bias_residual_layernorm(*ops, EPS)
    torch.cuda.synchronize()
    assert EG.bias_residual_layernorm.launches == before + 1
    assert torch.equal(low, out.to(BF16))
    ref, bound = _layernorm_bound(*ops, EPS)
    assert ((out.double() - ref).abs() <= bound).all()
    twin, _ = EG.bias_residual_layernorm_plain(*ops, EPS)
    assert ((twin.double() - ref).abs() <= bound).all()


def _bf16_steps(a, b):
    """How many bf16 steps apart ``a`` and ``b`` lie, entry by entry (their
    bit patterns as integers, of one sign)."""
    ia, ib = (t.view(torch.int16).int() for t in (a, b))
    assert ((ia < 0) == (ib < 0)).all()
    return (ia - ib).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_gelu_kernel_at_the_main_paths_shapes(cuda, shape, bias_dtype):
    """Kernel B at the reader's and the retriever's canvases, F 3,072: its
    bf16 values are its twin's but at most one in 10^3, those one bf16
    step away. Both compute the same f32 expression with an erff of their
    own toolkit (PyTorch's build and this one's nvcc), which may differ by
    an f32 ulp; an f32 value within an ulp of a bf16 rounding midpoint
    then rounds to the other neighbour (about one value in 2^16 where the
    two differ)."""
    g, bias = _gelu_operands(_SHAPES[shape], 3072, bias_dtype, seed=8,
                             device=cuda)
    before = EG.bias_gelu.launches
    h = EG.bias_gelu(g, bias)
    torch.cuda.synchronize()
    assert EG.bias_gelu.launches == before + 1
    steps = _bf16_steps(h, EG.bias_gelu_plain(g, bias))
    assert int(steps.max()) <= 1
    assert float((steps > 0).float().mean()) <= 1e-3


def _plain_on_the_card(monkeypatch):
    monkeypatch.setattr(TL, "takes_fused_glue", lambda *args: False)


def _glue_launches():
    return EG.bias_residual_layernorm.launches, EG.bias_gelu.launches


@pytest.mark.cuda
def test_reader_with_the_kernels_matches_the_plain_path(cuda, monkeypatch):
    """A 4-layer packed bf16 reader (width 256, FFN 1,024): logits with the
    kernels against the same forward on the plain path within bf16
    resolution, rtol = atol = 2e-2 (an activation within an f32 ulp of a
    bf16 rounding boundary may round the other way, and the layers carry
    it on, as tests/test_torch_cuda.py holds the bf16 GEMM to the upcast
    one), and the same best start and end wherever the plain path's lead
    their runners-up by more than twice the two paths' largest difference
    in the row."""
    from viquae_torch.models import qa as tqa

    cfg = tqa.ReaderConfig(bert=tbert.BertConfig(
        vocab_size=3000, hidden_size=256, num_hidden_layers=4,
        num_attention_heads=4, intermediate_size=1024,
        max_position_embeddings=256, add_pooler=False), fuse_ir_score=False)
    model = TL.seeded(tqa.Reader, cfg, seed=0, device=cuda).to(BF16)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(5, 3000, n).astype(np.int32)
            for n in np.clip(rng.normal(146, 20, 96), 40, 256).astype(int)]
    p = packing.pack_token_sequences(seqs, 256, pad_rows_to=8)
    ids, seg, pos = (torch.from_numpy(a).to(cuda) for a in (
        p.input_ids, p.segment_ids, p.position_ids))
    tt = (pos > 8).int()
    gather = torch.zeros((len(seqs), 256), dtype=torch.int64)
    mask = torch.zeros((len(seqs), 256), dtype=torch.int32)
    for i, s in enumerate(seqs):
        start = int(p.cls_rows[i]) * 256 + int(p.cls_cols[i])
        gather[i, :len(s)] = torch.arange(start, start + len(s))
        mask[i, :len(s)] = 1
    gather, mask = gather.to(cuda), mask.to(cuda)

    def forward():
        with torch.no_grad():
            return tqa.reader_apply_packed(
                model, cfg, ids, seg, pos, tt, gather, mask, m_passages=8,
                compute_dtype=BF16)

    a0, b0 = _glue_launches()
    got = forward()
    assert _glue_launches() == (a0 + 8, b0 + 4)
    _plain_on_the_card(monkeypatch)
    ref = forward()
    assert _glue_launches() == (a0 + 8, b0 + 4)
    real = mask > 0
    for a, b in ((got.start_logits, ref.start_logits),
                 (got.end_logits, ref.end_logits)):
        assert torch.isfinite(a[real]).all()
        torch.testing.assert_close(a[real], b[real], rtol=2e-2, atol=2e-2)
        gap = ((a - b).abs() * real).amax(-1)
        a, b = (t.masked_fill(~real, float("-inf")) for t in (a, b))
        top2 = b.topk(2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 2 * gap
        assert clear.float().mean() > 0.5
        assert torch.equal(a.argmax(-1)[clear], b.argmax(-1)[clear])


class _WordTokenizer:
    """``w<i>`` -> id 5 + i, with what the embedder calls."""

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


@pytest.mark.cuda
def test_packed_embedder_with_the_kernels_gives_the_plain_ranks(
        cuda, monkeypatch):
    """The DPR question tower through ``PackedTextEmbedder`` in bf16, rows
    of 64 (width 256, FFN 1,024): CLS vectors with the kernels against the
    plain path within bf16 resolution (the reader's reason), and each
    question's nearest of 500 passages the plain path's wherever it leads
    its runner-up by more than the two paths' scores differ."""
    from viquae_torch.ir.embedding import PackedTextEmbedder
    from viquae_torch.models import dpr as tdpr

    cfg = tdpr.DPRConfig(bert=tbert.BertConfig(
        vocab_size=300, hidden_size=256, num_hidden_layers=4,
        num_attention_heads=4, intermediate_size=1024,
        max_position_embeddings=64, add_pooler=False))
    model = TL.seeded(tbert.Bert, cfg.bert, seed=1, device=cuda).to(BF16)
    rng = np.random.default_rng(1)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 290, n))
             for n in rng.integers(6, 30, 200)]

    def embed():
        emb = PackedTextEmbedder(tdpr.make_packed_apply(cfg), model,
                                 _WordTokenizer(), row_len=64,
                                 batch_size=256, compute_dtype=BF16,
                                 device=cuda)
        return emb(texts)[:200].float()

    a0, b0 = _glue_launches()
    got = embed()
    assert _glue_launches() == (a0 + 8, b0 + 4)
    _plain_on_the_card(monkeypatch)
    ref = embed()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
    kb = torch.randn((500, 256), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    s_got, s_ref = got @ kb.T, ref @ kb.T
    gap = (s_got - s_ref).abs().amax(-1)
    top2 = s_ref.topk(2, dim=-1).values
    clear = top2[:, 0] - top2[:, 1] > 2 * gap
    assert clear.float().mean() > 0.5
    assert torch.equal(s_got.argmax(-1)[clear], s_ref.argmax(-1)[clear])
