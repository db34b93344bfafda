"""The port's encoder (viquae_torch/models) against the JAX functions on the
same weights: the JAX param tree, as numpy, goes through
convert.params_from_jax into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import dpr as tdpr
from viquae_torch.models import layers as TL
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.models import layers as JL

torch.set_num_threads(2)

SMALL = dict(vocab_size=3000, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64)
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _tree(add_pooler, seed=0):
    """JAX-initialized params as numpy, every leaf perturbed with numpy
    noise so LayerNorm scales and biases matter too."""
    cfg = jbert.BertConfig(**SMALL, add_pooler=add_pooler)
    tree = jax.tree.map(np.asarray, jbert.init(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(
            np.float32), tree)


def _bf16_tree(tree):
    """The tree rounded to bf16, kept as float32 numpy (exact values)."""
    return jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), tree)


def _canvas(seed=0, rows=4, row_len=16):
    """A packed canvas whose last row is all padding (segment 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SMALL["vocab_size"], (rows, row_len)).astype(
        np.int32)
    seg = np.zeros((rows, row_len), np.int32)
    pos = np.zeros((rows, row_len), np.int32)
    cls_rows, cls_cols = [], []
    for r in range(rows - 1):
        c, s = 0, 1
        while c < row_len - 2:
            ln = int(rng.integers(2, 8))
            ln = min(ln, row_len - c)
            seg[r, c:c + ln] = s
            pos[r, c:c + ln] = np.arange(ln)
            cls_rows.append(r)
            cls_cols.append(c)
            c, s = c + ln, s + 1
    return ids, seg, pos, np.array(cls_rows, np.int32), np.array(
        cls_cols, np.int32)


def test_params_from_jax_layout():
    tree = _tree(add_pooler=True)
    cfg = tbert.BertConfig(**SMALL)
    model = convert.params_from_jax(tree, cfg, device="cpu")
    lin = model.layers[1].mlp["in"]
    assert lin.weight.shape == (SMALL["intermediate_size"],
                                SMALL["hidden_size"])
    np.testing.assert_array_equal(lin.weight.numpy(),
                                  tree["layers"][1]["mlp"]["in"]["kernel"].T)
    np.testing.assert_array_equal(model.embeddings["ln"].weight.numpy(),
                                  tree["embeddings"]["ln"]["scale"])
    assert not any(p.requires_grad for p in model.parameters())
    m16 = convert.params_from_jax(tree, cfg, device="cpu",
                                  dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in m16.parameters())
    # init_tree draws the JAX layout: same tree structure and shapes
    ours = convert.init_tree(cfg, seed=3)
    ref = jax.tree.map(np.asarray,
                       jbert.init(jax.random.key(0), jbert.BertConfig(**SMALL)))
    assert (jax.tree.structure(ours) == jax.tree.structure(ref))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.shape == b.shape


def test_dense_layer_norm_mlp_match_jax():
    tree = _tree(add_pooler=False)
    model = convert.params_from_jax(tree, tbert.BertConfig(**SMALL),
                                    device="cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, SMALL["hidden_size"])).astype(np.float32)
    layer, jlayer = model.layers[0], jax.tree.map(jnp.asarray,
                                                  tree["layers"][0])
    np.testing.assert_allclose(
        TL.dense(layer["attention"]["q"], torch.tensor(x)).numpy(),
        np.asarray(JL.dense(jlayer["attention"]["q"], jnp.asarray(x))),
        **F32_TOL)
    np.testing.assert_allclose(
        TL.layer_norm(layer["output_ln"], torch.tensor(x)).numpy(),
        np.asarray(JL.layer_norm(jlayer["output_ln"], jnp.asarray(x))),
        **F32_TOL)
    np.testing.assert_allclose(
        TL.mlp(layer["mlp"], torch.tensor(x)).numpy(),
        np.asarray(JL.mlp(jlayer["mlp"], jnp.asarray(x))), **F32_TOL)
    for act in ("gelu", "gelu_new", "relu", "quick_gelu", "tanh"):
        np.testing.assert_allclose(
            TL.ACT[act](torch.tensor(x)).numpy(),
            np.asarray(JL.ACT[act](jnp.asarray(x))), **F32_TOL,
            err_msg=act)


def test_attention_biases_and_mha_match_jax():
    tree = _tree(add_pooler=False)
    model = convert.params_from_jax(tree, tbert.BertConfig(**SMALL),
                                    device="cpu")
    _, seg, _, _, _ = _canvas()
    mask = (seg > 0).astype(np.int32)
    np.testing.assert_array_equal(
        TL.attention_bias_from_segments(torch.tensor(seg)).numpy(),
        np.asarray(JL.attention_bias_from_segments(jnp.asarray(seg))))
    np.testing.assert_array_equal(
        TL.attention_bias_from_mask(torch.tensor(mask)).numpy(),
        np.asarray(JL.attention_bias_from_mask(jnp.asarray(mask))))
    x = np.random.default_rng(2).normal(
        size=seg.shape + (SMALL["hidden_size"],)).astype(np.float32)
    got = TL.mha(model.layers[0]["attention"], torch.tensor(x),
                 bias=TL.attention_bias_from_segments(torch.tensor(seg)),
                 n_heads=4)
    ref = JL.mha(jax.tree.map(jnp.asarray, tree["layers"][0]["attention"]),
                 jnp.asarray(x),
                 bias=JL.attention_bias_from_segments(jnp.asarray(seg)),
                 n_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_bert_apply_padded_matches_jax():
    tree = _tree(add_pooler=True)
    cfg_t, cfg_j = tbert.BertConfig(**SMALL), jbert.BertConfig(**SMALL)
    model = convert.params_from_jax(tree, cfg_t, device="cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(0, SMALL["vocab_size"], (3, 12))
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0
    tt = rng.integers(0, 2, (3, 12))
    got = model(torch.tensor(ids), attention_mask=torch.tensor(mask),
                token_type_ids=torch.tensor(tt))  # Bert.forward is apply
    ref = jbert.apply(jax.tree.map(jnp.asarray, tree), cfg_j,
                      jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tt))
    for key in ("last_hidden_state", "pooler_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   **F32_TOL, err_msg=key)


def test_bert_apply_packed_matches_jax():
    tree = _tree(add_pooler=False)
    cfg_t = tbert.BertConfig(**SMALL, add_pooler=False)
    cfg_j = jbert.BertConfig(**SMALL, add_pooler=False)
    model = convert.params_from_jax(tree, cfg_t, device="cpu")
    ids, seg, pos, _, _ = _canvas(4)
    got = tbert.apply(model, cfg_t, torch.tensor(ids),
                      position_ids=torch.tensor(pos),
                      segment_ids=torch.tensor(seg))["last_hidden_state"]
    ref = jbert.apply(jax.tree.map(jnp.asarray, tree), cfg_j,
                      jnp.asarray(ids), position_ids=jnp.asarray(pos),
                      segment_ids=jnp.asarray(seg))["last_hidden_state"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_dpr_apply_and_apply_packed_match_jax():
    tree = _tree(add_pooler=False)
    cfg_t = tdpr.DPRConfig(bert=tbert.BertConfig(**SMALL, add_pooler=False))
    cfg_j = jdpr.DPRConfig(bert=jbert.BertConfig(**SMALL, add_pooler=False))
    model = convert.params_from_jax(tree, cfg_t, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    ids, seg, pos, cr, cc = _canvas(5)
    got = tdpr.make_packed_apply(cfg_t)(
        model, *(torch.tensor(a) for a in (ids, seg, pos, cr, cc)))
    ref = jdpr.apply_packed(jparams, cfg_j,
                            *(jnp.asarray(a) for a in (ids, seg, pos, cr, cc)))
    assert got.shape == (len(cr), SMALL["hidden_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    mask = (seg > 0).astype(np.int32)
    got = tdpr.apply(model, cfg_t, torch.tensor(ids), torch.tensor(mask))
    ref = jdpr.apply(jparams, cfg_j, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(got["pooler_output"].numpy(),
                               np.asarray(ref["pooler_output"]), **F32_TOL)


def test_bf16_weights_and_compute_match_jax():
    """bf16 weights with bf16 compute, as the serving path runs. Both
    sides round at the same points (bf16 embedding sums, bf16 dense
    operands with f32 results, bf16 attention probabilities), but XLA may
    keep excess precision between fused bf16 ops and sums in another
    order, so the CLS outputs agree to within bf16 resolution, not bitwise:
    rtol = atol = 2e-2 (bf16 has a relative spacing of 2^-8 ~ 3.9e-3)."""
    tree = _bf16_tree(_tree(add_pooler=False))
    cfg_t = tdpr.DPRConfig(bert=tbert.BertConfig(**SMALL, add_pooler=False))
    cfg_j = jdpr.DPRConfig(bert=jbert.BertConfig(**SMALL, add_pooler=False))
    model = convert.params_from_jax(tree, cfg_t, device="cpu",
                                    dtype=torch.bfloat16)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    ids, seg, pos, cr, cc = _canvas(6)
    got = tdpr.apply_packed(model, cfg_t,
                            *(torch.tensor(a) for a in (ids, seg, pos, cr, cc)),
                            compute_dtype=torch.bfloat16)
    ref = jdpr.apply_packed(jparams, cfg_j,
                            *(jnp.asarray(a) for a in (ids, seg, pos, cr, cc)),
                            compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_all_padding_canvas_rows_stay_finite(dtype):
    """A canvas row with no segment allows no key at all: the finite mask
    bias gives it uniform attention instead of NaN, so the NaN can't spread
    to real tokens in the next layer."""
    tree = _tree(add_pooler=False)
    cfg = tbert.BertConfig(**SMALL, add_pooler=False)
    model = convert.params_from_jax(tree, cfg, device="cpu", dtype=dtype)
    ids, seg, pos, _, _ = _canvas(7)
    assert (seg[-1] == 0).all()
    out = tbert.apply(model, cfg, torch.tensor(ids),
                      position_ids=torch.tensor(pos),
                      segment_ids=torch.tensor(seg),
                      compute_dtype=dtype)["last_hidden_state"]
    assert torch.isfinite(out).all()
