"""The port's ViLT (viquae_torch/models/vilt.py) against the JAX package's
(viquae_tpu/models/vilt.py) on the same weights and inputs: the cases of
tests/test_vilt.py at tiny widths (2 layers, width 24, 48-px images of
16-px patches), JAX on the CPU.

Weights: a JAX init tree with N(0, 0.05) added to every leaf (zero biases
and unit scales would hide a mis-mapped tensor) goes to both packages.
Tolerances: f32 within 2e-5 of the output scale (max |got - ref| <= 2e-5
max |ref|); bf16 compute within rtol = atol = 2e-2 (bf16's relative
spacing is 2^-8 ~ 3.9e-3; the two packages sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import flat_leaves, perturbed
from viquae_torch.models import convert
from viquae_torch.models import vilt as tvilt
from viquae_tpu.models import vilt as jvilt

torch.set_num_threads(2)

TINY = dict(vocab_size=60, hidden_size=24, num_layers=2, num_heads=2,
            intermediate_size=48, max_positions=32, image_size=48,
            patch_size=16)
JCFG, TCFG = jvilt.ViltConfig(**TINY), tvilt.ViltConfig(**TINY)
RTOL = 2e-5


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def tree():
    return perturbed(jax.tree.map(np.asarray,
                                  jvilt.init(jax.random.key(0), JCFG)))


@pytest.fixture(scope="module")
def reader_tree():
    return perturbed(jax.tree.map(
        np.asarray, jvilt.reader_init(jax.random.key(1), JCFG)), seed=1)


def batch(b=2, lt=6, n_images=None, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 60, (b, lt)).astype(np.int32)
    shape = (b, 48, 48, 3) if n_images is None else (b, n_images, 48, 48, 3)
    pix = rng.standard_normal(shape).astype(np.float32)
    mask = np.ones((b, lt), np.int32)
    mask[0, 4:] = 0   # a padded text row
    return ids, pix, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_matches_jax_with_a_padded_text_mask(tree, dtype):
    ids, pix, mask = batch()
    tt = np.zeros_like(ids)
    tt[:, 3:] = 1
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = jvilt.apply(tree, JCFG, jnp.asarray(ids), jnp.asarray(pix),
                      attention_mask=jnp.asarray(mask),
                      token_type_ids=jnp.asarray(tt), compute_dtype=jdt)
    model = convert.module_from_tree(tvilt.Vilt, TCFG, tree=tree,
                                     device="cpu")
    got = tvilt.apply(model, TCFG, torch.from_numpy(ids),
                      torch.from_numpy(pix),
                      attention_mask=torch.from_numpy(mask),
                      token_type_ids=torch.from_numpy(tt), compute_dtype=tdt)
    assert got["last_hidden_state"].shape == (2, 6 + 9 + 1, 24)
    for key in ("last_hidden_state", "pooler_output"):
        if dtype == "f32":
            close(got[key], ref[key])
        else:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                       rtol=2e-2, atol=2e-2, err_msg=key)


def test_vilt_for_ir_is_cls_pooling_as_jax(tree):
    ids, pix, mask = batch(b=3, lt=4, seed=1)
    ref = jvilt.vilt_for_ir_apply(tree, JCFG, jnp.asarray(ids),
                                  jnp.asarray(pix))
    model = convert.module_from_tree(tvilt.Vilt, TCFG, tree=tree,
                                     device="cpu")
    got = tvilt.vilt_for_ir_apply(model, TCFG, torch.from_numpy(ids),
                                  torch.from_numpy(pix))
    full = tvilt.apply(model, TCFG, torch.from_numpy(ids),
                       torch.from_numpy(pix))
    assert torch.equal(got.pooler_output, full["last_hidden_state"][:, 0])
    close(got.pooler_output, ref.pooler_output)


def test_multi_image_pixel_mask_matches_jax(tree):
    """(B, 3 images) with whole images masked: each image's tokens carry
    their own CLS and positions, the mask repeats per image (not a tile),
    and a masked image's pixels change nothing."""
    ids, pix, _ = batch(lt=4, n_images=3, seed=2)
    pixel_mask = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    ref = jvilt.apply(tree, JCFG, jnp.asarray(ids), jnp.asarray(pix),
                      pixel_mask=jnp.asarray(pixel_mask))
    model = convert.module_from_tree(tvilt.Vilt, TCFG, tree=tree,
                                     device="cpu")
    got = tvilt.apply(model, TCFG, torch.from_numpy(ids),
                      torch.from_numpy(pix),
                      pixel_mask=torch.from_numpy(pixel_mask))
    assert got["last_hidden_state"].shape == (2, 4 + 3 * 10, 24)
    close(got["last_hidden_state"], ref["last_hidden_state"])
    close(got["pooler_output"], ref["pooler_output"])
    pix2 = pix.copy()
    pix2[0, 2] += 100.0
    moved = tvilt.apply(model, TCFG, torch.from_numpy(ids),
                        torch.from_numpy(pix2),
                        pixel_mask=torch.from_numpy(pixel_mask))
    np.testing.assert_allclose(moved["pooler_output"][0].numpy(),
                               got["pooler_output"][0].numpy(), atol=1e-5)


def test_multi_passage_vilt_reader_matches_jax(reader_tree):
    n, m, length, a = 2, 3, 8, 2
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 60, (n * m, length)).astype(np.int32)
    pix = rng.standard_normal((n * m, 48, 48, 3)).astype(np.float32)
    mask = np.ones((n * m, length), np.int32)
    mask[:, 6:] = 0
    start = rng.integers(0, 6, (n, m, a)).astype(np.int32)
    end = rng.integers(0, 6, (n, m, a)).astype(np.int32)
    answer_mask = np.ones((n, m, a), np.int32)
    answer_mask[1, :, 1] = 0
    ref = jvilt.multi_passage_vilt_apply(
        reader_tree, JCFG, jnp.asarray(ids), jnp.asarray(pix),
        attention_mask=jnp.asarray(mask), start_positions=jnp.asarray(start),
        end_positions=jnp.asarray(end), answer_mask=jnp.asarray(answer_mask),
        m_passages=m)
    model = convert.module_from_tree(tvilt.ViltReader, TCFG,
                                     tree=reader_tree, device="cpu")
    got = tvilt.multi_passage_vilt_apply(
        model, TCFG, *map(torch.from_numpy, (ids, pix)),
        attention_mask=torch.from_numpy(mask),
        start_positions=torch.from_numpy(start),
        end_positions=torch.from_numpy(end),
        answer_mask=torch.from_numpy(answer_mask), m_passages=m)
    assert got.start_logits.shape == (n * m, length)
    for field in ("start_logits", "end_logits", "start_log_probs",
                  "end_log_probs"):
        close(getattr(got, field), getattr(ref, field))
    np.testing.assert_allclose(float(got.loss), float(ref.loss), rtol=1e-5)


@pytest.fixture(scope="module")
def hf_state_dict():
    from transformers import ViltConfig as HFViltConfig
    from transformers import ViltModel

    torch.manual_seed(0)
    cfg = HFViltConfig(
        vocab_size=60, hidden_size=24, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=48,
        max_position_embeddings=32, image_size=48, patch_size=16,
        modality_type_vocab_size=2, hidden_act="gelu")
    sd = ViltModel(cfg).eval().state_dict()
    gen = torch.Generator().manual_seed(1)
    # non-trivial biases, scales and position embeddings
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen)
            if v.is_floating_point() else v for k, v in sd.items()}


@pytest.mark.parametrize("image_size", [48, 96, 32],
                         ids=["same_grid", "grows", "shrinks"])
def test_params_from_hf_matches_jax(hf_state_dict, image_size):
    """The HF layout (3 x 3 patch grid) ported at the same grid, a larger
    one (6 x 6) and a smaller one (2 x 2): every leaf equals the JAX
    port's, the interpolated position embeddings within 1e-6."""
    kw = {**TINY, "image_size": image_size}
    ref = jvilt.params_from_hf(hf_state_dict, jvilt.ViltConfig(**kw))
    cfg = tvilt.ViltConfig(**kw)
    model = tvilt.params_from_hf(hf_state_dict, cfg, device="cpu")
    got = flat_leaves(convert.tree_from_module(model))
    want = flat_leaves(jax.tree.map(np.asarray, ref))
    assert got.keys() == want.keys()
    assert got["position_embeddings"].shape == (cfg.n_patches + 1, 24)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("kind", ["vilt", "reader"])
def test_jax_tree_round_trips_through_the_port(kind):
    """JAX init tree -> port module -> tree_from_module: the same leaves,
    bit for bit."""
    init = jvilt.init if kind == "vilt" else jvilt.reader_init
    cls = tvilt.Vilt if kind == "vilt" else tvilt.ViltReader
    tree = jax.tree.map(np.asarray, init(jax.random.key(2), JCFG))
    module = convert.module_from_tree(cls, TCFG, tree=tree, device="cpu")
    back, want = flat_leaves(convert.tree_from_module(module)), \
        flat_leaves(tree)
    assert back.keys() == want.keys()
    for path in want:
        assert np.array_equal(back[path], want[path]), path


def test_seeded_init_draws_the_jax_kinds():
    model = tvilt.reader_init(TCFG, seed=0, device="cpu")
    vilt = model.vilt
    assert vilt.patch_embedding.weight.abs().max() <= 0.04 + 1e-7
    assert torch.equal(vilt.final_ln.weight, torch.ones(24))
    assert float(vilt.cls_token.std()) > 0
    assert not any(p.requires_grad for p in model.parameters())
