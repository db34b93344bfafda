"""The image towers of the port against the JAX package's on the same
converted weights (JAX on the CPU): ResNet, CLIP ModifiedResNet, CLIP ViT
and text, at tiny configs (stage sizes (1, 1, 1, 1) or (2, 2), width 8,
32-64 px). f32: rtol 1e-4 / atol 1e-4 relative to the output scale; bf16
compute_dtype: also within 1e-4 of the output scale, since both packages
multiply the same bf16 operands and keep every sum in f32
(tests/test_torch_conv_bf16.py holds each convolution to its f32
reordering bound); the readings are ~1e-7."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.models import clip as tclip
from viquae_torch.models import convert
from viquae_torch.models import resnet as tresnet
from viquae_tpu.models import clip as jclip
from viquae_tpu.models import resnet as jresnet

from torch_helpers import jax_tree, randomize_batch_norm_

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rel * scale, (err, scale)


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------------
# ResNet
# --------------------------------------------------------------------------
# seeded weights are drawn with the port (the JAX inits take ~10 s each on
# the CPU) and handed to both packages as the JAX tree
@pytest.fixture(scope="module")
def resnet_pair():
    cfg = jresnet.ResNetConfig(stage_sizes=(2, 2), width=8)
    model = randomize_batch_norm_(tresnet.init(cfg, seed=0, device="cpu"),
                                  seed=1)
    return cfg, jax_tree(model)


@pytest.mark.parametrize("pool", ["avg", "max", "none"])
def test_resnet_matches_jax(resnet_pair, pool):
    import dataclasses

    cfg, tree = resnet_pair
    cfg = dataclasses.replace(cfg, pool=pool)
    x = _images((2, 40, 36, 3))
    ref = np.asarray(jresnet.apply(tree, cfg, jnp.asarray(x)))
    model = tresnet.from_jax(tree, cfg, device="cpu")
    _close(model(torch.from_numpy(x)), ref, 1e-4)


def test_resnet_bf16_compute_dtype(resnet_pair):
    cfg, tree = resnet_pair
    x = _images((2, 32, 32, 3))
    ref = np.asarray(jresnet.apply(tree, cfg, jnp.asarray(x),
                                   compute_dtype=jnp.bfloat16))
    model = tresnet.from_jax(tree, cfg, device="cpu")
    got = tresnet.apply(model, cfg, torch.from_numpy(x),
                        compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    _close(got, ref, 1e-4)


def _torchvision_state_dict(tree, cfg):
    """The tree in torchvision's key layout (what a local torchvision
    checkpoint holds, fc included)."""
    flat = convert.state_dict_from_tree(tree)
    sd = {}
    for name, a in flat.items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer{int(parts[1]) + 1}", parts[2]] + parts[3:]
        name = ".".join(parts).replace("downsample_conv", "downsample.0") \
            .replace("downsample_bn", "downsample.1")
        sd[name] = torch.from_numpy(a)
    sd["fc.weight"] = torch.zeros(10, 8 * 2 ** (len(cfg.stage_sizes) - 1)
                                  * 4)
    return sd


def test_resnet_torchvision_loader_matches_jax(resnet_pair):
    cfg, tree = resnet_pair
    sd = _torchvision_state_dict(tree, cfg)
    x = _images((1, 32, 32, 3), seed=2)
    ref = np.asarray(jresnet.apply(jresnet.params_from_torchvision(sd, cfg),
                                   cfg, jnp.asarray(x)))
    model = tresnet.params_from_torchvision(sd, cfg, device="cpu")
    _close(model(torch.from_numpy(x)), ref, 1e-4)
    for a, b in zip(jax.tree.leaves(_np_tree(
            jresnet.params_from_torchvision(sd, cfg))),
            jax.tree.leaves(tresnet.tree_from_torchvision(sd, cfg))):
        np.testing.assert_array_equal(a, b)


def test_resnet_seeded_init_is_deterministic():
    cfg = jresnet.ResNetConfig(stage_sizes=(1, 1), width=8)
    a = tresnet.init(cfg, seed=3, device="cpu")
    b = tresnet.init(cfg, seed=3, device="cpu")
    c = tresnet.init(cfg, seed=4, device="cpu")
    x = torch.from_numpy(_images((1, 32, 32, 3)))
    assert torch.equal(a(x), b(x)) and not torch.equal(a(x), c(x))
    assert not any(p.requires_grad for p in a.parameters())


# --------------------------------------------------------------------------
# CLIP ModifiedResNet (OpenAI RN50 layout)
# --------------------------------------------------------------------------
MRN_CFG = jclip.ModifiedResNetConfig(stage_sizes=(1, 1, 1, 1), width=8,
                                     output_dim=16, heads=4, image_size=64)


@pytest.fixture(scope="module")
def openai_sd():
    return jclip.random_openai_rn50_state_dict(MRN_CFG, seed=5)


@pytest.mark.parametrize("compute_dtype", [None, "bf16"])
def test_modified_resnet_matches_jax(openai_sd, compute_dtype):
    jparams = jclip.visual_params_from_openai(openai_sd, MRN_CFG)
    model = tclip.visual_params_from_openai(openai_sd, MRN_CFG, device="cpu")
    x = _images((2, 64, 64, 3), seed=3)
    ref = np.asarray(jclip.modified_resnet_apply(
        jparams, MRN_CFG, jnp.asarray(x),
        compute_dtype=jnp.bfloat16 if compute_dtype else None))
    got = tclip.modified_resnet_apply(
        model, MRN_CFG, torch.from_numpy(x),
        compute_dtype=torch.bfloat16 if compute_dtype else None)
    _close(got, ref, 1e-4)


def test_modified_resnet_from_jax_tree_equals_loader(openai_sd):
    tree = _np_tree(jclip.visual_params_from_openai(openai_sd, MRN_CFG))
    a = tclip.modified_resnet_from_jax(tree, MRN_CFG, device="cpu")
    b = tclip.visual_params_from_openai(openai_sd, MRN_CFG, device="cpu")
    for (na, ta), (nb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    seeded = tclip.modified_resnet_init(MRN_CFG, seed=1, device="cpu")
    assert seeded.state_dict().keys() == a.state_dict().keys()


# --------------------------------------------------------------------------
# CLIP ViT + text
# --------------------------------------------------------------------------
VIT_CFG = jclip.CLIPVisionConfig(hidden_size=32, num_layers=2, num_heads=4,
                                 intermediate_size=64, image_size=32,
                                 patch_size=8, projection_dim=16)
TEXT_CFG = jclip.CLIPTextConfig(vocab_size=99, hidden_size=32, num_layers=2,
                                num_heads=4, intermediate_size=64,
                                max_positions=32, projection_dim=16,
                                eos_token_id=98)
IDS = np.array([[0, 5, 7, 98, 1, 1], [0, 9, 11, 13, 17, 98],
                [0, 3, 4, 5, 6, 7]])        # the last row has no EOS
MASK = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1],
                 [1, 1, 1, 1, 1, 1]])


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_vit_matches_jax(compute_dtype):
    tree = jax_tree(tclip.vit_init(VIT_CFG, seed=1, device="cpu"))
    x = _images((2, 32, 32, 3), seed=4)
    jd, td = ((jnp.float32, torch.float32) if compute_dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    ref = jclip.vit_apply(tree, VIT_CFG, jnp.asarray(x), compute_dtype=jd)
    model = tclip.vit_from_jax(tree, VIT_CFG, device="cpu")
    got = tclip.vit_apply(model, VIT_CFG, torch.from_numpy(x),
                          compute_dtype=td)
    for key in ("image_embeds", "pooler_output", "last_hidden_state"):
        _close(got[key], ref[key], 1e-4)


@pytest.mark.parametrize("with_mask", [True, False])
def test_text_matches_jax(with_mask):
    tree = jax_tree(tclip.text_init(TEXT_CFG, seed=2, device="cpu"))
    mask = MASK if with_mask else None
    ref = jclip.text_apply(tree, TEXT_CFG, jnp.asarray(IDS),
                           None if mask is None else jnp.asarray(mask))
    model = tclip.text_from_jax(tree, TEXT_CFG, device="cpu")
    got = tclip.text_apply(model, TEXT_CFG, torch.from_numpy(IDS),
                           None if mask is None else torch.from_numpy(mask))
    for key in ("text_embeds", "pooler_output"):
        _close(got[key], ref[key], 1e-4)


@pytest.fixture(scope="module")
def hf_clip():
    from transformers import CLIPConfig, CLIPModel, CLIPTextConfig, \
        CLIPVisionConfig

    torch.manual_seed(0)
    cfg = CLIPConfig(
        text_config=CLIPTextConfig(
            vocab_size=99, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32, eos_token_id=98, bos_token_id=0,
            pad_token_id=1).to_dict(),
        vision_config=CLIPVisionConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, image_size=32, patch_size=8).to_dict(),
        projection_dim=16)
    return cfg, CLIPModel(cfg).eval()


def test_hf_loader_matches_hf_and_jax(hf_clip):
    _, model = hf_clip
    sd = model.state_dict()
    ported = tclip.params_from_hf(sd, TEXT_CFG, VIT_CFG, device="cpu")
    jparams = jclip.params_from_hf(sd)
    pixels = _images((2, 32, 32, 3), seed=5)
    with torch.no_grad():
        hf_img = model.get_image_features(
            pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2)))
        hf_txt = model.get_text_features(
            input_ids=torch.from_numpy(IDS[:2]),
            attention_mask=torch.from_numpy(MASK[:2]))
    hf_img = getattr(hf_img, "pooler_output", hf_img)
    hf_txt = getattr(hf_txt, "pooler_output", hf_txt)
    img = tclip.vit_apply(ported["vision"], VIT_CFG,
                          torch.from_numpy(pixels))["image_embeds"]
    txt = tclip.text_apply(ported["text"], TEXT_CFG,
                           torch.from_numpy(IDS[:2]),
                           torch.from_numpy(MASK[:2]))["text_embeds"]
    np.testing.assert_allclose(img.numpy(), hf_img.numpy(), atol=3e-5,
                               rtol=1e-3)
    np.testing.assert_allclose(txt.numpy(), hf_txt.numpy(), atol=3e-5,
                               rtol=1e-3)
    j_img = jclip.vit_apply(jparams["vision"], VIT_CFG,
                            jnp.asarray(pixels))["image_embeds"]
    _close(img, j_img, 1e-4)
    assert float(ported["logit_scale"]) == pytest.approx(
        float(jparams["logit_scale"]))
    # clip_scores / l2norm as the JAX package's
    ref = jclip.clip_scores(jnp.asarray(txt.numpy()), j_img,
                            jparams["logit_scale"])
    got = tclip.clip_scores(txt, img, ported["logit_scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_registered_towers_seeded_and_from_pretrained(hf_clip, tmp_path):
    from viquae_torch.core.config import get_class_from_name

    tower_cls = get_class_from_name("CLIPTextTower")
    assert tower_cls is tclip.CLIPTextTower
    tower = tower_cls(seed=0, device="cpu", **{
        k: getattr(TEXT_CFG, k) for k in ("vocab_size", "hidden_size",
                                          "num_layers", "num_heads",
                                          "intermediate_size",
                                          "max_positions", "projection_dim",
                                          "eos_token_id")})
    out = tower(torch.from_numpy(IDS), torch.from_numpy(MASK))
    assert out["text_embeds"].shape == (3, 16)
    same = tower_cls(cfg=tower.cfg, seed=0, device="cpu")
    assert torch.equal(same(torch.from_numpy(IDS))["text_embeds"],
                       tower(torch.from_numpy(IDS))["text_embeds"])

    _, model = hf_clip
    model.save_pretrained(tmp_path / "clip")
    loaded = tclip.CLIPTextTower.from_pretrained(tmp_path / "clip",
                                                 device="cpu")
    ref = jclip.CLIPTextTower.from_pretrained(tmp_path / "clip")
    _close(loaded(torch.from_numpy(IDS[:2]),
                  torch.from_numpy(MASK[:2]))["text_embeds"],
           ref(jnp.asarray(IDS[:2]), jnp.asarray(MASK[:2]))["text_embeds"],
           1e-4)
    vis = get_class_from_name("CLIPVisionTower").from_pretrained(
        tmp_path / "clip", device="cpu")
    pixels = torch.from_numpy(_images((1, 32, 32, 3)))
    assert vis(pixels)["image_embeds"].shape == (1, 16)
