"""The port's multimodal encoders (viquae_torch/models/mm.py), the export
format (train/checkpoint.py), the host formatting (train/data.py) and
MMEmbedder against the JAX package's on the same inputs and weights: the
cases of tests/test_mm_qa.py (:55-160 ECA, ILF and Flamant, :275 CLIPForIR,
:377 the registry round trip, :420 ILF packed) and tests/test_packing.py
(:273 ECA packed), at tiny widths, JAX on the CPU.

Weights: the JAX inits' trees (numpy leaves) go to both packages; gates
are set to non-zero values wherever gating is on, since a gate at its
initial 0 hides the gated branch. Tolerance: f32 everywhere, outputs
within 2e-5 of the output scale (max |got - ref| <= 2e-5 max |ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.models import bert as tbert
from viquae_torch.models import mm as tmm
from viquae_torch.train import checkpoint as tckpt
from viquae_torch.train import data as tdata
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import mm as jmm
from viquae_tpu.train import checkpoint as jckpt
from viquae_tpu.train import data as jdata

torch.set_num_threads(2)

BERT = dict(vocab_size=60, hidden_size=24, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=48,
            max_position_embeddings=40, add_pooler=False)
RTOL = 2e-5


def cfgs(cls="MMConfig", **kw):
    """The same configuration in both packages."""
    base = dict(n_faces=2, face_dim=8, bbox_dim=7,
                image_dims=(("clip", 10), ("imagenet", 12)))
    base.update(kw)
    j = getattr(jmm, cls)(bert=jbert.BertConfig(**BERT), **base)
    t = getattr(tmm, cls)(bert=tbert.BertConfig(**BERT), **base)
    return j, t


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def set_gates(tree, value=0.6):
    """Every tanh gate of a JAX tree to a non-zero value (in place)."""
    if isinstance(tree, dict):
        if set(tree) == {"gate"}:
            tree["gate"] = np.full((1,), value, np.float32)
        for v in tree.values():
            set_gates(v, value + 0.1)
    return tree


def inputs(b=3, l=6, n_images=1, n_faces=2, seed=0, image_dims=None):
    """numpy text/face/image inputs; row 2 has no valid face, row 1 one."""
    rng = np.random.default_rng(seed)
    text = {"input_ids": rng.integers(0, 60, (b, l)).astype(np.int32),
            "attention_mask": np.ones((b, l), np.int32)}
    face_mask = np.zeros((b, n_images, n_faces), np.int32)
    face_mask[0] = 1
    if n_faces:
        face_mask[1, :, 0] = 1
    face = {"face": rng.standard_normal((b, n_images, n_faces, 8)).astype(
                np.float32),
            "bbox": rng.standard_normal((b, n_images, n_faces, 7)).astype(
                np.float32),
            "attention_mask": face_mask}
    image = {name: {"input": rng.standard_normal((b, n_images, dim)).astype(
                        np.float32),
                    "attention_mask": np.ones((b, n_images), np.int32)}
             for name, dim in (image_dims or (("clip", 10), ("imagenet", 12)))}
    return text, face, image


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def tt(tree):
    return jax.tree.map(torch.from_numpy, tree)


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), \
        np.abs(got - ref).max() / np.abs(ref).max()


# --------------------------------------------------------------------------
# ECA
# --------------------------------------------------------------------------
ECA_CASES = {
    "default": {},
    "gating": {"gating": True},
    "no_text": {"no_text": True},
    "exclusive": {"face_and_image_are_exclusive": True},
    "two_images": {"n_images": 2},
    "no_faces": {"n_faces": 0},
}


@pytest.mark.parametrize("case", sorted(ECA_CASES))
def test_eca_matches_jax(case):
    kw = ECA_CASES[case]
    jcfg, tcfg = cfgs(**kw)
    tree = np_tree(jmm.eca_init(jax.random.key(0), jcfg))
    set_gates(tree)
    text, face, image = inputs(n_images=jcfg.n_images,
                               n_faces=jcfg.n_faces)
    ref = jmm.eca_apply(tree, jcfg, jx(text), jx(face), jx(image))
    model = tmm.from_jax(tmm.ECA, tcfg, tree, device="cpu")
    got = tmm.eca_apply(model, tcfg, tt(text), tt(face), tt(image))
    assert got.last_hidden_state.shape == ref.last_hidden_state.shape
    close(got.pooler_output, ref.pooler_output)
    close(got.last_hidden_state, ref.last_hidden_state)


def test_eca_mask_effect():
    """A masked face changes nothing; an unmasked one changes the row."""
    _, tcfg = cfgs()
    model = tmm.init(tmm.ECA, tcfg, seed=0, device="cpu")
    text, face, image = inputs()
    out = tmm.eca_apply(model, tcfg, tt(text), tt(face), tt(image))
    for row, changes in ((2, False), (0, True)):
        face2 = {k: v.copy() for k, v in face.items()}
        face2["face"][row] += 100.0
        out2 = tmm.eca_apply(model, tcfg, tt(text), tt(face2), tt(image))
        same = torch.allclose(out.pooler_output[row],
                              out2.pooler_output[row], atol=1e-5)
        assert same != changes


def test_seeded_gates_start_at_zero():
    """The port's seeded init keeps the gates at 0, as the JAX inits:
    visual features change nothing then."""
    _, tcfg = cfgs(gating=True)
    model = tmm.init(tmm.ECA, tcfg, seed=1, device="cpu")
    assert float(model.face_gate.gate) == 0.0
    text, face, image = inputs()
    out = tmm.eca_apply(model, tcfg, tt(text), tt(face), tt(image))
    face["face"] += 5.0
    out2 = tmm.eca_apply(model, tcfg, tt(text), tt(face), tt(image))
    assert torch.allclose(out.pooler_output, out2.pooler_output, atol=1e-5)


# --------------------------------------------------------------------------
# ILF
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["default", "exclusive", "no_faces"])
def test_ilf_matches_jax(case):
    kw = {"default": {}, "exclusive": {"face_and_image_are_exclusive": True},
          "no_faces": {"n_faces": 0}}[case]
    jcfg, tcfg = cfgs(**kw)
    tree = np_tree(jmm.ilf_init(jax.random.key(1), jcfg))
    text, face, image = inputs(n_faces=jcfg.n_faces, seed=2)
    ref = jmm.ilf_apply(tree, jcfg, jx(text), jx(face), jx(image))
    model = tmm.from_jax(tmm.ILF, tcfg, tree, device="cpu")
    close(tmm.ilf_apply(model, tcfg, tt(text), tt(face),
                        tt(image)).pooler_output, ref.pooler_output)


def test_ilf_face_sum_ignores_masked_faces():
    _, tcfg = cfgs()
    model = tmm.init(tmm.ILF, tcfg, seed=0, device="cpu")
    text, face, image = inputs()
    out = tmm.ilf_apply(model, tcfg, tt(text), tt(face), tt(image))
    face["face"][2] += 9.0
    out2 = tmm.ilf_apply(model, tcfg, tt(text), tt(face), tt(image))
    assert torch.allclose(out.pooler_output[2], out2.pooler_output[2],
                          atol=1e-5)


# --------------------------------------------------------------------------
# Flamant, CLIPForIR
# --------------------------------------------------------------------------
@pytest.mark.parametrize("every,gating", [(1, True), (2, False)])
def test_flamant_matches_jax(every, gating):
    jcfg, tcfg = cfgs(cls="FlamantConfig", image_dims=(("clip", 10),),
                      gating=gating, multimodal_attention_every=every,
                      image_num_attention_heads=2,
                      image_intermediate_size=48)
    tree = set_gates(np_tree(jmm.flamant_init(jax.random.key(2), jcfg)))
    text, face, image = inputs(seed=3, image_dims=(("clip", 10),))
    text["attention_mask"][1, 4:] = 0
    ref = jmm.flamant_apply(tree, jcfg, jx(text), jx(face), jx(image))
    model = tmm.from_jax(tmm.Flamant, tcfg, tree, device="cpu")
    got = tmm.flamant_apply(model, tcfg, tt(text), tt(face), tt(image))
    close(got.last_hidden_state, ref.last_hidden_state)


def test_clip_for_ir_matches_jax():
    from viquae_torch.models import clip as tclip
    from viquae_tpu.models import clip as jclip

    kw_t = dict(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2,
                intermediate_size=32, max_positions=16, projection_dim=8,
                eos_token_id=49)
    kw_v = dict(hidden_size=16, num_layers=1, num_heads=2,
                intermediate_size=32, image_size=16, patch_size=8,
                projection_dim=8)
    jt, jv = jclip.CLIPTextConfig(**kw_t), jclip.CLIPVisionConfig(**kw_v)
    t_cfg, v_cfg = tclip.CLIPTextConfig(**kw_t), tclip.CLIPVisionConfig(**kw_v)
    key = jax.random.key(0)
    tree = np_tree({"text": jclip.text_init(key, jt),
                    "vision": jclip.vit_init(jax.random.fold_in(key, 1), jv)})
    ids = np.array([[0, 5, 49, 1], [0, 7, 8, 49]], np.int32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.int32)
    px = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    ref = jmm.clip_for_ir_apply(tree, jt, jv, jnp.asarray(ids),
                                jnp.asarray(mask), jnp.asarray(px))
    params = {"text": tclip.text_from_jax(tree["text"], t_cfg, device="cpu"),
              "vision": tclip.vit_from_jax(tree["vision"], v_cfg,
                                           device="cpu")}
    got = tmm.clip_for_ir_apply(params, t_cfg, v_cfg, torch.from_numpy(ids),
                                torch.from_numpy(mask), torch.from_numpy(px))
    close(got.pooler_output, ref.pooler_output)


# --------------------------------------------------------------------------
# packed canvases
# --------------------------------------------------------------------------
def _mm_batch(seed, b, n_faces=2):
    """tests/test_packing.py::_mm_batch, ragged texts."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 14, b)
    ids = np.zeros((b, 16), np.int32)
    mask = np.zeros((b, 16), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, 60, n)
        mask[i, :n] = 1
    return {
        "text_inputs": {"input_ids": ids, "attention_mask": mask},
        "face_inputs": {
            "face": rng.standard_normal((b, 1, n_faces, 8)).astype(
                np.float32),
            "bbox": rng.standard_normal((b, 1, n_faces, 7)).astype(
                np.float32),
            "attention_mask": (rng.random((b, 1, n_faces)) < 0.6).astype(
                np.int32)},
        "image_inputs": {"clip": {
            "input": rng.standard_normal((b, 1, 10)).astype(np.float32),
            "attention_mask": (rng.random((b, 1)) < 0.7).astype(np.int32)}},
    }


CANVAS = ("input_ids", "segment_ids", "position_ids", "cls_rows", "cls_cols")


@pytest.mark.parametrize("exclusive", [False, True])
def test_eca_packed_equals_padded_and_jax(exclusive):
    jcfg, tcfg = cfgs(image_dims=(("clip", 10),), gating=True,
                      face_and_image_are_exclusive=exclusive)
    tree = set_gates(np_tree(jmm.eca_init(jax.random.key(3), jcfg)))
    batch = _mm_batch(11, b=9)
    t_vis = tdata.mm_visual_mask(batch["face_inputs"],
                                 batch["image_inputs"]).shape[1]
    canvas = tdata.pack_mm_text_inputs(
        batch, 16 + t_vis, face_and_image_are_exclusive=exclusive)
    jcanvas = jdata.pack_mm_text_inputs(
        batch, 16 + t_vis, face_and_image_are_exclusive=exclusive)
    assert canvas.keys() == jcanvas.keys()
    for name in canvas:
        np.testing.assert_array_equal(canvas[name], jcanvas[name])
    names = [f"canvas_{n}" for n in CANVAS + ("vis_rows", "vis_cols")]
    ref = jmm.eca_apply_packed(
        tree, jcfg, *(jnp.asarray(canvas[n]) for n in names),
        jx(batch["face_inputs"]), jx(batch["image_inputs"]))[:9]
    model = tmm.from_jax(tmm.ECA, tcfg, tree, device="cpu")
    got = tmm.eca_apply_packed(
        model, tcfg, *(torch.from_numpy(canvas[n]) for n in names),
        tt(batch["face_inputs"]), tt(batch["image_inputs"]))[:9]
    close(got, ref)
    padded = tmm.eca_apply(model, tcfg, tt(batch["text_inputs"]),
                           tt(batch["face_inputs"]),
                           tt(batch["image_inputs"])).pooler_output
    close(got, padded.numpy())


def test_ilf_packed_equals_padded_and_jax():
    jcfg, tcfg = cfgs(image_dims=(("clip", 10),))
    tree = np_tree(jmm.ilf_init(jax.random.key(5), jcfg))
    batch = _mm_batch(4, b=7)
    canvas = tdata.pack_mm_text_inputs(batch, 16, needs_vis=False)
    assert "canvas_vis_rows" not in canvas
    names = [f"canvas_{n}" for n in CANVAS]
    ref = jmm.ilf_apply_packed(
        tree, jcfg, *(jnp.asarray(canvas[n]) for n in names),
        jx(batch["face_inputs"]), jx(batch["image_inputs"]))[:7]
    model = tmm.from_jax(tmm.ILF, tcfg, tree, device="cpu")
    got = tmm.ilf_apply_packed(
        model, tcfg, *(torch.from_numpy(canvas[n]) for n in names),
        tt(batch["face_inputs"]), tt(batch["image_inputs"]))
    close(got, ref)
    padded = tmm.ilf_apply(model, tcfg, tt(batch["text_inputs"]),
                           tt(batch["face_inputs"]),
                           tt(batch["image_inputs"])).pooler_output
    close(got, padded.numpy())


def test_visual_scatter_drops_out_of_range_pointers_as_jax():
    """``.at[rows, cols].set(v, mode="drop")``: negative pointers count from
    the end, pointers still outside the canvas are dropped; every other
    slot keeps its value."""
    rng = np.random.default_rng(0)
    r, c, d = 5, 7, 3
    hidden = rng.standard_normal((r, c, d)).astype(np.float32)
    rows = np.array([[0, 4, 5, 9], [-1, 2, -6, 3]], np.int32)
    cols = np.array([[1, 6, 0, 2], [0, -2, 3, 7]], np.int32)
    tokens = rng.standard_normal((2, 4, d)).astype(np.float32)
    ref = jnp.asarray(hidden).at[
        jnp.asarray(rows).reshape(-1), jnp.asarray(cols).reshape(-1)
    ].set(jnp.asarray(tokens).reshape(-1, d), mode="drop")
    got = tmm.scatter_visual_tokens(torch.from_numpy(hidden),
                                    torch.from_numpy(rows),
                                    torch.from_numpy(cols),
                                    torch.from_numpy(tokens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not np.array_equal(got.numpy(), hidden)   # some slots written


# --------------------------------------------------------------------------
# export directories and the registry
# --------------------------------------------------------------------------
def test_export_format_crosses_both_ways(tmp_path):
    jcfg, _ = cfgs(cls="FlamantConfig", image_dims=(("clip", 10),),
                   multimodal_attention_every=2,
                   image_num_attention_heads=2, image_intermediate_size=48)
    tree = np_tree(jmm.flamant_init(jax.random.key(4), jcfg))
    jckpt.export_params(tmp_path / "jax", tree, config={"a": 1})
    tckpt.export_params(tmp_path / "port", tree, config={"a": 1})
    with np.load(tmp_path / "jax" / "params.npz") as a, \
            np.load(tmp_path / "port" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "bert/layers/1/mlp/in/kernel" in a.files
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
    assert (tmp_path / "port" / "config.json").read_text() == \
        (tmp_path / "jax" / "config.json").read_text()
    # rebuilt from the names: lists where the keys are 0 .. n-1
    rebuilt = tckpt.import_params(tmp_path / "jax")
    assert isinstance(rebuilt["bert"]["layers"], list)
    assert isinstance(rebuilt["image_embeddings"], dict)
    assert jax.tree.structure(rebuilt["bert"]) == \
        jax.tree.structure(tree["bert"])
    for a, b in zip(jax.tree.leaves(rebuilt["bert"]),
                    jax.tree.leaves(tree["bert"])):
        np.testing.assert_array_equal(a, b)
    jax_back = jckpt.import_params(tmp_path / "port", tree)
    for a, b in zip(jax.tree.leaves(jax_back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["ECAEncoder", "IntermediateLinearFusion"])
def test_registry_round_trip_through_an_export_dir(tmp_path, name):
    """get_pretrained(name, export dir) of the port equals the JAX bundle
    loaded from the same directory (JAX's export_params)."""
    from viquae_torch.core.config import get_pretrained as tget
    from viquae_tpu.core.config import get_pretrained as jget

    cfg_kwargs = dict(
        bert={**BERT, "num_hidden_layers": 1},
        n_faces=2, face_dim=8, image_dims={"clip": 10, "imagenet": 12})
    jb = jget(name, **cfg_kwargs)
    jb.params = set_gates(np_tree(jb.params))
    jckpt.export_params(tmp_path, jb.params)
    jb = jget(name, str(tmp_path), **cfg_kwargs)
    tb = tget(name, str(tmp_path), device="cpu", **cfg_kwargs)
    assert tb.cfg.image_dims == (("clip", 10), ("imagenet", 12))
    text, face, image = inputs()
    ref = jb.apply_fn(jb.params, jx(text), jx(face), jx(image)).pooler_output
    got = tb.apply_fn(tb.params, tt(text), tt(face), tt(image)).pooler_output
    close(got, ref)
    seeded = tget(name, seed=3, device="cpu", **cfg_kwargs)
    assert seeded.params.state_dict().keys() == tb.params.state_dict().keys()


def test_evaluation_only_arguments_raise():
    """ECA and ILF train (dropout needs a CPU generator to draw its seeds
    from); Flamant stays evaluation only."""
    _, tcfg = cfgs()
    model = tmm.init(tmm.ECA, tcfg, seed=0, device="cpu")
    text, face, image = (tt(x) for x in inputs())
    with pytest.raises(ValueError, match="Generator"):
        tmm.eca_apply(model, tcfg, text, face, image, deterministic=False)
    gen = torch.Generator().manual_seed(0)
    out = tmm.eca_apply(model, tcfg, text, face, image, deterministic=False,
                        generator=gen, remat_layers=True).pooler_output
    assert torch.isfinite(out).all()
    _, fcfg = cfgs(cls="FlamantConfig", image_num_attention_heads=2,
                   image_intermediate_size=16)
    flamant = tmm.init(tmm.Flamant, fcfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="evaluation"):
        tmm.flamant_apply(flamant, fcfg, text, face, image,
                          deterministic=False)


@pytest.mark.parametrize("kind", ["eca", "ilf"])
def test_moe_eca_and_ilf_match_jax(kind):
    """A MoE BERT inside ECA / ILF (top-2 of 4 experts in every other
    layer): the JAX tree converts, the pooled output equals the JAX
    encoder's and the load-balance term is surfaced, equal to JAX's; the
    registry bundle builds one."""
    import dataclasses

    jcfg, tcfg = cfgs(gating=True)
    moe_kw = dict(moe_experts=4, moe_every=2, moe_capacity_factor=2.0)
    jcfg = dataclasses.replace(jcfg, bert=dataclasses.replace(jcfg.bert,
                                                              **moe_kw))
    tcfg = dataclasses.replace(tcfg, bert=dataclasses.replace(tcfg.bert,
                                                              **moe_kw))
    init, apply, module = {
        "eca": (jmm.eca_init, (jmm.eca_apply, tmm.eca_apply), tmm.ECA),
        "ilf": (jmm.ilf_init, (jmm.ilf_apply, tmm.ilf_apply), tmm.ILF),
    }[kind]
    tree = set_gates(np_tree(init(jax.random.key(5), jcfg)))
    assert "moe" in tree[{"eca": "bert", "ilf": "dpr_encoder"}[kind]][
        "layers"][1]
    text, face, image = inputs()
    ref = apply[0](tree, jcfg, jx(text), jx(face), jx(image))
    model = tmm.from_jax(module, tcfg, tree, device="cpu")
    got = apply[1](model, tcfg, tt(text), tt(face), tt(image))
    close(got.pooler_output, ref.pooler_output)
    assert float(got.moe_aux) == pytest.approx(float(ref.moe_aux), rel=1e-5)
    bundle = {"eca": tmm.ECAEncoder,
              "ilf": tmm.IntermediateLinearFusion}[kind](cfg=tcfg,
                                                         device="cpu")
    assert any(".moe." in name for name in bundle.params.state_dict())


# --------------------------------------------------------------------------
# host formatting copies
# --------------------------------------------------------------------------
def test_precomputed_features_and_formatter_equal_jax():
    rng = np.random.default_rng(0)
    items = [
        {"face_embedding": rng.standard_normal((3, 8)).tolist(),
         "face_box": rng.standard_normal((3, 7)).tolist(),
         "clip": rng.standard_normal(10).tolist()},
        {"face_embedding": None, "clip": [float("nan")] * 10},
        {"face_embedding": rng.standard_normal((1, 8)).tolist()},
    ]
    kw = dict(n_faces=2, face_dim=8, image_dims={"clip": 10, "imagenet": 4})
    ours = tdata.ImageFormatter(tdata.PreComputedImageFeatures(**kw))
    ref = jdata.ImageFormatter(jdata.PreComputedImageFeatures(**kw))
    text = {"input_ids": np.ones((3, 4), np.int32)}
    a = ours.format_batch(text, items, passage_items=items[::-1])
    b = ref.format_batch(text, items, passage_items=items[::-1])
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------
# MMEmbedder
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("tok")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "who", "is",
             "this"] + [f"ent{i}" for i in range(40)]
    (d / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"))


def _mm_rows(n, seed=0, n_faces=2):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        words = " ".join(f"ent{j}" for j in rng.integers(0, 40,
                                                          rng.integers(1, 9)))
        has_face = i % 3 != 1
        rows.append({
            "input": f"who is {words}", "index": int(rng.integers(0, 4)),
            "face_embedding": (rng.standard_normal((rng.integers(1, 4), 8))
                               .astype(np.float32).tolist()
                               if has_face and n_faces else None),
            "face_box": (rng.standard_normal((3, 7)).astype(np.float32)
                         .tolist() if has_face and n_faces else None),
            "clip": (rng.standard_normal(10).astype(np.float32).tolist()
                     if i % 4 else None),
        })
    return rows


@pytest.mark.parametrize("name,packed,kb", [
    ("ECAEncoder", False, False), ("ECAEncoder", True, False),
    ("ECAEncoder", True, True), ("IntermediateLinearFusion", False, True),
    ("IntermediateLinearFusion", True, False)])
def test_mm_embedder_matches_jax(tokenizer, devices, tmp_path, name, packed,
                                 kb):
    from viquae_torch.core.config import get_pretrained as tget
    from viquae_torch.ir.embedding import MMEmbedder as TMMEmbedder
    from viquae_tpu.core.config import get_pretrained as jget
    from viquae_tpu.ir.embedding import MMEmbedder as JMMEmbedder

    cfg_kwargs = dict(bert={**BERT, "vocab_size": 50}, n_faces=2,
                      face_dim=8, image_dims={"clip": 10}, gating=True)
    jb = jget(name, **cfg_kwargs)
    jb.params = set_gates(np_tree(jb.params))
    jckpt.export_params(tmp_path, jb.params)
    jb = jget(name, str(tmp_path), **cfg_kwargs)
    tb = tget(name, str(tmp_path), device="cpu", **cfg_kwargs)
    rows = _mm_rows(7)
    batch = {k: [r[k] for r in rows] for k in rows[0]}
    kb_rows = kb_features = None
    if kb:
        # the articles hold the image features; the passages only an index
        articles = _mm_rows(4, seed=1)
        kb_rows = [{"clip": a["clip"], "face_embedding": a["face_embedding"],
                    "face_box": a["face_box"]} for a in articles]
        kb_features = ["clip", "face_embedding", "face_box"]
        batch = {"input": batch["input"], "index": batch["index"]}
    feats = dict(n_faces=2, face_dim=8, image_dims={"clip": 10})
    common = dict(key="input", save_as="emb", max_length=16, batch_size=4,
                  kb=kb_rows, kb_features=kb_features)
    ref = JMMEmbedder(jb.apply_fn, jb.params, tokenizer,
                      jdata.PreComputedImageFeatures(**feats),
                      packed_bundle=jb if packed else None,
                      **common)(dict(batch))["emb"]
    got = TMMEmbedder(tb.apply_fn, tb.params, tokenizer,
                      tdata.PreComputedImageFeatures(**feats),
                      packed_bundle=tb if packed else None, device="cpu",
                      **common)(dict(batch))["emb"]
    assert got.shape == (7, 24) and got.dtype == np.float32
    close(got, ref)
    empty = TMMEmbedder(tb.apply_fn, tb.params, tokenizer,
                        tdata.PreComputedImageFeatures(**feats),
                        device="cpu", **common)(
        {"input": [], "index": []})["emb"]
    assert empty.shape == (0, 24)
