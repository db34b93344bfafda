"""The face chain of the port against the JAX package's on the same
converted weights (JAX on the CPU): ArcFace, P/R/O-Net, the NMS, the
crops and resizes, the whole MTCNN cascade at a 64-px canvas, alignment,
FaceEmbedder and FaceQueryEncoder (its full-resolution redo path and NaN
rows). Tolerances are stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.models import arcface as tarc
from viquae_torch.models import convert
from viquae_torch.models import mtcnn as tm
from viquae_tpu.models import arcface as jarc
from viquae_tpu.models import mtcnn as jm

from torch_helpers import jax_tree, randomize_batch_norm_

torch.set_num_threads(2)

# the cascade at a small canvas: 4 pyramid scales. Thresholds 0.5 let
# every stage keep some and drop some candidates of the seeded weights
CASCADE_CFG = jm.MTCNNConfig(canvas=64, min_face_size=20,
                             thresholds=(0.5, 0.5, 0.5))
ARC_CFG = jarc.ArcFaceConfig(stage_sizes=(1, 1, 1, 1), width=8,
                             embedding_size=16)
MARGIN = 1e-4   # no stage probability may lie closer to its threshold
BOX_ATOL = 1e-2  # px: measured 2e-3 (three chained calibrations amplify
#                  the f32 reordering of the seeded nets' regressions)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# seeded weights are drawn with the port (the JAX inits take ~10 s each on
# the CPU) and handed to both packages as the JAX tree
@pytest.fixture(scope="module")
def mtcnn_pair():
    tree = jax_tree(tm.init(seed=3, device="cpu"))
    return tree, tm.from_jax(tree, device="cpu")


@pytest.fixture(scope="module")
def arcface_pair():
    tree = jax_tree(randomize_batch_norm_(
        tarc.init(ARC_CFG, seed=4, device="cpu"), seed=9))
    return tree, tarc.from_jax(tree, ARC_CFG, device="cpu")


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


# --------------------------------------------------------------------------
# ArcFace
# --------------------------------------------------------------------------
@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_arcface_matches_jax(arcface_pair, compute_dtype):
    """f32 within 1e-4 of the output scale, bf16 within 1e-2: both
    packages keep every sum in f32, but the sums differ in the order of
    their additions, and the bf16 casts before each convolution and the
    embedding layer turn a few last-bit differences into one-ulp bf16 flips
    (the port's two convolution routes read 1e-3 apart, the JAX package
    2.7e-3 from either)."""
    tree, model = arcface_pair
    x = np.random.default_rng(0).uniform(-1, 1, (3, 112, 112, 3)).astype(
        np.float32)
    bf16 = compute_dtype == "bf16"
    ref = np.asarray(jarc.apply(tree, ARC_CFG, jnp.asarray(x),
                                jnp.bfloat16 if bf16 else None))
    got = tarc.apply(model, ARC_CFG, _t(x), torch.bfloat16 if bf16 else None)
    _close(got, ref, 1e-2 if bf16 else 1e-4)


def test_arcface_insightface_loader_matches_jax(arcface_pair):
    tree, model = arcface_pair
    sd = {}
    for name, a in convert.state_dict_from_tree(tree).items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer{int(parts[1]) + 1}", parts[2]] + parts[3:]
        name = (".".join(parts).replace("downsample_conv", "downsample.0")
                .replace("downsample_bn", "downsample.1")
                .replace("features_bn", "features"))
        sd[name] = torch.from_numpy(a)
    loaded = tarc.params_from_insightface(sd, ARC_CFG, device="cpu")
    for (na, ta), (nb, tb) in zip(loaded.state_dict().items(),
                                  model.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    for a, b in zip(jax.tree.leaves(_np_tree(
            jarc.params_from_insightface(sd, ARC_CFG))),
            jax.tree.leaves(tarc.tree_from_insightface(sd, ARC_CFG))):
        np.testing.assert_array_equal(a, b)
    seeded = tarc.init(ARC_CFG, seed=0, device="cpu")
    assert seeded.state_dict().keys() == model.state_dict().keys()


# --------------------------------------------------------------------------
# P/R/O-Net, pooling, geometry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("net,size", [("pnet", 31), ("pnet", 64),
                                      ("rnet", 24), ("onet", 48)])
def test_stage_networks_match_jax(mtcnn_pair, net, size):
    """Every output within 1e-5 absolute (probabilities, regressions,
    landmarks of inputs normalised like the cascade's)."""
    tree, model = mtcnn_pair
    x = np.random.default_rng(1).uniform(-1, 1, (5, size, size, 3)).astype(
        np.float32)
    ref = getattr(jm, f"{net}_apply")(tree[net], jnp.asarray(x))
    got = getattr(tm, f"{net}_apply")(getattr(model, net), _t(x))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("h,window,stride", [
    (22, 3, 2), (23, 3, 2), (10, 3, 2), (3, 3, 2), (9, 2, 2), (10, 2, 2),
    (2, 2, 2), (5, 2, 2)])
def test_ceil_mode_maxpool_matches_reference_padding(h, window, stride):
    x = np.random.default_rng(2).standard_normal((2, h, h + 1, 4)).astype(
        np.float32)
    ref = np.asarray(jm._maxpool(jnp.asarray(x), window, stride))
    got = tm._maxpool(_t(x).permute(0, 3, 1, 2), window, stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def _boxes(rng, n, lead=()):
    b = rng.uniform(0, 100, lead + (n, 4)).astype(np.float32)
    b[..., 2:] = b[..., :2] + rng.uniform(5, 30, lead + (n, 2))
    return b


@pytest.mark.parametrize("mode", ["union", "min"])
def test_iou_rerec_calibrate_match(mode):
    rng = np.random.default_rng(3)
    boxes = _boxes(rng, 12)
    np.testing.assert_allclose(
        tm.iou_matrix(_t(boxes), mode).numpy(),
        np.asarray(jm.iou_matrix(jnp.asarray(boxes), mode)), atol=1e-6)
    reg = rng.uniform(-0.2, 0.2, (12, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tm.rerec(tm.calibrate(_t(boxes), _t(reg))).numpy(),
        np.asarray(jm.rerec(jm.calibrate(jnp.asarray(boxes),
                                         jnp.asarray(reg)))), atol=1e-4)


@pytest.mark.parametrize("mode", ["union", "min"])
@pytest.mark.parametrize("max_keep", [None, 3, 100])
def test_nms_fixed_batched_equals_jax_per_row(mode, max_keep):
    """A batch of rows through one call equals the JAX while_loop on each
    row: random rows, an all-invalid row (argmax of an all-NEG_INF row
    must keep nothing) and rows of EXACTLY tied scores (the lower index
    wins, as jnp.argmax)."""
    rng = np.random.default_rng(4)
    k = 40
    boxes = _boxes(rng, k, (6,))
    scores = rng.uniform(0, 1, (6, k)).astype(np.float32)
    valid = rng.random((6, k)) < 0.7
    valid[1] = False                        # nothing live
    scores[2] = 0.5                         # all tied
    scores[3, ::2] = scores[3, 1::2]        # pairwise ties
    boxes[3, ::2] = boxes[3, 1::2]          # ... on the same boxes
    got = tm.nms_fixed(_t(boxes), _t(scores), _t(valid), 0.5, mode=mode,
                       max_keep=max_keep).numpy()
    for r in range(6):
        ref = np.asarray(jm.nms_fixed(
            jnp.asarray(boxes[r]), jnp.asarray(scores[r]),
            jnp.asarray(valid[r]), 0.5, mode=mode, max_keep=max_keep))
        np.testing.assert_array_equal(got[r], ref, err_msg=str(r))
    assert not got[1].any()
    if max_keep is not None:
        assert (got.sum(1) <= max_keep).all()
    if max_keep == 3:
        assert got.sum(1).max() == 3      # the cap binds
    # any leading shape: (2, 3, K) rows equal the (6, K) call
    again = tm.nms_fixed(_t(boxes).reshape(2, 3, k, 4),
                         _t(scores).reshape(2, 3, k),
                         _t(valid).reshape(2, 3, k), 0.5, mode=mode,
                         max_keep=max_keep)
    np.testing.assert_array_equal(again.reshape(6, k).numpy(), got)


def test_top_k_breaks_ties_by_the_lower_index():
    x = np.array([[0.5, 0.7, 0.5, 0.7, 0.1, 0.5],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for row in x:
        rv, ri = jax.lax.top_k(jnp.asarray(row), 4)
        gv, gi = tm._top_k(_t(row), 4)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


def test_crop_resize_matches_jax():
    """Boxes inside, straddling the border and outside: within 1e-3 on
    0-255 pixels."""
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 255, (2, 40, 52, 3)).astype(np.float32)
    boxes = np.array([[[3.2, 4.1, 30.7, 34.9], [-8.0, -5.0, 12.5, 10.0],
                       [40.0, 30.0, 70.0, 60.0], [60.0, 45.0, 80.0, 70.0]],
                      [[0.0, 0.0, 52.0, 40.0], [10.0, 12.0, 10.5, 12.3],
                       [20.0, 5.0, 44.0, 29.0], [1.0, 1.0, 2.0, 2.0]]],
                     np.float32)
    for out in (24, 48):
        ref = np.stack([np.asarray(jm.crop_resize(
            jnp.asarray(imgs[i]), jnp.asarray(boxes[i]), out))
            for i in range(2)])
        got = tm.crop_resize(_t(imgs), _t(boxes), out).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("size", [12, 23, 64, 100])
def test_bilinear_resize_clamps_like_mode_nearest(size):
    img = np.random.default_rng(6).uniform(0, 255, (2, 40, 50, 3)).astype(
        np.float32)
    ref = np.stack([np.asarray(jm._bilinear_resize(jnp.asarray(im), size))
                    for im in img])
    got = tm._bilinear_resize(_t(img), size).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


# --------------------------------------------------------------------------
# the whole cascade
# --------------------------------------------------------------------------
def _cascade_inputs():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, 64, 64, 3)).astype(np.float32)
    # flat 8x8 blocks and zero padding: tied PNet probabilities
    imgs[1] = np.repeat(np.repeat(imgs[1, ::8, ::8], 8, 0), 8, 1)
    imgs[2, 40:] = 0
    imgs[2, :, 50:] = 0
    hws = np.array([[64, 64], [64, 64], [40, 50], [64, 48]], np.float32)
    return imgs, hws


def test_cascade_matches_jax(mtcnn_pair):
    """detect_faces_batch against the JAX per-image cascade (vmapped):
    valid masks equal, probabilities within 1e-4, boxes and landmarks
    within BOX_ATOL px. Every stage probability is first held MARGIN away
    from its threshold, so a seed near a threshold fails here, loudly."""
    tree, model = mtcnn_pair
    cfg = CASCADE_CFG
    imgs, hws = _cascade_inputs()
    images, true_hws = _t(imgs), _t(hws)
    boxes, scores, regs, valid = tm.pnet_stage(model, images, true_hws, cfg)
    b1, v1 = tm.stage1_nms(boxes, scores, regs, valid, cfg)
    p2, b2, v2 = tm.rnet_stage(model, images, b1, v1, cfg)
    p3, out = tm.onet_stage(model, images, b2, v2, cfg)
    margins = [(scores - cfg.thresholds[0]).abs().min(),
               (p2 - cfg.thresholds[1]).abs()[v1].min(),
               (p3 - cfg.thresholds[2]).abs()[v2].min()]
    assert min(float(m) for m in margins) > MARGIN, margins
    # non-vacuous: every stage keeps some and drops some
    assert 0 < int(v2.sum()) < v1.numel() and 0 < int(out["valid"].sum())
    direct = tm.detect_faces_batch(model, images, true_hws, cfg)
    for key in out:
        assert torch.equal(direct[key], out[key]), key

    ref = jm.detect_faces_batch(tree, jnp.asarray(imgs), jnp.asarray(hws),
                                cfg)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    mask = ref["valid"]
    np.testing.assert_array_equal(out["valid"].numpy(), mask)
    np.testing.assert_allclose(out["probs"].numpy(), ref["probs"], rtol=0,
                               atol=1e-4)
    for key in ("boxes", "landmarks"):
        np.testing.assert_allclose(out[key].numpy()[mask], ref[key][mask],
                                   rtol=0, atol=BOX_ATOL)
    one = tm.detect_faces(model, images[2], true_hws[2], cfg)
    np.testing.assert_array_equal(one["valid"].numpy(), mask[2])


def test_facenet_loader_equals_the_tree(mtcnn_pair):
    """facenet_pytorch's key layout is the tree's own names."""
    tree, model = mtcnn_pair
    sd = {k: torch.from_numpy(v)
          for k, v in convert.state_dict_from_tree(tree).items()}
    loaded = tm.params_from_facenet(sd, device="cpu")
    for (na, ta), (nb, tb) in zip(loaded.state_dict().items(),
                                  model.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    for a, b in zip(jax.tree.leaves(_np_tree(jm.params_from_facenet(sd))),
                    jax.tree.leaves(tm.tree_from_facenet(sd))):
        np.testing.assert_array_equal(a, b)
    assert tm.MTCNNConfig().scales == jm.MTCNNConfig().scales


# --------------------------------------------------------------------------
# alignment, FaceEmbedder, FaceQueryEncoder
# --------------------------------------------------------------------------
LM = np.asarray([[20.0, 30.0], [44.0, 30.0], [32.0, 44.0],
                 [24.0, 56.0], [42.0, 56.0]], np.float32)


def test_align_face_matches_jax():
    """One image, and a batch: within 2e-2 on 0-255 pixels (the closed
    form and the SVD solve the 2x2 problem with different f32 rounding,
    ~1e-6 relative; that moves sample points by ~1e-4 px over random
    pixels whose gradients reach ~255 per px)."""
    from viquae_torch.image import face_recognition as tfr
    from viquae_tpu.image import face_recognition as jfr

    np.testing.assert_array_equal(tfr.SRC, jfr.SRC)
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (70, 90, 3)).astype(np.float32)
    ref = np.asarray(jfr.align_face(jnp.asarray(img), jnp.asarray(LM)))
    got = tfr.align_face(_t(img), _t(LM)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    lms = np.stack([LM, LM[::-1].copy() + 3.0])
    both = tfr.align_face(torch.stack([_t(img), _t(img)]), _t(lms))
    np.testing.assert_allclose(both[0].numpy(), got, rtol=0, atol=1e-4)


def test_face_embedder_matches_jax_and_handles_non_rgb(arcface_pair):
    """FaceEmbedder's column against the JAX align -> normalize -> ArcFace
    on the same image (within 1e-4 of the embedding scale); 'L' and 'RGBA'
    inputs are converted; None landmarks keep None."""
    from PIL import Image

    from viquae_torch.image.face_recognition import FaceEmbedder
    from viquae_tpu.image import face_recognition as jfr
    from viquae_tpu.ops import image as jops

    tree, model = arcface_pair
    base = np.random.default_rng(11).integers(0, 255, (70, 90, 3),
                                              dtype=np.uint8)
    rgb = Image.fromarray(base)
    batch = {"image": [rgb, rgb.convert("L"), rgb.convert("RGBA"), None],
             "face_landmarks": [[LM], [LM], [LM, LM + 1.0], None]}
    embedder = FaceEmbedder(model, cfg=ARC_CFG, max_n_faces=2,
                            batch_size=2, device="cpu")
    out = embedder(dict(batch))["face_embedding"]
    assert out[3] is None and len(out[2]) == 2 and len(out[0]) == 1
    crop = jfr.align_face(jnp.asarray(base.astype(np.float32)),
                          jnp.asarray(LM))
    ref = np.asarray(jarc.apply(tree, ARC_CFG, jops.normalize(
        crop[None] / 255.0, jops.FACE_MEAN, jops.FACE_STD)))[0]
    _close(out[0][0], ref, 1e-4)
    np.testing.assert_allclose(out[2][0], out[0][0], rtol=1e-6, atol=1e-6)
    gray = np.asarray(rgb.convert("L"), np.float32)
    assert FaceEmbedder._to_rgb_array(rgb.convert("L")).shape == (70, 90, 3)
    np.testing.assert_array_equal(
        FaceEmbedder._to_rgb_array(gray)[..., 1], gray)


def test_face_query_encoder_matches_the_dataset_stages(mtcnn_pair,
                                                       arcface_pair):
    """The online face leg equals FaceDetector -> most probable face ->
    FaceEmbedder at ORIGINAL resolution (within 1e-4), an image LARGER
    than the canvas included (the full-resolution redo path); rows without
    an image, with an image below min_face_size, or without a face are
    NaN."""
    import dataclasses

    from PIL import Image

    from viquae_torch.image.face_detection import FaceDetector
    from viquae_torch.image.face_recognition import (FaceEmbedder,
                                                     FaceQueryEncoder)

    _, m_model = mtcnn_pair
    _, a_model = arcface_pair
    rng = np.random.default_rng(4)
    images = [
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)),
        Image.fromarray(rng.integers(0, 255, (128, 96, 3), dtype=np.uint8)),
        None,
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)),
        Image.fromarray(np.zeros((10, 40, 3), np.uint8)),      # too small
    ]
    encoder = FaceQueryEncoder(m_model, a_model, mtcnn_cfg=CASCADE_CFG,
                               arcface_cfg=ARC_CFG, batch_size=4,
                               device="cpu")
    online = encoder(images)
    assert online.shape == (5, 16)

    detector = FaceDetector(m_model, cfg=CASCADE_CFG, batch_size=4,
                            device="cpu")
    embedder = FaceEmbedder(a_model, cfg=ARC_CFG, device="cpu")
    probs, _, landmarks = detector.detect_batch(images)
    for i, img in enumerate(images):
        if img is None or landmarks[i] is None:
            assert np.isnan(online[i]).all(), i
            continue
        best = int(np.argmax(probs[i]))
        crop = embedder._aligned_crop(
            FaceEmbedder._to_rgb_array(img), landmarks[i][best])
        ref = embedder._embed_crops([crop])[0]
        np.testing.assert_allclose(online[i], ref, rtol=1e-4, atol=1e-4)
    # non-vacuous: the oversized image took the redo path with a face
    assert landmarks[1] is not None and np.isfinite(online[1]).all()
    assert np.isnan(online[[2, 4]]).all()
    assert np.isnan(encoder([None, None])).all()
    # a final threshold no probability reaches: no face anywhere -> NaN
    strict = FaceQueryEncoder(
        m_model, a_model, mtcnn_cfg=dataclasses.replace(
            CASCADE_CFG, thresholds=(0.5, 0.5, 1.0 - 1e-7)),
        arcface_cfg=ARC_CFG, batch_size=4, device="cpu")
    assert np.isnan(strict(images)).all()


def test_face_query_encoder_matches_jax(mtcnn_pair, arcface_pair):
    """The port's FaceQueryEncoder against the JAX package's on the same
    images and weights, row by row: NaN rows equal (no image, an image
    below min_face_size, no face), every other row within 1e-3 of the
    embedding scale (measured 4e-4: alignment's f32 rounding,
    test_align_face_matches_jax, carried through ArcFace). Two sub-batches, the second padded; two
    images larger than the 64-px canvas take the full-resolution redo
    path."""
    from PIL import Image

    from viquae_torch.image.face_recognition import FaceQueryEncoder
    from viquae_tpu.image import face_recognition as jfr

    m_tree, m_model = mtcnn_pair
    a_tree, a_model = arcface_pair
    rng = np.random.default_rng(4)
    sizes = [(64, 64), (128, 96), None, (48, 64), (10, 40), (96, 150),
             (64, 56), (40, 40)]
    images = [None if s is None else Image.fromarray(
        rng.integers(0, 255, s + (3,), dtype=np.uint8)) for s in sizes]
    ours = FaceQueryEncoder(m_model, a_model, mtcnn_cfg=CASCADE_CFG,
                            arcface_cfg=ARC_CFG, batch_size=4,
                            device="cpu")(images)
    ref = jfr.FaceQueryEncoder(m_tree, a_tree, mtcnn_cfg=CASCADE_CFG,
                               arcface_cfg=ARC_CFG, batch_size=4)(images)
    assert ours.shape == ref.shape == (len(images), 16)
    absent = np.isnan(ref).all(axis=1)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert absent[[2, 4]].all()
    # non-vacuous: both oversized images, and most others, have a face
    assert not absent[[1, 5]].any() and (~absent).sum() >= 5
    _close(ours[~absent], ref[~absent], 1e-3)
