"""viquae_torch.ops.image against viquae_tpu.ops.image on the same inputs
(JAX on the CPU). Pixel values are in [0, 255] unless stated; tolerances
are float32 reordering (the JAX products run at HIGHEST precision, the
port's with TF32 off)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.ops import image as T
from viquae_tpu.ops import image as J

torch.set_num_threads(2)

ATOL_255 = 2e-4   # absolute, on values up to 255


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
@pytest.mark.parametrize("in_hw,out_hw", [
    ((37, 53), (16, 24)),     # downsample, non-square, antialiased
    ((30, 20), (64, 45)),     # upsample
    ((37, 53), (37, 20)),     # one axis unchanged
    ((40, 40), (40, 40)),     # identity
    ((9, 70), (31, 12)),      # up one axis, down the other
])
def test_resize_matches_jax_image_resize(in_hw, out_hw, method):
    x = np.random.default_rng(0).uniform(0, 255, (2, *in_hw, 3)).astype(
        np.float32)
    ref = np.asarray(J.resize_bilinear(jnp.asarray(x), out_hw,
                                       method=method))
    got = T.resize_bilinear(_t(x), out_hw, method=method).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL_255)


def test_resize_without_antialias_matches():
    x = np.random.default_rng(1).uniform(0, 1, (1, 50, 34, 3)).astype(
        np.float32)
    ref = np.asarray(J.resize_bilinear(jnp.asarray(x), (17, 21),
                                       antialias=False))
    got = T.resize_bilinear(_t(x), (17, 21), antialias=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,size", [("clip", 32), ("imagenet", 32),
                                       ("face", 16), ("clip", 50)])
def test_preprocess_matches(kind, size):
    u8 = np.random.default_rng(2).integers(0, 256, (2, 50, 70, 3)).astype(
        np.uint8)
    ref = np.asarray(J.preprocess(jnp.asarray(u8), size=size, kind=kind))
    got = T.preprocess(_t(u8), size=size, kind=kind).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="Unknown preprocessing"):
        T.preprocess(_t(u8), kind="nope")


def test_center_crop_and_normalize_match():
    x = np.random.default_rng(3).uniform(0, 1, (2, 11, 14, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        T.center_crop(_t(x), 7).numpy(),
        np.asarray(J.center_crop(jnp.asarray(x), 7)))
    np.testing.assert_allclose(
        T.normalize(_t(x), T.CLIP_MEAN, T.CLIP_STD).numpy(),
        np.asarray(J.normalize(jnp.asarray(x), J.CLIP_MEAN, J.CLIP_STD)),
        rtol=1e-6, atol=1e-6)
    assert (T.IMAGENET_MEAN, T.IMAGENET_STD, T.CLIP_MEAN, T.CLIP_STD,
            T.FACE_MEAN, T.FACE_STD) == (
        J.IMAGENET_MEAN, J.IMAGENET_STD, J.CLIP_MEAN, J.CLIP_STD,
        J.FACE_MEAN, J.FACE_STD)


@pytest.mark.parametrize("mode", ["constant", "nearest"])
def test_map_coordinates_modes_match_at_the_borders(mode):
    """Coordinates inside, on the edge and past every border: 'constant'
    reads 0 outside, 'nearest' clamps the taps."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (9, 13, 3)).astype(np.float32)
    ys = np.concatenate([rng.uniform(-2.5, 11.5, 200),
                         [-1.0, -0.5, 0.0, 8.0, 8.5, 9.0, 4.0]])
    xs = np.concatenate([rng.uniform(-2.5, 15.5, 200),
                         [6.0, -0.2, 12.0, 12.7, -1.0, 13.0, 13.2]])
    ys, xs = ys.astype(np.float32), xs.astype(np.float32)
    ref = np.stack([np.asarray(jax.scipy.ndimage.map_coordinates(
        jnp.asarray(img[..., c]), [jnp.asarray(ys), jnp.asarray(xs)],
        order=1, mode=mode)) for c in range(3)], -1)
    got = T.map_coordinates_bilinear(_t(img)[None], _t(ys)[None],
                                     _t(xs)[None], mode=mode)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL_255)
    with pytest.raises(ValueError, match="unsupported mode"):
        T.map_coordinates_bilinear(_t(img)[None], _t(ys)[None],
                                   _t(xs)[None], mode="wrap")


@pytest.mark.parametrize("matrix", [
    [[0.9, 0.1, 3.0], [-0.1, 0.9, 2.0]],          # inside, small rotation
    [[1.0, 0.0, -20.0], [0.0, 1.0, 25.0]],        # half the output outside
    [[1.3, 0.2, 30.0], [-0.2, 1.3, -8.0]],        # scaled, past two borders
    [[0.5, 0.0, 100.0], [0.0, 0.5, 100.0]],       # entirely outside: zeros
])
def test_affine_warp_matches_with_zero_borders(matrix):
    img = np.random.default_rng(5).uniform(0, 255, (40, 50, 3)).astype(
        np.float32)
    m = np.asarray(matrix, np.float32)
    ref = np.asarray(J.affine_warp(jnp.asarray(img), jnp.asarray(m),
                                   (36, 44)))
    got = T.affine_warp(_t(img), _t(m), (36, 44)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL_255)
    # a batch of two is each image warped alone
    both = T.affine_warp(torch.stack([_t(img), _t(img[::-1].copy())]),
                         torch.stack([_t(m), _t(m)]), (36, 44)).numpy()
    np.testing.assert_array_equal(both[0], got)


def _similarity(src, scale, theta, trans, reflect=False):
    rot = scale * np.array([[np.cos(theta), -np.sin(theta)],
                            [np.sin(theta), np.cos(theta)]])
    if reflect:
        rot = rot @ np.diag([1.0, -1.0])
    return (src @ rot.T + trans).astype(np.float32)


@pytest.mark.parametrize("case", ["exact", "noisy", "reflection",
                                  "landmarks"])
def test_umeyama_matches_svd_solution(case):
    """The closed form against the JAX SVD solution: an exact similarity,
    a noisy one, a REFLECTED point set (det(cov) < 0, where the SVD takes
    d = -1) and the face template itself."""
    rng = np.random.default_rng(6)
    src = rng.uniform(0, 100, (5, 2)).astype(np.float32)
    if case == "exact":
        dst = _similarity(src, 1.3, 0.4, [10.0, -5.0])
    elif case == "noisy":
        dst = _similarity(src, 0.7, -2.0, [3.0, 4.0]) + rng.normal(
            0, 2.0, (5, 2)).astype(np.float32)
    elif case == "reflection":
        dst = _similarity(src, 1.1, 0.9, [-7.0, 2.0], reflect=True)
    else:
        from viquae_tpu.image.face_recognition import SRC

        src = SRC + rng.normal(0, 3.0, (5, 2)).astype(np.float32) + 40.0
        dst = SRC
    ref = np.asarray(J.umeyama_similarity(jnp.asarray(src),
                                          jnp.asarray(dst)))
    got = T.umeyama_similarity(_t(src), _t(dst)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    if case == "exact":
        np.testing.assert_allclose(
            got[:, :2] @ src.T + got[:, 2:], dst.T, atol=1e-3)
    inv_ref = np.asarray(J.invert_affine(jnp.asarray(ref)))
    inv = T.invert_affine(_t(got)).numpy()
    np.testing.assert_allclose(inv, inv_ref, rtol=1e-4, atol=1e-4)


def test_umeyama_and_inverse_batched_equal_one_at_a_time():
    rng = np.random.default_rng(7)
    src = rng.uniform(0, 100, (6, 5, 2)).astype(np.float32)
    dst = rng.uniform(0, 100, (6, 5, 2)).astype(np.float32)
    batched = T.umeyama_similarity(_t(src), _t(dst))
    for i in range(6):
        one = T.umeyama_similarity(_t(src[i]), _t(dst[i]))
        np.testing.assert_allclose(batched[i].numpy(), one.numpy(),
                                   rtol=1e-6, atol=1e-5)
    inv = T.invert_affine(batched)
    eye = inv[:, :, :2] @ batched[:, :, :2]
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(
        np.eye(2), (6, 2, 2)), atol=1e-5)


def test_scale_box_matches():
    boxes = np.random.default_rng(8).uniform(0, 300, (3, 4, 4)).astype(
        np.float32)
    ref = np.asarray(J.scale_box(jnp.asarray(boxes), 320, 240))
    got = T.scale_box(_t(boxes), 320, 240).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
