"""bf16 convolutions keep their f32 sums (ROADMAP C6): the port's
``resnet.conv2d_f32`` on bf16 operands against the JAX package's
``resnet.conv(..., compute_dtype=bfloat16)`` and ``clip.vit_apply``'s patch
step, both ``preferred_element_type=float32``, for each kind of
convolution the towers run (1x1, 1x1 stride 2, 3x3, 3x3 stride 2, 7x7
stride 2, the ViT patch), and ``resnet._conv_upcast``, the reference that
chip_smoke.py phase 17 times it against.

Tolerance: the f32 reordering bound of each output, 2 g_n sum |x w| over
its n = cin * kh * kw products (g_n = n u / (1 - n u), u = 2^-24): both
sides multiply the same bf16 values exactly and differ only in the order of
the additions. A result rounded to bf16 (half a bf16 ulp, 2^-9 relative)
fails it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from viquae_torch.models import resnet as tresnet
from viquae_tpu.models import resnet as jresnet

torch.set_num_threads(2)

# (cin, cout, k, stride, padding, side)
KINDS = {
    "1x1": (24, 40, 1, 1, 0, 9),
    "1x1_stride2": (24, 40, 1, 2, 0, 9),
    "3x3": (16, 24, 3, 1, 1, 10),
    "3x3_stride2": (16, 24, 3, 2, 1, 11),
    "7x7_stride2": (3, 16, 7, 2, 3, 23),
}


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _operands(cin, cout, k, side, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, side, side, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    return x, w


def _reorder_bound(x, w, stride, padding):
    """2 g_n (|x| conv |w|) in f64, NCHW."""
    n = w.shape[0] * w.shape[1] * w.shape[2]
    gamma = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
    ax = torch.from_numpy(np.abs(_bf16(x))).double().permute(0, 3, 1, 2)
    aw = torch.from_numpy(np.abs(_bf16(w))).double().permute(3, 2, 0, 1)
    return 2 * gamma * F.conv2d(ax, aw, None, stride, padding).numpy()


def _assert_within(got, ref, bound):
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.float64) - ref)
    assert (diff <= bound).all(), (diff.max(), (diff - bound).max())


def _conv(route, x, w, stride, padding):
    """NHWC x, HWIO w (numpy) -> the port's NCHW f32 result."""
    x = torch.from_numpy(x).permute(0, 3, 1, 2)
    w = torch.from_numpy(w).permute(3, 2, 0, 1)
    if route == "upcast":
        return tresnet._conv_upcast(x.to(torch.bfloat16),
                                    w.to(torch.bfloat16), stride, padding)
    return tresnet.conv2d_f32(x, w, stride, padding, torch.bfloat16)


@pytest.mark.parametrize("route", ["gemm", "upcast"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bf16_conv_keeps_the_f32_sum(kind, route):
    cin, cout, k, stride, padding, side = KINDS[kind]
    x, w = _operands(cin, cout, k, side, seed=len(kind))
    ref = jresnet.conv({"kernel": jnp.asarray(w)}, jnp.asarray(x), stride,
                       padding=[(padding, padding)] * 2,
                       compute_dtype=jnp.bfloat16)
    assert ref.dtype == jnp.float32
    ref = np.asarray(ref, np.float64).transpose(0, 3, 1, 2)
    got = _conv(route, x, w, stride, padding)
    assert got.dtype == torch.float32
    _assert_within(got, ref, _reorder_bound(x, w, stride, padding))


@pytest.mark.parametrize("route", ["gemm", "upcast"])
def test_bf16_vit_patch_embedding_keeps_the_f32_sum(route):
    """The patch step of ``clip.vit_apply`` (stride = kernel, VALID), as
    the JAX package computes it, against the port's ``vit_apply`` route."""
    patch, cin, width, side = 8, 3, 32, 32
    x, w = _operands(cin, width, patch, side, seed=7)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(w).astype(jnp.bfloat16),
        window_strides=(patch, patch), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32)
    ref = np.asarray(ref, np.float64).transpose(0, 3, 1, 2)
    got = _conv(route, x, w, patch, 0)
    _assert_within(got, ref, _reorder_bound(x, w, patch, 0))


def test_f32_conv_is_the_plain_convolution():
    cin, cout, k, stride, padding, side = KINDS["3x3_stride2"]
    x, w = _operands(cin, cout, k, side, seed=3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    for cd in (None, torch.float32):
        assert torch.equal(tresnet.conv2d_f32(xt, wt, stride, padding, cd),
                           F.conv2d(xt, wt, None, stride, padding))
