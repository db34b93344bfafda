"""Kernel B2 (kb-major score + segment max) and topk_pallas in the port
(viquae_torch/ops/mips_fused.py) against the JAX package's Pallas kernel,
run in interpret mode on the CPU, and its topk_pallas, in the cases of
tests/test_mips_pallas.py.

Tolerances: f32 scores and maxima within 2e-5 (tests/test_mips_pallas.py's
own tolerance: the two f32 sums of a product are taken in different
orders). On integer-valued inputs every f32 sum is exact, so bf16 and f32
results are bit-identical, ties included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.ops import mips_fused as tmf
from viquae_tpu.ops import mips as jm
from viquae_tpu.ops import mips_pallas as jmp

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    kb = rng.standard_normal((4096, 64)).astype(np.float32)
    queries = rng.standard_normal((16, 64)).astype(np.float32)
    return queries, kb


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _jax_b2(q, kb, dtype=jnp.float32):
    s, m = jmp.fused_score_segmax(jnp.asarray(q, dtype),
                                  jnp.asarray(kb, dtype), tile=1024)
    return np.asarray(s.astype(jnp.float32)), np.asarray(m)


def test_plain_b2_matches_jax_f32():
    rng = np.random.default_rng(1)
    kb = rng.standard_normal((4096, 64)).astype(np.float32)
    q = rng.standard_normal((16, 64)).astype(np.float32)
    s, m = tmf.fused_score_segmax_plain(_t(q), _t(kb))
    assert s.shape == (4096, 16) and s.dtype == torch.float32
    assert m.shape == (32, 16) and m.dtype == torch.float32
    ref_s, ref_m = _jax_b2(q, kb)
    np.testing.assert_allclose(s.numpy(), ref_s, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(m.numpy(), ref_m, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_b2_bit_identical_on_integers(dtype):
    """Integers in [-30, 30], d = 16: the f32 sums are exact but reach
    14,400, past bf16's 8-bit mantissa, so the bf16 scores are rounded
    while the maxima are not — both rounding points are checked bit for
    bit against the Pallas kernel."""
    rng = np.random.default_rng(2)
    kb = rng.integers(-30, 31, (2048, 16)).astype(np.float32)
    q = rng.integers(-30, 31, (24, 16)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    s, m = tmf.fused_score_segmax_plain(_t(q, tdt), _t(kb, tdt))
    assert s.dtype == tdt and m.dtype == torch.float32
    ref_s, ref_m = _jax_b2(q, kb, jdt)
    np.testing.assert_array_equal(s.float().numpy(), ref_s)
    np.testing.assert_array_equal(m.numpy(), ref_m)
    exact = kb @ q.T
    np.testing.assert_array_equal(m.numpy(),
                                  exact.reshape(16, 128, 24).max(1))
    if dtype == "bfloat16":
        # the maxima are of the UNROUNDED sums, not of the stored scores
        rounded_max = s.float().view(16, 128, 24).amax(1).numpy()
        assert (rounded_max != m.numpy()).any()


def test_wrapper_uses_plain_version_for_cpu_tensors_only():
    q, kb = _t(np.ones((3, 8))), _t(np.ones((256, 8)))
    before = tmf.fused_score_segmax.launches
    s, m = tmf.fused_score_segmax(q, kb)
    ref_s, ref_m = tmf.fused_score_segmax_plain(q, kb)
    assert torch.equal(s, ref_s) and torch.equal(m, ref_m)
    assert tmf.fused_score_segmax.launches == before  # no kernel ran


def _both_topk(q, kb, k, valid_rows=None, dtype="float32"):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    s, i = tmf.topk_pallas(_t(q, tdt), _t(kb, tdt), k, valid_rows=valid_rows)
    ref_s, ref_i = jmp.topk_pallas(
        jnp.asarray(q, jdt), jnp.asarray(kb, jdt), k,
        valid_rows=None if valid_rows is None else jnp.int32(valid_rows))
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy(), np.asarray(ref_s), np.asarray(ref_i)


def test_topk_pallas_matches_exact(data):
    q, kb = data
    s, i, ref_s, ref_i = _both_topk(q, kb, 20)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(i, jm.exact_topk_numpy(q, kb, 20)[1])
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-5)


def test_topk_pallas_valid_rows(data):
    q, kb = data
    padded = np.concatenate([kb, 100 * np.ones((100, 64), np.float32)])
    s, i, ref_s, ref_i = _both_topk(q, padded, 10, valid_rows=len(kb))
    assert i.max() < len(kb)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(i, jm.exact_topk_numpy(q, kb, 10)[1])
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-5)


def test_topk_pallas_unaligned_default_masks_padding():
    """valid_rows=None masks the internal padding: every true score is
    negative, and a zero pad row would score 0.0."""
    rng = np.random.default_rng(0)
    kb = -np.abs(rng.standard_normal((1500, 32))).astype(np.float32)
    q = np.abs(rng.standard_normal((8, 32))).astype(np.float32)
    s, i, ref_s, ref_i = _both_topk(q, kb, 10)
    assert i.max() < 1500
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(i, jm.exact_topk_numpy(q, kb, 10)[1])
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-5)


def test_topk_pallas_k_exceeds_n_pads():
    rng = np.random.default_rng(1)
    kb = rng.standard_normal((100, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    s, i, ref_s, ref_i = _both_topk(q, kb, 300)
    assert s.shape == (4, 300)
    assert (i[:, :100] < 100).all() and (i[:, 100:] == 2 ** 31 - 1).all()
    assert np.isneginf(s[:, 100:]).all()
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("q_count", [1, 7, 641, 700])
def test_topk_pallas_any_query_count(q_count):
    """The port pads no queries (the reference pads to its 640-query
    block); the results are the same."""
    rng = np.random.default_rng(2)
    kb = rng.standard_normal((2048, 16)).astype(np.float32)
    q = rng.standard_normal((q_count, 16)).astype(np.float32)
    s, i, ref_s, ref_i = _both_topk(q, kb, 5)
    assert s.shape == (q_count, 5)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-5)


def test_topk_pallas_partial_boundary_segment():
    """valid_rows cutting mid-segment with high-scoring invalid rows: the
    boundary segment's max is recomputed over the valid rows."""
    rng = np.random.default_rng(0)
    n, d, nv = 4096, 16, 4032
    kb = rng.standard_normal((n, d)).astype(np.float32)
    kb[nv:] *= 100.0
    q = rng.standard_normal((8, d)).astype(np.float32)
    s, i, ref_s, ref_i = _both_topk(q, kb, 10, valid_rows=nv)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(i, jm.exact_topk_numpy(q, kb[:nv], 10)[1])
    np.testing.assert_allclose(s, ref_s, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("valid_rows", [None, 900, 1000, 640])
def test_topk_pallas_bf16_mixed_maxima_bit_identical(valid_rows):
    """bf16 with sums past bf16's mantissa: the boundary segment's max comes
    from the ROUNDED scores, every other segment's from the unrounded f32
    sums, and candidates are the rounded scores. Integer inputs make both
    packages compute the same sums, so ids and scores are bit-identical,
    ties at the k-th value included."""
    rng = np.random.default_rng(3)
    kb = rng.integers(-30, 31, (1000, 16)).astype(np.float32)
    q = rng.integers(-30, 31, (5, 16)).astype(np.float32)
    s, i, ref_s, ref_i = _both_topk(q, kb, 25, valid_rows=valid_rows,
                                    dtype="bfloat16")
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(s, ref_s)
    assert i.max() < (valid_rows or 1000)
