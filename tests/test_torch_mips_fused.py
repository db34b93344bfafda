"""The port's exact search (viquae_torch/ops/mips.py, mips_fused.py) against
the JAX package's Pallas path, run in interpret mode on the CPU. The port
keeps the KB row-major (N, d); the JAX functions get its transpose."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import bf16_ulp_distance
from viquae_torch.ops import mips as tm
from viquae_torch.ops import mips_fused as tmf
from viquae_tpu.ops import mips as jm
from viquae_tpu.ops import mips_pallas as jmp

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _jax_score_segmax(q, kb, valid_rows):
    scores, seg3 = jmp.fused_score_segmax_qmajor(
        jnp.asarray(q), jnp.asarray(kb).T, jnp.int32(valid_rows))
    segmax = jnp.moveaxis(seg3, 0, 1).reshape(q.shape[0], -1)
    return (np.asarray(scores.astype(jnp.float32)),
            np.asarray(segmax.astype(jnp.float32)))


@pytest.mark.parametrize("valid_rows", [1000, 0, 1024, 640])
def test_plain_score_segmax_is_bit_identical_on_integers(valid_rows):
    """Integer inputs in [-4, 4] with d = 64: every f32 sum is exact, so
    both versions must agree bit for bit, -inf columns included."""
    rng = np.random.default_rng(valid_rows)
    q = rng.integers(-4, 5, (37, 64)).astype(np.float32)
    kb = rng.integers(-4, 5, (1024, 64)).astype(np.float32)
    s, m = tmf.fused_score_segmax_qmajor_plain(_t(q), _t(kb), valid_rows)
    assert s.dtype == m.dtype == torch.bfloat16
    assert m.shape == (37, 1024 // 128)
    ref_s, ref_m = _jax_score_segmax(q, kb, valid_rows)
    np.testing.assert_array_equal(s.float().numpy(), ref_s)
    np.testing.assert_array_equal(m.float().numpy(), ref_m)


def test_plain_score_segmax_within_one_ulp_on_gaussian():
    """Gaussian inputs: f32 sums taken in another order may round to the
    neighbouring bf16 value, so at most 1 bf16 ulp apart; each segment max
    is the max of the (rounded) scores of its own version."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(20, 96)).astype(np.float32)
    kb = rng.normal(size=(2048, 96)).astype(np.float32)
    s, m = tmf.fused_score_segmax_qmajor_plain(_t(q), _t(kb), 2000)
    ref_s, ref_m = _jax_score_segmax(q, kb, 2000)
    assert bf16_ulp_distance(s.float().numpy(), ref_s).max() <= 1
    assert bf16_ulp_distance(m.float().numpy(), ref_m).max() <= 1
    np.testing.assert_array_equal(
        m.float().numpy(), s.float().view(20, 16, 128).amax(-1).numpy())


def test_to_kernel_layout_pads_rows_only():
    kb = torch.arange(300 * 8, dtype=torch.float32).view(300, 8)
    out = tmf.to_kernel_layout(kb)
    assert out.shape == (384, 8)
    assert torch.equal(out[:300], kb) and not out[300:].any()
    assert tmf.to_kernel_layout(out).shape == (384, 8)


def _finalize_cases():
    rng = np.random.default_rng(3)
    ties = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0, -np.inf, 2.0],
                     [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    ties_idx = np.array([[70, 9, 4, 11, 3, 2, 1, 5],
                         [7, 6, 5, 4, 3, 2, 1, 0]], np.int32)
    neg = np.full((2, 6), -np.inf, np.float32)
    neg[0, :2] = [1.0, 1.0]
    neg_idx = rng.permutation(12).astype(np.int32).reshape(2, 6)
    return [(ties, ties_idx, 5), (ties, ties_idx, 8), (ties, ties_idx, 11),
            (neg, neg_idx, 4), (neg, neg_idx, 9)]


@pytest.mark.parametrize("case", range(5))
def test_finalize_topk_matches_jax(case):
    """Crafted ties (kept by pool position at the k boundary, then ordered
    by id), -inf lanes (id blanked to INT32_MAX before the order restore)
    and k wider than the pool (padded)."""
    cand, cand_idx, k = _finalize_cases()[case]
    s, i = tm.finalize_topk(torch.tensor(cand), torch.tensor(cand_idx), k)
    ref_s, ref_i = jm.finalize_topk(jnp.asarray(cand), jnp.asarray(cand_idx),
                                    k)
    assert i.dtype == torch.int32 and s.shape == (cand.shape[0], k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def _distinct_bf16_kb(n_rows, dim, perm_seed=1):
    """KB whose scores against an all-ones query are distinct small
    integers (bf16-exact): tests/test_mips.py's fixture."""
    rng = np.random.default_rng(perm_seed)
    weights = rng.permutation(n_rows).astype(np.float32) + 1.0
    kb = np.zeros((n_rows, dim), np.float32)
    kb[np.arange(n_rows), np.arange(n_rows) % dim] = weights
    return kb


def _both_topk(q, kb, k, valid_rows=None, chunks=1):
    s, i = tmf.topk_fused(_t(q), _t(kb), k, valid_rows=valid_rows,
                          chunks=chunks)
    ref_s, ref_i = jmp.topk_fused(
        jnp.asarray(q), jnp.asarray(kb).T, k,
        valid_rows=None if valid_rows is None else jnp.int32(valid_rows),
        chunks=chunks)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    return s.numpy(), i.numpy(), np.asarray(ref_s), np.asarray(ref_i)


def test_topk_fused_exact_integer_scores():
    kb = _distinct_bf16_kb(256, 64)
    q = np.concatenate([np.ones((1, 64), np.float32),
                        2 * np.ones((1, 64), np.float32)])
    padded = np.zeros((512, 64), np.float32)
    padded[:256] = kb
    s, i, ref_s, ref_i = _both_topk(q, padded, 25, valid_rows=256)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(s, ref_s)
    np.testing.assert_array_equal(i, jm.exact_topk_numpy(q, kb, 25)[1])


def test_topk_fused_tie_order_within_topk():
    kb = np.zeros((512, 8), np.float32)
    kb[:, 0] = 0.125
    for r in (3, 130, 259, 388, 500):  # spread across segments
        kb[r] = 0.0
        kb[r, 1] = 2.0
    q = np.zeros((1, 8), np.float32)
    q[0, 1] = 1.0
    s, i, ref_s, ref_i = _both_topk(q, kb, 5)
    np.testing.assert_array_equal(i[0], [3, 130, 259, 388, 500])
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(s, ref_s)


def test_topk_fused_valid_rows_poison():
    kb = _distinct_bf16_kb(200, 64, perm_seed=2)
    padded = np.concatenate([kb, np.full((312, 64), 100.0, np.float32)])
    q = np.ones((9, 64), np.float32)
    s, i, ref_s, ref_i = _both_topk(q, padded, 10, valid_rows=200)
    assert i.max() < 200
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(s, ref_s)


@pytest.mark.parametrize("chunks", [2, 3])
def test_topk_fused_chunked_matches_single(chunks):
    rng = np.random.default_rng(5)
    padded = np.zeros((1024, 64), np.float32)
    winners = rng.choice(900, size=40, replace=False)
    padded[winners, winners % 64] = rng.permutation(40) + 201.0
    padded[900:, 0] = 999.0  # poison beyond valid_rows
    q = np.concatenate([np.ones((3, 64), np.float32),
                        2 * np.ones((2, 64), np.float32)])
    s1, i1, ref_s, ref_i = _both_topk(q, padded, 30, valid_rows=900)
    np.testing.assert_array_equal(i1, ref_i)
    s, i, _, _ = _both_topk(q, padded, 30, valid_rows=900, chunks=chunks)
    assert i.max() < 900
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_array_equal(s, s1)


def test_topk_fused_chunked_ties_across_slabs():
    kb = np.zeros((1024, 8), np.float32)
    for r in (3, 700):
        kb[r, 1] = 2.0
    for r in (200, 900):
        kb[r, 1] = 1.0
    q = np.zeros((1, 8), np.float32)
    q[0, 1] = 1.0
    s, i, ref_s, ref_i = _both_topk(q, kb, 4, chunks=2)
    np.testing.assert_array_equal(i[0], [3, 700, 200, 900])
    np.testing.assert_array_equal(s[0], [2, 2, 1, 1])
    np.testing.assert_array_equal(i, ref_i)


def test_topk_fused_chunked_k_exceeds_slab():
    kb = _distinct_bf16_kb(100, 64, perm_seed=7)
    padded = np.zeros((1024, 64), np.float32)
    padded[:100] = kb
    q = np.ones((2, 64), np.float32)
    s, i, ref_s, ref_i = _both_topk(q, padded, 80, valid_rows=100, chunks=2)
    np.testing.assert_array_equal(i, jm.exact_topk_numpy(q, kb, 80)[1])
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(s, ref_s)


def test_topk_fused_k_exceeds_valid_rows_pads():
    kb = _distinct_bf16_kb(20, 16, perm_seed=9)
    padded = np.zeros((512, 16), np.float32)
    padded[:20] = kb
    q = np.ones((3, 16), np.float32)
    s, i, ref_s, ref_i = _both_topk(q, padded, 30, valid_rows=20)
    assert (i[:, 20:] == tm.INT32_MAX).all() and np.isinf(s[:, 20:]).all()
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(s, ref_s)


@pytest.mark.parametrize("do_l2norm", [False, True], ids=["ip", "l2norm"])
def test_dense_index_fused_matches_jax(do_l2norm):
    """search_batch on the fused index: ids equal to the JAX index except
    where bf16 rounding of the (f32-normalized) inputs differs by an ulp
    and swaps near-ties; scores within 1 bf16 ulp."""
    rng = np.random.default_rng(11)
    kb = rng.normal(size=(1000, 48)).astype(np.float32)
    q = rng.normal(size=(40, 48)).astype(np.float32)
    index = tm.DenseIndex(kb, do_l2norm=do_l2norm, mode="fused",
                          device="cpu")
    ref_index = jm.DenseIndex(kb, do_l2norm=do_l2norm, mode="fused")
    assert index.matrix.shape == (1024, 48) and index.n == 1000
    s, i = index.search_batch(q, k=10)
    ref_s, ref_i = ref_index.search_batch(q, k=10)
    assert s.shape == (40, 10) and s.dtype == np.float32
    assert np.mean(i == ref_i) >= 0.99
    assert bf16_ulp_distance(s, ref_s).max() <= 1
    if not do_l2norm:
        np.testing.assert_array_equal(i, ref_i)
    # device tensors in, device tensors out with sync=False
    s2, i2 = index.search_batch(torch.tensor(q), k=10, sync=False)
    assert isinstance(s2, torch.Tensor)
    np.testing.assert_array_equal(i2.numpy(), i)


def test_dense_index_clamps_k_and_rejects_unported_modes():
    """Every mode clamps k to the row count; an unknown mode is refused."""
    kb = np.random.default_rng(0).normal(size=(7, 16)).astype(np.float32)
    for mode in ("fused", "fast", "exact", "global", "approx"):
        s, i = tm.DenseIndex(kb, mode=mode, device="cpu").search_batch(
            kb[:3], k=100)
        assert s.shape == i.shape == (3, 7), mode
        np.testing.assert_array_equal(i[:, 0], [0, 1, 2])  # self-hit
    with pytest.raises(ValueError, match="unknown top-k mode"):
        tm.DenseIndex(kb, mode="streaming", device="cpu")


def test_wrapper_uses_plain_version_for_cpu_tensors_only():
    q, kb = _t(np.ones((2, 8))), _t(np.ones((128, 8)))
    before = tmf.fused_score_segmax_qmajor.launches
    s, m = tmf.fused_score_segmax_qmajor(q, kb, 100)
    ref_s, ref_m = tmf.fused_score_segmax_qmajor_plain(q, kb, 100)
    assert torch.equal(s, ref_s) and torch.equal(m, ref_m)
    assert tmf.fused_score_segmax_qmajor.launches == before  # no kernel ran
