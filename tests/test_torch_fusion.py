"""Device late fusion in the port (viquae_torch/ops/fusion.py fuse_topk)
against the JAX fuse_topk and the port's host pipeline default_minimum ->
normalize_run -> fuse(wsum), in the cases of tests/test_fusion_device.py.

Tolerances: fused scores within 1e-5 absolute of the JAX ones (the f32 sums
of the statistics and of each doc's contributions are reduced in another
order than XLA's; fused scores are O(1), so this is ~20 f32 ulps); ids equal
except where two fused scores lie within that tolerance of each other.
Against the host pipeline (float64) the JAX test's 2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.ops.fusion import fuse_topk
from viquae_torch.rankeval import Run, default_minimum, fuse, normalize_run
from viquae_tpu.ops import fusion as jfusion

torch.set_num_threads(2)

INT_MAX = np.iinfo(np.int32).max
TOL = 1e-5


def _make_runs(seed=0, n_q=9, ks=(7, 5, 6), n_docs=50):
    rng = np.random.default_rng(seed)
    scores_list, idx_list = [], []
    for k in ks:
        ids = np.stack([rng.choice(n_docs, size=k, replace=False)
                        for _ in range(n_q)]).astype(np.int32)
        scores = rng.normal(size=(n_q, k)).astype(np.float32) * 3 + 1
        order = np.argsort(-scores, axis=1)
        scores_list.append(np.take_along_axis(scores, order, axis=1))
        idx_list.append(np.take_along_axis(ids, order, axis=1))
    return scores_list, idx_list


def _both(scores_list, idx_list, weights, k, norm, valid_queries=None):
    s, i = fuse_topk([torch.from_numpy(x) for x in scores_list],
                     [torch.from_numpy(x) for x in idx_list], weights, k,
                     norm=norm, valid_queries=valid_queries)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    ref_s, ref_i = jfusion.fuse_topk(
        tuple(jnp.asarray(x) for x in scores_list),
        tuple(jnp.asarray(x) for x in idx_list), tuple(weights), k,
        norm=norm,
        valid_queries=None if valid_queries is None
        else jnp.int32(valid_queries))
    return s.numpy(), i.numpy(), np.asarray(ref_s), np.asarray(ref_i)


def assert_fused_close(s, i, ref_s, ref_i, tol=TOL):
    """Scores within ``tol`` position by position; where ids differ, the
    port's id sits in the reference row at a score within ``tol``."""
    finite = np.isfinite(ref_s)
    np.testing.assert_array_equal(np.isfinite(s), finite)
    np.testing.assert_allclose(s[finite], ref_s[finite], rtol=0, atol=tol)
    for r, c in zip(*np.nonzero(i != ref_i)):
        hit = np.nonzero(ref_i[r] == i[r, c])[0]
        assert hit.size and abs(ref_s[r, hit[0]] - ref_s[r, c]) <= tol, (r, c)


def _host_fuse(scores_list, idx_list, weights, norm):
    runs = []
    for r, (scores, ids) in enumerate(zip(scores_list, idx_list)):
        runs.append(Run({
            str(q): {str(int(d)): float(v) for d, v in zip(ids[q], scores[q])
                     if d != INT_MAX}
            for q in range(scores.shape[0])}, name=f"run{r}"))
    runs = [normalize_run(r, norm) for r in default_minimum(runs)]
    return fuse(runs, norm=None, method="wsum",
                params={"weights": list(weights)})


@pytest.mark.parametrize("norm", ["gzmuv", "zmuv", "min-max", None])
@pytest.mark.parametrize("seed", [0, 7, 21])
def test_fuse_topk_matches_jax_and_host_pipeline(norm, seed):
    scores_list, idx_list = _make_runs(seed=seed)
    weights = (0.5, 0.3, 0.2)
    s, i, ref_s, ref_i = _both(scores_list, idx_list, weights, 10, norm)
    assert_fused_close(s, i, ref_s, ref_i)
    host = _host_fuse(scores_list, idx_list, weights, norm)
    for q in range(scores_list[0].shape[0]):
        items = sorted(host[str(q)].items(),
                       key=lambda kv: (-kv[1], int(kv[0])))[:10]
        np.testing.assert_array_equal(i[q][: len(items)],
                                      [int(d) for d, _ in items])
        np.testing.assert_allclose(s[q][: len(items)],
                                   [v for _, v in items], rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("norm", ["gzmuv", "zmuv", "min-max", "raw", None])
def test_fuse_topk_valid_queries_and_empty_rows(norm):
    """Rows >= valid_queries are padding (left out of gzmuv's statistics);
    a query absent from one index (all its lanes padded, like a faceless
    query against the face index) contributes nothing there."""
    scores_list, idx_list = _make_runs(seed=11, n_q=12)
    scores_list[2][4] = -np.inf
    idx_list[2][4] = INT_MAX
    scores_list[0][9:] *= 50.0  # garbage in the padding rows
    s, i, ref_s, ref_i = _both(scores_list, idx_list, (0.3, 0.2, 0.2), 8,
                               norm, valid_queries=9)
    assert_fused_close(s, i, ref_s, ref_i)
    full = _both(scores_list, idx_list, (0.3, 0.2, 0.2), 8, norm)
    if norm == "gzmuv":  # the garbage rows would move the statistics
        assert not np.allclose(s[:9], full[0][:9])
    else:  # per-query norms ignore other rows
        np.testing.assert_array_equal(s[:9], full[0][:9])


def test_fuse_topk_padded_entries_ignored():
    scores_list, idx_list = _make_runs(seed=3)
    idx_list[1][:, -2:] = INT_MAX
    scores_list[1][:, -2:] = -np.inf
    s, i, ref_s, ref_i = _both(scores_list, idx_list, (0.4, 0.4, 0.2), 8,
                               "gzmuv")
    assert (i != INT_MAX).all() and np.isfinite(s).all()
    assert_fused_close(s, i, ref_s, ref_i)


def test_fuse_topk_k_exceeds_union():
    scores_list, idx_list = _make_runs(seed=5, n_q=4, ks=(3, 3), n_docs=8)
    s, i, ref_s, ref_i = _both(scores_list, idx_list, (0.6, 0.4), 20, "zmuv")
    assert s.shape == (4, 20)
    for q in range(4):
        n_real = len(set(idx_list[0][q]) | set(idx_list[1][q]))
        assert np.isfinite(s[q][:n_real]).all()
        assert (i[q][n_real:] == INT_MAX).all()
        assert (s[q][n_real:] == -np.inf).all()
    assert_fused_close(s, i, ref_s, ref_i)


def test_fuse_topk_single_index_is_rerank_identity():
    scores = np.sort(np.random.default_rng(1).normal(size=(5, 9)),
                     axis=1)[:, ::-1].astype(np.float32)
    ids = np.argsort(np.random.default_rng(2).normal(size=(5, 9)),
                     axis=1).astype(np.int32) + 100
    s, i, ref_s, ref_i = _both([scores], [ids], (2.0,), 9, None)
    np.testing.assert_allclose(s, 2.0 * scores, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i, ids)
    assert_fused_close(s, i, ref_s, ref_i)


def test_fuse_topk_rejects_bad_arguments():
    scores_list, idx_list = _make_runs()
    ts = [torch.from_numpy(x) for x in scores_list]
    ti = [torch.from_numpy(x) for x in idx_list]
    with pytest.raises(ValueError, match="lengths differ"):
        fuse_topk(ts, ti, (1.0,), 5)
    with pytest.raises(ValueError, match="unknown device-fusion norm"):
        fuse_topk(ts, ti, (1.0, 1.0, 1.0), 5, norm="rank")
