"""The port's viz modules (viquae_torch/viz, textual copies of
viquae_tpu/viz) against the JAX package's: the cases of tests/test_umap.py
and the viz cases of tests/test_aux.py (wtl_filter, html rendering,
projection and plot, stats), each run through both packages on the same
inputs, the results equal (the reference's own UMAP in numpy, so bit for
bit)."""
import numpy as np
import pytest

from viquae_torch.rankeval import Qrels as TQrels
from viquae_torch.rankeval import Run as TRun
from viquae_torch.viz import html as t_html
from viquae_torch.viz import projection as t_projection
from viquae_torch.viz import stats as t_stats
from viquae_torch.viz import umap as t_umap
from viquae_torch.viz import wtl_filter as t_wtl
from viquae_tpu.rankeval import Qrels as JQrels
from viquae_tpu.rankeval import Run as JRun
from viquae_tpu.viz import html as j_html
from viquae_tpu.viz import projection as j_projection
from viquae_tpu.viz import stats as j_stats
from viquae_tpu.viz import umap as j_umap
from viquae_tpu.viz import wtl_filter as j_wtl


def make_clusters(seed=0, n_per=40, d=32, n_clusters=3, sep=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * sep
    x, labels = [], []
    for c in range(n_clusters):
        x.append(centers[c] + rng.normal(size=(n_per, d)))
        labels += [c] * n_per
    return np.concatenate(x), np.asarray(labels)


# ---- tests/test_umap.py ----------------------------------------------------
def test_smooth_knn_calibration():
    rng = np.random.default_rng(0)
    dists = np.sort(rng.uniform(0.1, 2.0, (50, 15)), axis=1)
    rho, sigma = t_umap.smooth_knn(dists)
    np.testing.assert_array_equal(rho, dists[:, 0])
    psum = np.exp(-np.maximum(dists - rho[:, None], 0) / sigma[:, None]).sum(1)
    np.testing.assert_allclose(psum, np.log2(15), rtol=1e-3)
    ref = j_umap.smooth_knn(dists)
    np.testing.assert_array_equal(rho, ref[0])
    np.testing.assert_array_equal(sigma, ref[1])


def test_fuzzy_graph_symmetric_and_local():
    x, labels = make_clusters(n_per=20)
    heads, tails, w = t_umap.fuzzy_graph(x, n_neighbors=10,
                                         metric="euclidean")
    assert np.all(w > 0) and np.all(w <= 1.0 + 1e-9)
    assert np.mean(labels[heads] == labels[tails]) > 0.95
    for got, ref in zip((heads, tails, w), j_umap.fuzzy_graph(
            x, n_neighbors=10, metric="euclidean")):
        np.testing.assert_array_equal(got, ref)


def test_find_ab_params():
    a, b = t_umap.find_ab_params(0.1)
    assert a == pytest.approx(1.577, rel=0.05)
    assert b == pytest.approx(0.895, rel=0.05)
    assert (a, b) == tuple(j_umap.find_ab_params(0.1))


def test_umap_recovers_clusters():
    x, labels = make_clusters()
    y = t_umap.umap_embed(x, n_neighbors=10, n_epochs=100,
                          metric="euclidean", seed=1)
    assert y.shape == (len(x), 2) and np.all(np.isfinite(y))
    d = ((y[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    assert np.mean(labels[d.argmin(1)] == labels) > 0.9
    np.testing.assert_array_equal(y, j_umap.umap_embed(
        x, n_neighbors=10, n_epochs=100, metric="euclidean", seed=1))


def test_reduce_entry_and_projection_route():
    x, _ = make_clusters(n_per=15)
    y = t_umap.reduce(x, metric="cosine", n_epochs=30)
    assert y.shape == (len(x), 2)
    np.testing.assert_array_equal(
        y, j_umap.reduce(x, metric="cosine", n_epochs=30))
    y3 = t_projection.project(x, method="umap", n_epochs=30)
    assert y3.shape == (len(x), 2)
    np.testing.assert_array_equal(
        y3, j_projection.project(x, method="umap", n_epochs=30))


def test_smooth_knn_duplicate_points():
    dists = np.array([[0.0, 0.5, 1.0, 2.0], [0.3, 0.6, 0.9, 1.2],
                      [0.0, 0.0, 0.0, 0.0]])
    rho, sigma = t_umap.smooth_knn(dists)
    assert (rho[0], rho[1], rho[2]) == (0.5, 0.3, 0.0)
    assert (sigma > 0).all()
    np.testing.assert_array_equal(sigma, j_umap.smooth_knn(dists)[1])


# ---- the viz cases of tests/test_aux.py -------------------------------------
def test_wtl_filter():
    def runs(qrels_cls, run_cls):
        qrels = qrels_cls({"q1": {"d1": 1}, "q2": {"d2": 1},
                           "q3": {"d3": 1}})
        run_a = run_cls({"q1": {"d1": 1.0}, "q2": {"d9": 1.0},
                         "q3": {"d3": 1.0}}, name="A")
        run_b = run_cls({"q1": {"d1": 1.0}, "q2": {"d2": 1.0},
                         "q3": {"d9": 1.0}}, name="B")
        return qrels, run_a, run_b

    expected = {"win": {"q3"}, "loose": {"q1", "q3"},
                "intersection": {"q1"}, "union": {"q1", "q2", "q3"},
                "nunion": set()}
    t_args, j_args = runs(TQrels, TRun), runs(JQrels, JRun)
    for name, ids in expected.items():
        assert t_wtl.select_ids(*t_args, name) == ids
        assert j_wtl.select_ids(*j_args, name) == ids


def test_html_rendering(tmp_path):
    items = [{"id": "q1", "input": "who is this?",
              "output": {"original_answer": "Ada"}, "image": "img1.jpg"}]
    passages = [{"passage": "Ada Lovelace was...", "index": 0}]
    wiki = [{"url": "http://w/Ada", "wikipedia_title": "Ada"}]
    page = t_html.dataset_to_html(
        items, tmp_path / "out.html", passages=passages, wiki=wiki,
        search_run=TRun({"q1": {"0": 2.0, "1": 1.0}}, name="dense"))
    assert "who is this?" in page and "Ada Lovelace" in page
    assert (tmp_path / "out.html").exists()
    assert page == j_html.dataset_to_html(
        items, tmp_path / "ref.html", passages=passages, wiki=wiki,
        search_run=JRun({"q1": {"0": 2.0, "1": 1.0}}, name="dense"))


def test_projection_and_plot(tmp_path):
    rng = np.random.default_rng(0)
    emb = np.concatenate([rng.normal(0, 1, (30, 8)),
                          rng.normal(5, 1, (30, 8))]).astype(np.float32)
    labels = [0] * 30 + [1] * 30
    xy = t_projection.plot_embeddings(emb, labels,
                                      output=str(tmp_path / "plot.png"),
                                      method="pca")
    assert xy.shape == (60, 2) and (tmp_path / "plot.png").exists()
    assert abs(xy[:30, 0].mean() - xy[30:, 0].mean()) > 1.0
    ref = j_projection.plot_embeddings(emb, labels,
                                       output=str(tmp_path / "ref.png"),
                                       method="pca")
    np.testing.assert_array_equal(xy, ref)
    assert (tmp_path / "plot.png").read_bytes() == \
        (tmp_path / "ref.png").read_bytes()


def test_stats():
    data = {"input": ["a b c", "d e", None], "faces": [[1, 2], [], None]}

    class DS(dict):
        column_names = list(data)

        def __len__(self):
            return 3

    out = t_stats.dataset_stats(DS(data), columns=["input", "faces"])
    assert out["n_items"] == 3
    assert out["input"]["coverage"] == pytest.approx(2 / 3)
    assert out["input"]["mean_words"] == pytest.approx(2.5)
    assert out == j_stats.dataset_stats(DS(data), columns=["input", "faces"])
