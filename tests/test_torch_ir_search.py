"""The retrieval runtime (viquae_torch/ir/search.py, ir/metrics.py,
ir/fuse.py) against the JAX package's on the same KB and query batch: the
same runs (ids equal, scores within 1e-5), qrels, metrics and files. The
engines that are not ported refuse by name; the device BM25 scorer is built
behind the BM25 seam."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.ir import metrics as t_metrics
from viquae_torch.ir import search as t_search
from viquae_torch.ops import bm25 as t_bm25
from viquae_torch.ops import mips as t_mips
from viquae_tpu.ir import metrics as j_metrics
from viquae_tpu.ir import search as j_search

torch.set_num_threads(2)

SCORE_TOL = dict(atol=1e-5, rtol=1e-5)


class DictDataset:
    """Minimal stand-in for an HF dataset (column + int indexing)."""

    def __init__(self, columns):
        self.columns = columns
        self.column_names = list(columns)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.columns[key]
        return {c: v[key] for c, v in self.columns.items()}

    def remove_columns(self, cols):
        return DictDataset(
            {c: v for c, v in self.columns.items() if c not in cols})

    def __len__(self):
        return len(next(iter(self.columns.values())))


@pytest.fixture
def setup():
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((50, 16)).astype(np.float32)
    passages = [f"passage about entity{i} with answer{i} inside"
                for i in range(50)]
    kb = DictDataset({"embedding": list(vectors), "passage": passages})
    q_vec = vectors[:10] + 0.01 * np.random.default_rng(1).standard_normal(
        (10, 16)).astype(np.float32)
    batch = {
        "id": [f"q{i}" for i in range(10)],
        "dense_query": [q_vec[i] for i in range(10)],
        "text_query": [f"tell me about entity{i}" for i in range(10)],
        "output": [{"original_answer": f"answer{i}",
                    "answer": [f"answer{i}"]} for i in range(10)],
    }
    return kb, batch


def _dense(port, **extra):
    """index_kwargs of an f32 dense index, in each package's own dtype."""
    return dict(column="embedding", key="dense_query", chunk_size=512,
                dtype=torch.float32 if port else jnp.float32, **extra)


def _both(batch, kb_kwargs, tmp_path=None, **kw):
    """dataset_search through the port (on the CPU) and through the JAX
    package; ``kb_kwargs(port)`` builds each side's KB description."""
    out = []
    for port, module in ((True, t_search), (False, j_search)):
        save = None if tmp_path is None else (
            tmp_path / ("port" if port else "jax"))
        batch_copy = {k: list(v) for k, v in batch.items()}
        extra = dict(device="cpu") if port else {}
        out.append(module.dataset_search(
            batch_copy, metric_save_path=save, kb_kwargs=kb_kwargs(port),
            **extra, **kw))
    return out


def _assert_same(ours, ref):
    (report, runs, qrels), (ref_report, ref_runs, ref_qrels) = ours, ref
    assert runs.keys() == ref_runs.keys()
    for name in runs:
        a, b = runs[name].to_dict(), ref_runs[name].to_dict()
        assert a.keys() == b.keys(), name
        for q in a:
            assert list(a[q]) == list(b[q]), (name, q)
            np.testing.assert_allclose(list(a[q].values()),
                                       list(b[q].values()), **SCORE_TOL)
    assert qrels.to_dict() == ref_qrels.to_dict()
    assert report.scores.keys() == ref_report.scores.keys()
    for name in report.scores:
        assert report.scores[name] == pytest.approx(ref_report.scores[name])


@pytest.mark.parametrize("text,expected", [
    ("the sky is blue", ([0], [0, 1])),
    ("bluebird is a bird", ([], [1])),   # 'blue' must match as a whole word
])
def test_find_relevant_matches_jax(text, expected):
    kb = [{"passage": text}, {"passage": "grass is green"}]
    ours = t_metrics.find_relevant([0, 1], "Blue", ["green!"], kb)
    assert ours == j_metrics.find_relevant([0, 1], "Blue", ["green!"], kb)
    assert ours == expected


def test_searcher_end_to_end_matches_jax(setup, tmp_path):
    kb, batch = setup
    ours, ref = _both(
        batch, lambda port: {"kb0": dict(kb_path=kb, index_kwargs={
            "dense": _dense(port)})},
        tmp_path=tmp_path, k=5, reference_kb_path=kb, do_fusion=False)
    _assert_same(ours, ref)
    report, _, qrels = ours
    assert report.scores["dense"]["precision@1"] == 1.0
    assert report.scores["dense"]["mrr@100"] == 1.0
    assert qrels["q0"]["0"] == 1
    for name in ("dense.json", "qrels.json", "qnonrels.json",
                 "metrics.json", "metrics.md"):
        assert (tmp_path / "port" / name).exists(), name
    for name in ("qrels.json", "qnonrels.json"):
        assert (json.loads((tmp_path / "port" / name).read_text())
                == json.loads((tmp_path / "jax" / name).read_text()))
    assert ((tmp_path / "port" / "metrics.md").read_text()
            == (tmp_path / "jax" / "metrics.md").read_text())


def test_searcher_over_a_datasets_dataset_matches_plain_columns(setup):
    """A real ``datasets.Dataset`` as KB, reference KB and query set gives
    the runs of plain columns."""
    from datasets import Dataset

    kb, batch = setup
    hf_kb = Dataset.from_dict({"embedding": [v.tolist() for v in
                                             kb["embedding"]],
                               "passage": kb["passage"]})
    hf_queries = Dataset.from_dict({
        "id": batch["id"],
        "dense_query": [v.tolist() for v in batch["dense_query"]],
        "output": batch["output"]})
    kwargs = dict(k=5, do_fusion=False, device="cpu")
    from_hf = t_search.dataset_search(
        hf_queries, reference_kb_path=hf_kb,
        kb_kwargs={"kb0": dict(kb_path=hf_kb, index_kwargs={
            "dense": _dense(True)})}, **kwargs)
    plain = t_search.dataset_search(
        dict(batch), reference_kb_path=kb,
        kb_kwargs={"kb0": dict(kb_path=kb, index_kwargs={
            "dense": _dense(True)})}, **kwargs)
    _assert_same(from_hf, plain)


def test_searcher_none_queries_match_jax(setup):
    kb, batch = setup
    batch["dense_query"][3] = None
    batch["dense_query"][6] = np.full(16, np.nan, np.float32)
    ours, ref = _both(
        batch, lambda port: {"kb0": dict(kb_path=kb, index_kwargs={
            "dense": _dense(port)})},
        k=5, reference_kb_path=kb, do_fusion=False)
    _assert_same(ours, ref)
    report, runs, _ = ours
    assert runs["dense"].to_dict().get("q3", {}) == {}
    assert runs["dense"].to_dict().get("q6", {}) == {}
    assert report.scores["dense"]["precision@1"] == pytest.approx(0.8)


@pytest.mark.parametrize("many2one", [None, "max"],
                         ids=["one2many", "many2one_max"])
def test_index_mapping_matches_jax(setup, tmp_path, many2one):
    kb, batch = setup
    if many2one is None:   # article -> its two passages, 1e-8 rank penalty
        mapping = {i: [2 * i, 2 * i + 1] for i in range(50)}
        reference = DictDataset({"passage": [
            f"text with answer{i // 2} inside" for i in range(100)]})
    else:                  # passage -> its article, the best score kept
        mapping = {i: [i // 2] for i in range(50)}
        reference = DictDataset({"passage": [
            f"article with answer{i} inside" for i in range(25)]})
    mpath = tmp_path / "mapping.json"
    mpath.write_text(json.dumps(mapping))
    ours, ref = _both(
        batch, lambda port: {"kb0": dict(
            kb_path=kb, index_mapping_path=str(mpath), many2one=many2one,
            index_kwargs={"dense": _dense(port)})},
        k=6, reference_kb_path=reference, do_fusion=False)
    _assert_same(ours, ref)
    run_q0 = ours[1]["dense"]["q0"]
    if many2one is None:
        assert run_q0["0"] - run_q0["1"] == pytest.approx(1e-8)
    else:
        assert len(run_q0) <= 6


def test_stale_index_mapping_raises(setup, tmp_path):
    kb, batch = setup
    mpath = tmp_path / "mapping.json"
    mpath.write_text(json.dumps({i: [i] for i in range(5)}))
    with pytest.raises(KeyError, match="index_mapping"):
        t_search.dataset_search(
            dict(batch), k=5, reference_kb_path=kb, do_fusion=False,
            device="cpu", kb_kwargs={"kb0": dict(
                kb_path=kb, index_mapping_path=str(mpath),
                index_kwargs={"dense": _dense(True)})})


def test_hybrid_dense_plus_bm25_and_fusion_fit_match_jax(setup, tmp_path):
    kb, batch = setup
    ours, ref = _both(
        batch, lambda port: {"kb0": dict(kb_path=kb, index_kwargs={
            "dense": _dense(port),
            "bm25": dict(column="passage", key="text_query", kind="BM25"),
        })},
        tmp_path=tmp_path, k=5, reference_kb_path=kb,
        fusion_kwargs={"subcommand": "fit", "norm": "min-max"})
    _assert_same(ours, ref)
    assert ours[0].scores["bm25"]["precision@1"] == 1.0
    best = tmp_path / "port" / "min-max_wsum_best_params.json"
    assert best.exists()
    assert (json.loads(best.read_text()) == json.loads(
        (tmp_path / "jax" / "min-max_wsum_best_params.json").read_text()))


def test_legacy_normalization_and_weight_match_jax(setup):
    """``normalization`` + ``interpolation_weight`` (the reference's ES
    interpolation) reach the runs as w * (s - mean) / std."""
    kb, batch = setup
    legacy = dict(normalization={"method": "normalize", "mean": 2.0,
                                 "std": 4.0}, interpolation_weight=0.25)
    ours, ref = _both(
        batch, lambda port: {"kb0": dict(kb_path=kb, index_kwargs={
            "dense": _dense(port, **legacy)})},
        k=5, reference_kb_path=kb, do_fusion=False)
    _assert_same(ours, ref)
    raw = t_search.dataset_search(
        dict(batch), k=5, reference_kb_path=kb, do_fusion=False,
        device="cpu", kb_kwargs={"kb0": dict(kb_path=kb, index_kwargs={
            "dense": _dense(True)})})
    for q, scores in raw[1]["dense"].to_dict().items():
        np.testing.assert_allclose(
            list(ours[1]["dense"][q].values()),
            [0.25 * (s - 2.0) / 4.0 for s in scores.values()], rtol=1e-5)
    with pytest.raises(ValueError, match="normalization method"):
        t_search.Index("x", normalization={"method": "softmax"})


def _write_qrels(tmp_path, qrels):
    path = tmp_path / "qrels.json"
    path.write_text(json.dumps(qrels))
    return path


def _searchers(tmp_path, qrels, **kw):
    kb_kwargs = kw.pop("kb_kwargs")
    path = str(_write_qrels(tmp_path, qrels))
    return (t_search.Searcher(kb_kwargs=kb_kwargs(True), qrels=path,
                              device="cpu", **kw),
            j_search.Searcher(kb_kwargs=kb_kwargs(False), qrels=path, **kw))


def test_qrels_only_mode_without_output_column_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(20, 8)).astype(np.float32)
    with pytest.warns(UserWarning, match="No reference KB"):
        ours, ref = _searchers(
            tmp_path, {"0": {"1": 1}}, k=5, reference_kb_path=None,
            kb_kwargs=lambda port: {"kb": dict(
                kb_path={"emb": emb.tolist()},
                index_kwargs={"dense": dict(
                    column="emb", key="emb", chunk_size=64,
                    dtype=torch.float32 if port else jnp.float32)})})
    for searcher in (ours, ref):
        searcher({"id": ["0", "1"], "emb": emb[:2].tolist()})
    assert len(ours.runs["dense"]) == 2
    for q in ("0", "1"):
        assert list(ours.runs["dense"][q]) == list(ref.runs["dense"][q])
    assert ours.qrels == ref.qrels == {"0": {"1": 1}}


def test_integer_ids_are_stringified_as_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(10, 4)).astype(np.float32)
    passages = [f"fact{i}" for i in range(10)]
    ours, ref = _searchers(
        tmp_path, {"0": {"9": 1}}, k=3,
        reference_kb_path=[{"passage": t} for t in passages],
        kb_kwargs=lambda port: {"kb": dict(
            kb_path={"emb": emb.tolist(), "passage": passages},
            index_kwargs={"dense": dict(
                column="emb", key="emb", chunk_size=64,
                dtype=torch.float32 if port else jnp.float32)})})
    batch = {
        "id": [0, 1],
        "emb": emb[:2].tolist(),
        "output": [{"original_answer": "fact0", "answer": ["fact0"]},
                   {"original_answer": "fact1", "answer": ["fact1"]}],
    }
    for searcher in (ours, ref):
        searcher(dict(batch))
    assert set(ours.runs["dense"]) == {"0", "1"}
    assert ours.qrels == ref.qrels
    assert ours.qnonrels == ref.qnonrels
    assert ours.qrels["0"].get("9") == 1


def test_streaming_index_through_kb_seam_matches_jax(setup):
    kb, batch = setup
    ours, ref = _both(
        batch, lambda port: {"kb0": dict(kb_path=kb, index_kwargs={
            "dense": dict(column="embedding", key="dense_query",
                          streaming=True, chunk_rows=16,
                          dtype=torch.float32 if port else jnp.float32)})},
        k=5, reference_kb_path=kb, do_fusion=False)
    _assert_same(ours, ref)
    assert ours[0].scores["dense"]["precision@1"] == 1.0
    kbase = t_search.KnowledgeBase(kb, device="cpu", index_kwargs={
        "dense": dict(column="embedding", streaming=True, chunk_rows=16)})
    assert isinstance(kbase.indexes["dense"].backend,
                      t_mips.StreamingDenseIndex)
    with pytest.raises(ValueError, match="load_path/save_path"):
        t_search.KnowledgeBase(kb, device="cpu", index_kwargs={
            "dense": dict(column="embedding", streaming=True,
                          save_path="somewhere")})


def test_dense_and_bm25_indexes_save_and_load(setup, tmp_path):
    kb, batch = setup
    first = t_search.KnowledgeBase(kb, device="cpu", index_kwargs={
        "dense": dict(column="embedding", string_factory="L2norm,Flat",
                      save_path=str(tmp_path / "dense")),
        "bm25": dict(column="passage", kind="ES",
                     save_path=str(tmp_path / "bm25.npz"))})
    assert first.indexes["dense"].do_L2norm
    assert isinstance(first.indexes["bm25"].backend, t_bm25.BM25Index)
    assert first.indexes["bm25"].kind is t_search.IndexKind.BM25
    again = t_search.KnowledgeBase(kb, device="cpu", index_kwargs={
        "dense": dict(column="embedding", load_path=str(tmp_path / "dense")),
        "bm25": dict(column="passage", kind="BM25",
                     load_path=str(tmp_path / "bm25.npz"))})
    assert again.indexes["dense"].do_L2norm
    queries = np.stack(batch["dense_query"])
    for name, q in (("dense", queries), ("bm25", batch["text_query"])):
        a = first.search_batch(name, q, k=4)
        b = again.search_batch(name, q, k=4)
        assert a[1] == b[1]
        for x, y in zip(a[0], b[0]):
            np.testing.assert_allclose(x, y, **SCORE_TOL)


@pytest.mark.parametrize("index_kwargs,item", [
    (dict(column="embedding", string_factory="IVF64,Flat"), "A17"),
    (dict(column="embedding", string_factory="L2norm,IVF16,Flat"), "A17"),
    (dict(column="passage", kind="BM25", device="sharded"), "A17"),
])
def test_engines_that_are_not_ported_refuse_by_name(setup, index_kwargs,
                                                    item):
    """No other engine is put in the place of the one the config names."""
    kb, _ = setup
    with pytest.raises(NotImplementedError, match=item):
        t_search.KnowledgeBase(kb, device="cpu",
                               index_kwargs={"index": index_kwargs})


DEVICE_KWARGS = dict(n_head=8, l_small=32, l_mid=64, pool_mid=40,
                     pool_small=24, q_block=4)


def test_bm25_device_flag_builds_a_device_scorer_and_matches_jax(setup):
    """IndexKind.BM25 with device=True builds a DeviceBM25 behind the seam
    (tests/test_bm25_device.py:182), every device tunable reaches it, and
    the runs through both packages' seams agree."""
    from viquae_torch.ops.bm25_device import DeviceBM25
    from viquae_tpu.ops.bm25_device import DeviceBM25 as JDeviceBM25

    kb, batch = setup
    kwargs = dict(column="passage", kind="BM25", k1=0.5, b=0.3, device=True,
                  **DEVICE_KWARGS)
    ours = t_search.KnowledgeBase(kb, device="cpu",
                                  index_kwargs={"sparse": dict(kwargs)})
    ref = j_search.KnowledgeBase(kb, index_kwargs={"sparse": dict(kwargs)})
    backend = ours.indexes["sparse"].backend
    assert isinstance(backend, DeviceBM25)
    assert isinstance(ref.indexes["sparse"].backend, JDeviceBM25)
    assert backend.device == torch.device("cpu")
    assert (backend.l_mid_cfg, backend.n_head, backend.q_block,
            backend.pool_mid, backend.pool_small, backend.l_small_cfg) == (
        64, 8, 4, 40, 24, 32)
    scores, ids = ours.search_batch("sparse", batch["text_query"], k=5)
    ref_scores, ref_ids = ref.search_batch("sparse", batch["text_query"],
                                           k=5)
    assert all(ids), "non-empty retrieval through the seam"
    assert ids == ref_ids
    for a, b in zip(scores, ref_scores):
        np.testing.assert_allclose(a, b, **SCORE_TOL)


@pytest.mark.parametrize("how", ["build", "load"])
def test_bm25_device_kwargs_with_device_false_reach_no_host_index(
        setup, tmp_path, how):
    """A config that carries the device scorer's tunables with
    ``device: false`` serves from the host index on both sides: the keys
    are taken out before BM25Index.build / .load sees them."""
    kb, batch = setup
    kwargs = dict(column="passage", kind="BM25", k1=0.5, b=0.3, device=False,
                  **DEVICE_KWARGS)
    if how == "load":
        t_bm25.BM25Index.build(kb["passage"]).save(tmp_path / "bm25")
        kwargs["load_path"] = str(tmp_path / "bm25")
    ours = t_search.KnowledgeBase(kb, device="cpu",
                                  index_kwargs={"sparse": dict(kwargs)})
    ref = j_search.KnowledgeBase(kb, index_kwargs={"sparse": dict(kwargs)})
    assert isinstance(ours.indexes["sparse"].backend, t_bm25.BM25Index)
    a = ours.search_batch("sparse", batch["text_query"], k=5)
    b = ref.search_batch("sparse", batch["text_query"], k=5)
    assert a[1] == b[1] and all(a[1])
    for x, y in zip(a[0], b[0]):
        np.testing.assert_allclose(x, y, **SCORE_TOL)


def test_knowledge_base_needs_a_gpu_unless_cpu_is_named(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    kb, _ = setup
    with pytest.raises(RuntimeError):
        t_search.KnowledgeBase(kb, index_kwargs={
            "dense": dict(column="embedding")})
    with pytest.raises(RuntimeError):
        t_search.Searcher(kb_kwargs={"kb0": dict(kb_path=kb, index_kwargs={
            "dense": dict(column="embedding")})}, reference_kb_path=kb)
