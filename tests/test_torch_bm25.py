"""The port's host BM25 (viquae_torch/ops/bm25.py + native/bm25_scorer.cpp)
and the grid search over it (ir/hp.py): bitwise the JAX package's scores,
ids and tie order on every scoring path, interchangeable index files, the
same best hyperparameters."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import viquae_torch.native as t_native
import viquae_tpu.native as j_native
from viquae_torch.ir import hp as t_hp
from viquae_torch.ops import bm25 as t_bm25
from viquae_torch.rankeval import Qrels as TQrels
from viquae_tpu.ir import hp as j_hp
from viquae_tpu.ops import bm25 as j_bm25
from viquae_tpu.rankeval import Qrels as JQrels

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CSR_FIELDS = ("offsets", "docs", "tfs", "doc_len", "idf", "norm", "term_ub")


def _fuzz_corpus(seed, n_docs=400, vocab=50):
    """A Zipf corpus whose second half repeats the first (exact score
    ties), with queries that include an empty and an unknown one."""
    rng = np.random.default_rng(seed)
    docs = [
        " ".join(f"w{(int(z) - 1) % vocab}"
                 for z in rng.zipf(1.3, rng.integers(10, 60)))
        for _ in range(n_docs // 2)]
    queries = [
        " ".join(f"w{(int(z) - 1) % vocab}" for z in rng.zipf(1.3, 6))
        for _ in range(16)] + ["", "zzz unknown", "W3, w3; w4!"]
    return docs + docs, queries, int(rng.integers(3, 60))


def _assert_bitwise(ours, ref):
    (scores, ids), (ref_scores, ref_ids) = ours, ref
    assert ids == ref_ids
    assert len(scores) == len(ref_scores)
    for a, b in zip(scores, ref_scores):
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))


def test_scorer_source_is_byte_identical_copy():
    assert ((ROOT / "viquae_torch/native/bm25_scorer.cpp").read_bytes()
            == (ROOT / "viquae_tpu/native/bm25_scorer.cpp").read_bytes())


def test_native_scorers_build():
    for name in ("load_bm25_scorer", "load_bm25_maxscore",
                 "load_bm25_maxscore_mt"):
        assert getattr(t_native, name)() is not None, (
            f"g++ compile of the port's native scorer failed: {name}")


@pytest.mark.parametrize("seed", range(3))
def test_index_build_matches_jax(seed):
    docs, _, _ = _fuzz_corpus(seed)
    ours = t_bm25.BM25Index.build(docs, k1=0.5, b=0.3)
    ref = j_bm25.BM25Index.build(docs, k1=0.5, b=0.3)
    assert ours.vocab == ref.vocab and ours.n_docs == ref.n_docs
    for field in CSR_FIELDS:
        a, b = getattr(ours, field), getattr(ref, field)
        np.testing.assert_array_equal(a, b, err_msg=field)
        assert a.dtype == b.dtype, field
    assert t_bm25.analyze("The Quick-brown fox's 2nd jump!") == \
        j_bm25.analyze("The Quick-brown fox's 2nd jump!")


@pytest.mark.parametrize("path", ["python", "native", "maxscore",
                                  "maxscore_mt", "search_batch"])
@pytest.mark.parametrize("seed", range(3))
def test_search_is_bitwise_the_jax_search(seed, path):
    docs, queries, k = _fuzz_corpus(seed)
    ours = t_bm25.BM25Index.build(docs, k1=0.5, b=0.3)
    ref = j_bm25.BM25Index.build(docs, k1=0.5, b=0.3)
    if path == "python":
        pairs = [(ours.search(q, k=k), ref.search(q, k=k)) for q in queries]
        got = tuple(map(list, zip(*(p[0] for p in pairs))))
        want = tuple(map(list, zip(*(p[1] for p in pairs))))
    elif path == "search_batch":   # the public entry: MaxScore, threaded
        got = ours.search_batch(queries, k=k, n_threads=3)
        want = ref.search_batch(queries, k=k, n_threads=3)
    else:
        loader, kw = {
            "native": ("load_bm25_scorer", {}),
            "maxscore": ("load_bm25_maxscore", dict(maxscore=True)),
            "maxscore_mt": ("load_bm25_maxscore_mt",
                            dict(maxscore=True, n_threads=4)),
        }[path]
        fn_t, fn_j = getattr(t_native, loader)(), getattr(j_native, loader)()
        assert fn_t is not None and fn_j is not None
        got = ours._search_batch_native(fn_t, queries, k, **kw)
        want = ref._search_batch_native(fn_j, queries, k, **kw)
    _assert_bitwise(got, want)
    assert got[1][-3] == [] and got[1][-2] == []   # empty, unknown
    assert got[1][-1]                               # analyzed to w3 w3 w4
    # every path of the port agrees with its own python path on the ids
    for q, ids in zip(queries, got[1]):
        assert ids == ours.search(q, k=k)[1]


def test_python_fallback_without_native(monkeypatch):
    docs, queries, k = _fuzz_corpus(4)
    ours = t_bm25.BM25Index.build(docs)
    native = ours.search_batch(queries, k=k)
    monkeypatch.setenv("VIQUAE_NO_NATIVE", "1")
    assert t_native.load_bm25_scorer() is None
    fallback = ours.search_batch(queries, k=k)
    assert fallback[1] == native[1]
    for a, b in zip(fallback[0], native[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_retune_matches_jax_and_refreshes_the_bounds():
    docs, queries, k = _fuzz_corpus(5)
    ours = t_bm25.BM25Index.build(docs, k1=1.2, b=0.75)
    ref = j_bm25.BM25Index.build(docs, k1=1.2, b=0.75)
    before = ours.term_ub.copy()
    for index in (ours, ref):
        index.set_hyperparameters(k1=0.5, b=0.3)
    assert not np.array_equal(before, ours.term_ub)
    np.testing.assert_array_equal(ours.term_ub, ref.term_ub)
    _assert_bitwise(ours.search_batch(queries, k=k),
                    ref.search_batch(queries, k=k))


def test_save_load_files_are_interchangeable(tmp_path):
    docs, queries, k = _fuzz_corpus(6)
    ours = t_bm25.BM25Index.build(docs, k1=0.9, b=0.4)
    ref = j_bm25.BM25Index.build(docs, k1=0.9, b=0.4)
    ours.save(tmp_path / "port")
    ref.save(tmp_path / "jax")
    from_jax = t_bm25.BM25Index.load(tmp_path / "jax")
    from_port = j_bm25.BM25Index.load(tmp_path / "port")
    assert (from_jax.k1, from_jax.b) == (from_port.k1, from_port.b) == (
        0.9, 0.4)
    want = ref.search_batch(queries, k=k)
    _assert_bitwise(from_jax.search_batch(queries, k=k), want)
    _assert_bitwise(from_port.search_batch(queries, k=k), want)
    _assert_bitwise(t_bm25.BM25Index.load(tmp_path / "port").search_batch(
        queries, k=k), want)


def test_empty_index_and_tie_break():
    empty = t_bm25.BM25Index.build([])
    assert empty.search("anything", k=5) == ([], [])
    assert empty.search_batch(["a", "b"], k=3) == ([[], []], [[], []])
    ties = t_bm25.BM25Index.build(["apple pie", "apple pie", "banana"])
    assert ties.search("apple", k=2)[1] == [0, 1]
    assert ties.search_batch(["apple"], k=2)[1] == [[0, 1]]


def test_synth_zipf_index_matches_jax():
    kwargs = dict(n_docs=300, vocab_size=200, mean_len=20, seed=3)
    ours = t_bm25.synth_zipf_index(**kwargs)
    ref = j_bm25.synth_zipf_index(**kwargs)
    for field in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(ours, field),
                                      getattr(ref, field), err_msg=field)
    assert ours.vocab == ref.vocab


def _objectives(seed=0):
    """BM25Objective of each package over one corpus: document d answers
    the query made of three of its own words."""
    rng = np.random.default_rng(seed)
    docs = [" ".join(f"w{j}" for j in rng.integers(0, 60, rng.integers(
        5, 40))) for _ in range(120)]
    queries, qrels = {}, {}
    for q in range(25):
        words = docs[q].split()
        queries[f"q{q}"] = " ".join(rng.choice(words, 3))
        qrels[f"q{q}"] = {str(q): 1}
    ours = t_hp.BM25Objective(t_bm25.BM25Index.build(docs), queries,
                              TQrels(qrels), k=10, metric="mrr@10")
    ref = j_hp.BM25Objective(j_bm25.BM25Index.build(docs), queries,
                             JQrels(qrels), k=10, metric="mrr@10")
    return ours, ref


def test_grid_search_gives_the_jax_best_parameters(tmp_path):
    grid = {"b": [0.0, 0.3, 0.75, 1.0], "k1": [0.0, 0.5, 1.2, 2.0]}
    ours, ref = _objectives()
    got = t_hp.hyperparameter_search(
        ours, grid, storage=str(tmp_path / "port" / "trials.json"),
        test_objective=lambda p: {"again": ours(p)})
    want = j_hp.hyperparameter_search(
        ref, grid, storage=str(tmp_path / "jax" / "trials.json"),
        test_objective=lambda p: {"again": ref(p)})
    assert got == want
    assert got["test_metrics"]["again"] == got["best_value"]
    assert len(got["trials"]) == 16
    assert len(set(got["trials"].values())) > 1   # the grid matters
    assert (json.loads((tmp_path / "port" / "trials.json").read_text())
            == json.loads((tmp_path / "jax" / "trials.json").read_text()))
    # resumed from storage: no trial is computed again
    resumed = t_hp.GridSearch(grid, storage=str(
        tmp_path / "port" / "trials.json")).run(
            lambda p: pytest.fail("a stored trial was run again"))
    assert resumed["best_params"] == got["best_params"]
    assert t_hp.DEFAULT_BM25_GRID == j_hp.DEFAULT_BM25_GRID


def test_grid_search_all_nan_raises():
    with pytest.raises(ValueError, match="no finite objective"):
        t_hp.GridSearch({"b": [0.1, 0.2]}).run(lambda p: float("nan"))
