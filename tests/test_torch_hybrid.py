"""HybridRetrievalPipeline of the port (BM25 on the host or the device +
dense, fused on the device) on the CPU: the cases of tests/test_serving.py
(:414 host fusion, :482 device BM25 backend, :522 raw interpolation with
the two constructor errors), then the port against the JAX pipeline on the
same tokenizer, weights, queries, KB and corpus, with ``compact_transfer``
both ways; and ``compact_transfer`` on the fused and multi-index pipelines.

Tolerances. Against the host fusion and the closed form: the reference's
own (fused scores by doc id within 2e-2 absolute/relative, the bf16 wire
format; rank equivalence within 0.05). Port against JAX: ids equal on
>= 98 % of positions and, where they are equal, scores within one bf16 ulp
(f32 encoders differ in their last bits on the two sides, which can swap
near-tied rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import bf16_ulp_distance
from viquae_torch.ir.embedding import PackedTextEmbedder as TEmbedder
from viquae_torch.ir.serving import FusedRetrievalPipeline as TFused
from viquae_torch.ir.serving import HybridRetrievalPipeline as THybrid
from viquae_torch.ir.serving import MultiIndexRetrievalPipeline as TMulti
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import dpr as tdpr
from viquae_torch.ops import bm25 as tbm25
from viquae_torch.ops import mips as tm
from viquae_torch.ops.bm25_device import DeviceBM25 as TDeviceBM25
from viquae_tpu.ir.embedding import PackedTextEmbedder as JEmbedder
from viquae_tpu.ir.serving import HybridRetrievalPipeline as JHybrid
from viquae_tpu.ir.serving import MultiIndexRetrievalPipeline as JMulti
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.ops import bm25 as jbm25
from viquae_tpu.ops import mips as jm
from viquae_tpu.ops.bm25_device import DeviceBM25 as JDeviceBM25

torch.set_num_threads(2)

SMALL = dict(vocab_size=3000, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64, add_pooler=False)
PAD = np.iinfo(np.int32).max
DEV_KW = dict(n_head=8, l_small=32, pool_mid=8, pool_small=32, q_block=16)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from transformers import BertTokenizerFast

    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"w{i}" for i in range(2000)])
    d = tmp_path_factory.mktemp("hybridtok")
    (d / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(d / "vocab.txt"))
    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(**SMALL))
    tcfg = tdpr.DPRConfig(bert=tbert.BertConfig(**SMALL))
    tree = jax.tree.map(np.asarray, jdpr.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    # queries share the corpus' 60-term vocabulary so both legs retrieve
    queries = [
        " ".join(f"w{j}" for j in rng.integers(0, 60, rng.integers(4, 15)))
        for _ in range(64)
    ]
    kb = rng.normal(size=(400, 32)).astype(np.float32)
    return tok, jcfg, tcfg, tree, queries, kb


def _mini_corpus(rng, n_docs=400, n_terms=60):
    return [
        " ".join(f"w{j}"
                 for j in rng.integers(0, n_terms, rng.integers(20, 60)))
        for _ in range(n_docs)
    ]


def _embedders(setup, batch_size):
    tok, jcfg, tcfg, tree, _, _ = setup
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    t_emb = TEmbedder(tdpr.make_packed_apply(tcfg), model, tok, row_len=32,
                      batch_size=batch_size, compute_dtype=torch.float32,
                      device="cpu")
    j_emb = JEmbedder(jdpr.make_packed_apply(jcfg),
                      jax.tree.map(jnp.asarray, tree), tok, row_len=32,
                      batch_size=batch_size, compute_dtype=jnp.float32)
    return t_emb, j_emb


def _by_doc(idx_row, score_row):
    return {int(d): float(s) for d, s in zip(idx_row, score_row) if d != PAD}


def _assert_close_rankings(idx, ref_i, scores, ref_s, min_agree=0.98):
    assert np.mean(idx == ref_i) >= min_agree
    same = idx == ref_i
    assert bf16_ulp_distance(scores[same], ref_s[same]).max() <= 1


# ---- tests/test_serving.py:414 --------------------------------------------
def test_hybrid_pipeline_matches_host_fusion(setup):
    """Dense on the device + BM25 through the host scorer, fused with
    gzmuv + default minimum on the device, equals the host pipeline:
    per-leg runs -> default_minimum -> normalize gzmuv -> wsum."""
    from viquae_torch.rankeval import Run, default_minimum, fuse

    queries, kb = setup[4][:48], setup[5][:40]
    texts = _mini_corpus(np.random.default_rng(5), n_docs=40)
    bm25 = tbm25.BM25Index.build(texts, k1=0.5, b=0.3)
    t_emb, _ = _embedders(setup, 64)
    index = tm.DenseIndex(kb, mode="global", dtype=torch.float32,
                          device="cpu")
    # ONE batch so gzmuv's batch-as-run statistics match the host run
    pipe = THybrid(t_emb, index, bm25, weights=(0.7, 0.3), batch_size=64,
                   k=10, k_bm25=10, compact_transfer=False)
    scores, idx = pipe.run_arrays(queries)
    assert set(pipe.report()) == {"tokenize+pack+dense_dispatch",
                                  "bm25_host", "fuse_dispatch",
                                  "drain_to_host"}

    q_emb = t_emb(queries)[: len(queries)].numpy()
    full = q_emb @ kb.T
    d_idx = np.argsort(-full, axis=1, kind="stable")[:, :10]
    d_scores = np.take_along_axis(full, d_idx, axis=1)
    q_ids = [str(i) for i in range(len(queries))]
    dense_run = {q: {str(d): float(s) for s, d in zip(d_scores[i], d_idx[i])}
                 for i, q in enumerate(q_ids)}
    b_scores, b_idx = bm25.search_batch(queries, k=10)
    bm25_run = {q: {str(d): float(s) for s, d in zip(b_scores[i], b_idx[i])}
                for i, q in enumerate(q_ids)}
    runs = default_minimum([Run(dense_run, name="dense"),
                            Run(bm25_run, name="bm25")])
    fused = fuse(runs, norm="gzmuv", method="wsum",
                 params={"weights": [0.7, 0.3]})
    for i, q in enumerate(q_ids):
        got = _by_doc(idx[i], scores[i])
        assert got
        for d, s in got.items():
            np.testing.assert_allclose(s, fused[q][str(d)], rtol=2e-2,
                                       atol=2e-2)
        want = sorted(fused[q].items(), key=lambda kv: (-kv[1], int(kv[0])))
        kth = want[min(len(got), len(want)) - 1][1]
        assert all(fused[q][str(d)] >= kth - 0.05 for d in got), i


# ---- tests/test_serving.py:482 --------------------------------------------
def test_hybrid_pipeline_accepts_device_bm25(setup):
    """DeviceBM25 duck-types BM25Index (search_batch + n_docs) and drops in
    as the sparse leg; the pipeline then takes the bm25_device branch."""
    queries, kb = setup[4][:16], setup[5][:200]
    texts = _mini_corpus(np.random.default_rng(7), n_docs=200)
    host = tbm25.BM25Index.build(texts, k1=0.5, b=0.3)
    dev = TDeviceBM25(host, device="cpu", **DEV_KW)
    t_emb, _ = _embedders(setup, 16)
    index = tm.DenseIndex(kb, mode="global", dtype=torch.float32,
                          device="cpu")
    kw = dict(weights=(0.7, 0.3), batch_size=16, k=10, k_bm25=10,
              compact_transfer=False)
    pipe_d = THybrid(t_emb, index, dev, **kw)
    pipe_h = THybrid(t_emb, index, host, **kw)
    s_d, i_d = pipe_d.run_arrays(queries)
    s_h, i_h = pipe_h.run_arrays(queries)
    assert "bm25_device" in pipe_d.report()
    assert "bm25_host" not in pipe_d.report()
    for q in range(len(queries)):
        got, want = _by_doc(i_d[q], s_d[q]), _by_doc(i_h[q], s_h[q])
        shared = set(got) & set(want)
        assert len(shared) >= max(1, int(0.7 * len(want))), (q, got, want)
        for d in shared:
            np.testing.assert_allclose(got[d], want[d], rtol=5e-2,
                                       atol=5e-2)


# ---- tests/test_serving.py:522 --------------------------------------------
def test_hybrid_pipeline_raw_interpolation(setup):
    """norm='raw' + fixed stats: fused(d) = w_d*(s_d-m_d)/sd_d +
    w_b*(s_b-m_b)/sd_b, absent legs contribute 0."""
    queries, kb = setup[4][:32], setup[5][:300]
    texts = _mini_corpus(np.random.default_rng(6), n_docs=300)
    bm25 = tbm25.BM25Index.build(texts, k1=0.5, b=0.3)
    t_emb, _ = _embedders(setup, 32)
    index = tm.DenseIndex(kb, mode="global", dtype=torch.float32,
                          device="cpu")
    stats = ((0.5, 2.0), (20.1111, 5.85003))
    pipe = THybrid(t_emb, index, bm25, weights=(0.7, 0.3), batch_size=32,
                   k=8, k_bm25=8, norm="raw", stats=stats,
                   compact_transfer=False)
    scores, idx = pipe.run_arrays(queries)
    d_scores, d_idx = TFused(t_emb, index, batch_size=32, k=8,
                             compact_transfer=False).run_arrays(queries)
    b_scores, b_idx = bm25.search_batch(queries, k=8)
    for i in range(len(queries)):
        expect = {}
        for s, d in zip(d_scores[i], d_idx[i]):
            expect[int(d)] = expect.get(int(d), 0.0) + 0.7 * (s - 0.5) / 2.0
        for s, d in zip(b_scores[i], b_idx[i]):
            expect[int(d)] = (expect.get(int(d), 0.0)
                              + 0.3 * (s - 20.1111) / 5.85003)
        got = _by_doc(idx[i], scores[i])
        for d, s in got.items():
            np.testing.assert_allclose(s, expect[d], rtol=2e-2, atol=2e-2)
        want = sorted(expect.items(), key=lambda kv: (-kv[1], kv[0]))
        kth = want[min(len(got), len(want)) - 1][1]
        assert all(expect[d] >= kth - 0.05 for d in got), i


@pytest.mark.parametrize("kwargs, match", [
    (dict(norm="raw"), "norm='raw'"),
    (dict(norm="gzmuv", stats=((0.5, 2.0), (20.0, 5.0))), "legacy"),
], ids=["raw-without-stats", "stats-without-raw"])
def test_hybrid_constructor_errors(setup, kwargs, match):
    t_emb, _ = _embedders(setup, 32)
    index = tm.DenseIndex(setup[5][:50], mode="global", device="cpu")
    bm25 = tbm25.BM25Index.build(_mini_corpus(np.random.default_rng(1), 50))
    with pytest.raises(ValueError, match=match):
        THybrid(t_emb, index, bm25, batch_size=32, k=8, **kwargs)


def test_hybrid_k_bm25_is_clamped_and_chunked_modes_are_refused(setup):
    t_emb, _ = _embedders(setup, 32)
    bm25 = tbm25.BM25Index.build(_mini_corpus(np.random.default_rng(1), 7))
    index = tm.DenseIndex(setup[5][:50], mode="global", device="cpu")
    pipe = THybrid(t_emb, index, bm25, batch_size=32, k=20, k_bm25=100)
    assert pipe.k == 20 and pipe.k_bm25 == 7
    assert THybrid(t_emb, index, bm25, batch_size=32, k=20).k_bm25 == 7
    s, i = pipe.run_arrays(setup[4][:5])
    assert s.shape == i.shape == (5, 20)
    with pytest.raises(ValueError, match="use RetrievalPipeline"):
        THybrid(t_emb, tm.DenseIndex(setup[5][:50], mode="fast",
                                     device="cpu"), bm25)


# ---- the port against the JAX pipeline -----------------------------------
@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "not-compact"])
@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("norm", ["gzmuv", "raw"])
def test_hybrid_run_arrays_match_jax(setup, norm, backend, compact):
    """Two batches (40 + 24 queries), one of them partial."""
    queries, kb = setup[4], setup[5]
    texts = _mini_corpus(np.random.default_rng(9), n_docs=len(kb))
    t_host = tbm25.BM25Index.build(texts, k1=0.5, b=0.3)
    j_host = jbm25.BM25Index.build(texts, k1=0.5, b=0.3)
    t_bm25, j_bm25 = t_host, j_host
    if backend == "device":
        t_bm25 = TDeviceBM25(t_host, device="cpu", **DEV_KW)
        j_bm25 = JDeviceBM25(j_host, **DEV_KW)
    t_emb, j_emb = _embedders(setup, 40)
    kw = dict(weights=(0.7, 0.3), batch_size=40, k=10, k_bm25=12, norm=norm,
              compact_transfer=compact)
    if norm == "raw":
        kw["stats"] = ((0.5, 2.0), (20.1111, 5.85003))
    scores, idx = THybrid(
        t_emb, tm.DenseIndex(kb, mode="global", dtype=torch.float32,
                             device="cpu"), t_bm25, **kw).run_arrays(queries)
    ref_s, ref_i = JHybrid(
        j_emb, jm.DenseIndex(kb, mode="global", dtype=jnp.float32), j_bm25,
        **kw).run_arrays(queries)
    assert scores.shape == idx.shape == (64, 10)
    assert scores.dtype == np.float32 and idx.dtype == np.int64
    _assert_close_rankings(idx, ref_i, scores, ref_s)


@pytest.mark.parametrize("n_queries", [24, 10], ids=["slice", "pad"])
def test_device_rows_are_cut_or_padded_to_batch_size(setup, n_queries):
    """q_block 16 does not divide batch_size 24: 24 queries come back as 32
    rows and are cut, 10 come back as 16 and are padded with -inf /
    INT32_MAX; either way the result equals the host-scorer branch up to
    the device scorer's bf16 weights."""
    queries, kb = setup[4][:n_queries], setup[5][:200]
    texts = _mini_corpus(np.random.default_rng(7), n_docs=200)
    host = tbm25.BM25Index.build(texts, k1=0.5, b=0.3)
    dev = TDeviceBM25(host, device="cpu", **DEV_KW)
    t_emb, j_emb = _embedders(setup, 24)
    index = tm.DenseIndex(kb, mode="global", dtype=torch.float32,
                          device="cpu")
    kw = dict(weights=(0.7, 0.3), batch_size=24, k=10, k_bm25=10)
    s_d, i_d = THybrid(t_emb, index, dev, **kw).run_arrays(queries)
    assert s_d.shape == (n_queries, 10)
    j_dev = JDeviceBM25(jbm25.BM25Index.build(texts, k1=0.5, b=0.3),
                        **DEV_KW)
    ref_s, ref_i = JHybrid(
        j_emb, jm.DenseIndex(kb, mode="global", dtype=jnp.float32), j_dev,
        **kw).run_arrays(queries)
    _assert_close_rankings(i_d, ref_i, s_d, ref_s)


def test_hybrid_over_the_fused_index_matches_its_legs(setup):
    """Over a 'fused' bf16 index (kernel B1's path; its plain version on
    the CPU): the result equals fuse_topk of the two legs run apart."""
    from viquae_torch.ops.fusion import fuse_topk

    queries, kb = setup[4][:30], setup[5]
    texts = _mini_corpus(np.random.default_rng(3), n_docs=len(kb))
    dev = TDeviceBM25(tbm25.BM25Index.build(texts, k1=0.5, b=0.3),
                      device="cpu", **DEV_KW)
    t_emb, _ = _embedders(setup, 32)
    index = tm.DenseIndex(kb, mode="fused", device="cpu")
    scores, idx = THybrid(t_emb, index, dev, batch_size=32, k=10,
                          k_bm25=15).run_arrays(queries)
    d_s, d_i = index.search_device(t_emb(queries), *index.snapshot(), 10)
    b_s, b_i = dev.search_batch_device(queries, k=15)
    ref_s, ref_i = fuse_topk((d_s, b_s[:32]), (d_i, b_i[:32]), (0.7, 0.3),
                             10, norm="gzmuv", valid_queries=30)
    np.testing.assert_array_equal(idx, ref_i[:30].numpy())
    np.testing.assert_array_equal(
        scores, ref_s[:30].to(torch.bfloat16).float().numpy())


# ---- compact_transfer on the other pipelines (a call written for the
# reference must not raise, and the feature dtype follows it) --------------
@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "not-compact"])
def test_fused_pipeline_accepts_compact_transfer(setup, compact):
    queries, kb = setup[4], setup[5]
    t_emb, _ = _embedders(setup, 64)
    index = tm.DenseIndex(kb, mode="global", device="cpu")
    s, i = TFused(t_emb, index, batch_size=64, k=5,
                  compact_transfer=compact).run_arrays(queries)
    s0, i0 = TFused(t_emb, index, batch_size=64, k=5).run_arrays(queries)
    np.testing.assert_array_equal(i, i0)
    np.testing.assert_array_equal(s, s0)


@pytest.mark.parametrize("compact", [True, False],
                         ids=["compact", "not-compact"])
def test_multi_index_feature_dtype_follows_compact_transfer(setup, compact):
    """A bf16 L2-normalised index: with compact_transfer the features are
    rounded to bf16 and then normalised, without it they are normalised in
    f32 and then rounded. Each way equals the JAX pipeline the same way."""
    queries, kb = setup[4], setup[5]
    rng = np.random.default_rng(11)
    kb_img = rng.normal(size=(len(kb), 24)).astype(np.float32)
    feats = {"img": rng.normal(size=(len(queries), 24)).astype(np.float32)}
    t_emb, j_emb = _embedders(setup, 64)
    weights = {"dpr": 0.6, "img": 0.4}
    t_idx = {"dpr": tm.DenseIndex(kb, mode="global", dtype=torch.bfloat16,
                                  device="cpu"),
             "img": tm.DenseIndex(kb_img, do_l2norm=True, mode="global",
                                  dtype=torch.bfloat16, device="cpu")}
    j_idx = {"dpr": jm.DenseIndex(kb, mode="global", dtype=jnp.bfloat16),
             "img": jm.DenseIndex(kb_img, do_l2norm=True, mode="global",
                                  dtype=jnp.bfloat16)}
    pipe = TMulti(t_emb, t_idx, weights, "dpr", batch_size=64, k=10,
                  compact_transfer=compact)
    got = pipe._features("img", feats["img"], 0, 64)
    assert got.dtype == (torch.bfloat16 if compact else torch.float32)
    scores, idx = pipe.run_arrays(queries, feats)
    ref_s, ref_i = JMulti(j_emb, j_idx, weights, "dpr", batch_size=64, k=10,
                          compact_transfer=compact).run_arrays(queries, feats)
    _assert_close_rankings(idx, ref_i, scores, ref_s)


def test_compact_transfer_changes_the_rounding_point(setup):
    """The two settings are different computations: on a bf16 L2norm index
    the query that reaches the product differs in some element."""
    rng = np.random.default_rng(11)
    feats = rng.normal(size=(64, 24)).astype(np.float32)
    t_emb, _ = _embedders(setup, 64)
    idx = {"dpr": tm.DenseIndex(setup[5], mode="global", device="cpu"),
           "img": tm.DenseIndex(rng.normal(size=(400, 24)), do_l2norm=True,
                                mode="global", dtype=torch.bfloat16,
                                device="cpu")}
    out = []
    for compact in (True, False):
        pipe = TMulti(t_emb, idx, {"dpr": 0.5, "img": 0.5}, "dpr",
                      batch_size=64, k=5, compact_transfer=compact)
        q = idx["img"]._queries(pipe._features("img", feats, 0, 64))
        out.append(q.to(torch.bfloat16).float())
    assert not torch.equal(out[0], out[1])
