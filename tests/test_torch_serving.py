"""The whole ported slice: tokenize -> pack -> packed DPR encoder -> fused
exact search, through FusedRetrievalPipeline, against the JAX pipeline on
the same tokenizer, weights, queries and KB."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import bf16_ulp_distance
from viquae_torch.ir.embedding import PackedTextEmbedder as TEmbedder
from viquae_torch.ir.serving import FusedRetrievalPipeline as TFused
from viquae_torch.ir.serving import RetrievalPipeline as TPipeline
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import dpr as tdpr
from viquae_torch.ops import mips as tm
from viquae_tpu.ir.embedding import PackedTextEmbedder as JEmbedder
from viquae_tpu.ir.serving import FusedRetrievalPipeline as JFused
from viquae_tpu.ir.serving import RetrievalPipeline as JPipeline
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.ops import mips as jm

torch.set_num_threads(2)

SMALL = dict(vocab_size=3000, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64, add_pooler=False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from transformers import BertTokenizerFast

    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"w{i}" for i in range(2000)])
    d = tmp_path_factory.mktemp("servetok")
    (d / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(d / "vocab.txt"))
    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(**SMALL))
    tcfg = tdpr.DPRConfig(bert=tbert.BertConfig(**SMALL))
    tree = jax.tree.map(np.asarray, jdpr.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    queries = [
        " ".join(f"w{j}" for j in rng.integers(0, 2000, rng.integers(4, 15)))
        for _ in range(150)
    ]
    kb = rng.normal(size=(5000, 32)).astype(np.float32)
    return tok, jcfg, tcfg, tree, queries, kb


def _port_pipeline(setup, do_l2norm=False, k=10):
    tok, _, tcfg, tree, _, kb = setup
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    emb = TEmbedder(tdpr.make_packed_apply(tcfg), model, tok, row_len=32,
                    batch_size=64, compute_dtype=torch.float32, device="cpu")
    index = tm.DenseIndex(kb, do_l2norm=do_l2norm, mode="fused",
                          device="cpu")
    return TFused(emb, index, batch_size=64, k=k)


def _jax_pipeline(setup, do_l2norm=False, k=10):
    tok, jcfg, _, tree, _, kb = setup
    emb = JEmbedder(jdpr.make_packed_apply(jcfg),
                    jax.tree.map(jnp.asarray, tree), tok, row_len=32,
                    batch_size=64, compute_dtype=jnp.float32)
    index = jm.DenseIndex(kb, do_l2norm=do_l2norm, mode="fused")
    return JFused(emb, index, batch_size=64, k=k)


@pytest.mark.parametrize("do_l2norm", [False, True], ids=["ip", "l2norm"])
def test_fused_pipeline_matches_jax(setup, do_l2norm):
    """f32 encoders on both sides; the search casts the embeddings to bf16.
    The two f32 embeddings differ in the last bits, so a bf16 cast can land
    one ulp apart and swap near-tied KB rows: ids equal on >= 99 % of
    positions, every score within 2 bf16 ulps of the JAX score."""
    queries = setup[4]
    scores, idx = _port_pipeline(setup, do_l2norm).run_arrays(queries)
    ref_s, ref_i = _jax_pipeline(setup, do_l2norm).run_arrays(queries)
    assert scores.shape == idx.shape == (150, 10)
    assert scores.dtype == np.float32 and idx.dtype == np.int64
    assert np.mean(idx == ref_i) >= 0.99
    assert bf16_ulp_distance(scores, ref_s).max() <= 2


def test_run_device_matches_run_arrays(setup):
    queries = setup[4]
    pipe = _port_pipeline(setup)
    scores, idx = pipe.run_arrays(queries)
    batches = pipe.run_device(queries)
    assert [start for start, _, _ in batches] == [0, 64, 128]
    got_i = np.concatenate([
        i[: min(64, len(queries) - start)].numpy()
        for start, _, i in batches])
    got_s = np.concatenate([
        s[: min(64, len(queries) - start)].float().numpy()
        for start, s, _ in batches])
    np.testing.assert_array_equal(got_i, idx)
    np.testing.assert_array_equal(got_s, scores)
    assert batches[0][1].dtype == torch.bfloat16
    assert batches[0][2].dtype == torch.int32


def test_base_pipeline_and_index_search_agree_with_fused(setup):
    """RetrievalPipeline (embed, then DenseIndex.search_batch) returns the
    same ids and scores as the fused pipeline, and the k clamp holds."""
    queries = setup[4]
    fused = _port_pipeline(setup)
    scores, idx = fused.run_arrays(queries)
    base = TPipeline(fused.embed_fn, fused.index, batch_size=64, k=10)
    b_scores, b_idx = base.run_arrays(queries)
    np.testing.assert_array_equal(b_idx, idx)
    np.testing.assert_array_equal(b_scores, scores)
    assert set(base.report()) == {"tokenize+embed_dispatch",
                                  "search_dispatch", "drain_to_host"}
    small = tm.DenseIndex(setup[5][:7], mode="fused", device="cpu")
    s7, i7 = TFused(fused.embed_fn, small, batch_size=64,
                    k=100).run_arrays(queries[:10])
    assert s7.shape == i7.shape == (10, 7)
    assert i7.max() < 7


def test_fused_pipeline_rejects_other_modes(setup):
    class Chunked:
        mode, n = "fast", 10

    with pytest.raises(ValueError, match="single-pass"):
        TFused(None, Chunked())


# ---- global/approx pipelines, Run output and late fusion -----------------
def _embedders(setup, batch_size=64):
    tok, jcfg, tcfg, tree, _, _ = setup
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    t_emb = TEmbedder(tdpr.make_packed_apply(tcfg), model, tok, row_len=32,
                      batch_size=batch_size, compute_dtype=torch.float32,
                      device="cpu")
    j_emb = JEmbedder(jdpr.make_packed_apply(jcfg),
                      jax.tree.map(jnp.asarray, tree), tok, row_len=32,
                      batch_size=batch_size, compute_dtype=jnp.float32)
    return t_emb, j_emb


def _assert_close_rankings(idx, ref_i, scores, ref_s, min_agree=0.999):
    """f32 encoders on both sides differ in the last bits of the
    embeddings (~1e-6), which can swap near-tied KB rows: ids equal on
    >= ``min_agree`` of positions, and where they agree the (bf16 wire)
    scores are within one bf16 ulp."""
    assert np.mean(idx == ref_i) >= min_agree
    same = idx == ref_i
    assert bf16_ulp_distance(scores[same], ref_s[same]).max() <= 1


@pytest.mark.parametrize("mode", ["global", "approx"])
def test_single_pass_pipelines_match_jax(setup, mode):
    """FusedRetrievalPipeline and RetrievalPipeline over an f32 'global' or
    'approx' index, against the JAX pipelines; run() is a Run of the same
    rankings."""
    queries, kb = setup[4], setup[5]
    t_emb, j_emb = _embedders(setup)
    t_index = tm.DenseIndex(kb, mode=mode, device="cpu")
    j_index = jm.DenseIndex(kb, mode=mode)
    fused = TFused(t_emb, t_index, batch_size=64, k=10)
    scores, idx = fused.run_arrays(queries)
    ref_s, ref_i = JFused(j_emb, j_index, batch_size=64,
                          k=10).run_arrays(queries)
    assert scores.shape == idx.shape == (150, 10)
    _assert_close_rankings(idx, ref_i, scores, ref_s)
    # the base pipeline takes search_batch: f32 scores, not the bf16 wire
    base = TPipeline(t_emb, t_index, batch_size=64, k=10)
    b_scores, b_idx = base.run_arrays(queries)
    np.testing.assert_array_equal(b_idx, idx)
    np.testing.assert_array_equal(
        torch.from_numpy(b_scores).to(torch.bfloat16).float().numpy(), scores)
    qids = [f"q{i}" for i in range(len(queries))]
    run = fused.run(qids, queries)
    ref_run = JPipeline(j_emb, j_index, batch_size=64, k=10).run(qids,
                                                                 queries)
    assert list(run.keys()) == qids == list(ref_run.keys())
    assert run.name == ref_run.name == "serving"
    same = sum(list(run[q]) == list(ref_run[q]) for q in qids)
    assert same >= 0.98 * len(qids)
    assert [int(d) for d in run["q0"]] == idx[0].tolist()


def test_fused_pipeline_rejects_chunked_modes(setup):
    t_emb, _ = _embedders(setup)
    for mode in ("fast", "exact"):
        with pytest.raises(ValueError, match="use RetrievalPipeline"):
            TFused(t_emb, tm.DenseIndex(setup[5][:300], mode=mode,
                                        device="cpu"))


def test_global_l2norm_pipeline_scores_match_search_batch(setup):
    """A do_l2norm 'global' index scores cosine in the pipeline too: ids
    equal to search_batch on the same embeddings, scores equal up to the
    bf16 wire format."""
    queries, kb = setup[4][:64], setup[5]
    t_emb, _ = _embedders(setup)
    index = tm.DenseIndex(kb, do_l2norm=True, mode="global", device="cpu")
    scores, idx = TFused(t_emb, index, batch_size=64, k=5).run_arrays(
        queries)
    ref_s, ref_i = index.search_batch(t_emb(queries)[:64], k=5)
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_array_equal(
        scores, torch.from_numpy(ref_s).to(torch.bfloat16).float().numpy())


def test_global_pipeline_k_clamped_to_index_size(setup):
    queries, kb = setup[4][:10], setup[5]
    t_emb, _ = _embedders(setup)
    small = tm.DenseIndex(kb[:7], mode="global", device="cpu")
    s, i = TPipeline(t_emb, small, batch_size=64, k=100).run_arrays(queries)
    s2, i2 = TFused(t_emb, small, batch_size=64, k=100).run_arrays(queries)
    assert s.shape == s2.shape == (10, 7)
    np.testing.assert_array_equal(i, i2)


def test_global_pipeline_sees_rows_added_after_construction(setup):
    """Rows added after the pipeline was built are searched: the count is
    read per batch, not fixed at construction (tests/test_serving.py:674),
    on both growth paths of DenseIndex.add."""
    queries, kb = setup[4], setup[5]
    t_emb, j_emb = _embedders(setup)
    index = tm.DenseIndex(kb[:4990], mode="global", device="cpu")
    j_index = jm.DenseIndex(kb[:4990], mode="global")
    pipe = TFused(t_emb, index, batch_size=64, k=10)
    j_pipe = JFused(j_emb, j_index, batch_size=64, k=10)
    pipe.run_arrays(queries[:64])
    added = 10.0 * t_emb(queries[:3])[:3].numpy()  # dominant rows
    for rows in (added[:1], added[1:]):  # in the padding, then growth
        index.add(rows)
        j_index.add(rows)
    assert index.n == j_index.n == 4993
    scores, idx = pipe.run_arrays(queries)
    ref_s, ref_i = j_pipe.run_arrays(queries)
    assert np.all(idx[:3, 0] >= 4990)
    _assert_close_rankings(idx, ref_i, scores, ref_s, min_agree=0.99)


def _multi_indexes(pkg_mips, kb, rng, dtype, specs, **kwargs):
    out = {}
    for name, d, l2 in specs:
        rows = kb if d is None else rng.normal(size=(kb.shape[0], d)).astype(
            np.float32)
        out[name] = pkg_mips.DenseIndex(rows, do_l2norm=l2, mode="global",
                                        dtype=dtype, **kwargs)
    return out


@pytest.mark.parametrize("case", ["fp32-3way", "nan-rows", "bf16-features"])
def test_multi_index_pipeline_matches_jax(setup, case):
    """Late fusion with precomputed features, against the JAX
    MultiIndexRetrievalPipeline in the cases of tests/test_serving.py:221
    (text + 2 modal f32 indexes, gzmuv), :377 (NaN feature rows = the
    query is absent from that run) and :637 (feature rounding follows the
    index dtype: bf16 indexes get bf16-rounded features, as the JAX
    default compact upload sends them)."""
    from viquae_torch.ir.serving import MultiIndexRetrievalPipeline as TMulti
    from viquae_tpu.ir.serving import MultiIndexRetrievalPipeline as JMulti

    queries, kb = setup[4][:96], setup[5]
    n_q = len(queries)
    batch = 48
    specs = [("dpr", None, False), ("clip", 24, True), ("face", 16, False)]
    weights = {"dpr": 0.5, "clip": 0.3, "face": 0.2}
    t_dtype, j_dtype = torch.float32, jnp.float32
    if case == "bf16-features":
        t_dtype, j_dtype = torch.bfloat16, jnp.bfloat16
    rng = np.random.default_rng(42)
    feats = {"clip": rng.normal(size=(n_q, 24)).astype(np.float32),
             "face": rng.normal(size=(n_q, 16)).astype(np.float32)}
    if case == "nan-rows":
        feats["face"][[5, 17, 60]] = np.nan
    t_emb, j_emb = _embedders(setup, batch_size=batch)
    t_idx = _multi_indexes(tm, kb, np.random.default_rng(7), t_dtype, specs,
                           device="cpu")
    j_idx = _multi_indexes(jm, kb, np.random.default_rng(7), j_dtype, specs)
    pipe = TMulti(t_emb, t_idx, weights, text_index="dpr", batch_size=batch,
                  k=10, norm="gzmuv")
    scores, idx = pipe.run_arrays(queries, feats)
    assert scores.shape == (n_q, 10) and np.isfinite(scores).all()
    assert (idx >= 0).all() and (idx < kb.shape[0]).all()
    for compact in ((True, False) if case == "fp32-3way" else (True,)):
        ref_s, ref_i = JMulti(j_emb, j_idx, weights, text_index="dpr",
                              batch_size=batch, k=10, norm="gzmuv",
                              compact_transfer=compact).run_arrays(queries,
                                                                   feats)
        _assert_close_rankings(idx, ref_i, scores, ref_s, min_agree=0.98)
    run = pipe.run([str(i) for i in range(n_q)], queries, feats)
    assert run.name == "serving-fusion" and len(run) == n_q


def test_multi_index_pipeline_matches_fuse_topk_of_search_device(setup):
    """The pipeline equals fuse_topk over each index's search_device on the
    same embeddings and features, and a NaN row drops the query from that
    index's run."""
    from viquae_torch.ir.serving import MultiIndexRetrievalPipeline as TMulti
    from viquae_torch.ops.fusion import fuse_topk

    queries, kb = setup[4][:40], setup[5]
    rng = np.random.default_rng(3)
    img = rng.normal(size=(40, 12)).astype(np.float32)
    img[[1, 30]] = np.nan
    t_emb, _ = _embedders(setup, batch_size=40)
    indexes = {"dpr": tm.DenseIndex(kb, mode="fused", device="cpu"),
               "img": tm.DenseIndex(rng.normal(size=(kb.shape[0], 12)),
                                    do_l2norm=True, mode="global",
                                    dtype=torch.bfloat16, device="cpu")}
    pipe = TMulti(t_emb, indexes, {"dpr": 0.6, "img": 0.4}, "dpr",
                  batch_size=40, k=8)
    scores, idx = pipe.run_arrays(queries, {"img": img})
    s_t, i_t = indexes["dpr"].search_device(t_emb(queries), *indexes[
        "dpr"].snapshot(), 8)
    q_img = torch.from_numpy(np.nan_to_num(img, nan=0.0)).to(torch.bfloat16)
    s_i, i_i = indexes["img"].search_device(q_img, *indexes[
        "img"].snapshot(), 8)
    ok = torch.from_numpy(np.isfinite(img).all(1))[:, None]
    s_i = torch.where(ok, s_i, tm.NEG_INF)
    i_i = torch.where(ok, i_i, tm.INT32_MAX)
    ref_s, ref_i = fuse_topk([s_t, s_i], [i_t, i_i], (0.6, 0.4), 8,
                             norm="gzmuv", valid_queries=40)
    np.testing.assert_array_equal(idx, ref_i.numpy())
    np.testing.assert_array_equal(
        scores, ref_s.to(torch.bfloat16).float().numpy())


def test_multi_index_pipeline_rejects_bad_inputs(setup):
    from viquae_torch.ir.serving import MultiIndexRetrievalPipeline as TMulti

    kb = setup[5][:500]
    t_emb, _ = _embedders(setup)
    indexes = {"dpr": tm.DenseIndex(kb, mode="global", device="cpu"),
               "clip": tm.DenseIndex(kb[:, :8], mode="global",
                                     device="cpu")}
    weights = {"dpr": 0.5, "clip": 0.5}
    # online legs: only non-text index names, and an index takes one leg
    with pytest.raises(ValueError, match="image_encoders"):
        TMulti(t_emb, indexes, weights, "dpr", image_encoders={"nope": 1})
    with pytest.raises(ValueError, match="image_encoders"):
        TMulti(t_emb, indexes, weights, "dpr", image_encoders={"dpr": 1})
    with pytest.raises(ValueError, match="face_encoders"):
        TMulti(t_emb, indexes, weights, "dpr", image_encoders={"clip": 1},
               face_encoders={"clip": 1})
    online = TMulti(t_emb, indexes, weights, "dpr", image_encoders={"clip": 1})
    assert online.image_encoders == {"clip": 1} and not online.face_encoders
    with pytest.raises(ValueError, match="text_index"):
        TMulti(t_emb, indexes, weights, "nope")
    with pytest.raises(ValueError, match="weights keys"):
        TMulti(t_emb, indexes, {"dpr": 1.0}, "dpr")
    with pytest.raises(ValueError, match="chunked modes"):
        TMulti(t_emb, {**indexes, "x": tm.DenseIndex(kb, device="cpu")},
               {**weights, "x": 0.1}, "dpr")
    pipe = TMulti(t_emb, {**indexes, "small": tm.DenseIndex(
        kb[:6], mode="global", device="cpu")}, {**weights, "small": 0.1},
        "dpr", k=100)
    assert pipe.k == 6
    queries = setup[4][:4]
    with pytest.raises(ValueError, match="missing query_features"):
        pipe.run_arrays(queries, {"clip": np.zeros((4, 8))})
    with pytest.raises(ValueError, match="not index names"):
        pipe.run_arrays(queries, {"clip": np.zeros((4, 8)),
                                  "small": np.zeros((4, 32)),
                                  "bogus": np.zeros((4, 8))})
    with pytest.raises(ValueError, match="rows for"):
        pipe.run_arrays(queries, {"clip": np.zeros((3, 8)),
                                  "small": np.zeros((4, 32))})
