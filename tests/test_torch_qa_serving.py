"""The answer path (viquae_torch/ir/qa_serving.AnswerPipeline: retrieve ->
Multi-passage BERT reader -> answer strings) against the JAX pipeline on
the same tokenizer, weights, KB and questions: equal answers and passage
ids, scores within 1e-5. Everything runs in f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.ir.embedding import PackedColumnEmbedder as TColumnEmbedder
from viquae_torch.ir.embedding import PackedTextEmbedder as TEmbedder
from viquae_torch.ir.qa_serving import AnswerPipeline as TAnswer
from viquae_torch.ir.serving import FusedRetrievalPipeline as TFused
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import dpr as tdpr
from viquae_torch.models import qa as tqa
from viquae_torch.ops import mips as tm
from viquae_tpu.ir.embedding import PackedColumnEmbedder as JColumnEmbedder
from viquae_tpu.ir.embedding import PackedTextEmbedder as JEmbedder
from viquae_tpu.ir.qa_serving import AnswerPipeline as JAnswer
from viquae_tpu.ir.serving import FusedRetrievalPipeline as JFused
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.models import qa as jqa
from viquae_tpu.ops import mips as jm

torch.set_num_threads(2)

SMALL = dict(vocab_size=300, hidden_size=24, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=48,
             max_position_embeddings=64, add_pooler=False)
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def qa_setup(tmp_path_factory):
    from transformers import BertTokenizerFast

    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"w{i}" for i in range(200)])
    d = tmp_path_factory.mktemp("qatok")
    (d / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(d / "vocab.txt"))

    jb, tb = jbert.BertConfig(**SMALL), tbert.BertConfig(**SMALL)
    d_tree = jax.tree.map(
        np.asarray, jdpr.init(jax.random.key(0), jdpr.DPRConfig(bert=jb)))
    trees = {
        fuse: jax.tree.map(np.asarray, jqa.init(
            jax.random.key(1 + 6 * fuse),
            jqa.ReaderConfig(bert=jb, fuse_ir_score=fuse)))
        for fuse in (False, True)}
    # a score projection away from the identity, so the scores matter
    trees[True]["score_proj_w"] = np.full((1, 1), 0.7, np.float32)
    trees[True]["score_proj_b"] = np.full((1,), -0.2, np.float32)

    rng = np.random.default_rng(0)
    kb_rows = [
        {"passage": " ".join(
            f"w{j}" for j in rng.integers(0, 200, rng.integers(8, 20)))}
        for _ in range(60)]
    for row in kb_rows:
        row["passage_tokens"] = tok(
            row["passage"], add_special_tokens=False)["input_ids"]
    kb_mat = rng.normal(size=(60, 24)).astype(np.float32)
    queries = [
        " ".join(f"w{j}" for j in rng.integers(0, 200, rng.integers(4, 9)))
        for _ in range(13)]
    return dict(tok=tok, jb=jb, tb=tb, d_tree=d_tree, trees=trees,
                kb_rows=kb_rows, kb_mat=kb_mat, queries=queries)


def _jax_pipe(s, k=3, fuse=False, **kw):
    dcfg = jdpr.DPRConfig(bert=s["jb"])
    emb = JEmbedder(jdpr.make_packed_apply(dcfg),
                    jax.tree.map(jnp.asarray, s["d_tree"]), s["tok"],
                    row_len=24, batch_size=8, compute_dtype=jnp.float32)
    index = jm.DenseIndex(s["kb_mat"], mode="global", dtype=jnp.float32)
    retrieval = JFused(emb, index, batch_size=8, k=k)
    rcfg = jqa.ReaderConfig(bert=s["jb"], fuse_ir_score=fuse)
    return JAnswer(retrieval, s["kb_rows"], rcfg,
                   jax.tree.map(jnp.asarray, s["trees"][fuse]), s["tok"],
                   compute_dtype=jnp.float32, **kw)


def _port_retrieval(s, k=3):
    dcfg = tdpr.DPRConfig(bert=s["tb"])
    emb = TEmbedder(tdpr.make_packed_apply(dcfg),
                    convert.params_from_jax(s["d_tree"], dcfg, device="cpu"),
                    s["tok"], row_len=24, batch_size=8,
                    compute_dtype=torch.float32, device="cpu")
    index = tm.DenseIndex(s["kb_mat"], mode="global", dtype=torch.float32,
                          device="cpu")
    return TFused(emb, index, batch_size=8, k=k)


def _port_pipe(s, k=3, fuse=False, kb=None, **kw):
    rcfg = tqa.ReaderConfig(bert=s["tb"], fuse_ir_score=fuse)
    reader = convert.reader_from_jax(s["trees"][fuse], rcfg, device="cpu")
    return TAnswer(_port_retrieval(s, k), kb or s["kb_rows"], rcfg, reader,
                   s["tok"], compute_dtype=torch.float32, device="cpu", **kw)


def _assert_same_output(ours, ref):
    assert len(ours) == len(ref)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a["answer"] == b["answer"], (i, a, b)
        assert a["passage_ids"] == b["passage_ids"], i
        np.testing.assert_allclose(a["scores"], b["scores"], **SCORE_TOL)


COMMON = dict(m_passages=3, reader_seq=48, questions_per_step=4)


@pytest.mark.parametrize("variant", ["padded", "packed", "packed_pinned",
                                     "packed_pinned_overflow", "pretokenized",
                                     "pretokenized_packed"])
def test_answer_pipeline_matches_jax(qa_setup, variant):
    kw = dict(COMMON)
    if variant.startswith("packed"):
        kw["packed_reader"] = True
    if variant == "packed_pinned":
        kw["packed_rows"] = 16
    if variant == "packed_pinned_overflow":
        kw["packed_rows"] = 2   # every batch overflows: the unpinned retry
    if variant.startswith("pretokenized"):
        kw["passage_tokens_key"] = "passage_tokens"
        kw["packed_reader"] = variant.endswith("packed")
    queries = qa_setup["queries"]
    pipe = _port_pipe(qa_setup, **kw)
    ours = pipe.run(queries)
    _assert_same_output(ours, _jax_pipe(qa_setup, **kw).run(queries))
    assert all(isinstance(o["answer"], str) for o in ours)
    assert all(len(o["passage_ids"]) == 3 for o in ours)
    assert set(pipe.report()) == {"retrieve", "reader_dispatch", "decode"}


def test_answer_pipeline_matches_direct_path(qa_setup):
    """The pipeline's answers equal a per-question pass through
    reader_apply + log_probs_to_answers over the ids it retrieved, with the
    pairs tokenized by the tokenizer's own pair mode."""
    s = qa_setup
    tok, queries = s["tok"], s["queries"]
    M, seq = 3, 48
    pipe = _port_pipe(s, **COMMON)
    out = pipe.run(queries)
    for i, o in enumerate(out):
        passages = [s["kb_rows"][int(d)]["passage"] for d in o["passage_ids"]]
        enc = tok([queries[i]] * M, passages, padding="max_length",
                  truncation="only_second", max_length=seq,
                  return_tensors="np")
        mask = torch.from_numpy(enc["attention_mask"].astype(np.int32))
        with torch.no_grad():
            r_out = tqa.reader_apply(
                pipe.reader_params, pipe.reader_cfg,
                torch.from_numpy(enc["input_ids"].astype(np.int32)),
                attention_mask=mask,
                token_type_ids=torch.from_numpy(
                    enc["token_type_ids"].astype(np.int32)),
                m_passages=M)
        neg = torch.tensor(-1e30)
        slp = torch.log_softmax(
            torch.where(mask > 0, r_out.start_logits, neg).reshape(1, -1),
            -1).reshape(M, seq)
        elp = torch.log_softmax(
            torch.where(mask > 0, r_out.end_logits, neg).reshape(1, -1),
            -1).reshape(M, seq)
        ref = tqa.log_probs_to_answers(slp, elp, enc["input_ids"], tok, M)
        assert o["answer"] == ref[0], (i, o["answer"], ref[0])


def test_packed_reader_matches_padded(qa_setup):
    out_pad = _port_pipe(qa_setup, **COMMON).run(qa_setup["queries"])
    out_packed = _port_pipe(qa_setup, packed_reader=True, **COMMON).run(
        qa_setup["queries"])
    for a, b in zip(out_pad, out_packed):
        assert a["answer"] == b["answer"], (a, b)
        assert a["passage_ids"] == b["passage_ids"]


def test_pretokenized_matches_text(qa_setup):
    out_text = _port_pipe(qa_setup, **COMMON).run(qa_setup["queries"])
    out_pre = _port_pipe(qa_setup, passage_tokens_key="passage_tokens",
                         **COMMON).run(qa_setup["queries"])
    assert [o["answer"] for o in out_text] == [o["answer"] for o in out_pre]


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_long_question_and_ir_score_match_jax(qa_setup, packed):
    """A question longer than reader_seq is cut to its budget, and a
    fuse_ir_score reader is given the retrieval scores."""
    rng = np.random.default_rng(9)
    long_q = " ".join(f"w{j}" for j in rng.integers(0, 200, 120))
    queries = [long_q] + list(qa_setup["queries"][:5])
    kw = dict(m_passages=3, reader_seq=32, questions_per_step=3,
              packed_reader=packed)
    ours = _port_pipe(qa_setup, fuse=True, **kw).run(queries)
    assert len(ours) == 6 and all(o["answer"] is not None for o in ours)
    _assert_same_output(ours, _jax_pipe(qa_setup, fuse=True, **kw).run(
        queries))


def test_ir_score_reaches_the_reader(qa_setup):
    """With a steep score projection the top-scored passage wins every
    question: the answer is a span of the row [CLS] q [SEP] passage_ids[0]
    [SEP], so its words come from that question and that passage."""
    s = qa_setup
    trees = dict(s["trees"])
    trees[True] = {**trees[True],
                   "score_proj_w": np.full((1, 1), 50.0, np.float32)}
    pipe = _port_pipe({**s, "trees": trees}, fuse=True, **COMMON)
    for query, o in zip(s["queries"], pipe.run(s["queries"])):
        top = s["kb_rows"][o["passage_ids"][0]]["passage"]
        assert o["answer"]
        assert set(o["answer"].split()) <= set((query + " " + top).split())


def test_out_of_range_and_empty_passages_keep_their_rows(qa_setup):
    """Ids past the KB and empty token lists leave all-zero rows that win
    no span; a question with no passage at all still gets a string."""
    s = qa_setup

    class FixedRetrieval:
        k = 3

        def run_arrays(self, queries):
            n = len(queries)
            idx = np.tile(np.array([5, 999, 7], np.int64), (n, 1))
            idx[0] = [999, 5, -1]
            idx[1] = [999, 998, -1]   # nothing to read
            return np.ones((n, 3), np.float32), idx

    rcfg = tqa.ReaderConfig(bert=s["tb"])
    reader = convert.reader_from_jax(s["trees"][False], rcfg, device="cpu")
    for packed in (False, True):
        pipe = TAnswer(FixedRetrieval(), s["kb_rows"], rcfg, reader,
                       s["tok"], passage_tokens_key="passage_tokens",
                       packed_reader=packed, compute_dtype=torch.float32,
                       device="cpu", **COMMON)
        queries = s["queries"][:5]
        out = pipe.run(queries)
        # a span lies in one row [CLS] q [SEP] p [SEP]: its words come from
        # the question and from one passage that was really read
        words = [set((q + " " + s["kb_rows"][5]["passage"]).split())
                 for q in queries]
        assert out[0]["answer"] and set(out[0]["answer"].split()) <= words[0]
        assert out[1]["answer"] == ""
        for q, o, with5 in zip(queries[2:], out[2:], words[2:]):
            with7 = set((q + " " + s["kb_rows"][7]["passage"]).split())
            answer = set(o["answer"].split())
            assert answer and (answer <= with5 or answer <= with7)


def test_rejects_short_retrieval_k(qa_setup):
    s = qa_setup
    rcfg = tqa.ReaderConfig(bert=s["tb"])
    reader = convert.reader_from_jax(s["trees"][False], rcfg, device="cpu")
    with pytest.raises(ValueError, match="m_passages"):
        TAnswer(_port_retrieval(s, k=2), s["kb_rows"], rcfg, reader,
                s["tok"], m_passages=5, reader_seq=32, device="cpu")


def test_needs_a_gpu_unless_cpu_is_named(qa_setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    s = qa_setup
    rcfg = tqa.ReaderConfig(bert=s["tb"])
    reader = convert.reader_from_jax(s["trees"][False], rcfg, device="cpu")
    with pytest.raises(RuntimeError):
        TAnswer(_port_retrieval(s), s["kb_rows"], rcfg, reader, s["tok"],
                m_passages=3)


def test_packed_column_embedder_empty_batch_matches_jax(qa_setup):
    """dataset.map can hand a 0-row batch: an empty (0, d) f32 column, on
    both sides, before and after a real batch."""
    s = qa_setup
    jcfg, tcfg = jdpr.DPRConfig(bert=s["jb"]), tdpr.DPRConfig(bert=s["tb"])
    ours = TColumnEmbedder(
        tdpr.make_packed_apply(tcfg),
        convert.params_from_jax(s["d_tree"], tcfg, device="cpu"), s["tok"],
        row_len=24, batch_size=8, key="passage", save_as="emb", device="cpu")
    ref = JColumnEmbedder(
        jdpr.make_packed_apply(jcfg), jax.tree.map(jnp.asarray, s["d_tree"]),
        s["tok"], row_len=24, batch_size=8, key="passage", save_as="emb")
    for batch in ([], ["w1 w2 w3", "w4"], []):
        a = ours({"passage": list(batch)})["emb"]
        b = ref({"passage": list(batch)})["emb"]
        assert a.shape == b.shape == (len(batch), 24)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, **SCORE_TOL)
