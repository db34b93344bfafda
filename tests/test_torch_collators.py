"""The port's collators (viquae_torch/train/data.py, a textual host copy
of viquae_tpu/train/data.py held by tests/test_torch_host_copies.py) and
its answer-span matcher (native/answer_spans.cpp, a byte-identical copy)
in every case of tests/test_collators.py: each case runs in both packages
on the same inputs and seeds, the outputs must be equal (arrays bitwise,
strings exactly), and the JAX test's own assertions hold on the port's.
The cases that run a model (the packed reader and re-ranker) run the
port's model: packed and padded losses / logits agree within 1e-4."""
import numpy as np
import pytest
import torch

from viquae_torch.train import data as tdata
from viquae_torch.train.objectives import IGNORE_INDEX
from viquae_tpu.train import data as jdata

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast

    letters = list("abcdefghijklmnopqrstuvwxyz0123456789")
    vocab = (
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + [f"ent{i}" for i in range(30)]
        + [f"fact{i}" for i in range(30)]
        + ["question", "about", "passage", "text", "answer", "is", "the"]
        + letters + [f"##{c}" for c in letters]
    )
    d = tmp_path_factory.mktemp("tok")
    (d / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"),
                             do_lower_case=True)


def make_kb(n=20):
    return [{"passage": f"passage about ent{i} the answer is fact{i}",
             "index": i} for i in range(n)]


def make_items(n=4):
    return [
        {
            "id": f"q{i}",
            "input": f"question about ent{i}",
            "output": {"original_answer": f"fact{i}", "answer": [f"fact{i}"]},
            "search_provenance_indices": [i],
            "search_provenance_scores": [10.0],
            "search_irrelevant_indices": [(i + 5) % 20, (i + 9) % 20],
            "search_irrelevant_scores": [2.0, 1.0],
            "search_indices": [i, (i + 5) % 20, (i + 9) % 20],
            "search_scores": [9.0, 3.0, 1.0],
        }
        for i in range(n)
    ]


def assert_same(a, b, where="batch"):
    """Deep equality of collator outputs: dicts by key, arrays bitwise
    (dtype included), lists and scalars exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def both(fn):
    """fn(module) in both packages; asserts equal outputs, returns the
    port's."""
    ours, ref = fn(tdata), fn(jdata)
    assert_same(ours, ref)
    return ours


def test_biencoder_collate(tokenizer):
    batch = both(lambda m: m.BiEncoderCollator(
        tokenizer, kb=make_kb(), M=3, max_length=16, seed=0
    ).collate_fn(make_items(4)))
    assert batch["question_inputs"]["input_ids"].shape == (4, 16)
    assert batch["context_inputs"]["input_ids"].shape == (12, 16)
    np.testing.assert_array_equal(batch["labels"], [0, 1, 2, 3])
    assert "ent1" in tokenizer.decode(batch["context_inputs"]["input_ids"][1])


def test_biencoder_missing_relevant_gets_ignore_index(tokenizer):
    def run(m):
        items = make_items(2)
        items[1]["search_provenance_indices"] = []
        return m.BiEncoderCollator(tokenizer, kb=make_kb(), M=2,
                                   max_length=16, seed=0).collate_fn(items)

    batch = both(run)
    assert batch["labels"][0] == 0 and batch["labels"][1] == IGNORE_INDEX


def test_image_features_padding():
    items = [
        {"face_embedding": [[1.0] * 4, [2.0] * 4, [3.0] * 4, [4.0] * 4],
         "face_box": [[0.1] * 7] * 4, "clip": [9.0] * 5},
        {"face_embedding": None, "clip": None},
        {"clip": [float("nan")] * 5},
    ]

    def run(m):
        feats = m.PreComputedImageFeatures(n_faces=3, face_dim=4, bbox_dim=7,
                                           image_dims={"clip": 5})
        return feats.get_face_inputs(items), feats.get_image_inputs(items)

    faces, images = both(run)
    assert faces["face"].shape == (3, 1, 3, 4)
    np.testing.assert_array_equal(faces["attention_mask"][0, 0], [1, 1, 1])
    np.testing.assert_array_equal(images["clip"]["attention_mask"][:, 0],
                                  [1, 0, 0])


def test_reader_collate_answer_positions(tokenizer):
    batch = both(lambda m: m.ReaderCollator(
        tokenizer, kb=make_kb(), M=2, max_length=24, max_n_answers=3,
        seed=0, train=True).collate_fn(make_items(2)))
    assert batch["input_ids"].shape == (4, 24)
    assert batch["start_positions"].shape == (2, 2, 3)
    for i in range(2):
        row = batch["input_ids"][i * 2]
        s = batch["start_positions"][i, 0, 0]
        e = batch["end_positions"][i, 0, 0]
        assert batch["answer_mask"][i, 0, 0] == 1
        np.testing.assert_array_equal(row[s: e + 1], tokenizer(
            f"fact{i}", add_special_tokens=False)["input_ids"])
    assert batch["answer_strings"][0] == ["fact0"]


def test_reader_eval_passages_from_run(tokenizer):
    from viquae_torch import rankeval as trank
    from viquae_tpu import rankeval as jrank

    def run(m):
        rank = trank if m is tdata else jrank
        return m.ReaderCollator(
            tokenizer, kb=make_kb(), M=2, max_length=24, seed=0,
            train=False, run=rank.Run({"q0": {"3": 5.0, "7": 4.0},
                                       "q1": {"2": 9.0}}),
        ).collate_fn(make_items(2))

    batch = both(run)
    np.testing.assert_allclose(batch["passage_scores"], [5.0, 4.0, 9.0, 0.0])
    assert "ent3" in tokenizer.decode(batch["input_ids"][0])


def test_reranker_collate(tokenizer):
    batch = both(lambda m: m.ReRankerCollator(
        tokenizer, kb=make_kb(), M=3, max_length=16, seed=0, train=True
    ).collate_fn(make_items(2)))
    assert batch["input_ids"].shape == (6, 16)
    np.testing.assert_array_equal(batch["labels"], [0, 0])


def ict_items(n=4):
    return [
        {
            "sentences": [{"text": f"sentence {j} of doc {i}."}
                          for j in range(5)],
            "title": f"doc{i}",
            "face_embedding": [[float(i)] * 4],
            "face_box": [[0.1] * 7],
            "clip": [float(i)] * 5,
            "context_clip": [float(i) + 100] * 5,
            "context_face_embedding": [[float(i) + 100] * 4],
            "context_face_box": [[0.2] * 7],
        }
        for i in range(n)
    ]


@pytest.mark.parametrize("packed", [False, True])
def test_ict_collate_hard_negatives(tokenizer, packed):
    def run(m):
        feats = m.PreComputedImageFeatures(n_faces=1, face_dim=4, bbox_dim=7,
                                           image_dims={"clip": 5})
        coll = m.ICTCollator(tokenizer, M=3, max_length=16, seed=0,
                             image_features=feats, sentences_per_target=2,
                             packed=packed)
        return [coll.collate_fn(ict_items()) for _ in range(3)]

    batch = both(run)[0]
    assert batch["context_inputs"]["text_inputs"]["input_ids"].shape == (
        12, 16)
    clip = batch["context_inputs"]["image_inputs"]["clip"]["input"]
    assert clip.shape == (12, 1, 5)
    np.testing.assert_array_equal(clip[4], np.roll(clip[:4], 1, 0)[0])
    np.testing.assert_array_equal(batch["labels"], [0, 1, 2, 3])
    assert ("canvas_vis_rows" in batch["question_inputs"]["text_inputs"]
            ) == packed


def test_ict_pseudo_question_masking(tokenizer):
    item = {"sentences": [{"text": f"s{j}."} for j in range(5)], "title": "t"}

    def run(m):
        coll = m.ICTCollator(tokenizer, M=1, max_length=16, seed=0,
                             text_mask_rate=1.0, sentences_per_target=2)
        return [coll.get_pseudo_question(item) for _ in range(10)]

    for q, t in both(run):
        assert q["text"] not in t["text"]


def test_map_run():
    from viquae_torch.rankeval import Run

    run = Run({"q1": {"a0": 3.0, "a1": 2.0}})
    mapping = {"a0": [10, 11], "a1": [20]}
    out = tdata.map_run(run, mapping, k=3)
    assert out["q1"] == {"10": 3.0, "11": 3.0, "20": 2.0}
    assert set(tdata.map_run(run, mapping, k=2)["q1"]) == {"10", "11"}


def test_crossmodal_collator(tokenizer):
    items = [{"text": "question about ent0",
              "pixel_values": np.zeros((8, 8, 3), np.float32)},
             {"text": "question about ent1",
              "pixel_values": np.ones((8, 8, 3), np.float32)}]
    batch = both(lambda m: m.CrossModalCollator(
        tokenizer, max_length=12).collate_fn(items))
    assert batch["text_inputs"]["input_ids"].shape == (2, 12)
    assert batch["pixel_values"].shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(batch["labels"], [0, 1])


def test_answer_positions_native_matches_python(tokenizer, monkeypatch):
    """The port's native matcher (built from its own copy of
    answer_spans.cpp) and the numpy fallback give the JAX package's
    positions."""
    from viquae_torch.native import load_answer_span_matcher

    assert load_answer_span_matcher() is not None

    def run(m):
        return m.ReaderCollator(
            tokenizer, kb=make_kb(), M=2, max_length=24, max_n_answers=3,
            seed=0, train=True).collate_fn(make_items(4))

    native = both(run)
    monkeypatch.setenv("VIQUAE_NO_NATIVE", "1")
    import viquae_torch.native.build as tbuild

    monkeypatch.setattr(tbuild, "_CACHE", {})
    fallback = run(tdata)
    for k in ("start_positions", "end_positions", "answer_mask"):
        np.testing.assert_array_equal(native[k], fallback[k])


def test_answer_positions_native_dedupe_rule():
    """Repeated answers and overlapping matches: the port's native matcher
    keeps what the JAX package's keeps, bit for bit."""
    from viquae_torch.native import load_answer_span_matcher as tload
    from viquae_tpu.native import load_answer_span_matcher as jload

    outs = []
    for load in (tload, jload):
        native = load()
        assert native is not None
        ids = np.array([[7, 8, 7, 8, 7, 8, 0, 0]], np.int32)
        out_s = np.zeros((1, 4), np.int32)
        out_e = np.zeros((1, 4), np.int32)
        out_c = np.zeros(1, np.int32)
        native(ids, np.int64(1), np.int64(8),
               np.array([7, 8, 8, 7], np.int32),
               np.array([0, 2, 4], np.int64), np.array([0, 2], np.int64),
               np.int32(4), out_s, out_e, out_c)
        outs.append((out_s, out_e, out_c))
    assert_same(*outs)
    out_s, out_e, out_c = outs[0]
    assert out_c[0] == 4
    assert out_s[0, :4].tolist() == [0, 2, 4, 1]
    assert out_e[0, :4].tolist() == [1, 3, 5, 2]


def test_reader_collator_packed_matches_unpacked_loss(tokenizer):
    """packed=True emits the canvas fields; the port reader's packed loss
    is finite and <= the padded one (pads are -inf on the canvas)."""
    from viquae_torch.models import bert, qa
    from viquae_torch.train import trainee

    batch = both(lambda m: m.ReaderCollator(
        tokenizer, kb=make_kb(), M=2, max_length=24, max_n_answers=3,
        seed=0, train=True, packed=True).collate_fn(make_items(2)))
    assert batch["gather_idx"].shape == (4, 24)
    assert int((batch["canvas_segment_ids"] > 0).sum()) == int(
        batch["attention_mask"].sum())
    cfg = qa.ReaderConfig(bert=bert.BertConfig(
        vocab_size=tokenizer.vocab_size + 10, hidden_size=16,
        num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32, add_pooler=False))
    params = qa.init(cfg, 0, device="cpu")
    rt = trainee.ReaderTrainee(cfg, params, tokenizer, m_passages=2)
    from viquae_torch.core.device import upload_batch

    unpacked = {k: v for k, v in batch.items()
                if not k.startswith("canvas_") and "gather" not in k}
    lp, ap = rt.loss_fn(params, upload_batch(batch, "cpu"),
                        deterministic=True)
    lu, au = rt.loss_fn(params, upload_batch(unpacked, "cpu"),
                        deterministic=True)
    assert torch.isfinite(lp)
    assert float(lp) <= float(lu) + 1e-4
    assert ap["start_log_probs"].shape == au["start_log_probs"].shape


def test_reranker_collator_packed_matches_unpacked(tokenizer):
    from viquae_torch.models import bert, rr

    batch = both(lambda m: m.ReRankerCollator(
        tokenizer, kb=make_kb(), M=2, max_length=24, seed=0, train=True,
        packed=True).collate_fn(make_items(2)))
    assert "canvas_token_type_ids" in batch
    cfg = rr.BertReRankerConfig(bert=bert.BertConfig(
        vocab_size=tokenizer.vocab_size + 10, hidden_size=16,
        num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32, add_pooler=False))
    params = rr.bert_reranker_init(cfg, 0, device="cpu")
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
         if not isinstance(v, list)}
    ref = rr.bert_reranker_apply(params, cfg, t["input_ids"],
                                 t["attention_mask"],
                                 token_type_ids=t.get("token_type_ids"))
    got = rr.bert_reranker_apply_packed(
        params, cfg, t["canvas_input_ids"], t["canvas_segment_ids"],
        t["canvas_position_ids"], t["canvas_token_type_ids"],
        t["canvas_cls_rows"], t["canvas_cls_cols"])
    np.testing.assert_allclose(got.logits.numpy(), ref.logits.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_image_formatter_concatenates_question_and_passage_features():
    q_items = [{"face_embedding": [[1.0] * 4], "clip": [9.0, 9.0, 9.0]}] * 2
    p_items = [{"clip": [5.0, 5.0, 5.0]}, {}]
    text = {"input_ids": np.zeros((2, 4), np.int32),
            "attention_mask": np.ones((2, 4), np.int32)}

    def run(m):
        feats = m.PreComputedImageFeatures(n_faces=2, face_dim=4,
                                           bbox_dim=7, image_dims={"clip": 3})
        return m.ImageFormatter(feats).format_batch(text, q_items, p_items)

    out = both(run)
    assert out["face_inputs"]["face"].shape == (2, 2, 2, 4)
    np.testing.assert_array_equal(
        out["image_inputs"]["clip"]["input"][:, 0], [[9, 9, 9]] * 2)
    np.testing.assert_array_equal(
        out["image_inputs"]["clip"]["attention_mask"], [[1, 1], [1, 0]])


def test_reader_collator_precomputed_keeps_positions_top_level(tokenizer):
    def run(m):
        questions = make_items()
        for q in questions:
            q["face_embedding"] = [[0.5] * 8]
        return m.ReaderCollator(
            tokenizer, kb=make_kb(), M=2, max_length=24, max_n_answers=2,
            seed=0, train=True, image_features=m.PreComputedImageFeatures(
                n_faces=1, face_dim=8, bbox_dim=7, image_dims={}),
        ).collate_fn(questions[:4])

    batch = both(run)
    assert "start_positions" in batch and "text_inputs" in batch
    assert "start_positions" not in batch["text_inputs"]
    assert batch["face_inputs"]["face"].shape[1] == 2
    with pytest.raises(ValueError, match="packed multimodal reader"):
        tdata.ReaderCollator(
            tokenizer, kb=make_kb(), M=2, max_length=24, packed=True,
            image_features=tdata.PreComputedImageFeatures(
                n_faces=1, face_dim=8, bbox_dim=7, image_dims={}))


def test_training_passages_sample_full_lists(tokenizer):
    item = {
        "id": "q0", "input": "question about ent0",
        "output": {"original_answer": "fact0", "answer": ["fact0"]},
        "search_provenance_indices": [0, 1, 2, 3],
        "search_provenance_scores": [4.0, 3.0, 2.0, 1.0],
        "search_irrelevant_indices": [10, 11, 12, 13, 14, 15],
        "search_irrelevant_scores": [6.0, 5.0, 4.0, 3.0, 2.0, 1.0],
    }

    def run(m):
        mod = m.QADataModule(tokenizer, kb=make_kb(), M=4,
                             n_relevant_passages=1, seed=0)
        draws = [mod.get_training_passages(item) for _ in range(200)]
        return ([[p["index"] for p in rel] for rel, _ in draws],
                [[p["index"] for p in irr] for _, irr in draws])

    rel, irr = both(run)
    assert {r[0] for r in rel} == {0, 1, 2, 3}
    assert {i for row in irr for i in row} == {10, 11, 12, 13, 14, 15}


def test_packed_collator_pins_canvas_rows(tokenizer):
    def run(m):
        col = m.BiEncoderCollator(tokenizer, kb=make_kb(), M=2,
                                  n_relevant_passages=1, packed=True,
                                  max_length=32, seed=0)
        return col.collate_fn(make_items(4)), col.collate_fn(make_items(2))

    b1, b2 = both(run)
    k = "canvas_input_ids"
    assert b1["question_inputs"][k].shape == b2["question_inputs"][k].shape


def test_select_kb_batched_matches_rowwise(tokenizer):
    import datasets as hfds

    kb = hfds.Dataset.from_list(make_kb())

    def run(m):
        return m.QADataModule(tokenizer, kb=kb, M=4)._select_kb([3, 7, 1])

    rows = both(run)
    assert [r["index"] for r in rows] == [3, 7, 1]
    assert rows[0]["passage"] == make_kb()[3]["passage"]


def test_joint_biencoder_and_clip_collator(tokenizer):
    """The joint collator adds the passages' titles (text before
    ' [SEP] ') tokenized for the CLIP text tower, in both packages."""
    kb = [{**p, "passage": f"ent{p['index']} [SEP] {p['passage']}"}
          for p in make_kb()]
    batch = both(lambda m: m.JointBiEncoderAndClipCollator(
        tokenizer, cm_tokenizer=tokenizer, cm_max_length=8, kb=kb, M=2,
        max_length=16, seed=0).collate_fn(make_items(3)))
    titles = batch["context_inputs"]["titles"]["input_ids"]
    assert titles.shape == (6, 8)
    assert tokenizer.decode(titles[1], skip_special_tokens=True) == "ent1"
