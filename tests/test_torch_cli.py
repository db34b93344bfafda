"""The port's CLI (``python -m viquae_torch --device cpu <command>``)
against the JAX package's (``viquae_tpu.cli.main``) on the same configs
and the same weights: the cases of tests/test_cli.py (all but training)
and of tests/test_cli_aux.py for the aux commands the port runs,
``train`` (fit with checkpoints, resume and export; validate; test) and
``save-ptm``, the host-only data, annotation and viz commands (``wiki``
with its one network call replaced), plus the parsers.

Weights: neither CLI draws them. Both load one export directory written
by the JAX package's ``export_params`` (a tree drawn with numpy), or one
torch checkpoint in the reference's layout (facenet, insightface, HF
CLIP). Equality: runs and answers exactly (same ids, same answer
strings); scores within 1e-5, or one bf16 ulp where the pipeline rounds
them to bf16 (the f32 sums of the two packages differ in their last bits
and may round to neighbouring bf16 values: seen once, on the hybrid answer
path); embeddings within 1e-5 of the largest entry; host-only commands
byte for byte.
"""
import io
import json
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from viquae_torch.cli import main as tmain
from viquae_torch.cli import parse_args
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_tpu.cli import main as jmain
from viquae_tpu.train.checkpoint import export_params

torch.set_num_threads(2)

BCFG = dict(vocab_size=40, hidden_size=16, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=32,
            max_position_embeddings=64, add_pooler=False)
READER_BCFG = {k: v for k, v in BCFG.items() if k != "add_pooler"}


def port(argv):
    tmain(["--device", "cpu", *map(str, argv)])


def jax_cli(argv):
    jmain([*map(str, argv)])


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Tokenizer, KB (passages, 16-d text and 8-d clip embeddings), query
    file and the DPR and reader export directories."""
    from datasets import Dataset
    from transformers import BertTokenizerFast

    root = tmp_path_factory.mktemp("cli")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(30)]
    (root / "tok").mkdir()
    (root / "tok" / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(root / "tok" / "vocab.txt"),
                      do_lower_case=True).save_pretrained(root / "tok")
    rng = np.random.default_rng(0)
    Dataset.from_dict({
        "passage": [" ".join(f"w{j}" for j in rng.integers(0, 30, 8))
                    for _ in range(40)],
        "embedding": rng.standard_normal((40, 16)).astype(
            np.float32).tolist(),
        "clip": rng.standard_normal((40, 8)).astype(np.float32).tolist(),
    }).save_to_disk(str(root / "kb"))
    np.save(root / "q_clip.npy", rng.standard_normal((9, 8)).astype(
        np.float32))
    (root / "queries.txt").write_text(
        "\n".join(f"w{i} w{i + 1} w{i + 2}" for i in range(9)))
    export_params(root / "dpr", convert.init_tree(
        tbert.BertConfig(**BCFG), seed=3))
    from viquae_torch.models import qa as tqa

    export_params(root / "reader", convert.init_reader_tree(
        tqa.MultiPassageBERTReader.config(READER_BCFG), seed=4))
    return root


def dpr_model(ws):
    return {"class_name": "DPREncoder",
            "pretrained_model_name_or_path": str(ws / "dpr"),
            "bert_config": BCFG}


def reader_block(ws):
    return {"reader": {"class_name": "MultiPassageBERTReader",
                       "pretrained_model_name_or_path": str(ws / "reader"),
                       "bert_config": READER_BCFG},
            "passages": str(ws / "kb"), "reader_seq": 48,
            "questions_per_step": 4, "packed_reader": True}


def write(path, obj):
    path.write_text(json.dumps(obj))
    return path


def assert_scores_close(got, ref):
    """Within 1e-5, or one bf16 ulp of the reference score."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ulp = np.ldexp(1.0, np.frexp(np.abs(ref))[1] - 8)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= np.maximum(1e-5, ulp)).all(), (got, ref)


def assert_runs_equal(a, b):
    assert a.keys() == b.keys()
    for q in a:
        assert list(a[q]) == list(b[q]), q
        assert_scores_close([b[q][d] for d in b[q]], [a[q][d] for d in a[q]])


def both_serve(ws, tmp_path, config, capsys, k=5):
    cfg = write(tmp_path / "serve.json", config)
    out = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        cli(["serve", ws / "queries.txt", cfg, tmp_path / f"{label}.json",
             "--k", k, "--batch", 4])
        out[label] = json.loads(capsys.readouterr().out)
    assert out["port"]["queries"] == out["jax"]["queries"] == 9
    runs = {label: json.loads((tmp_path / f"{label}.json").read_text())
            for label in out}
    assert len(runs["port"]) == 9
    assert all(len(v) == k for v in runs["port"].values())
    assert_runs_equal(runs["jax"], runs["port"])
    return out


def both_answer(ws, tmp_path, config, capsys):
    cfg = write(tmp_path / "answer.json", config)
    results = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        cli(["answer", ws / "queries.txt", cfg, tmp_path / f"{label}.json",
             "--m-passages", 3, "--batch", 4])
        assert json.loads(capsys.readouterr().out)["queries"] == 9
        results[label] = json.loads((tmp_path / f"{label}.json").read_text())
    assert len(results["port"]) == 9
    for a, b in zip(results["jax"], results["port"]):
        assert b["question"] == a["question"]
        assert b["answer"] == a["answer"] and b["answer"] is not None
        assert list(b["passage_ids"]) == list(a["passage_ids"])
        assert len(b["passage_ids"]) == 3
        assert_scores_close(b["scores"], a["scores"])


# --------------------------------------------------------------------------
# parsers, the device
# --------------------------------------------------------------------------
def _commands(main, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--help"])
    assert exc.value.code == 0
    listed = re.search(r"\{([a-z0-9,\-]+)\}", capsys.readouterr().out)
    return set(listed.group(1).split(","))


def test_parsers_list_the_same_commands(capsys):
    ours, ref = _commands(tmain, capsys), _commands(jmain, capsys)
    assert ours == ref and len(ours) == 31


def test_cli_refuses_the_cpu_unless_named(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    cfg = write(tmp_path / "c.json", {})
    with pytest.raises(SystemExit):
        tmain(["hp", str(cfg)])
    assert "--device cpu" in capsys.readouterr().err
    assert parse_args(["--device", "cpu", "hp", str(cfg)]).device == \
        torch.device("cpu")


def test_cli_config_both_styles(tmp_path, capsys):
    """Configs are accepted positionally or via --config; both/neither
    fail, with the JAX package's messages."""
    cfg = str(write(tmp_path / "cfg.json", {}))
    for main in (jmain, lambda argv: tmain(["--device", "cpu", *argv])):
        with pytest.raises(SystemExit):
            main(["hp"])
        assert "config is required" in capsys.readouterr().err
        with pytest.raises(SystemExit):
            main(["hp", cfg, "--config", cfg])
        assert "both positionally" in capsys.readouterr().err


# --------------------------------------------------------------------------
# serve / answer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["global", "fused"])
def test_cli_serve(ws, tmp_path, capsys, mode):
    both_serve(ws, tmp_path, {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"), "row_len": 16,
        "index": {"dataset": str(ws / "kb"), "column": "embedding",
                  "mode": mode}}, capsys)


def test_cli_serve_fusion(ws, tmp_path, capsys, devices):
    from viquae_tpu.ops import mips

    clip = np.asarray(
        __import__("datasets").load_from_disk(str(ws / "kb"))["clip"],
        np.float32)
    mips.DenseIndex(clip, do_l2norm=True).save(str(tmp_path / "clip_idx"))
    both_serve(ws, tmp_path, {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"), "row_len": 16,
        "indexes": {
            "dpr": {"dataset": str(ws / "kb"), "column": "embedding",
                    "mode": "global"},
            "clip": {"load": str(tmp_path / "clip_idx.npz"),
                     "mode": "global"}},
        "weights": {"dpr": 0.6, "clip": 0.4}, "text_index": "dpr",
        "norm": "gzmuv",
        "query_features": {"clip": str(ws / "q_clip.npy")}}, capsys)


@pytest.mark.parametrize("device_bm25", [False, True])
def test_cli_serve_hybrid(ws, tmp_path, capsys, device_bm25):
    bm25 = {"kb": str(ws / "kb"), "column": "passage", "b": 0.3, "k1": 0.5}
    if device_bm25:
        bm25.update(device=True, n_head=8, l_small=16, pool_mid=8,
                    pool_small=16, q_block=4)
    out = both_serve(ws, tmp_path, {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"), "row_len": 16,
        "index": {"dataset": str(ws / "kb"), "column": "embedding",
                  "mode": "global"},
        "bm25": bm25, "weights": [0.7, 0.3], "norm": "gzmuv"}, capsys)
    assert ("bm25_host" in out["port"]["stages"]) != device_bm25


def test_cli_answer(ws, tmp_path, capsys):
    both_answer(ws, tmp_path, {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"), "row_len": 16,
        "index": {"dataset": str(ws / "kb"), "column": "embedding",
                  "mode": "fused"}, **reader_block(ws)}, capsys)


def test_cli_answer_fusion(ws, tmp_path, capsys):
    both_answer(ws, tmp_path, {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"), "row_len": 16,
        "indexes": {
            "dpr": {"dataset": str(ws / "kb"), "column": "embedding",
                    "mode": "fused"},
            "clip": {"dataset": str(ws / "kb"), "column": "clip",
                     "mode": "global"}},
        "weights": {"dpr": 0.6, "clip": 0.4}, "text_index": "dpr",
        "query_features": {"clip": str(ws / "q_clip.npy")},
        **reader_block(ws)}, capsys)


def test_cli_answer_hybrid(ws, tmp_path, capsys):
    both_answer(ws, tmp_path, {
        "model": dpr_model(ws), "tokenizer": str(ws / "tok"), "row_len": 16,
        "index": {"dataset": str(ws / "kb"), "column": "embedding",
                  "mode": "global"},
        "bm25": {"kb": str(ws / "kb"), "column": "passage", "b": 0.3,
                 "k1": 0.5},
        "weights": [0.7, 0.3], **reader_block(ws)}, capsys)


def test_cli_interact(ws, tmp_path, capsys, monkeypatch):
    """The REPL prints the same hits (and, with a reader, the same
    answers) in both packages."""
    lines = "w1 w2 w3\n\nw7 w8\n"
    base = {"model": dpr_model(ws), "tokenizer": str(ws / "tok"),
            "row_len": 16, "index": {"dataset": str(ws / "kb"),
                                     "column": "embedding",
                                     "mode": "global"}}
    for config in ({**base, "passages": str(ws / "kb")},
                   {**base, **reader_block(ws)}):
        cfg = write(tmp_path / "interact.json", config)
        printed = {}
        for label, cli in (("jax", jax_cli), ("port", port)):
            monkeypatch.setattr("sys.stdin", io.StringIO(lines))
            cli(["interact", cfg, "--k", 3, "--batch", 4,
                 "--m-passages", 3])
            printed[label] = capsys.readouterr().out
        assert printed["port"] == printed["jax"]
        assert printed["port"].count("\n") >= 3


# --------------------------------------------------------------------------
# embed
# --------------------------------------------------------------------------
def _embedding(path, column):
    from datasets import load_from_disk

    return np.asarray(load_from_disk(str(path))[column], np.float32)


def _close(got, ref, rtol=1e-5):
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_cli_embed_packed_matches_padded(ws, tmp_path):
    from datasets import Dataset

    rng = np.random.default_rng(0)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 30,
                                                    rng.integers(3, 12)))
             for _ in range(17)]
    base = {"model": dpr_model(ws), "tokenizer": str(ws / "tok"),
            "max_length": 16, "batch_size": 8, "key": "passage",
            "save_as": "embedding"}
    out = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        for packed in (False, True):
            name = f"{label}_{packed}"
            Dataset.from_dict({"passage": texts}).save_to_disk(
                str(tmp_path / name))
            cfg = write(tmp_path / f"{name}.json", {**base,
                                                    "packed": packed})
            cli(["embed", tmp_path / name, cfg])
            out[name] = _embedding(tmp_path / name, "embedding")
    _close(out["port_True"], out["port_False"], 2e-4)  # packed == padded
    _close(out["port_False"], out["jax_False"])
    _close(out["port_True"], out["jax_True"])


@pytest.fixture(scope="module")
def mm_ws(tmp_path_factory):
    """A tokenizer, a 3-row dataset with face and clip columns (row 1 has
    no face), and ECA / ILF export directories from the JAX inits."""
    from datasets import Dataset
    from transformers import BertTokenizerFast

    from viquae_tpu.models import bert as jbert
    from viquae_tpu.models import mm

    root = tmp_path_factory.mktemp("mm")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "who", "is",
             "this"] + [f"ent{i}" for i in range(10)]
    (root / "tok").mkdir()
    (root / "tok" / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(root / "tok" / "vocab.txt"),
                      do_lower_case=True).save_pretrained(root / "tok")
    bcfg = dict(vocab_size=30, hidden_size=16, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=32,
                max_position_embeddings=16, add_pooler=False)
    cfg = mm.MMConfig(bert=jbert.BertConfig(**bcfg), n_faces=2,
                      face_dim=8, image_dims=(("clip", 10),))
    export_params(root / "eca", jax.tree.map(
        np.asarray, mm.eca_init(jax.random.key(0), cfg)))
    export_params(root / "ilf", jax.tree.map(
        np.asarray, mm.ilf_init(jax.random.key(1), cfg)))
    rng = np.random.default_rng(0)
    rows = [{
        "input": f"who is this ent{i}",
        "face_embedding": (None if i == 1 else rng.standard_normal(
            (2, 8)).astype(np.float32).tolist()),
        "face_box": (None if i == 1 else rng.standard_normal(
            (2, 7)).astype(np.float32).tolist()),
        "clip": rng.standard_normal(10).astype(np.float32).tolist(),
    } for i in range(3)]
    Dataset.from_list(rows).save_to_disk(str(root / "ds"))
    return root, bcfg


@pytest.mark.parametrize("name,packed", [("ECAEncoder", False),
                                         ("ECAEncoder", True),
                                         ("IntermediateLinearFusion", True)])
def test_cli_embed_multimodal(mm_ws, tmp_path, name, packed):
    root, bcfg = mm_ws
    export = root / ("eca" if name == "ECAEncoder" else "ilf")
    config = {
        "model": {"class_name": name,
                  "pretrained_model_name_or_path": str(export),
                  "bert": bcfg, "n_faces": 2, "face_dim": 8,
                  "image_dims": {"clip": 10}},
        "tokenizer": str(root / "tok"),
        "image_features": {"n_faces": 2, "face_dim": 8,
                           "image_dims": {"clip": 10}},
        "key": "input", "save_as": "mm_embedding", "max_length": 8,
        "batch_size": 2, "packed": packed,
    }
    cfg = write(tmp_path / "cfg.json", config)
    for label, cli in (("jax", jax_cli), ("port", port)):
        cli(["embed", root / "ds", cfg, "--output", tmp_path / label])
    got = _embedding(tmp_path / "port", "mm_embedding")
    assert got.shape == (3, 16)
    assert len({tuple(r.round(5)) for r in got}) == 3
    _close(got, _embedding(tmp_path / "jax", "mm_embedding"))

    # a multimodal model without image_features fails with a clear error
    del config["image_features"]
    bad = write(tmp_path / "bad.json", config)
    with pytest.raises(ValueError, match="image_features"):
        port(["embed", root / "ds", bad, "--output", tmp_path / "out2"])


# --------------------------------------------------------------------------
# search, fuse, hp and the host-only data commands
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qa_ws(tmp_path_factory):
    """tests/test_cli.py's workspace: a 12-passage KB and 6 questions with
    provenance and irrelevant indices."""
    from datasets import Dataset

    root = tmp_path_factory.mktemp("qa")
    Dataset.from_dict({"passage": [
        f"w{i} is famous the answer is w{i + 20}" for i in range(12)]}
    ).save_to_disk(str(root / "kb"))
    Dataset.from_dict({
        "id": [f"q{i}" for i in range(6)],
        "input": [f"what about w{i}" for i in range(6)],
        "output": [{"original_answer": f"w{i + 20}",
                    "answer": [f"w{i + 20}"],
                    "provenance": [{"title": [f"T{i}"]}]}
                   for i in range(6)],
        "search_provenance_indices": [[i] for i in range(6)],
    }).save_to_disk(str(root / "questions"))
    return root


def _dir_files(path):
    return {p.relative_to(path).as_posix(): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


def test_cli_search_bm25(qa_ws, tmp_path, capsys):
    config = {"kb_kwargs": {str(qa_ws / "kb"): {"index_kwargs": {
                  "bm25": {"column": "passage", "key": "input",
                           "kind": "BM25"}}}},
              "reference_kb_path": str(qa_ws / "kb"), "do_fusion": False}
    cfg = write(tmp_path / "search.json", config)
    printed = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        shutil.copytree(qa_ws / "questions", tmp_path / f"q_{label}")
        cli(["search", tmp_path / f"q_{label}", cfg, "--k", 5,
             "--metrics", tmp_path / label])
        printed[label] = capsys.readouterr().out
    assert "bm25" in printed["port"]
    assert json.loads((tmp_path / "port" / "metrics.json").read_text()) \
        == json.loads((tmp_path / "jax" / "metrics.json").read_text())
    assert_runs_equal(
        json.loads((tmp_path / "jax" / "bm25.json").read_text()),
        json.loads((tmp_path / "port" / "bm25.json").read_text()))


def test_cli_fuse_and_hp(qa_ws, tmp_path, capsys):
    """`fuse fit` then `fuse test` over two runs, and the BM25 grid
    search: the same files and printed results."""
    rng = np.random.default_rng(0)
    qrels = {f"q{i}": {str(i): 1} for i in range(6)}
    runs = [{f"q{i}": {str(d): float(s) for d, s in zip(
        rng.choice(12, 5, replace=False), rng.normal(size=5))}
        for i in range(6)} for _ in range(2)]
    write(tmp_path / "qrels.json", qrels)
    for r, run in enumerate(runs):
        write(tmp_path / f"run{r}.json", run)
    printed = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        cfg = write(tmp_path / f"fuse_{label}.json", {
            "qrels": str(tmp_path / "qrels.json"),
            "runs": [str(tmp_path / f"run{r}.json") for r in range(2)],
            "output": str(tmp_path / f"fused_{label}"), "norm": "zmuv"})
        cli(["fuse", "fit", "--config", cfg])
        best = next((tmp_path / f"fused_{label}").glob("*best_params.json"))
        cli(["fuse", "test", "--config", cfg, "--best_params", best])
        hp_cfg = write(tmp_path / f"hp_{label}.json", {
            "kb": str(qa_ws / "kb"), "dataset": str(qa_ws / "questions"),
            "qrels": str(tmp_path / "qrels.json"), "k": 5,
            "grid": {"b": [0.3, 0.75], "k1": [0.5, 1.2]}})
        cli(["hp", hp_cfg])
        printed[label] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert "best_params" in printed["port"]
    assert _dir_files(tmp_path / "fused_port") == \
        _dir_files(tmp_path / "fused_jax")


def test_cli_passages_mapping_relevant(tmp_path, capsys):
    from datasets import Dataset, load_from_disk

    articles = {
        "wikipedia_title": ["Ada", "Bizet", "Carmen"],
        "text": [{"paragraph": ["Ada wrote notes.\n", "BEGIN_SECTION x",
                                "She met Babbage.\n"]},
                 {"paragraph": ["Bizet composed Carmen.\n"]},
                 {"paragraph": ["Carmen is an opera.\n", "Short.\n"]}],
    }
    questions = {"id": ["q0", "q1"], "input": ["who wrote notes",
                                               "who composed carmen"],
                 "output": [{"original_answer": "Ada", "answer": ["Ada"],
                             "provenance": [{"title": ["Ada"]}]},
                            {"original_answer": "Bizet",
                             "answer": ["Bizet"],
                             "provenance": [{"title": ["Bizet"]}]}]}
    for label, cli in (("jax", jax_cli), ("port", port)):
        d = tmp_path / label
        Dataset.from_dict(articles).save_to_disk(str(d / "articles"))
        Dataset.from_dict(questions).save_to_disk(str(d / "questions"))
        cli(["passages", d / "articles", d / "passages", "--config",
             write(tmp_path / "passages.json",
                   {"method": "uniform_sents", "n": 4})])
        cli(["mapping", d / "articles", "wikipedia_title",
             "title2index.json", "--inverse"])
        cli(["mapping", d / "passages", "index", "article2passage.json",
             "--one2many"])
        cli(["relevant", d / "questions", d / "passages",
             d / "articles" / "title2index.json", "--article2passage",
             d / "passages" / "article2passage.json"])
    assert capsys.readouterr().out.count("Dataset") == 2
    for name in ("articles", "passages", "questions"):
        a = load_from_disk(str(tmp_path / "jax" / name))
        b = load_from_disk(str(tmp_path / "port" / name))
        assert a.to_dict() == b.to_dict(), name
    for path in ("articles/title2index.json",
                 "passages/article2passage.json"):
        assert (tmp_path / "port" / path).read_text() == \
            (tmp_path / "jax" / path).read_text()
    assert any(load_from_disk(str(tmp_path / "port" / "questions"))[
        "provenance_indices"])


def test_cli_sentences_face_box_infoseek(tmp_path, capsys, monkeypatch):
    """The aux host commands (tests/test_cli_aux.py's cases) print and
    write the same in both packages."""
    from datasets import Dataset, load_from_disk
    from PIL import Image

    (tmp_path / "imgs").mkdir()
    Image.new("RGB", (200, 100)).save(tmp_path / "imgs" / "im0.jpg")
    monkeypatch.setenv("VIQUAE_IMAGES_PATH", str(tmp_path / "imgs"))
    refs = [{"data_id": "i0", "question_type": "String",
             "answer_eval": ["paris"]},
            {"data_id": "i1", "question_type": "Numerical",
             "answer_eval": [1.0, 3.0]}]
    preds = [{"data_id": "i0", "prediction": "Paris"},
             {"data_id": "i1", "prediction": "7"}]
    (tmp_path / "refs.jsonl").write_text("\n".join(map(json.dumps, refs)))
    (tmp_path / "preds.jsonl").write_text("\n".join(map(json.dumps, preds)))
    printed = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        d = tmp_path / label
        Dataset.from_dict({"text": [
            "First sentence here. Second one! A third?"]}).save_to_disk(
            str(d / "text"))
        Dataset.from_list([{
            "image": "im0.jpg", "face_box": [[20.0, 10.0, 120.0, 60.0]],
            "face_landmarks": [[[40.0, 20.0], [80.0, 20.0], [60.0, 30.0],
                                [50.0, 45.0], [70.0, 45.0]]],
        }]).save_to_disk(str(d / "faces"))
        cli(["sentences", d / "text"])
        cli(["face-box", d / "faces"])
        cli(["infoseek", tmp_path / "preds.jsonl", tmp_path / "refs.jsonl"])
        printed[label] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert json.loads(printed["port"].splitlines()[-1])["score"] == 50.0
    for name in ("text", "faces"):
        assert load_from_disk(str(tmp_path / "port" / name)).to_dict() == \
            load_from_disk(str(tmp_path / "jax" / name)).to_dict()


# --------------------------------------------------------------------------
# evqa (Exact Match, BEM) and the kilt2vqa chain
# --------------------------------------------------------------------------
EVQA_BERT = {"vocab_size": 40, "hidden_size": 16, "num_hidden_layers": 1,
             "num_attention_heads": 2, "intermediate_size": 32,
             "max_position_embeddings": 64, "type_vocab_size": 3,
             "add_pooler": True}


def _evqa_files(tmp_path):
    preds = {"q0": "w1", "q1": "w5", "q2": "two", "q3": "w7 and w8",
             "q4": "w3", "q5": "w11 w12", "q6": "w9"}
    refs = {"q0": {"reference": "w1", "question": "what?"},
            "q1": {"reference": "w9", "question": "which?"},
            "q2": {"reference": "2", "question": "how many?"},
            "q3": {"reference": "w7&&w8", "question": "who?",
                   "question_type": "multi_answer"},
            "q4": {"reference": "w2|w4", "question": "where?"},
            "q5": {"reference": "w13 w14", "question": "w15 w16 w17"},
            "q6": {"reference": "w10 w12", "question": "w18"}}
    write(tmp_path / "pred.json", preds)
    write(tmp_path / "ref.json", refs)
    return tmp_path / "pred.json", tmp_path / "ref.json"


def test_cli_evqa_exact_match(ws, tmp_path, capsys):
    pred, ref = _evqa_files(tmp_path)
    printed = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        cli(["evqa", pred, ref])
        printed[label] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert json.loads(printed["port"]) == {"accuracy": 3 / 7,
                                           "n_evaluated": 7}


def test_cli_evqa_bem_on_exported_params(ws, tmp_path, capsys):
    """``evqa --scorer bem`` in both packages on one export directory of
    BEM weights: EM hits short-circuit, the misses go through the BEM
    forward one example at a time; the same accuracy, and a BEM that
    decides (some misses rescued, not all)."""
    from viquae_torch.models import bem as tbem
    from viquae_tpu.models import bem as jbem
    from viquae_tpu.models import bert as jbert

    from torch_helpers import perturbed

    cfg = jbem.BEMConfig(bert=jbert.BertConfig(**EVQA_BERT), max_length=64)
    tree = perturbed(jax.tree.map(np.asarray, jbem.init(
        jax.random.key(5), cfg)), seed=11, scale=0.4)
    export_params(tmp_path / "bem", tree)
    config = write(tmp_path / "bem.json", {
        "tokenizer": str(ws / "tok"), "params": str(tmp_path / "bem"),
        "bem_config": {"bert_config": EVQA_BERT, "max_length": 64}})
    pred, ref = _evqa_files(tmp_path)
    printed = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        cli(["evqa", pred, ref, "--scorer", "bem", "--config", config])
        printed[label] = json.loads(capsys.readouterr().out)
    assert printed["port"] == printed["jax"]
    assert 3 / 7 < printed["port"]["accuracy"] < 1.0
    # the port's scorer on the misses, against the JAX one's probabilities
    from transformers import BertTokenizerFast

    tok = BertTokenizerFast(vocab_file=str(ws / "tok" / "vocab.txt"),
                            do_lower_case=True)
    examples = [{"candidate": "w5", "reference": "w9", "question": "which?"},
                {"candidate": "w11 w12", "reference": "w13 w14",
                 "question": "w15 w16 w17"}]
    tcfg = tbem.BEMConfig(bert=tbert.BertConfig(**EVQA_BERT), max_length=64)
    ours = tbem.BEMScorer(tcfg, tbem.from_jax(tree, tcfg, device="cpu"),
                          tok, max_length=64, device="cpu").score(examples)
    theirs = jbem.BEMScorer(cfg, jax.tree.map(jax.numpy.asarray, tree), tok,
                            max_length=64).score(examples)
    np.testing.assert_allclose(ours, theirs, atol=1e-5)


def test_cli_evqa_bem_with_seeded_weights(ws, tmp_path, capsys):
    """tests/test_server.py's ``evqa --scorer bem`` case on the port: no
    ``params``, seeded weights (not JAX's values); the protocol runs, q0
    is an EM hit whatever BEM says."""
    write(tmp_path / "pred.json", {"q0": "w1", "q1": "w5"})
    write(tmp_path / "ref.json", {
        "q0": {"reference": "w1", "question": "what?"},
        "q1": {"reference": "w9", "question": "which?"}})
    write(tmp_path / "bem.json", {
        "tokenizer": str(ws / "tok"),
        "bem_config": {"bert_config": EVQA_BERT, "max_length": 64}})
    port(["evqa", tmp_path / "pred.json", tmp_path / "ref.json",
          "--scorer", "bem", "--config", tmp_path / "bem.json"])
    out = json.loads(capsys.readouterr().out)
    assert out["n_evaluated"] == 2
    assert 0.5 <= out["accuracy"] <= 1.0


def _kilt_workspace(root):
    """tests/test_cli_aux.py's kilt2vqa workspace: two KILT-TriviaQA
    questions and their three Wikipedia articles."""
    from datasets import Dataset

    Dataset.from_list([
        {"id": "q0", "input": "Who married Ada Lovelace?",
         "output": {"original_answer": "William King", "provenance": [
             {"wikipedia_id": ["1"], "title": ["Ada Lovelace"]},
             {"wikipedia_id": ["2"], "title": ["Mathematics"]}]}},
        {"id": "q1", "input": "Who composed the opera Carmen?",
         "output": {"original_answer": "Georges Bizet", "provenance": [
             {"wikipedia_id": ["3"], "title": ["Carmen"]}]}},
    ]).save_to_disk(str(root / "questions"))
    Dataset.from_list([
        {"wikipedia_id": "1", "wikipedia_title": "Ada Lovelace",
         "wikidata_info": {"wikidata_id": "Q7259",
                           "aliases": {"alias": ["ada king"]}}},
        {"wikipedia_id": "2", "wikipedia_title": "Mathematics",
         "wikidata_info": {"wikidata_id": "Q395",
                           "aliases": {"alias": []}}},
        {"wikipedia_id": "3", "wikipedia_title": "Carmen",
         "wikidata_info": {"wikidata_id": "Q185968",
                           "aliases": {"alias": ["carmen opera"]}}},
    ]).save_to_disk(str(root / "wikipedia"))
    return root


def _enrich_entities(path):
    """The counted entities with what wiki.py would add (gender,
    occupation, heuristics-scored images), as tests/test_cli_aux.py."""
    entities = json.loads(path.read_text())
    entities["Q7259"].update({
        "gender": {"value": "http://www.wikidata.org/entity/Q6581072"},
        "instanceof": {"http://www.wikidata.org/entity/Q5": {}},
        "occupation": {"Q121594": {"label": {"value": "mathematician"}}},
        "images": {"File:Ada.jpg": {"heuristics": {"title": True}}},
    })
    entities["Q185968"].update({
        "instanceof": {"http://www.wikidata.org/entity/Q1344": {}},
        "instanceofLabel": {"Q1344": {"value": "opera"}},
        "images": {"File:Carmen.jpg": {"heuristics": {"title": True}}},
    })
    path.write_text(json.dumps(entities))


def test_cli_kilt2vqa_chain(tmp_path, capsys):
    """ner (title gazetteer) -> ned -> count-entities -> generate-mentions
    -> generate-vq -> labelstudio in both packages on the same workspace:
    the same datasets, files and printed counts at every step."""
    from datasets import load_from_disk

    printed = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        d = _kilt_workspace(tmp_path / label)
        ner_cfg = write(d / "ner.json", {"titles": str(d / "wikipedia"),
                                         "title_key": "wikipedia_title"})
        lines = []

        def run(argv):
            cli(argv)
            out = json.loads(capsys.readouterr().out)
            out.pop("saved", None)
            lines.append(out)

        run(["kilt2vqa", "ner", d / "questions", "--output", d / "ner_out",
             "--config", ner_cfg])
        run(["kilt2vqa", "ned", d / "ner_out", "--output", d / "ned_out",
             "--wikipedia", d / "wikipedia"])
        run(["kilt2vqa", "count-entities", d / "ned_out", "--output",
             d / "entities.json"])
        _enrich_entities(d / "entities.json")
        run(["kilt2vqa", "generate-mentions", d / "ned_out", "--output",
             d / "mention_out", "--entities", d / "entities.json"])
        run(["kilt2vqa", "generate-vq", d / "mention_out", "--output",
             d / "vq_out", "--entities", d / "entities.json"])
        run(["kilt2vqa", "labelstudio", d / "vq_out", "--output",
             d / "tasks.json"])
        printed[label] = lines
    assert printed["port"] == printed["jax"]
    assert printed["port"][0]["items"] == 2
    for name in ("ner_out", "ned_out", "mention_out", "vq_out"):
        assert load_from_disk(str(tmp_path / "port" / name)).to_list() == \
            load_from_disk(str(tmp_path / "jax" / name)).to_list(), name
    for name in ("entities.json", "tasks.json"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text(), name
    vq = load_from_disk(str(tmp_path / "port" / "vq_out"))
    generated = {v["input"] for item in vq for v in item["vq"]}
    assert "Who married this woman?" in generated
    assert "Who composed this opera?" in generated


def test_cli_kilt2vqa_download_without_the_network(tmp_path, capsys,
                                                  monkeypatch):
    """``kilt2vqa download`` in both packages with the one network call
    (``wiki.request``) replaced: the same shard of images written, a
    failed file warned about and skipped, the same count printed."""
    import types

    from datasets import Dataset

    import viquae_torch.data.wiki as twiki
    import viquae_tpu.data.wiki as jwiki

    def fake_request(url, session=None, **kwargs):
        if "bad" in url:
            raise RuntimeError(f"{url}: no egress")
        return types.SimpleNamespace(content=url.encode())

    for module in (twiki, jwiki):
        monkeypatch.setattr(module, "request", fake_request)
    items = [{"vq": [{"image": f"File {i}.jpg",
                      "url": f"http://x/{'bad' if i == 3 else i}"}]}
             for i in range(6)]
    Dataset.from_list(items).save_to_disk(str(tmp_path / "vq"))
    printed, files = {}, {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        root = tmp_path / f"images_{label}"
        with pytest.warns(UserWarning, match="no egress"):
            cli(["kilt2vqa", "download", tmp_path / "vq", "--save-root",
                 root, "--num-shards", 2, "--shard-index", 1])
        printed[label] = capsys.readouterr().out
        files[label] = {f.name: f.read_bytes() for f in root.iterdir()}
    assert printed["port"] == printed["jax"]
    assert json.loads(printed["port"]) == {"downloaded": 2}
    assert files["port"] == files["jax"] == {
        "File_1.jpg": b"http://x/1", "File_5.jpg": b"http://x/5"}


def test_cli_kilt2vqa_requires_its_inputs(tmp_path):
    for argv, flag in ((["ned", "ds"], "--wikipedia"),
                       (["count-entities", "ds"], "--output"),
                       (["generate-vq", "ds"], "--entities")):
        with pytest.raises(SystemExit, match=flag):
            port(["kilt2vqa", *argv])


@pytest.fixture(scope="module")
def ner_dir(tmp_path_factory):
    """tests/test_cli_aux.py's tiny HF BertForTokenClassification
    directory (saved by HF, model.safetensors) with its tokenizer."""
    from transformers import BertConfig as HFBertConfig
    from transformers import BertForTokenClassification, BertTokenizerFast

    root = tmp_path_factory.mktemp("ner")
    torch.manual_seed(0)
    id2label = {0: "O", 1: "B-PER", 2: "I-PER"}
    hf_cfg = HFBertConfig(
        vocab_size=40, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32, num_labels=3, id2label=id2label,
        label2id={v: k for k, v in id2label.items()})
    model = BertForTokenClassification(hf_cfg).eval()
    with torch.no_grad():  # label margins well above f32 reordering
        model.classifier.weight.mul_(40.0)
    mdir = root / "ner_model"
    model.save_pretrained(mdir)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "who",
             "married", "composed", "the", "opera", "carmen", "ada",
             "lovelace", "?"] + [f"w{i}" for i in range(26)]
    (mdir / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(mdir / "vocab.txt"),
                      do_lower_case=True).save_pretrained(mdir)
    return mdir


@pytest.mark.parametrize("dtype", [None, "float32"],
                         ids=["default_bf16", "f32"])
def test_cli_kilt2vqa_ner_neural(ner_dir, tmp_path, capsys, dtype):
    """``kilt2vqa ner`` with a ``neural`` block loads the HF directory into
    the port's NeuralNER. In f32 the placeholders equal the JAX CLI's; at
    the default bf16 compute the command runs as tests/test_cli_aux.py
    asks (a placeholder column for both questions; bf16 labels are held to
    JAX under the margin rule in tests/test_torch_ner.py)."""
    from datasets import load_from_disk

    neural = {"path": str(ner_dir), "max_length": 16, "batch_size": 2}
    if dtype:
        neural["compute_dtype"] = dtype
    cfg = write(tmp_path / "ner_neural.json", {"neural": neural})
    clis = (("jax", jax_cli), ("port", port)) if dtype else (("port", port),)
    out = {}
    for label, cli in clis:
        d = _kilt_workspace(tmp_path / label)
        cli(["kilt2vqa", "ner", d / "questions", "--output", d / "ner_out",
             "--config", cfg])
        assert json.loads(capsys.readouterr().out)["items"] == 2
        out[label] = load_from_disk(str(d / "ner_out")).to_list()
        assert "placeholder" in out[label][0]
    if dtype:
        assert out["port"] == out["jax"]
        assert any(item["placeholder"] for item in out["port"])


# --------------------------------------------------------------------------
# image and face stages
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def img_ws(tmp_path_factory):
    """Three random RGB images of several sizes and a dataset naming them."""
    from datasets import Dataset
    from PIL import Image

    root = tmp_path_factory.mktemp("img")
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i, (h, w) in enumerate(((100, 80), (64, 96), (130, 130))):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                        "RGB").save(root / "imgs" / f"im{i}.png")
        names.append(f"im{i}.png")
    Dataset.from_dict({"image": names}).save_to_disk(str(root / "ds"))
    return root


def _copy_ds(img_ws, tmp_path, label):
    shutil.copytree(img_ws / "ds", tmp_path / label)
    return tmp_path / label


def test_cli_resize(img_ws, tmp_path, capsys):
    printed = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        cli(["resize", img_ws / "ds", img_ws / "imgs", tmp_path / label,
             "--size", 48])
        printed[label] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] == "resized 3 images\n"
    assert _dir_files(tmp_path / "port") == _dir_files(tmp_path / "jax")


def test_cli_embed_image(img_ws, tmp_path, monkeypatch):
    """embed-image: CLIP ViT from an HF CLIPModel state dict and
    ImageNet-RN50 from a torchvision-layout one (the same files for both
    packages); then the HF alias conflict refused."""
    from transformers import CLIPConfig, CLIPModel

    from test_torch_image_models import _torchvision_state_dict
    from viquae_torch.models import resnet as tresnet
    from torch_helpers import jax_tree, randomize_batch_norm_

    monkeypatch.setenv("VIQUAE_IMAGES_PATH", str(img_ws / "imgs"))
    vision = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                  intermediate_size=32, image_size=32, patch_size=16)
    hf = CLIPModel(CLIPConfig(
        text_config=dict(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32,
                         max_position_embeddings=16),
        vision_config=vision, projection_dim=8)).eval()
    torch.save(hf.state_dict(), tmp_path / "clip.pt")
    rcfg = tresnet.ResNetConfig(stage_sizes=(1, 1), width=8)
    tree = jax_tree(randomize_batch_norm_(tresnet.init(rcfg, seed=0,
                                                       device="cpu")))
    torch.save(_torchvision_state_dict(tree, rcfg), tmp_path / "rn.pt")
    configs = {
        "clip": {"model": "clip-vit", "weights": str(tmp_path / "clip.pt"),
                 "model_config": {**vision, "projection_dim": 8},
                 "save_as": "clip", "image_size": 32, "batch_size": 2},
        "imagenet": {"model": "imagenet-RN50",
                     "weights": str(tmp_path / "rn.pt"),
                     "model_config": {"stage_sizes": [1, 1], "width": 8},
                     "save_as": "imagenet", "image_size": 32,
                     "batch_size": 2},
    }
    for name, config in configs.items():
        for label, cli in (("jax", jax_cli), ("port", port)):
            cfg = write(tmp_path / f"{name}_{label}.json", config)
            ds = (tmp_path / label if name != "clip"
                  else _copy_ds(img_ws, tmp_path, label))
            cli(["embed-image", ds, cfg])
        got = _embedding(tmp_path / "port", name)
        assert got.shape[0] == 3
        _close(got, _embedding(tmp_path / "jax", name), 1e-4)

    bad = dict(configs["clip"], model_config={**vision, "num_layers": 3,
                                              "projection_dim": 8})
    with pytest.raises(ValueError, match="num_hidden_layers"):
        port(["embed-image", img_ws / "ds", write(tmp_path / "bad.json",
                                                  bad)])


def test_cli_faces_and_face_embed(img_ws, tmp_path, monkeypatch):
    """faces (MTCNN from a facenet-layout checkpoint, thresholds 0 so the
    seeded cascade keeps candidates) then face-embed (ArcFace from an
    insightface-layout checkpoint) on the same files in both packages:
    the same detections (probabilities within 1e-4, boxes and landmarks
    within 1e-2 px, as tests/test_torch_face.py) and, from the same
    detections, embeddings within 1e-4 of their scale."""
    from viquae_torch.models import arcface as tarc
    from viquae_torch.models import mtcnn as tm
    from torch_helpers import jax_tree, randomize_batch_norm_

    monkeypatch.setenv("VIQUAE_IMAGES_PATH", str(img_ws / "imgs"))
    sd = {k: torch.from_numpy(v) for k, v in convert.state_dict_from_tree(
        jax_tree(tm.init(seed=3, device="cpu"))).items()}
    torch.save(sd, tmp_path / "mtcnn.pt")
    acfg = {"stage_sizes": [1, 1, 1, 1], "width": 8, "embedding_size": 16}
    atree = jax_tree(randomize_batch_norm_(tarc.init(
        tarc.ArcFaceConfig(stage_sizes=(1, 1, 1, 1), width=8,
                           embedding_size=16), seed=4, device="cpu"),
        seed=9))
    asd = {}
    for name, a in convert.state_dict_from_tree(atree).items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer{int(parts[1]) + 1}", parts[2]] + parts[3:]
        name = (".".join(parts).replace("downsample_conv", "downsample.0")
                .replace("downsample_bn", "downsample.1")
                .replace("features_bn", "features"))
        asd[name] = torch.from_numpy(a)
    torch.save(asd, tmp_path / "arcface.pt")
    faces_cfg = write(tmp_path / "faces.json", {
        "weights": str(tmp_path / "mtcnn.pt"),
        "mtcnn": {"canvas": 128, "min_face_size": 40, "max_faces": 2,
                  "k_per_scale": 8, "k_stage1": 16, "k_stage2": 8,
                  "thresholds": [0.0, 0.0, 0.0]},
        "batch_size": 2})
    embed_cfg = write(tmp_path / "embed.json", {
        "weights": str(tmp_path / "arcface.pt"), "arcface": acfg,
        "batch_size": 2})
    from datasets import load_from_disk

    out = {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        ds = _copy_ds(img_ws, tmp_path, label)
        cli(["faces", ds, "--config", faces_cfg])
        out[label] = load_from_disk(str(ds)).to_dict()
    # face-embed on the JAX package's detections in both packages: a
    # landmark 1e-3 px apart moves the aligned crop, not the tower
    for label, cli in (("jax", jax_cli), ("port", port)):
        ds = tmp_path / f"embed_{label}"
        shutil.copytree(tmp_path / "jax", ds)
        cli(["face-embed", ds, "--config", embed_cfg])
        out[f"embed_{label}"] = load_from_disk(str(ds)).to_dict()
    assert out["port"].keys() == out["jax"].keys()
    assert "face_embedding" in out["embed_port"]
    for col, atol in (("face_prob", 1e-4), ("face_box", 1e-2),
                      ("face_landmarks", 1e-2)):
        for a, b in zip(out["jax"][col], out["port"][col]):
            assert (a is None) == (b is None), col
            if a is not None:
                np.testing.assert_allclose(np.asarray(b, np.float64),
                                           np.asarray(a, np.float64),
                                           rtol=0, atol=atol, err_msg=col)
    got = [np.asarray(e, np.float32)
           for e in out["embed_port"]["face_embedding"] if e is not None]
    ref = [np.asarray(e, np.float32)
           for e in out["embed_jax"]["face_embedding"] if e is not None]
    assert len(got) == len(ref) > 0
    _close(np.concatenate(got), np.concatenate(ref), 1e-4)


# --------------------------------------------------------------------------
# train / save-ptm
# --------------------------------------------------------------------------
TRAIN_BCFG = dict(BCFG, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def train_ws(tmp_path_factory, ws):
    """Questions (with provenance / irrelevant passage ids) over ``ws``'s
    KB, the two DPR towers as export dirs (drawn by the port at std 0.2,
    so that the tiny towers' embeddings differ) and an HF-layout reader
    directory: both packages load the same weights."""
    from datasets import Dataset

    from viquae_torch.models import dpr as tdpr
    from viquae_torch.models import qa as tqa
    from viquae_torch.models.layers import init_weights_
    from viquae_torch.train.checkpoint import export_params as texport

    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(1)
    rows = []
    for i in range(8):
        rel = [int(i)]
        rows.append({
            "id": f"q{i}", "input": f"w{i} w{i + 1} w{i + 2}",
            "output": {"original_answer": f"w{i + 3}",
                       "answer": [f"w{i + 3}"]},
            "search_provenance_indices": rel,
            "search_irrelevant_indices": [int(j) for j in
                                          rng.choice(np.arange(8, 40), 3,
                                                     replace=False)],
            "search_indices": rel + [int(j) for j in rng.choice(
                np.arange(8, 40), 2, replace=False)],
            "search_scores": [3.0, 2.0, 1.0],
        })
    Dataset.from_list(rows).save_to_disk(str(root / "questions"))
    cfg = tdpr.DPRConfig(bert=tbert.BertConfig(**TRAIN_BCFG))
    for seed, name in ((5, "question"), (6, "context")):
        tower = init_weights_(tdpr.init(cfg, seed, device="cpu"), seed,
                              linear_std=0.2, embed_std=0.2, truncated=True)
        texport(root / name, convert.tree_from_module(tower))
    rcfg = tqa.MultiPassageBERTReader.config(READER_BCFG)
    reader = init_weights_(tqa.init(rcfg, 7, device="cpu"), 7,
                           linear_std=0.2, embed_std=0.2, truncated=True)
    sd = tbert.params_to_hf_state_dict(reader.bert, rcfg.bert,
                                       prefix="bert.")
    sd["qa_outputs.weight"] = reader.qa_outputs.weight.detach().clone()
    sd["qa_outputs.bias"] = reader.qa_outputs.bias.detach().clone()
    (root / "reader").mkdir()
    torch.save(sd, root / "reader" / "pytorch_model.bin")
    (root / "reader" / "config.json").write_text(json.dumps({
        **READER_BCFG, "hidden_act": "gelu", "layer_norm_eps": 1e-12,
        "type_vocab_size": 2, "model_type": "bert",
        "architectures": ["BertModel"]}))
    return root


def biencoder_config(ws, train_ws, out, max_steps=4, **trainer):
    def tower(name):
        return {"class_name": "DPREncoder", "bert_config": TRAIN_BCFG,
                "pretrained_model_name_or_path": str(train_ws / name)}

    return {
        "seed": 3,
        "trainee": {"kind": "biencoder", "question_model": tower("question"),
                    "context_model": tower("context")},
        "data": {"tokenizer": str(ws / "tok"),
                 "dataset": str(train_ws / "questions"),
                 "kb": str(ws / "kb"), "M": 2, "batch_size": 4,
                 "max_length": 16, "packed": True},
        "optimizer": {"lr": 5e-3, "warmup_steps": 2, "total_steps": 10,
                      "grad_clip": 1.0},
        "trainer": {"max_steps": max_steps, "log_every": 1,
                    "ckpt_every": 2, "ckpt_dir": str(out / "ckpt"),
                    **trainer},
        "export": str(out / "export"),
    }


def losses(ckpt_dir):
    lines = (ckpt_dir / "log.jsonl").read_text().splitlines()
    return [json.loads(x)["loss"] for x in lines
            if "loss" in json.loads(x)]


def test_cli_train_fit_matches_jax(ws, train_ws, tmp_path, capsys):
    """``train fit`` on the same config, data and weights in both
    packages: the same loss history (1e-4 relative over 4 AdamW steps with
    warmup and clipping), checkpoints under the ckpt dir, and export
    directories that load in the other package."""
    from viquae_torch.models import dpr as tdpr
    from viquae_tpu.models import bert as jbert
    from viquae_tpu.models import dpr as jdpr
    from viquae_tpu.train.checkpoint import import_params

    for label, cli in (("jax", jax_cli), ("port", port)):
        cfg = write(tmp_path / f"{label}.json",
                    biencoder_config(ws, train_ws, tmp_path / label))
        cli(["train", "fit", cfg])
    capsys.readouterr()
    got, ref = losses(tmp_path / "port" / "ckpt"), losses(
        tmp_path / "jax" / "ckpt")
    assert len(got) == len(ref) == 4
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert (tmp_path / "port" / "ckpt" / "step_4" / "state.pt").exists()
    template = jdpr.init(jax.random.key(0), jdpr.DPRConfig(
        bert=jbert.BertConfig(**TRAIN_BCFG)))
    for name in ("question_model", "context_model"):
        import_params(tmp_path / "port" / "export" / name, template)
        tdpr.DPREncoder.from_pretrained(
            tmp_path / "jax" / "export" / name, device="cpu",
            bert_config=TRAIN_BCFG)


def test_cli_train_resume_validate_test_and_save_ptm(ws, train_ws, tmp_path,
                                                     capsys):
    """``fit --ckpt-path`` resumes: 4 then 6 steps equal an uninterrupted
    6-step run bitwise; ``validate`` and ``test`` (a biencoder has no test
    protocol: both evaluate) print the JAX CLI's ``test`` metrics for the
    same weights; ``save-ptm`` writes the towers of the last checkpoint,
    equal to ``fit``'s export."""
    straight = write(tmp_path / "straight.json", biencoder_config(
        ws, train_ws, tmp_path / "straight", max_steps=6))
    port(["train", "fit", straight])
    first = biencoder_config(ws, train_ws, tmp_path / "resumed")
    port(["train", "fit", write(tmp_path / "first.json", first)])
    ckpt = tmp_path / "resumed" / "ckpt"
    first["trainer"]["max_steps"] = 6
    del first["trainer"]["ckpt_dir"]
    port(["train", "fit", write(tmp_path / "second.json", first),
          "--ckpt-path", ckpt])
    capsys.readouterr()
    assert losses(ckpt) == losses(tmp_path / "straight" / "ckpt")
    for name in ("question_model", "context_model"):
        a = np.load(tmp_path / "straight" / "export" / name / "params.npz")
        b = np.load(tmp_path / "resumed" / "export" / name / "params.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])

    port(["save-ptm", straight, tmp_path / "ptm"])
    saved = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert saved["step"] == 6 and len(saved["exported"]) == 2
    for name in ("question_model", "context_model"):
        a = np.load(tmp_path / "ptm" / name / "params.npz")
        b = np.load(tmp_path / "straight" / "export" / name / "params.npz")
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])

    evals = {}
    cfg = biencoder_config(ws, train_ws, tmp_path / "eval")
    del cfg["trainer"]["ckpt_dir"]
    cfg = write(tmp_path / "eval.json", cfg)
    for label, cli, sub in (("jax", jax_cli, "test"),
                            ("validate", port, "validate"),
                            ("test", port, "test")):
        capsys.readouterr()
        cli(["train", sub, cfg])
        line = capsys.readouterr().out.strip().splitlines()[-1]
        evals[label] = eval(line, {"nan": float("nan")})
    assert set(evals["validate"]) == set(evals["jax"]) >= {"loss",
                                                          "MRR@N*M"}
    assert evals["validate"] == evals["test"]
    for k, v in evals["jax"].items():
        assert evals["validate"][k] == pytest.approx(v, rel=1e-5), k


def test_cli_train_test_reader_matches_jax(ws, train_ws, tmp_path, capsys):
    """``train test`` of a reader initialised from an HF directory
    (``pretrained:``): the same metrics.json and predictions.json as the
    JAX CLI."""
    for label, cli in (("jax", jax_cli), ("port", port)):
        cfg = write(tmp_path / f"{label}.json", {
            "seed": 0,
            "trainee": {"kind": "reader", "m_passages": 2,
                        "pretrained": str(train_ws / "reader"),
                        "bert_config": READER_BCFG},
            "data": {"tokenizer": str(ws / "tok"),
                     "dataset": str(train_ws / "questions"),
                     "kb": str(ws / "kb"), "collator": "reader", "M": 2,
                     "batch_size": 4, "max_length": 24,
                     "max_n_answers": 2, "train": False},
            "export": str(tmp_path / label),
        })
        cli(["train", "test", cfg])
    capsys.readouterr()
    for name in ("metrics.json", "predictions.json"):
        got = json.loads((tmp_path / "port" / name).read_text())
        assert got == json.loads((tmp_path / "jax" / name).read_text()), name
    assert len(json.loads(
        (tmp_path / "port" / "predictions.json").read_text())) == 8


# --------------------------------------------------------------------------
# the host-only data, annotation and viz commands, through both CLIs
# --------------------------------------------------------------------------
def _ds(path, rows=None, columns=None):
    from datasets import Dataset

    ds = Dataset.from_list(rows) if rows is not None \
        else Dataset.from_dict(columns)
    ds.save_to_disk(str(path))
    return path


def _wiki_case(tmp, monkeypatch):
    """``wiki feminine`` with ``wiki.request`` answering the SPARQL query
    (no network), then ``filter`` and ``heuristics`` offline."""
    import types

    import viquae_torch.data.wiki as twiki
    import viquae_tpu.data.wiki as jwiki

    bindings = [{"entity": {"value": "http://www.wikidata.org/entity/Q33999"},
                 "entity_female_label": {"value": "actress"}}]

    def fake_request(url, session=None, **kwargs):
        return types.SimpleNamespace(
            json=lambda: {"results": {"bindings": bindings}})

    for module in (twiki, jwiki):
        monkeypatch.setattr(module, "request", fake_request)
    human = "http://www.wikidata.org/entity/Q5"
    entities = {
        "Q1": {"instanceof": {human: {}}, "occupation": {
            "http://www.wikidata.org/entity/Q33999": {}},
            "dateofdeath": {"value": "1900-01-01T00:00:00Z"},
            "titles": ["Ada"], "categories": ["Ada Lovelace"]},
        "Q2": {"instanceof": {human: {}}, "titles": ["Bob"]},
        "Q3": {"instanceof": {"http://www.wikidata.org/entity/Q515": {}},
               "titles": ["Paris"]},
    }

    def steps(out):
        subset = out / "subset"
        subset.mkdir()
        (subset / "entities.json").write_text(json.dumps(entities))
        return [["wiki", "feminine", subset],
                ["wiki", "filter", subset, "--deceased", 1950, "Q515"],
                ["wiki", "heuristics", subset]]
    return steps


def _wikidump_case(tmp, monkeypatch):
    (tmp / "dump.xml").write_text(
        '<mediawiki xmlns="http://www.mediawiki.org/xml/export-0.10/">'
        "<page><ns>6</ns><title>File:Ada.jpg</title><revision><text>\n"
        "{{Information\n|description = Portrait of Ada\n}}\n"
        "[[Category:Ada Lovelace]]\n</text></revision></page></mediawiki>")
    (tmp / "cats.json").write_text(json.dumps(
        {"Q7259": {"categories": ["Ada Lovelace"]}}))
    return lambda out: [["wikidump", tmp / "dump.xml", tmp / "cats.json",
                         out / "images.json"]]


def _wit_case(tmp, monkeypatch):
    import csv

    rows = [{"language": "en", "page_title": f"Article{a}",
             "section_title": f"S{s}", "image_url": f"http://x/i_{a}_{s}.jpg",
             "context_section_description": f"text {a} {s}",
             "caption_reference_description": f"cap {a} {s}"}
            for a in range(10) for s in range(3)]
    with open(tmp / "wit.tsv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
        writer.writeheader()
        writer.writerows(rows)
    return lambda out: [["wit", tmp / "wit.tsv", out / "mict"]]


def _labelstudio_case(tmp, monkeypatch):
    keep = {"from_name": "discard", "value": {"choices": ["keep"]}}
    drop = {"from_name": "discard", "value": {"choices": ["discard"]}}
    (tmp / "a.json").write_text(json.dumps([
        {"id": 1, "data": {"question": "q1", "answer": "a1"},
         "annotations": [{"result": [keep]}]}]))
    (tmp / "b.json").write_text(json.dumps([
        {"id": 1, "data": {"question": "q1", "answer": "a1"},
         "annotations": [{"result": [keep]}]},
        {"id": 2, "data": {"question": "q2", "answer": "a2"},
         "annotations": [{"result": [drop]}]}]))
    return lambda out: [
        ["labelstudio", "merge", tmp / "a.json", tmp / "b.json",
         "--output", out / "merged.json"],
        ["labelstudio", "agreement", out / "merged.json"],
        ["labelstudio", "vqa", out / "merged.json", "--output",
         out / "vqa.json"],
        ["labelstudio", "assign", out / "merged.json", "--n-annotators", 2,
         "--overlap", 1, "--output", out / "assign.json"]]


def _mscelebs_case(tmp, monkeypatch):
    import base64

    face = base64.b64encode(b"JPEGDATA")
    (tmp / "faces.tsv").write_bytes(
        b"m.0abc\timg1\t" + face + b"\nm.0def\timg2\t" + face + b"\n")
    (tmp / "entities.json").write_text(json.dumps(
        {"Q1": {"freebase": {"value": "/m/0abc"}}}))
    return lambda out: [
        ["mscelebs", "entities", tmp / "faces.tsv", "--mids",
         tmp / "entities.json", "--output", out / "counts.json"],
        ["mscelebs", "extract", tmp / "faces.tsv", "--mids",
         tmp / "entities.json", "--save-root", out / "faces"]]


def _html_case(tmp, monkeypatch):
    _ds(tmp / "ds", rows=[
        {"id": "q0", "input": "who is this?", "image": "im0.jpg",
         "output": {"original_answer": "Ada"}},
        {"id": "q1", "input": "what is that?", "image": "im1.jpg",
         "output": {"original_answer": "Carmen"}}])
    (tmp / "run.json").write_text(json.dumps(
        {"q0": {"3": 2.0, "1": 1.0}, "q1": {"2": 5.0}}))
    _ds(tmp / "passages", columns={"passage": [f"p{i}" for i in range(4)],
                                   "index": list(range(4))})
    return lambda out: [["html", tmp / "ds", out / "out.html", "--run",
                         tmp / "run.json", "--passages", tmp / "passages",
                         "--n", 2]]


def _plot_case(tmp, monkeypatch):
    rng = np.random.default_rng(0)
    _ds(tmp / "ds", columns={
        "embedding": rng.standard_normal((20, 8)).tolist(),
        "label": ["a"] * 10 + ["b"] * 10})
    return lambda out: [
        ["plot", tmp / "ds", "embedding", "--labels", "label", "--method",
         method, "--output", out / f"{method}.png"]
        for method in ("pca", "umap")]


def _wtl_filter_case(tmp, monkeypatch):
    _ds(tmp / "ds", columns={"id": ["q0", "q1"], "input": ["a", "b"]})
    (tmp / "qrels.json").write_text(json.dumps(
        {"q0": {"d0": 1}, "q1": {"d1": 1}}))
    (tmp / "run.json").write_text(json.dumps(
        {"q0": {"d0": 2.0, "d9": 1.0}, "q1": {"d9": 2.0, "d1": 1.0}}))
    return lambda out: [["wtl-filter", tmp / "ds", tmp / "qrels.json",
                         tmp / "run.json", out / "filtered", "--filter",
                         "win"]]


def _stats_case(tmp, monkeypatch):
    _ds(tmp / "ds", columns={"input": ["a b c", "d e", None],
                             "faces": [[1, 2], [], None]})
    return lambda out: [["stats", tmp / "ds"]]


HOST_CASES = {"wiki": _wiki_case, "wikidump": _wikidump_case,
              "wit": _wit_case, "labelstudio": _labelstudio_case,
              "mscelebs": _mscelebs_case, "html": _html_case,
              "plot": _plot_case, "wtl-filter": _wtl_filter_case,
              "stats": _stats_case}


def _written(out):
    """Every file under ``out`` as bytes, except datasets saved to disk
    (a split of a DatasetDict is one), which are compared by their rows:
    their metadata holds fingerprints. A split saved with no rows has no
    Arrow file to load and counts as empty."""
    from datasets import Dataset

    datasets, files = {}, {}
    for root in sorted(p.parent for p in out.rglob("state.json")):
        datasets[root] = (Dataset.load_from_disk(str(root)).to_dict()
                          if any(root.glob("*.arrow")) else {})
    for f in sorted(out.rglob("*")):
        if f.is_file() and not any(f.is_relative_to(r) for r in datasets):
            files[str(f.relative_to(out))] = f.read_bytes()
    return files, {str(r.relative_to(out)): rows
                   for r, rows in datasets.items()}


@pytest.mark.parametrize("command", sorted(HOST_CASES))
def test_host_commands_match_the_jax_cli(command, tmp_path, capsys,
                                         monkeypatch):
    """Each data-construction, annotation or viz command run through both
    CLIs on the inputs of tests/test_cli_aux.py's case (``stats`` and
    ``wiki`` on their own): the same lines printed (output paths aside)
    and the same files written, byte for byte (datasets by their rows)."""
    steps = HOST_CASES[command](tmp_path, monkeypatch)
    printed, written = {}, {}
    for label, cli in (("jax", jax_cli), ("port", port)):
        out = tmp_path / label
        out.mkdir()
        lines = []
        for argv in steps(out):
            cli(argv)
            lines.append(capsys.readouterr().out.replace(str(out), "OUT"))
        printed[label], written[label] = lines, _written(out)
    assert printed["port"] == printed["jax"]
    assert written["port"] == written["jax"]
    files, datasets = written["port"]
    assert files or datasets or command == "stats"
    if command == "stats":
        assert json.loads(printed["port"][0])["n_items"] == 3
    if command == "wtl-filter":
        assert datasets["filtered"]["id"] == ["q0"]
    if command == "wit":
        assert {name.split("/")[-1] for name in datasets} == {
            "train", "validation", "test"}
        assert sum(len(next(iter(rows.values()), [])) for rows in
                   datasets.values()) == 30
