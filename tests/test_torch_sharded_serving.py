"""Serving on the mesh: a gloo world of 4 processes
(tests/torch_dist_helpers.py) at data = 2 x kb = 2 runs the pipelines of
viquae_torch/ir/serving.py over kb-sharded indexes (and ShardedDeviceBM25)
with the packed encoder split over ``data``, every embedder split over
``data``, and the reference's QA program (__graft_entry__.py:450-596: two
kb-sharded legs, ``fuse_topk`` in gzmuv, host pair assembly, the packed
reader step with its canvas rows split over ``data``). Each is held to the
port's single-device run of the same thing in this process and, for the
sharded fused pipeline, to the JAX one (tests/test_serving.py:199).

Tolerances. The embedders in f32 within 1e-5 relative of the single-device
embedder (each rank packs or pads its own rows, so sums may be taken in
another order). The retrieval ids equal to the single-device run's, the
scores of a pipeline's bf16 output within one bf16 ulp (2**-8 relative):
the kb-sharded search of the same query vectors is exact (f32 modes) or
bit-equal (fused), so the ids can only move where an embedding's last
bits moved a score across a tie, which these seeded inputs do not. The
QA program: the fused ids equal to fuse_topk over the exact top-k of each
leg (the dry run's host reference), the spans equal and the logits within
1e-5 of the single-device reader's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as tdh
from viquae_torch.core import mesh
from viquae_torch.image.embedding import ImageEmbedder
from viquae_torch.ir.embedding import (MMEmbedder, PackedTextEmbedder,
                                       TextEmbedder)
from viquae_torch.ir.serving import (FusedRetrievalPipeline,
                                     HybridRetrievalPipeline,
                                     MultiIndexRetrievalPipeline)
from viquae_torch.models import bert, convert, dpr
from viquae_torch.ops import bm25, mips
from viquae_torch.ops.bm25_device import DeviceBM25
from viquae_torch.ops.fusion import fuse_topk
from viquae_torch.train.data import PreComputedImageFeatures

torch.set_num_threads(2)

REL = 1e-5
BF16_REL = 2.0 ** -8


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("servetok")
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "who", "is",
              "this"] + [f"w{i}" for i in range(2000)])
    (d / "vocab.txt").write_text("\n".join(vocab))
    rng = np.random.default_rng(0)
    queries = [" ".join(f"w{j}" for j in rng.integers(0, 2000,
                                                      rng.integers(4, 15)))
               for _ in range(150)]
    kb = rng.normal(size=(3000, 32)).astype(np.float32)
    passages = [" ".join(f"w{j}" for j in rng.integers(0, 300,
                                                       rng.integers(8, 30)))
                for _ in range(3000)]
    images = [None if i % 4 == 3 else Image.fromarray(rng.integers(
        0, 256, (20 + i, 24, 3), dtype=np.uint8)) for i in range(12)]
    mm_items = []
    for i in range(7):
        words = " ".join(f"w{j}" for j in rng.integers(0, 40,
                                                       rng.integers(1, 9)))
        face = i % 3 != 1
        mm_items.append({
            "input": f"who is {words}",
            "face_embedding": (rng.standard_normal((int(rng.integers(1, 4)),
                                                    8)).tolist()
                               if face else None),
            "face_box": rng.standard_normal((3, 7)).tolist() if face
            else None,
            "clip": rng.standard_normal(10).tolist() if i % 4 != 2
            else None})
    n_kb = 1000
    qa = dict(questions=queries[:16],
              kb=rng.standard_normal((n_kb, 32)).astype(np.float32),
              kb_face=rng.standard_normal((n_kb, 32)).astype(np.float32),
              q_face=rng.standard_normal((16, 32)).astype(np.float32),
              passage_tokens=rng.integers(5, 128, (n_kb, 10)).astype(
                  np.int32), k=10, m=3, row_len=32)
    return dict(vocab=str(d / "vocab.txt"), queries=queries, kb=kb,
                kb_face=rng.normal(size=(3000, 16)).astype(np.float32),
                q_face=rng.normal(size=(150, 16)).astype(np.float32),
                passages=passages, mm_items=mm_items, images=images, qa=qa)


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    return tdh.run_world("serving", 4, tmp_path_factory.mktemp("serving"),
                         **inputs)


@pytest.fixture(scope="module")
def single(inputs):
    """The same models and embedders on one device, no mesh."""
    from transformers import BertTokenizerFast

    tok = BertTokenizerFast(vocab_file=inputs["vocab"])
    cfg, model, rcfg, reader, eca = tdh.serving_models()
    emb = PackedTextEmbedder(dpr.make_packed_apply(cfg), model, tok,
                             row_len=32, batch_size=64,
                             compute_dtype=torch.float32, device="cpu")
    return dict(tok=tok, cfg=cfg, model=model, rcfg=rcfg, reader=reader,
                eca=eca, emb=emb)


def _same_on_every_rank(world, key):
    first = world[0][key]
    for res in world[1:]:
        for a, b in zip(np.atleast_1d(first) if isinstance(first, np.ndarray)
                        else first,
                        np.atleast_1d(res[key]) if isinstance(
                            res[key], np.ndarray) else res[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return first


def _close(got, ref, rel=REL):
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale)


def test_packed_encoder_split_over_data(inputs, world, single):
    got = _same_on_every_rank(world, "embeddings")
    ref = single["emb"].embed_texts(inputs["queries"][:64]).numpy()
    assert got.shape == ref.shape == (64, 32)
    _close(got, ref)


def test_sharded_fused_pipeline(inputs, world, single):
    """tests/test_serving.py:199: a kb-sharded fused index in the pipeline,
    its encoder split over data: the single-device pipeline's ids, and the
    JAX pipeline's (kb = 8 mesh) to its own criterion; each batch issues a
    data gather of the CLS vectors (each rank's (64, 32) block holds those
    whose canvas rows it encodes, zeros elsewhere) and one kb gather of
    candidates."""
    s, i = _same_on_every_rank(world, "fused")
    pipe = FusedRetrievalPipeline(
        single["emb"], mips.DenseIndex(inputs["kb"], mode="fused",
                                       device="cpu"), batch_size=64, k=10)
    ref_s, ref_i = pipe.run_arrays(inputs["queries"])
    np.testing.assert_array_equal(i, ref_i)
    _close(s, ref_s, BF16_REL)
    n_batches = -(-len(inputs["queries"]) // 64)
    assert world[0]["fused_log"] == [
        ("all_gather", "data", 2 * 64 * 32 * 4),
        ("all_gather", "kb", 2 * 3 * 64 * 10 * 4)] * n_batches

    from viquae_tpu.core import mesh as jmesh
    from viquae_tpu.ir.embedding import PackedTextEmbedder as JEmbedder
    from viquae_tpu.ir.serving import FusedRetrievalPipeline as JFused
    from viquae_tpu.models import bert as jbert
    from viquae_tpu.models import dpr as jdpr
    from viquae_tpu.ops import mips as jm

    jcfg = jdpr.DPRConfig(bert=jbert.BertConfig(**tdh.SERVE_BERT))
    params = jax.tree.map(jnp.asarray,
                          convert.tree_from_module(single["model"]))
    ctx = jmesh.make_kb_mesh()
    with jmesh.use(ctx):
        jemb = JEmbedder(jdpr.make_packed_apply(jcfg), params,
                         single["tok"], row_len=32, batch_size=64,
                         compute_dtype=jnp.float32)
        jpipe = JFused(jemb, jm.DenseIndex(inputs["kb"], mesh_ctx=ctx,
                                           mode="fused"),
                       batch_size=64, k=10)
        _, j_i = jpipe.run_arrays(inputs["queries"])
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i, j_i)])
    assert overlap > 0.95, overlap


def test_sharded_hybrid_pipeline(inputs, world, single):
    """HybridRetrievalPipeline over a kb-sharded global index and
    ShardedDeviceBM25 equals the single-device pipeline over DenseIndex
    and DeviceBM25."""
    s, i = _same_on_every_rank(world, "hybrid")
    sparse = DeviceBM25(bm25.BM25Index.build(inputs["passages"], k1=0.5,
                                             b=0.3),
                        n_head=16, l_small=64, q_block=64, device="cpu")
    pipe = HybridRetrievalPipeline(
        single["emb"], mips.DenseIndex(inputs["kb"], mode="global",
                                       device="cpu"), sparse,
        batch_size=64, k=10)
    ref_s, ref_i = pipe.run_arrays(inputs["queries"])
    np.testing.assert_array_equal(i, ref_i)
    _close(s, ref_s, BF16_REL)


def test_sharded_multi_index_pipeline(inputs, world, single):
    s, i = _same_on_every_rank(world, "multi")
    emb = PackedTextEmbedder(dpr.make_packed_apply(single["cfg"]),
                             single["model"], single["tok"], row_len=32,
                             batch_size=48, compute_dtype=torch.float32,
                             device="cpu")
    pipe = MultiIndexRetrievalPipeline(
        emb, {"text": mips.DenseIndex(inputs["kb"], mode="fused",
                                      device="cpu"),
              "face": mips.DenseIndex(inputs["kb_face"], mode="global",
                                      do_l2norm=True, device="cpu")},
        {"text": 0.6, "face": 0.4}, text_index="text", batch_size=48, k=10)
    ref_s, ref_i = pipe.run_arrays(inputs["queries"],
                                   {"face": inputs["q_face"]})
    np.testing.assert_array_equal(i, ref_i)
    _close(s, ref_s, BF16_REL)


def test_text_embedder_split_over_data(inputs, world, single):
    """13 texts, batch 6: batches of 6 rows split 3 + 3, the last batch of
    1 padded; one data gather a batch."""
    got = _same_on_every_rank(world, "text")
    ref = TextEmbedder(lambda p, **kw: bert.apply(p, single["cfg"].bert,
                                                  **kw),
                       single["model"], single["tok"],
                       output_key="last_hidden_state", max_length=16,
                       batch_size=6, device="cpu").embed_texts(
                           inputs["queries"][:13])
    assert got.shape == ref.shape == (13, 16, 32)
    _close(got, ref)
    assert [(op, axis) for op, axis, _ in world[0]["text_log"]] == [
        ("all_gather", "data")] * 3


def test_image_embedder_split_over_data(inputs, world):
    got = _same_on_every_rank(world, "image")
    ref = ImageEmbedder(tdh.tiny_image_tower,
                        torch.linspace(-1, 1, 12).reshape(3, 4), "emb",
                        image_size=16, batch_size=5,
                        device="cpu").embed_images(inputs["images"])
    assert got.shape == ref.shape == (12, 4)
    missing = np.isnan(ref).all(axis=1)
    assert missing.sum() == 3
    np.testing.assert_array_equal(np.isnan(got).all(axis=1), missing)
    _close(got[~missing], ref[~missing])


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_mm_embedder_split_over_data(inputs, world, single, packed):
    from transformers import BertTokenizerFast

    got = _same_on_every_rank(world, f"mm_{packed}")
    eca = single["eca"]
    ref = MMEmbedder(eca.apply_fn, eca.params,
                     BertTokenizerFast(vocab_file=inputs["vocab"]),
                     PreComputedImageFeatures(**tdh.MM_FEATURES),
                     key="input", save_as="emb", max_length=16, batch_size=4,
                     packed_bundle=eca if packed else None,
                     device="cpu").embed_items(inputs["mm_items"])
    assert got.shape == ref.shape == (7, 24)
    _close(got, ref)


def test_qa_program_on_the_mesh(inputs, world, single):
    """__graft_entry__.py:496-596 at data = 2 x kb = 2: the fused ids equal
    fuse_topk over each leg's exact top-k; the reader step with its canvas
    rows split over data gives the single-device reader's spans and
    logits; the kb gathers are candidate-sized, the data gathers
    output-sized (every rank's block of the CLS vectors, the canvas
    logits), none KB-sized."""
    qa = inputs["qa"]
    fused_i, spans, start, end = _same_on_every_rank(world, "qa")
    n_q, k = len(qa["questions"]), qa["k"]
    q = single["emb"].embed_texts(qa["questions"])[:n_q].numpy()
    s0, i0 = mips.exact_topk_numpy(q, qa["kb"], k)
    s1, i1 = mips.exact_topk_numpy(qa["q_face"], qa["kb_face"], k)
    _, ref_i = fuse_topk(
        (torch.from_numpy(s0), torch.from_numpy(s1)),
        (torch.from_numpy(i0).int(), torch.from_numpy(i1).int()),
        (0.6, 0.4), qa["m"], norm="gzmuv")
    np.testing.assert_array_equal(fused_i, ref_i.numpy())
    ref = tdh.qa_program(mesh.make_mesh(device="cpu"), single["emb"],
                         single["reader"], single["rcfg"], **qa)
    np.testing.assert_array_equal(fused_i, ref[0])
    for a, b in zip(spans, ref[1]):
        np.testing.assert_array_equal(a, b)
    finite = start > -1e29
    np.testing.assert_array_equal(finite, ref[2] > -1e29)
    _close(start[finite], ref[2][finite])
    _close(end[finite], ref[3][finite])
    log = world[0]["qa_log"]
    kb_bytes = [b for _, axis, b in log if axis == "kb"]
    assert kb_bytes == [2 * 2 * n_q * k * 4] * 2
    data = [b for _, axis, b in log if axis == "data"]
    assert len(data) == 2 and data[0] == 2 * 64 * 32 * 4
    assert max(data) < qa["kb"].nbytes


def test_cli_serve_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc-per-node 2 -m viquae_torch --device cpu serve``
    (gloo, a kb mesh of the two ranks: the dense index row-split, BM25
    with ``"device": "sharded"``) writes, from rank 0 alone, the run one
    process writes with ``"device": true``."""
    import json
    import subprocess
    import sys

    from datasets import Dataset
    from transformers import BertTokenizerFast

    from viquae_torch.cli import main as tmain
    from viquae_torch.train.checkpoint import export_params

    bcfg = dict(vocab_size=40, hidden_size=16, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=32,
                max_position_embeddings=64, add_pooler=False)
    (tmp_path / "tok").mkdir()
    (tmp_path / "tok" / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + [f"w{i}" for i in range(30)]))
    BertTokenizerFast(vocab_file=str(tmp_path / "tok" / "vocab.txt")
                      ).save_pretrained(tmp_path / "tok")
    rng = np.random.default_rng(0)
    Dataset.from_dict({
        "passage": [" ".join(f"w{j}" for j in rng.integers(0, 30, 8))
                    for _ in range(300)],
        "embedding": rng.standard_normal((300, 16)).astype(
            np.float32).tolist()}).save_to_disk(str(tmp_path / "kb"))
    (tmp_path / "queries.txt").write_text(
        "\n".join(f"w{i} w{i + 1} w{i + 2}" for i in range(9)))
    export_params(tmp_path / "dpr", convert.init_tree(
        bert.BertConfig(**bcfg), seed=3))

    def config(bm25_device):
        path = tmp_path / f"serve_{bm25_device}.json"
        path.write_text(json.dumps({
            "model": {"class_name": "DPREncoder", "bert_config": bcfg,
                      "pretrained_model_name_or_path": str(tmp_path / "dpr")},
            "tokenizer": str(tmp_path / "tok"), "row_len": 16,
            "index": {"dataset": str(tmp_path / "kb"), "column": "embedding",
                      "mode": "global"},
            "bm25": {"kb": str(tmp_path / "kb"), "column": "passage",
                     "b": 0.3, "k1": 0.5, "device": bm25_device,
                     "n_head": 8, "l_small": 16, "q_block": 4},
            "weights": [0.7, 0.3], "norm": "gzmuv"}))
        return path

    args = ["serve", str(tmp_path / "queries.txt")]
    tail = ["--k", "5", "--batch", "4"]
    tmain(["--device", "cpu", *args, str(config(True)),
           str(tmp_path / "one.json"), *tail])
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "viquae_torch", "--device", "cpu",
         *args, str(config("sharded")), str(tmp_path / "two.json"), *tail],
        capture_output=True, text=True, timeout=120, cwd=tdh.ROOT,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(tdh.ROOT)})
    assert out.returncode == 0, out.stderr[-4000:]
    printed = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(printed) == 1 and json.loads(printed[0])["queries"] == 9
    one = json.loads((tmp_path / "one.json").read_text())
    two = json.loads((tmp_path / "two.json").read_text())
    assert one.keys() == two.keys()
    for q in one:
        assert list(two[q]) == list(one[q]), q
        np.testing.assert_allclose(list(two[q].values()),
                                   list(one[q].values()), rtol=BF16_REL)
