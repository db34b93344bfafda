"""Small ``torch.distributed`` worlds on the CPU (gloo) for the tests of the
port's multi-device paths, and the programs their ranks run.

Imports no JAX: each rank is a fresh ``python tests/torch_dist_helpers.py
SPEC RANK`` process that imports torch, numpy and the port only, with one
torch thread. A world meets through a ``file://`` rendezvous in its own
directory (no port to collide on between test workers), runs one program
that makes several checks, and hands its results back to the test process
as a pickle in that directory. :func:`run_world` gives every world a time
limit: when a rank has not finished by then, every rank is killed and the
call raises :class:`WorldTimeout`, so a hung collective fails one test.
"""
from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
JOIN_TIMEOUT_S = 60.0


class WorldTimeout(AssertionError):
    """A world's ranks did not all finish within its time limit."""


def run_world(program: str, world: int, tmp_path, timeout: float =
              JOIN_TIMEOUT_S, **kwargs) -> list:
    """Run ``PROGRAMS[program](rank=r, tmp=dir, **kwargs)`` (or the
    program of that name in ``torch_train_helpers``) on ``world`` gloo
    ranks and return each rank's result, in rank order."""
    tmp = Path(tmp_path) / f"world_{program}_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    spec = tmp / "spec.pkl"
    spec.write_bytes(pickle.dumps({
        "program": program, "world": world, "timeout": timeout,
        "init": f"file://{tmp / 'rendezvous'}", "kwargs": kwargs}))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp / f"rank{r}.log", "wb") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(spec), str(r)],
                              env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=ROOT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
    except subprocess.TimeoutExpired:
        raise WorldTimeout(
            f"world {program!r} of {world} ranks did not finish within "
            f"{timeout} s; ranks still running: "
            f"{[r for r, p in enumerate(procs) if p.poll() is None]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = []
    for r, p in enumerate(procs):
        out = tmp / f"rank{r}.pkl"
        if p.returncode != 0 or not out.exists():
            log = (tmp / f"rank{r}.log").read_text(errors="replace")
            raise AssertionError(f"rank {r} of world {program!r} exited "
                                 f"{p.returncode}:\n{log[-6000:]}")
        results.append(pickle.loads(out.read_bytes()))
    return results


# ---- what the ranks run -----------------------------------------------------
def _np(t):
    return t.detach().cpu().numpy()


def padded(kb: np.ndarray, rows: int) -> np.ndarray:
    """kb with zero rows appended up to ``rows``."""
    out = np.zeros((rows, kb.shape[1]), kb.dtype)
    out[: len(kb)] = kb
    return out


def shard_rows(kb_pad: np.ndarray, ctx):
    """This rank's row slice of a padded KB, as a tensor on the CPU."""
    import torch

    from viquae_torch.core import mesh

    rows = len(kb_pad) // ctx.kb_size
    lo = ctx.coordinate(mesh.KB_AXIS) * rows
    return torch.from_numpy(np.ascontiguousarray(kb_pad[lo: lo + rows]))


def _logged(ctx, fn):
    """(fn(), [(op, axis, bytes)] of the collectives fn issued)."""
    ctx.collective_log.clear()
    out = fn()
    log = list(ctx.collective_log)
    ctx.collective_log.clear()
    return out, log


def mesh_program(rank: int, tmp):
    """Mesh shapes, coordinates, axis gathers, row split and gather."""
    import torch

    from viquae_torch.core import mesh

    out = {"rank": rank, "meshes": {}}
    for name, kw in (("all_data", {}), ("data2_model2", dict(data=2,
                                                             model=2)),
                     ("kb", None), ("data2_kb2", dict(data=2, kb=2)),
                     ("pipe2_kb2", dict(pipe=2, kb=2))):
        ctx = (mesh.make_kb_mesh(device="cpu") if kw is None
               else mesh.make_mesh(device="cpu", **kw))
        me = torch.tensor([rank], dtype=torch.int64)
        out["meshes"][name] = {
            "sizes": dict(ctx.sizes), "coords": dict(ctx.coords),
            "gathered": {axis: _np(mesh.all_gather(ctx, me, axis))[:, 0]
                         .tolist() for axis in mesh.AXES},
            "route": mesh.collective_route(ctx)}
    try:
        mesh.make_mesh(data=3, device="cpu")
    except ValueError as e:
        out["bad_mesh"] = str(e)
    ctx = mesh.make_mesh(data=2, kb=2, device="cpu")
    x = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
    part = mesh.split_rows(ctx, x)
    back = mesh.gather_rows(ctx, torch.from_numpy(part), len(x))
    out["split"] = (part, _np(back), list(ctx.collective_log))
    return out


def mips_program(rank: int, tmp, queries, kb, kb_int, q_int, k,
                 chunk_size):
    """topk_sharded in every mode and a sharded DenseIndex (search, add,
    reconstruct, save / load) on a kb = 4 and a data = 2 x kb = 2 mesh."""
    import torch

    from viquae_torch.core import mesh
    from viquae_torch.ops import mips

    out = {}
    n = len(kb)
    for name, kw in (("kb4", dict(kb=4)), ("data2_kb2", dict(data=2, kb=2))):
        ctx = mesh.make_mesh(device="cpu", **kw)
        res = out[name] = {}
        q = torch.from_numpy(queries)
        kb_pad = padded(kb, mesh.pad_to_multiple(n, ctx.kb_size * 128))
        local = shard_rows(kb_pad, ctx)
        for mode in ("fast", "exact", "global", "approx"):
            (s, i), log = _logged(ctx, lambda: mips.topk_sharded(
                q, local, k, mesh_ctx=ctx, chunk_size=chunk_size,
                valid_rows=n, mode=mode))
            res[mode] = (_np(s), _np(i), log)
        # the fused engine on integer-valued bf16 inputs (exact sums, many
        # ties), shards 512-row aligned as the reference's
        qi = torch.from_numpy(q_int).to(torch.bfloat16)
        ki_pad = padded(kb_int, mesh.pad_to_multiple(len(kb_int),
                                                     ctx.kb_size * 512))
        ki = shard_rows(ki_pad, ctx).to(torch.bfloat16)
        for label, nv, kk in (("full", len(kb_int), k),
                              ("uneven", len(kb_int) - 37, k),
                              ("sparse", 100, 256)):
            (s, i), log = _logged(ctx, lambda: mips.topk_sharded(
                qi, ki, kk, mesh_ctx=ctx, valid_rows=nv, mode="fused"))
            res[f"fused_{label}"] = (_np(s), _np(i), log)
        # the uneven valid_rows case of the reference's dry run
        s, i = mips.topk_sharded(q, local, k, mesh_ctx=ctx, chunk_size=64,
                                 mode="fast", valid_rows=n - 37)
        res["fast_uneven"] = (_np(s), _np(i))

        # ---- DenseIndex on the mesh ----------------------------------
        with mesh.use(ctx):
            for mode in ("fast", "global", "approx", "fused"):
                index = mips.DenseIndex(kb, mode=mode, chunk_size=chunk_size)
                (s, i), log = _logged(ctx, lambda: index.search_batch(
                    queries, k=k))
                res[f"index_{mode}"] = (s, i, log, index.matrix.shape[0])
                (s, i), _ = _logged(ctx, lambda: index.search_device(
                    q, *index.snapshot(), k))
                res[f"index_{mode}_device"] = (_np(s), _np(i))
            index = mips.DenseIndex(kb[:500], do_l2norm=True, chunk_size=256)
            index.add(kb[500:520])      # inside the padding
            res["add_small"] = index.search_batch(queries, k=15)
            index.add(5.0 * kb[520:1100])  # grows: rows change owner
            res["add_grow"] = index.search_batch(queries, k=15)
            res["add_rows"] = index.reconstruct_batch([0, 499, 510, 519,
                                                       520, 1099])
            fresh = mips.DenseIndex(
                np.concatenate([kb[:520], 5.0 * kb[520:1100]]),
                do_l2norm=True, chunk_size=256)
            res["add_fresh"] = fresh.search_batch(queries, k=15)
            path = Path(tmp) / f"{name}_index.npz"
            fused = mips.DenseIndex(kb, mode="fused")
            fused.save(path)
            res["saved"] = dict(np.load(path))
            loaded = mips.DenseIndex.load(path, mode="fused")
            res["loaded"] = loaded.search_batch(queries, k=k)
            res["reconstruct"] = fused.reconstruct_batch(
                np.array([[0, n - 1], [n // 2, 7]]))
    return out


def bm25_program(rank: int, tmp, texts, configs, seam_texts):
    """ShardedDeviceBM25 on kb = 4 and data = 2 x kb = 2 meshes: each
    config's lists, device rows, overflow count and collectives; the
    overflow + empty case; the searcher seam."""
    from viquae_torch.core import mesh
    from viquae_torch.ir.search import IndexKind, KnowledgeBase
    from viquae_torch.ops import bm25
    from viquae_torch.ops.bm25_device import ShardedDeviceBM25

    host = bm25.BM25Index.build(texts, k1=0.5, b=0.3)
    out = {}
    for name, kw in (("kb4", dict(kb=4)), ("data2_kb2", dict(data=2, kb=2))):
        ctx = mesh.make_mesh(device="cpu", **kw)
        res = out[name] = {}
        for cfg_name, (cfg, qs, k) in configs.items():
            dev = ShardedDeviceBM25(host, mesh_ctx=ctx, **cfg)
            (s, i), log = _logged(ctx, lambda: dev.search_batch(qs, k=k))
            d_s, d_i = dev.search_batch_device(qs, k=k)
            res[cfg_name] = {"lists": (s, i), "device": (_np(d_s), _np(d_i)),
                             "overflow": dev.last_overflow, "log": log,
                             "d_shard_pad": dev.d_shard_pad,
                             "l_mid": dev.l_mid, "l_small": dev.l_small}
        kb = KnowledgeBase({"passage": seam_texts}, mesh_ctx=ctx)
        kb.add_or_load_index(column="passage", index_name="sparse",
                             kind=IndexKind.BM25, k1=0.5, b=0.3,
                             device="sharded", n_head=8, l_small=32,
                             pool_mid=4, pool_small=8, q_block=4)
        backend = kb.indexes["sparse"].backend
        res["seam"] = (type(backend).__name__, backend.ctx.kb_size,
                       kb.search_batch("sparse", [seam_texts[5][:40]], k=5))
    return out


SERVE_BERT = dict(vocab_size=3000, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  add_pooler=False)
MM_BERT = dict(vocab_size=60, hidden_size=24, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=48,
               max_position_embeddings=40, add_pooler=False)
MM_FEATURES = dict(n_faces=2, face_dim=8, image_dims={"clip": 10})


def serving_models():
    """(DPR config, DPR weights, reader config, reader weights, the ECA
    encoder bundle) from seeds, on the CPU: the same in every process."""
    from viquae_torch.core.config import get_pretrained
    from viquae_torch.models import bert, dpr, qa

    cfg = dpr.DPRConfig(bert=bert.BertConfig(**SERVE_BERT))
    rcfg = qa.ReaderConfig(bert=cfg.bert)
    eca = get_pretrained("ECAEncoder", device="cpu",
                         bert={**MM_BERT, "vocab_size": 50}, gating=True,
                         **MM_FEATURES)
    return (cfg, dpr.init(cfg, seed=0, device="cpu"), rcfg,
            qa.init(rcfg, seed=9, device="cpu"), eca)


def tiny_image_tower(params, pixels):
    """A stand-in image tower: the mean colour through a (3, D) map."""
    return pixels.float().mean(dim=(1, 2)) @ params


def serving_program(rank: int, tmp, vocab, queries, kb, kb_face, q_face,
                    passages, mm_items, images, qa):
    """Serving on a data = 2 x kb = 2 mesh: the pipelines over kb-sharded
    indexes (and BM25) with the packed encoder split over data, each
    embedder split over data, and the reference's QA program
    (__graft_entry__.py:496-596)."""
    import torch
    from transformers import BertTokenizerFast

    from viquae_torch.core import mesh
    from viquae_torch.image.embedding import ImageEmbedder
    from viquae_torch.ir.embedding import (MMEmbedder, PackedTextEmbedder,
                                           TextEmbedder)
    from viquae_torch.ir.serving import (FusedRetrievalPipeline,
                                         HybridRetrievalPipeline,
                                         MultiIndexRetrievalPipeline)
    from viquae_torch.models import bert, dpr
    from viquae_torch.ops import bm25, mips
    from viquae_torch.ops.bm25_device import ShardedDeviceBM25
    from viquae_torch.train.data import PreComputedImageFeatures

    ctx = mesh.make_mesh(data=2, kb=2, device="cpu")
    tok = BertTokenizerFast(vocab_file=vocab)
    cfg, model, rcfg, reader, eca = serving_models()
    out = {}
    with mesh.use(ctx), torch.no_grad():
        emb = PackedTextEmbedder(dpr.make_packed_apply(cfg), model, tok,
                                 row_len=32, batch_size=64,
                                 compute_dtype=torch.float32)
        out["embeddings"] = _np(emb.embed_texts(queries[:64]))
        pipe = FusedRetrievalPipeline(
            emb, mips.DenseIndex(kb, mode="fused"), batch_size=64, k=10)
        out["fused"], out["fused_log"] = _logged(
            ctx, lambda: pipe.run_arrays(queries))
        sparse = ShardedDeviceBM25(bm25.BM25Index.build(passages, k1=0.5,
                                                         b=0.3),
                                   n_head=16, l_small=64, q_block=64)
        hybrid = HybridRetrievalPipeline(
            emb, mips.DenseIndex(kb, mode="global"), sparse, batch_size=64,
            k=10)
        out["hybrid"] = hybrid.run_arrays(queries)
        emb48 = PackedTextEmbedder(dpr.make_packed_apply(cfg), model, tok,
                                   row_len=32, batch_size=48,
                                   compute_dtype=torch.float32)
        multi = MultiIndexRetrievalPipeline(
            emb48, {"text": mips.DenseIndex(kb, mode="fused"),
                  "face": mips.DenseIndex(kb_face, mode="global",
                                          do_l2norm=True)},
            {"text": 0.6, "face": 0.4}, text_index="text", batch_size=48,
            k=10)
        out["multi"] = multi.run_arrays(queries, {"face": q_face})

        text = TextEmbedder(lambda p, **kw: bert.apply(p, cfg.bert, **kw),
                            model, tok, output_key="last_hidden_state",
                            max_length=16, batch_size=6)
        out["text"], out["text_log"] = _logged(
            ctx, lambda: text.embed_texts(queries[:13]))
        image = ImageEmbedder(tiny_image_tower,
                              torch.linspace(-1, 1, 12).reshape(3, 4),
                              "emb", image_size=16, batch_size=5)
        out["image"] = image.embed_images(images)
        for packed in (False, True):
            mm = MMEmbedder(eca.apply_fn, eca.params, tok,
                            PreComputedImageFeatures(**MM_FEATURES),
                            key="input", save_as="emb", max_length=16,
                            batch_size=4,
                            packed_bundle=eca if packed else None)
            out[f"mm_{packed}"] = mm.embed_items(mm_items)
        out["qa"], out["qa_log"] = _logged(
            ctx, lambda: qa_program(ctx, emb, reader, rcfg, **qa))
    return out


def qa_program(ctx, emb, reader, rcfg, questions, kb, kb_face, q_face,
               passage_tokens, k, m, row_len):
    """Two kb-sharded legs (the packed DPR questions over ``kb``, features
    over ``kb_face``, mode "fast", chunk 64), ``fuse_topk`` in gzmuv on
    the device, host assembly of (question, passage) pairs, then the packed
    reader step with its canvas rows split over ``data``. Returns the
    fused ids, the canvas logits' spans and the start / end logits."""
    import torch

    from viquae_torch.core import mesh
    from viquae_torch.models import qa
    from viquae_torch.ops import mips, packing
    from viquae_torch.ops.fusion import fuse_topk

    n_q = len(questions)
    q = emb.embed_texts(questions)[:n_q]
    legs = []
    for mat, queries in ((kb, q), (kb_face, torch.from_numpy(q_face))):
        local = shard_rows(padded(mat, mesh.pad_to_multiple(
            len(mat), ctx.kb_size * 128)), ctx)
        legs.append(mips.topk_sharded(queries, local, k, mesh_ctx=ctx,
                                      chunk_size=64, mode="fast",
                                      valid_rows=len(mat)))
    fused_s, fused_i = fuse_topk(
        tuple(s for s, _ in legs), tuple(i for _, i in legs), (0.6, 0.4), m,
        norm="gzmuv", valid_queries=n_q)
    fused_i = _np(fused_i)[:n_q]
    pair_seqs, pair_tts = pair_canvas_inputs(questions, fused_i,
                                             passage_tokens)
    rp = packing.pack_token_sequences(pair_seqs, row_len=row_len,
                                      pad_rows_to=ctx.data_size)
    tts = packing.pack_parallel(rp, pair_tts)
    g_idx, g_mask = packing.gather_indices(rp, row_len)
    args = [torch.from_numpy(np.asarray(a)) for a in (
        rp.input_ids, rp.segment_ids, rp.position_ids, tts, g_idx, g_mask)]
    out = qa.reader_apply_packed(reader, rcfg, *args, m_passages=m,
                                 mesh_ctx=ctx)
    return (fused_i, tuple(_np(t) for t in reader_spans(out, m)),
            _np(out.start_logits), _np(out.end_logits))


def pair_canvas_inputs(questions, fused_ids, passage_tokens):
    """The dry run's host boundary: [CLS] question[:6] [SEP] passage [SEP]
    for each question and each of its fused passages (zeros for a pad
    id), with the token types."""
    pair_seqs, pair_tts = [], []
    width = passage_tokens.shape[1]
    for qi, text in enumerate(questions):
        ids = [int(w[1:]) for w in text.split()][:6]
        head = np.array([2] + ids + [3], np.int32)
        for d in fused_ids[qi]:
            body = (passage_tokens[int(d)] if 0 <= int(d) < len(
                passage_tokens) else np.zeros(width, np.int32))
            pair_seqs.append(np.concatenate([head, body, [3]]).astype(
                np.int32))
            pair_tts.append(np.r_[np.zeros(len(head), np.int32),
                                  np.ones(width + 1, np.int32)])
    return pair_seqs, pair_tts


def reader_spans(out, m):
    """get_best_spans over the global softmax of each question's m
    passages, as the dry run reads the step."""
    import torch

    from viquae_torch.models import qa

    n_q = out.start_logits.shape[0] // m
    start = torch.exp(torch.log_softmax(out.start_logits, -1)).reshape(
        n_q, m, -1)
    end = torch.exp(torch.log_softmax(out.end_logits, -1)).reshape(
        n_q, m, -1)
    return qa.get_best_spans(start, end)


def hang_program(rank: int, tmp):
    """Rank 0 waits in a collective that rank 1 never joins."""
    import torch

    from viquae_torch.core import mesh

    ctx = mesh.make_kb_mesh(device="cpu")
    if rank == 1:
        time.sleep(3600)
    return _np(mesh.all_gather(ctx, torch.zeros(1), mesh.KB_AXIS))


PROGRAMS = {"mesh": mesh_program, "mips": mips_program,
            "bm25": bm25_program, "serving": serving_program,
            "hang": hang_program}


def _main(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    spec = pickle.loads(Path(spec_path).read_bytes())
    dist.init_process_group(
        "gloo", init_method=spec["init"], rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    programs = PROGRAMS
    if spec["program"] not in programs:     # the training worlds' programs
        import torch_train_helpers

        programs = torch_train_helpers.PROGRAMS
    try:
        result = programs[spec["program"]](
            rank=rank, tmp=Path(spec_path).parent, **spec["kwargs"])
    finally:
        dist.destroy_process_group()
    (Path(spec_path).parent / f"rank{rank}.pkl").write_bytes(
        pickle.dumps(result))


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]))
