"""Command-line surface: ``python -m viquae_torch [--device D] <command>``
(counterpart of viquae_tpu/cli.py, over the port's modules).

One argparse dispatcher over the JSON/YAML kwargs-tree configs of the JAX
package's CLI (the same files drive both):

  passages   split articles into passages
  mapping    title2index / article2passage
  relevant   provenance qrels
  embed      text embedding (padded, packed) and the multimodal ECA / ILF
             encoders over precomputed image features (MMEmbedder)
  embed-image, resize, faces, face-embed   the image and face stages
  search     multi-index search + evaluation
  serve      streaming retrieval over a query file -> run JSON
  answer     retrieve -> read -> answers JSON
  fuse, hp   late-fusion fit/test, BM25 grid search
  stats      dataset statistics
  train      config-driven training: fit (checkpoints, resume, export),
             validate, test (train/run.py)

plus the aux commands of viquae_torch/cli_aux.py (server, interact,
save-ptm, sentences, face-box, infoseek, evqa, kilt2vqa, and the data
construction, annotation and viz commands).

``--device`` names where everything a command builds lives; the default
is the GPU (``core.device.resolve_device``), and without one the CLI
refuses to run unless ``--device cpu`` is given.

Under ``torchrun --nproc-per-node N -m viquae_torch ...`` (``WORLD_SIZE``
set) the CLI joins the process group (``core.mesh.init_from_env``: NCCL,
one GPU a rank, or gloo with ``--device cpu``) and runs ``serve`` or
``answer`` on a ``kb`` mesh of the whole world: every dense index is
row-split over the ranks, and BM25 too with ``"device": "sharded"``. Only
rank 0 writes outputs and prints. The other commands run on one process.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from viquae_torch.core.config import load_config


def _add_config_arg(p):
    p.add_argument("--config", type=str, help="JSON/YAML kwargs-tree")


def _add_config_positional(p):
    """Positional config that can also be given as --config."""
    p.add_argument("config", nargs="?", default=None,
                   help="JSON/YAML kwargs-tree (also accepted as --config)")
    p.add_argument("--config", dest="config_opt", default=None,
                   help=argparse.SUPPRESS)


def _tokenizer(name):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(name)


def cmd_passages(args):
    from viquae_torch.data.loading import make_passage_dataset

    kwargs = load_config(args.config) if args.config else {}
    if kwargs.get("method") == "uniform":
        kwargs["tokenizer"] = _tokenizer(
            kwargs.pop("tokenizer_name", "bert-base-uncased"))
    out = make_passage_dataset(args.input, args.output, **kwargs)
    print(out)


def cmd_mapping(args):
    from viquae_torch.data.loading import make_mapping_dataset

    make_mapping_dataset(
        args.dataset, args.key, args.save_name,
        inverse=args.inverse, one2many=args.one2many,
    )


def cmd_relevant(args):
    from datasets import load_from_disk

    from viquae_torch.data.loading import json_integer_keys
    from viquae_torch.ir.metrics import find_relevant_dataset

    title2index = json.loads(Path(args.title2index).read_text())
    article2passage = None
    if args.article2passage:
        article2passage = json.loads(
            Path(args.article2passage).read_text(),
            object_hook=json_integer_keys,
        )
    find_relevant_dataset(
        args.dataset,
        passages=load_from_disk(args.passages),
        title2index=title2index,
        article2passage=article2passage,
        save_as=args.save,
    )


def cmd_embed(args):
    from viquae_torch.core.config import get_pretrained
    from viquae_torch.ir.embedding import (MMEmbedder, TextEmbedder,
                                           dataset_embed)
    from viquae_torch.models.mm import _MMEncoderBundle

    config = load_config(args.config)
    model_kwargs = config.pop("model")
    model = get_pretrained(**model_kwargs, device=args.device)
    tokenizer = _tokenizer(config.pop("tokenizer"))
    # an "image_features" block selects the multimodal path (ECAEncoder /
    # IntermediateLinearFusion over precomputed face+image feature columns)
    image_features = config.pop("image_features", None)
    packed_embed = config.pop("packed", False)
    if image_features is not None:
        from viquae_torch.train.data import PreComputedImageFeatures

        if packed_embed and not hasattr(model, "packed_apply_fn"):
            raise ValueError(
                f"{model_kwargs.get('class_name')} has no packed path; "
                "drop 'packed'")
        embedder = MMEmbedder(
            model.apply_fn, model.params, tokenizer,
            PreComputedImageFeatures(**image_features),
            packed_bundle=model if packed_embed else None,
            device=args.device, **config)
    elif isinstance(model, _MMEncoderBundle):
        raise ValueError(
            f"{model_kwargs.get('class_name')} is multimodal: the embed "
            "config needs an 'image_features' block (n_faces/face_dim/"
            "image_dims) naming the precomputed feature columns")
    elif packed_embed:
        # packed corpus embedding: passages at their real lengths instead
        # of padded to max_length. CLS pooling only.
        from viquae_torch.ir.embedding import PackedColumnEmbedder
        from viquae_torch.models import dpr as dpr_lib

        if config.get("layers"):
            raise ValueError("packed embedding extracts CLS only; "
                             "drop 'packed' to use 'layers'")
        row_len = config.pop("max_length", 256)
        embedder = PackedColumnEmbedder(
            dpr_lib.make_packed_apply(model.cfg), model.params, tokenizer,
            row_len=row_len, device=args.device, **config)
    else:
        embedder = TextEmbedder(model.apply_fn, model.params, tokenizer,
                                device=args.device, **config)
    dataset_embed(args.dataset, embedder, output_path=args.output)


def cmd_search(args):
    from datasets import load_from_disk

    from viquae_torch.ir.search import dataset_search

    config = load_config(args.config)
    dataset = load_from_disk(args.dataset)
    metric_save_path = Path(args.metrics) if args.metrics else None
    dataset_search(dataset, k=args.k, metric_save_path=metric_save_path,
                   device=args.device, **config)


def _build_dense_index(index_cfg, device, default_mode="global"):
    """Shared index construction for serve/answer (mode defaults differ:
    serve 'global', answer 'fused')."""
    import numpy as np

    from viquae_torch.ops import mips

    mode = index_cfg.get("mode", default_mode)
    if "load" in index_cfg:
        return mips.DenseIndex.load(index_cfg["load"], mode=mode,
                                    device=device)
    from datasets import load_from_disk

    kb = load_from_disk(index_cfg["dataset"])
    return mips.DenseIndex(
        np.asarray(kb[index_cfg["column"]], np.float32),
        do_l2norm=index_cfg.get("do_l2norm", False), mode=mode,
        device=device)


def _build_hybrid_pipeline(config, embedder, batch_size, k, device,
                           default_mode="fused"):
    """Shared serve/answer hybrid construction: a "bm25" block names a
    saved index dir or a dataset column; dense index + weights + norm as
    in the serve schema (consumes the relevant keys from ``config``)."""
    from viquae_torch.ir.serving import HybridRetrievalPipeline
    from viquae_torch.ops import bm25 as bm25_lib

    bcfg = dict(config.pop("bm25"))
    hyper = {key: bcfg[key] for key in ("k1", "b") if key in bcfg}
    if "path" in bcfg:
        bm = bm25_lib.BM25Index.load(bcfg["path"], **hyper)
    else:
        from datasets import load_from_disk

        ds = load_from_disk(str(bcfg["kb"]))
        bm = bm25_lib.BM25Index.build(
            ds[bcfg.get("column", "passage")], **hyper)
    if bcfg.get("device"):
        # score BM25 on the card (ops/bm25_device.py), or over the mesh's
        # kb axis with "sharded"; the host index stays inside as the exact
        # overflow fallback
        from viquae_torch.ops.bm25_device import DeviceBM25, ShardedDeviceBM25

        dev_kwargs = {key: bcfg[key]
                      for key in ("n_head", "l_small", "l_mid", "pool_mid",
                                  "pool_small", "q_block") if key in bcfg}
        scorer = (ShardedDeviceBM25 if bcfg["device"] == "sharded"
                  else DeviceBM25)
        bm = scorer(bm, device=device, **dev_kwargs)
    index = _build_dense_index(config.pop("index"), device,
                               default_mode=default_mode)
    stats = config.pop("stats", None)
    return HybridRetrievalPipeline(
        embedder, index, bm,
        weights=tuple(config.pop("weights", (0.7, 0.3))),
        batch_size=batch_size, k=k,
        norm=config.pop("norm", "gzmuv"),
        stats=(tuple(tuple(pair) for pair in stats)
               if stats is not None else None),
    )


def _packed_text_embedder(config, device, batch_size, fixed_rows=None):
    """(tokenizer, PackedTextEmbedder) of a serve/answer/server config
    (consumes "model", "tokenizer" and "row_len")."""
    from viquae_torch.core.config import get_pretrained
    from viquae_torch.ir.embedding import PackedTextEmbedder
    from viquae_torch.models import dpr as dpr_lib

    model = get_pretrained(**config.pop("model"), device=device)
    tokenizer = _tokenizer(config.pop("tokenizer"))
    return tokenizer, PackedTextEmbedder(
        dpr_lib.make_packed_apply(model.cfg), model.params, tokenizer,
        row_len=config.pop("row_len", 64), batch_size=batch_size,
        fixed_rows=fixed_rows, device=device)


def _read_queries(path):
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def cmd_serve(args):
    """Streaming retrieval over a query file (one query per line) with the
    packed pipelines; writes a ranx-format run JSON."""
    import numpy as np

    from viquae_torch.ir.serving import FusedRetrievalPipeline

    config = load_config(args.config)
    _, embedder = _packed_text_embedder(config, args.device, args.batch)
    queries = _read_queries(args.queries)
    ids = [str(i) for i in range(len(queries))]

    if "bm25" in config:
        # hybrid sparse+dense serving: {"index": dense_cfg, "bm25":
        # {"path": saved_index | "kb": dataset, "column": ..., "b", "k1"},
        # "weights": [dense, bm25], "norm": "gzmuv" | "raw" (+ "stats")}
        pipeline = _build_hybrid_pipeline(config, embedder, args.batch,
                                          args.k, args.device,
                                          default_mode="global")
        run = pipeline.run(ids, queries)
    elif "indexes" in config:
        # late-fusion serving: {"indexes": {name: index_cfg}, "weights":
        # {name: w}, "text_index": name, "norm": "gzmuv",
        # "query_features": {name: path.npy}}
        from viquae_torch.ir.serving import MultiIndexRetrievalPipeline

        indexes = {n: _build_dense_index(c, args.device)
                   for n, c in config.pop("indexes").items()}
        feats = {n: np.load(p)
                 for n, p in config.pop("query_features", {}).items()}
        pipeline = MultiIndexRetrievalPipeline(
            embedder, indexes, config.pop("weights"),
            text_index=config.pop("text_index"),
            batch_size=args.batch, k=args.k,
            norm=config.pop("norm", "gzmuv"),
        )
        run = pipeline.run(ids, queries, feats)
    else:
        index = _build_dense_index(config.pop("index"), args.device)
        pipeline = FusedRetrievalPipeline(embedder, index,
                                          batch_size=args.batch, k=args.k)
        run = pipeline.run(ids, queries)
    if _writes():
        run.save(args.output)
        print(json.dumps({"queries": len(queries),
                          "stages": pipeline.report()}))


def cmd_answer(args):
    """Batch end-to-end QA over a query file: retrieve -> read -> answer
    strings (ir/qa_serving.AnswerPipeline); writes a JSON list of
    {question, answer, passage_ids, scores}."""
    import numpy as np
    from datasets import load_from_disk

    from viquae_torch.core.config import get_pretrained
    from viquae_torch.ir.qa_serving import AnswerPipeline
    from viquae_torch.ir.serving import FusedRetrievalPipeline

    config = load_config(args.config)
    tokenizer, embedder = _packed_text_embedder(config, args.device,
                                                args.batch)
    run_kwargs = {}
    if "bm25" in config:
        retrieval = _build_hybrid_pipeline(config, embedder, args.batch,
                                           args.m_passages, args.device)
    elif "indexes" in config:
        from viquae_torch.ir.serving import MultiIndexRetrievalPipeline

        indexes = {n: _build_dense_index(c, args.device,
                                         default_mode="fused")
                   for n, c in config.pop("indexes").items()}
        feats = {n: np.load(p)
                 for n, p in config.pop("query_features", {}).items()}
        retrieval = MultiIndexRetrievalPipeline(
            embedder, indexes, config.pop("weights"),
            text_index=config.pop("text_index"),
            batch_size=args.batch, k=args.m_passages,
            norm=config.pop("norm", "gzmuv"),
        )
        run_kwargs["query_features"] = feats
    else:
        index = _build_dense_index(config.pop("index"), args.device,
                                   default_mode="fused")
        retrieval = FusedRetrievalPipeline(
            embedder, index, batch_size=args.batch, k=args.m_passages)

    reader = get_pretrained(**config.pop("reader"), device=args.device)
    kb = load_from_disk(config.pop("passages"))
    pipeline = AnswerPipeline(
        retrieval, kb, reader.cfg, reader.params, tokenizer,
        m_passages=args.m_passages, device=args.device, **config,
    )
    queries = _read_queries(args.queries)
    results = pipeline.run(queries, **run_kwargs)
    for r, q in zip(results, queries):
        r["question"] = q
    if _writes():
        with open(args.output, "w") as f:
            json.dump(results, f, indent=1)
        print(json.dumps({"queries": len(queries),
                          "stages": pipeline.report()}))


def cmd_fuse(args):
    from viquae_torch.ir.fuse import Fusion

    config = load_config(args.config) if args.config else {}
    subcommand_kwargs = config.pop("subcommand_kwargs", {})
    fusion = Fusion(**config)
    if args.subcommand == "fit":
        fusion.fit(**subcommand_kwargs)
    else:
        if not args.best_params:
            raise SystemExit(
                "fuse test requires --best_params (a JSON file from "
                "`fuse fit`)")
        best_params = json.loads(Path(args.best_params).read_text())
        fusion.test(best_params, **subcommand_kwargs)


def cmd_hp(args):
    from datasets import load_from_disk

    from viquae_torch.ir import hp
    from viquae_torch.ops import bm25
    from viquae_torch.rankeval import Qrels

    config = load_config(args.config)
    kb = load_from_disk(config["kb"])
    index = bm25.BM25Index.build(list(kb[config.get("column", "passage")]))
    dataset = load_from_disk(config["dataset"])
    queries = dict(zip(dataset["id"], dataset[config.get("key", "input")]))
    qrels = Qrels.from_file(config["qrels"])
    objective = hp.BM25Objective(
        index, queries, qrels, k=config.get("k", 100),
        metric=config.get("metric", "mrr@100"),
    )
    result = hp.hyperparameter_search(
        objective, config.get("grid", hp.DEFAULT_BM25_GRID),
        storage=config.get("storage"),
    )
    print(json.dumps(
        {k: result[k] for k in ("best_params", "best_value")}, indent=2))


def _torch_load(path):
    import torch

    return torch.load(path, map_location="cpu")


def cmd_faces(args):
    from viquae_torch.image.face_detection import (FaceDetector,
                                                   dataset_detect_faces)
    from viquae_torch.models import mtcnn

    config = load_config(args.config) if args.config else {}
    weights = config.pop("weights", None)
    params = (mtcnn.params_from_facenet(_torch_load(weights),
                                        device=args.device) if weights
              else mtcnn.init(seed=0, device=args.device))
    mtcnn_kwargs = config.pop("mtcnn", {})
    if "thresholds" in mtcnn_kwargs:  # a JSON list; the config is frozen
        mtcnn_kwargs["thresholds"] = tuple(mtcnn_kwargs["thresholds"])
    cfg = mtcnn.MTCNNConfig(**mtcnn_kwargs)
    detector = FaceDetector(params, cfg=cfg, device=args.device, **config)
    dataset_detect_faces(args.dataset, detector)


def cmd_face_embed(args):
    from viquae_torch.image.face_recognition import (
        FaceEmbedder, dataset_compute_face_embedding)
    from viquae_torch.models import arcface

    config = load_config(args.config) if args.config else {}
    cfg = arcface.ArcFaceConfig(**config.pop("arcface", {}))
    weights = config.pop("weights", None)
    params = (arcface.params_from_insightface(_torch_load(weights), cfg,
                                              device=args.device) if weights
              else arcface.init(cfg, seed=0, device=args.device))
    embedder = FaceEmbedder(params, cfg=cfg, device=args.device, **config)
    dataset_compute_face_embedding(args.dataset, embedder)


def build_image_tower(config, device):
    """(apply_fn, params, preprocessing) from an embed-image model config
    ({"model": clip-vit|clip|clip-RN50|imagenet-RN50, "weights": path?,
    "model_config": {...}}), the tower on ``device``. Shared by the
    embed-image stage and the server's online image towers. Mutates
    ``config`` (pops the model keys), leaving stage kwargs behind."""
    model_kind = config.pop("model", "clip-vit")
    weights = config.pop("weights", None)
    if model_kind in ("clip-vit", "clip"):
        from viquae_torch.models import clip as clip_lib

        mc = config.pop("model_config", {})
        # accept HF CLIPVisionConfig field names
        for hf_name, ours in [("num_hidden_layers", "num_layers"),
                              ("num_attention_heads", "num_heads")]:
            if hf_name in mc:
                val = mc.pop(hf_name)
                if mc.setdefault(ours, val) != val:
                    raise ValueError(
                        f"model_config sets both {hf_name!r}={val} and "
                        f"{ours!r}={mc[ours]} — remove one")
        vcfg = clip_lib.CLIPVisionConfig(**mc)
        params = (clip_lib.vit_from_jax(
                      clip_lib.tree_from_hf(_torch_load(weights))["vision"],
                      vcfg, device=device) if weights
                  else clip_lib.vit_init(vcfg, seed=0, device=device))

        def apply_fn(p, x):
            return clip_lib.vit_apply(p, vcfg, x)["image_embeds"]
        preprocessing = "clip"
    elif model_kind == "clip-RN50":
        from viquae_torch.models import clip as clip_lib

        mcfg = clip_lib.ModifiedResNetConfig(**config.pop("model_config",
                                                          {}))
        if not weights:
            raise ValueError(
                "clip-RN50 requires 'weights' (an OpenAI CLIP visual "
                "state_dict); ModifiedResNet has no random init")
        params = clip_lib.visual_params_from_openai(_torch_load(weights),
                                                    mcfg, device=device)

        def apply_fn(p, x):
            return clip_lib.modified_resnet_apply(p, mcfg, x)
        preprocessing = "clip"
    elif model_kind == "imagenet-RN50":
        from viquae_torch.models import resnet

        rcfg = resnet.ResNetConfig(**config.pop("model_config", {}))
        params = (resnet.params_from_torchvision(_torch_load(weights), rcfg,
                                                 device=device) if weights
                  else resnet.init(rcfg, seed=0, device=device))

        def apply_fn(p, x):
            return resnet.apply(p, rcfg, x)
        preprocessing = "imagenet"
    else:
        raise ValueError(f"Unknown image model {model_kind!r}")
    return apply_fn, params, preprocessing


def cmd_embed_image(args):
    from viquae_torch.image.embedding import (ImageEmbedder,
                                              dataset_embed_images)

    config = load_config(args.config)
    apply_fn, params, preprocessing = build_image_tower(config, args.device)
    embedder = ImageEmbedder(apply_fn, params, preprocessing=preprocessing,
                             device=args.device, **config)
    dataset_embed_images(args.dataset, embedder)


def cmd_resize(args):
    from viquae_torch.image.resize import dataset_resize

    n = dataset_resize(args.dataset, args.root, args.save_root,
                       size=args.size)
    print(f"resized {n} images")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="viquae_torch")
    parser.add_argument(
        "--device", default=None,
        help="where models, indexes and pipelines live (default: the GPU; "
             "without one the CLI refuses to run unless this names cpu)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("passages", help="split articles into passages")
    p.add_argument("input"), p.add_argument("output"), _add_config_arg(p)
    p.set_defaults(fn=cmd_passages)

    p = sub.add_parser("mapping", help="build title2index/article2passage")
    p.add_argument("dataset"), p.add_argument("key"), p.add_argument("save_name")
    p.add_argument("--inverse", action="store_true")
    p.add_argument("--one2many", action="store_true")
    p.set_defaults(fn=cmd_mapping)

    p = sub.add_parser("relevant", help="provenance relevance judgment")
    p.add_argument("dataset"), p.add_argument("passages")
    p.add_argument("title2index")
    p.add_argument("--article2passage")
    p.add_argument("--save", default="provenance_indices")
    p.set_defaults(fn=cmd_relevant)

    p = sub.add_parser("embed", help="embed a text column")
    p.add_argument("dataset"), _add_config_positional(p)
    p.add_argument("--output")
    p.set_defaults(fn=cmd_embed)

    p = sub.add_parser("search", help="multi-index search + eval")
    p.add_argument("dataset"), _add_config_positional(p)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--metrics")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("serve", help="streaming packed retrieval over a "
                                     "query file -> run JSON")
    p.add_argument("queries"), _add_config_positional(p)
    p.add_argument("output")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--batch", type=int, default=1280)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("answer", help="batch QA: retrieve -> read -> "
                                      "answers JSON")
    p.add_argument("queries"), _add_config_positional(p)
    p.add_argument("output")
    p.add_argument("--m-passages", type=int, default=24)
    p.add_argument("--batch", type=int, default=1280)
    p.set_defaults(fn=cmd_answer)

    p = sub.add_parser("fuse", help="late fusion fit/test")
    p.add_argument("subcommand", choices=["fit", "test"])
    p.add_argument("--best_params"), _add_config_arg(p)
    p.set_defaults(fn=cmd_fuse)

    p = sub.add_parser("hp", help="BM25 hyperparameter grid search")
    _add_config_positional(p)
    p.set_defaults(fn=cmd_hp)

    p = sub.add_parser("faces", help="MTCNN face detection stage")
    p.add_argument("dataset"), _add_config_arg(p)
    p.set_defaults(fn=cmd_faces)

    p = sub.add_parser("face-embed", help="align + ArcFace embedding stage")
    p.add_argument("dataset"), _add_config_arg(p)
    p.set_defaults(fn=cmd_face_embed)

    p = sub.add_parser("embed-image", help="global image embedding stage")
    p.add_argument("dataset"), _add_config_positional(p)
    p.set_defaults(fn=cmd_embed_image)

    p = sub.add_parser("resize", help="thumbnail the image corpus")
    p.add_argument("dataset"), p.add_argument("root")
    p.add_argument("save_root")
    p.add_argument("--size", type=int, default=512)
    p.set_defaults(fn=cmd_resize)

    p = sub.add_parser("stats", help="dataset statistics")
    p.add_argument("dataset")
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("train", help="config-driven training")
    p.add_argument("subcommand", choices=["fit", "validate", "test"])
    _add_config_positional(p)
    p.add_argument("--ckpt-path", dest="ckpt_path", default=None,
                   help="checkpoint dir: `test` restores it for eval "
                        "(default: trainer.ckpt_dir best/ then latest); "
                        "`fit` RESUMES training from its latest step")
    p.set_defaults(fn=cmd_train)

    from viquae_torch.cli_aux import register_aux

    register_aux(sub, _add_config_arg, _add_config_positional)
    return parser


def cmd_stats(args):
    from datasets import load_from_disk

    from viquae_torch.viz.stats import dataset_stats

    print(json.dumps(dataset_stats(load_from_disk(args.dataset)), indent=2,
                     default=str))


def cmd_train(args):
    from viquae_torch.train.run import run_from_config

    run_from_config(args.config, subcommand=args.subcommand,
                    ckpt_path=args.ckpt_path, device=args.device)


def parse_args(argv=None) -> argparse.Namespace:
    """The parsed command line, ``device`` resolved (the GPU by default;
    raises without one unless ``--device`` names another device)."""
    from viquae_torch.core.device import resolve_device

    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "config_opt", None) is not None:
        if args.config is not None:
            parser.error("config given both positionally and via --config")
        args.config = args.config_opt
    if hasattr(args, "config_opt") and args.config is None:
        parser.error("a config is required (positional or --config)")
    try:
        args.device = resolve_device(args.device)
    except RuntimeError as e:  # no GPU and no --device
        parser.error(f"{e} (--device cpu)")
    return args


# the commands that run on a mesh of torchrun's world
_MESH_COMMANDS = ("serve", "answer", "train")


def _writes() -> bool:
    """Whether this process writes outputs: rank 0 of the mesh."""
    from viquae_torch.core import mesh

    return mesh.current().rank == 0


def main(argv=None):
    args = parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        args.fn(args)
        return
    import torch.distributed as dist

    from viquae_torch.core import mesh

    if args.command not in _MESH_COMMANDS and int(
            os.environ["WORLD_SIZE"]) > 1:
        raise SystemExit(f"{args.command!r} runs on one process; under "
                         f"torchrun only {list(_MESH_COMMANDS)} run")
    args.device = mesh.init_from_env(args.device)
    try:
        # serving splits the KB over every rank; training its batches
        ctx = (mesh.make_mesh(device=args.device) if args.command == "train"
               else mesh.make_kb_mesh(device=args.device))
        with mesh.use(ctx):
            args.fn(args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
