"""Aux subcommands of the port's CLI (counterpart of the part of
viquae_tpu/cli_aux.py whose modules are ported):

  server     HTTP serving with dynamic micro-batching (ir/server.py) over a
             serve / answer config: dense, hybrid, late fusion with online
             image and face legs (the VQA /answer endpoint), the reader
  interact   REPL over the serving pipelines
  save-ptm   export a train-state checkpoint as encoder dirs
  sentences  sentence-segment a text column
  face-box   UNITER-style scaled face-box features
  infoseek   the InfoSeek official evaluation
  evqa       the Encyclopedic-VQA evaluation protocol (Exact Match, then
             the BEM scorer for the misses)
  kilt2vqa   the VQA generation pipeline (ner with the title gazetteer or
             the neural NER model / ned / count-entities /
             generate-mentions / generate-vq / labelstudio / download)
  wiki       the Wikidata/Commons entity pipeline over a subset directory
  wikidump   Commons dump -> per-entity image metadata
  wit        WIT tsv -> MICT DatasetDict
  labelstudio annotation round-trip (merge/agreement/assign/vqa)
  mscelebs   MS-Celeb faces (entities/extract)
  html       questions + results rendered as HTML
  plot       2-D projection of an embedding column (umap/pca/tsne)
  wtl-filter a dataset filtered on win/tie/loss against a run

The data-construction, annotation and viz commands are host-only.
Every command takes its device from the CLI's ``--device``.
"""
from __future__ import annotations

import json
from pathlib import Path

from viquae_torch.core.config import load_config

def _load_dataset(path):
    from datasets import load_from_disk

    return load_from_disk(str(path))


def _save_dataset(dataset, args):
    out = args.output or args.dataset
    if args.output:
        dataset.save_to_disk(str(out))
    else:  # Arrow forbids overwriting the open source dir in place
        from viquae_torch.ir.embedding import save_in_place

        save_in_place(dataset, out)
    return out


# ---------------------------------------------------------------------------
# kilt2vqa
# ---------------------------------------------------------------------------
def _build_ner_fn(config, device):
    from viquae_torch.data import kilt2vqa

    neural_spec = config.pop("neural", None)
    if neural_spec is not None:
        # model-based NER: an HF BertForTokenClassification dir (e.g. a
        # CoNLL-03 checkpoint) read as its config and raw state dict and
        # ported to models/ner.py on ``device``
        from transformers import AutoConfig, AutoTokenizer

        from viquae_torch.models import bert as bert_lib
        from viquae_torch.models import ner as ner_lib

        path = neural_spec.pop("path")
        cfg = ner_lib.config_from_hf(AutoConfig.from_pretrained(path))
        params = ner_lib.params_from_hf(bert_lib.load_hf_state_dict(path),
                                        cfg, device=device)
        tokenizer = AutoTokenizer.from_pretrained(
            neural_spec.pop("tokenizer", path)
        )
        return ner_lib.NeuralNER(params, cfg, tokenizer, device=device,
                                 **neural_spec)

    titles_spec = config.pop("titles", None)
    if titles_spec is None:
        return kilt2vqa.capitalized_span_ner
    titles_path = Path(str(titles_spec))
    if titles_path.suffix == ".json":
        titles = json.loads(titles_path.read_text())
        if isinstance(titles, dict):  # e.g. title2index mappings
            titles = list(titles)
    else:
        kb = _load_dataset(titles_path)
        titles = kb[config.pop("title_key", "wikipedia_title")]
    return kilt2vqa.GazetteerNER(titles, **config.pop("gazetteer", {}))


def _require(value, flag, command):
    if not value:
        raise SystemExit(f"{command} requires {flag}")
    return value


def cmd_kilt2vqa(args):
    from viquae_torch.data import kilt2vqa

    config = load_config(args.config) if args.config else {}
    sub = args.subcommand
    if sub in ("labelstudio", "count-entities"):
        _require(args.output, "--output", f"kilt2vqa {sub}")
    if sub == "ned":
        _require(args.wikipedia, "--wikipedia", "kilt2vqa ned")
    if sub in ("generate-mentions", "generate-vq"):
        _require(args.entities, "--entities", f"kilt2vqa {sub}")

    if sub == "download":
        dataset = _load_dataset(args.dataset)
        n = kilt2vqa.download_images(
            dataset, args.save_root or "images",
            image_width=args.width,
            num_shards=args.num_shards, shard_index=args.shard_index,
        )
        print(json.dumps({"downloaded": n}))
        return

    if sub == "labelstudio":
        dataset = _load_dataset(args.dataset)
        tasks = kilt2vqa.labelstudio_export(dataset, image_width=args.width)
        Path(args.output).write_text(json.dumps(tasks, indent=1))
        print(json.dumps({"tasks": len(tasks)}))
        return

    if sub == "count-entities":
        dataset = _load_dataset(args.dataset)
        entities = kilt2vqa.count_entities(
            dataset, wer_threshold=args.wer_threshold
        )
        Path(args.output).write_text(json.dumps(entities, indent=1))
        print(json.dumps({"entities": len(entities)}))
        return

    dataset = _load_dataset(args.dataset)
    if sub == "ner":
        ner_fn = _build_ner_fn(config, args.device)
        dataset = dataset.map(
            lambda item: kilt2vqa.item2placeholder(item, ner_fn=ner_fn)
        )
    elif sub == "ned":
        wikipedia = _load_dataset(args.wikipedia)
        wid2row = {
            str(wid): i for i, wid in enumerate(wikipedia["wikipedia_id"])
        }

        def get_wikipedia_item(wid):
            return wikipedia[wid2row[str(wid)]]

        dataset = dataset.map(
            lambda item: kilt2vqa.disambiguate(item, get_wikipedia_item)
        )
    elif sub == "generate-mentions":
        entities = json.loads(Path(args.entities).read_text())
        feminine = (
            json.loads(Path(args.feminine).read_text())
            if args.feminine else None
        )
        dataset = dataset.map(lambda item: kilt2vqa.generate_mention(
            item, entities, wer_threshold=args.wer_threshold,
            feminine_labels=feminine,
        ))
    elif sub == "generate-vq":
        entities = json.loads(Path(args.entities).read_text())
        dataset = dataset.map(lambda item: kilt2vqa.generate_vq(
            item, entities, image_width=args.width
        ))
    else:  # pragma: no cover - argparse choices guard this
        raise ValueError(f"unknown kilt2vqa subcommand {sub!r}")
    out = _save_dataset(dataset, args)
    print(json.dumps({"items": len(dataset), "saved": str(out)}))


# ---------------------------------------------------------------------------
# evqa
# ---------------------------------------------------------------------------
def cmd_evqa(args):
    from viquae_torch.data import evqa

    predictions = json.loads(Path(args.predictions).read_text())
    references = json.loads(Path(args.references).read_text())
    scoring = evqa.exact_match_scoring_function
    if args.scorer == "bem":
        from viquae_torch.models import bem
        from viquae_torch.train.run import _build_tokenizer

        config = load_config(args.config) if args.config else {}
        bem_kwargs = dict(config.get("bem_config", {}))
        if "bert_config" in bem_kwargs:  # nested BertConfig as a dict
            from viquae_torch.models import bert as bert_lib

            bem_kwargs["bert"] = bert_lib.BertConfig(
                **bem_kwargs.pop("bert_config"))
        cfg = bem.BEMConfig(**bem_kwargs)
        tokenizer = _build_tokenizer(config["tokenizer"])
        if config.get("params"):  # an export directory of either package
            from viquae_torch.train.checkpoint import import_params

            params = bem.from_jax(import_params(config["params"]), cfg,
                                  device=args.device)
        else:
            params = bem.init(cfg, seed=config.get("seed", 0),
                              device=args.device)
        scorer = bem.BEMScorer(cfg=cfg, params=params, tokenizer=tokenizer,
                               device=args.device, **config.get("scorer", {}))
        bem_fn = evqa.initialize_bem_scoring_function(scorer=scorer)

        # the official EVQA protocol: Exact Match first, BEM rescues misses
        def scoring(example):
            return evqa.encyclopedic_vqa_evaluation_function(example, bem_fn)
    out = evqa.evaluate(predictions, references, scoring_function=scoring)
    print(json.dumps(out))


def cmd_save_ptm(args):
    from viquae_torch.train.run import (_build_tokenizer, build_optimizer,
                                        build_trainee)
    from viquae_torch.train.save_ptm import save_ptm
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    config = load_config(args.config)
    tokenizer = _build_tokenizer(config["data"]["tokenizer"])
    trainee = build_trainee(dict(config["trainee"]), tokenizer=tokenizer,
                            device=args.device)
    trainer = Trainer(trainee.loss_fn, trainee.params,
                      build_optimizer(config, trainee),
                      TrainerConfig(**config.get("trainer", {})))
    ckpt_dir = args.ckpt or config.get("trainer", {}).get("ckpt_dir")
    if not ckpt_dir:
        raise SystemExit("save-ptm needs --ckpt or trainer.ckpt_dir")
    out = save_ptm(ckpt_dir, args.output, trainer.state, step=args.step)
    print(json.dumps(out))


def cmd_sentences(args):
    """Sentence-segment a text column (ICT input)."""
    from viquae_torch.data.loading import make_sentences_dataset

    out = make_sentences_dataset(args.dataset, text_key=args.text_key)
    print(json.dumps({"items": len(out)}))


def cmd_face_box(args):
    from viquae_torch.image.face_box import dataset_scale_face_boxes

    out = dataset_scale_face_boxes(args.dataset, image_key=args.image_key)
    print(json.dumps({"items": len(out)}))


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def cmd_infoseek(args):
    from viquae_torch.data import infoseek

    qid2example = {
        ex["data_id"]: ex for ex in _read_jsonl(args.references)
    }
    if len(args.predictions) == 1 and not args.split:
        out = infoseek.evaluate_infoseek(
            _read_jsonl(args.predictions[0]), qid2example)
    else:
        splits = args.split or [Path(p).stem for p in args.predictions]
        if len(splits) != len(args.predictions):
            raise SystemExit(
                f"--split names {len(splits)} splits for "
                f"{len(args.predictions)} prediction files — zip would "
                "silently drop files")
        out = infoseek.evaluate_infoseek_full(
            {s: _read_jsonl(p) for s, p in zip(splits, args.predictions)},
            qid2example)
    print(json.dumps(out))


def cmd_interact(args):
    """REPL over the serving pipelines: type a question, get passages (or
    an answer when the config has a 'reader' block)."""
    import sys

    from datasets import load_from_disk

    from viquae_torch import cli as _cli
    from viquae_torch.core.config import get_pretrained
    from viquae_torch.ir.serving import FusedRetrievalPipeline

    config = load_config(args.config)
    # server configs pin the canvas; honour (and consume) the key here too
    # so the same config file drives both commands
    tokenizer, embedder = _cli._packed_text_embedder(
        config, args.device, args.batch,
        fixed_rows=config.pop("fixed_rows", None))
    reader_cfg = config.pop("reader", None)
    if reader_cfg is not None:
        from viquae_torch.ir.qa_serving import AnswerPipeline

        index = _cli._build_dense_index(config.pop("index"), args.device,
                                        default_mode="fused")
        retrieval = FusedRetrievalPipeline(
            embedder, index, batch_size=args.batch, k=args.m_passages)
        reader = get_pretrained(**reader_cfg, device=args.device)
        kb = load_from_disk(config.pop("passages"))
        pipeline = AnswerPipeline(
            retrieval, kb, reader.cfg, reader.params, tokenizer,
            m_passages=args.m_passages, device=args.device, **config)

        def respond(question):
            result = pipeline.run([question])[0]
            return f"answer: {result['answer']}"
    else:
        index = _cli._build_dense_index(config.pop("index"), args.device,
                                        default_mode="global")
        passages = (load_from_disk(str(config.pop("passages")))
                    if "passages" in config else None)
        pipeline = FusedRetrievalPipeline(
            embedder, index, batch_size=args.batch, k=args.k)

        def respond(question):
            run = pipeline.run(["interactive"], [question])
            hits = sorted(run["interactive"].items(),
                          key=lambda kv: -kv[1])[:args.k]
            lines = []
            for pid, score in hits:
                text = ""
                if passages is not None:
                    text = passages[int(pid)].get("passage", "")[:120]
                lines.append(f"  [{pid}] {score:.3f} {text}")
            return "\n".join(lines) or "  (no results)"

    print("ready — one question per line (ctrl-D to exit)", flush=True)
    for line in sys.stdin:
        question = line.strip()
        if not question:
            continue
        print(respond(question), flush=True)


def _build_face_query_encoder(config, batch_size, device):
    """FaceQueryEncoder (online MTCNN -> align -> ArcFace leg) from a
    config block: {"mtcnn": MTCNNConfig kwargs, "mtcnn_weights": facenet
    .pt?, "arcface": ArcFaceConfig kwargs, "arcface_weights": .pt?};
    without weights, seeded ones ("mtcnn_seed", "arcface_seed", 0)."""
    from viquae_torch.cli import _torch_load
    from viquae_torch.image.face_recognition import FaceQueryEncoder
    from viquae_torch.models import arcface, mtcnn

    mtcnn_kwargs = dict(config.pop("mtcnn", {}))
    if "thresholds" in mtcnn_kwargs:  # a JSON list; the config is frozen
        mtcnn_kwargs["thresholds"] = tuple(mtcnn_kwargs["thresholds"])
    m_cfg = mtcnn.MTCNNConfig(**mtcnn_kwargs)
    m_weights = config.pop("mtcnn_weights", None)
    m_params = (mtcnn.params_from_facenet(_torch_load(m_weights),
                                          device=device) if m_weights
                else mtcnn.init(seed=config.pop("mtcnn_seed", 0),
                                device=device))
    a_cfg = arcface.ArcFaceConfig(**config.pop("arcface", {}))
    a_weights = config.pop("arcface_weights", None)
    a_params = (arcface.params_from_insightface(_torch_load(a_weights),
                                                a_cfg, device=device)
                if a_weights
                else arcface.init(a_cfg, seed=config.pop("arcface_seed", 0),
                                  device=device))
    return FaceQueryEncoder(m_params, a_params, mtcnn_cfg=m_cfg,
                            arcface_cfg=a_cfg, batch_size=batch_size,
                            device=device)


def build_server_from_config(args):
    """Construct (http_server, services) from a serve/answer config —
    split from cmd_server so tests can drive the built server in a
    thread. Supports plain dense ("index"), hybrid ("bm25" block),
    multi-index fusion with online towers ("indexes" +
    image_encoders/face_encoders -> the VQA /answer endpoint) and reader
    ("reader" + "passages") configs."""
    from viquae_torch import cli as _cli
    from viquae_torch.core.config import get_pretrained
    from viquae_torch.ir.server import (BatchedAnswerService,
                                        BatchedRetrievalService,
                                        BatchedVQAService, make_http_server)
    from viquae_torch.ir.serving import FusedRetrievalPipeline

    device = args.device
    config = load_config(args.config)
    tokenizer, embedder = _cli._packed_text_embedder(
        config, device, args.max_batch,
        fixed_rows=config.pop("fixed_rows", None))
    reader_cfg = config.pop("reader", None)
    k = args.m_passages if reader_cfg else args.k
    image_encoder_names = []
    if "bm25" in config:
        # hybrid sparse+dense serving (same "bm25" schema as serve/answer)
        retrieval_pipeline = _cli._build_hybrid_pipeline(
            config, embedder, args.max_batch, k, device,
            default_mode="fused" if reader_cfg else "global")
    elif "indexes" in config:
        # multi-index fusion with ONLINE towers: {"indexes": {...},
        # "weights": {...}, "text_index": ..., "image_encoders": {index:
        # embed-image model config}, "face_encoders": {index: {"mtcnn":
        # cfg, "mtcnn_weights": pt?, "arcface": cfg, "arcface_weights":
        # pt?}}, "reader": {...}, "passages": ...}. Every live request
        # carries its own pixels, so non-text legs need an online encoder
        # and a reader must consume the fusion (the /answer VQA endpoint).
        if reader_cfg is None:
            raise SystemExit(
                "a fusion server config needs a 'reader' block: non-text "
                "legs are fed by per-request images (POST /answer with "
                "image_b64), there is no precomputed-feature path online")
        from viquae_torch.image.embedding import ImageEmbedder
        from viquae_torch.ir.serving import MultiIndexRetrievalPipeline

        indexes = {n: _cli._build_dense_index(c, device)
                   for n, c in config.pop("indexes").items()}
        image_encoders = {}
        for name, icfg in config.pop("image_encoders", {}).items():
            icfg = dict(icfg)
            apply_fn, params, prep = _cli.build_image_tower(icfg, device)
            image_encoders[name] = ImageEmbedder(
                apply_fn, params, save_as=name, preprocessing=prep,
                batch_size=args.max_batch, device=device, **icfg)
        face_encoders = {
            name: _build_face_query_encoder(dict(fcfg), args.max_batch,
                                            device)
            for name, fcfg in config.pop("face_encoders", {}).items()
        }
        missing = (set(indexes) - {config.get("text_index")}
                   - set(image_encoders) - set(face_encoders))
        if missing:
            raise SystemExit(
                f"fusion server: non-text indexes {sorted(missing)} have "
                "no online encoder (add image_encoders/face_encoders)")
        image_encoder_names = sorted(set(image_encoders)
                                     | set(face_encoders))
        retrieval_pipeline = MultiIndexRetrievalPipeline(
            embedder, indexes, config.pop("weights"),
            text_index=config.pop("text_index"),
            batch_size=args.max_batch, k=k,
            norm=config.pop("norm", "gzmuv"),
            image_encoders=image_encoders or None,
            face_encoders=face_encoders or None,
        )
    else:
        retrieval_pipeline = FusedRetrievalPipeline(
            embedder,
            _cli._build_dense_index(
                config.pop("index"), device,
                default_mode="fused" if reader_cfg else "global"),
            batch_size=args.max_batch, k=k)
    retrieval = answerer = vqa = None
    max_inflight = getattr(args, "max_inflight", 1)
    if reader_cfg is not None:
        from datasets import load_from_disk

        from viquae_torch.ir.qa_serving import AnswerPipeline

        reader = get_pretrained(**reader_cfg, device=device)
        kb = load_from_disk(config.pop("passages"))
        pipeline = AnswerPipeline(retrieval_pipeline, kb, reader.cfg,
                                  reader.params, tokenizer,
                                  m_passages=args.m_passages, device=device,
                                  **config)
        if image_encoder_names:
            vqa = BatchedVQAService(
                pipeline, image_encoder_names, max_batch=args.max_batch,
                max_wait_ms=args.max_wait_ms, max_inflight=max_inflight)
        else:
            answerer = BatchedAnswerService(
                pipeline, max_batch=args.max_batch,
                max_wait_ms=args.max_wait_ms, max_inflight=max_inflight)
    else:
        retrieval = BatchedRetrievalService(
            retrieval_pipeline, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, max_inflight=max_inflight)
    server = make_http_server(host=args.host, port=args.port,
                              retrieval=retrieval, answerer=answerer,
                              vqa=vqa)
    return server, [s for s in (retrieval, answerer, vqa) if s is not None]


def cmd_server(args):
    """HTTP serving over the dynamic micro-batcher: the `serve` config
    schema gains live POST /search (dense or hybrid); adding a 'reader'
    block (the `answer` schema) enables POST /answer instead."""
    server, services = build_server_from_config(args)
    has_answer = any(hasattr(s, "answer") for s in services)
    print(json.dumps({
        "listening": f"http://{args.host}:{server.server_address[1]}",
        "endpoints": (["/answer"] if has_answer else ["/search"])
        + ["/health"],
        "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
    }), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        for service in services:
            service.close()


# ---------------------------------------------------------------------------
# data construction, annotation (host only)
# ---------------------------------------------------------------------------
def cmd_wikidump(args):
    from viquae_torch.data import wikidump

    mapping = json.loads(Path(args.categories).read_text())
    if mapping and isinstance(next(iter(mapping.values())), dict):
        # entities.json layout ({qid: {..., "categories": [...]}}) instead
        # of a flat {category: qid} mapping
        mapping = {
            cat: qid
            for qid, entity in mapping.items()
            for cat in entity.get("categories", [])
        }
    images = wikidump.process_dump(args.dump, mapping)
    Path(args.output).write_text(json.dumps(images, indent=1))
    print(json.dumps({
        "entities_with_images": len(images),
        "images": sum(len(v) for v in images.values()),
    }))


def _read_class_csv(path) -> set:
    """First column (a class URI) of a concrete/abstract_entities.csv
    (header skipped — reference wiki.py:1022-1028)."""
    lines = Path(path).read_text().split("\n")[1:]
    return {line.split(",")[0] for line in lines if line}


def cmd_wiki(args):
    """Wikidata/Commons entity pipeline over a subset directory holding
    the reference's file layout: entities.json, depictions.json,
    feminine_labels.json, {n|all}_superclasses.json (parity
    reference wiki.py:104-133 docopt CLI + :940-1042 dispatch). The live
    actions need an egress-enabled host; heuristics/filter are offline."""
    from viquae_torch.data import wiki

    subset = Path(args.subset)
    entities_path = subset / "entities.json"
    depictions_path = subset / "depictions.json"
    entities = json.loads(entities_path.read_text())
    out_path = entities_path
    action = args.action
    if action == "entities":
        output = wiki.update_from_data(entities, skip=args.skip)
        output = wiki.set_reference_images(output)
        wiki.print_stats(output)
    elif action == "feminine":
        output = wiki.query_feminine_labels(entities)
        out_path = subset / "feminine_labels.json"
    elif action == "depicted":
        # attributes of every entity DEPICTED in the subset's images, then
        # the prominence heuristic (result is entity-dependent, so it is
        # saved into entities.json — reference wiki.py:976-990)
        depictions = json.loads(depictions_path.read_text())
        depicted = {wiki.uri_to_qid(uri): {"n_questions": 0}
                    for uris in depictions.values() for uri in uris}
        depicted = wiki.update_from_data(depicted)
        depicted.update(entities)
        output = wiki.depiction_instanceof_heuristic(depictions, depicted)
        wiki.print_stats(output)
    elif action == "superclasses":
        output = wiki.query_superclasses(entities, n_levels=args.n)
        out_path = subset / f"{args.n if args.n else 'all'}_superclasses.json"
    elif action == "sparql-depicts":
        output = wiki.update_from_commons_sparql(entities)
        wiki.print_stats(output)
    elif action == "sparql-depicted":
        depictions = {wiki.uri_to_qid(uri): []
                      for entity in entities.values()
                      for uri in entity.get("depictions", {})}
        output = wiki.query_depicted_entities(depictions)
        out_path = depictions_path
    elif action == "rest":
        output = wiki.update_from_commons_rest(
            entities, max_images=args.max_images,
            max_categories=args.max_categories)
        wiki.print_stats(output)
    elif action == "heuristics":
        heuristics = (set(args.heuristics) if args.heuristics
                      else wiki.VALID_IMAGE_HEURISTICS)
        output = wiki.image_heuristic(entities, heuristics)
        wiki.print_stats(output)
    elif action == "filter":
        superclasses = {}
        if args.superclass:
            superclasses = json.loads(
                (subset / f"{args.superclass}_superclasses.json").read_text())
        if args.concrete:  # --positive: keep concrete classes + people
            entities = wiki.keep_classes(
                entities, _read_class_csv(args.concrete), superclasses)
        to_exclude = {wiki.QID_URI_PREFIX + qid for qid in args.classes}
        if args.abstract:  # --negative: drop abstract classes
            to_exclude |= _read_class_csv(args.abstract)
        if to_exclude:
            entities = wiki.exclude_classes(entities, to_exclude,
                                            superclasses)
        if args.deceased is not None:
            entities = wiki.remove_alive_humans(
                entities, year_threshold=args.deceased)
        output = entities
        wiki.print_stats(output)
    out_path.write_text(json.dumps(output))
    print(f"saved {action} output to {out_path}")


def _iter_wit_rows(paths):
    import csv
    import gzip
    import sys

    # WIT rows hold full article sections; the csv default (128k) rejects
    # some of them
    csv.field_size_limit(sys.maxsize)
    for path in paths:
        path = Path(path)
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rt", encoding="utf-8", newline="") as f:
            yield from csv.DictReader(f, delimiter="\t")


def cmd_wit(args):
    from viquae_torch.data import wit

    paths = []
    for spec in args.tsv:
        p = Path(spec)
        paths.extend(sorted(p.glob("*.tsv*")) if p.is_dir() else [p])
    downloaded = None
    if args.downloaded:
        downloaded = set(
            Path(args.downloaded).read_text().splitlines()
        ) - {""}
    out = wit.build_mict_dataset(
        _iter_wit_rows(paths), output_path=args.output,
        downloaded_images=downloaded, split=not args.no_split,
        seed=args.seed,
    )
    sizes = (
        {name: len(split) for name, split in out.items()}
        if hasattr(out, "items") else {"all": len(out)}
    )
    print(json.dumps(sizes))


def cmd_labelstudio(args):
    from viquae_torch.data import labelstudio

    if args.subcommand in ("merge", "assign", "vqa"):
        _require(args.output, "--output", f"labelstudio {args.subcommand}")
    if args.subcommand == "merge":
        merged = labelstudio.merge_completions(args.paths)
        Path(args.output).write_text(json.dumps(merged, indent=1))
        print(json.dumps({"tasks": len(merged)}))
    elif args.subcommand == "agreement":
        # multiple exports merge first (agreement needs the per-task union
        # of annotations; reading only paths[0] would silently compute it
        # over a fraction of the annotators)
        tasks = (labelstudio.merge_completions(args.paths)
                 if len(args.paths) > 1
                 else labelstudio.load_completions(args.paths[0]))
        print(json.dumps(labelstudio.annotator_agreement(tasks)))
    elif args.subcommand == "assign":
        tasks = (labelstudio.merge_completions(args.paths)
                 if len(args.paths) > 1
                 else labelstudio.load_completions(args.paths[0]))
        assignments = labelstudio.assign_annotations(
            tasks, args.n_annotators, overlap=args.overlap
        )
        out = Path(args.output)
        for i, chunk in enumerate(assignments):
            target = out.with_name(f"{out.stem}_{i}{out.suffix or '.json'}")
            target.write_text(json.dumps(chunk, indent=1))
        print(json.dumps({
            "annotators": len(assignments),
            "tasks_each": [len(c) for c in assignments],
        }))
    else:  # vqa: annotated tasks -> final (question, answer, image) triples
        tasks = (labelstudio.merge_completions(args.paths)
                 if len(args.paths) > 1
                 else labelstudio.load_completions(args.paths[0]))
        vqa = [labelstudio.retrieve_vqa(t) for t in tasks]
        vqa = [v for v in vqa if v is not None and not v["discard"]]
        Path(args.output).write_text(json.dumps(vqa, indent=1))
        print(json.dumps({"kept": len(vqa), "of": len(tasks)}))


def _load_mids(path):
    from viquae_torch.data import mscelebs

    data = json.loads(Path(path).read_text())
    if isinstance(data, list):
        raw = data
    else:  # entities.json: {qid: {"freebase": {"value": "/m/0xxx"}, ...}}
        raw = []
        for entity in data.values():
            freebase = entity.get("freebase")
            if isinstance(freebase, dict):
                freebase = freebase.get("value")
            if freebase:
                raw.append(freebase)
    return {
        mscelebs.wikidata2freebase(m) if m.startswith("/m/") else m
        for m in raw
    }


def cmd_mscelebs(args):
    from viquae_torch.data import mscelebs

    mids = _load_mids(args.mids) if args.mids else None
    if args.subcommand == "entities":
        if mids is None:
            raise SystemExit("mscelebs entities requires --mids")
        counts = mscelebs.count_entities(mids, args.tsv)
        if args.output:
            Path(args.output).write_text(json.dumps(counts, indent=1))
        print(json.dumps({
            "entities_with_faces": len(counts),
            "faces": sum(counts.values()),
        }))
    else:  # extract
        n = mscelebs.extract_faces(args.tsv, args.save_root, mids)
        print(json.dumps({"extracted": n}))


# ---------------------------------------------------------------------------
# viz (host only)
# ---------------------------------------------------------------------------
def cmd_html(args):
    from viquae_torch.rankeval import Run
    from viquae_torch.viz.html import dataset_to_html

    dataset = _load_dataset(args.dataset)
    out = dataset_to_html(
        dataset, args.output, n=args.n, width=args.width,
        passages=_load_dataset(args.passages) if args.passages else None,
        wiki=_load_dataset(args.wiki) if args.wiki else None,
        search_run=Run.from_file(args.run) if args.run else None,
        other_search_run=(
            Run.from_file(args.other_run) if args.other_run else None
        ),
        image_root=args.image_root,
    )
    print(out)


def cmd_plot(args):
    from viquae_torch.viz.projection import dataset_plot

    # without --output the Agg backend renders nothing and the figure is
    # never saved — a silent no-op that used to print {"saved": null}
    _require(args.output, "--output", "plot")
    kwargs = load_config(args.config) if args.config else {}
    dataset_plot(
        args.dataset, args.column, label_column=args.labels,
        output=args.output, method=args.method, **kwargs,
    )
    print(json.dumps({"saved": args.output, "method": args.method}))


def cmd_wtl_filter(args):
    from viquae_torch.rankeval import Qrels, Run
    from viquae_torch.viz.wtl_filter import filter_dataset

    dataset = _load_dataset(args.dataset)
    filtered = filter_dataset(
        dataset,
        Qrels.from_file(args.qrels),
        Run.from_file(args.run_a),
        run_b=Run.from_file(args.run_b) if args.run_b else None,
        filter=args.filter, k_a=args.k_a, k_b=args.k_b,
    )
    filtered.save_to_disk(str(args.output))
    print(json.dumps({"kept": len(filtered), "of": len(dataset)}))


def register_aux(sub, add_config_arg, add_config_positional):

    p = sub.add_parser(
        "kilt2vqa", help="VQA generation pipeline (ner/ned/mentions/vq)")
    p.add_argument("subcommand", choices=[
        "ner", "ned", "count-entities", "generate-mentions", "generate-vq",
        "labelstudio", "download",
    ])
    p.add_argument("dataset")
    p.add_argument("--output")
    p.add_argument("--config")
    p.add_argument("--wikipedia", help="KILT wikipedia dataset dir (ned)")
    p.add_argument("--entities", help="entities.json (mentions/vq)")
    p.add_argument("--feminine", help="feminine_labels.json")
    p.add_argument("--wer-threshold", type=float, default=0.5)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--save-root")
    p.add_argument("--num-shards", type=int)
    p.add_argument("--shard-index", type=int)
    p.set_defaults(fn=cmd_kilt2vqa)

    p = sub.add_parser(
        "wiki", help="Wikidata/Commons entity pipeline over a subset dir")
    p.add_argument("action", choices=[
        "entities", "feminine", "depicted", "superclasses",
        "sparql-depicts", "sparql-depicted", "rest", "heuristics", "filter",
    ])
    p.add_argument("subset", help="directory holding entities.json (+ "
                                  "depictions.json for depicted actions)")
    p.add_argument("--skip", help="only query entities missing this "
                                  "attribute (entities action resume)")
    p.add_argument("--n", type=int, help="superclass levels (default all)")
    p.add_argument("--max-images", type=int, default=1000)
    p.add_argument("--max-categories", type=int, default=100)
    p.add_argument("--heuristics", nargs="*",
                   help="subset of {categories,description,depictions,title}")
    p.add_argument("--superclass",
                   help="superclass level used by filter (int or 'all'; "
                        "reads {level}_superclasses.json from the subset)")
    p.add_argument("--concrete",
                   help="concrete_entities.csv -> positive filter")
    p.add_argument("--abstract",
                   help="abstract_entities.csv -> negative filter")
    p.add_argument("--deceased", type=int,
                   help="drop humans alive or deceased after this year")
    p.add_argument("classes", nargs="*", default=[],
                   help="extra QIDs to exclude (filter action)")
    p.set_defaults(fn=cmd_wiki)

    p = sub.add_parser(
        "wikidump", help="Commons dump -> per-entity image metadata")
    p.add_argument("dump"), p.add_argument("categories")
    p.add_argument("output")
    p.set_defaults(fn=cmd_wikidump)

    p = sub.add_parser("wit", help="WIT tsv -> MICT DatasetDict")
    p.add_argument("tsv", nargs="+", help="tsv(.gz) files or a directory")
    p.add_argument("output")
    p.add_argument("--downloaded", help="file of downloaded image names")
    p.add_argument("--no-split", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_wit)

    p = sub.add_parser(
        "labelstudio", help="annotation round-trip (merge/agreement/"
                            "assign/vqa)")
    p.add_argument("subcommand",
                   choices=["merge", "agreement", "assign", "vqa"])
    p.add_argument("paths", nargs="+")
    p.add_argument("--output")
    p.add_argument("--n-annotators", type=int, default=2)
    p.add_argument("--overlap", type=int, default=0)
    p.set_defaults(fn=cmd_labelstudio)

    p = sub.add_parser("mscelebs", help="MS-Celeb faces (entities/extract)")
    p.add_argument("subcommand", choices=["entities", "extract"])
    p.add_argument("tsv")
    p.add_argument("--mids", help="JSON list of mids or entities.json")
    p.add_argument("--save-root", default="faces")
    p.add_argument("--output")
    p.set_defaults(fn=cmd_mscelebs)

    p = sub.add_parser("html", help="render questions + results as HTML")
    p.add_argument("dataset"), p.add_argument("output")
    p.add_argument("--n", type=int)
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--passages"), p.add_argument("--wiki")
    p.add_argument("--run"), p.add_argument("--other-run")
    p.add_argument("--image-root", default="")
    p.set_defaults(fn=cmd_html)

    p = sub.add_parser("plot", help="2-D projection of an embedding column")
    p.add_argument("dataset"), p.add_argument("column")
    p.add_argument("--labels"), p.add_argument("--output")
    p.add_argument("--method", choices=["umap", "pca", "tsne"],
                   default="umap")
    p.add_argument("--config")
    p.set_defaults(fn=cmd_plot)

    p = sub.add_parser(
        "wtl-filter", help="filter a dataset on win/tie/loss vs a run")
    p.add_argument("dataset"), p.add_argument("qrels")
    p.add_argument("run_a"), p.add_argument("output")
    p.add_argument("--run-b")
    p.add_argument("--filter", default="win")
    p.add_argument("--k-a", type=int, default=1)
    p.add_argument("--k-b", type=int, default=1)
    p.set_defaults(fn=cmd_wtl_filter)

    p = sub.add_parser("evqa", help="Encyclopedic-VQA evaluation (EM/BEM)")
    p.add_argument("predictions"), p.add_argument("references")
    p.add_argument("--scorer", choices=["em", "bem"], default="em")
    p.add_argument("--config", help="BEM scorer config (bem)")
    p.set_defaults(fn=cmd_evqa)

    p = sub.add_parser(
        "save-ptm", help="export a TrainState checkpoint as encoder dirs")
    add_config_positional(p)
    p.add_argument("output")
    p.add_argument("--ckpt", help="checkpoint dir (default: trainer.ckpt_dir)")
    p.add_argument("--step", type=int)
    p.set_defaults(fn=cmd_save_ptm)

    p = sub.add_parser(
        "sentences", help="sentence-segment a text column (ICT input)")
    p.add_argument("dataset")
    p.add_argument("--text-key", default="text")
    p.set_defaults(fn=cmd_sentences)

    p = sub.add_parser(
        "face-box", help="UNITER-style scaled face-box features")
    p.add_argument("dataset")
    p.add_argument("--image-key", default="image")
    p.set_defaults(fn=cmd_face_box)

    p = sub.add_parser("infoseek", help="InfoSeek official evaluation")
    p.add_argument("predictions", nargs="+")
    p.add_argument("references")
    p.add_argument("--split", nargs="*")
    p.set_defaults(fn=cmd_infoseek)

    p = sub.add_parser(
        "server", help="HTTP serving (dynamic micro-batching) over a "
                       "serve/answer config")
    add_config_positional(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--m-passages", type=int, default=24)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=10.0)
    p.add_argument("--max-inflight", type=int, default=2,
                   help="concurrent micro-batches (cross-batch pipelining)")
    p.set_defaults(fn=cmd_server)

    p = sub.add_parser(
        "interact", help="interactive retrieval/QA REPL over stdin")
    add_config_positional(p)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--m-passages", type=int, default=8)
    p.add_argument("--batch", type=int, default=8)
    p.set_defaults(fn=cmd_interact)
