"""Multi-index, multi-KB retrieval runtime (counterpart of
viquae_tpu/ir/search.py).

Parity with meerqat/ir/search.py (Index :55-78, KnowledgeBase :81-293,
Searcher :296-459, dataset_search :462-524) on one GPU:

- FAISS flat indexes -> :class:`viquae_torch.ops.mips.DenseIndex` (KB matrix
  on the device) or :class:`~viquae_torch.ops.mips.StreamingDenseIndex`
  (pinned host chunks streamed through it).
- Elasticsearch/pyserini BM25 -> :class:`viquae_torch.ops.bm25.BM25Index`
  (in-repo inverted index, scored on the host) or, with ``device: true``,
  :class:`viquae_torch.ops.bm25_device.DeviceBM25` (scored on the card),
  behind the same `IndexKind` seam.
- ranx -> :mod:`viquae_torch.rankeval`.

Not ported yet, and refused by name rather than served by another engine:
the ``IVF`` string factories (ROADMAP.md A17, ``ops/ivf.py``) and BM25 with
``device: "sharded"`` (ROADMAP.md A17, the multi-GPU scorer). The
mesh argument of the JAX classes is a ``device`` here.

Kept behaviors: per-batch search over dataset columns, None-query masking,
article->passage `index_mapping` expansion (one2many with 1e-8 rank-decay
penalty, or many2one='max'), on-the-fly qrels via `find_relevant` with a
qnonrels cache, run/qrels/metrics persistence, optional late fusion.
"""
from __future__ import annotations

import enum
import json
import re
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from viquae_torch.data.loading import json_integer_keys
from viquae_torch.ir.metrics import find_relevant
from viquae_torch.rankeval import Qrels, Run, compare as rankeval_compare


class IndexKind(enum.Enum):
    DENSE = 0   # on-device MIPS (replaces FAISS)
    BM25 = 1    # in-repo sparse BM25 (replaces ES / pyserini)
    # aliases so reference configs with "kind": "FAISS"/"ES"/"PYSERINI" load
    FAISS = 0
    ES = 1
    PYSERINI = 1


class Index:
    """Metadata + backend handle for one index over a KB column.

    `normalization` ({"method": "normalize", "mean", "std"}) and
    `interpolation_weight` are the reference's committed legacy config
    semantics (experiments/ir/viquae/bm25/config.json): scores come back
    as w * (s - mean) / std, so summing runs across indexes reproduces
    the old ES interpolation. Both default to off (raw scores)."""

    def __init__(self, key: str, kind: IndexKind = IndexKind.DENSE,
                 do_L2norm: bool = False, backend=None,
                 normalization=None, interpolation_weight=None):
        self.key = key
        self.kind = kind
        self.do_L2norm = do_L2norm
        self.backend = backend
        if normalization is not None:
            method = normalization.get("method", "normalize")
            if method != "normalize":
                raise ValueError(
                    f"unsupported score normalization method {method!r}")
            self.normalization = (float(normalization["mean"]),
                                  float(normalization["std"]))
        else:
            self.normalization = None
        self.interpolation_weight = (
            float(interpolation_weight)
            if interpolation_weight is not None else None)

    def transform_scores(self, scores):
        """Apply the legacy normalize+weight to one query's score list."""
        if self.normalization is None and self.interpolation_weight is None:
            return scores
        arr = np.asarray(scores, dtype=np.float32)
        if self.normalization is not None:
            mean, std = self.normalization
            arr = (arr - mean) / std
        if self.interpolation_weight is not None:
            arr = arr * self.interpolation_weight
        return arr.tolist()


class KnowledgeBase:
    """A dataset + one or more searchable indexes over its columns.

    Parameters (parity with ir/search.py:81-131)
    ----------
    kb_path: path to an HF dataset on disk, a `datasets.Dataset`, or a
        plain dict of columns (whatever `dataset[column]` indexes).
    index_mapping_path: JSON mapping article index -> passage indices
        (or the inverse when `many2one='max'`).
    index_kwargs: {index_name: kwargs for `add_or_load_index`}.
    device: where dense indexes live; the GPU unless the caller names one.
    """

    def __init__(self, kb_path=None, index_mapping_path=None, many2one=None,
                 index_kwargs=None, load_dataset: bool = True, device=None):
        if load_dataset and kb_path is not None:
            if isinstance(kb_path, (str, Path)):
                from datasets import load_from_disk

                self.dataset = load_from_disk(str(kb_path))
            else:
                self.dataset = kb_path
        else:
            self.dataset = None
        self.device = device
        self.indexes: Dict[str, Index] = {}
        if index_mapping_path is None:
            self.index_mapping = None
        else:
            with open(index_mapping_path) as f:
                self.index_mapping = json.load(f, object_hook=json_integer_keys)
        self.many2one = many2one
        for index_name, kwargs in (index_kwargs or {}).items():
            self.add_or_load_index(index_name=index_name, **kwargs)

    # ---- index construction -------------------------------------------
    def add_or_load_index(self, column=None, index_name=None, kind=None,
                          key=None, **index_kwargs):
        if kind is None:
            kind = IndexKind.DENSE
        elif isinstance(kind, str):
            kind = IndexKind[kind]
        index_name = index_name or column
        key = key if key is not None else index_name
        # legacy score-interpolation config keys (applied at search time)
        normalization = index_kwargs.pop("normalization", None)
        interpolation_weight = index_kwargs.pop("interpolation_weight", None)
        if kind == IndexKind.DENSE:
            backend = None
            if column is not None:
                from viquae_torch.ops import mips

                string_factory = index_kwargs.pop("string_factory", "Flat")
                explicit_l2 = index_kwargs.pop("do_L2norm", False)
                do_l2norm = "L2norm" in string_factory or explicit_l2
                load_path = index_kwargs.pop("load_path", None)
                save_path = index_kwargs.pop("save_path", None)
                if re.search(r"IVF(\d+)", string_factory):
                    raise NotImplementedError(
                        f"string_factory {string_factory!r}: the inverted-"
                        "file index (ops/ivf.py) is not ported yet "
                        "(ROADMAP.md A17); a flat index would not be the "
                        "engine the config names")
                # streaming: true -> host-RAM KB streamed through the GPU
                # (KBs beyond device memory; ops.mips.StreamingDenseIndex)
                streaming = index_kwargs.pop("streaming", False)
                if streaming:
                    if load_path or save_path:
                        # silently ignoring these re-chunked the multi-GB
                        # column from scratch every run while the config
                        # claimed persistence
                        raise ValueError(
                            "streaming indexes are rebuilt from the host "
                            "column each run and do not support "
                            "load_path/save_path — drop those keys or use "
                            "a device DenseIndex")
                    vectors = np.asarray(self.dataset[column], dtype=np.float32)
                    index_kwargs.pop("mode", None)  # single streamed engine
                    backend = mips.StreamingDenseIndex(
                        vectors, do_l2norm=do_l2norm, device=self.device,
                        **index_kwargs)
                elif load_path and (
                    Path(str(load_path)).suffix == ".npz"
                    and Path(str(load_path)).exists()
                    or Path(str(load_path) + ".npz").exists()
                ):
                    backend = mips.DenseIndex.load(
                        load_path, device=self.device, **index_kwargs
                    )
                else:
                    vectors = np.asarray(self.dataset[column], dtype=np.float32)
                    backend = mips.DenseIndex(
                        vectors, do_l2norm=do_l2norm, device=self.device,
                        **index_kwargs,
                    )
                    if save_path:
                        backend.save(save_path)
                do_l2norm_q = backend.do_l2norm
            else:
                do_l2norm_q = False
            self.indexes[index_name] = Index(
                key=key, kind=kind, do_L2norm=do_l2norm_q, backend=backend,
                normalization=normalization,
                interpolation_weight=interpolation_weight,
            )
        elif kind == IndexKind.BM25:
            backend = None
            if column is not None:
                from viquae_torch.ops import bm25

                load_path = index_kwargs.pop("load_path", None)
                save_path = index_kwargs.pop("save_path", None)
                # device=True scores on the card (ops/bm25_device.py);
                # device_kwargs pass through to DeviceBM25 (n_head, ...)
                device = index_kwargs.pop("device", False)
                device_kwargs = {
                    key_: index_kwargs.pop(key_)
                    for key_ in ("n_head", "l_small", "l_mid", "pool_mid",
                                 "pool_small", "q_block")
                    if key_ in index_kwargs
                }
                if device == "sharded":
                    raise NotImplementedError(
                        "BM25 with device='sharded': the multi-GPU scorer "
                        "(ShardedDeviceBM25) is not ported yet (ROADMAP.md "
                        "A17); use device=True for one card")
                if load_path and Path(load_path).exists():
                    backend = bm25.BM25Index.load(load_path, **index_kwargs)
                else:
                    backend = bm25.BM25Index.build(
                        list(self.dataset[column]), **index_kwargs
                    )
                    if save_path:
                        backend.save(save_path)
                if device:
                    from viquae_torch.ops.bm25_device import DeviceBM25

                    backend = DeviceBM25(backend, device=self.device,
                                         **device_kwargs)
            self.indexes[index_name] = Index(
                key=key, kind=kind, do_L2norm=False, backend=backend,
                normalization=normalization,
                interpolation_weight=interpolation_weight,
            )
        else:
            raise ValueError(f"Unknown index kind {kind}")

    # ---- search -------------------------------------------------------
    def search_batch(self, index_name: str, queries, k: int = 100):
        """Returns (scores_batch, indices_batch) as lists per query."""
        index = self.indexes[index_name]
        if index.kind == IndexKind.DENSE:
            queries = np.asarray(queries, dtype=np.float32)
            scores, indices = index.backend.search_batch(queries, k=k)
            scores_batch, indices_batch = scores.tolist(), indices.tolist()
        else:
            scores_batch, indices_batch = index.backend.search_batch(
                list(queries), k=k)
        if (index.normalization is not None
                or index.interpolation_weight is not None):
            scores_batch = [index.transform_scores(s) for s in scores_batch]
        return scores_batch, indices_batch

    def search_batch_if_not_None(self, index_name, queries, k: int = 100):
        """None-query masking (parity ir/search.py:148-171)."""
        scores_batch: List[list] = [[] for _ in queries]
        indices_batch: List[list] = [[] for _ in queries]
        present = [
            (i, q) for i, q in enumerate(queries)
            if q is not None and not _is_nan_vector(q)
        ]
        if not present:
            return scores_batch, indices_batch
        idx, present_queries = zip(*present)
        s, ind = self.search_batch(index_name, list(present_queries), k=k)
        for j, i in enumerate(idx):
            scores_batch[i] = s[j]
            indices_batch[i] = ind[j]
        return scores_batch, indices_batch


def _is_nan_vector(q) -> bool:
    if isinstance(q, str):
        return False
    arr = np.asarray(q, dtype=np.float32)
    return bool(np.isnan(arr).all())


class Searcher:
    """Searches a query dataset through every index of every KB, building
    ranx-style runs + on-the-fly qrels (parity ir/search.py:296-459)."""

    DEFAULT_METRICS = ["mrr@100", "precision@1", "precision@20", "hit_rate@20"]

    def __init__(self, kb_kwargs: Dict, k: int = 100,
                 reference_kb_path=None, reference_key: str = "passage",
                 qrels: Optional[str] = None, qnonrels: Optional[str] = None,
                 fusion_kwargs: Optional[dict] = None,
                 metrics_kwargs: Optional[dict] = None,
                 do_fusion: Optional[bool] = None, device=None):
        self.k = k
        self.kbs: Dict[str, KnowledgeBase] = {}
        self.qrels = json.load(open(qrels)) if qrels else {}
        self.qnonrels = json.load(open(qnonrels)) if qnonrels else {}
        self.runs: Dict[str, dict] = {}

        resolved = set()
        for kb_path, kb_kwarg in kb_kwargs.items():
            # reference contract: the dict key IS the kb path; alternatively
            # the path/dataset may be given explicitly as kb_kwarg['kb_path']
            # and the key is just a label
            kb_kwarg = dict(kb_kwarg)
            kb_source = kb_kwarg.pop("kb_path", kb_path)
            rp = Path(str(kb_path)).expanduser()
            if rp in resolved:
                raise ValueError(f"duplicate KB path {kb_path}")
            resolved.add(rp)
            kb = KnowledgeBase(kb_source, device=device, **kb_kwarg)
            self.kbs[str(kb_path)] = kb
            overlap = kb.indexes.keys() & self.runs.keys()
            assert not overlap, f"All KBs should have unique index names: {overlap}"
            for index_name in kb.indexes:
                self.runs[index_name] = {}
        assert not ({"search", "fusion"} & self.runs.keys())

        self.do_fusion = (
            do_fusion if do_fusion is not None else len(self.runs) > 1
        )
        if self.do_fusion:
            assert len(self.runs) > 1

        if reference_kb_path is None:
            assert qrels is not None, (
                "need either a reference KB or precomputed qrels"
            )
            warnings.warn(
                "No reference KB -> cannot extend annotation coverage; "
                "interpret results carefully."
            )
            self.reference_kb = None
        else:
            if isinstance(reference_kb_path, (str, Path)):
                from datasets import load_from_disk

                ref = load_from_disk(str(reference_kb_path))
            else:
                ref = reference_kb_path
            if hasattr(ref, "remove_columns"):
                ref = ref.remove_columns(
                    [c for c in ref.column_names if c != reference_key]
                )
            self.reference_kb = ref
        self.reference_key = reference_key
        self.fusion_kwargs = dict(fusion_kwargs or {})
        mk = dict(metrics=list(self.DEFAULT_METRICS))
        mk.update(metrics_kwargs or {})
        self.metrics_kwargs = mk

    # ---- per-batch search ---------------------------------------------
    def __call__(self, batch: dict) -> dict:
        from viquae_torch.data.infoseek import QuestionType

        question_types = [
            QuestionType[t] for t in batch.get(
                "question_type", ["String"] * len(batch["id"])
            )
        ]
        # qrels-only mode (reference_kb=None with precomputed judgments)
        # has no "output" column to read; gt is only consumed by _judge
        outputs = (batch["output"] if self.reference_kb is not None
                   else [None] * len(batch["id"]))
        for kb in self.kbs.values():
            for index_name, index in kb.indexes.items():
                queries = batch[index.key]
                # search_batch_if_not_None handles the all-present case
                # identically (and skips the double numpy conversion a
                # separate prescan would cost)
                scores_batch, indices_batch = kb.search_batch_if_not_None(
                    index_name, queries, k=self.k
                )
                for q_id, scores, indices, gt, question_type in zip(
                    batch["id"], scores_batch, indices_batch,
                    outputs, question_types,
                ):
                    # file-loaded qrels/runs carry JSON STRING keys; an
                    # int-keyed dataset id would bypass the qnonrels cache
                    # and later clobber the file judgments on stringify
                    q_id = str(q_id)
                    run_q = self.runs[index_name].setdefault(q_id, {})
                    for score, i in zip(scores, indices):
                        penalty = 0.0
                        if kb.index_mapping is not None:
                            if int(i) not in kb.index_mapping:
                                # the reference fails loudly on an unmapped
                                # retrieved id (kb.index_mapping[i]); a
                                # .get() default silently shortened runs
                                # when the mapping was stale vs the KB
                                raise KeyError(
                                    f"retrieved id {int(i)} missing from "
                                    f"index_mapping of {index_name!r} — "
                                    "stale mapping for this KB snapshot?")
                            for j in kb.index_mapping[int(i)]:
                                j = str(j)
                                if kb.many2one is None:
                                    run_q[j] = score - penalty
                                    penalty += 1e-8
                                elif kb.many2one == "max":
                                    if j not in run_q or run_q[j] < score:
                                        run_q[j] = score
                                else:
                                    raise ValueError(
                                        f"Invalid many2one: {kb.many2one!r}"
                                    )
                        else:
                            run_q[str(i)] = float(score)
                        if len(run_q) >= self.k:
                            break
                    if self.reference_kb is not None:
                        self._judge(q_id, run_q, gt, question_type)
        return batch

    def _judge(self, q_id, run_q, gt, question_type=None):
        """Extend qrels with newly retrieved, using the qnonrels cache."""
        self.qrels.setdefault(q_id, {})
        self.qnonrels.setdefault(q_id, {})
        retrieved = (
            run_q.keys() - (self.qrels[q_id].keys() | self.qnonrels[q_id].keys())
        )
        if not retrieved:
            return
        _, relevant = find_relevant(
            retrieved,
            gt["original_answer"],
            gt["answer"],
            self.reference_kb,
            reference_key=self.reference_key,
            question_type=question_type,
        )
        self.qrels[q_id].update({str(i): 1 for i in relevant})
        self.qnonrels[q_id].update(
            {i: 0 for i in retrieved - self.qrels[q_id].keys()}
        )


def dataset_search(dataset, k: int = 100, metric_save_path=None,
                   map_kwargs: Optional[dict] = None, **kwargs):
    """Map dataset through a Searcher, evaluate, save, optionally fuse.

    Parity with ir/search.py:462-524. Returns (report, runs, qrels).
    """
    searcher = Searcher(k=k, **kwargs)
    if hasattr(dataset, "map"):
        # load_from_cache_file=False: runs/qrels fill as a SIDE CHANNEL of
        # the map — a deterministic Searcher (e.g. BM25-only, which the
        # datasets Hasher fingerprints stably) would otherwise cache-hit
        # on the second run, skip every __call__, and evaluate over empty
        # runs (same pitfall as metrics.find_relevant_dataset)
        dataset.map(searcher, batched=True,
                    **{"load_from_cache_file": False, **(map_kwargs or {})})
    else:  # plain dict of columns
        searcher(dataset)

    qrels = Qrels(searcher.qrels)
    runs = {name: Run(run, name=name) for name, run in searcher.runs.items()}

    if metric_save_path is not None:
        metric_save_path = Path(metric_save_path)
        metric_save_path.mkdir(exist_ok=True, parents=True)
        qrels.save(metric_save_path / "qrels.json")
        with open(metric_save_path / "qnonrels.json", "w") as f:
            json.dump(searcher.qnonrels, f)
        for index_name, run in runs.items():
            run.save(metric_save_path / f"{index_name}.json")

    report = rankeval_compare(qrels, list(runs.values()),
                              **searcher.metrics_kwargs)
    print(report)
    if metric_save_path is not None:
        report.save(metric_save_path / "metrics.json")
        (metric_save_path / "metrics.md").write_text(report.to_table())

    if searcher.do_fusion:
        from viquae_torch.ir.fuse import Fusion

        fusion_kwargs = dict(searcher.fusion_kwargs)
        subcommand = fusion_kwargs.pop("subcommand", "fit")
        subcommand_kwargs = fusion_kwargs.pop("subcommand_kwargs", {})
        fuser = Fusion(
            qrels=qrels, runs=list(runs.values()),
            output=metric_save_path, **fusion_kwargs,
        )
        getattr(fuser, subcommand)(**subcommand_kwargs)

    return report, runs, qrels
