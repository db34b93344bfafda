"""Relevance judgment + qrels construction + run comparison (host side).

Parity with meerqat/ir/metrics.py: a passage is relevant for a question iff
it contains (word-boundary regex, after squad normalization) the original or
an alternative answer (:79-124); provenance-based qrels construction walks
article->passage mappings (:127-203); runs are compared with rankeval
(replacing ranx, :237-313).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from viquae_torch.data.loading import answer_preprocess
from viquae_torch.rankeval import Qrels, Run, compare as rankeval_compare


def find_relevant(
    retrieved: Sequence[int],
    original_answer: str,
    alternative_answers: Sequence[str],
    kb,
    reference_key: str = "passage",
    question_type=None,
) -> Tuple[List[int], List[int]]:
    """Split `retrieved` into (original_relevant, relevant) passage indices.

    kb: anything indexable by int returning a dict with `reference_key`
    (an HF Dataset or a list of dicts). For InfoSeek Numerical questions a
    passage is relevant if it holds any number in the answer range.
    """
    from viquae_torch.data.infoseek import QuestionType, numerical_relevant

    original_relevant, relevant = [], []
    original = answer_preprocess(original_answer)
    alternatives = [answer_preprocess(a) for a in alternative_answers]
    numerical = question_type == QuestionType.Numerical
    for i in retrieved:
        i = int(i)
        raw_passage = kb[i][reference_key]
        if numerical and numerical_relevant(alternative_answers, raw_passage):
            original_relevant.append(i)
            relevant.append(i)
            continue
        passage = answer_preprocess(raw_passage)
        if original and re.search(rf"\b{re.escape(original)}\b", passage):
            original_relevant.append(i)
            relevant.append(i)
            continue
        for answer in alternatives:
            if answer and re.search(rf"\b{re.escape(answer)}\b", passage):
                relevant.append(i)
                break
    return original_relevant, relevant


def find_relevant_item(
    item: dict,
    passages,
    title2index: Dict[str, int],
    article2passage: Optional[Dict[int, List[int]]] = None,
    reference_key: str = "passage",
    save_as: str = "provenance_indices",
    qrels: Optional[dict] = None,
) -> dict:
    """Label which provenance passages hold the answer; fills `qrels`."""
    titles = {
        provenance["title"][0] for provenance in item["output"]["provenance"]
    }
    original_relevant, relevant = [], []
    # sorted: set iteration order is hash-seed-dependent, which would make
    # the saved provenance_indices column order differ run-to-run
    for title in sorted(titles):
        if title not in title2index:
            continue
        article_index = title2index[title]
        passage_indices = (
            [article_index]
            if article2passage is None
            else article2passage.get(article_index, [])
        )
        o, r = find_relevant(
            passage_indices,
            item["output"]["original_answer"],
            item["output"]["answer"],
            passages,
            reference_key=reference_key,
        )
        original_relevant.extend(o)
        relevant.extend(r)
    item[f"original_answer_{save_as}"] = original_relevant
    item[save_as] = relevant
    if qrels is not None:
        qrels[item["id"]] = {str(i): 1 for i in relevant}
    return item


def find_relevant_dataset(dataset_path, save_as: str = "provenance_indices",
                          **kwargs):
    from datasets import DatasetDict, load_from_disk

    dataset_path = Path(dataset_path)
    dataset = load_from_disk(dataset_path)
    qrels: dict = {}
    kwargs.update(save_as=save_as, qrels=qrels)
    # load_from_cache_file=False: qrels fills as a side channel, which a
    # cache replay would leave empty
    dataset = dataset.map(
        find_relevant_item, fn_kwargs=kwargs, load_from_cache_file=False
    )
    from viquae_torch.ir.embedding import save_in_place

    save_in_place(dataset, dataset_path)  # Arrow forbids in-place overwrite
    if isinstance(dataset, DatasetDict):
        for split, subset in dataset.items():
            Qrels({q: qrels[q] for q in subset["id"]}).save(
                dataset_path / split / f"{save_as}.json"
            )
    else:
        Qrels(qrels).save(dataset_path / f"{save_as}.json")
    return dataset


def fuse_qrels(qrels_paths: Sequence) -> Qrels:
    """Union multiple qrels files, erroring on contradictions."""
    if len(qrels_paths) == 1:
        return Qrels.from_file(qrels_paths[0])
    final: Dict[str, Dict[str, float]] = {}
    for i, path in enumerate(qrels_paths):
        qrels = Qrels.from_file(path)
        for q_id, rels in qrels.items():
            final.setdefault(q_id, {})
            for doc_id, score in rels.items():
                if doc_id in final[q_id] and final[q_id][doc_id] != score:
                    raise ValueError(
                        f"{path} contradicts a prior qrels: got {score} and "
                        f"{final[q_id][doc_id]} for '{q_id}'/'{doc_id}'"
                    )
                final[q_id][doc_id] = score
    return Qrels(final)


def load_runs(runs_paths: Sequence = (), runs_dict: Optional[dict] = None,
              filter_q_ids: Sequence[str] = ()) -> List[Run]:
    runs = [Run.from_file(p) for p in runs_paths]
    for name, run in (runs_dict or {}).items():
        runs.append(Run(run, name=name))
    if filter_q_ids:
        drop = set(filter_q_ids)
        runs = [
            Run({q: r for q, r in run.items() if q not in drop}, name=run.name)
            for run in runs
        ]
    return runs


def compare(qrels_path, runs_paths=(), runs_dict=None, filter_q_ids=(),
            output_path=None, **kwargs):
    """Load qrels+runs from disk, compare, save JSON report."""
    qrels = Qrels.from_file(qrels_path)
    if filter_q_ids:
        qrels = Qrels({q: r for q, r in qrels.items() if q not in set(filter_q_ids)})
    runs = load_runs(runs_paths, runs_dict, filter_q_ids)
    report = rankeval_compare(qrels, runs, **kwargs)
    if output_path is not None:
        output_path = Path(output_path)
        output_path.mkdir(exist_ok=True, parents=True)
        report.save(output_path / "metrics.json")
        (output_path / "metrics.md").write_text(report.to_table())
    return report


def cat_breakdown(runs, qrels, cats: Dict[str, List[str]],
                  metric: str = "precision@1") -> Dict[str, Dict[str, float]]:
    """Per-category mean metric breakdown (ir/metrics.py:316-364)."""
    from viquae_torch.rankeval.metrics import per_query_scores

    out: Dict[str, Dict[str, float]] = {}
    for run in runs:
        q_ids = list(qrels.keys())
        scores = per_query_scores(qrels, run, metric, q_ids=q_ids)
        by_q = dict(zip(q_ids, scores))
        result = {}
        for cat, members in cats.items():
            # mean over JUDGED members only: counting category ids absent
            # from the qrels as 0.0 would silently deflate the category
            # metric by found/total instead of reporting the judged mean
            judged = [by_q[q] for q in members if q in by_q]
            result[cat] = sum(judged) / len(judged) if judged else 0.0
        out[run.name or "run"] = result
    return out


def get_wtl_table(per_query_a, per_query_b) -> Dict[str, int]:
    """Win/tie/loss counts of a vs b over shared queries."""
    wins = ties = losses = 0
    for q, a in per_query_a.items():
        b = per_query_b.get(q)
        if b is None:
            continue
        if a > b:
            wins += 1
        elif a == b:
            ties += 1
        else:
            losses += 1
    return {"win": wins, "tie": ties, "loss": losses}
