"""Training-side metrics (parity with meerqat/train/metrics.py).

- :func:`batch_retrieval` / :func:`accumulate_batch_metrics` <- :10-74:
  in-batch MRR@N*M and hits@1, vectorized.
- :func:`get_run` <- :77-102: reranker logits -> rankeval Run.
- squad EM/F1 (+ per-question variants for significance tests) <- :105-178.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from viquae_torch.data.loading import answer_preprocess
from viquae_torch.rankeval import Run

IGNORE_INDEX = -100


def batch_retrieval(log_probs, labels, ignore_index: int = IGNORE_INDEX
                    ) -> Dict[str, float]:
    """In-batch retrieval counts for one batch (normalize with
    accumulate_batch_metrics)."""
    log_probs = np.asarray(log_probs)
    labels = np.asarray(labels)
    batch_size = log_probs.shape[0]
    valid = labels != ignore_index
    ranks = np.empty(batch_size, np.int64)
    order = np.argsort(-log_probs, axis=1, kind="stable")
    for i in range(batch_size):
        if valid[i]:
            ranks[i] = int(np.nonzero(order[i] == labels[i])[0][0]) + 1
        else:
            ranks[i] = 0
    mrr = float(np.sum(np.where(valid, 1.0 / np.maximum(ranks, 1), 0.0)))
    hits = int(np.sum(valid & (ranks == 1)))
    return {
        "MRR@N*M": mrr,
        "hits@1": hits,
        "ignored_predictions": int((~valid).sum()),
        "batch_size": batch_size,
    }


def accumulate_batch_metrics(batch_metrics: Sequence[dict]) -> Dict[str, float]:
    metrics: Counter = Counter()
    for m in batch_metrics:
        for k, v in m.items():
            metrics[k] += v
    effective = (metrics.pop("batch_size", 0)
                 - metrics.pop("ignored_predictions", 0))
    if effective <= 0:
        # every prediction ignored (e.g. a dev split with no relevant
        # passages) or an empty eval iterable: report zeros instead of
        # killing the whole fit with a ZeroDivisionError mid-eval
        return {k: 0.0 for k in metrics}
    return {k: v / effective for k, v in metrics.items()}


def get_run(eval_outputs: Sequence[dict], ir_run: Run) -> Run:
    """Re-rank an IR run with reranker logits (parity :77-102)."""
    run: Dict[str, dict] = {}
    for batch in eval_outputs:
        logits = np.asarray(batch["logits"])
        n, m = logits.shape
        question_ids = [batch["ids"][i] for i in range(0, n * m, m)]
        rankings = np.argsort(-logits, axis=1, kind="stable")
        for ranking, logit, q_id in zip(rankings, logits, question_ids):
            ir_results = ir_run[q_id] if q_id in ir_run else {}
            if not ir_results:
                run[q_id] = ir_results
            else:
                doc_ids = list(ir_results.keys())[:m]
                run[q_id] = {
                    doc_ids[i]: float(logit[i])
                    for i in ranking if i < len(doc_ids)
                }
    return Run(run)


# --------------------------------------------------------------------------
# squad EM/F1
# --------------------------------------------------------------------------
def exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(answer_preprocess(prediction) == answer_preprocess(ground_truth))


def f1_score(prediction: str, ground_truth: str) -> float:
    pred_tokens = answer_preprocess(prediction).split()
    gt_tokens = answer_preprocess(ground_truth).split()
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def metric_max_over_ground_truths(metric_fn, prediction, ground_truths):
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def squad(predictions: List[str], references: List[List[str]]) -> Dict[str, float]:
    assert len(predictions) == len(references)
    em = f1 = 0.0
    for pred, gts in zip(predictions, references):
        em += metric_max_over_ground_truths(exact_match_score, pred, gts)
        f1 += metric_max_over_ground_truths(f1_score, pred, gts)
    n = len(references)
    return {"exact_match": em / n, "f1": f1 / n}


def squad_per_question(predictions, references) -> Dict[str, List[float]]:
    assert len(predictions) == len(references)
    em, f1 = [], []
    for pred, gts in zip(predictions, references):
        em.append(metric_max_over_ground_truths(exact_match_score, pred, gts))
        f1.append(metric_max_over_ground_truths(f1_score, pred, gts))
    return {"exact_match": em, "f1": f1}
