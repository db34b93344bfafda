"""InfoSeek evaluation: question types + numerical range matching.

Parity with meerqat/data/infoseek.py (itself the official infoseek_eval
protocol): numerical answers are scored by range containment / IoU >= 0.5
with a +/-10% tolerance around single-number answers; time and string
answers by max exact match over references.
"""
from __future__ import annotations

import enum
import re
from typing import Any, Dict, List, Sequence, Tuple, Union

from viquae_torch.train.metrics import (
    exact_match_score,
    metric_max_over_ground_truths,
)


class QuestionType(enum.Enum):
    String = 0
    Numerical = 1
    Time = 2


_NUMBER_RE = re.compile(
    r"[-+]?[.]?[\d]+(?:,\d\d\d)*[\.]?\d*(?:[eE][-+]?\d+)?"
)


def clean_str_range(text: str) -> str:
    """'9-10' -> '9 - 10' so ranges split into two numbers."""
    out = []
    for i, ch in enumerate(text):
        if ch == "-" and i >= 1 and text[i - 1].isdigit():
            out.append(" - ")
        else:
            out.append(ch)
    return "".join(out)


def find_numbers(text: str) -> Tuple[List[float], List[str]]:
    """All numbers in a string (floats + their source substrings)."""
    text = clean_str_range(text)
    raw = _NUMBER_RE.findall(text)
    numbers = []
    for n in raw:
        n_clean = n.replace(",", "").strip(".")
        if n_clean.count(".") > 1:
            n_clean = n_clean.split(".")[0]
        numbers.append(float(n_clean))
    return numbers, raw


def process_numerical_answer(text: str) -> Union[float, List[float]]:
    """String -> number or [min, max] range ([0, 0] when nothing parses)."""
    numbers, _ = find_numbers(text)
    numbers = numbers[:2]
    if len(numbers) == 2:
        lo, hi = numbers
        return [lo, hi] if lo <= hi else lo
    if len(numbers) == 1:
        return numbers[0]
    return [0, 0]


def in_range(number: float, bounds: Sequence[float]) -> bool:
    return bounds[0] <= number <= bounds[1]


def safe_division(x: float, y: float) -> float:
    return x / y if y != 0 else 0


def range_intersection_over_union(x: Sequence[float], y: Sequence[float]) -> float:
    min1, max1 = min(x), max(x)
    min2, max2 = min(y), max(y)
    overlap = max(0.0, min(max1, max2) - max(min1, min2))
    lx = (max1 - min1) + 1e-12
    ly = (max2 - min2) + 1e-12
    return safe_division(overlap, lx + ly - overlap)


def metric_numerical_range(pred, answer, tolerance: float = 0.1) -> int:
    answer = list(answer) if isinstance(answer, tuple) else answer
    pred = list(pred) if isinstance(pred, tuple) else pred
    # robustness beyond the reference: 1-element ranges behave like scalars
    if isinstance(answer, list) and len(answer) == 1:
        answer = answer[0]
    if isinstance(pred, list) and len(pred) == 1:
        pred = pred[0]
    if not isinstance(answer, list):
        # sorted: for a NEGATIVE scalar answer the official recipe
        # [a*(1-t), a*(1+t)] (reference meerqat/data/infoseek.py:60,
        # reproducing the official infoseek_eval) builds an INVERTED
        # range where even an exact prediction scores 0 — deliberate
        # deviation so elevations/temperatures evaluate correctly
        lo = answer * (1 - tolerance)
        hi = answer * (1 + tolerance)
        answer = [min(lo, hi), max(lo, hi)]
    if not isinstance(pred, list):
        return 1 if in_range(pred, answer) else 0
    if answer[0] <= pred[0] <= answer[1] and answer[0] <= pred[1] <= answer[1]:
        return 1
    return 1 if range_intersection_over_union(pred, answer) >= 0.5 - 1e-12 else 0


def find_valid_numerical_answers(answer: Sequence[str],
                                 passages: Sequence[str]) -> List[str]:
    """Numbers occurring in passages that match the answer range — used to
    build answer strings for numerical questions (ir/metrics.py:79-93)."""
    valid = []
    answer_range = [float(a) for a in answer]
    for passage in passages:
        floats, strings = find_numbers(passage)
        for f, s in zip(floats, strings):
            if metric_numerical_range(f, answer_range) == 1:
                valid.append(s)
    return valid


def numerical_relevant(answer: Sequence[str], passage: str) -> bool:
    answer_range = [float(a) for a in answer]
    numbers, _ = find_numbers(passage)
    return any(
        metric_numerical_range(n, answer_range) == 1 for n in numbers
    )


# --------------------------------------------------------------------------
# official evaluation
# --------------------------------------------------------------------------
def evaluation(predictions: List[Dict[str, Any]],
               qid2example: Dict[str, Dict[str, Any]]):
    time_pred, quantity_pred, entity_pred = [], [], []
    time_ans, quantity_ans, entity_ans = [], [], []
    for p in predictions:
        qid = p["data_id"]
        if qid not in qid2example:
            continue
        example = qid2example[qid]
        pred = p["prediction"]
        answer = example["answer_eval"]
        qtype = QuestionType[example["question_type"]]
        if qtype == QuestionType.Time:
            time_pred.append(pred)
            time_ans.append(answer)
        elif qtype == QuestionType.Numerical:
            quantity_pred.append(process_numerical_answer(pred))
            quantity_ans.append([float(a) for a in answer])
        else:
            entity_pred.append(pred)
            entity_ans.append(answer)
    score_time = [
        metric_max_over_ground_truths(exact_match_score, p, a)
        for p, a in zip(time_pred, time_ans)
    ]
    score_quantity = [
        metric_numerical_range(p, a)
        for p, a in zip(quantity_pred, quantity_ans)
    ]
    score_entity = [
        metric_max_over_ground_truths(exact_match_score, p, a)
        for p, a in zip(entity_pred, entity_ans)
    ]
    return score_time, score_quantity, score_entity


def harmonic_mean(*args: float) -> float:
    safe = [a if a != 0 else 1e-12 for a in args]
    return len(safe) / sum(1.0 / v for v in safe)


def evaluate_infoseek(predictions, qid2example) -> Dict[str, float]:
    s_time, s_num, s_str = evaluation(predictions, qid2example)
    all_scores = s_time + s_num + s_str
    return {
        "score": round(safe_division(sum(all_scores), len(all_scores)) * 100, 2),
        "score_time": round(safe_division(sum(s_time), len(s_time)) * 100, 2),
        "score_num": round(safe_division(sum(s_num), len(s_num)) * 100, 2),
        "score_string": round(safe_division(sum(s_str), len(s_str)) * 100, 2),
    }


def evaluate_infoseek_full(predictions: Dict[str, List[dict]],
                           qid2example: Dict[str, dict]) -> Dict[str, dict]:
    scores = {}
    for split, pred in predictions.items():
        split_score = evaluate_infoseek(pred, qid2example)
        split_score["split"] = split
        scores[split] = split_score
    if len(scores) >= 2:
        # the official InfoSeek headline number: harmonic mean across the
        # splits (unseen-question / unseen-entity)
        scores["final"] = {
            "score": round(
                harmonic_mean(*(s["score"] for s in scores.values())), 2
            ),
            "split": "harmonic_mean",
        }
    return scores
