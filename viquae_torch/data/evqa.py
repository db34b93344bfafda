"""Encyclopedic-VQA evaluation (parity meerqat/data/evqa.py, itself the
official encyclopedic-VQA protocol): answer normalization with digit/
contraction standardization, single-answer exact match, multi-answer list
IoU >= 0.5, optional BEM (BERT answer equivalence) scoring gated behind
TF-hub availability.
"""
from __future__ import annotations

import re
import string
from typing import Callable, Dict, List, Optional, Sequence

_PUNCTUATION = set(string.punctuation)

_DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't",
    "havent": "haven't", "isnt": "isn't", "shouldnt": "shouldn't",
    "wasnt": "wasn't", "werent": "weren't", "wont": "won't",
    "wouldnt": "wouldn't",
}


def preprocess_answer(answer: str, replacement_character: str = "") -> str:
    answer = answer.lower().replace("\n", " ").replace("\t", " ").strip()
    if answer.startswith("<extra_id_0> "):
        answer = answer.replace("<extra_id_0> ", replacement_character)
    answer = "".join(
        replacement_character if c in _PUNCTUATION else c for c in answer
    )
    answer = re.sub(r"\b(the answer is|a|an|the)\b", " ", answer)
    words = []
    for w in answer.split():
        w = _DIGIT_MAP.get(w, w)
        w = _CONTRACTIONS.get(w, w)
        words.append(w)
    return " ".join(words)


def singleanswer_exact_match(reference: str, candidate: str) -> bool:
    ref = preprocess_answer(reference)
    if not ref:
        raise ValueError("Reference answer is empty after preprocessing.")
    return ref == preprocess_answer(candidate)


def list_intersection_over_union(target: Sequence[str],
                                 prediction: Sequence[str]) -> float:
    if not target:
        raise ValueError("Target list should not be empty.")
    t, p = set(target), set(prediction)
    return len(t & p) / len(t | p)


def multianswer_exact_match(reference: str, candidate: str,
                            iou_threshold: float = 0.5) -> bool:
    refs = [preprocess_answer(a) for a in reference.split("&&")]
    refs = [a for a in refs if a]
    if not refs:
        raise ValueError("Reference list is empty after preprocessing.")
    cands = candidate.replace(" and ", ",").replace(" & ", ",").split(",")
    cands = [preprocess_answer(a) for a in cands]
    cands = [a for a in cands if a]
    return list_intersection_over_union(refs, cands) >= iou_threshold


def exact_match_scoring_function(example: dict) -> bool:
    if example.get("question_type") == "multi_answer":
        return multianswer_exact_match(example["reference"], example["candidate"])
    return singleanswer_exact_match(example["reference"], example["candidate"])


def initialize_bem_scoring_function(
    scorer=None,
    model_url: Optional[str] = None,
    vocab_path: Optional[str] = None,
) -> Callable[[dict], bool]:
    """BEM (BERT answer equivalence, arxiv 2202.07654) scoring function —
    parity with meerqat/data/evqa.py:295-386.

    Pass a :class:`viquae_torch.models.bem.BEMScorer` (the in-repo JAX BERT
    scorer: offline-constructible, weight-portable) as `scorer`; the
    original TF-hub SavedModel path stays available when tensorflow_hub is
    installed and `model_url` is given."""
    if scorer is None and model_url is not None:
        try:
            import tensorflow_hub  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "the TF-hub BEM path requires tensorflow_hub; construct a "
                "viquae_torch.models.bem.BEMScorer instead"
            ) from e
        raise NotImplementedError(
            "load the BEM SavedModel on a TF-enabled host; the supported "
            "path in this framework is models.bem.BEMScorer"
        )
    if scorer is None:
        raise ValueError(
            "pass scorer=models.bem.BEMScorer(params=..., tokenizer=...)"
        )
    if not callable(scorer):
        # catch legacy positional calls like (model_url) immediately instead
        # of failing at the first scored example
        raise TypeError(
            f"scorer must be callable (e.g. models.bem.BEMScorer), got "
            f"{type(scorer).__name__}; pass TF-hub URLs via model_url="
        )

    def score_example(example: dict, threshold_score: bool = True):
        if not example.get("reference"):
            raise ValueError("Reference answer cannot be empty.")
        if example.get("question_type") in ("list", "multianswer",
                                            "multi_answer"):
            example = {**example,
                       "reference": example["reference"].replace("&&", ",")}
        return scorer(example, threshold_score=threshold_score)

    return score_example


def encyclopedic_vqa_evaluation_function(example: dict,
                                         bem_scoring_function: Callable
                                         ) -> float:
    """Official EVQA scoring (meerqat/data/evqa.py:389+): Exact Match
    first; only when EM fails fall back to BEM (for single-answer
    questions EM is strictly stricter than BEM, so this equals pure BEM
    but much faster). '|'-joined reference alternatives take the MAX of
    the full EM+BEM score per alternative (the reference's
    evaluate_example loops the whole function over reference_list) —
    BEM must never see the joined string."""
    if (example.get("question_type") != "multi_answer"
            and "|" in example.get("reference", "")):
        return max(
            encyclopedic_vqa_evaluation_function(
                {**example, "reference": r}, bem_scoring_function)
            for r in example["reference"].split("|")
        )
    if evaluate_example(example, exact_match_scoring_function):
        return 1.0
    return float(bem_scoring_function(example))


def evaluate_example(example: dict,
                     scoring_function: Callable = exact_match_scoring_function
                     ) -> bool:
    """One example = {'reference', 'candidate', 'question_type'?}. Multiple
    references may be '&&'-joined for multi_answer or '|'-joined
    alternatives for single answer."""
    if example.get("question_type") != "multi_answer" and "|" in example.get(
        "reference", ""
    ):
        return any(
            scoring_function({**example, "reference": r})
            for r in example["reference"].split("|")
        )
    return scoring_function(example)


def evaluate(predictions: Dict[str, str], references: Dict[str, dict],
             scoring_function: Callable = exact_match_scoring_function
             ) -> Dict[str, float]:
    """predictions: {question_id: answer}; references: {question_id:
    {'reference', 'question_type'?}}."""
    scores = []
    for qid, candidate in predictions.items():
        if qid not in references:
            continue
        example = {**references[qid], "candidate": candidate}
        scores.append(float(evaluate_example(example, scoring_function)))
    return {
        "accuracy": sum(scores) / len(scores) if scores else 0.0,
        "n_evaluated": len(scores),
    }
