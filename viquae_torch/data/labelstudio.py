"""Label Studio annotation round-trip
(parity meerqat/data/labelstudio.py:36-283): merge completions, compute
annotator agreement, assign tasks with overlap."""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def load_completions(path) -> List[dict]:
    data = json.loads(Path(path).read_text())
    return data if isinstance(data, list) else data.get("completions", [])


def merge_completions(paths: Sequence) -> List[dict]:
    """Union of tasks across annotator exports, deduped by task id; tasks
    annotated multiple times keep all annotations."""
    by_id: Dict = {}
    for path in paths:
        for task in load_completions(path):
            task_id = task.get("id")
            # legacy Label Studio exports carry per-task "completions"
            # instead of "annotations" — normalize so duplicate-task
            # merging never drops an annotator's work
            anns = task.get("annotations") or task.get("completions") or []
            if task_id in by_id:
                by_id[task_id]["annotations"].extend(anns)
            else:
                task = dict(task)
                task.pop("completions", None)
                task["annotations"] = list(anns)
                by_id[task_id] = task
    return list(by_id.values())


def retrieve_vqa(task: dict) -> Optional[dict]:
    """Extract the validated (question, answer, image) triple from one
    annotated task (labelstudio.py:169-207)."""
    data = task.get("data", {})
    annotations = task.get("annotations") or task.get("completions") or []
    if not annotations:
        return None
    annotation = annotations[0]
    results = annotation.get("result", [])
    out = {
        "image": data.get("image"),
        "question": data.get("question"),
        "answer": data.get("answer"),
        "wikidata_id": data.get("wikidata_id"),
        "id": data.get("id"),
        "discard": False,
    }
    for result in results:
        name = result.get("from_name", "")
        value = result.get("value", {})
        if name in ("discard", "validity") and value.get("choices"):
            choice = value["choices"][0].lower()
            if "discard" in choice or "invalid" in choice:
                out["discard"] = True
        elif value.get("text"):
            out[name] = value["text"][0]
    return out


def annotator_agreement(tasks: Sequence[dict]) -> Dict[str, float]:
    """Pairwise raw agreement + Cohen's kappa on the discard decision for
    tasks with >= 2 annotations (labelstudio.py:83-167)."""
    decisions: List[List[bool]] = []
    for task in tasks:
        annotations = task.get("annotations", [])
        if len(annotations) < 2:
            continue
        task_decisions = []
        for annotation in annotations[:2]:
            discard = False
            for result in annotation.get("result", []):
                value = result.get("value", {})
                # SAME discard definition as retrieve_vqa (from_name
                # gated): agreement must be computed on the decision the
                # dataset build actually uses
                if (result.get("from_name", "") in ("discard", "validity")
                        and value.get("choices")):
                    choice = value["choices"][0].lower()
                    if "discard" in choice or "invalid" in choice:
                        discard = True
            task_decisions.append(discard)
        decisions.append(task_decisions)
    if not decisions:
        return {"n_double_annotated": 0}
    agree = sum(1 for a, b in decisions if a == b)
    n = len(decisions)
    p_o = agree / n
    # Cohen's kappa
    p_a_discard = sum(1 for a, _ in decisions if a) / n
    p_b_discard = sum(1 for _, b in decisions if b) / n
    p_e = (
        p_a_discard * p_b_discard
        + (1 - p_a_discard) * (1 - p_b_discard)
    )
    kappa = (p_o - p_e) / (1 - p_e) if p_e < 1 else 1.0
    return {
        "n_double_annotated": n,
        "raw_agreement": p_o,
        "cohen_kappa": kappa,
    }


def assign_annotations(tasks: Sequence[dict], n_annotators: int,
                       overlap: int = 0) -> List[List[dict]]:
    """Partition tasks across annotators with `overlap` shared tasks for
    agreement estimation (labelstudio.py:209-236)."""
    tasks = list(tasks)
    shared = tasks[:overlap]
    rest = tasks[overlap:]
    per = len(rest) // n_annotators
    assignments = []
    for i in range(n_annotators):
        chunk = rest[i * per: (i + 1) * per] if i < n_annotators - 1 else rest[(n_annotators - 1) * per:]
        assignments.append(shared + chunk)
    return assignments
