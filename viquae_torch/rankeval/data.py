"""Qrels/Run containers, file-format compatible with ranx.

JSON format: ``{q_id: {doc_id: score}}``. TREC format:
``q_id Q0 doc_id rank score run_name`` for runs and
``q_id 0 doc_id rel`` for qrels.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

Results = Dict[str, float]


class _DictLike:
    _payload_attr: str

    def __init__(self, data: Optional[Dict[str, Results]] = None, name: Optional[str] = None):
        self._data: Dict[str, Results] = {}
        if data:
            for q_id, results in data.items():
                self._data[str(q_id)] = {str(d): float(s) for d, s in results.items()}
        self.name = name

    # dict-ish surface
    def __getitem__(self, q_id) -> Results:
        return self._data[str(q_id)]

    def __setitem__(self, q_id, results: Results):
        self._data[str(q_id)] = {str(d): float(s) for d, s in results.items()}

    def __contains__(self, q_id) -> bool:
        return str(q_id) in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Results]:
        return self._data

    @classmethod
    def from_dict(cls, data: Dict[str, Results], name: Optional[str] = None):
        return cls(data, name=name)

    # ---- io -----------------------------------------------------------
    def save(self, path, kind: Optional[str] = None):
        path = Path(path)
        kind = kind or ("trec" if path.suffix in (".trec", ".txt") else "json")
        if kind == "json":
            path.write_text(json.dumps(self._data))
        else:
            path.write_text("\n".join(self._trec_lines()) + "\n")

    @classmethod
    def from_file(cls, path, kind: Optional[str] = None, name: Optional[str] = None):
        path = Path(path)
        kind = kind or ("trec" if path.suffix in (".trec", ".txt") else "json")
        obj = cls(name=name)
        if kind == "json":
            obj._data = {
                str(q): {str(d): float(s) for d, s in res.items()}
                for q, res in json.loads(path.read_text()).items()
            }
        else:
            obj._parse_trec(path.read_text())
        if obj.name is None:
            obj.name = path.stem
        return obj


class Qrels(_DictLike):
    """Relevance judgments: q_id -> doc_id -> integer relevance grade."""

    def _trec_lines(self) -> List[str]:
        return [
            f"{q} 0 {d} {int(s)}"
            for q, res in self._data.items()
            for d, s in res.items()
        ]

    def _parse_trec(self, text: str):
        for line in text.splitlines():
            parts = line.split()
            if len(parts) < 4:
                continue
            q, _, d, rel = parts[:4]
            self._data.setdefault(q, {})[d] = float(rel)

    @property
    def qrels(self):  # ranx attr-compat
        return self._data


class Run(_DictLike):
    """Retrieval results: q_id -> doc_id -> score (higher is better)."""

    def _trec_lines(self) -> List[str]:
        name = self.name or "run"
        lines = []
        for q, res in self._data.items():
            ranked = sorted(res.items(), key=lambda kv: -kv[1])
            lines += [
                f"{q} Q0 {d} {rank + 1} {s} {name}"
                for rank, (d, s) in enumerate(ranked)
            ]
        return lines

    def _parse_trec(self, text: str):
        for line in text.splitlines():
            parts = line.split()
            if len(parts) < 6:
                continue
            q, _, d, _, score, name = parts[:6]
            self._data.setdefault(q, {})[d] = float(score)
            if self.name is None:
                self.name = name

    @property
    def run(self):  # ranx attr-compat
        return self._data

    # ---- dense view ----------------------------------------------------
    def to_padded(self, q_ids: Optional[Iterable[str]] = None, k: Optional[int] = None
                  ) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """(q_ids, doc_ids (Q,K) object array with '' padding, scores (Q,K) with -inf).

        Docs are sorted by descending score; ties keep insertion order, the
        same contract as ranx/FAISS (stable sort on negated scores).
        """
        q_ids = list(q_ids if q_ids is not None else self._data.keys())
        per_q = []
        for q in q_ids:
            res = self._data.get(str(q), {})
            docs = list(res.keys())
            scores = np.asarray(list(res.values()), dtype=np.float64)
            order = np.argsort(-scores, kind="stable")
            per_q.append(([docs[i] for i in order], scores[order]))
        width = k if k is not None else max((len(d) for d, _ in per_q), default=0)
        doc_mat = np.full((len(q_ids), width), "", dtype=object)
        score_mat = np.full((len(q_ids), width), -np.inf, dtype=np.float64)
        for row, (docs, scores) in enumerate(per_q):
            n = min(len(docs), width)
            doc_mat[row, :n] = docs[:n]
            score_mat[row, :n] = scores[:n]
        return q_ids, doc_mat, score_mat

    @classmethod
    def from_ranked_arrays(cls, q_ids, doc_ids, scores, name=None, valid=None) -> "Run":
        """Build from (Q, K) arrays (e.g. MIPS output). `valid` masks out pads."""
        data: Dict[str, Results] = {}
        doc_ids = np.asarray(doc_ids)
        scores = np.asarray(scores)
        for row, q in enumerate(q_ids):
            res = {}
            for col in range(doc_ids.shape[1]):
                if valid is not None and not valid[row, col]:
                    continue
                res[str(doc_ids[row, col])] = float(scores[row, col])
            data[str(q)] = res
        return cls(data, name=name)
