"""In-repo BM25 sparse retrieval (the Elasticsearch / pyserini replacement).

The reference delegates sparse passage retrieval to an Elasticsearch server
(meerqat/ir/search.py:268-293) or pyserini/Lucene (:251-266), with tuned
hyperparameters b=0.3, k1=0.5 (EXPERIMENTS.rst:437). Neither Java stack is
part of this framework: BM25 becomes an in-repo component with the same
`search_batch` contract behind the `IndexKind` seam (SURVEY.md §2.3
explicitly allows a CPU-side inverted index here; scoring is vectorized
numpy over CSR postings, no per-doc Python loops).

Scoring follows Lucene's BM25Similarity:
    idf(t)  = ln(1 + (N - df + 0.5) / (df + 0.5))
    s(t, d) = idf(t) * tf / (tf + k1 * (1 - b + b * dl/avgdl))
(Lucene folds the (k1+1) numerator constant away since 8.0; it does not
change ranking. We keep it out for Lucene parity.)

Analyzer: lowercase + Unicode word pieces (\\w+), approximating ES's
`standard` analyzer (no stemming, no stopwords — matching the reference's
index config in experiments/ir/viquae/bm25/config.json).
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

_WORD = re.compile(r"\w+", re.UNICODE)


def analyze(text: str) -> List[str]:
    return _WORD.findall(text.lower())


class BM25Index:
    """CSR inverted index: postings grouped by term."""

    def __init__(self, vocab: Dict[str, int], offsets, docs, tfs, doc_len,
                 n_docs: int, k1: float = 1.2, b: float = 0.75):
        self.vocab = vocab
        self.offsets = offsets      # (V+1,) int64 — postings slice per term
        self.docs = docs            # (nnz,)  int32 — doc ids
        self.tfs = tfs              # (nnz,)  float32 — term frequencies
        self.doc_len = doc_len      # (N,)    float32
        self.n_docs = n_docs
        self.k1 = k1
        self.b = b
        self._refresh()

    def _refresh(self):
        df = np.diff(self.offsets).astype(np.float64)
        self.idf = np.log(
            1.0 + (self.n_docs - df + 0.5) / (df + 0.5)
        ).astype(np.float32)
        avgdl = self.doc_len.mean() if len(self.doc_len) else 1.0
        self.norm = (
            self.k1 * (1.0 - self.b + self.b * self.doc_len / max(avgdl, 1e-9))
        ).astype(np.float32)
        self._term_ub_cache = None  # b/k1-dependent; rebuilt lazily

    @property
    def term_ub(self) -> np.ndarray:
        """Per-term upper-bound contribution (qtf=1):
        ub(t) = idf(t) * max_{d in postings(t)} tf/(tf + norm_d) — the
        MaxScore pruning bounds (native scorer). One vectorized pass over
        the postings, cached per (k1, b)."""
        if self._term_ub_cache is None:
            n_terms = len(self.offsets) - 1
            if len(self.docs) == 0:
                self._term_ub_cache = np.zeros(n_terms, np.float32)
                return self._term_ub_cache
            contrib = self.tfs / (self.tfs + self.norm[self.docs])
            # reduceat ONLY over non-empty terms: clipping empty trailing
            # terms' starts to nnz-1 used to terminate the last non-empty
            # term's segment one posting early — an UNDERestimated upper
            # bound, i.e. rank-UNSAFE pruning (verified: postings
            # [.1,.2|.3,.9] with two trailing empty terms bounded term 1
            # at 0.3 instead of 0.9). Empty terms' bounds are 0.
            nonempty = np.diff(self.offsets) > 0
            ub = np.zeros(len(self.offsets) - 1, contrib.dtype)
            if nonempty.any():
                ub[nonempty] = np.maximum.reduceat(
                    contrib, self.offsets[:-1][nonempty])
            self._term_ub_cache = (self.idf * ub).astype(np.float32)
        return self._term_ub_cache

    def set_hyperparameters(self, k1: float = None, b: float = None):
        """Retune b/k1 without rebuilding postings (replaces the reference's
        ES close-index/put-settings/reopen dance, ir/hp.py:125-220)."""
        if k1 is not None:
            self.k1 = k1
        if b is not None:
            self.b = b
        self._refresh()

    # ---- construction --------------------------------------------------
    @classmethod
    def build(cls, texts: Sequence[str], k1: float = 1.2, b: float = 0.75
              ) -> "BM25Index":
        vocab: Dict[str, int] = {}
        term_ids: List[np.ndarray] = []
        term_tfs: List[np.ndarray] = []
        doc_len = np.zeros(len(texts), np.float32)
        for d, text in enumerate(texts):
            tokens = analyze(text)
            doc_len[d] = len(tokens)
            counts: Dict[int, int] = {}
            for tok in tokens:
                tid = vocab.setdefault(tok, len(vocab))
                counts[tid] = counts.get(tid, 0) + 1
            term_ids.append(np.fromiter(counts.keys(), np.int64, len(counts)))
            term_tfs.append(
                np.fromiter(counts.values(), np.float32, len(counts))
            )
        # flatten (doc-major) then convert to term-major CSR via argsort
        doc_of = np.concatenate(
            [np.full(len(t), d, np.int32) for d, t in enumerate(term_ids)]
        ) if term_ids else np.zeros(0, np.int32)
        tid_flat = (
            np.concatenate(term_ids) if term_ids else np.zeros(0, np.int64)
        )
        tf_flat = (
            np.concatenate(term_tfs) if term_tfs else np.zeros(0, np.float32)
        )
        order = np.argsort(tid_flat, kind="stable")
        docs = doc_of[order]
        tfs = tf_flat[order]
        counts_per_term = np.bincount(tid_flat, minlength=len(vocab))
        offsets = np.zeros(len(vocab) + 1, np.int64)
        np.cumsum(counts_per_term, out=offsets[1:])
        return cls(vocab, offsets, docs, tfs, doc_len, len(texts), k1, b)

    # ---- search --------------------------------------------------------
    def search(self, query: str, k: int = 100) -> Tuple[List[float], List[int]]:
        scores = np.zeros(self.n_docs, np.float32)
        q_counts: Dict[int, int] = {}
        for tok in analyze(query):
            tid = self.vocab.get(tok)
            if tid is not None:
                q_counts[tid] = q_counts.get(tid, 0) + 1
        for tid, qtf in q_counts.items():
            lo, hi = self.offsets[tid], self.offsets[tid + 1]
            docs = self.docs[lo:hi]
            tf = self.tfs[lo:hi]
            contrib = self.idf[tid] * qtf * tf / (tf + self.norm[docs])
            scores[docs] += contrib
        k = min(k, self.n_docs)
        if k == 0:  # empty index: np.partition(kth=-1) would raise
            return [], []
        # exact tie order (ascending doc id — the framework contract, and
        # what the C++ scorer enforces): select every doc scoring >= the
        # k-th value so boundary ties are all present, then stable-sort
        kth = -np.partition(-scores, k - 1)[k - 1]
        if kth > 0:
            cand = np.nonzero(scores >= kth)[0]
        else:  # zero-score docs are "not retrieved"
            cand = np.nonzero(scores > 0)[0]
        cand = cand[np.lexsort((cand, -scores[cand]))][:k]
        return scores[cand].tolist(), cand.tolist()

    def search_batch(self, queries: Sequence[str], k: int = 100,
                     n_threads: int = None
                     ) -> Tuple[List[List[float]], List[List[int]]]:
        """n_threads: worker threads for the C++ MaxScore driver (queries
        are embarrassingly parallel; per-query results are bitwise
        identical to sequential). None = one per host core. The attached
        VM has ONE core, so the default stays sequential here — the knob
        exists because real serving hosts have many."""
        if n_threads is None:
            import os as _os

            n_threads = _os.cpu_count() or 1
        if n_threads > 1:
            native_mt = self._maxscore_scorer_mt()
            if native_mt is not None:
                return self._search_batch_native(
                    native_mt, queries, k, maxscore=True,
                    n_threads=n_threads)
        native = self._maxscore_scorer()
        if native is not None:
            return self._search_batch_native(native, queries, k,
                                             maxscore=True)
        native = self._native_scorer()
        if native is not None:
            return self._search_batch_native(native, queries, k)
        scores_batch, indices_batch = [], []
        for q in queries:
            s, i = self.search(q, k=k)
            scores_batch.append(s)
            indices_batch.append(i)
        return scores_batch, indices_batch

    def _native_scorer(self):
        if not hasattr(self, "_native"):
            from viquae_torch.native import load_bm25_scorer

            self._native = load_bm25_scorer()
        return self._native

    def _maxscore_scorer(self):
        if not hasattr(self, "_native_maxscore"):
            from viquae_torch.native import load_bm25_maxscore

            self._native_maxscore = load_bm25_maxscore()
        return self._native_maxscore

    def _maxscore_scorer_mt(self):
        if not hasattr(self, "_native_maxscore_mt"):
            from viquae_torch.native import load_bm25_maxscore_mt

            self._native_maxscore_mt = load_bm25_maxscore_mt()
        return self._native_maxscore_mt

    def _search_batch_native(self, native, queries: Sequence[str], k: int,
                             maxscore: bool = False,
                             n_threads: int = None):
        """C++ CSR scorers (viquae_torch/native/bm25_scorer.cpp): identical
        math + tie order to the numpy path. The MaxScore variant prunes
        with per-term upper bounds (rank-safe: exact scores + tie order)
        instead of scanning every posting of every query term."""
        term_ids: List[int] = []
        term_qtfs: List[float] = []
        offsets = [0]
        for q in queries:
            counts: dict = {}
            for tok in analyze(q):
                tid = self.vocab.get(tok)
                if tid is not None:
                    counts[tid] = counts.get(tid, 0) + 1
            term_ids.extend(counts.keys())
            term_qtfs.extend(float(v) for v in counts.values())
            offsets.append(len(term_ids))
        n_queries = len(queries)
        k_eff = min(k, self.n_docs)
        out_scores = np.zeros((n_queries, k_eff), np.float32)
        out_indices = np.zeros((n_queries, k_eff), np.int32)
        out_counts = np.zeros(n_queries, np.int32)
        args = [
            np.ascontiguousarray(self.offsets, np.int64),
            np.ascontiguousarray(self.docs, np.int32),
            np.ascontiguousarray(self.tfs, np.float32),
            np.ascontiguousarray(self.idf, np.float32),
            np.ascontiguousarray(self.norm, np.float32),
        ]
        if maxscore:
            args.append(np.ascontiguousarray(self.term_ub, np.float32))
        args += [
            np.int64(self.n_docs),
            np.ascontiguousarray(term_ids, np.int32)
            if term_ids else np.zeros(0, np.int32),
            np.ascontiguousarray(term_qtfs, np.float32)
            if term_qtfs else np.zeros(0, np.float32),
            np.ascontiguousarray(offsets, np.int64),
            np.int64(n_queries),
            np.int32(k_eff),
            out_scores, out_indices, out_counts,
        ]
        if n_threads is not None:
            args.append(np.int32(n_threads))
        native(*args)
        scores_batch = [
            out_scores[q, : out_counts[q]].tolist() for q in range(n_queries)
        ]
        indices_batch = [
            out_indices[q, : out_counts[q]].tolist() for q in range(n_queries)
        ]
        return scores_batch, indices_batch

    # ---- persistence ---------------------------------------------------
    def save(self, path):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path / "postings.npz",
            offsets=self.offsets, docs=self.docs, tfs=self.tfs,
            doc_len=self.doc_len,
            meta=np.array([self.n_docs, self.k1, self.b], np.float64),
        )
        with open(path / "vocab.json", "w") as f:
            json.dump(self.vocab, f)

    @classmethod
    def load(cls, path, **hyper) -> "BM25Index":
        path = Path(path)
        data = np.load(path / "postings.npz")
        with open(path / "vocab.json") as f:
            vocab = json.load(f)
        n_docs, k1, b = data["meta"]
        idx = cls(
            vocab, data["offsets"], data["docs"], data["tfs"],
            data["doc_len"], int(n_docs), k1=float(k1), b=float(b),
        )
        if hyper:
            idx.set_hyperparameters(**hyper)
        return idx


def synth_zipf_index(n_docs: int, vocab_size: int = 400_000,
                     mean_len: int = 100, zipf_a: float = 1.2,
                     k1: float = 0.5, b: float = 0.3,
                     seed: int = 0) -> "BM25Index":
    """Synthesize a Zipf passage corpus DIRECTLY into term-major CSR
    postings (benchmark scaffolding: bench.py + scripts/bm25_bench.py use
    the same builder; `uniform_passages`-shaped ~100-token docs). Stable
    sorts keep per-term doc ids ASCENDING — the MaxScore scorer's binary
    probes require it."""
    rng = np.random.default_rng(seed)
    doc_len = rng.poisson(mean_len, n_docs).clip(20, 220).astype(np.int64)
    total = int(doc_len.sum())
    tokens = (rng.zipf(zipf_a, total).astype(np.int64) - 1) % vocab_size
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), doc_len)
    key = doc_of * vocab_size + tokens
    # (no pre-sort: np.unique sorts its own copy; a 150M-key stable sort
    # here doubled the dominant cost of index synthesis for nothing)
    uniq, tf = np.unique(key, return_counts=True)
    d = (uniq // vocab_size).astype(np.int32)
    t = (uniq % vocab_size).astype(np.int64)
    order = np.argsort(t, kind="stable")
    counts = np.bincount(t, minlength=vocab_size)
    offsets = np.zeros(vocab_size + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return BM25Index(
        {f"t{i}": i for i in range(vocab_size)}, offsets, d[order],
        tf[order].astype(np.float32), doc_len.astype(np.float32), n_docs,
        k1=k1, b=b,
    )
