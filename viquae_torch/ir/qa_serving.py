"""End-to-end batch QA serving: retrieve -> read -> answer strings
(counterpart of viquae_tpu/ir/qa_serving.py).

The reference runs its full pipeline (embed -> search -> read) as offline
dataset stages plus a ONE-query-at-a-time REPL. This module is the batch
deployment loop over the same stages:

- retrieval: any serving pipeline with `run_arrays` (FusedRetrievalPipeline
  / MultiIndexRetrievalPipeline) — one chain of device work per batch;
- passage fetch + (question, passage) pair tokenization on host, in a
  prefetch thread so it overlaps the reader's device compute;
- reader: no-grad MultiPassageBERT forward with the reference's GLOBAL
  softmax over all M passages per question and span selection on the
  device; only three (n,) index vectors come back to the host, through
  pinned buffers read one batch late.

While a profile runs (core/profiling.py) the loop records a
``reader.questions`` span for the questions' WordPiece, a ``reader.pairs``
span per reader batch assembled, a ``reader.step`` device span around each
reader upload and forward, and the packed canvases' real tokens and slots
in the counters ``reader.canvas_tokens`` and ``reader.canvas_slots``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from viquae_torch.core import profiling
from viquae_torch.core.device import HostCopy as _HostCopy
from viquae_torch.core.device import resolve_device, upload
from viquae_torch.core.profiling import StageTimer
from viquae_torch.ir.serving import drain_lagged
from viquae_torch.models import qa
from viquae_torch.ops import packing


def span_probabilities(start_logits, end_logits, mask, m_passages: int):
    """(n*m, L) logits -> (n, m, L) start and end probabilities under the
    reference's GLOBAL normalization: one softmax over all M passages of a
    question jointly. Pad positions (``mask`` 0) get -1e30 and can't win
    spans; a question whose rows are all masked gets a uniform
    distribution, not NaN."""
    nm, length = start_logits.shape
    n = nm // m_passages
    pad = mask <= 0

    def probabilities(logits):
        # a fill kernel, not a scalar tensor copied from the host: that copy
        # would make the dispatching thread wait for the whole reader step
        logits = logits.masked_fill(pad, -1e30)
        return torch.softmax(logits.reshape(n, m_passages * length),
                             dim=-1).reshape(n, m_passages, length)

    return probabilities(start_logits), probabilities(end_logits)


class AnswerPipeline:
    """queries (+ modal features) -> extractive answers, batched.

    Parameters
    ----------
    retrieval: serving pipeline with run_arrays(queries, ...) -> (scores,
        indices) over the PASSAGE id space.
    kb: passage dataset/list; kb[int(id)][passage_key] is the text (only
        ``len`` and integer indexing are used).
    reader_cfg / reader_params: models.qa ReaderConfig and Reader, the
        latter on ``device``.
    tokenizer: HF tokenizer for (question, passage) pairs + span decode.
    m_passages: top-M passages read per question (reference default 24).
    questions_per_step: reader batch (one fixed shape).
    device: where the reader runs; the GPU unless the caller names one.
    """

    def __init__(self, retrieval, kb, reader_cfg, reader_params, tokenizer,
                 m_passages: int = 24, reader_seq: int = 256,
                 passage_key: str = "passage",
                 passage_tokens_key: Optional[str] = None,
                 questions_per_step: int = 16,
                 timer: Optional[StageTimer] = None,
                 compute_dtype=None,
                 packed_reader: bool = False,
                 packed_rows: Optional[int] = None,
                 device=None):
        self.retrieval = retrieval
        r_k = getattr(retrieval, "k", None)
        if r_k is not None and r_k < m_passages:
            raise ValueError(
                f"retrieval returns k={r_k} passages but m_passages="
                f"{m_passages}; construct the retrieval pipeline with "
                "k >= m_passages (the fuse_ir_score path would otherwise "
                "crash on the short score rows)")
        self.device = resolve_device(device)
        self.kb = kb
        self.reader_cfg = reader_cfg
        self.reader_params = reader_params
        self.tokenizer = tokenizer
        self.M = m_passages
        self.reader_seq = reader_seq
        self.passage_key = passage_key
        # passage_tokens_key: column of PRE-TOKENIZED passage ids (no
        # special tokens). KB passages are static, so a deployment
        # tokenizes them once at index-build time; at serve time only the
        # short questions hit the tokenizer and the (question, passage)
        # pairs are assembled with numpy. Without it, tokenizing M=24
        # full pairs per question is the end-to-end bottleneck.
        self.passage_tokens_key = passage_tokens_key
        self.n_q = questions_per_step
        self.timer = timer or StageTimer("qa-serving")
        # packed_reader: run the forward on a packed canvas at the REAL
        # pair lengths (qa.reader_apply_packed); the padded ids are still
        # built host-side for span decode only
        self.packed_reader = packed_reader
        # packed_rows pins the packed canvas height to ONE shape
        # (PackedTextEmbedder.fixed_rows counterpart); batches that
        # overflow the pinned canvas fall back to an unpinned pack
        self.packed_rows = packed_rows
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.fuse_ir_score = bool(getattr(reader_cfg, "fuse_ir_score",
                                          False))

    def _postprocess(self, start_logits, end_logits, mask):
        """Span selection on the device: the host receives three (n,)
        index vectors instead of (n*m, L) log-probs."""
        return qa.get_best_spans(
            *span_probabilities(start_logits, end_logits, mask, self.M))

    # grad mode is per thread and the prefetch thread calls these, so it
    # is switched off here and not around the caller
    @torch.no_grad()
    def read(self, ids, mask, token_types, passage_scores):
        """passage_scores feed the fuse_ir_score projection when the
        reader was trained with it."""
        out = qa.reader_apply(
            self.reader_params, self.reader_cfg, ids, attention_mask=mask,
            token_type_ids=token_types, m_passages=self.M,
            passage_scores=passage_scores, compute_dtype=self.compute_dtype,
        )
        return self._postprocess(out.start_logits, out.end_logits, mask)

    @torch.no_grad()
    def read_packed(self, ids, seg, pos, tt, g_idx, g_mask, mask,
                     passage_scores):
        out = qa.reader_apply_packed(
            self.reader_params, self.reader_cfg, ids, seg, pos, tt, g_idx,
            g_mask, m_passages=self.M, passage_scores=passage_scores,
            compute_dtype=self.compute_dtype,
        )
        return self._postprocess(out.start_logits, out.end_logits, mask)

    def upload(self, *arrays):
        """Host arrays on the pipeline's device, without waiting for it."""
        return tuple(upload(a, self.device) for a in arrays)

    # ------------------------------------------------------------------
    def _encode_questions(self, queries):
        """Encode ONCE, truncated to reader_seq // 2 (the question budget;
        pair assembly happens from the encoded ids directly — a
        decode->re-encode round trip is not guaranteed token-identical)."""
        return self.tokenizer(
            list(map(str, queries)), add_special_tokens=False,
            truncation=True, max_length=self.reader_seq // 2,
        )["input_ids"]

    def _fill_pair_canvas(self, chunk, q_ids_all, doc_tokens):
        """Assemble one fixed-shape reader batch: [CLS] q [SEP] p [SEP]
        rows with token types 0/1 (BertTokenizerFast pair format,
        parity-tested). `doc_tokens[j]` lists the retrieved passages'
        token sequences for chunk[j] (<= M entries; missing docs leave
        all-zero rows). ONE fill loop serves both the pretokenized and
        the tokenize-at-serve-time producers so their span inputs cannot
        drift apart."""
        tok = self.tokenizer
        cls_id, sep_id = tok.cls_token_id, tok.sep_token_id
        seq = self.reader_seq
        nm = self.n_q * self.M
        ids = np.zeros((nm, seq), np.int32)
        mask = np.zeros((nm, seq), np.int32)
        tt = np.zeros((nm, seq), np.int32)
        row = 0
        for j, qi in enumerate(chunk):
            head = [cls_id] + list(q_ids_all[qi]) + [sep_id]
            budget = seq - len(head) - 1
            for p_ids in doc_tokens[j]:
                if not len(p_ids):
                    # empty/out-of-range passage: keep the ROW POSITION
                    # (spans map back to passage rank by row) but leave it
                    # all-zero — a live [CLS] q [SEP][SEP] row would
                    # compete in the global softmax and could win a
                    # nonsense span inside the question text
                    row += 1
                    continue
                full = head + list(p_ids)[: max(budget, 0)] + [sep_id]
                L = len(full)
                ids[row, :L] = full
                mask[row, :L] = 1
                tt[row, len(head): L] = 1
                row += 1
            row += self.M - len(doc_tokens[j])
        return ids, mask, tt

    def reader_batches(self, queries, indices):
        """Host producer: fetch top-M passages (pre-tokenized KB column,
        or tokenize at serve time) + assemble fixed-shape pair batches."""
        tok = self.tokenizer
        with profiling.span("reader.questions", questions=len(queries)):
            q_ids_all = self._encode_questions(queries)
        pretok = self.passage_tokens_key is not None
        for start in range(0, len(queries), self.n_q):
            chunk = range(start, min(start + self.n_q, len(queries)))
            n_real = len(chunk)
            with profiling.span("reader.pairs", questions=n_real):
                if pretok:
                    doc_tokens = [
                        [self.kb[int(d)][self.passage_tokens_key]
                         if 0 <= int(d) < len(self.kb) else []
                         for d in indices[qi][: self.M]]
                        for qi in chunk
                    ]
                else:
                    texts = [
                        str(self.kb[int(d)][self.passage_key])
                        if 0 <= int(d) < len(self.kb) else ""
                        for qi in chunk for d in indices[qi][: self.M]
                    ]
                    flat = tok(texts, add_special_tokens=False,
                               truncation=True,
                               max_length=self.reader_seq)["input_ids"] \
                        if texts else []
                    doc_tokens, p_i = [], 0
                    for qi in chunk:
                        n_docs = len(indices[qi][: self.M])
                        doc_tokens.append(flat[p_i: p_i + n_docs])
                        p_i += n_docs
                ids, mask, tt = self._fill_pair_canvas(chunk, q_ids_all,
                                                       doc_tokens)
            yield start, n_real, ids, mask, tt

    def pack_pairs(self, ids, mask, tt):
        """The padded pair rows packed at their real lengths: the canvas
        arrays, the token types laid on it and the gather back to the
        (n*m, reader_seq) layout."""
        lens = mask.sum(axis=1).clip(min=1)
        seqs = [ids[r, : lens[r]] for r in range(len(ids))]
        try:
            p = packing.pack_token_sequences(
                seqs, row_len=self.reader_seq,
                n_rows=self.packed_rows, pad_rows_to=16)
        except ValueError:
            # batch overflows the pinned canvas
            p = packing.pack_token_sequences(
                seqs, row_len=self.reader_seq, pad_rows_to=16)
        profiling.count_canvas("reader", p.segment_ids)
        tts = [tt[r, : lens[r]] for r in range(len(ids))]
        tt_canvas = packing.pack_parallel(p, tts)
        g_idx, g_mask = packing.gather_indices(p, self.reader_seq)
        return (p.input_ids, p.segment_ids, p.position_ids, tt_canvas,
                g_idx, g_mask)

    def run(self, queries: List[str], **retrieval_kwargs) -> List[Dict]:
        """Answer every query; returns [{"answer", "passage_ids",
        "scores"}] in input order."""
        with self.timer.stage("retrieve"):
            scores, indices = self.retrieval.run_arrays(
                queries, **retrieval_kwargs)

        answers: List[Optional[str]] = [None] * len(queries)

        def stream():
            for item in self.reader_batches(queries, indices):
                start, n_real, ids, mask, tt = item
                p_scores = None
                if self.fuse_ir_score:
                    sl = np.zeros((self.n_q, self.M), np.float32)
                    sl[:n_real] = scores[start: start + n_real, : self.M]
                    p_scores, = self.upload(sl.reshape(-1))
                with self.timer.stage("reader_dispatch"):
                    if self.packed_reader:
                        read = self.read_packed
                        arrays = (*self.pack_pairs(ids, mask, tt), mask)
                    else:
                        read, arrays = self.read, (ids, mask, tt)
                    with profiling.device_span("reader.step", self.device):
                        spans = read(*self.upload(*arrays), p_scores)
                    copy = _HostCopy(*spans)
                yield start, n_real, ids, copy

        def drain_one(item):
            start, n_real, ids, copy = item
            with self.timer.stage("decode"):
                passage, s_idx, e_idx = (a.numpy() for a in copy.result())
                ids3 = ids.reshape(self.n_q, self.M, self.reader_seq)
                for i in range(n_real):
                    span = ids3[i, passage[i], s_idx[i]: e_idx[i]]
                    answers[start + i] = self.tokenizer.decode(
                        span, skip_special_tokens=True)

        # prefetch: batch i+1 tokenizes while batch i reads on device;
        # lagged drain overlaps span decode with the next reader step
        drain_lagged(stream(), drain_one)

        return [
            {
                "answer": answers[i],
                "passage_ids": indices[i][: self.M].tolist(),
                "scores": scores[i][: self.M].tolist(),
            }
            for i in range(len(queries))
        ]

    def report(self) -> dict:
        return self.timer.report()
