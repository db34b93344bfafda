"""The plain reference of the reader: (question, passage) pair rows built
again from the tokenizer and the KB's token ids, the Multi-passage BERT
span head in f32 on padded rows, and the numbers that judge the program's
logits and spans.

It follows the program one step: the pairs are built from the passage ids
the program's retrieval returned (the retrieval itself is judged apart,
``reference/retrieval.py``).

Numbers (worst cases over the compared reader steps):
- ``logit_gap``: the largest difference between the program's start or end
  logit and the reference's, over every real token, as a share of the
  reference logits' root mean square;
- ``span_mismatches``: questions whose chosen span is not the best span
  of the program's own logits under the global softmax;
- ``answer_mismatches``: answers that are not the decoded tokens of the
  program's chosen span in the reference's pair rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import bert as ref_bert


def pair_rows(tokenizer, questions: Sequence[str], passage_ids, kb,
              m: int, seq: int):
    """(n*m, seq) ids, mask and token types: [CLS] q [SEP] p [SEP], the
    question cut to seq // 2 tokens, the passage to what is left."""
    q_ids = tokenizer(list(questions), add_special_tokens=False,
                      truncation=True, max_length=seq // 2)["input_ids"]
    n = len(questions)
    ids = np.zeros((n * m, seq), np.int64)
    mask = np.zeros((n * m, seq), np.int64)
    tt = np.zeros((n * m, seq), np.int64)
    for j in range(n):
        head = [tokenizer.cls_token_id] + list(q_ids[j]) \
            + [tokenizer.sep_token_id]
        budget = max(seq - len(head) - 1, 0)
        for r, d in enumerate(list(passage_ids[j])[:m]):
            row = j * m + r
            if not 0 <= int(d) < len(kb):
                continue
            p = list(kb.tokens(int(d)))[:budget]
            full = head + p + [tokenizer.sep_token_id]
            ids[row, : len(full)] = full
            mask[row, : len(full)] = 1
            tt[row, len(head): len(full)] = 1
    return ids, mask, tt


@torch.no_grad()
def logits(w, b: dict, ids, mask, tt, device, quant: Optional[str] = None,
           block: int = 96):
    """(rows, seq) start and end logits in f32."""
    starts, ends = [], []
    with ref_bert.tf32():
        for lo in range(0, len(ids), block):
            t = [torch.as_tensor(a[lo: lo + block], device=device)
                 for a in (ids, mask, tt)]
            x = ref_bert.encode(w, b, t[0], t[1], t[2], prefix="bert.",
                                quant=quant)
            out = ref_bert.linear(x, w, "qa_outputs", quant)
            starts.append(out[..., 0])
            ends.append(out[..., 1])
    return torch.cat(starts), torch.cat(ends)


def logit_gap(got_start, got_end, ref_start, ref_end, mask) -> float:
    real = torch.as_tensor(mask, device=ref_start.device).bool()
    if not real.any():
        return 0.0
    ref = torch.cat([ref_start[real], ref_end[real]])
    got = torch.cat([got_start.to(ref.device).float()[real],
                     got_end.to(ref.device).float()[real]])
    if not torch.isfinite(got).all():
        return float("inf")
    rms = ref.pow(2).mean().sqrt().clamp(min=1e-12)
    return float((got - ref).abs().max() / rms)


@torch.no_grad()
def best_spans(start_logits, end_logits, mask, m: int):
    """Each question's span scores under one softmax over its m passages'
    real tokens: (best score, score of every (passage, start, end))."""
    nm, length = start_logits.shape
    n = nm // m
    pad = ~torch.as_tensor(mask, device=start_logits.device).bool()

    def probs(x):
        x = x.float().masked_fill(pad, float("-inf"))
        return torch.softmax(x.reshape(n, m * length), -1).reshape(
            n, m, length)

    pair = torch.triu(probs(start_logits)[..., :, None]
                      * probs(end_logits)[..., None, :])
    pair[:, :, 0, :] = 0.0
    return pair.reshape(n, -1).amax(1), pair


def span_mismatches(pair_scores, best, passage, start, end,
                    rtol: float = 1e-5) -> int:
    """Questions whose chosen span (end exclusive) scores below the best
    span of the same logits by more than ``rtol`` of the best: the
    program's selection against the plain one, allowing for the order of
    the float32 operations."""
    n = best.shape[0]
    dev = best.device
    p, s, e = (torch.as_tensor(np.asarray(a), device=dev).long()
               for a in (passage, start, end))
    ok = (e - 1 >= s) & (s >= 0) & (e - 1 < pair_scores.shape[-1]) & (
        p >= 0) & (p < pair_scores.shape[1])
    chosen = torch.zeros(n, device=dev)
    idx = torch.arange(n, device=dev)[ok]
    chosen[ok] = pair_scores[idx, p[ok], s[ok], (e - 1)[ok]]
    return int((chosen < best * (1 - rtol)).sum())


def answer_mismatches(tokenizer, ids, answers: List[str], passage, start,
                      end, m: int) -> int:
    """Answers that differ from the decoded span of the chosen row."""
    ids3 = ids.reshape(len(answers), m, -1)
    bad = 0
    for i, answer in enumerate(answers):
        span = ids3[i, int(passage[i]), int(start[i]): int(end[i])]
        if tokenizer.decode(span, skip_special_tokens=True) != answer:
            bad += 1
    return bad
