"""The plain reference of retrieval: the question tower in f32 over the
tokenizer's own ids, then an exact f32 search of the KB, and the numbers
that judge a program's top-k against it.

Numbers (each a worst case over the compared questions):
- ``rank_gap``: by how much the program's j-th passage scores below the
  reference's j-th, in the reference's own scores, as a share of the
  question's best reference score;
- ``score_gap``: how far the score the program returned for a passage lies
  from the reference's score of that passage, as the same share;
- ``bad_ids``: ids outside the KB or repeated within one question.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from perfbench.reference import bert as ref_bert


def question_ids(tokenizer, texts, row_len: int):
    return tokenizer(list(texts), truncation=True,
                     max_length=row_len)["input_ids"]


@torch.no_grad()
def embed(w, b: dict, tokenizer, texts, row_len: int, device,
          quant: Optional[str] = None, block: int = 256) -> torch.Tensor:
    """(n, D) f32 [CLS] states of ``texts`` (no pooler: DPR)."""
    seqs = question_ids(tokenizer, texts, row_len)
    out = []
    with ref_bert.tf32():
        for lo in range(0, len(seqs), block):
            ids, mask = ref_bert.pad_rows(seqs[lo: lo + block], device)
            out.append(ref_bert.encode(w, b, ids, mask, quant=quant)[:, 0])
    return torch.cat(out)


@torch.no_grad()
def search(q: torch.Tensor, kb: torch.Tensor, k: int,
           quant: Optional[str] = None, block: int = 64):
    """Exact top-``k`` of ``q`` (n, D) f32 against ``kb`` (N, D): f32
    products of the (rounded) operands; (scores f32, ids int64),
    descending."""
    kb_f = ref_bert.rounded(kb.float(), quant)
    q = ref_bert.rounded(q, quant)
    scores, ids = [], []
    with ref_bert.tf32():
        for lo in range(0, q.shape[0], block):
            s = q[lo: lo + block] @ kb_f.t()
            top = torch.topk(s, k, dim=1)
            scores.append(top.values)
            ids.append(top.indices)
    return torch.cat(scores), torch.cat(ids)


@torch.no_grad()
def scores_of(q: torch.Tensor, kb: torch.Tensor, ids: torch.Tensor
              ) -> torch.Tensor:
    """f32 reference scores of passages ``ids`` (n, k) for ``q`` (n, D)."""
    with ref_bert.tf32():
        rows = kb[ids.clamp(0, kb.shape[0] - 1).long()].float()
        return torch.einsum("nkd,nd->nk", rows, q)


@torch.no_grad()
def judge(got_scores, got_ids, q_ref: torch.Tensor, kb: torch.Tensor,
          k: int, ref_top: Optional[torch.Tensor] = None) -> dict:
    """``rank_gap``, ``score_gap`` and ``bad_ids`` of a program's (n, k)
    scores and ids against the reference question vectors ``q_ref``."""
    dev = q_ref.device
    got_ids = torch.as_tensor(np.asarray(got_ids), device=dev).long()
    got_scores = torch.as_tensor(np.asarray(got_scores, np.float32),
                                 device=dev)
    n_kb = kb.shape[0]
    outside = (got_ids < 0) | (got_ids >= n_kb)
    sorted_ids = torch.sort(got_ids, dim=1).values
    repeated = (sorted_ids[:, 1:] == sorted_ids[:, :-1]).sum()
    if ref_top is None:
        ref_top = search(q_ref, kb, k)[0]
    theirs = scores_of(q_ref, kb, got_ids)
    scale = ref_top[:, :1].abs().clamp(min=1e-6)
    rank_gap = ((ref_top[:, : got_ids.shape[1]] - theirs) / scale).clamp(
        min=0)
    score_gap = (got_scores - theirs).abs() / scale
    valid = ~outside
    return {"rank_gap": float(rank_gap[valid].max()) if valid.any()
            else float("inf"),
            "score_gap": float(score_gap[valid].max()) if valid.any()
            else float("inf"),
            "bad_ids": int(outside.sum() + repeated)}
