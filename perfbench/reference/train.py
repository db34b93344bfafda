"""The plain reference of DPR biencoder training: both towers in f32 on
padded rows (``reference/bert.py``), DPR's in-batch negatives loss, the
global-norm clip and AdamW with the linear warm-up, written out by hand.
It imports nothing of the program.

The towers' gradients are taken in blocks of rows, so that a batch of 256
questions and 512 passages fits beside nothing else: the embeddings of the
whole batch are computed first without gradients, the loss's gradient with
respect to them is taken, and each block is then run again with gradients
and given its rows of that gradient (the "gradient cache" of Gao et al.,
arXiv:2101.06983; the same gradient as one pass over the whole batch, up
to the order of the sums).

Numbers, each the worst over the steps or the leaves compared:
- ``loss_gap``: |program's loss - reference's| / |reference's|, a step;
- ``grad_gap``: the first step's gradient as the optimizer gets it (after
  the clip); for each leaf, |program's norm - reference's norm| over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same of each leaf's change over the steps compared.
Leaves whose reference gradient is under a thousandth of the median
leaf's (a key's bias, whose gradient under softmax is nought to rounding)
move under Adam by round-off alone and are left out of both gaps.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference import bert as ref_bert

# leaves whose gradient norm is under this share of the median leaf's
NEGLIGIBLE = 1e-3


def token_rows(tokenizer, texts: Sequence[str], max_length: int):
    return tokenizer(list(texts), truncation=True,
                     max_length=max_length)["input_ids"]


def _cls(w, b, seqs, device, block):
    """[CLS] states of ``seqs`` in blocks of similar lengths, without
    gradients; (n, D) f32 and the blocks' row indices."""
    order = np.argsort([len(s) for s in seqs], kind="stable")
    blocks = [order[lo: lo + block] for lo in range(0, len(seqs), block)]
    out = torch.empty((len(seqs), b["hidden_size"]), device=device)
    with torch.no_grad():
        for rows in blocks:
            ids, mask = ref_bert.pad_rows([seqs[i] for i in rows], device)
            out[torch.as_tensor(rows, device=device)] = ref_bert.encode(
                w, b, ids, mask)[:, 0]
    return out, blocks


def _backward(w, b, seqs, blocks, grad, device):
    """Accumulates into ``w``'s ``.grad`` the gradient whose rows with
    respect to the [CLS] states are ``grad``."""
    for rows in blocks:
        ids, mask = ref_bert.pad_rows([seqs[i] for i in rows], device)
        cls = ref_bert.encode(w, b, ids, mask)[:, 0]
        g = grad[torch.as_tensor(rows, device=device)]
        (cls * g).sum().backward()


def loss_and_grads(towers: Dict[str, dict], b: dict, batch: dict, device,
                   block: int = 64) -> float:
    """One step's loss; the towers' leaves get their ``.grad``.
    ``batch``: {"question": token rows, "context": token rows (positives
    then negatives), "labels": the positive's row of each question}."""
    q, q_blocks = _cls(towers["question"], b, batch["question"], device,
                       block)
    c, c_blocks = _cls(towers["context"], b, batch["context"], device,
                       block)
    q.requires_grad_(True)
    c.requires_grad_(True)
    scores = q @ c.t()
    labels = torch.as_tensor(batch["labels"], device=device).long()
    loss = torch.nn.functional.cross_entropy(scores, labels)
    loss.backward()
    _backward(towers["question"], b, batch["question"], q_blocks, q.grad,
              device)
    _backward(towers["context"], b, batch["context"], c_blocks, c.grad,
              device)
    return float(loss.detach())


def warmup_lr(lr: float, warmup: int, total: int, step: int) -> float:
    """Linear 0 -> lr over ``warmup`` steps, then linear to 0 at
    ``total``; in float32, counted from 0 (the first update has lr 0)."""
    f32 = np.float32
    s = f32(step)
    frac = s / f32(max(1, warmup)) if step < warmup else (
        (f32(total) - s) / f32(max(1, total - warmup)))
    return float(f32(lr) * max(frac, f32(0.0)))


class AdamW:
    """torch's AdamW written out: decoupled decay, bias-corrected
    moments, eps added to the corrected root."""

    def __init__(self, leaves: List[torch.Tensor], opt: dict):
        self.leaves, self.opt = leaves, opt
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self) -> List[torch.Tensor]:
        """Clips the gradients by their global norm, takes the step and
        returns the gradients as clipped."""
        o = self.opt
        b1, b2 = o.get("betas", (0.9, 0.999))
        eps, decay = o.get("eps", 1e-8), o.get("weight_decay", 0.0)
        grads = [p.grad for p in self.leaves]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        if o.get("grad_clip") and norm >= o["grad_clip"]:
            grads = [g * (o["grad_clip"] / norm) for g in grads]
        lr = warmup_lr(o["lr"], o.get("warmup_steps", 0),
                       o["total_steps"], self.t)
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            if decay:
                p.mul_(1 - lr * decay)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr / c1 * m / (v.sqrt() / c2 ** 0.5 + eps))
        for p in self.leaves:
            p.grad = None
        return grads


def train(towers: Dict[str, dict], b: dict, batches: List[dict], opt: dict,
          device, control: bool = False) -> dict:
    """Follows the program's first steps over ``batches`` from the drawn
    ``towers`` ({"question": {name: f32 tensor}, "context": ...}, changed
    in place). Returns each step's loss, each leaf's norm of the first
    step's clipped gradient and of its change over all the steps, keyed
    "<tower>.<name>". ``control``: the products in TF32."""
    names = [(t, n) for t in ("question", "context") for n in towers[t]]
    start = {(t, n): towers[t][n].detach().clone() for t, n in names}
    for t, n in names:
        towers[t][n] = towers[t][n].detach().float().requires_grad_(True)
    leaves = [towers[t][n] for t, n in names]
    adam = AdamW(leaves, opt)
    losses, first = [], None
    with ref_bert.tf32(control):
        for batch in batches:
            losses.append(loss_and_grads(towers, b, batch, device))
            grads = adam.step()
            if first is None:
                first = {f"{t}.{n}": float(torch.linalg.vector_norm(g))
                         for (t, n), g in zip(names, grads)}
    change = {f"{t}.{n}": float(torch.linalg.vector_norm(
        towers[t][n].detach() - start[t, n])) for t, n in names}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              kept: Sequence[str]) -> Dict[str, float]:
    """Each leaf's |got - ref| over the larger of its reference norm and
    the median leaf's."""
    median = float(np.median([ref[k] for k in kept]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], median) for k in kept}


def worst(gaps: Dict[str, float], n: int = 3) -> List[tuple]:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def judge(got: dict, ref: dict) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of the program's
    readings ``got`` (as :func:`train` returns them) against the
    reference's."""
    median = float(np.median(list(ref["grad_norms"].values())))
    kept = [k for k, v in ref["grad_norms"].items()
            if v >= NEGLIGIBLE * median]
    if set(got["grad_norms"]) != set(ref["grad_norms"]) or len(
            got["losses"]) != len(ref["losses"]):
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "change_gap": float("inf")}
    grad = leaf_gaps(got["grad_norms"], ref["grad_norms"], kept)
    change = leaf_gaps(got["change_norms"], ref["change_norms"], kept)
    print(f"losses {got['losses']} against {ref['losses']}; worst leaves: "
          f"gradient {worst(grad)}, change {worst(change)}; "
          f"left out: {sorted(set(ref['grad_norms']) - set(kept))}",
          file=sys.stderr)
    return {"loss_gap": max(abs(g - r) / abs(r) for g, r in zip(
                got["losses"], ref["losses"])),
            "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}
