"""The multi-passage reading-comprehension loss (counterpart of
``multi_passage_rc_loss`` in viquae_tpu/train/optim.py).

(N*M, L) start/end logits get ONE softmax shared across the M passages of
a question (reshape to (N, M*L)), per-answer-occurrence NLL, marginal
log-likelihood with mean reduction, legacy ``max_pooling`` flag. A plain
function on tensors: autograd gives its gradient. The optimizer, schedule
and freeze masks of the JAX module are listed in ROADMAP.md (A16).
"""
from __future__ import annotations

import torch


def multi_passage_rc_loss(
    start_logits: torch.Tensor,     # (N*M, L)
    end_logits: torch.Tensor,       # (N*M, L)
    start_positions: torch.Tensor,  # (N*M, A) token positions (A = max answers)
    end_positions: torch.Tensor,    # (N*M, A)
    answer_mask: torch.Tensor,      # (N*M, A) 1 for real answer occurrences
    m_passages: int,
    max_pooling: bool = False,
):
    """Marginal log-likelihood over all answer occurrences with a global
    softmax across each question's M passages.

    Returns (loss, start_log_probs (N*M, L), end_log_probs (N*M, L)).
    """
    nm, length = start_logits.shape
    m = m_passages
    n = nm // m
    ignored_index = length
    start_positions = start_positions.long().clamp(0, ignored_index)
    end_positions = end_positions.long().clamp(0, ignored_index)

    # shared softmax across the M passages of each question
    start_lp = torch.log_softmax(
        start_logits.reshape(n, m * length), dim=1
    ).reshape(nm, length)
    end_lp = torch.log_softmax(
        end_logits.reshape(n, m * length), dim=1
    ).reshape(nm, length)

    def nll(log_probs, positions):
        # positions == ignored_index -> 0 loss (as NLLLoss ignore_index)
        padded = torch.cat(
            [log_probs, log_probs.new_zeros((nm, 1))], dim=1
        )
        picked = torch.gather(padded, 1, positions)  # (N*M, A)
        valid = positions < ignored_index
        return -picked * valid

    span_mask = answer_mask.float()
    loss_tensor = (
        nll(start_lp, start_positions) + nll(end_lp, end_positions)
    ) * span_mask  # (N*M, A)

    if max_pooling:  # legacy ViQuAE-paper behavior
        loss_tensor = loss_tensor.reshape(n, m, -1).amax(dim=1)
    # else: keep (N*M, A) — the marginal runs over answer OCCURRENCES WITHIN
    # each passage row and the mean over all N*M rows; only the max_pooling
    # branch reshapes to (N, ...)

    # zero-loss entries are excluded from the marginal via the -1e10 trick;
    # all-zero rows contribute log(1) = 0
    marginal = torch.sum(
        torch.exp(-loss_tensor - 1e10 * (loss_tensor == 0)), dim=1
    )
    loss = -torch.mean(torch.log(marginal + (marginal == 0)))
    return loss, start_lp, end_lp
