"""Training objectives (counterpart of viquae_tpu/train/objectives.py).

- :func:`biencoder_loss`: DPR in-batch-negatives NLL over the (N, N*M)
  question x passage similarities;
- :func:`clip_contrastive_loss`: symmetric InfoNCE (CLIP);
- :func:`joint_mono_cross_modal_loss`: weighted sum of text-text,
  image-image and image-title similarities;
- :func:`reranker_loss`: cross-entropy over the M passage logits;
- ``ict_loss``: the biencoder objective under another data construction.

Plain functions on tensors: autograd gives their gradients. Labels equal
to :data:`IGNORE_INDEX` take no part in the mean.
"""
from __future__ import annotations

import torch

IGNORE_INDEX = -100


def _nll_from_similarities(similarities: torch.Tensor, labels: torch.Tensor):
    """Mean NLL over labels != IGNORE_INDEX; returns (loss, log_probs)."""
    log_probs = torch.log_softmax(similarities, dim=1)
    valid = labels != IGNORE_INDEX
    safe_labels = torch.where(valid, labels, 0).long()
    picked = torch.gather(log_probs, 1, safe_labels[:, None])[:, 0]
    loss = -torch.sum(picked * valid) / torch.clamp(valid.sum(), min=1)
    return loss, log_probs


def biencoder_loss(
    question_embeddings: torch.Tensor,  # (N, D)
    context_embeddings: torch.Tensor,   # (N*M, D)
    labels: torch.Tensor,               # (N,) index of the relevant
                                        #      context, or IGNORE_INDEX
):
    """DPR in-batch-negatives NLL over the (N, N*M) similarity."""
    similarities = question_embeddings.float() @ context_embeddings.float().T
    loss, log_probs = _nll_from_similarities(similarities, labels)
    return loss, {"log_probs": log_probs, "labels": labels}


def clip_contrastive_loss(
    text_embeddings: torch.Tensor,   # (N, D) L2-normalized
    image_embeddings: torch.Tensor,  # (N, D) L2-normalized
    logit_scale: torch.Tensor,       # scalar (exp of learnable temperature)
):
    """Symmetric InfoNCE (CLIP)."""
    logits = logit_scale * (text_embeddings.float()
                            @ image_embeddings.float().T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_t, _ = _nll_from_similarities(logits, labels)
    loss_i, _ = _nll_from_similarities(logits.T, labels)
    return 0.5 * (loss_t + loss_i), {"logits": logits}


def joint_mono_cross_modal_loss(
    question_embeddings: torch.Tensor,        # (N, D) text tower
    context_embeddings: torch.Tensor,         # (N*M, D) text tower
    question_image_embeddings: torch.Tensor,  # (N, Di) CLIP image
    context_image_embeddings: torch.Tensor,   # (N*M, Di) CLIP image
    context_title_embeddings: torch.Tensor,   # (N*M, Di) CLIP text of titles
    labels: torch.Tensor,                     # (N,)
    question_weight: torch.Tensor,
    image_weight: torch.Tensor,
    cm_weight: torch.Tensor,
    temperature=1.0,
):
    """Weighted 3-way similarity (text-text + image-image + image-title)."""
    sim = question_weight * (question_embeddings @ context_embeddings.T)
    sim = sim + image_weight * (
        question_image_embeddings @ context_image_embeddings.T)
    sim = sim + cm_weight * (
        question_image_embeddings @ context_title_embeddings.T)
    sim = sim * temperature
    return _nll_from_similarities(sim, labels)


def reranker_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Cross-entropy over the M candidate passages of each question.

    logits: (N, M); labels: (N,) index of the relevant passage or
    IGNORE_INDEX."""
    return _nll_from_similarities(logits, labels)


ict_loss = biencoder_loss  # same objective, different data construction
