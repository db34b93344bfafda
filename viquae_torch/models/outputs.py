"""Typed model outputs (counterpart of viquae_tpu/models/outputs.py):
lightweight NamedTuples of tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class EncoderOutput(NamedTuple):
    pooler_output: Optional[torch.Tensor] = None
    # summed MoE load-balance aux, else None
    moe_aux: Optional[torch.Tensor] = None


class ECAEncoderOutput(NamedTuple):
    pooler_output: Optional[torch.Tensor] = None
    last_hidden_state: Optional[torch.Tensor] = None
    moe_aux: Optional[torch.Tensor] = None


class BiEncoderOutput(NamedTuple):
    question_pooler_output: Optional[torch.Tensor] = None
    context_pooler_output: Optional[torch.Tensor] = None


class JointMonoAndCrossModalOutput(NamedTuple):
    question_pooler_output: Optional[torch.Tensor] = None
    context_pooler_output: Optional[torch.Tensor] = None
    question_image_output: Optional[torch.Tensor] = None
    context_image_output: Optional[torch.Tensor] = None
    context_title_output: Optional[torch.Tensor] = None


class ReaderOutput(NamedTuple):
    loss: Optional[torch.Tensor] = None
    start_logits: Optional[torch.Tensor] = None
    end_logits: Optional[torch.Tensor] = None
    start_log_probs: Optional[torch.Tensor] = None
    end_log_probs: Optional[torch.Tensor] = None
    moe_aux: Optional[torch.Tensor] = None


class ReRankerOutput(NamedTuple):
    loss: Optional[torch.Tensor] = None
    logits: Optional[torch.Tensor] = None
    moe_aux: Optional[torch.Tensor] = None
