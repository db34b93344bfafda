"""ViLT: single-stream vision-and-language transformer (counterpart of
viquae_tpu/models/vilt.py).

A pre-LN ViT over the concatenated [text tokens | CLS + patches] sequence
with modality-type embeddings. The patch grid is static: images come at
``image_size`` and a checkpoint's position embeddings are interpolated to
that grid when it is loaded (:func:`params_from_hf`). On top of the
encoder, :func:`vilt_for_ir_apply` (CLS pooling, the reference's
``ViltForIR``) and :func:`multi_passage_vilt_apply` (span extraction over
the text segment with the global multi-passage softmax, the reference's
``MultiPassageVilt``).

:class:`Vilt` holds the weights named as the JAX tree (``text.{word,
position, token_type, ln}``, ``cls_token``, ``patch_embedding``,
``position_embeddings``, ``modality_type``, ``blocks[i].{ln_before,
attention, ln_after, mlp}``, ``final_ln``, ``pooler``), so
``convert.module_from_tree`` loads a JAX tree and
``convert.tree_from_module`` writes one. Pixel values come in the JAX
layout, (B, H, W, 3) or (B, n_images, H, W, 3). The patch step is an f32
convolution whatever ``compute_dtype`` is (TF32 off,
``core/device.py``); ``compute_dtype`` reaches the attention and MLP
products only, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from viquae_torch.models import layers as L
from viquae_torch.models.outputs import EncoderOutput, ReaderOutput


@dataclasses.dataclass(frozen=True)
class ViltConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 40
    type_vocab_size: int = 2
    modality_type_vocab_size: int = 2
    image_size: int = 384
    patch_size: int = 32
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu_exact"
    n_images: int = 1

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class ViltText(nn.Module):
    """Text embedding tables (bare arrays in the JAX tree) and their
    LayerNorm."""

    def __init__(self, cfg: ViltConfig, **factory):
        super().__init__()
        h = cfg.hidden_size
        self.word = nn.Parameter(torch.empty((cfg.vocab_size, h), **factory))
        self.position = nn.Parameter(
            torch.empty((cfg.max_positions, h), **factory))
        self.token_type = nn.Parameter(
            torch.empty((cfg.type_vocab_size, h), **factory))
        self.ln = L.layer_norm_init(h, cfg.layer_norm_eps, **factory)


class Vilt(nn.Module):
    def __init__(self, cfg: ViltConfig, **factory):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.text = ViltText(cfg, **factory)
        self.cls_token = nn.Parameter(torch.empty((h,), **factory))
        self.patch_embedding = nn.Conv2d(3, h, cfg.patch_size,
                                         stride=cfg.patch_size, **factory)
        self.position_embeddings = nn.Parameter(
            torch.empty((cfg.n_patches + 1, h), **factory))
        self.modality_type = nn.Parameter(
            torch.empty((cfg.modality_type_vocab_size, h), **factory))
        self.blocks = nn.ModuleList([
            nn.ModuleDict({
                "ln_before": L.layer_norm_init(h, eps, **factory),
                "attention": L.mha_init(h, **factory),
                "ln_after": L.layer_norm_init(h, eps, **factory),
                "mlp": L.mlp_init(h, cfg.intermediate_size, **factory),
            })
            for _ in range(cfg.num_layers)
        ])
        self.final_ln = L.layer_norm_init(h, eps, **factory)
        self.pooler = L.dense_init(h, h, **factory)


class ViltReader(nn.Module):
    """MultiPassageVilt's weights: ``vilt`` and the ``qa_outputs`` span
    head."""

    def __init__(self, cfg: ViltConfig, **factory):
        super().__init__()
        self.vilt = Vilt(cfg, **factory)
        self.qa_outputs = L.dense_init(cfg.hidden_size, 2, **factory)


def _seeded(module_cls, cfg: ViltConfig, seed: int, device) -> nn.Module:
    """Seeded random weights in the JAX init's kinds: every dense kernel,
    table and the patch kernel truncated normal (std 0.02), biases 0,
    LayerNorm scales 1."""
    model = L.seeded(module_cls, cfg, seed=seed, device=device,
                     truncated=True)
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed + 1)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            with torch.no_grad():
                L.truncated_normal_(mod.weight, 0.02, gen)
    return model


def init(cfg: ViltConfig, seed: int = 0, device=None) -> Vilt:
    """Seeded random ViLT on ``device`` (default: the GPU): the JAX init's
    distribution, not its values."""
    return _seeded(Vilt, cfg, seed, device)


def reader_init(cfg: ViltConfig, seed: int = 0, device=None) -> ViltReader:
    return _seeded(ViltReader, cfg, seed, device)


def visual_embed(params: Vilt, cfg: ViltConfig,
                 pixel_values: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, n_patches+1, D) f32 with CLS + position
    embeddings; the patch products and sums in f32."""
    b = pixel_values.shape[0]
    conv = params.patch_embedding
    patches = F.conv2d(pixel_values.float().permute(0, 3, 1, 2),
                       conv.weight.float(), conv.bias.float(),
                       stride=cfg.patch_size)           # (B, D, h, w)
    x = patches.flatten(2).transpose(1, 2)              # (B, h*w, D)
    cls = params.cls_token.float().expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    return x + params.position_embeddings[: x.shape[1]]


def apply(
    params: Vilt,
    cfg: ViltConfig,
    input_ids: torch.Tensor,
    pixel_values: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    pixel_mask: Optional[torch.Tensor] = None,
    image_token_type_idx: int = 1,
    compute_dtype=torch.float32,
) -> Dict[str, torch.Tensor]:
    """input_ids (B, Lt); pixel_values (B, H, W, 3) already normalized, or
    (B, n_images, H, W, 3) with ``pixel_mask`` (B, n_images) masking whole
    absent images (each image has its own CLS and position embeddings).
    Returns {"last_hidden_state": (B, Lt + T_vis, D), "pooler_output":
    (B, D)}, f32."""
    b, lt = input_ids.shape
    device = input_ids.device
    text = params.text
    if token_type_ids is None:
        token_type_ids = torch.zeros((b, lt), dtype=torch.long,
                                     device=device)
    t = (text.word[input_ids.long()]
         + text.position[torch.arange(lt, device=device)][None]
         + text.token_type[token_type_ids.long()])
    t = L.layer_norm(text.ln, t, cfg.layer_norm_eps)
    t = t + params.modality_type[0]

    if pixel_values.dim() == 5:  # (B, n_images, H, W, 3)
        n_images = pixel_values.shape[1]
        flat = pixel_values.reshape((-1,) + tuple(pixel_values.shape[2:]))
        v = visual_embed(params, cfg, flat)
        v = v.reshape(b, n_images * v.shape[1], cfg.hidden_size)
        v_mask = (pixel_mask.repeat_interleave(cfg.n_patches + 1, dim=1)
                  if pixel_mask is not None
                  else torch.ones((b, v.shape[1]), dtype=torch.long,
                                  device=device))
    else:
        v = visual_embed(params, cfg, pixel_values)
        v_mask = torch.ones((b, v.shape[1]), dtype=torch.long,
                            device=device)
    v = v + params.modality_type[image_token_type_idx]

    x = torch.cat([t, v], dim=1)
    if attention_mask is None:
        attention_mask = torch.ones((b, lt), dtype=torch.long, device=device)
    mask = torch.cat([attention_mask.long(), v_mask.long()], dim=1)
    bias = L.attention_bias_from_mask(mask)

    eps = cfg.layer_norm_eps
    for block in params.blocks:
        h = L.layer_norm(block["ln_before"], x, eps)
        x = x + L.mha(block["attention"], h, bias=bias, n_heads=cfg.num_heads,
                      compute_dtype=compute_dtype)
        h = L.layer_norm(block["ln_after"], x, eps)
        x = x + L.mlp(block["mlp"], h, cfg.hidden_act, compute_dtype)
    x = L.layer_norm(params.final_ln, x, eps)
    pooled = torch.tanh(L.dense(params.pooler, x[:, 0]))
    return {"last_hidden_state": x, "pooler_output": pooled}


def vilt_for_ir_apply(params: Vilt, cfg: ViltConfig, *args,
                      **kwargs) -> EncoderOutput:
    """DPR-style CLS pooling instead of the ITM-pretrained pooler."""
    out = apply(params, cfg, *args, **kwargs)
    return EncoderOutput(pooler_output=out["last_hidden_state"][:, 0])


def multi_passage_vilt_apply(
    params: ViltReader, cfg: ViltConfig,
    input_ids, pixel_values,
    attention_mask=None,
    start_positions=None, end_positions=None, answer_mask=None,
    m_passages: int = 24,
    compute_dtype=torch.float32,
) -> ReaderOutput:
    """Span extraction over the TEXT segment of each (question + passage,
    image) pair, with the global multi-passage softmax
    (``train.optim.multi_passage_rc_loss``)."""
    from viquae_torch.models.qa import reader_output

    out = apply(params.vilt, cfg, input_ids, pixel_values,
                attention_mask=attention_mask, compute_dtype=compute_dtype)
    lt = input_ids.shape[1]
    logits = L.dense(params.qa_outputs, out["last_hidden_state"][:, :lt])
    return reader_output(logits[..., 0], logits[..., 1], start_positions,
                         end_positions, answer_mask, m_passages)


# --------------------------------------------------------------------------
# weight port
# --------------------------------------------------------------------------
def tree_from_hf(state_dict, cfg: ViltConfig) -> Dict[str, Any]:
    """An HF ``ViltModel`` state dict as the JAX param tree (numpy f32),
    the patch position embeddings interpolated to ``cfg``'s grid when the
    checkpoint's differs (``jax.image.resize`` bilinear with antialiasing,
    ``ops.image.resize_bilinear``)."""
    from viquae_torch.ops.image import resize_bilinear

    def get(name):
        t = state_dict[name]
        return np.asarray(t.detach().cpu().float().numpy()
                          if hasattr(t, "detach") else t, np.float32)

    def lin(name):
        return {"kernel": get(f"{name}.weight").T, "bias": get(f"{name}.bias")}

    def ln(name):
        return {"scale": get(f"{name}.weight"), "bias": get(f"{name}.bias")}

    n_layers = len({
        k.split(".")[2] for k in state_dict if k.startswith("encoder.layer.")
    })
    pos = get("embeddings.position_embeddings")[0]  # (n_patches+1, D)
    if pos.shape[0] != cfg.n_patches + 1:
        side_src = int(np.sqrt(pos.shape[0] - 1))
        side_dst = cfg.image_size // cfg.patch_size
        grid = torch.from_numpy(pos[1:].reshape(1, side_src, side_src, -1))
        grid = resize_bilinear(grid, (side_dst, side_dst)).numpy()
        pos = np.concatenate([pos[:1], grid.reshape(side_dst * side_dst, -1)])
    return {
        "text": {
            "word": get("embeddings.text_embeddings.word_embeddings.weight"),
            "position": get(
                "embeddings.text_embeddings.position_embeddings.weight"),
            "token_type": get(
                "embeddings.text_embeddings.token_type_embeddings.weight"),
            "ln": ln("embeddings.text_embeddings.LayerNorm"),
        },
        "cls_token": get("embeddings.cls_token")[0, 0],
        "patch_embedding": {
            "kernel": np.transpose(
                get("embeddings.patch_embeddings.projection.weight"),
                (2, 3, 1, 0)),
            "bias": get("embeddings.patch_embeddings.projection.bias"),
        },
        "position_embeddings": pos,
        "modality_type": get("embeddings.token_type_embeddings.weight"),
        "blocks": [
            {
                "ln_before": ln(f"encoder.layer.{i}.layernorm_before"),
                "attention": {
                    "q": lin(f"encoder.layer.{i}.attention.attention.query"),
                    "k": lin(f"encoder.layer.{i}.attention.attention.key"),
                    "v": lin(f"encoder.layer.{i}.attention.attention.value"),
                    "o": lin(f"encoder.layer.{i}.attention.output.dense"),
                },
                "ln_after": ln(f"encoder.layer.{i}.layernorm_after"),
                "mlp": {
                    "in": lin(f"encoder.layer.{i}.intermediate.dense"),
                    "out": lin(f"encoder.layer.{i}.output.dense"),
                },
            }
            for i in range(n_layers)
        ],
        "final_ln": ln("layernorm"),
        "pooler": lin("pooler.dense"),
    }


def params_from_hf(state_dict, cfg: ViltConfig, device=None,
                   dtype: torch.dtype = torch.float32) -> Vilt:
    """Port an HF ``ViltModel`` state dict into a :class:`Vilt` on
    ``device`` (default: the GPU) at ``cfg``'s static grid."""
    from viquae_torch.models import convert

    return convert.module_from_tree(Vilt, cfg, tree=tree_from_hf(
        state_dict, cfg), device=device, dtype=dtype)
