"""CLIP: ViT and ModifiedResNet visual towers + text tower (counterpart of
viquae_tpu/models/clip.py).

The reference consumes CLIP as OpenAI CLIP RN50 ``model.visual`` for image
embeddings (column "clip-RN50", 1024-d), HF CLIP-ViT
``get_image_features``, and the text tower. Here:

- pre-LN transformer blocks with quick_gelu (shared by text + ViT),
- ViT visual tower (patch conv, CLS token, pre/post LN, projection),
- text tower (causal mask, EOT pooling, projection),
- ModifiedResNet visual tower (3-conv stem with avgpools, avgpool-in-
  bottleneck, attention pooling) for RN50 checkpoints.

Modules are named as the JAX param trees, so :func:`text_from_jax`,
:func:`vit_from_jax` and :func:`modified_resnet_from_jax` are
``convert.module_from_tree``. Weight ports: :func:`params_from_hf` (HF CLIPModel
state_dict) and :func:`visual_params_from_openai` (OpenAI "visual.*" RN50
layout); ``transformers`` is imported only inside the function that loads
a checkpoint directory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from viquae_torch.core.config import register as _register
from viquae_torch.core.device import resolve_device
from viquae_torch.models import convert
from viquae_torch.models import layers as L
from viquae_torch.models import resnet as R


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    max_positions: int = 77
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5


# --------------------------------------------------------------------------
# pre-LN transformer blocks
# --------------------------------------------------------------------------
class Block(nn.Module):
    def __init__(self, dim, mlp_dim, eps, **factory):
        super().__init__()
        self.ln1 = L.layer_norm_init(dim, eps, **factory)
        self.attn = L.mha_init(dim, **factory)
        self.ln2 = L.layer_norm_init(dim, eps, **factory)
        self.mlp = L.mlp_init(dim, mlp_dim, **factory)


def _block_apply(p: Block, x, heads, eps, bias=None,
                 compute_dtype=torch.float32):
    h = L.layer_norm(p.ln1, x, eps)
    x = x + L.mha(p.attn, h, bias=bias, n_heads=heads,
                  compute_dtype=compute_dtype)
    h = L.layer_norm(p.ln2, x, eps)
    x = x + L.mlp(p.mlp, h, act="quick_gelu", compute_dtype=compute_dtype)
    return x


def _blocks(n, dim, mlp_dim, eps, **factory):
    return nn.ModuleList(Block(dim, mlp_dim, eps, **factory)
                         for _ in range(n))


# --------------------------------------------------------------------------
# text tower
# --------------------------------------------------------------------------
class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **factory):
        super().__init__()
        d = cfg.hidden_size
        self.token_embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, d, **factory))
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_positions, d, **factory))
        self.blocks = _blocks(cfg.num_layers, d, cfg.intermediate_size,
                              cfg.layer_norm_eps, **factory)
        self.final_ln = L.layer_norm_init(d, cfg.layer_norm_eps, **factory)
        self.projection = nn.Linear(d, cfg.projection_dim, bias=False,
                                    **factory)


def text_init(cfg: CLIPTextConfig, seed: int = 0, device=None) -> CLIPText:
    """Seeded random text tower (not bit-equal to the JAX ``text_init``:
    another generator; parity is held through converted weights)."""
    return L.seeded(CLIPText, cfg, seed=seed, device=device)


def text_from_jax(tree, cfg: CLIPTextConfig, device=None) -> CLIPText:
    return convert.module_from_tree(CLIPText, cfg, tree=tree, device=device)


@torch.no_grad()
def text_apply(params: CLIPText, cfg: CLIPTextConfig,
               input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    b, length = input_ids.shape
    x = params.token_embedding[input_ids]
    x = x + params.position_embedding[:length]
    f32_min = torch.finfo(torch.float32).min
    causal = torch.triu(torch.full((length, length), f32_min * 0.5,
                                   device=x.device), diagonal=1)[None, None]
    bias = causal
    if attention_mask is not None:
        bias = bias + L.attention_bias_from_mask(attention_mask)
    for p in params.blocks:
        x = _block_apply(p, x, cfg.num_heads, cfg.layer_norm_eps, bias,
                         compute_dtype)
    x = L.layer_norm(params.final_ln, x, cfg.layer_norm_eps)
    # EOT pooling: feature at the first eos token position (HF semantics)
    eos = (input_ids == cfg.eos_token_id).to(torch.int32)
    eot_pos = torch.where(eos.any(dim=1), torch.argmax(eos, dim=1),
                          torch.argmax(input_ids, dim=1))
    pooled = x[torch.arange(b, device=x.device), eot_pos]
    projected = pooled @ params.projection.weight.t()
    return {"last_hidden_state": x, "pooler_output": pooled,
            "text_embeds": projected}


# --------------------------------------------------------------------------
# ViT visual tower
# --------------------------------------------------------------------------
class CLIPVision(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **factory):
        super().__init__()
        d = cfg.hidden_size
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.empty(d, **factory))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, bias=False,
                                         **factory)
        self.position_embedding = nn.Parameter(
            torch.empty(n_patches + 1, d, **factory))
        self.pre_ln = L.layer_norm_init(d, cfg.layer_norm_eps, **factory)
        self.blocks = _blocks(cfg.num_layers, d, cfg.intermediate_size,
                              cfg.layer_norm_eps, **factory)
        self.post_ln = L.layer_norm_init(d, cfg.layer_norm_eps, **factory)
        self.projection = nn.Linear(d, cfg.projection_dim, bias=False,
                                    **factory)


def vit_init(cfg: CLIPVisionConfig, seed: int = 0, device=None) -> CLIPVision:
    """Seeded random ViT tower (another generator than the JAX
    ``vit_init``)."""
    return L.seeded(CLIPVision, cfg, seed=seed, device=device)


def vit_from_jax(tree, cfg: CLIPVisionConfig, device=None) -> CLIPVision:
    return convert.module_from_tree(CLIPVision, cfg, tree=tree, device=device)


@torch.no_grad()
def vit_apply(params: CLIPVision, cfg: CLIPVisionConfig,
              images: torch.Tensor,
              compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """images: (B, H, W, 3) CLIP-normalized."""
    b = images.shape[0]
    patches = F.conv2d(R.nchw(images).to(compute_dtype),
                       params.patch_embedding.weight.to(compute_dtype),
                       stride=cfg.patch_size).float()
    x = patches.flatten(2).transpose(1, 2)            # (B, h*w, D)
    cls = params.class_embedding.expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + params.position_embedding[: x.shape[1]]
    x = L.layer_norm(params.pre_ln, x, cfg.layer_norm_eps)
    for p in params.blocks:
        x = _block_apply(p, x, cfg.num_heads, cfg.layer_norm_eps, None,
                         compute_dtype)
    pooled = L.layer_norm(params.post_ln, x[:, 0], cfg.layer_norm_eps)
    projected = pooled @ params.projection.weight.t()
    return {"last_hidden_state": x, "pooler_output": pooled,
            "image_embeds": projected}


# --------------------------------------------------------------------------
# ModifiedResNet visual tower (OpenAI CLIP RN50)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModifiedResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    output_dim: int = 1024
    heads: int = 32
    image_size: int = 224
    bn_eps: float = 1e-5


class AttnPool(nn.Module):
    def __init__(self, tokens: int, dim: int, out: int, **factory):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.empty(tokens, dim, **factory))
        self.q_proj = nn.Linear(dim, dim, **factory)
        self.k_proj = nn.Linear(dim, dim, **factory)
        self.v_proj = nn.Linear(dim, dim, **factory)
        self.c_proj = nn.Linear(dim, out, **factory)


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: ModifiedResNetConfig, **factory):
        super().__init__()
        w = cfg.width
        for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2),
                                         (w // 2, w)), start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, 3, bias=False,
                                                **factory))
            setattr(self, f"bn{i}", L.BatchNorm(cout, **factory))
        self.layers = nn.ModuleList()
        cin = w
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            planes = w * 2 ** stage
            blocks = nn.ModuleList()
            for b in range(n_blocks):
                # OpenAI layout: every stage's first block downsamples
                blocks.append(R.Bottleneck(cin, planes, b == 0, **factory))
                cin = planes * 4
            self.layers.append(blocks)
        # stem (stride 2) + avgpool + one stride-2 per later stage
        spacial = cfg.image_size // (4 * 2 ** (len(cfg.stage_sizes) - 1))
        self.attnpool = AttnPool(spacial * spacial + 1, cin, cfg.output_dim,
                                 **factory)


def modified_resnet_init(cfg: ModifiedResNetConfig = ModifiedResNetConfig(),
                         seed: int = 0, device=None) -> ModifiedResNet:
    """Seeded random RN50 visual tower (layers.init_weights_)."""
    return L.seeded(ModifiedResNet, cfg, seed=seed, device=device)


def modified_resnet_from_jax(tree, cfg: ModifiedResNetConfig, device=None
                             ) -> ModifiedResNet:
    return convert.module_from_tree(ModifiedResNet, cfg, tree=tree,
                                    device=device)


def _avgpool2(x):
    return F.avg_pool2d(x, 2)


def _mrn_bottleneck_apply(p, x, stride, eps, compute_dtype=None):
    cd = compute_dtype
    out = F.relu(R.batch_norm(p.bn1, R.conv(p.conv1, x, compute_dtype=cd),
                              eps))
    out = F.relu(R.batch_norm(p.bn2, R.conv(p.conv2, out, compute_dtype=cd),
                              eps))
    if stride > 1:
        out = _avgpool2(out)
    out = R.batch_norm(p.bn3, R.conv(p.conv3, out, compute_dtype=cd), eps)
    if hasattr(p, "downsample_conv"):
        identity = x
        if stride > 1:
            identity = _avgpool2(identity)
        identity = R.batch_norm(
            p.downsample_bn,
            R.conv(p.downsample_conv, identity, compute_dtype=cd), eps)
    else:
        identity = x
    return F.relu(out + identity)


@torch.no_grad()
def modified_resnet_apply(params: ModifiedResNet, cfg: ModifiedResNetConfig,
                          images: torch.Tensor,
                          compute_dtype=None) -> torch.Tensor:
    """(B, H, W, 3) CLIP-normalized -> (B, output_dim) via attention pool.

    compute_dtype=bfloat16 runs the conv trunk in bf16; BN and the
    attention pool stay f32."""
    eps = cfg.bn_eps
    x = R.nchw(images.float())
    for i in (1, 2, 3):
        stride = 2 if i == 1 else 1
        x = F.relu(R.batch_norm(
            getattr(params, f"bn{i}"),
            R.conv(getattr(params, f"conv{i}"), x, stride,
                   compute_dtype=compute_dtype), eps))
    x = _avgpool2(x)
    for stage, blocks in enumerate(params.layers):
        for b, block in enumerate(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            x = _mrn_bottleneck_apply(block, x, stride, eps,
                                      compute_dtype=compute_dtype)
    # attention pooling (visual.attnpool), f32
    b_sz, c = x.shape[0], x.shape[1]
    tokens = x.flatten(2).transpose(1, 2)             # (B, HW, C)
    mean = tokens.mean(dim=1, keepdim=True)
    tokens = torch.cat([mean, tokens], dim=1)         # (B, HW+1, C)
    ap = params.attnpool
    tokens = tokens + ap.positional_embedding[None]

    def proj(lin, t):
        return t @ lin.weight.t() + lin.bias

    q = proj(ap.q_proj, tokens[:, :1])
    k = proj(ap.k_proj, tokens)
    v = proj(ap.v_proj, tokens)
    heads = cfg.heads
    hd = c // heads
    q = q.reshape(b_sz, 1, heads, hd)
    k = k.reshape(b_sz, -1, heads, hd)
    v = v.reshape(b_sz, -1, heads, hd)
    attn = torch.softmax(
        torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd), dim=-1)
    pooled = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b_sz, c)
    return proj(ap.c_proj, pooled)


# --------------------------------------------------------------------------
# joint wrapper
# --------------------------------------------------------------------------
def l2norm(x, axis=-1, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=axis,
                                                    keepdim=True), min=eps)


def clip_scores(text_embeds, image_embeds, logit_scale):
    """(N, D), (M, D) -> (N, M) cosine logits."""
    return logit_scale * (l2norm(text_embeds) @ l2norm(image_embeds).T)


# --------------------------------------------------------------------------
# weight ports: state dicts -> the JAX package's trees -> modules
# --------------------------------------------------------------------------
def _to_np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t)


def tree_from_hf(state_dict) -> Dict[str, Any]:
    """An HF ``CLIPModel`` state_dict -> {"text", "vision", "logit_scale"}
    trees in the JAX package's layout (its ``params_from_hf``)."""
    def get(name):
        return _to_np(state_dict[name])

    def lin(name):
        return {"kernel": get(f"{name}.weight").T, "bias": get(f"{name}.bias")}

    def ln(name):
        return {"scale": get(f"{name}.weight"), "bias": get(f"{name}.bias")}

    def block(prefix):
        return {
            "ln1": ln(f"{prefix}.layer_norm1"),
            "attn": {
                "q": lin(f"{prefix}.self_attn.q_proj"),
                "k": lin(f"{prefix}.self_attn.k_proj"),
                "v": lin(f"{prefix}.self_attn.v_proj"),
                "o": lin(f"{prefix}.self_attn.out_proj"),
            },
            "ln2": ln(f"{prefix}.layer_norm2"),
            "mlp": {
                "in": lin(f"{prefix}.mlp.fc1"),
                "out": lin(f"{prefix}.mlp.fc2"),
            },
        }

    n_text = len({
        k.split(".")[3] for k in state_dict
        if k.startswith("text_model.encoder.layers.")
    })
    n_vis = len({
        k.split(".")[3] for k in state_dict
        if k.startswith("vision_model.encoder.layers.")
    })
    text = {
        "token_embedding": get("text_model.embeddings.token_embedding.weight"),
        "position_embedding": get(
            "text_model.embeddings.position_embedding.weight"),
        "blocks": [
            block(f"text_model.encoder.layers.{i}") for i in range(n_text)
        ],
        "final_ln": ln("text_model.final_layer_norm"),
        "projection": {"kernel": get("text_projection.weight").T},
    }
    pre_ln_key = (
        "vision_model.pre_layrnorm"  # HF's historical typo
        if "vision_model.pre_layrnorm.weight" in state_dict
        else "vision_model.pre_layernorm"
    )
    vision = {
        "class_embedding": get("vision_model.embeddings.class_embedding"),
        "patch_embedding": {
            "kernel": np.transpose(
                get("vision_model.embeddings.patch_embedding.weight"),
                (2, 3, 1, 0))
        },
        "position_embedding": get(
            "vision_model.embeddings.position_embedding.weight"),
        "pre_ln": ln(pre_ln_key),
        "blocks": [
            block(f"vision_model.encoder.layers.{i}") for i in range(n_vis)
        ],
        "post_ln": ln("vision_model.post_layernorm"),
        "projection": {"kernel": get("visual_projection.weight").T},
    }
    return {"text": text, "vision": vision,
            "logit_scale": get("logit_scale")}


def params_from_hf(state_dict, text_cfg: CLIPTextConfig,
                   vision_cfg: CLIPVisionConfig, device=None
                   ) -> Dict[str, Any]:
    """An HF ``CLIPModel`` state_dict -> {"text": :class:`CLIPText`,
    "vision": :class:`CLIPVision`, "logit_scale": tensor} on ``device``.
    The towers' widths and head counts come from the configs."""
    tree = tree_from_hf(state_dict)
    device = resolve_device(device)
    return {"text": text_from_jax(tree["text"], text_cfg, device),
            "vision": vit_from_jax(tree["vision"], vision_cfg, device),
            "logit_scale": torch.from_numpy(np.asarray(
                tree["logit_scale"], np.float32)).to(device)}


def tree_from_openai(state_dict, cfg: ModifiedResNetConfig) -> Dict[str, Any]:
    """OpenAI CLIP RN50 ``visual.*`` weights -> the JAX package's
    ModifiedResNet tree (its ``visual_params_from_openai``)."""
    def get(name):
        return _to_np(state_dict[name])

    def conv_p(name):
        return {"kernel": np.transpose(get(f"{name}.weight"), (2, 3, 1, 0))}

    def bn_p(name):
        return {
            "scale": get(f"{name}.weight"), "bias": get(f"{name}.bias"),
            "mean": get(f"{name}.running_mean"),
            "var": get(f"{name}.running_var"),
        }

    params: Dict[str, Any] = {}
    for i in (1, 2, 3):
        params[f"conv{i}"] = conv_p(f"visual.conv{i}")
        params[f"bn{i}"] = bn_p(f"visual.bn{i}")
    params["layers"] = []
    for stage, n_blocks in enumerate(cfg.stage_sizes, start=1):
        blocks = []
        for b in range(n_blocks):
            base = f"visual.layer{stage}.{b}"
            p = {
                "conv1": conv_p(f"{base}.conv1"), "bn1": bn_p(f"{base}.bn1"),
                "conv2": conv_p(f"{base}.conv2"), "bn2": bn_p(f"{base}.bn2"),
                "conv3": conv_p(f"{base}.conv3"), "bn3": bn_p(f"{base}.bn3"),
            }
            if f"{base}.downsample.1.weight" in state_dict:
                # downsample = [avgpool, conv, bn]
                p["downsample_conv"] = conv_p(f"{base}.downsample.1")
                p["downsample_bn"] = bn_p(f"{base}.downsample.2")
            blocks.append(p)
        params["layers"].append(blocks)
    params["attnpool"] = {
        "positional_embedding": get("visual.attnpool.positional_embedding"),
        **{proj: {"kernel": get(f"visual.attnpool.{proj}.weight").T,
                  "bias": get(f"visual.attnpool.{proj}.bias")}
           for proj in ("q_proj", "k_proj", "v_proj", "c_proj")},
    }
    return params


def visual_params_from_openai(state_dict, cfg: ModifiedResNetConfig,
                              device=None) -> ModifiedResNet:
    """Port OpenAI CLIP RN50 ``visual.*`` weights (ModifiedResNet)."""
    return modified_resnet_from_jax(tree_from_openai(state_dict, cfg), cfg,
                                    device)


# --------------------------------------------------------------------------
# config-registry tower wrappers (trainee / embedding contract)
# --------------------------------------------------------------------------
def _hf_clip_state_dict(path):
    from transformers import CLIPModel

    model = CLIPModel.from_pretrained(path, torch_dtype=torch.float32)
    return model.config, model.state_dict()


def _text_cfg_from_hf(hf_cfg) -> CLIPTextConfig:
    t = hf_cfg.text_config
    return CLIPTextConfig(
        vocab_size=t.vocab_size, hidden_size=t.hidden_size,
        num_layers=t.num_hidden_layers, num_heads=t.num_attention_heads,
        intermediate_size=t.intermediate_size,
        max_positions=t.max_position_embeddings,
        projection_dim=hf_cfg.projection_dim, eos_token_id=t.eos_token_id)


def _vision_cfg_from_hf(hf_cfg) -> CLIPVisionConfig:
    v = hf_cfg.vision_config
    return CLIPVisionConfig(
        hidden_size=v.hidden_size, num_layers=v.num_hidden_layers,
        num_heads=v.num_attention_heads,
        intermediate_size=v.intermediate_size, image_size=v.image_size,
        patch_size=v.patch_size, projection_dim=hf_cfg.projection_dim)


@_register("CLIPTextTower")
class CLIPTextTower:
    """Registry entry bundling (cfg, params) for the CLIP text tower.
    Without ``params`` the weights are drawn from ``seed`` with a
    ``torch.Generator`` (:func:`text_init`), so a seeded tower is not
    bit-equal to the JAX package's; parity holds through converted
    weights (:func:`text_from_jax`)."""

    def __init__(self, cfg: Optional[CLIPTextConfig] = None, params=None,
                 seed: int = 0, device=None, **cfg_kwargs):
        self.cfg = cfg or CLIPTextConfig(**cfg_kwargs)
        self.params = (params if params is not None
                       else text_init(self.cfg, seed, device))

    @classmethod
    def from_pretrained(cls, path, device=None, **kwargs):
        hf_cfg, sd = _hf_clip_state_dict(path)
        cfg = _text_cfg_from_hf(hf_cfg)
        return cls(cfg=cfg, params=text_from_jax(tree_from_hf(sd)["text"],
                                                 cfg, device), **kwargs)

    def __call__(self, input_ids, attention_mask=None, **kw):
        return text_apply(self.params, self.cfg, input_ids, attention_mask)

    def apply_fn(self, params, input_ids, attention_mask=None, **kw):
        return text_apply(params, self.cfg, input_ids, attention_mask)


@_register("CLIPVisionTower")
class CLIPVisionTower:
    """Registry entry for the CLIP ViT visual tower (cfg, params); seeded
    weights as :class:`CLIPTextTower`'s."""

    def __init__(self, cfg: Optional[CLIPVisionConfig] = None, params=None,
                 seed: int = 0, compute_dtype=None, device=None,
                 **cfg_kwargs):
        self.cfg = cfg or CLIPVisionConfig(**cfg_kwargs)
        self.compute_dtype = compute_dtype
        self.params = (params if params is not None
                       else vit_init(self.cfg, seed, device))

    @classmethod
    def from_pretrained(cls, path, device=None, **kwargs):
        hf_cfg, sd = _hf_clip_state_dict(path)
        cfg = _vision_cfg_from_hf(hf_cfg)
        return cls(cfg=cfg, params=vit_from_jax(tree_from_hf(sd)["vision"],
                                                cfg, device), **kwargs)

    def __call__(self, pixels, **kw):
        return self.apply_fn(self.params, pixels)

    def apply_fn(self, params, pixels, **kw):
        return vit_apply(
            params, self.cfg, pixels,
            **({"compute_dtype": self.compute_dtype}
               if self.compute_dtype is not None else {}),
        )
