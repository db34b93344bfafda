"""Multimodal fusion encoders (counterpart of viquae_tpu/models/mm.py).

- :func:`eca_apply` / :func:`eca_apply_packed` — **ECAEncoder**: faces and
  images are projected into token space, appended AFTER the text
  embedding module, and the whole sequence runs through the BERT encoder;
  CLS-pooled. Optional tanh gating of the visual tokens, optional
  ``face_and_image_are_exclusive`` masking, optional ``no_text``.
- :func:`ilf_apply` / :func:`ilf_apply_packed` — **IntermediateLinearFusion**:
  DPR pooled text + linear-projected summed face/image features, LN.
- :func:`flamant_apply` — **Flamant**: BERT layers with gated
  cross-attention blocks to the visual tokens every
  ``multimodal_attention_every`` layers.
- :func:`clip_for_ir_apply` — **CLIPForIR**: text_embeds + image_embeds.

The weights live in modules named as the JAX param trees (:class:`ECA`,
:class:`ILF`, :class:`Flamant`), so :func:`from_jax` converts a tree one
name to one name. ECA and ILF train: ``deterministic=False`` turns on
dropout at the JAX package's sites (each visual projection, the text
embeddings, the BERT layers, ILF's fused output), its seeds drawn from
the CPU ``generator``; ``remat_layers`` checkpoints each BERT layer.
ECA and ILF surface a Mixture-of-Experts BERT's load-balance term
(``moe_aux``, or the second value with ``return_aux``). Flamant is
evaluation only and, as in the JAX package, refuses a MoE BERT (its layer
loop interleaves the cross-attention blocks).
Masks stay finite additive biases (``layers.attention_bias_from_*``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from viquae_torch.core.config import register as _register
from viquae_torch.models import bert
from viquae_torch.models import layers as L
from viquae_torch.models.outputs import ECAEncoderOutput, EncoderOutput


@dataclasses.dataclass(frozen=True)
class MMConfig:
    bert: bert.BertConfig = dataclasses.field(
        default_factory=lambda: bert.BertConfig(add_pooler=False)
    )
    n_images: int = 1
    n_faces: int = 4
    face_dim: int = 512
    bbox_dim: int = 7
    image_dims: Tuple[Tuple[str, int], ...] = (
        ("clip-RN50", 1024), ("imagenet-RN50", 2048),
    )
    face_and_image_are_exclusive: bool = False
    no_text: bool = False
    gating: bool = False


@dataclasses.dataclass(frozen=True)
class FlamantConfig(MMConfig):
    multimodal_attention_every: int = 1
    image_num_attention_heads: int = 12
    image_intermediate_size: int = 3072


# ---- visual projection blocks ---------------------------------------------
class FaceEmbedding(nn.Module):
    def __init__(self, cfg: MMConfig, **factory):
        super().__init__()
        d = cfg.bert.hidden_size
        self.face_proj = L.dense_init(cfg.face_dim, d, **factory)
        self.bbox_proj = L.dense_init(cfg.bbox_dim, d, **factory)
        self.ln = L.layer_norm_init(d, cfg.bert.layer_norm_eps, **factory)


def face_embedding_apply(p: FaceEmbedding, cfg: MMConfig, face, bbox,
                         type_embedding=None, seed=None):
    x = L.dense(p.face_proj, face) + L.dense(p.bbox_proj, bbox)
    if type_embedding is not None:
        x = x + type_embedding
    x = L.layer_norm(p.ln, x, cfg.bert.layer_norm_eps)
    return L.dropout(x, cfg.bert.hidden_dropout_prob, seed)


class ImageEmbedding(nn.Module):
    def __init__(self, cfg: MMConfig, input_dim: int, **factory):
        super().__init__()
        d = cfg.bert.hidden_size
        self.linear = L.dense_init(input_dim, d, **factory)
        if cfg.n_images > 1:
            self.ln = L.layer_norm_init(d, cfg.bert.layer_norm_eps,
                                        **factory)


def image_embedding_apply(p: ImageEmbedding, cfg: MMConfig, x,
                          type_embedding=None, seed=None):
    x = L.dense(p.linear, x)
    if type_embedding is not None:
        # the LayerNorm exists (and applies) only with a type embedding,
        # that is when n_images > 1
        x = x + type_embedding
        x = L.layer_norm(p.ln, x, cfg.bert.layer_norm_eps)
    return L.dropout(x, cfg.bert.hidden_dropout_prob, seed)


class TanhGate(nn.Module):
    """Flamingo-style gate: ``x * tanh(gate)``, the gate initialised to 0
    (so a freshly initialised gated branch contributes nothing)."""

    def __init__(self, **factory):
        super().__init__()
        self.gate = nn.Parameter(torch.zeros((1,), **factory))


def tanh_gate(p: TanhGate, x):
    return x * torch.tanh(p.gate)


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------
class ECA(nn.Module):
    """ECA weights: ``bert``, ``image_type_embeddings`` (n_images > 1),
    ``face_embedding`` (n_faces > 0), ``image_embeddings[name]`` and, with
    gating, ``face_gate`` / ``image_gates[name]``."""

    def __init__(self, cfg: MMConfig, **factory):
        super().__init__()
        d = cfg.bert.hidden_size
        self.bert = bert.Bert(cfg.bert, **factory)
        if cfg.n_images > 1:
            self.image_type_embeddings = nn.Parameter(
                torch.zeros((cfg.n_images, d), **factory))
        if cfg.n_faces > 0:
            self.face_embedding = FaceEmbedding(cfg, **factory)
            if cfg.gating:
                self.face_gate = TanhGate(**factory)
        self.image_embeddings = nn.ModuleDict({
            name: ImageEmbedding(cfg, dim, **factory)
            for name, dim in cfg.image_dims})
        self.image_gates = nn.ModuleDict({
            name: TanhGate(**factory)
            for name, _ in (cfg.image_dims if cfg.gating else ())})


class ILF(nn.Module):
    """IntermediateLinearFusion weights: ``dpr_encoder`` (BERT),
    ``face_embedding`` (n_faces > 0), ``image_embeddings[name]``,
    ``dpr_proj`` and ``ln``."""

    def __init__(self, cfg: MMConfig, **factory):
        super().__init__()
        if cfg.n_images != 1:
            raise ValueError("ILF supports a single image (parity)")
        d = cfg.bert.hidden_size
        self.dpr_encoder = bert.Bert(cfg.bert, **factory)
        if cfg.n_faces > 0:
            self.face_embedding = FaceEmbedding(cfg, **factory)
        self.image_embeddings = nn.ModuleDict({
            name: ImageEmbedding(cfg, dim, **factory)
            for name, dim in cfg.image_dims})
        self.dpr_proj = L.dense_init(d, d, **factory)
        self.ln = L.layer_norm_init(d, cfg.bert.layer_norm_eps, **factory)


class CrossAttentionLayer(nn.Module):
    def __init__(self, cfg: FlamantConfig, **factory):
        super().__init__()
        d, eps = cfg.bert.hidden_size, cfg.bert.layer_norm_eps
        self.xattn = L.mha_init(d, **factory)
        self.xattn_ln = L.layer_norm_init(d, eps, **factory)
        self.ffw = L.mlp_init(d, cfg.image_intermediate_size, **factory)
        self.ln = L.layer_norm_init(d, eps, **factory)
        if cfg.gating:
            self.attn_gate = TanhGate(**factory)
            self.ffw_gate = TanhGate(**factory)


class Flamant(ECA):
    """ECA's weights plus ``xattn_layers[str(i)]`` before every
    ``multimodal_attention_every``-th BERT layer."""

    def __init__(self, cfg: FlamantConfig, **factory):
        super().__init__(cfg, **factory)
        self.xattn_layers = nn.ModuleDict({
            str(i): CrossAttentionLayer(cfg, **factory)
            for i in range(0, cfg.bert.num_hidden_layers,
                           cfg.multimodal_attention_every)})


def init(module_cls, cfg: MMConfig, seed: int = 0, device=None) -> nn.Module:
    """Seeded random weights (``layers.seeded``: another generator than
    the JAX inits, the same truncated-normal dense and embedding draws)
    with every tanh gate at 0, as the JAX inits set it."""
    model = L.seeded(module_cls, cfg, seed=seed, device=device,
                     truncated=True)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, TanhGate):
                mod.gate.zero_()
    return model


def from_jax(module_cls, cfg: MMConfig, tree: Dict[str, Any], device=None,
             dtype: torch.dtype = torch.float32) -> nn.Module:
    """A JAX param tree of ``eca_init`` / ``ilf_init`` / ``flamant_init``
    (or of the re-rankers and the ECA reader built on them; numpy leaves)
    -> ``module_cls`` on ``device`` (default: the GPU) in ``dtype``;
    strict on names and shapes."""
    from viquae_torch.models import convert

    return convert.module_from_tree(module_cls, cfg, tree=tree,
                                    device=device, dtype=dtype)


# --------------------------------------------------------------------------
# visual tokens
# --------------------------------------------------------------------------
def _type_embedding(params: ECA, n_images: int, device):
    """(n_images, D) rows of ``image_type_embeddings``, the JAX package's
    ``image_type_embeddings[arange(n_images)]``."""
    return params.image_type_embeddings[torch.arange(n_images, device=device)]


def _visual_tokens(params, cfg: MMConfig, face_inputs, image_inputs,
                   deterministic: bool = True, generator=None):
    """Project faces + images to (B, T_vis, D) tokens + (B, T_vis) mask:
    faces (n_images * n_faces) first, then each image kind (n_images each)
    in ``image_inputs``' order. One dropout seed per projection branch."""
    faces = face_inputs["face"]  # (B, n_images, n_faces, face_dim)
    b, n_images, n_faces, _ = faces.shape
    seeds = L.dropout_seeds(generator, 1 + len(image_inputs or {}),
                            deterministic)
    tokens, masks = [], []
    face_mask = face_inputs["attention_mask"].reshape(b, n_images * n_faces)
    if n_faces > 0:
        type_emb = None
        if cfg.n_images > 1:
            type_emb = _type_embedding(params, n_images,
                                       faces.device)[None, :, None]
        face_out = face_embedding_apply(
            params.face_embedding, cfg, faces, face_inputs["bbox"],
            type_embedding=type_emb, seed=seeds[0]
        ).reshape(b, n_images * n_faces, -1)
        if cfg.gating:
            face_out = tanh_gate(params.face_gate, face_out)
        tokens.append(face_out)
        masks.append(face_mask)

    image_mask_parts = []
    for img_i, (name, image) in enumerate((image_inputs or {}).items()):
        type_emb = None
        if cfg.n_images > 1:
            type_emb = _type_embedding(params, n_images, faces.device)[None]
        out = image_embedding_apply(
            params.image_embeddings[name], cfg,
            image["input"].reshape(b, n_images, -1), type_embedding=type_emb,
            seed=seeds[1 + img_i])
        if cfg.gating:
            out = tanh_gate(params.image_gates[name], out)
        tokens.append(out)
        image_mask_parts.append(image["attention_mask"])
    if image_mask_parts:
        image_mask = torch.cat(image_mask_parts, dim=1)
        if cfg.face_and_image_are_exclusive:
            has_face = face_mask.sum(dim=1, keepdim=True) > 0
            image_mask = torch.where(has_face, 0, image_mask)
        masks.append(image_mask)
    vis_tokens = (torch.cat(tokens, dim=1) if tokens else
                  faces.new_zeros((b, 0, cfg.bert.hidden_size)))
    vis_mask = (torch.cat(masks, dim=1) if masks else
                faces.new_zeros((b, 0)))
    return vis_tokens, vis_mask


# --------------------------------------------------------------------------
# ECA encoder
# --------------------------------------------------------------------------
def eca_apply(params: ECA, cfg: MMConfig, text_inputs, face_inputs,
              image_inputs=None, deterministic: bool = True, generator=None,
              compute_dtype=torch.float32,
              remat_layers: bool = False) -> ECAEncoderOutput:
    vis_tokens, vis_mask = _visual_tokens(params, cfg, face_inputs,
                                          image_inputs, deterministic,
                                          generator)
    input_ids = text_inputs["input_ids"]
    attention_mask = text_inputs["attention_mask"]
    token_type_ids = text_inputs.get("token_type_ids")
    if cfg.no_text:
        input_ids = input_ids[:, :1]
        attention_mask = attention_mask[:, :1]
        if token_type_ids is not None:
            token_type_ids = token_type_ids[:, :1]
    (seed,) = L.dropout_seeds(generator, 1, deterministic)
    text_emb = bert.embed(params.bert, cfg.bert, input_ids,
                          token_type_ids=token_type_ids, seed=seed)
    hidden = torch.cat([text_emb, vis_tokens], dim=1)
    mask = torch.cat([attention_mask, vis_mask.to(attention_mask.dtype)],
                     dim=1)
    moe = cfg.bert.moe_experts > 0
    sequence = bert.encode(params.bert, cfg.bert, hidden, mask,
                           compute_dtype=compute_dtype,
                           deterministic=deterministic, generator=generator,
                           remat_layers=remat_layers, return_moe_aux=moe)
    moe_aux = None
    if moe:
        sequence, moe_aux = sequence
    return ECAEncoderOutput(pooler_output=sequence[:, 0],
                            last_hidden_state=sequence, moe_aux=moe_aux)


def scatter_visual_tokens(hidden: torch.Tensor, vis_rows: torch.Tensor,
                          vis_cols: torch.Tensor,
                          vis_tokens: torch.Tensor) -> torch.Tensor:
    """``hidden.at[vis_rows, vis_cols].set(vis_tokens, mode="drop")`` of
    the JAX package: each (row, col) pointer's slot of the (R, C, D) canvas
    takes its token's whole vector; a negative pointer counts from the end
    (JAX index normalisation) and a pointer still outside the canvas is
    dropped. Dropped writes go to a scratch row, so nothing is read back
    to the host and no index is out of range."""
    r, c, d = hidden.shape
    rows = vis_rows.reshape(-1).long()
    cols = vis_cols.reshape(-1).long()
    rows = torch.where(rows < 0, rows + r, rows)
    cols = torch.where(cols < 0, cols + c, cols)
    inside = (rows >= 0) & (rows < r) & (cols >= 0) & (cols < c)
    flat = torch.where(inside, rows * c + cols, r * c)
    canvas = torch.cat([hidden.reshape(r * c, d), hidden.new_zeros((1, d))])
    canvas.index_copy_(0, flat, vis_tokens.reshape(-1, d).to(hidden.dtype))
    return canvas[: r * c].view(r, c, d)


def mask_visual_slots(segment_ids: torch.Tensor, vis_rows: torch.Tensor,
                      vis_cols: torch.Tensor) -> torch.Tensor:
    """``segment_ids`` with every reserved visual slot set to 0 (padding),
    pointers outside the canvas dropped as in :func:`scatter_visual_tokens`:
    a text-only tower reads an ECA canvas as the packed text alone."""
    zeros = torch.zeros(vis_rows.shape + (1,), dtype=segment_ids.dtype,
                        device=segment_ids.device)
    return scatter_visual_tokens(segment_ids[..., None], vis_rows, vis_cols,
                                 zeros)[..., 0]


def eca_apply_packed(params: ECA, cfg: MMConfig, input_ids, segment_ids,
                     position_ids, cls_rows, cls_cols, vis_rows, vis_cols,
                     face_inputs, image_inputs=None,
                     deterministic: bool = True, generator=None,
                     compute_dtype=torch.float32, remat_layers: bool = False,
                     return_aux: bool = False):
    """Packed-canvas ECA forward: many samples per row (ops/packing.py).

    The canvas comes from ``packing.pack_with_reserved(seqs, T_vis, ...)``:
    each sample's segment holds its text tokens followed by T_vis reserved
    slots at (vis_rows, vis_cols) (shape (n_cls, T_vis)). The text canvas
    is embedded normally, then each sample's face/image tokens
    (``_visual_tokens``, as in :func:`eca_apply`) replace the whole vector
    of its reserved slots (:func:`scatter_visual_tokens`). Slots whose
    face/image is absent carry segment id 0 (the collator's job), so
    attention ignores them.

    Returns (n_cls, D) CLS states; entries past the packer's n_seqs are
    garbage — slice them off. With ``return_aux``, (cls, moe_aux): the
    MoE load-balance term (None for a dense config)."""
    if cfg.no_text:
        raise NotImplementedError(
            "packed ECA assumes text tokens; use eca_apply for no_text")
    vis_tokens, _ = _visual_tokens(params, cfg, face_inputs, image_inputs,
                                   deterministic, generator)
    (seed,) = L.dropout_seeds(generator, 1, deterministic)
    hidden = bert.embed(params.bert, cfg.bert, input_ids,
                        position_ids=position_ids, seed=seed)
    b, t_vis = vis_tokens.shape[:2]
    # pointer arrays are n_cls-padded; visual inputs carry the true batch
    vis_rows, vis_cols = vis_rows[:b], vis_cols[:b]
    assert tuple(vis_rows.shape) == (b, t_vis), (vis_rows.shape, (b, t_vis))
    hidden = scatter_visual_tokens(hidden, vis_rows, vis_cols, vis_tokens)
    moe = cfg.bert.moe_experts > 0
    sequence = bert.encode(params.bert, cfg.bert, hidden,
                           compute_dtype=compute_dtype,
                           segment_ids=segment_ids,
                           deterministic=deterministic, generator=generator,
                           remat_layers=remat_layers, return_moe_aux=moe)
    moe_aux = None
    if moe:
        sequence, moe_aux = sequence
    cls = sequence[cls_rows.long(), cls_cols.long()]
    return (cls, moe_aux) if return_aux else cls


# --------------------------------------------------------------------------
# Intermediate Linear Fusion
# --------------------------------------------------------------------------
def _ilf_fuse_visual(params: ILF, cfg: MMConfig, output, face_inputs,
                     image_inputs, deterministic: bool = True,
                     generator=None):
    """Shared ILF fusion tail: masked face-projection sum + image-projection
    sums + LN + dropout, one seed per site. Exclusivity zeroes the image
    INPUT (reference parity: the dense bias still leaks through for
    face-bearing samples)."""
    faces = face_inputs["face"]
    b, n_images, n_faces, _ = faces.shape
    # the face branch, one per image kind, the fused output
    seeds = L.dropout_seeds(generator, 2 + len(image_inputs or {}),
                            deterministic)
    if n_faces > 0:
        face_out = face_embedding_apply(
            params.face_embedding, cfg,
            faces.reshape(b, n_images * n_faces, -1),
            face_inputs["bbox"].reshape(b, n_images * n_faces, -1),
            seed=seeds[0])
        mask = face_inputs["attention_mask"].reshape(b, n_images * n_faces,
                                                     1)
        output = output + (face_out * mask).sum(dim=1)

    face_mask_flat = face_inputs["attention_mask"].reshape(b, -1)
    has_face = face_mask_flat.sum(dim=1, keepdim=True) > 0
    for img_i, (name, image) in enumerate((image_inputs or {}).items()):
        inp = image["input"].reshape(b, -1)
        if cfg.face_and_image_are_exclusive:
            inp = torch.where(has_face, 0.0, inp)
        output = output + image_embedding_apply(
            params.image_embeddings[name], cfg, inp, seed=seeds[1 + img_i])
    output = L.layer_norm(params.ln, output, cfg.bert.layer_norm_eps)
    return L.dropout(output, cfg.bert.hidden_dropout_prob, seeds[-1])


def ilf_apply(params: ILF, cfg: MMConfig, text_inputs, face_inputs,
              image_inputs=None, deterministic: bool = True, generator=None,
              compute_dtype=torch.float32,
              remat_layers: bool = False) -> EncoderOutput:
    out = bert.apply(params.dpr_encoder, cfg.bert, text_inputs["input_ids"],
                     text_inputs["attention_mask"],
                     token_type_ids=text_inputs.get("token_type_ids"),
                     compute_dtype=compute_dtype,
                     deterministic=deterministic, generator=generator,
                     remat_layers=remat_layers)
    output = L.dense(params.dpr_proj, out["last_hidden_state"][:, 0])
    return EncoderOutput(pooler_output=_ilf_fuse_visual(
        params, cfg, output, face_inputs, image_inputs, deterministic,
        generator), moe_aux=out.get("moe_aux"))


def ilf_apply_packed(params: ILF, cfg: MMConfig, input_ids, segment_ids,
                     position_ids, cls_rows, cls_cols, face_inputs,
                     image_inputs=None, deterministic: bool = True,
                     generator=None,
                     compute_dtype=torch.float32, remat_layers: bool = False,
                     return_aux: bool = False):
    """Packed-canvas ILF forward: the text CLS comes from a packed DPR
    tower (block-diagonal attention); the visual side is a per-sample SUM
    of projections, so plain ``pack_text_inputs`` canvases work. Returns
    (B, D) for the B samples of ``face_inputs`` (or (out, None) with
    ``return_aux``; moe_aux is None for a dense config)."""
    out = bert.apply(params.dpr_encoder, cfg.bert, input_ids,
                     position_ids=position_ids, segment_ids=segment_ids,
                     compute_dtype=compute_dtype,
                     deterministic=deterministic, generator=generator,
                     remat_layers=remat_layers)
    text = out["last_hidden_state"][cls_rows.long(), cls_cols.long()]
    b = face_inputs["face"].shape[0]
    output = _ilf_fuse_visual(params, cfg, L.dense(params.dpr_proj,
                                                   text[:b]),
                              face_inputs, image_inputs, deterministic,
                              generator)
    return (output, out.get("moe_aux")) if return_aux else output


# --------------------------------------------------------------------------
# Flamant: gated cross-attention every n layers
# --------------------------------------------------------------------------
@torch.no_grad()
def flamant_apply(params: Flamant, cfg: FlamantConfig, text_inputs,
                  face_inputs, image_inputs=None, deterministic: bool = True,
                  rng=None, compute_dtype=torch.float32) -> ECAEncoderOutput:
    if not deterministic or rng is not None:
        raise NotImplementedError(
            "Flamant is ported for evaluation: no trainee builds it, so its "
            "dropout sites are not ported")
    if cfg.bert.moe_experts > 0:
        raise NotImplementedError(
            "Flamant hand-rolls its BertLayer loop (gated cross-attention "
            "interleaving) and does not support moe_experts > 0 — use a "
            "dense BertConfig or the ECA/ILF/DPR MoE paths")
    vis_tokens, vis_mask = _visual_tokens(params, cfg, face_inputs,
                                          image_inputs)
    x = bert.embed(params.bert, cfg.bert, text_inputs["input_ids"],
                   token_type_ids=text_inputs.get("token_type_ids"))
    bcfg = cfg.bert
    eps = bcfg.layer_norm_eps
    text_bias = L.attention_bias_from_mask(text_inputs["attention_mask"])
    vis_bias = L.attention_bias_from_mask(vis_mask)
    for i, layer in enumerate(params.bert.layers):
        xl = params.xattn_layers[str(i)] \
            if str(i) in params.xattn_layers else None
        if xl is not None and vis_tokens.shape[1] > 0:
            # gated cross-attention block (residual + LN inside, like
            # BertAttention), then the gated FFW, then LN
            attn = L.mha(xl.xattn, x, bias=vis_bias,
                         n_heads=cfg.image_num_attention_heads,
                         compute_dtype=compute_dtype, kv=vis_tokens)
            attn = L.layer_norm(xl.xattn_ln, attn + x, eps)
            if cfg.gating:
                attn = tanh_gate(xl.attn_gate, attn)
            x = attn + x
            ffw = L.mlp(xl.ffw, x, "gelu", compute_dtype)
            if cfg.gating:
                ffw = tanh_gate(xl.ffw_gate, ffw)
            x = L.layer_norm(xl.ln, ffw + x, eps)
        # standard BERT layer
        attn = L.mha(layer["attention"], x, bias=text_bias,
                     n_heads=bcfg.num_attention_heads,
                     compute_dtype=compute_dtype)
        x = L.layer_norm(layer["attention_ln"], x + attn, eps)
        ff = L.mlp(layer["mlp"], x, bcfg.hidden_act, compute_dtype)
        x = L.layer_norm(layer["output_ln"], x + ff, eps)
    return ECAEncoderOutput(pooler_output=x[:, 0], last_hidden_state=x)


# --------------------------------------------------------------------------
# config-registry bundles (get_pretrained by class_name)
# --------------------------------------------------------------------------
def mm_config(**cfg_kwargs) -> MMConfig:
    """An MMConfig from a kwargs tree: ``image_dims`` as a dict (JSON
    order kept) or a list of [name, dim] pairs, ``bert`` as a dict."""
    cfg_kwargs = dict(cfg_kwargs)  # don't mutate the caller's tree
    dims = cfg_kwargs.get("image_dims")
    if isinstance(dims, dict):
        cfg_kwargs["image_dims"] = tuple(dims.items())
    elif dims is not None:
        cfg_kwargs["image_dims"] = tuple(tuple(pair) for pair in dims)
    if isinstance(cfg_kwargs.get("bert"), dict):
        cfg_kwargs["bert"] = bert.BertConfig(**cfg_kwargs["bert"])
    return MMConfig(**cfg_kwargs)


class _MMEncoderBundle:
    """cfg + params + apply_fn, the triple the embedders consume. Without
    ``params`` the weights are drawn from ``seed`` (:func:`init`);
    ``from_pretrained`` reads an export directory (train/checkpoint.py) of
    either package."""

    module_cls = None
    forward = None

    def __init__(self, cfg: Optional[MMConfig] = None, params=None,
                 seed: int = 0, device=None, **cfg_kwargs):
        self.cfg = cfg if cfg is not None else mm_config(**cfg_kwargs)
        self.params = (params if params is not None
                       else init(type(self).module_cls, self.cfg, seed,
                                 device))

    @classmethod
    def from_pretrained(cls, path, device=None, cfg=None, seed: int = 0,
                        **cfg_kwargs):
        from viquae_torch.train.checkpoint import import_params

        cfg = cfg if cfg is not None else mm_config(**cfg_kwargs)
        return cls(cfg=cfg, params=from_jax(cls.module_cls, cfg,
                                            import_params(path), device))

    def apply_fn(self, params, text_inputs, face_inputs, image_inputs=None,
                 **kw):
        return type(self).forward(params, self.cfg, text_inputs,
                                  face_inputs, image_inputs, **kw)


@_register("ECAEncoder")
class ECAEncoder(_MMEncoderBundle):
    module_cls = ECA
    forward = staticmethod(eca_apply)
    PACKED_NEEDS_VIS = True  # visual tokens scatter into reserved slots

    def packed_apply_fn(self, params, input_ids, segment_ids, position_ids,
                        cls_rows, cls_cols, vis_rows, vis_cols,
                        face_inputs, image_inputs=None, **kw):
        return eca_apply_packed(params, self.cfg, input_ids, segment_ids,
                                position_ids, cls_rows, cls_cols, vis_rows,
                                vis_cols, face_inputs, image_inputs, **kw)


@_register("IntermediateLinearFusion")
class IntermediateLinearFusion(_MMEncoderBundle):
    module_cls = ILF
    forward = staticmethod(ilf_apply)
    PACKED_NEEDS_VIS = False  # visual side is a sum, not tokens

    def packed_apply_fn(self, params, input_ids, segment_ids, position_ids,
                        cls_rows, cls_cols, face_inputs, image_inputs=None,
                        **kw):
        return ilf_apply_packed(params, self.cfg, input_ids, segment_ids,
                                position_ids, cls_rows, cls_cols,
                                face_inputs, image_inputs, **kw)


# --------------------------------------------------------------------------
# CLIPForIR
# --------------------------------------------------------------------------
def clip_for_ir_apply(clip_params, text_cfg, vision_cfg, input_ids,
                      attention_mask, pixel_values,
                      compute_dtype=torch.float32) -> EncoderOutput:
    """text_embeds + image_embeds (``clip_params``: {"text": CLIPText,
    "vision": CLIPVision}): with dot-product similarity this scores every
    mono- and cross-modal pair."""
    from viquae_torch.models import clip as clip_lib

    text = clip_lib.text_apply(clip_params["text"], text_cfg, input_ids,
                               attention_mask,
                               compute_dtype=compute_dtype)["text_embeds"]
    image = clip_lib.vit_apply(clip_params["vision"], vision_cfg,
                               pixel_values,
                               compute_dtype=compute_dtype)["image_embeds"]
    return EncoderOutput(pooler_output=text + image)
