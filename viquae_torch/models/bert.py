"""BERT encoder (post-LN), counterpart of viquae_tpu/models/bert.py.

:class:`Bert` holds the weights in the JAX package's tree layout
(``embeddings.{word,position,token_type,ln}``, ``layers[i].{attention.
{q,k,v,o}, attention_ln, mlp.{in,out} | moe.{router,in,out}, output_ln}``,
``pooler``) so that :func:`viquae_torch.models.convert.params_from_jax`
maps names one to one; :func:`apply` is the forward. With
``moe_experts > 0`` every ``moe_every``-th layer's FFN is a
Mixture-of-Experts block (ops/moe.py) whose tokens outside the attention
mask (or canvas segment 0) claim no expert slot, and the forward returns
the summed load-balance term (``moe_aux``). Training arguments:
``deterministic`` (False turns dropout on at the config's rates, at the
JAX package's four sites: embeddings, attention probabilities, attention
output, FFN output), ``generator``
(the CPU ``torch.Generator`` the dropout seeds are drawn from) and
``remat_layers`` (each layer under ``torch.utils.checkpoint``, its seeds
drawn before it, so the recomputed masks are the same).

On a mesh: :func:`param_spec` is the reference's tensor-parallel layout
(attention heads and MLP units over ``model``, the experts of a MoE layer
over ``model``, the rest replicated), for ``models.sharding``; the layers
then run on their shards (``layers.mha`` / ``mlp``, ``moe.moe_apply``).
``activation_sharding`` is the sequence-parallel seam: with L over
``model`` the activations between layers are this rank's slice of the
sequence, LayerNorm, dropout and the residual run on it, and each block
gathers the whole sequence (a reduce-scatter returns its output's slice).
:func:`params_to_hf_state_dict` / :func:`save_pretrained_hf` export the
weights as an HF ``BertModel``.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from viquae_torch.core import mesh as meshlib
from viquae_torch.core import profiling
from viquae_torch.core.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS
from viquae_torch.models import layers as L
from viquae_torch.ops import encoder_glue as glue
from viquae_torch.ops import moe as moe_lib


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    add_pooler: bool = True
    # Mixture-of-Experts FFN (ops/moe.py): 0 = the dense HF-portable
    # BERT; > 0 swaps the FFN of every moe_every-th layer for a block of
    # moe_experts experts, routed in GShard groups of moe_group_size tokens
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 1
    moe_group_size: int = 1024

    @classmethod
    def from_hf(cls, hf_config, add_pooler: bool = True) -> "BertConfig":
        """From an HF BERT config: the dict of a ``config.json`` or an
        object with the same attributes."""
        def get(name, *default):
            if isinstance(hf_config, dict):
                return (hf_config.get(name, *default) if default
                        else hf_config[name])
            return getattr(hf_config, name, *default)

        names = ("vocab_size", "hidden_size", "num_hidden_layers",
                 "num_attention_heads", "intermediate_size",
                 "max_position_embeddings", "type_vocab_size", "hidden_act",
                 "layer_norm_eps")
        values = {name: get(name) for name in names}
        for name in ("hidden_dropout_prob", "attention_probs_dropout_prob"):
            values[name] = get(name, 0.1)
        return cls(**values, add_pooler=add_pooler)


def _is_moe_layer(cfg: BertConfig, i: int) -> bool:
    return cfg.moe_experts > 0 and (i + 1) % cfg.moe_every == 0


def _ffn_init(cfg: BertConfig, i: int, **factory) -> Dict[str, nn.Module]:
    if _is_moe_layer(cfg, i):
        return {"moe": moe_lib.moe_init(cfg.hidden_size,
                                         cfg.intermediate_size,
                                         cfg.moe_experts, **factory)}
    return {"mlp": L.mlp_init(cfg.hidden_size, cfg.intermediate_size,
                              **factory)}


def param_spec(cfg: BertConfig) -> dict:
    """Tensor parallelism over ``model`` (the reference's
    ``bert.param_spec``): each layer's attention (``layers.mha_spec``,
    whole heads) and MLP (``layers.mlp_spec``), or its experts
    (``moe.moe_spec``) on a MoE layer; embeddings, LayerNorms and the
    pooler replicated."""
    def layer_spec(i):
        s = {"attention": L.mha_spec(cfg.num_attention_heads),
             "attention_ln": L.layer_norm_spec(),
             "output_ln": L.layer_norm_spec()}
        if _is_moe_layer(cfg, i):
            s["moe"] = moe_lib.moe_spec()
        else:
            s["mlp"] = L.mlp_spec()
        return s

    table = {"weight": None}
    spec = {"embeddings": {"word": table, "position": dict(table),
                           "token_type": dict(table),
                           "ln": L.layer_norm_spec()},
            "layers": [layer_spec(i) for i in range(cfg.num_hidden_layers)]}
    if cfg.add_pooler:
        spec["pooler"] = L.dense_spec()
    return spec


def _sequence_axis(activation_sharding) -> Optional[str]:
    """The mesh axis the L dimension of (B, L, D) is split over: the
    seam takes the reference's PartitionSpec entries, (batch axis or None,
    ``model``, None)."""
    if activation_sharding is None:
        return None
    spec = tuple(activation_sharding) + (None,) * (
        3 - len(tuple(activation_sharding)))
    if spec[0] not in (None, DATA_AXIS) or spec[1] not in (None, MODEL_AXIS) \
            or spec[2] is not None:
        raise ValueError(f"activation_sharding: (B, L, D) may split B over "
                         f"data and L over model, got {spec}")
    return spec[1]


class Bert(nn.Module):
    """BERT weights in the JAX param-tree layout; ``forward`` is
    :func:`apply`."""

    def __init__(self, cfg: BertConfig, **factory):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embeddings = nn.ModuleDict({
            "word": nn.Embedding(cfg.vocab_size, h, **factory),
            "position": nn.Embedding(cfg.max_position_embeddings, h,
                                     **factory),
            "token_type": nn.Embedding(cfg.type_vocab_size, h, **factory),
            "ln": L.layer_norm_init(h, cfg.layer_norm_eps, **factory),
        })
        self.layers = nn.ModuleList([
            nn.ModuleDict({
                "attention": L.mha_init(h, **factory),
                "attention_ln": L.layer_norm_init(h, cfg.layer_norm_eps,
                                                  **factory),
                **_ffn_init(cfg, i, **factory),
                "output_ln": L.layer_norm_init(h, cfg.layer_norm_eps,
                                               **factory),
            })
            for i in range(cfg.num_hidden_layers)
        ])
        self.pooler = (L.dense_init(h, h, **factory) if cfg.add_pooler
                       else None)

    def forward(self, input_ids, **kw):
        return apply(self, self.cfg, input_ids, **kw)


def embed(
    params: Bert,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """word + position + type embeddings, summed in the PARAMETER dtype
    (as the JAX package does), then the f32 LayerNorm and, with a
    ``seed``, dropout -> (B, L, D) f32."""
    emb = params.embeddings
    b, l = input_ids.shape
    device = input_ids.device
    if position_ids is None:
        position_ids = torch.arange(l, device=device)[None, :]
    x = (emb["word"].weight[input_ids.long()]
         + emb["position"].weight[position_ids.long()])
    if token_type_ids is None:
        token_type_ids = torch.zeros((b, l), dtype=torch.long, device=device)
    x = x + emb["token_type"].weight[token_type_ids.long()]
    x = L.layer_norm(emb["ln"], x, cfg.layer_norm_eps)
    return L.dropout(x, cfg.hidden_dropout_prob, seed)


def _layer_forward(layer: nn.ModuleDict, x, bias, cfg: BertConfig,
                   compute_dtype, seeds: Sequence[Optional[int]] = (
                       None, None, None), token_mask=None, seq_axis=None,
                   segment_ids=None, x_low=None):
    """One post-LN transformer block; ``seeds`` = the dropout seeds of the
    attention probabilities, the attention output and the FFN output.
    Returns (y, moe_aux, y_low): moe_aux is None for a dense FFN.
    ``token_mask`` (B, L) keeps padding tokens out of MoE routing. With
    ``seq_axis``, ``x`` and the output are this rank's slice of L.
    ``segment_ids``: a packed canvas's, for the attention
    (``layers.mha``).

    Where ``layers.takes_fused_glue`` holds, the block runs
    :func:`_fused_block`; ``x_low`` is then ``x`` rounded to
    ``compute_dtype`` if the previous block made it, and ``y_low`` is
    ``y`` rounded, for the next block. Elsewhere ``y_low`` is None. Every
    call adds one to the ``glue.fused_calls`` or ``glue.plain_calls``
    counter (core/profiling.py) by the path it takes."""
    seed_a, seed_h, seed_b = seeds
    fused = L.takes_fused_glue(
        x, layer, compute_dtype, cfg.hidden_act,
        ((cfg.attention_probs_dropout_prob, seed_a),
         (cfg.hidden_dropout_prob, seed_h), (cfg.hidden_dropout_prob, seed_b)),
        seq_axis)
    profiling.count("glue.fused_calls" if fused else "glue.plain_calls")
    if fused:
        y, y_low = _fused_block(layer, x, x_low, bias, cfg, compute_dtype,
                                segment_ids)
        return y, None, y_low
    folds = (DATA_AXIS,) if seq_axis is None else (DATA_AXIS, seq_axis)
    eps = cfg.layer_norm_eps
    attn = L.mha(layer["attention"], x, bias=bias,
                 n_heads=cfg.num_attention_heads, compute_dtype=compute_dtype,
                 dropout_rate=cfg.attention_probs_dropout_prob, seed=seed_a,
                 seq_axis=seq_axis, segment_ids=segment_ids)
    attn = L.dropout(attn, cfg.hidden_dropout_prob, seed_h, folds)
    x = L.layer_norm(layer["attention_ln"], x + attn, eps, seq_axis)
    aux = None
    if "moe" in layer:
        whole = x if seq_axis is None else meshlib.gather_to(x, seq_axis, 1)
        ff, aux = moe_lib.moe_apply(
            layer["moe"], whole, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, act=cfg.hidden_act,
            compute_dtype=compute_dtype, group_size=cfg.moe_group_size,
            token_mask=token_mask)
        if seq_axis is not None:
            ff = meshlib.scatter_to(ff, seq_axis, 1)
    else:
        ff = L.mlp(layer["mlp"], x, cfg.hidden_act, compute_dtype, seq_axis)
    ff = L.dropout(ff, cfg.hidden_dropout_prob, seed_b, folds)
    return L.layer_norm(layer["output_ln"], x + ff, eps, seq_axis), aux, None


def _fused_block(layer: nn.ModuleDict, x, x_low, bias, cfg: BertConfig,
                 compute_dtype, segment_ids):
    """:func:`_layer_forward`'s math with the glue between the GEMMs in
    ops/encoder_glue.py's kernels: the o and ``mlp.out`` products leave
    their GEMMs without bias, and kernel A adds it, the residual and the
    LayerNorm, writing the f32 stream and its bf16 copy; kernel B adds
    ``mlp.in``'s bias and applies GELU, writing bf16 only. The q, k, v and
    ``mlp.in`` GEMMs read the bf16 copy, which the first block makes from
    ``x`` in one cast. Returns (y, y rounded to ``compute_dtype``)."""
    if x_low is None:
        x = x.contiguous()
        x_low = x.to(compute_dtype)
    eps = cfg.layer_norm_eps
    attn, mlp, a_ln, o_ln = (layer[name] for name in (
        "attention", "mlp", "attention_ln", "output_ln"))
    y = L.mha(attn, x_low, bias=bias, n_heads=cfg.num_attention_heads,
              compute_dtype=compute_dtype, segment_ids=segment_ids,
              out_bias=False)
    x, x_low = glue.bias_residual_layernorm(y, attn["o"].bias, x,
                                            a_ln.weight, a_ln.bias, eps)
    h = glue.bias_gelu(L._matmul(mlp["in"], x_low, compute_dtype),
                       mlp["in"].bias)
    return glue.bias_residual_layernorm(L._matmul(mlp["out"], h,
                                                  compute_dtype),
                                        mlp["out"].bias, x, o_ln.weight,
                                        o_ln.bias, eps)


def _bias_when_needed(segment_ids):
    """A packed canvas's (B, 1, L, L) block-diagonal bias as a function of
    no arguments: built at its first call and kept. ``layers.mha`` calls it
    only on the plain path, so an encoder whose every layer runs the fused
    kernel builds none; training builds it once."""
    return functools.cache(functools.partial(L.attention_bias_from_segments,
                                             segment_ids))


def _layer_under(ctx, *args):
    """:func:`_layer_forward` under the mesh ``ctx``: the recomputation
    of a remat layer in the backward pass sees the forward's mesh."""
    with meshlib.use(ctx):
        return _layer_forward(*args)


def encode(
    params: Bert,
    cfg: BertConfig,
    hidden: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    segment_ids: Optional[torch.Tensor] = None,
    output_hidden_states: bool = False,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    remat_layers: bool = False,
    return_moe_aux: bool = False,
    activation_sharding=None,
):
    """Encoder stack over (B, L, D) hidden states. ``segment_ids`` (B, L),
    0 = padding: packed-canvas mode — attention is block-diagonal per
    segment, overriding ``attention_mask``; the layers get the ids, and
    the (B, 1, L, L) bias is built where a layer first takes the plain
    path of ``layers.mha``. With ``output_hidden_states``
    returns (final, [embedding_out, layer1_out, ...]). ``remat_layers``
    recomputes each layer in the backward pass (per-layer gradient
    checkpointing), so one layer's activations are live at a time.

    With ``return_moe_aux`` (MoE configs) the summed load-balance term of
    the MoE layers is appended: (x[, hidden], aux). Training a MoE config
    without asking for it raises: a loss without the balance term lets
    the experts collapse.

    ``activation_sharding`` (the reference's PartitionSpec entries over
    (B, L, D), e.g. ``(DATA_AXIS, MODEL_AXIS, None)``) is the
    sequence-parallel seam: L is split over ``model`` of the current mesh
    between the layers (it must divide), and the outputs are whole
    again."""
    if cfg.moe_experts > 0 and not deterministic and not return_moe_aux:
        raise ValueError(
            "moe_experts > 0 in training mode requires return_moe_aux="
            "True — add the load-balance aux to the loss (ops/moe.py)")
    b, l = hidden.shape[:2]
    if segment_ids is not None:
        bias = _bias_when_needed(segment_ids)
        token_mask = segment_ids > 0  # canvas padding rows (segment 0)
    else:
        if attention_mask is None:
            attention_mask = torch.ones((b, l), device=hidden.device)
        bias = L.attention_bias_from_mask(attention_mask)
        token_mask = attention_mask > 0
    # padding tokens claim no MoE slot; dense layers ignore the mask
    if cfg.moe_experts == 0:
        token_mask = None
    # three independent dropout sites per layer; every seed is drawn here,
    # outside any checkpointed region
    seeds = L.dropout_seeds(generator, 3 * len(params.layers),
                            deterministic)
    seq_axis = _sequence_axis(activation_sharding)
    if seq_axis is not None and meshlib.current().group(seq_axis) is None:
        seq_axis = None      # a world of one: nothing to split
    if seq_axis is not None and l % meshlib.current().size(seq_axis):
        raise ValueError(f"sequence parallelism: L = {l} does not divide "
                         f"by the {seq_axis!r} axis' "
                         f"{meshlib.current().size(seq_axis)}")

    def whole(t):
        return t if seq_axis is None else meshlib.gather_to(t, seq_axis, 1)

    x = hidden if seq_axis is None else meshlib.scatter_to(hidden, seq_axis,
                                                           1)
    all_hidden = [hidden]
    moe_aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    x_low = None     # x rounded to compute_dtype, where a fused block made it
    for i, layer in enumerate(params.layers):
        layer_seeds = tuple(seeds[3 * i: 3 * i + 3])
        if remat_layers and torch.is_grad_enabled():
            x, aux, x_low = checkpoint(
                _layer_under, meshlib.current(), layer, x, bias, cfg,
                compute_dtype, layer_seeds, token_mask, seq_axis,
                segment_ids, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux, x_low = _layer_forward(layer, x, bias, cfg,
                                           compute_dtype, layer_seeds,
                                           token_mask, seq_axis,
                                           segment_ids, x_low)
        if aux is not None:
            moe_aux = moe_aux + aux
        if output_hidden_states:
            all_hidden.append(whole(x))
    x = whole(x)
    out = (x,)
    if output_hidden_states:
        out = out + (all_hidden,)
    if return_moe_aux:
        out = out + (moe_aux,)
    return out if len(out) > 1 else out[0]


# ---- pipeline parallelism (ops/pipeline.py over the ``pipe`` axis) --------
def pipeline_params(params: Bert, n_stages: int) -> Bert:
    """A copy of ``params`` whose ``layers`` is a ``pipeline.Stages`` of
    ``n_stages`` equal stages (``layers[s][j]`` is layer ``s * per + j``):
    the staged layout :func:`encode_pipelined` runs and
    :func:`pipeline_param_spec` splits over ``pipe``. Embeddings and pooler
    stay as they are (replicated: they run outside the pipelined region).
    Raises on an uneven split."""
    from viquae_torch.ops import pipeline as pl

    out = copy.deepcopy(params)
    out.layers = pl.stack_stages(list(out.layers), n_stages)
    return out


def pipeline_unstack(params: Bert) -> Bert:
    """Inverse of :func:`pipeline_params`: a copy with the per-layer
    ``ModuleList`` (the checkpoint and HF layout). A shard that holds one
    stage is gathered first (``models.sharding.gather_module``)."""
    from viquae_torch.ops import pipeline as pl

    out = copy.deepcopy(params)
    out.layers = pl.unstack_stages(out.layers)
    return out


def pipeline_param_spec(cfg: BertConfig, n_stages: int) -> dict:
    """The spec of staged params (``models.sharding``): the stages split
    over ``pipe`` (a shard keeps this rank's stage), everything else
    replicated — the reference's ``pipeline_param_spec``. ``n_stages``
    must split the layers evenly (the mesh's ``pipe`` size)."""
    from viquae_torch.ops import pipeline as pl

    pl._split_count(cfg.num_hidden_layers, n_stages)
    spec = param_spec(cfg)
    spec["layers"] = pl.stage_spec()
    return spec


def encode_pipelined(
    params: Bert,
    cfg: BertConfig,
    hidden: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    *,
    n_micro: int,
    mesh_ctx=None,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    compute_dtype=torch.float32,
    segment_ids: Optional[torch.Tensor] = None,
    remat_layers: bool = False,
) -> torch.Tensor:
    """:func:`encode` over the ``pipe`` mesh axis (GPipe schedule,
    ops/pipeline.py) -> (B, L, D) f32 on every rank.

    ``params.layers`` is in the staged layout (:func:`pipeline_params`:
    all stages, or a shard holding this rank's). ``hidden``: the global
    batch (every rank holds it, as in training). On a ``data`` axis of
    several ranks each rank takes its block of the rows
    (``train.data_parallel.Rows``), microbatches it into ``n_micro`` and
    returns the global output through ``gather_from`` over ``data`` (its
    backward sums the ranks' cotangents; the trainer's mean over ``data``
    then gives one device's gradient). Every output row depends on its own
    row only, so how rows group into microbatches changes no value; a
    batch whose rows do not divide by ``data`` x ``n_micro`` raises, as
    the reference's ``microbatch``. Padded-mask and packed
    ``segment_ids`` modes: the mask's bias is built once and microbatched
    with the hidden states; a packed canvas's segment ids are microbatched
    instead, and a stage builds a microbatch's bias where a layer first
    takes the plain path (as in :func:`encode`).

    Dropout seeds are drawn for every (microbatch, global layer, site)
    from ``generator`` before the schedule, on every rank, so a stage's
    masks do not depend on the rank that holds it; they are other masks
    than :func:`encode`'s. ``remat_layers`` checkpoints each layer inside
    a stage (recomputed under the forward's mesh). Deterministic, the
    output and gradients equal :func:`encode`'s up to the f32 order of
    the microbatched products (bit for bit at one microbatch)."""
    from viquae_torch.ops import pipeline as pl
    from viquae_torch.train import data_parallel as dp

    if cfg.moe_experts > 0:
        # pp x ep composition is a non-goal, as in the reference: the stage
        # contract is shape-preserving per microbatch and has no channel
        # for the per-stage MoE aux loss
        raise NotImplementedError(
            "encode_pipelined does not support MoE layers "
            "(moe_experts > 0) — use the sequential encoder with ep")
    ctx = mesh_ctx if mesh_ctx is not None else meshlib.current()
    stages = params.layers
    if not isinstance(stages, pl.Stages):
        raise ValueError("encode_pipelined needs staged params "
                         "(bert.pipeline_params)")
    if stages.n_stages != ctx.pipe_size:
        raise ValueError(
            f"params carry {stages.n_stages} stages but the mesh's pipe "
            f"axis is {ctx.pipe_size} — restage with pipeline_params")
    b, l = hidden.shape[:2]
    if segment_ids is not None:
        # each microbatch's bias is built where a layer first needs it
        per_row = {"segment_ids": segment_ids}
    else:
        if attention_mask is None:
            attention_mask = torch.ones((b, l), device=hidden.device)
        bias = L.attention_bias_from_mask(attention_mask)
        # microbatch the query dim even for broadcast (B, 1, 1, L) biases
        per_row = {"bias": bias.expand((b,) + tuple(bias.shape[1:]))}
    rows = dp.Rows(b, ctx)
    if ctx.size(DATA_AXIS) > 1 and not rows.split:
        raise ValueError(f"batch {b} not divisible by the data axis' "
                         f"{ctx.size(DATA_AXIS)} x n_micro={n_micro}")
    n_layers = stages.n_stages * stages.per
    seeds = L.dropout_seeds(generator, 3 * n_layers * n_micro,
                            deterministic)
    consts = {name: pl.microbatch(rows.take(t), n_micro)
              for name, t in per_row.items()}
    consts["seeds"] = [seeds[3 * n_layers * m: 3 * n_layers * (m + 1)]
                       for m in range(n_micro)]

    def stage_fn(layers, x, c, offset):
        segs = c.get("segment_ids")
        bias = c["bias"] if segs is None else _bias_when_needed(segs)
        x_low = None
        for j, layer in enumerate(layers):
            i = offset + j
            layer_seeds = tuple(c["seeds"][3 * i: 3 * i + 3])
            if remat_layers and torch.is_grad_enabled():
                x, _, x_low = checkpoint(
                    _layer_under, meshlib.current(), layer, x, bias, cfg,
                    compute_dtype, layer_seeds, None, None, segs,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, _, x_low = _layer_forward(layer, x, bias, cfg,
                                             compute_dtype, layer_seeds,
                                             segment_ids=segs, x_low=x_low)
        return x

    with rows.scope():
        out = pl.pipeline_apply(
            stage_fn, stages[ctx.coordinate(PIPE_AXIS)],
            pl.microbatch(rows.take(hidden), n_micro), consts=consts,
            mesh_ctx=ctx)
    return rows.gather(pl.unmicrobatch(out))


def apply(
    params: Bert,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    compute_dtype=torch.float32,
    segment_ids: Optional[torch.Tensor] = None,
    output_hidden_states: bool = False,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    remat_layers: bool = False,
    activation_sharding=None,
) -> Dict[str, torch.Tensor]:
    """embed -> encode -> optional tanh pooler.

    Returns {"last_hidden_state": (B, L, D) f32, "pooler_output": (B, D)?}
    and, with ``output_hidden_states``, "hidden_states": [embedding_out,
    layer1_out, ...] (the per-layer seam of ``TextEmbedder(layers=...)``);
    a MoE config adds "moe_aux", the summed load-balance term.
    With ``segment_ids`` pass the packer's ``position_ids`` too, so
    positions restart per segment.
    """
    (seed,) = L.dropout_seeds(generator, 1, deterministic)
    x = embed(params, cfg, input_ids, token_type_ids=token_type_ids,
              position_ids=position_ids, seed=seed)
    moe = cfg.moe_experts > 0
    x = encode(params, cfg, x, attention_mask, compute_dtype=compute_dtype,
               segment_ids=segment_ids,
               output_hidden_states=output_hidden_states,
               deterministic=deterministic, generator=generator,
               remat_layers=remat_layers, return_moe_aux=moe,
               activation_sharding=activation_sharding)
    hidden_states = moe_aux = None
    if moe:
        *x, moe_aux = x
        x = x[0] if len(x) == 1 else tuple(x)
    if output_hidden_states:
        x, hidden_states = x
    out = {"last_hidden_state": x}
    if hidden_states is not None:
        out["hidden_states"] = hidden_states
    if moe_aux is not None:
        out["moe_aux"] = moe_aux
    if cfg.add_pooler and params.pooler is not None:
        out["pooler_output"] = torch.tanh(L.dense(params.pooler, x[:, 0]))
    return out


def state_dict_from_hf(state_dict, cfg: BertConfig, prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """A torch ``BertModel`` state_dict under :class:`Bert`'s names
    (counterpart of the JAX package's ``bert.params_from_hf``; both sides
    keep dense weights (out, in), so only the names change). ``prefix``
    strips a wrapper path (e.g. "bert.")."""
    if cfg.moe_experts > 0:
        raise ValueError(
            "HF BertModel checkpoints are dense — port into a "
            "moe_experts=0 config (MoE params have no HF counterpart)")

    def get(name):
        return torch.as_tensor(state_dict[prefix + name]).detach()

    out = {
        "embeddings.word.weight": get("embeddings.word_embeddings.weight"),
        "embeddings.position.weight":
            get("embeddings.position_embeddings.weight"),
        "embeddings.token_type.weight":
            get("embeddings.token_type_embeddings.weight"),
    }

    def both(ours, theirs):
        out[f"{ours}.weight"] = get(f"{theirs}.weight")
        out[f"{ours}.bias"] = get(f"{theirs}.bias")

    both("embeddings.ln", "embeddings.LayerNorm")
    for i in range(cfg.num_hidden_layers):
        base, layer = f"encoder.layer.{i}", f"layers.{i}"
        both(f"{layer}.attention.q", f"{base}.attention.self.query")
        both(f"{layer}.attention.k", f"{base}.attention.self.key")
        both(f"{layer}.attention.v", f"{base}.attention.self.value")
        both(f"{layer}.attention.o", f"{base}.attention.output.dense")
        both(f"{layer}.attention_ln", f"{base}.attention.output.LayerNorm")
        both(f"{layer}.mlp.in", f"{base}.intermediate.dense")
        both(f"{layer}.mlp.out", f"{base}.output.dense")
        both(f"{layer}.output_ln", f"{base}.output.LayerNorm")
    if cfg.add_pooler and (prefix + "pooler.dense.weight") in state_dict:
        both("pooler", "pooler.dense")
    return out


def params_to_hf_state_dict(params: Bert, cfg: BertConfig, prefix: str = ""
                            ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`state_dict_from_hf`: the weights as a torch
    ``BertModel`` state_dict on the CPU (the save_ptm contract: HF
    ``save_pretrained`` directories for downstream stages)."""
    if cfg.moe_experts > 0:
        raise ValueError(
            "MoE configs are not HF-BertModel-exportable — the expert "
            "stack has no state_dict counterpart")
    ours = params.state_dict()
    out = {}

    def put(theirs, name):
        out[prefix + theirs] = ours[name].detach().to(
            "cpu", torch.float32).contiguous()

    put("embeddings.word_embeddings.weight", "embeddings.word.weight")
    put("embeddings.position_embeddings.weight", "embeddings.position.weight")
    put("embeddings.token_type_embeddings.weight",
        "embeddings.token_type.weight")

    def both(theirs, name):
        put(f"{theirs}.weight", f"{name}.weight")
        put(f"{theirs}.bias", f"{name}.bias")

    both("embeddings.LayerNorm", "embeddings.ln")
    for i in range(cfg.num_hidden_layers):
        base, layer = f"encoder.layer.{i}", f"layers.{i}"
        both(f"{base}.attention.self.query", f"{layer}.attention.q")
        both(f"{base}.attention.self.key", f"{layer}.attention.k")
        both(f"{base}.attention.self.value", f"{layer}.attention.v")
        both(f"{base}.attention.output.dense", f"{layer}.attention.o")
        both(f"{base}.intermediate.dense", f"{layer}.mlp.in")
        both(f"{base}.output.dense", f"{layer}.mlp.out")
        both(f"{base}.attention.output.LayerNorm", f"{layer}.attention_ln")
        both(f"{base}.output.LayerNorm", f"{layer}.output_ln")
    if cfg.add_pooler and params.pooler is not None:
        both("pooler.dense", "pooler")
    return out


def load_hf_state_dict(path) -> Dict[str, torch.Tensor]:
    """The raw state dict of an HF ``save_pretrained`` directory
    (``pytorch_model.bin``, else ``model.safetensors``) on the CPU."""
    import os

    bin_path = os.path.join(str(path), "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    from safetensors.torch import load_file

    return load_file(os.path.join(str(path), "model.safetensors"))


def save_pretrained_hf(params: Bert, cfg: BertConfig, path, prefix: str = "",
                       head: Optional[Dict[str, torch.Tensor]] = None,
                       **hf_config_extra):
    """Write an HF-loadable BertModel dir (config.json +
    pytorch_model.bin). A task model's directory passes the encoder's
    ``prefix`` ("bert."), its ``head`` tensors under their HF names and
    its config entries (``architectures``, ``id2label``, ...)."""
    import json
    from pathlib import Path

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    hf_config = {
        "architectures": ["BertModel"],
        "model_type": "bert",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "hidden_act": cfg.hidden_act,
        "layer_norm_eps": cfg.layer_norm_eps,
        "hidden_dropout_prob": cfg.hidden_dropout_prob,
        "attention_probs_dropout_prob": cfg.attention_probs_dropout_prob,
        **hf_config_extra,
    }
    (path / "config.json").write_text(json.dumps(hf_config, indent=2))
    tensors = params_to_hf_state_dict(params, cfg, prefix=prefix)
    tensors.update({name: t.detach().to("cpu", torch.float32).contiguous()
                    for name, t in (head or {}).items()})
    torch.save(tensors, path / "pytorch_model.bin")
    return path
