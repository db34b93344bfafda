"""The Mixture-of-Experts FFN (viquae_torch/ops/moe.py) and the MoE BERT
against the JAX package (viquae_tpu/ops/moe.py, models/bert.py).

- Every single-device case of tests/test_moe.py, on the port (the three
  expert-sharding cases and the pipelined guard belong to the multi-GPU
  slice).
- ``moe_apply`` against the JAX function on the same weights:
  - bit for bit in f32 for top_k <= 2 where every product and sum is
    exact (integer-valued operands, relu): the port dispatches by slot
    index, the reference by one-hot products, and the two agree to the
    bit once the frameworks' own f32 summation orders cannot show;
  - on gaussian data, f32 within 2e-6 of the output's scale (the two
    frameworks sum the expert products in other orders), bf16 within one
    bf16 ulp of the scale (the reference's bf16 GELU rounds after each
    of its elementwise steps, torch's once); the routing and the aux
    loss equal.
- Capacity overflow, grouping and ``token_mask``; the MoE BERT padded and
  packed; round trips through ``convert``. Each trainee's loss with the
  aux against the JAX trainee's is in test_torch_moe_trainee.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainee import ict_batch, jtree, spread, tokenizer  # noqa
from viquae_torch.models import bert as tbert
from viquae_torch.models import convert
from viquae_torch.models import dpr as tdpr
from viquae_torch.models import layers as L
from viquae_torch.models import mm as tmm
from viquae_torch.models import qa as tqa
from viquae_torch.models import rr as trr
from viquae_torch.ops import moe
from viquae_torch.train import trainee as ttrainee
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.models import mm as jmm
from viquae_tpu.ops import moe as jmoe

torch.set_num_threads(2)

DIM, HID = 8, 16
F32_SCALE_TOL = 2e-6


def moe_params(n_experts, seed, dim=DIM, hid=HID, std=0.3):
    """Seeded port weights (router and kernels at ``std``, small random
    biases) and the same weights as the JAX tree."""
    p = L.seeded(moe.moe_init, dim, hid, n_experts, seed=seed, device="cpu")
    L.init_weights_(p, seed, linear_std=std)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed + 100)
        for name, t in p.named_parameters():
            if name.endswith("bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return p, jax.tree.map(jnp.asarray, convert.tree_from_module(p))


def set_router(p, kernel):
    """Both packages' router from one (D, E) kernel."""
    with torch.no_grad():
        p["router"].weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.asarray(kernel, np.float32).T)))
    return jax.tree.map(jnp.asarray, convert.tree_from_module(p))


def run(p, x, **kw):
    y, aux = moe.moe_apply(p, torch.as_tensor(np.asarray(x)), **kw)
    return y.detach().numpy(), float(aux)


def expert_ffn(p, e, x, act="gelu"):
    """Expert ``e`` as a plain two-layer FFN (L.mlp on its slices)."""
    mlp = L.mlp_init(p["in"].weight.shape[1], p["in"].weight.shape[2])
    with torch.no_grad():
        mlp["in"].weight.copy_(p["in"].weight[e].T)
        mlp["in"].bias.copy_(p["in"].bias[e])
        mlp["out"].weight.copy_(p["out"].weight[e].T)
        mlp["out"].bias.copy_(p["out"].bias[e])
    return L.mlp(mlp, torch.as_tensor(x), act).detach().numpy()


# ---------------------------------------------------------------------------
# the single-device cases of tests/test_moe.py, on the port
# ---------------------------------------------------------------------------
def test_single_expert_reduces_to_dense_ffn():
    p, _ = moe_params(1, 0)
    x = np.random.default_rng(0).standard_normal((4, 6, DIM)).astype(
        np.float32)
    y, aux = run(p, x, top_k=1)
    np.testing.assert_allclose(y, expert_ffn(p, 0, x), rtol=1e-5, atol=1e-6)
    assert aux == pytest.approx(1.0, rel=1e-6)


def test_routing_follows_router_argmax():
    n_exp, t = 4, 8
    p, _ = moe_params(n_exp, 1)
    router = np.zeros((DIM, n_exp), np.float32)
    router[:4, :] = 50.0 * np.eye(4, dtype=np.float32)
    set_router(p, router)
    x = np.zeros((t, DIM), np.float32)
    for i in range(t):
        x[i, i % 4] = 1.0
    y, _ = run(p, x, top_k=1, capacity_factor=4.0)
    for i in range(t):
        np.testing.assert_allclose(y[i:i + 1], expert_ffn(p, i % 4,
                                                          x[i:i + 1]),
                                   rtol=1e-5, atol=1e-6)


def test_capacity_overflow_drops_tokens():
    p, _ = moe_params(2, 2)
    router = np.zeros((DIM, 2), np.float32)
    router[:, 0] = 10.0
    set_router(p, router)
    x = np.abs(np.random.default_rng(3).standard_normal((8, DIM))).astype(
        np.float32) + 0.1
    y, _ = run(p, x, top_k=1, capacity_factor=0.5)  # C = 2
    np.testing.assert_array_equal(y[2:], np.zeros_like(y[2:]))
    assert np.abs(y[:2]).sum() > 0


def test_top2_gates_renormalize():
    p, _ = moe_params(3, 4)
    x = np.random.default_rng(5).standard_normal((6, DIM)).astype(np.float32)
    y, _ = run(p, x, top_k=2, capacity_factor=4.0)
    probs = torch.softmax(torch.from_numpy(x) @ p["router"].weight.T, -1)
    gv, gi = torch.topk(probs, 2)
    gv = (gv / gv.sum(-1, keepdim=True)).detach().numpy()
    ref = np.zeros((6, DIM), np.float32)
    for i in range(6):
        for j in range(2):
            ref[i] += gv[i, j] * expert_ffn(p, int(gi[i, j]), x[i:i + 1])[0]
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)


def test_aux_loss_balance():
    p, _ = moe_params(4, 6)
    set_router(p, np.zeros((DIM, 4), np.float32))
    x = np.abs(np.random.default_rng(7).standard_normal((16, DIM))).astype(
        np.float32) + 0.1
    _, aux_uniform = run(p, x, top_k=1)
    assert aux_uniform == pytest.approx(1.0, rel=1e-5)
    collapsed = np.zeros((DIM, 4), np.float32)
    collapsed[:, 2] = 25.0
    set_router(p, collapsed)
    _, aux_collapsed = run(p, x, top_k=1)
    assert aux_collapsed > 3.5


def test_bf16_compute_dtype_runs():
    p, _ = moe_params(4, 10)
    x = np.random.default_rng(11).standard_normal((4, 4, DIM)).astype(
        np.float32)
    y, aux = run(p, x, compute_dtype=torch.bfloat16)
    assert y.shape == x.shape and np.isfinite(y).all()
    assert np.isfinite(aux)


def test_grouped_matches_ungrouped_when_capacity_ample():
    p, _ = moe_params(4, 11)
    rng = np.random.default_rng(12)
    for t in (32, 37):  # 37: group padding stays inert
        x = rng.standard_normal((t, DIM)).astype(np.float32)
        y1, aux1 = run(p, x, top_k=2, capacity_factor=8.0, group_size=t + 1)
        yg, auxg = run(p, x, top_k=2, capacity_factor=8.0, group_size=8)
        np.testing.assert_allclose(yg, y1, rtol=1e-5, atol=1e-6)
        assert auxg == pytest.approx(aux1, rel=1e-6)


def test_grouped_capacity_is_per_group():
    p, _ = moe_params(2, 13)
    router = np.zeros((DIM, 2), np.float32)
    router[:, 0] = 10.0
    set_router(p, router)
    x = np.abs(np.random.default_rng(14).standard_normal((8, DIM))).astype(
        np.float32) + 0.1
    y, _ = run(p, x, top_k=1, capacity_factor=0.5, group_size=4)
    assert [i for i in range(8) if np.abs(y[i]).sum() > 0] == [0, 4]


def test_token_mask_excludes_padding_from_capacity():
    p, _ = moe_params(2, 17)
    router = np.zeros((DIM, 2), np.float32)
    router[:, 0] = 10.0
    set_router(p, router)
    x = np.abs(np.random.default_rng(18).standard_normal((8, DIM))).astype(
        np.float32) + 0.1
    mask = torch.tensor([1, 0, 1, 0, 1, 0, 1, 0])
    y, aux = run(p, x, top_k=1, capacity_factor=0.5, token_mask=mask)
    assert [i for i in range(8) if np.abs(y[i]).sum() > 0] == [0, 2]
    assert np.isfinite(aux) and aux > 1.0


def _moe_cfg(pkg=tbert, **kw):
    return pkg.BertConfig(
        vocab_size=61, hidden_size=16, num_hidden_layers=4,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32, add_pooler=False, **kw)


def bert_pair(seed, **kw):
    """A seeded port MoE BERT (weights at std 0.2, see test_torch_trainee)
    and its JAX tree; both configs built from ``kw``."""
    cfg, jcfg = _moe_cfg(**kw), _moe_cfg(jbert, **kw)
    params = spread(L.seeded(tbert.Bert, cfg, seed=seed, device="cpu",
                             truncated=True), seed)
    return params, cfg, jtree(params), jcfg


def test_moe_bert_layer_placement_and_aux():
    params, cfg, _, _ = bert_pair(0, moe_experts=4, moe_every=2)
    layers = params.layers
    assert "mlp" in layers[0] and "moe" in layers[1]
    assert "mlp" in layers[2] and "moe" in layers[3]
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 61, (4, 10)))
    out = tbert.apply(params, cfg, ids)
    assert tuple(out["last_hidden_state"].shape) == (4, 10, 16)
    assert torch.isfinite(out["moe_aux"]) and float(out["moe_aux"]) > 0


def test_moe_bert_single_expert_equals_dense():
    params, cfg, _, _ = bert_pair(1, moe_experts=1, moe_top_k=1)
    dense = L.seeded(tbert.Bert, _moe_cfg(), seed=1, device="cpu")
    with torch.no_grad():
        sd = {k: v for k, v in params.state_dict().items() if ".moe." not in k}
        for i, layer in enumerate(params.layers):
            sd[f"layers.{i}.mlp.in.weight"] = layer["moe"]["in"].weight[0].T
            sd[f"layers.{i}.mlp.in.bias"] = layer["moe"]["in"].bias[0]
            sd[f"layers.{i}.mlp.out.weight"] = layer["moe"]["out"].weight[0].T
            sd[f"layers.{i}.mlp.out.bias"] = layer["moe"]["out"].bias[0]
        dense.load_state_dict(sd)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 61, (3, 8)))
    torch.testing.assert_close(
        tbert.apply(params, cfg, ids)["last_hidden_state"],
        tbert.apply(dense, _moe_cfg(), ids)["last_hidden_state"],
        rtol=1e-5, atol=1e-6)


def test_moe_bert_training_requires_aux():
    params, cfg, _, _ = bert_pair(3, moe_experts=2)
    with pytest.raises(ValueError, match="return_moe_aux"):
        tbert.encode(params, cfg, torch.zeros((2, 6, 16)),
                     deterministic=False,
                     generator=torch.Generator().manual_seed(0))


def test_moe_bert_hf_port_guards():
    params, cfg, _, _ = bert_pair(4, moe_experts=2)
    with pytest.raises(ValueError, match="dense"):
        tbert.state_dict_from_hf({}, cfg)
    with pytest.raises(ValueError, match="exportable"):
        tbert.params_to_hf_state_dict(params, cfg)


def test_bert_moe_padding_is_inert():
    params, cfg, _, _ = bert_pair(19, moe_experts=4, moe_capacity_factor=4.0)
    l = 8
    ids = torch.from_numpy(np.random.default_rng(20).integers(0, 61, (2, l)))
    out = tbert.apply(params, cfg, ids, attention_mask=torch.ones((2, l)))
    out_pad = tbert.apply(
        params, cfg, torch.cat([ids, torch.zeros_like(ids)], 1),
        attention_mask=torch.cat([torch.ones((2, l)), torch.zeros((2, l))],
                                 1))
    torch.testing.assert_close(out_pad["last_hidden_state"][:, :l],
                               out["last_hidden_state"], rtol=1e-5,
                               atol=1e-5)


def _moe_dpr_pair(seed, **kw):
    cfg = tdpr.DPRConfig(bert=_moe_cfg(**kw))
    jcfg = jdpr.DPRConfig(bert=_moe_cfg(jbert, **kw))
    t = tdpr.DPREncoder(cfg=cfg, params=spread(
        tdpr.init(cfg, seed, device="cpu"), seed))
    return t, jdpr.DPREncoder(cfg=jcfg, params=jtree(t.params))


def _biencoder_batch(n=4, m=2, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "question_inputs": {
            "input_ids": torch.from_numpy(rng.integers(1, 61, (n, length))),
            "attention_mask": torch.ones((n, length), dtype=torch.int32)},
        "context_inputs": {
            "input_ids": torch.from_numpy(rng.integers(1, 61,
                                                       (n * m, length))),
            "attention_mask": torch.ones((n * m, length),
                                         dtype=torch.int32)},
        "labels": torch.arange(n) * m,
    }


def test_moe_biencoder_trainee_adds_aux_to_loss():
    (q, _), (c, _) = (_moe_dpr_pair(0, moe_experts=2,
                                    moe_capacity_factor=4.0),
                      _moe_dpr_pair(1, moe_experts=2,
                                    moe_capacity_factor=4.0))
    be = ttrainee.BiEncoderTrainee(q, c, moe_aux_weight=0.05)
    be0 = ttrainee.BiEncoderTrainee(q, c, moe_aux_weight=0.0)
    batch = _biencoder_batch()
    loss_w, out_w = be.loss_fn(be.params, batch, deterministic=True)
    loss_0, out_0 = be0.loss_fn(be0.params, batch, deterministic=True)
    assert "moe_aux" in out_w and "moe_aux" in out_0
    aux = float(out_w["moe_aux"])
    assert aux > 0.0
    assert float(loss_w) == pytest.approx(float(loss_0) + aux, rel=1e-6)
    params = be.params.requires_grad_(True)
    loss, _ = be.loss_fn(params, batch, torch.Generator().manual_seed(1),
                         deterministic=False)
    loss.backward()
    router = params["question"].layers[0]["moe"]["router"].weight
    assert float(router.grad.abs().max()) > 0.0


def test_moe_biencoder_dense_outputs_have_no_aux_key():
    (q, _), (c, _) = _moe_dpr_pair(0), _moe_dpr_pair(1)
    be = ttrainee.BiEncoderTrainee(q, c)
    loss, out = be.loss_fn(be.params, _biencoder_batch(), deterministic=True)
    assert "moe_aux" not in out and torch.isfinite(loss)


MM_KW = dict(n_faces=1, face_dim=6, bbox_dim=7,
             image_dims=(("clip", 8), ("imagenet", 9)))
MM_BERT = dict(vocab_size=120, hidden_size=16, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=32,
               max_position_embeddings=64, add_pooler=False)


def moe_mm_pair(kind, seed, **bert_kw):
    bert_kw = {**MM_BERT, "moe_experts": 2, "moe_capacity_factor": 8.0,
               **bert_kw}
    tcfg = tmm.MMConfig(bert=tbert.BertConfig(**bert_kw), **MM_KW)
    jcfg = jmm.MMConfig(bert=jbert.BertConfig(**bert_kw), **MM_KW)
    tcls, jcls = {"eca": (tmm.ECAEncoder, jmm.ECAEncoder),
                  "ilf": (tmm.IntermediateLinearFusion,
                          jmm.IntermediateLinearFusion)}[kind]
    t = tcls(cfg=tcfg, seed=seed, device="cpu")
    spread(t.params, seed)
    return t, jcls(cfg=jcfg, params=jtree(t.params))


def test_moe_eca_paths_surface_aux(tokenizer):
    """eca_apply carries moe_aux; eca_apply_packed returns it with
    return_aux; packed == padded embeddings with ample capacity; both
    equal the JAX paths."""
    from viquae_torch.core.device import upload_batch

    t, j = moe_mm_pair("eca", 3)
    batch = ict_batch(tokenizer, packed=False)["question_inputs"]
    tb = upload_batch(batch, torch.device("cpu"))
    out = tmm.eca_apply(t.params, t.cfg, tb["text_inputs"],
                        tb["face_inputs"], tb["image_inputs"])
    ref = jmm.eca_apply(j.params, j.cfg, batch["text_inputs"],
                        batch["face_inputs"], batch["image_inputs"])
    assert out.moe_aux is not None and float(out.moe_aux) > 0.0
    np.testing.assert_allclose(out.pooler_output.detach().numpy(),
                               np.asarray(ref.pooler_output),
                               rtol=1e-4, atol=1e-5)
    assert float(out.moe_aux) == pytest.approx(float(ref.moe_aux), rel=1e-5)
    packed = ict_batch(tokenizer, packed=True)["question_inputs"]
    text = upload_batch(packed, torch.device("cpu"))["text_inputs"]
    cls, aux = tmm.eca_apply_packed(
        t.params, t.cfg, text["canvas_input_ids"], text["canvas_segment_ids"],
        text["canvas_position_ids"], text["canvas_cls_rows"],
        text["canvas_cls_cols"], text["canvas_vis_rows"],
        text["canvas_vis_cols"], tb["face_inputs"], tb["image_inputs"],
        return_aux=True)
    assert aux is not None and float(aux) > 0.0
    n = out.pooler_output.shape[0]
    torch.testing.assert_close(cls[:n], out.pooler_output, rtol=2e-5,
                               atol=2e-5)


def test_moe_reader_aux_in_trainee_loss():
    cfg = tqa.ReaderConfig(bert=_moe_cfg(moe_experts=2,
                                         moe_capacity_factor=4.0))
    params = tqa.init(cfg, 7, device="cpu")
    rng = np.random.default_rng(7)
    nm, length, a = 4, 10, 2
    out = tqa.reader_apply(
        params, cfg, torch.from_numpy(rng.integers(1, 61, (nm, length))),
        attention_mask=torch.ones((nm, length)),
        start_positions=torch.from_numpy(rng.integers(0, length, (nm, a))),
        end_positions=torch.from_numpy(rng.integers(0, length, (nm, a))),
        answer_mask=torch.ones((nm, a)), m_passages=2)
    assert out.moe_aux is not None and float(out.moe_aux) > 0.0
    assert torch.isfinite(out.loss)


# ---------------------------------------------------------------------------
# moe_apply against the JAX function on the same weights
# ---------------------------------------------------------------------------
def _integer_case(n_experts, seed, t=40):
    """Integer-valued tokens and experts (every product and sum exact in
    f32) and a router whose columns come in equal pairs: each token's top
    two experts tie, are taken lowest index first, and gate 0.5 each."""
    rng = np.random.default_rng(seed)
    p, _ = moe_params(n_experts, seed)
    with torch.no_grad():
        for name, w in p.named_parameters():
            w.copy_(torch.from_numpy(rng.integers(
                -2, 3, tuple(w.shape)).astype(np.float32)))
    pairs = rng.integers(-2, 3, (DIM, n_experts // 2)).astype(np.float32)
    jtree_ = set_router(p, np.repeat(pairs, 2, axis=1))
    x = rng.integers(-3, 4, (t, DIM)).astype(np.float32)
    mask = (rng.random(t) < 0.85).astype(np.int32)
    return p, jtree_, x, mask


@pytest.mark.parametrize("top_k,cf,group", [
    (1, 1.25, 1024), (2, 1.25, 1024), (2, 0.5, 16), (2, 1.0, 7),
    (1, 0.25, 10)])
def test_moe_apply_is_bitwise_jax_for_top_k_le_2(top_k, cf, group):
    p, jt, x, mask = _integer_case(4, 21 + top_k, t=43)
    y, aux = run(p, x, top_k=top_k, capacity_factor=cf, group_size=group,
                 act="relu", token_mask=torch.from_numpy(mask))
    yj, auxj = jmoe.moe_apply(jt, jnp.asarray(x), top_k=top_k,
                              capacity_factor=cf, group_size=group,
                              act="relu", token_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(y, np.asarray(yj))
    assert aux == pytest.approx(float(auxj), rel=1e-6)
    # the construction keeps some drops under tight capacity
    if cf < 1.0:
        assert (np.abs(y).sum(1) == 0).sum() > (mask == 0).sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k,cf,group", [
    (1, 1.25, 1024), (2, 1.25, 16), (2, 0.5, 32), (3, 1.0, 50)])
def test_moe_apply_matches_jax_on_gaussian_data(dtype, top_k, cf, group):
    p, jt = moe_params(4, 30, dim=16, hid=32)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((3, 37, 16)).astype(np.float32)
    mask = (rng.random((3, 37)) < 0.8).astype(np.int32)
    kw = dict(top_k=top_k, capacity_factor=cf, group_size=group)
    y, aux = run(p, x, compute_dtype=getattr(torch, dtype),
                 token_mask=torch.from_numpy(mask), **kw)
    yj, auxj = jmoe.moe_apply(jt, jnp.asarray(x),
                              compute_dtype=getattr(jnp, dtype),
                              token_mask=jnp.asarray(mask), **kw)
    yj = np.asarray(yj, np.float32)
    scale = np.abs(yj).max()
    # routing equal: the same tokens are dropped (all-zero rows)
    np.testing.assert_array_equal(np.abs(y).sum(-1) == 0,
                                  np.abs(yj).sum(-1) == 0)
    if dtype == "float32":
        tol = F32_SCALE_TOL * scale
    else:   # one bf16 ulp of the output's scale
        tol = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert np.abs(y - yj).max() <= tol, (np.abs(y - yj).max(), tol)
    assert aux == pytest.approx(float(auxj), rel=1e-6)


def test_router_ties_go_to_the_lower_expert():
    """Equal router probabilities (a zero router): every token takes
    experts 0 and 1 in that order, in both packages."""
    p, _ = moe_params(4, 40)
    jt = set_router(p, np.zeros((DIM, 4), np.float32))
    x = np.random.default_rng(41).standard_normal((12, DIM)).astype(
        np.float32)
    y, _ = run(p, x, top_k=2, capacity_factor=4.0)
    yj, _ = jmoe.moe_apply(jt, jnp.asarray(x), top_k=2, capacity_factor=4.0)
    ref = 0.5 * expert_ffn(p, 0, x) + 0.5 * expert_ffn(p, 1, x)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y, np.asarray(yj), rtol=1e-5, atol=1e-6)


def test_moe_apply_gradients_match_jax():
    p, jt = moe_params(4, 50)
    x = np.random.default_rng(51).standard_normal((24, DIM)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    p.requires_grad_(True)
    y, aux = moe.moe_apply(p, xt, top_k=2, capacity_factor=1.0,
                           group_size=8)
    (torch.mean(y ** 2) + 0.01 * aux).backward()

    def loss(params):
        y_, aux_ = jmoe.moe_apply(params, jnp.asarray(x), top_k=2,
                                  capacity_factor=1.0, group_size=8)
        return jnp.mean(y_ ** 2) + 0.01 * aux_

    g = jax.grad(loss)(jt)
    got = {
        "router": p["router"].weight.grad.T, "in_k": p["in"].weight.grad,
        "in_b": p["in"].bias.grad, "out_k": p["out"].weight.grad,
        "out_b": p["out"].bias.grad}
    ref = {"router": g["router"]["kernel"], "in_k": g["in"]["kernel"],
           "in_b": g["in"]["bias"], "out_k": g["out"]["kernel"],
           "out_b": g["out"]["bias"]}
    for name in ref:
        r = np.asarray(ref[name])
        np.testing.assert_allclose(got[name].numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the MoE BERT against the JAX BERT; convert round trips
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_bert_padded_and_packed_match_jax(dtype):
    from viquae_torch.ops import packing

    params, cfg, jp, jcfg = bert_pair(60, moe_experts=4, moe_every=2,
                                      moe_group_size=16)
    rng = np.random.default_rng(61)
    lens = [9, 4, 12, 7, 3]
    ids = np.zeros((5, 12), np.int32)
    mask = np.zeros((5, 12), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, 61, n)
        mask[i, :n] = 1
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    out = tbert.apply(params, cfg, torch.from_numpy(ids),
                      torch.from_numpy(mask), compute_dtype=td)
    ref = jbert.apply(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                      compute_dtype=jd)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=3e-2, atol=3e-2)
    real = mask.astype(bool)
    np.testing.assert_allclose(out["last_hidden_state"].numpy()[real],
                               np.asarray(ref["last_hidden_state"])[real],
                               **tol)
    assert float(out["moe_aux"]) == pytest.approx(float(ref["moe_aux"]),
                                                  rel=1e-4)
    canvas = packing.pack_token_sequences(
        [ids[i, :n] for i, n in enumerate(lens)], row_len=16)
    args = [torch.from_numpy(np.asarray(getattr(canvas, k))) for k in
            ("input_ids", "segment_ids", "position_ids")]
    pout = tbert.apply(params, cfg, args[0], position_ids=args[2],
                       segment_ids=args[1], compute_dtype=td)
    pref = jbert.apply(jp, jcfg, jnp.asarray(canvas.input_ids),
                       position_ids=jnp.asarray(canvas.position_ids),
                       segment_ids=jnp.asarray(canvas.segment_ids),
                       compute_dtype=jd)
    seg = np.asarray(canvas.segment_ids) > 0
    np.testing.assert_allclose(pout["last_hidden_state"].numpy()[seg],
                               np.asarray(pref["last_hidden_state"])[seg],
                               **tol)
    assert float(pout["moe_aux"]) == pytest.approx(float(pref["moe_aux"]),
                                                   rel=1e-4)


def test_moe_jax_tree_round_trips_through_the_port():
    """A JAX MoE BERT tree -> convert.params_from_jax -> tree_from_module
    gives the tree back; module_from_tree carries an ECA tree with MoE
    layers; init_tree draws the MoE layout."""
    jcfg = _moe_cfg(jbert, moe_experts=3, moe_every=2)
    tcfg = _moe_cfg(moe_experts=3, moe_every=2)
    tree = jax.tree.map(np.asarray, jbert.init(jax.random.key(0), jcfg))
    module = convert.params_from_jax(tree, tcfg, device="cpu")
    back = convert.tree_from_module(module)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf)
    drawn = convert.init_tree(tcfg, seed=1)
    assert jax.tree_util.tree_structure(drawn) == \
        jax.tree_util.tree_structure(tree)
    t, j = moe_mm_pair("eca", 2, num_hidden_layers=2, moe_every=2)
    again = convert.module_from_tree(tmm.ECA, t.cfg,
                                     tree=convert.tree_from_module(t.params),
                                     device="cpu")
    for a, b in zip(again.state_dict().values(),
                    t.params.state_dict().values()):
        assert torch.equal(a, b)


def test_moe_decay_mask_matches_jax_paths():
    """Expert kernels and the router decay, expert biases do not, by the
    JAX package's regex on the JAX paths."""
    from viquae_torch.train.optim import decay_mask

    params, _, _, _ = bert_pair(5, moe_experts=2)
    mask = decay_mask(params)
    assert mask["layers.0.moe.in.weight"]
    assert mask["layers.0.moe.router.weight"]
    assert not mask["layers.0.moe.in.bias"]
    assert not mask["layers.0.moe.out.bias"]


def test_moe_eca_reader_and_rerankers_carry_aux():
    """The ECA reader and the ECA re-ranker report their BERT's MoE term
    (JAX qa.py:303, rr.py:86); Flamant refuses a MoE BERT, as in JAX."""
    t, _ = moe_mm_pair("eca", 4)
    cfg = t.cfg
    reader = tqa.eca_reader_init(cfg, 4, device="cpu")
    reranker = trr.eca_reranker_init(cfg, 4, device="cpu")
    rng = np.random.default_rng(4)
    n, length = 4, 10
    text = {"input_ids": torch.from_numpy(rng.integers(1, 100, (n, length))),
            "attention_mask": torch.ones((n, length), dtype=torch.long)}
    face = {"face": torch.randn(n, 1, 1, 6), "bbox": torch.randn(n, 1, 1, 7),
            "attention_mask": torch.ones((n, 1, 1), dtype=torch.long)}
    image = {"clip": {"input": torch.randn(n, 1, 8),
                      "attention_mask": torch.ones((n, 1))},
             "imagenet": {"input": torch.randn(n, 1, 9),
                          "attention_mask": torch.ones((n, 1))}}
    out = trr.eca_reranker_apply(reranker, cfg, text, face, image)
    assert out.moe_aux is not None and float(out.moe_aux) > 0
    rout = tqa.eca_reader_apply(reader, cfg, text, face, image,
                                m_passages=2)
    assert rout.moe_aux is not None and float(rout.moe_aux) > 0
    fcfg = tmm.FlamantConfig(bert=cfg.bert, **MM_KW)
    flamant = trr.flamant_reranker_init(
        tmm.FlamantConfig(bert=tbert.BertConfig(**MM_BERT), **MM_KW), 0,
        device="cpu")
    with pytest.raises(NotImplementedError, match="moe_experts"):
        trr.flamant_reranker_apply(flamant, fcfg, text, face, image)
