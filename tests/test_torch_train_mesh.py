"""Tensor and sequence parallelism of the port (viquae_torch/models/
{layers,bert,sharding}.py, ops/moe.py's spec, core/mesh.py's training
collectives) against the JAX package's specs and sharded encoders.

In process: every ``param_spec`` names, for every parameter, the dimension
the JAX spec names after the kernel transposition of ``models.convert``;
sharding a module converted from JAX params and putting its shards back
together gives the converted module bit for bit; a model axis that does not
divide the heads or the units is refused; the mesh's dropout folds the
right coordinates.

On a gloo world of 4 processes (data = 2 x model = 2,
tests/torch_dist_helpers.py): the tensor-parallel encoder (the rows split
over data) equals the JAX encoder under the JAX ``param_spec`` on a JAX
mesh of the same shape (atol 1e-5, as tests/test_bert.py holds JAX's);
the sequence-parallel seam, with replicated and with split weights, equals
the unconstrained encoder at rtol = atol = 2e-5 (tests/test_bert.py::
test_sequence_sharding_seam, tests/test_collective_layout.py:130-170), and
its collective log shows L split over ``model`` (a gather of each layer's
L slices before attention and the MLP, a reduce-scatter after); the
gradients through the tensor- and sequence-parallel encoder equal one
device's (1e-4 of each leaf's largest entry; the attention key bias, whose
true gradient is 0, is rounding noise on both sides and is held to 1e-4 of
the whole gradient's largest entry); and each layer makes two ``model``
all-reduces forward.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dist_helpers as tdh
import torch_train_helpers as tth
from viquae_torch import parallel
from viquae_torch.core import mesh
from viquae_torch.models import bert as tbert
from viquae_torch.models import dpr as tdpr
from viquae_torch.models import layers as tlayers
from viquae_torch.models import ner as tner
from viquae_torch.models import qa as tqa
from viquae_torch.models import sharding
from viquae_torch.models.convert import (jax_paths, params_from_jax,
                                         torch_partition, tree_from_module)
from viquae_torch.ops import moe as tmoe
from viquae_tpu.core import mesh as jmesh
from viquae_tpu.models import bert as jbert
from viquae_tpu.models import dpr as jdpr
from viquae_tpu.models import ner as jner
from viquae_tpu.models import qa as jqa

torch.set_num_threads(2)

ENC = {**tth.TINY, "vocab_size": 99}


def fake_mesh(**coords_and_sizes):
    """A MeshContext with the given sizes and coordinates and no process
    group: enough for the shard rule and the dropout folds."""
    sizes = {a: 1 for a in mesh.AXES}
    coords = {a: 0 for a in mesh.AXES}
    for axis, (coord, size) in coords_and_sizes.items():
        sizes[axis], coords[axis] = size, coord
    return mesh.MeshContext(sizes, coords)


def jspec_leaves(spec):
    """{JAX path: partition tuple} of a JAX PartitionSpec tree."""
    from jax.sharding import PartitionSpec as P

    leaves = jax.tree_util.tree_flatten_with_path(
        spec, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(leaf) for path, leaf in leaves}


@pytest.mark.parametrize("model", ["dpr", "dpr_moe", "reader_fused", "ner"])
def test_param_spec_names_the_references_dimension(model):
    """For every parameter, the port's (dim, axis) is the JAX spec's
    sharded dimension mapped through the kernel transposition (a dense
    kernel's shard_out is the nn.Linear weight's dim 0), None exactly where
    JAX replicates; the attention's split keeps whole heads."""
    moe = dict(moe_experts=4, moe_every=2) if model == "dpr_moe" else {}
    tcfg_b, jcfg_b = (tbert.BertConfig(**ENC, **moe),
                      jbert.BertConfig(**ENC, **moe))
    if model.startswith("dpr"):
        tcfg, jcfg = tdpr.DPRConfig(bert=tcfg_b), jdpr.DPRConfig(bert=jcfg_b)
        module = tdpr.init(tcfg, 0, device="cpu")
        tspec, jspec = tdpr.param_spec(tcfg), jdpr.param_spec(jcfg)
    elif model == "reader_fused":
        tcfg = tqa.ReaderConfig(bert=tcfg_b, fuse_ir_score=True)
        jcfg = jqa.ReaderConfig(bert=jcfg_b, fuse_ir_score=True)
        module = tqa.init(tcfg, 0, device="cpu")
        tspec, jspec = tqa.param_spec(tcfg), jqa.param_spec(jcfg)
    else:
        tcfg = tner.NERConfig(bert=tcfg_b, num_labels=5)
        jcfg = jner.NERConfig(bert=jcfg_b, num_labels=5)
        module = tner.init(tcfg, 0, device="cpu")
        tspec, jspec = tner.param_spec(tcfg), jner.param_spec(jcfg)
    got = sharding.flatten_spec(tspec)
    ref = jspec_leaves(jspec)
    paths = jax_paths(module)
    shapes = {n: p.dim() for n, p in module.named_parameters()}
    assert sorted(got) == sorted(paths)
    assert sorted(paths.values()) == sorted(ref)
    split = 0
    for name, path in paths.items():
        kernel = path.endswith("kernel")
        want = torch_partition(ref[path], shapes[name], kernel=kernel)
        entry = got[name]
        assert (entry and entry[:2]) == want, (name, path, entry, ref[path])
        split += want is not None
        if ".attention." in name and entry is not None:
            assert entry[2] == ENC["num_attention_heads"], name
    assert split > 0


def test_shard_then_gather_is_the_converted_module_bit_for_bit():
    """convert(JAX params) -> every rank's shard -> put back together
    equals convert(JAX params) bit for bit; names and module types do not
    change (AdamW's masks match); an axis of one splits nothing."""
    cfg = tbert.BertConfig(**ENC, moe_experts=4, moe_every=2)
    jcfg = jbert.BertConfig(**ENC, moe_experts=4, moe_every=2)
    tree = jax.tree.map(np.asarray, jbert.init(jax.random.key(0), jcfg))
    full = params_from_jax(tree, cfg, device="cpu")
    spec = tbert.param_spec(cfg)
    shards = [sharding.shard_module(full, spec, fake_mesh(model=(r, 2)))
              for r in range(2)]
    split = sharding.sharded_parameters(shards[0])
    assert set(split) == {n for n, e in sharding.flatten_spec(spec).items()
                          if e is not None}
    named = [dict(s.named_parameters()) for s in shards]
    for name, p in full.named_parameters():
        assert list(named[0]) == list(dict(full.named_parameters()))
        if name in split:
            dim = split[name][0]
            back = torch.cat([n[name] for n in named], dim=dim)
            assert named[0][name].shape[dim] * 2 == p.shape[dim]
        else:
            back = named[1][name]
        assert torch.equal(back, p), name
    one = sharding.shard_module(full, spec, fake_mesh(model=(0, 1)))
    assert not sharding.sharded_parameters(one)
    assert tree_from_module(one).keys() == tree.keys()


def test_a_model_axis_must_divide_heads_and_units():
    cfg = tbert.BertConfig(**ENC)
    full = tbert.Bert(cfg)
    with pytest.raises(ValueError, match="4 heads"):
        sharding.shard_module(full, tbert.param_spec(cfg),
                              fake_mesh(model=(0, 3)))
    with pytest.raises(ValueError, match="names no parameter"):
        sharding.shard_module(full, {"nope": None}, fake_mesh(model=(0, 2)))


def test_mesh_dropout_folds_data_and_split_axes():
    """Dropout on the mesh: the data coordinate changes the mask (the rows
    differ), the model coordinate changes it only where the activation is
    split over model (heads, a sequence slice); the same coordinates give
    the same mask, and a world of one keeps the plain mask."""
    x = torch.ones(64, 32)

    def mask(data, model, axes):
        with mesh.use(fake_mesh(data=(data, 2), model=(model, 2))):
            return tlayers.dropout(x, 0.3, 1234, axes) == 0

    plain = tlayers.dropout(x, 0.3, 1234) == 0
    rows = mesh.DATA_AXIS,
    both = mesh.DATA_AXIS, mesh.MODEL_AXIS
    assert torch.equal(mask(0, 0, rows), mask(0, 1, rows))
    assert not torch.equal(mask(0, 0, rows), mask(1, 0, rows))
    assert not torch.equal(mask(0, 0, both), mask(0, 1, both))
    assert torch.equal(mask(1, 1, both), mask(1, 1, both))
    assert not torch.equal(mask(0, 0, rows), plain)
    with mesh.use(fake_mesh()):
        assert torch.equal(tlayers.dropout(x, 0.3, 1234) == 0, plain)
    assert 0.2 < float(plain.float().mean()) < 0.4


def test_whole_view_holds_an_axis_whole():
    """core.mesh.whole: the axis reads size 1 and coordinate 0, its
    collectives are identities, the other axes and the collective log are
    the mesh's; the dropout mask of rows under it is one device's."""
    ctx = fake_mesh(data=(1, 2), model=(1, 2))
    view = mesh.whole(ctx, mesh.DATA_AXIS)
    assert (view.size(mesh.DATA_AXIS), view.coordinate(mesh.DATA_AXIS),
            view.data_size) == (1, 0, 1)
    assert (view.size(mesh.MODEL_AXIS), view.coordinate(mesh.MODEL_AXIS)) \
        == (2, 1)
    assert view.collective_log is ctx.collective_log
    assert view.group(mesh.DATA_AXIS) is None
    x = torch.ones(64, 32)
    with mesh.use(view):
        masked = tlayers.dropout(x, 0.3, 99)
    assert torch.equal(masked, tlayers.dropout(x, 0.3, 99))


def moe_case(seed=25):
    """A 4-expert MoE FFN (D 8, H 16) drawn by the port, its JAX tree, and
    32 gaussian tokens (4 x 8, the last two of row 1 padding). At seed 25
    the router sends more than a capacity of 1.25 to an expert of a group
    of 8: choices drop."""
    import jax.numpy as jnp

    p = tlayers.seeded(tmoe.moe_init, 8, 16, 4, seed=seed, device="cpu")
    tlayers.init_weights_(p, seed, linear_std=0.3)
    tree = jax.tree.map(jnp.asarray, tree_from_module(p))
    x = np.random.default_rng(seed + 1).standard_normal(
        (4, 8, 8)).astype(np.float32)
    mask = np.ones((4, 8), bool)
    mask[1, 6:] = False
    return p, tree, x, mask


def moe_on_ranks(p, x, mask, grad=True, **kw):
    """moe_apply on each half of the rows, as the two ranks of a data = 2
    mesh compute them (the call marked as each rank's block of the batch's
    4 rows, ``core.mesh.row_block``), side by side; with or without
    gradients."""
    out = []
    for r in (0, 1):
        with mesh.use(mesh.row_block(fake_mesh(data=(r, 2)), len(x))), \
                torch.set_grad_enabled(grad):
            y, _ = tmoe.moe_apply(p, torch.from_numpy(x[2 * r: 2 * r + 2]),
                                  token_mask=torch.from_numpy(
                                      mask[2 * r: 2 * r + 2]), **kw)
        out.append(y.detach().numpy())
    return np.concatenate(out)


@pytest.mark.parametrize("kw", [
    dict(top_k=2, capacity_factor=1.25, group_size=8),     # drops
    dict(top_k=2, capacity_factor=2.0, group_size=12),     # none can drop
], ids=["whole_groups_with_drops", "split_groups_without_drops"])
def test_moe_groups_are_the_global_batchs_on_split_rows(kw):
    """ops/moe.py while training on rows split over data: the groups, their
    length and the capacity are the global batch's, so the two ranks'
    outputs side by side equal one device's and the JAX moe_apply's on the
    whole batch (f32 within 2e-6 of the output's scale, as
    tests/test_torch_moe.py holds the two packages) — with drops where
    each rank's tokens are whole groups (the drops are real: capacity 8
    gives another output), and where a group straddles the ranks but no
    choice can drop."""
    from viquae_tpu.ops import moe as jmoe

    p, tree, x, mask = moe_case()
    got = moe_on_ranks(p, x, mask, **kw)
    one = tmoe.moe_apply(p, torch.from_numpy(x),
                         token_mask=torch.from_numpy(mask), **kw)[0]
    ref = np.asarray(jmoe.moe_apply(tree, x, token_mask=mask, **kw)[0])
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, one.detach().numpy(), rtol=0,
                               atol=2e-6 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)
    if kw["capacity_factor"] < 2:
        ample = tmoe.moe_apply(p, torch.from_numpy(x),
                               token_mask=torch.from_numpy(mask),
                               **dict(kw, capacity_factor=8.0))[0]
        assert not np.allclose(ample.detach().numpy(), ref,
                               atol=2e-6 * scale)


def test_moe_refuses_straddling_groups_that_can_drop():
    """A group of the global batch that straddles two ranks' tokens (16
    tokens a rank, groups of 11), at a capacity that can drop a choice:
    each rank would drop other choices than one device, so the call
    raises, with gradients and without (evaluation and serving split rows
    too); a call that no row split marks groups the tokens it is given."""
    p, _, x, mask = moe_case()
    kw = dict(top_k=2, capacity_factor=1.25, group_size=12)
    for grad in (True, False):
        with pytest.raises(ValueError, match="not whole groups"):
            moe_on_ranks(p, x, mask, grad=grad, **kw)
    with mesh.use(fake_mesh(data=(0, 2))), torch.no_grad():
        y, _ = tmoe.moe_apply(p, torch.from_numpy(x[:2]), **kw)
    assert y.shape == (2, 8, 8)


def test_parallel_reexports_the_training_surface():
    for name in ("copy_to", "reduce_from", "gather_from", "scatter_to",
                 "gather_to", "reduce_scatter_to", "all_reduce",
                 "reduce_scatter", "shard_module", "gather_module",
                 "param_spec", "moe_spec", "dense_spec", "mha_spec",
                 "mlp_spec", "layer_norm_spec"):
        assert hasattr(parallel, name), name
    assert "pipeline" in parallel.__doc__
    assert tmoe.moe_spec()["in"]["weight"] == (0, mesh.MODEL_AXIS)


# ---- the gloo world ---------------------------------------------------------
@pytest.fixture(scope="module")
def encoder_world(tmp_path_factory):
    """The encoder program on 4 gloo ranks, the JAX tree and inputs, and
    the JAX references: the encoder replicated, under its param_spec on a
    data = 2 x model = 2 JAX mesh, and with the sequence seam."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    jcfg = jbert.BertConfig(**ENC)
    jparams = jbert.init(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 99, (4, 16)).astype(np.int64)
    mask = np.ones((4, 16), np.int64)
    mask[:, 13:] = 0
    res = tdh.run_world("encoder", 4, tmp_path_factory.mktemp("enc"),
                        tree=tree, ids=ids, mask=mask, timeout=120)
    ref = np.asarray(jbert.apply(jparams, jcfg, jnp.asarray(ids),
                                 jnp.asarray(mask))["last_hidden_state"])
    ctx = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    spec = jbert.param_spec(jcfg)
    placed = jax.tree_util.tree_map(
        lambda p, s: jax.device_put(p, ctx.sharding(*s)), jparams, spec,
        is_leaf=lambda x: isinstance(x, P))
    with jmesh.use(ctx):
        tp = np.asarray(jax.jit(lambda p, i, m: jbert.apply(
            p, jcfg, i, m)["last_hidden_state"])(placed, jnp.asarray(ids),
                                                 jnp.asarray(mask)))
        seam = NamedSharding(ctx.mesh, P("data", "model", None))
        sp = np.asarray(jax.jit(lambda p, i, m: jbert.apply(
            p, jcfg, i, m, activation_sharding=seam)["last_hidden_state"])(
                jparams, jnp.asarray(ids), jnp.asarray(mask)))
    return {"ranks": res, "tree": tree, "ids": ids, "mask": mask,
            "ref": ref, "jax_tp": tp, "jax_sp": sp}


def test_tensor_parallel_forward(encoder_world):
    """tests/test_bert.py::test_tensor_parallel_forward at data = 2 x
    model = 2: the port's sharded encoder equals JAX's sharded encoder and
    the replicated one (atol 1e-5) on every rank."""
    for r in encoder_world["ranks"]:
        np.testing.assert_allclose(r["tp"], encoder_world["jax_tp"],
                                   atol=1e-5)
        np.testing.assert_allclose(r["tp"], encoder_world["ref"], atol=1e-5)


def test_sequence_sharding_seam(encoder_world):
    """The seam equals the unconstrained encoder (and JAX's seam) at
    rtol = atol = 2e-5, with replicated and with split weights."""
    for r in encoder_world["ranks"]:
        for name in ("sp", "sp_tp"):
            np.testing.assert_allclose(r[name], encoder_world["ref"],
                                       rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(r[name], encoder_world["jax_sp"],
                                       rtol=2e-5, atol=2e-5)


def test_sequence_parallel_splits_l_in_the_collective_log(encoder_world):
    """tests/test_collective_layout.py:130-170 on the port: the seam
    really splits L. Per layer, the whole sequence is gathered from the
    model ranks' L slices twice (before attention and the MLP) and, with
    split weights, two reduce-scatters return the slices; the encoder's
    output is gathered once more. Each gather moves the whole (B/data, L,
    D) f32 activation; the tensor-parallel run instead makes two model
    all-reduces of that size a layer and gathers nothing over model."""
    ids = encoder_world["ids"]
    whole = (len(ids) // 2) * ids.shape[1] * ENC["hidden_size"] * 4
    layers = ENC["num_hidden_layers"]
    for r in encoder_world["ranks"]:
        sp = tth.log_by_kind(r["sp_tp_log"])
        assert sp["all_gather/model"] == [whole] * (2 * layers + 1)
        assert sp["reduce_scatter/model"] == [whole] * (2 * layers)
        assert "all_reduce/model" not in sp
        rep = tth.log_by_kind(r["sp_log"])
        assert rep["all_gather/model"] == [whole] * (2 * layers + 1)
        tp = tth.log_by_kind(r["tp_log"])
        assert tp["all_reduce/model"] == [whole] * (2 * layers)
        assert "all_gather/model" not in tp


def test_tensor_and_sequence_parallel_gradients_equal_one_device(
        encoder_world):
    """The gradients of sum(w * h^2) through the sharded encoder, with and
    without the seam (summed over data, gathered over model), equal one
    device's: the LayerNorm and bias gradients of an L slice are summed
    over the slices, the replicated ones counted once."""
    cfg = tbert.BertConfig(**ENC)
    full = params_from_jax(encoder_world["tree"], cfg,
                           device="cpu").requires_grad_(True)
    h = tbert.apply(full, cfg, torch.from_numpy(encoder_world["ids"]),
                    torch.from_numpy(encoder_world["mask"]))[
                        "last_hidden_state"]
    (h.square() * torch.linspace(-1, 1, h.shape[-1])).sum().backward()
    ref = {n: p.grad.numpy() for n, p in full.named_parameters()}
    top = max(np.abs(g).max() for g in ref.values())
    for r in encoder_world["ranks"]:
        for name in ("tp", "sp_tp"):
            got = r["grads"][name]
            assert sorted(got) == sorted(ref)
            for n, g in ref.items():
                scale = top if "attention.k.bias" in n else np.abs(g).max()
                np.testing.assert_allclose(got[n], g, rtol=0,
                                           atol=1e-4 * scale, err_msg=n)


def test_world_shards_gather_back_bit_for_bit(encoder_world):
    """gather_module over the world's model axis gives the converted
    module back bit for bit on every rank."""
    coords = set()
    for r in encoder_world["ranks"]:
        assert r["gathered_equal"] is True
        coords.add((r["coords"]["data"], r["coords"]["model"]))
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
