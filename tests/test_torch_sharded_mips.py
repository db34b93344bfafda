"""The port's kb-sharded exact search (viquae_torch/ops/mips.py
``topk_sharded``, ``DenseIndex(mesh_ctx=)``) against the JAX package's
``topk_sharded`` / ``DenseIndex`` on its 8-device virtual CPU mesh.

Two levels: the shard-local step (``shard_topk``) run for each of kb
shards in this process, then ``merge_candidates`` — the wide parametrised
cases, up to kb = 8 — and a gloo world of 4 processes
(tests/torch_dist_helpers.py) on a kb = 4 and a data = 2 x kb = 2 mesh,
through the collectives.

Tolerances. f32 modes ("fast", "exact", "global", "approx"): ids equal to
JAX's and to the port's single-device search, scores within 2e-5 (the
single-device engine tests' bound). "fused" (kernel B1's plain twin on the
CPU) on integer-valued inputs, whose f32 sums are exact and whose scores
tie often: each shard's step equals JAX's interpret-mode kernel on that
shard, ties included; the merged result equals the port's single-device
``topk_fused`` bit for bit (the merge keeps tied scores in the
single-device order, ``merge_candidates``), and JAX's sharded result in its
scores, its ids differing only between equal scores (JAX merges ties by id,
so its result depends on where shard boundaries fall). "approx": also the
recall bound of test_sharded_approx_honors_recall_target.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as tdh
from viquae_torch.ops import mips as tm
from viquae_torch.ops import mips_fused as tmf
from viquae_tpu.core import mesh as jmesh
from viquae_tpu.ops import mips as jm
from viquae_tpu.ops import mips_pallas as jmp

torch.set_num_threads(2)

N, D, Q, K, CHUNK = 4001, 32, 17, 20, 512
INT32_MAX = 2 ** 31 - 1
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    kb = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((Q, D)).astype(np.float32)
    # integer-valued, for the fused engine: exact sums, frequent ties
    kb_int = rng.integers(-4, 5, (3000, 64)).astype(np.float32)
    q_int = rng.integers(-4, 5, (9, 64)).astype(np.float32)
    return queries, kb, q_int, kb_int


def _jax_sharded(q, kb_pad, k, kb_size, **kwargs):
    ctx = jmesh.make_mesh(data=8 // kb_size, kb=kb_size)
    with jmesh.use(ctx):
        fused = kwargs.get("mode") == "fused"
        mat = jnp.asarray(kb_pad.T if fused else kb_pad,
                          jnp.bfloat16 if fused else jnp.float32)
        mat = jax.device_put(mat, ctx.sharding(None, "kb") if fused
                             else ctx.kb_sharded)
        q = jnp.asarray(q, jnp.bfloat16 if fused else jnp.float32)
        s, i = jm.topk_sharded(q, mat, k, mesh_ctx=ctx, **kwargs)
    return np.asarray(s, np.float32), np.asarray(i)


def _composed(q, kb_pad, k, kb_size, valid_rows, mode, dtype=torch.float32,
              chunk_size=CHUNK):
    """Every shard's step in this process, then the merge."""
    rows = len(kb_pad) // kb_size
    q = torch.from_numpy(q).to(dtype)
    parts = [tm.shard_topk(q, torch.from_numpy(kb_pad[c * rows:
                                                      (c + 1) * rows]
                                               ).to(dtype),
                           k, c, valid_rows, chunk_size=chunk_size,
                           mode=mode)
             for c in range(kb_size)]
    s, i, r = zip(*parts)
    s, i = tm.merge_candidates(torch.stack(s), torch.stack(i), k,
                               torch.stack(r) if mode == "fused" else None)
    return s.numpy(), i.numpy()


def _single(q, kb, k, mode, valid_rows=None):
    """The port's single-device engine the index would route to."""
    q, kb = torch.from_numpy(q), torch.from_numpy(kb)
    if mode in ("global", "approx"):
        s, i = tm.topk_global(q, kb, k, valid_rows=valid_rows,
                              compute_dtype=torch.float32,
                              mode="approx" if mode == "approx" else "exact")
    else:
        s, i = tm.topk_single(q, kb, k, chunk_size=CHUNK,
                              valid_rows=valid_rows, mode=mode)
    return s.numpy(), i.numpy()


def _recall(idx, ref):
    return np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(idx, ref)])


@pytest.mark.parametrize("mode", ["fast", "exact", "global", "approx"])
@pytest.mark.parametrize("kb_size", [2, 4, 8])
def test_composed_f32_modes_match_jax_and_single_device(data, kb_size, mode):
    queries, kb, _, _ = data
    kb_pad = tdh.padded(kb, jmesh.pad_to_multiple(N, kb_size * 128))
    s, i = _composed(queries, kb_pad, K, kb_size, N, mode)
    js, ji = _jax_sharded(queries, kb_pad, K, kb_size, chunk_size=CHUNK,
                          valid_rows=N, compute_dtype=jnp.float32, mode=mode)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, **TOL)
    ss, si = _single(queries, kb, K, mode)
    np.testing.assert_array_equal(i, si)
    np.testing.assert_allclose(s, ss, **TOL)
    if mode == "approx":
        assert _recall(i, jm.exact_topk_numpy(queries, kb, K)[1]) > 0.9


def _tied_only(i, ji, q, kb):
    """Positions whose ids differ hold equal scores under both."""
    scores = q @ kb.T
    rows, cols = np.nonzero(i != ji)
    for r, c in zip(rows, cols):
        assert scores[r, i[r, c]] == scores[r, ji[r, c]], (r, c)


@pytest.mark.parametrize("valid", ["full", "uneven", "sparse"])
@pytest.mark.parametrize("kb_size", [2, 4, 8])
def test_composed_fused_equals_single_device_and_jax(data, kb_size, valid):
    """B1's plain twin per shard, 512-row shards as the reference's; the
    "sparse" case (100 valid rows, k = 256) leaves shards with
    valid_rows 0 and k beyond every shard's valid rows."""
    _, _, q_int, kb_int = data
    nv, k = {"full": (3000, K), "uneven": (3000 - 37, K),
             "sparse": (100, 256)}[valid]
    kb_pad = tdh.padded(kb_int, jmesh.pad_to_multiple(3000, kb_size * 512))
    s, i = _composed(q_int, kb_pad, k, kb_size, nv, "fused",
                     dtype=torch.bfloat16)
    one_s, one_i = tmf.topk_fused(
        torch.from_numpy(q_int).to(torch.bfloat16),
        torch.from_numpy(kb_pad).to(torch.bfloat16), k, valid_rows=nv)
    np.testing.assert_array_equal(s, one_s.numpy())
    np.testing.assert_array_equal(i, one_i.numpy())
    js, ji = _jax_sharded(q_int, kb_pad, k, kb_size, valid_rows=nv,
                          mode="fused")
    np.testing.assert_array_equal(s, js)
    _tied_only(i, ji, q_int, kb_pad)
    assert (i[:, :min(nv, k)] < nv).all()
    if nv < k:  # the sentinel stays unshifted, scores -inf
        assert (i[:, nv:] == INT32_MAX).all() and np.isneginf(s[:, nv:]).all()
        assert (np.sort(i[:, :nv], 1) == np.arange(nv)).all()


@pytest.mark.parametrize("shard", [0, 2])
def test_shard_step_equals_jax_kernel_on_that_shard_ties_included(data,
                                                                  shard):
    """shard_topk's fused step on one shard: the same ids as JAX's
    interpret-mode topk_fused on that shard's columns, shifted by the
    shard's base, tie order included."""
    _, _, q_int, kb_int = data
    kb_pad = tdh.padded(kb_int, 4096)
    rows = 1024
    nv = 3000 - 37
    s, i, _ = tm.shard_topk(
        torch.from_numpy(q_int).to(torch.bfloat16),
        torch.from_numpy(kb_pad[shard * rows: (shard + 1) * rows]).to(
            torch.bfloat16), K, shard, nv, mode="fused")
    js, ji = jmp.topk_fused(
        jnp.asarray(q_int, jnp.bfloat16),
        jnp.asarray(kb_pad[shard * rows: (shard + 1) * rows].T,
                    jnp.bfloat16), K,
        valid_rows=jnp.int32(min(max(nv - shard * rows, 0), rows)))
    ji = np.asarray(ji)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js, np.float32))
    np.testing.assert_array_equal(
        i.numpy(), np.where(ji == INT32_MAX, ji, ji + shard * rows))


@pytest.mark.parametrize("mode", ["global", "approx"])
def test_composed_k_exceeds_shard_rows(mode):
    """test_mips.py:438: 8 shards of 128 rows, k = 500."""
    rng = np.random.default_rng(1)
    kb = rng.standard_normal((1024, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    s, i = _composed(q, kb, 500, 8, 1024, mode)
    js, ji = _jax_sharded(q, kb, 500, 8, valid_rows=1024, mode=mode)
    assert s.shape == (4, 500)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, **TOL)
    np.testing.assert_array_equal(i, jm.exact_topk_numpy(q, kb, 500)[1])


def test_composed_uneven_valid_rows_is_exact_on_the_valid_prefix(data):
    """__graft_entry__.py:450-461: the last shard part padding, mode
    "fast", chunk 64: ids equal to the exact top-k of the valid rows."""
    queries, kb, _, _ = data
    kb_pad = tdh.padded(kb, jmesh.pad_to_multiple(N, 8 * 128))
    _, i = _composed(queries, kb_pad, K, 8, N - 37, "fast", chunk_size=64)
    np.testing.assert_array_equal(
        i, jm.exact_topk_numpy(queries, kb[: N - 37], K)[1])


# ---- a gloo world of 4 processes -----------------------------------------
MESHES = {"kb4": 4, "data2_kb2": 2}


@pytest.fixture(scope="module")
def world(data, tmp_path_factory):
    queries, kb, q_int, kb_int = data
    return tdh.run_world("mips", 4, tmp_path_factory.mktemp("mips"),
                         queries=queries, kb=kb, kb_int=kb_int, q_int=q_int,
                         k=K, chunk_size=CHUNK)


def _agree(results, key):
    """Every rank returns the same arrays; one rank's."""
    first = results[0][key]
    for res in results[1:]:
        for a, b in zip(first, res[key]):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
    return first


@pytest.mark.parametrize("mode", ["fast", "exact", "global", "approx"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_topk_sharded_f32_modes(data, world, name, mode):
    queries, kb, _, _ = data
    s, i, _ = _agree([r[name] for r in world], mode)
    kb_size = MESHES[name]
    kb_pad = tdh.padded(kb, jmesh.pad_to_multiple(N, kb_size * 128))
    js, ji = _jax_sharded(queries, kb_pad, K, kb_size, chunk_size=CHUNK,
                          valid_rows=N, compute_dtype=jnp.float32, mode=mode)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, **TOL)
    ss, si = _single(queries, kb, K, mode)
    np.testing.assert_array_equal(i, si)
    np.testing.assert_allclose(s, ss, **TOL)


@pytest.mark.parametrize("valid", ["full", "uneven", "sparse"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_topk_sharded_fused(data, world, name, valid):
    _, _, q_int, kb_int = data
    s, i, _ = _agree([r[name] for r in world], f"fused_{valid}")
    nv, k = {"full": (3000, K), "uneven": (3000 - 37, K),
             "sparse": (100, 256)}[valid]
    kb_pad = tdh.padded(kb_int, 4096)
    one_s, one_i = tmf.topk_fused(
        torch.from_numpy(q_int).to(torch.bfloat16),
        torch.from_numpy(kb_pad).to(torch.bfloat16), k, valid_rows=nv)
    np.testing.assert_array_equal(s, one_s.numpy())
    np.testing.assert_array_equal(i, one_i.numpy())
    js, ji = _jax_sharded(q_int, tdh.padded(kb_int, jmesh.pad_to_multiple(
        3000, MESHES[name] * 512)), k, MESHES[name], valid_rows=nv,
        mode="fused")
    np.testing.assert_array_equal(s, js)
    _tied_only(i, ji, q_int, kb_pad)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_uneven_valid_rows(data, world, name):
    queries, kb, _, _ = data
    _, i = _agree([r[name] for r in world], "fast_uneven")
    np.testing.assert_array_equal(
        i, jm.exact_topk_numpy(queries, kb[: N - 37], K)[1])


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_collectives_are_candidate_sized(world, name):
    """tests/test_collective_layout.py:62-128: every search issues ONE
    all-gather over kb of (kb, planes, Q, k) 4-byte values — scores and
    ids, plus the tie key for "fused" — never per-shard scores or KB rows;
    the bytes follow k and not N (fused: 3,000 rows; the f32 modes: 4,001,
    the same bytes a plane)."""
    kb_size = MESHES[name]
    for res in world:
        for key, q_count, k, planes in (
                [(m, Q, K, 2) for m in ("fast", "exact", "global", "approx")]
                + [("fused_full", 9, K, 3), ("fused_uneven", 9, K, 3),
                   ("fused_sparse", 9, 256, 3)]):
            log = res[name][key][2]
            candidate_bytes = kb_size * q_count * k * 4
            assert log == [("all_gather", "kb", planes * candidate_bytes)]
            assert planes * candidate_bytes <= 4 * 2 * candidate_bytes


@pytest.mark.parametrize("mode", ["fast", "global", "approx", "fused"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_dense_index_matches_jax_and_single_device(data, world, name,
                                                        mode):
    """DenseIndex on the mesh (each rank its N_pad / kb rows, 128-row
    aligned): search_batch and search_device against the JAX index on its
    kb mesh and the port's single-device index; one candidate gather."""
    queries, kb, _, _ = data
    s, i, log, rows = _agree([r[name] for r in world], f"index_{mode}")
    kb_size = MESHES[name]
    assert rows == jmesh.pad_to_multiple(N, kb_size * 128) // kb_size
    assert [(op, axis) for op, axis, _ in log] == [("all_gather", "kb")]
    ds, di = _agree([r[name] for r in world], f"index_{mode}_device")
    np.testing.assert_array_equal(di, i)
    np.testing.assert_array_equal(ds, s)
    one = tm.DenseIndex(kb, mode=mode, chunk_size=CHUNK, device="cpu")
    os_, oi = one.search_batch(queries, k=K)
    ctx = jmesh.make_mesh(data=8 // kb_size, kb=kb_size)
    with jmesh.use(ctx):
        js, ji = jm.DenseIndex(kb, mesh_ctx=ctx, mode=mode,
                               chunk_size=CHUNK).search_batch(queries, k=K)
    if mode == "fused":
        np.testing.assert_array_equal(i, oi)
        np.testing.assert_array_equal(s, os_)
        np.testing.assert_array_equal(s, js)
        assert (i != ji).mean() < 0.1  # swaps only among bf16 ties
        np.testing.assert_array_equal(s[i != ji], js[i != ji])
    else:
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(s, js, **TOL)
        np.testing.assert_array_equal(i, oi)
        np.testing.assert_allclose(s, os_, **TOL)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_dense_index_add_equals_a_fresh_build(data, world, name):
    """test_mips.py:516 on the mesh: rows added inside the padding, then
    enough to grow it (rows change owner), on an L2norm index: equal to a
    fresh build on the mesh, to the port's single-device index and to the
    JAX index after the same adds on its kb mesh."""
    queries, kb, _, _ = data
    res = world[0][name]
    for r in world[1:]:
        for key in ("add_small", "add_grow", "add_fresh", "add_rows"):
            np.testing.assert_array_equal(np.asarray(r[name][key][0]),
                                          np.asarray(res[key][0]))
    np.testing.assert_array_equal(res["add_grow"][1], res["add_fresh"][1])
    np.testing.assert_allclose(res["add_grow"][0], res["add_fresh"][0],
                               **TOL)
    one = tm.DenseIndex(kb[:500], do_l2norm=True, chunk_size=256,
                        device="cpu")
    one.add(kb[500:520])
    s, i = one.search_batch(queries, k=15)
    np.testing.assert_array_equal(res["add_small"][1], i)
    np.testing.assert_allclose(res["add_small"][0], s, **TOL)
    one.add(5.0 * kb[520:1100])
    np.testing.assert_array_equal(res["add_grow"][1],
                                  one.search_batch(queries, k=15)[1])
    np.testing.assert_array_equal(
        res["add_rows"], one.reconstruct_batch([0, 499, 510, 519, 520,
                                                1099]))
    kb_size = MESHES[name]
    ctx = jmesh.make_mesh(data=8 // kb_size, kb=kb_size)
    with jmesh.use(ctx):
        ref = jm.DenseIndex(kb[:500], do_l2norm=True, mesh_ctx=ctx,
                            chunk_size=256)
        ref.add(kb[500:520])
        ref.add(5.0 * kb[520:1100])
        js, ji = ref.search_batch(queries, k=15)
    np.testing.assert_array_equal(res["add_grow"][1], ji)
    np.testing.assert_allclose(res["add_grow"][0], js, **TOL)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_dense_index_save_load_and_reconstruct(data, world, name,
                                                    tmp_path):
    """save() on the mesh writes, from rank 0, the file one device writes;
    every rank loads it back into its shard and searches the same;
    reconstruct_batch reads rows across shards (a 2-D id array)."""
    queries, kb, _, _ = data
    one = tm.DenseIndex(kb, mode="fused", device="cpu")
    one.save(tmp_path / "one.npz")
    ref = dict(np.load(tmp_path / "one.npz"))
    res = world[0][name]
    assert res["saved"].keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(res["saved"][key], ref[key])
    s, i = one.search_batch(queries, k=K)
    for r in world:
        np.testing.assert_array_equal(r[name]["loaded"][1], i)
        np.testing.assert_array_equal(r[name]["loaded"][0], s)
        np.testing.assert_array_equal(
            r[name]["reconstruct"],
            one.reconstruct_batch(np.array([[0, N - 1], [N // 2, 7]])))
