"""The port's ShardedDeviceBM25 (viquae_torch/ops/bm25_device.py) against
the JAX class on its 8-device virtual CPU mesh: every sharded case of
tests/test_bm25_device.py (:206, :234, :247, :300, :319, :383).

Each shard's built arrays are built in this process (a mesh context at
each kb coordinate, no collective) and are the JAX class's slices of them
bit for bit (bf16 as bit patterns), and the host plans are equal. The
searches run in a gloo world of 4 processes (tests/torch_dist_helpers.py)
on a kb = 4 and a data = 2 x kb = 2 mesh, through the candidate
all-gather. Tolerances: top-k scores within 1e-5 relative of the JAX
class's (both sum the same bf16 weights in f32, in another order) and ids
equal wherever the neighbouring scores are further apart than that; the
single-device DeviceBM25 within 1e-6 as the reference's test holds its own
sharded class; the overflow row equal to the host scorer's.
"""
import numpy as np
import pytest
import torch

import torch_dist_helpers as tdh
from torch_helpers import bf16_bits
from viquae_torch.core import mesh
from viquae_torch.ops import bm25 as tbm25
from viquae_torch.ops.bm25_device import DeviceBM25, ShardedDeviceBM25
from viquae_tpu.core import mesh as jmesh
from viquae_tpu.ops import bm25 as jbm25
from viquae_tpu.ops.bm25_device import ShardedDeviceBM25 as JSharded

torch.set_num_threads(2)

SMALL = dict(n_head=16, l_small=64, pool_mid=6, pool_small=16, q_block=8)
SPLIT = dict(n_head=16, l_small=64, l_mid=128, q_block=8)
TINY = dict(n_head=16, l_small=64, pool_mid=1, pool_small=2, q_block=4)
MESHES = {"kb4": 4, "data2_kb2": 2}
INT32_MAX = 2 ** 31 - 1


def _synth_corpus(n_docs=400, vocab=300, seed=0):
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n_docs):
        length = rng.integers(10, 60)
        toks = (rng.zipf(1.3, length).astype(np.int64) - 1) % vocab
        texts.append(" ".join(f"w{t}" for t in toks))
    return texts


def _queries(host_index, n, seed, n_terms=6):
    rng = np.random.default_rng(seed)
    vocab = max(int(t[1:]) for t in host_index.vocab) + 1
    return [" ".join(f"w{t}" for t in
                     (rng.zipf(1.3, n_terms).astype(np.int64) - 1) % vocab)
            for _ in range(n)]


@pytest.fixture(scope="module")
def host_index():
    return tbm25.BM25Index.build(_synth_corpus(), k1=0.5, b=0.3)


@pytest.fixture(scope="module")
def j_host():
    return jbm25.BM25Index.build(_synth_corpus(), k1=0.5, b=0.3)


def _shard_ctx(kb_size, coord):
    """A mesh context at one kb coordinate, without a process group."""
    sizes = {a: 1 for a in mesh.AXES}
    coords = {a: 0 for a in mesh.AXES}
    sizes[mesh.KB_AXIS], coords[mesh.KB_AXIS] = kb_size, coord
    return mesh.MeshContext(sizes, coords, torch.device("cpu"))


def _overflow_query(host_index, sharded):
    df = np.diff(host_index.offsets)
    tails = [f"w{t}" for t in np.argsort(-df)
             if sharded.head_pos[host_index.vocab[f"w{t}"]] < 0
             and df[host_index.vocab[f"w{t}"]] > 0][:6]
    return " ".join(tails)


CONFIGS = {"small-pools": SMALL, "split": SPLIT, "tiny-pools": TINY}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("kb_size", [2, 4])
def test_each_shard_is_the_jax_class_slice_bit_for_bit(host_index, j_host,
                                                       kb_size, name):
    """The head matrix's column block, the tail row, the per-shard
    (start, len) tables, the widths and the plans (the overflow query
    included) equal the JAX class's."""
    ctx = jmesh.make_mesh(data=8 // kb_size, kb=kb_size)
    ref = JSharded(j_host, mesh_ctx=ctx, **CONFIGS[name])
    head = bf16_bits(np.asarray(ref.head_dense))
    docs, w = np.asarray(ref.tail_docs), bf16_bits(np.asarray(ref.tail_w))
    queries = _queries(host_index, 16, 11)
    for c in range(kb_size):
        ours = ShardedDeviceBM25(host_index, mesh_ctx=_shard_ctx(kb_size, c),
                                 **CONFIGS[name])
        queries_c = queries + [_overflow_query(host_index, ours)]
        dsp = ours.d_shard_pad
        assert (ours.d_shard, dsp, ours.l_mid, ours.l_small) == (
            ref.d_shard, ref.d_shard_pad, ref.l_mid, ref.l_small)
        np.testing.assert_array_equal(bf16_bits(ours.head_dense),
                                      head[:, c * dsp: (c + 1) * dsp])
        np.testing.assert_array_equal(ours.tail_docs.numpy(), docs[c])
        np.testing.assert_array_equal(bf16_bits(ours.tail_w), w[c])
        for key in ("tail_start", "tail_len", "tail_df_total", "head_pos"):
            np.testing.assert_array_equal(getattr(ours, key),
                                          getattr(ref, key), err_msg=key)
        plan, overflow = ours._plan(queries_c)
        j_plan, j_overflow = ref._plan(queries_c)
        assert overflow == j_overflow
        for a, b in zip(plan, j_plan):
            np.testing.assert_array_equal(a, b)


def test_per_shard_ranges_cover_all_postings(host_index):
    """test_bm25_device.py:234."""
    sharded = ShardedDeviceBM25(host_index, mesh_ctx=_shard_ctx(4, 0),
                                n_head=16, l_small=64, q_block=8)
    np.testing.assert_array_equal(sharded.tail_len.sum(axis=0),
                                  sharded.tail_df_total)


# ---- a gloo world of 4 processes -----------------------------------------
@pytest.fixture(scope="module")
def cases(host_index):
    probe = ShardedDeviceBM25(host_index, mesh_ctx=_shard_ctx(4, 0), **TINY)
    return {
        # test_bm25_device.py:206, :300, :383, :247
        "matches-single": (SMALL, _queries(host_index, 16, 11), 15),
        "device-lists": (SMALL, _queries(host_index, 6, 17), 10),
        "split": (SPLIT, _queries(host_index, 16, 13), 10),
        "overflow": (TINY, [_overflow_query(host_index, probe), ""], 10),
    }


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    return tdh.run_world(
        "bm25", 4, tmp_path_factory.mktemp("bm25"), texts=_synth_corpus(),
        configs=cases,
        seam_texts=_synth_corpus(n_docs=60, vocab=60, seed=9))


def _by_doc(s, i, ref_s, ref_i, rtol):
    """Lists of one query agree by doc id: equal lengths, scores within
    rtol, an id differing only where the reference's own scores tie."""
    assert len(i) == len(ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=rtol, atol=1e-7)
    for pos, (a, b) in enumerate(zip(i, ref_i)):
        if a != b:
            assert a in ref_i and abs(ref_s[ref_i.index(a)] - ref_s[pos]) \
                <= rtol * abs(ref_s[pos]), (pos, a, b)


@pytest.mark.parametrize("case", ["matches-single", "device-lists", "split",
                                  "overflow"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_search_matches_jax_and_single_device(host_index, j_host, cases,
                                                   world, name, case):
    cfg, queries, k = cases[case]
    got = world[0][name][case]
    for res in world[1:]:
        assert res[name][case]["lists"] == got["lists"]
        np.testing.assert_array_equal(res[name][case]["device"][1],
                                      got["device"][1])
    s, i = got["lists"]
    ctx = jmesh.make_mesh(data=8 // MESHES[name], kb=MESHES[name])
    ref = JSharded(j_host, mesh_ctx=ctx, **cfg)
    j_s, j_i = ref.search_batch(queries, k=k)
    assert got["overflow"] == ref.last_overflow
    single = DeviceBM25(host_index, device="cpu", **cfg)
    o_s, o_i = single.search_batch(queries, k=k)
    for q in range(len(queries)):
        _by_doc(s[q], i[q], j_s[q], j_i[q], 1e-5)
        _by_doc(s[q], i[q], o_s[q], o_i[q], 1e-6)
    # the device rows carry the lists in the pad convention
    d_s, d_i = got["device"]
    jd_s, jd_i = (np.asarray(a) for a in ref.search_batch_device(queries,
                                                                  k=k))
    assert d_s.shape == jd_s.shape
    for q in range(len(queries)):
        keep = d_i[q] != INT32_MAX
        assert d_i[q][keep].tolist() == i[q]
        np.testing.assert_allclose(d_s[q][keep], s[q], rtol=1e-6)
        assert np.isneginf(d_s[q][~keep]).all()
    if case == "overflow":
        h_s, h_i = host_index.search_batch(queries[:1], k=k)
        assert got["overflow"] == 1
        assert i[0] == h_i[0] and s[0] == h_s[0]
        assert i[1] == [] and s[1] == []


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_collectives_are_candidate_sized(cases, world, name):
    """tests/test_collective_layout.py:175-217: one all-gather over kb a
    query block, of (kb, 2, q_block, k) 4-byte values (scores and ids),
    below the budget and far below a leaked per-shard score block
    (q_block x d_shard_pad x 4 bytes)."""
    kb_size = MESHES[name]
    for case, (cfg, queries, k) in cases.items():
        got = world[0][name][case]
        qb = cfg["q_block"]
        n_blocks = -(-len(queries) // qb)
        candidate_bytes = kb_size * qb * k * 4
        assert got["log"] == [("all_gather", "kb", 2 * candidate_bytes)
                              ] * n_blocks
        assert 2 * candidate_bytes <= 4 * 2 * candidate_bytes
        assert 4 * 2 * candidate_bytes < qb * got["d_shard_pad"] * 4 * 4


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gloo_searcher_seam_builds_the_sharded_scorer(world, name):
    """test_bm25_device.py:319: device="sharded" behind the BM25 seam of a
    KnowledgeBase on the mesh builds ShardedDeviceBM25 over its kb axis;
    the retrieval is the JAX seam's."""
    import datasets

    from viquae_tpu.ir.search import IndexKind, KnowledgeBase

    texts = _synth_corpus(n_docs=60, vocab=60, seed=9)
    kind, kb_size, (s, i) = world[0][name]["seam"]
    assert (kind, kb_size) == ("ShardedDeviceBM25", MESHES[name])
    assert i[0], "non-empty retrieval through the sharded seam"
    ctx = jmesh.make_mesh(data=8 // MESHES[name], kb=MESHES[name])
    kb = KnowledgeBase(datasets.Dataset.from_dict({"passage": texts}),
                       mesh_ctx=ctx)
    kb.add_or_load_index(column="passage", index_name="sparse",
                         kind=IndexKind.BM25, k1=0.5, b=0.3,
                         device="sharded", n_head=8, l_small=32,
                         pool_mid=4, pool_small=8, q_block=4)
    j_s, j_i = kb.search_batch("sparse", [texts[5][:40]], k=5)
    _by_doc(s[0], i[0], j_s[0], j_i[0], 1e-5)
    for res in world[1:]:
        assert res[name]["seam"][2] == (s, i)
