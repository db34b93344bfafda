"""The IVF-Flat index (viquae_torch/ops/ivf.py) against the JAX module
(viquae_tpu/ops/ivf.py).

- Every case of tests/test_ivf.py, run on the port (its exact references
  are the port's flat index and numpy).
- Parity on the same init: k-means++ draws cannot be reproduced across
  frameworks (``jax.random``), so the port's Lloyd iterations start from
  the JAX seeding; centroids agree within 1e-5 relative on clustered data
  where no assignment is near a tie, and the assignment, the sorted
  layout and the skew split are equal.
- On one saved state, ids equal the JAX ids (split sublists included:
  their duplicated centroids tie, and both probe them lowest index
  first); scores within 1e-6 relative. ``.npz`` files load both ways.
- The ``IVF{nlist},Flat`` factories of the ``ir/search.py`` seam against
  the JAX ``KnowledgeBase``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viquae_torch.ops import ivf as tivf
from viquae_torch.ops.mips import INT32_MAX, DenseIndex, exact_topk_numpy
from viquae_tpu.ops import ivf as jivf

torch.set_num_threads(2)

K = 10
F32_REL = 1e-6


def IVF(kb, **kw):
    return tivf.IVFFlatIndex(kb, device="cpu", **kw)


def exact(kb, q, k=K, l2=False):
    s, i = DenseIndex(kb, do_l2norm=l2, mode="exact",
                      device="cpu").search_batch(q, k=k)
    return s, i


def recall_of(ids, ref):
    return np.mean([len(set(a) & set(b)) / ref.shape[1]
                    for a, b in zip(ids, ref)])


@pytest.fixture(scope="module")
def gaussian_case():
    rng = np.random.default_rng(0)
    kb = rng.standard_normal((5000, 24)).astype(np.float32)
    q = rng.standard_normal((23, 24)).astype(np.float32)  # not % qchunk
    return kb, q


def skewed_kb(seed=2, d=16):
    """One tight 3000-point blob + 1000 points over 10 far-apart centers
    (tests/test_ivf.py::test_skewed_lists_are_split_and_capped)."""
    rng = np.random.default_rng(seed)
    blob = rng.standard_normal((3000, d)).astype(np.float32) * 0.05
    far = rng.standard_normal((10, d)).astype(np.float32) * 12.0
    rest = np.concatenate([
        c + 0.05 * rng.standard_normal((100, d)).astype(np.float32)
        for c in far])
    return np.concatenate([blob, rest]), blob, rest


def separated_kb(seed=5, d=16, noise=0.2):
    """8 far-apart clusters, one of 3000 rows and seven of 100: k-means
    puts one centroid in each, no row is near an assignment tie, and the
    big list is split."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 20.0
    sizes = [3000] + [100] * 7
    kb = np.concatenate([
        c + noise * rng.standard_normal((n, d)).astype(np.float32)
        for c, n in zip(centers, sizes)])
    return kb, centers


# ---------------------------------------------------------------------------
# the cases of tests/test_ivf.py, on the port
# ---------------------------------------------------------------------------
def test_full_probe_equals_exact(gaussian_case):
    kb, q = gaussian_case
    ivf = IVF(kb, nlist=32, nprobe=4, seed=0)
    s_ivf, i_ivf = ivf.search_batch(q, k=K, nprobe=ivf.nlist)
    s_ex, i_ex = exact(kb, q)
    np.testing.assert_allclose(s_ivf, s_ex, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i_ivf, i_ex)  # FAISS tie order too


def test_recall_grows_with_nprobe(gaussian_case):
    kb, q = gaussian_case
    ivf = IVF(kb, nlist=32, seed=0)
    _, i_ex = exact(kb, q)

    def recall(nprobe):
        return recall_of(ivf.search_batch(q, k=K, nprobe=nprobe)[1], i_ex)

    r1, r8, r32 = recall(1), recall(8), recall(32)
    assert r1 <= r8 + 1e-9 and r8 <= r32 + 1e-9
    assert r32 == 1.0
    assert r8 > r1


def test_clustered_data_high_recall_at_low_nprobe():
    rng = np.random.default_rng(1)
    n_clusters, per, d = 40, 100, 16
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 5
    kb = np.concatenate([
        c + 0.3 * rng.standard_normal((per, d)).astype(np.float32)
        for c in centers])
    q = centers[:16] + 0.3 * rng.standard_normal((16, d)).astype(np.float32)
    ivf = IVF(kb, nlist=64, seed=0, train_iters=15)
    _, i_ex = exact(kb, q)

    def recall(nprobe):
        return recall_of(ivf.search_batch(q, k=K, nprobe=nprobe)[1], i_ex)

    assert recall(8) >= 0.9, recall(8)
    assert recall(16) == 1.0


def test_l2norm_mode_matches_flat(gaussian_case):
    kb, q = gaussian_case
    ivf = IVF(kb, nlist=16, do_l2norm=True, seed=0)
    s_ivf, i_ivf = ivf.search_batch(q, k=K, nprobe=16)
    s_ex, i_ex = exact(kb, q, l2=True)
    np.testing.assert_allclose(s_ivf, s_ex, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i_ivf, i_ex)


def test_k_exceeds_candidates_pads_with_sentinels():
    rng = np.random.default_rng(2)
    kb = rng.standard_normal((30, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    ivf = IVF(kb, nlist=16, seed=0)
    s, i = ivf.search_batch(q, k=50, nprobe=16)
    assert s.shape == (3, 50) and i.shape == (3, 50)
    assert (i[:, 30:] == INT32_MAX).all()
    assert np.isneginf(s[:, 30:]).all()
    np.testing.assert_array_equal(i[:, :30], exact(kb, q, k=30)[1])
    _, i1 = ivf.search_batch(q, k=20, nprobe=1)
    real = i1[i1 != INT32_MAX]
    assert ((0 <= real) & (real < 30)).all()


def test_save_load_roundtrip(gaussian_case, tmp_path):
    kb, q = gaussian_case
    ivf = IVF(kb, nlist=32, nprobe=7, seed=0)
    ivf.save(tmp_path / "ivf")
    loaded = tivf.IVFFlatIndex.load(tmp_path / "ivf", device="cpu")
    assert loaded.nprobe == 7 and loaded.nlist == 32 and loaded.n == len(kb)
    s0, i0 = ivf.search_batch(q, k=K)
    s1, i1 = loaded.search_batch(q, k=K)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)


def test_reconstruct_and_add_contract(gaussian_case):
    kb, _ = gaussian_case
    ivf = IVF(kb, nlist=32, seed=0)
    np.testing.assert_array_equal(ivf.reconstruct_batch([0, 17, 4999]),
                                  kb[[0, 17, 4999]])
    with pytest.raises(NotImplementedError, match="DenseIndex"):
        ivf.add(kb[:2])


def test_bf16_storage_runs(gaussian_case):
    kb, q = gaussian_case
    ivf = IVF(kb, nlist=32, seed=0, dtype=torch.bfloat16)
    _, i = ivf.search_batch(q, k=K, nprobe=ivf.nlist)
    assert recall_of(i, exact(kb, q)[1]) > 0.9


def _dict_kb(kb_mat):
    return {"emb": [row for row in kb_mat]}


def test_string_factory_seam():
    from viquae_torch.ir.search import KnowledgeBase

    rng = np.random.default_rng(3)
    kb_mat = rng.standard_normal((2000, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    kb = KnowledgeBase(kb_path=_dict_kb(kb_mat), device="cpu", index_kwargs={
        "dense": {"column": "emb", "string_factory": "IVF32,Flat",
                  "nprobe": 32, "seed": 0}})
    assert isinstance(kb.indexes["dense"].backend, tivf.IVFFlatIndex)
    _, ids = kb.search_batch("dense", [row for row in q], k=K)
    for a, b in zip(ids, exact(kb_mat, q)[1]):
        np.testing.assert_array_equal(np.asarray(a), b)
    kb_l2 = KnowledgeBase(kb_path=_dict_kb(kb_mat), device="cpu",
                          index_kwargs={"dense": {
                              "column": "emb",
                              "string_factory": "L2norm,IVF32,Flat",
                              "seed": 0}})
    assert kb_l2.indexes["dense"].backend.do_l2norm


def test_save_load_through_config_seam(tmp_path):
    from viquae_torch.ir.search import KnowledgeBase

    rng = np.random.default_rng(4)
    kb_mat = rng.standard_normal((500, 8)).astype(np.float32)
    path = str(tmp_path / "ivf_idx")
    kb1 = KnowledgeBase(kb_path=_dict_kb(kb_mat), device="cpu", index_kwargs={
        "dense": {"column": "emb", "string_factory": "IVF16,Flat",
                  "seed": 0, "save_path": path}})
    kb2 = KnowledgeBase(kb_path=_dict_kb(kb_mat), device="cpu", index_kwargs={
        "dense": {"column": "emb", "string_factory": "IVF16,Flat",
                  "load_path": path}})
    q = [rng.standard_normal(8).astype(np.float32) for _ in range(3)]
    _, i1 = kb1.search_batch("dense", q, k=5)
    _, i2 = kb2.search_batch("dense", q, k=5)
    for a, b in zip(i1, i2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_device_build_matches_host_build(gaussian_case):
    """A tensor KB builds where it lies, end to end, into the same index
    as the host-numpy path."""
    kb, q = gaussian_case
    host = IVF(kb, nlist=32, seed=0)
    dev = IVF(torch.from_numpy(kb), nlist=32, seed=0)
    s0, i0 = host.search_batch(q, k=K, nprobe=32)
    s1, i1 = dev.search_batch(q, k=K, nprobe=32)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(s0, s1, rtol=1e-5, atol=1e-5)


def test_skewed_lists_are_split_and_capped(tmp_path):
    kb, blob, rest = skewed_kb()
    ivf = IVF(kb, nlist=16, seed=0, max_list_factor=2.0)
    cap = int(np.ceil(2.0 * len(kb) / 16))
    assert ivf.list_cap <= cap, (ivf.list_cap, cap)
    assert ivf.nlist > 16
    sizes = ivf._st.sizes.numpy()
    starts = ivf._st.starts.numpy()
    assert int(sizes.sum()) == len(kb)
    assert (sizes <= cap).all()
    assert int((starts + sizes).max()) <= ivf._st.matrix.shape[0]
    q = np.concatenate([blob[:5], rest[:5]]) + 0.01
    s_ivf, i_ivf = ivf.search_batch(q, k=K, nprobe=ivf.nlist)
    s_ex, i_ex = exact(kb, q)
    np.testing.assert_array_equal(i_ivf, i_ex)
    np.testing.assert_allclose(s_ivf, s_ex, rtol=1e-5, atol=1e-5)
    ivf.save(tmp_path / "ivf")
    loaded = tivf.IVFFlatIndex.load(tmp_path / "ivf", device="cpu")
    assert loaded.nlist == ivf.nlist
    np.testing.assert_array_equal(
        loaded.search_batch(q, k=K, nprobe=loaded.nlist)[1], i_ivf)


# ---------------------------------------------------------------------------
# parity with the JAX module on the same init / state
# ---------------------------------------------------------------------------
def _jax_sample_and_init(kb, nlist, seed=0, per_list=64):
    rng = np.random.default_rng(seed)
    s = min(len(kb), per_list * nlist)
    idx = np.sort(rng.choice(len(kb), size=s, replace=False))
    sample = kb[idx]
    init = np.asarray(jivf._kmeanspp_init(jax.random.key(seed),
                                          jnp.asarray(sample), nlist))
    return sample, init


def test_kmeans_fit_and_assign_match_jax_on_the_same_init():
    kb, _ = separated_kb()
    sample, init = _jax_sample_and_init(kb, 8)
    ref = np.asarray(jivf._kmeans_fit(jnp.asarray(sample),
                                      jnp.asarray(init), 10))
    got = tivf._kmeans_fit(torch.from_numpy(sample),
                           torch.from_numpy(init.copy()), 10).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tivf._assign_chunk(torch.from_numpy(kb), torch.from_numpy(ref)
                           ).numpy(),
        np.asarray(jivf._assign_chunk(jnp.asarray(kb), jnp.asarray(ref))))


def test_port_kmeanspp_keeps_the_reference_invariants():
    """The port's own seeding (torch.Generator draws): nlist distinct rows
    of the sample, reproducible from the seed, one per far cluster."""
    kb, centers = separated_kb()
    sample = torch.from_numpy(kb[::7].copy())

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tivf._kmeanspp_init(gen, sample, 8)

    a = draw(0)
    torch.testing.assert_close(a, draw(0), rtol=0, atol=0)
    rows = {tuple(r) for r in sample.numpy()}
    assert all(tuple(c) in rows for c in a.numpy())
    near = np.argmin(((a.numpy()[:, None] - centers[None]) ** 2).sum(-1), 1)
    assert sorted(near.tolist()) == list(range(8))


def _build_both(monkeypatch, kb, **kw):
    """The JAX index and the port's, the port's Lloyd iterations started
    from the JAX k-means++ seeding (the one step that cannot be drawn the
    same)."""
    j = jivf.IVFFlatIndex(kb, **kw)
    trained = kb
    if kw.get("do_l2norm"):
        trained = kb / np.maximum(np.linalg.norm(kb, axis=1, keepdims=True),
                                  1e-12)
    _, init = _jax_sample_and_init(trained, kw["nlist"], kw.get("seed", 0))
    monkeypatch.setattr(
        tivf, "_kmeanspp_init",
        lambda gen, sample, nlist: torch.from_numpy(init.copy()))
    return j, IVF(kb, **kw)


def test_same_assignment_gives_the_same_layout_and_split(monkeypatch):
    kb, _ = separated_kb()
    j, t = _build_both(monkeypatch, kb, nlist=8, seed=0,
                       max_list_factor=2.0)
    assert t.nlist == j.nlist > 8 and t.list_cap == j.list_cap
    for name in ("starts", "sizes", "ids"):
        np.testing.assert_array_equal(getattr(t._st, name).numpy(),
                                      np.asarray(getattr(j._st, name)))
    np.testing.assert_array_equal(t._st.matrix.numpy(),
                                  np.asarray(j._st.matrix))
    # the parent map: sublists carry their parent's centroid
    np.testing.assert_allclose(t._st.centroids.numpy(),
                               np.asarray(j._st.centroids),
                               rtol=1e-5, atol=1e-5)
    c = t._st.centroids.numpy()
    dup = [(a, b) for a in range(len(c)) for b in range(a + 1, len(c))
           if (c[a] == c[b]).all()]
    assert dup, "the big list was not split"


def test_split_sublists_are_probed_lowest_index_first():
    """Duplicated centroids tie exactly; the probe keeps ascending list
    ids, as lax.top_k does."""
    cents = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 0.0],
                      [0.5, 0.5]], np.float32)
    q = np.array([[2.0, 0.1], [0.1, 2.0]], np.float32)
    got = tivf._probe(torch.from_numpy(q), torch.from_numpy(cents), 4)
    ref = jax.lax.top_k(jnp.asarray(q) @ jnp.asarray(cents).T, 4)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy()[0, :3], [0, 2, 3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_saved_index_searches_the_same_in_the_port(tmp_path, dtype):
    """A skewed JAX build, saved and loaded into the port: at every nprobe
    the ids equal the JAX ids (a small nprobe probes only some sublists of
    the split blob, so the tie order decides which)."""
    kb, blob, rest = skewed_kb()
    j = jivf.IVFFlatIndex(kb, nlist=16, seed=0, max_list_factor=2.0)
    assert j.nlist > 16
    j.save(tmp_path / "j")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jl = jivf.IVFFlatIndex.load(tmp_path / "j", dtype=jdt)
    tl = tivf.IVFFlatIndex.load(tmp_path / "j", device="cpu", dtype=tdt)
    q = np.concatenate([blob[:6], rest[:6]]) + 0.01
    for nprobe in (1, 2, 3, 8, j.nlist):
        s_j, i_j = jl.search_batch(q, k=K, nprobe=nprobe)
        s_t, i_t = tl.search_batch(q, k=K, nprobe=nprobe)
        np.testing.assert_array_equal(i_t, i_j)
        np.testing.assert_allclose(s_t, np.asarray(s_j, np.float32),
                                   rtol=F32_REL, atol=1e-6)


def test_port_saved_index_searches_the_same_in_jax(tmp_path):
    kb, blob, rest = skewed_kb(seed=7)
    t = IVF(kb, nlist=16, seed=0, max_list_factor=2.0, nprobe=3)
    t.save(tmp_path / "t")
    jl = jivf.IVFFlatIndex.load(tmp_path / "t")
    assert (jl.nlist, jl.nprobe, jl.list_cap, jl.n) == (
        t.nlist, t.nprobe, t.list_cap, t.n)
    q = np.concatenate([blob[:6], rest[:6]]) - 0.01
    for nprobe in (None, 1, t.nlist):
        s_j, i_j = jl.search_batch(q, k=K, nprobe=nprobe)
        s_t, i_t = t.search_batch(q, k=K, nprobe=nprobe)
        np.testing.assert_array_equal(i_t, np.asarray(i_j))
        np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=F32_REL,
                                   atol=1e-6)


def test_l2norm_state_matches_jax_on_the_same_init(monkeypatch, tmp_path):
    # wide clusters: normalized rows of tight ones would tie in f32
    kb, _ = separated_kb(seed=9, noise=4.0)
    j, t = _build_both(monkeypatch, kb, nlist=8, seed=0, do_l2norm=True)
    np.testing.assert_array_equal(t._st.matrix.numpy(),
                                  np.asarray(j._st.matrix))
    q = kb[::331] * 3.0
    s_j, i_j = j.search_batch(q, k=K, nprobe=2)
    s_t, i_t = t.search_batch(q, k=K, nprobe=2)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, rtol=F32_REL, atol=1e-6)


@pytest.mark.parametrize("factory", ["IVF16,Flat", "L2norm,IVF16,Flat"])
def test_search_seam_builds_saves_and_loads_like_jax(tmp_path, factory):
    """The seam on a JAX-built index file: the port loads what the JAX
    seam saved and returns its runs; the port's own build saves a file
    the JAX seam loads."""
    from viquae_torch.ir.search import KnowledgeBase as TKB
    from viquae_tpu.ir.search import KnowledgeBase as JKB

    kb_mat, _, _ = skewed_kb(seed=11, d=8)
    kb_mat = kb_mat[::4].copy()
    rng = np.random.default_rng(12)
    q = [kb_mat[i] + 0.01 * rng.standard_normal(8).astype(np.float32)
         for i in range(0, len(kb_mat), 97)]
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jkb = JKB(kb_path=_dict_kb(kb_mat), index_kwargs={"dense": {
        "column": "emb", "string_factory": factory, "seed": 0,
        "nprobe": 2, "save_path": jpath}})
    tkb = TKB(kb_path=_dict_kb(kb_mat), device="cpu", index_kwargs={
        "dense": {"column": "emb", "string_factory": factory,
                  "load_path": jpath}})
    assert tkb.indexes["dense"].do_L2norm == ("L2norm" in factory)
    s_j, i_j = jkb.search_batch("dense", q, k=5)
    s_t, i_t = tkb.search_batch("dense", q, k=5)
    for a, b, x, y in zip(i_t, i_j, s_t, s_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=F32_REL, atol=1e-6)
    TKB(kb_path=_dict_kb(kb_mat), device="cpu", index_kwargs={"dense": {
        "column": "emb", "string_factory": factory, "seed": 0,
        "save_path": tpath}})
    assert os.path.exists(tpath + ".npz")
    j2 = JKB(kb_path=_dict_kb(kb_mat), index_kwargs={"dense": {
        "column": "emb", "string_factory": factory, "load_path": tpath}})
    t2 = TKB(kb_path=_dict_kb(kb_mat), device="cpu", index_kwargs={"dense": {
        "column": "emb", "string_factory": factory, "load_path": tpath}})
    for a, b in zip(j2.search_batch("dense", q, k=5)[1],
                    t2.search_batch("dense", q, k=5)[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_brute_force_over_the_probed_lists():
    """The search equals a per-query product over exactly the rows of
    its probed lists, then the finalize_topk tail (chip_smoke's gate)."""
    from viquae_torch.ops.mips import finalize_topk

    kb, blob, rest = skewed_kb(seed=13)
    t = IVF(kb, nlist=16, seed=0, max_list_factor=2.0)
    q = torch.from_numpy(np.concatenate([blob[:4], rest[:4]]) + 0.02)
    nprobe = 3
    s, i = t.search_batch(q, k=K, nprobe=nprobe, sync=False)
    probed = tivf._probe(q, t._st.centroids, nprobe)
    st = t._st
    for r in range(q.shape[0]):
        rows = torch.cat([torch.arange(int(st.starts[c]),
                                       int(st.starts[c] + st.sizes[c]))
                          for c in probed[r]])
        cand = torch.matmul(st.matrix[rows], q[r])[None]
        rs, ri = finalize_topk(cand, st.ids[rows][None], K)
        torch.testing.assert_close(i[r], ri[0], rtol=0, atol=0)
        torch.testing.assert_close(s[r], rs[0])


def test_exact_numpy_reference_agrees_with_full_probe(gaussian_case):
    kb, q = gaussian_case
    ivf = IVF(kb, nlist=8, seed=1)
    _, i = ivf.search_batch(q, k=K, nprobe=8)
    np.testing.assert_array_equal(i, exact_topk_numpy(q, kb, K)[1])
