"""The port's DeviceBM25 (viquae_torch/ops/bm25_device.py) on the CPU:
every single-device case of tests/test_bm25_device.py, then the port
against the JAX class on the same seeded corpus.

Tolerances. Against the exact f32 host score vector: the rank-quality
criterion of the reference's test (bf16 per-posting weights: one bf16
relative step, 1.6e-2, of the true k-th score). Port against JAX: the built
arrays and the plans are equal bit for bit; top-k scores agree within 1e-5
relative (both sum the same bf16 weights in f32, in another order), and ids
are equal wherever the neighbouring scores are further apart than that.
``test_scatter_operands_behind_opt_barrier`` has no counterpart: the
barrier is a fix for an XLA fusion, and the port has no XLA.
"""
import numpy as np
import pytest
import torch

from torch_helpers import bf16_bits, device_bm25_arrays
from viquae_torch.ops import bm25 as tbm25
from viquae_torch.ops import bm25_device as tdev
from viquae_torch.ops.bm25_device import DeviceBM25

torch.set_num_threads(2)

SMALL = dict(n_head=16, l_small=64, pool_mid=6, pool_small=16, q_block=8)


def _synth_corpus(n_docs=400, vocab=300, seed=0):
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n_docs):
        length = rng.integers(10, 60)
        toks = (rng.zipf(1.3, length).astype(np.int64) - 1) % vocab
        texts.append(" ".join(f"w{t}" for t in toks))
    return texts


@pytest.fixture(scope="module")
def host_index():
    return tbm25.BM25Index.build(_synth_corpus(), k1=0.5, b=0.3)


@pytest.fixture(scope="module")
def device_index(host_index):
    return DeviceBM25(host_index, device="cpu", **SMALL)


def _exact_scores(index, query):
    """Full exact score vector on host (f32, original-order accumulation)."""
    scores = np.zeros(index.n_docs, np.float32)
    counts = {}
    for tok in tbm25.analyze(query):
        tid = index.vocab.get(tok)
        if tid is not None:
            counts[tid] = counts.get(tid, 0) + 1
    for tid, qtf in counts.items():
        lo, hi = index.offsets[tid], index.offsets[tid + 1]
        docs = index.docs[lo:hi]
        tf = index.tfs[lo:hi]
        scores[docs] += index.idf[tid] * qtf * tf / (tf + index.norm[docs])
    return scores


def _queries(host_index, n=24, seed=1, n_terms=6):
    rng = np.random.default_rng(seed)
    vocab = max(int(t[1:]) for t in host_index.vocab) + 1
    out = []
    for _ in range(n):
        terms = (rng.zipf(1.3, n_terms).astype(np.int64) - 1) % vocab
        out.append(" ".join(f"w{t}" for t in terms))
    return out


def _tail_terms(host_index, dev):
    df = np.diff(host_index.offsets)
    return [f"w{t}" for t in np.argsort(-df)
            if dev.head_pos[host_index.vocab[f"w{t}"]] < 0
            and df[host_index.vocab[f"w{t}"]] > 0]


def _assert_rank_quality(host_index, queries, d_ids, rel=2e-2):
    for q, query in enumerate(queries):
        exact = _exact_scores(host_index, query)
        if not d_ids[q]:
            assert not (exact > 0).any()
            continue
        kth = np.sort(exact)[::-1][len(d_ids[q]) - 1]
        tol = rel * max(kth, 1e-6) + 1e-6
        assert all(exact[d] >= kth - tol for d in d_ids[q])


# ---- the cases of tests/test_bm25_device.py, on the port -----------------
def test_device_matches_exact_to_bf16(host_index, device_index):
    queries = _queries(host_index)
    k = 20
    d_scores, d_ids = device_index.search_batch(queries, k=k)
    for q, (ds, di) in enumerate(zip(d_scores, d_ids)):
        exact = _exact_scores(host_index, queries[q])
        n_pos = int((exact > 0).sum())
        assert len(di) == min(k, n_pos), (q, len(di), n_pos)
        if not di:
            continue
        kth = np.sort(exact)[::-1][len(di) - 1]
        tol = 1.6e-2 * max(abs(kth), 1e-6) + 1e-6  # bf16 relative step
        for score, doc in zip(ds, di):
            # every retrieved doc must be a true near-top-k doc...
            assert exact[doc] >= kth - tol, (q, doc, exact[doc], kth)
            # ...and the device score must be the bf16-quantized exact one
            assert abs(score - exact[doc]) <= tol + 1.6e-2 * exact[doc], (
                q, doc, score, exact[doc])


def test_head_only_and_tail_only_queries(host_index, device_index):
    df = np.diff(host_index.offsets)
    head_term = f"w{np.argmax(df)}"
    rare = f"w{np.argmax(df == df[df > 0].min())}"
    for query in (head_term, rare, f"{head_term} {rare}"):
        (ds,), (di,) = device_index.search_batch([query], k=10)
        exact = _exact_scores(host_index, query)
        order = np.argsort(-exact, kind="stable")
        want = [d for d in order[:10] if exact[d] > 0]
        assert len(di) == min(10, len(want))
        assert exact[di[0]] >= exact[want[0]] * (1 - 2e-2)


def test_qtf_duplicates_count(host_index, device_index):
    df = np.diff(host_index.offsets)
    rare = f"w{np.argmax(df == df[df > 0].min())}"
    (s1,), (i1,) = device_index.search_batch([rare], k=5)
    (s2,), (i2,) = device_index.search_batch([f"{rare} {rare}"], k=5)
    assert i1 == i2
    np.testing.assert_allclose(np.asarray(s2), 2 * np.asarray(s1),
                               rtol=2e-2)


def test_overflow_falls_back_to_host_exactly(host_index, device_index):
    tail_terms = _tail_terms(host_index, device_index)[:23]
    assert len(tail_terms) == 23
    query = " ".join(tail_terms)
    plan, overflow = device_index._plan([query])
    assert overflow == [0]
    d_s, d_i = device_index.search_batch([query], k=10)
    h_s, h_i = host_index.search_batch([query], k=10)
    assert d_i == h_i
    assert d_s == h_s  # exact float equality: it IS the host path


def test_pool_exhaustion_spills_queries_not_results(host_index):
    dev = DeviceBM25(host_index, n_head=16, l_small=64, pool_mid=1,
                     pool_small=2, q_block=8, device="cpu")
    tails = _tail_terms(host_index, dev)[:6]
    queries = [f"{tails[0]} {tails[1]}", f"{tails[2]} {tails[3]}",
               f"{tails[4]} {tails[5]}"]
    _, overflow = dev._plan(queries)
    assert overflow, "tiny pool must overflow somewhere"
    d_s, d_i = dev.search_batch(queries, k=10)
    _assert_rank_quality(host_index, queries, d_i)


def test_empty_and_unknown_queries(device_index):
    scores, ids = device_index.search_batch(["", "zzz unknowntoken"], k=5)
    assert scores == [[], []] and ids == [[], []]


def test_batch_padding_isolated(host_index, device_index):
    """3 queries (padded to 8) == the same queries inside a full block."""
    queries = _queries(host_index, n=3, seed=7)
    a = device_index.search_batch(queries, k=10)
    b = device_index.search_batch(queries + _queries(host_index, 5, 8),
                                  k=10)
    assert a[1] == b[1][:3]
    assert a[0] == b[0][:3]


def test_rebuild_after_retune():
    host = tbm25.BM25Index.build(_synth_corpus(), k1=0.5, b=0.3)
    dev = DeviceBM25(host, n_head=16, l_small=64, q_block=8, device="cpu")
    before = bf16_bits(dev.tail_w).copy()
    host.set_hyperparameters(k1=1.2, b=0.75)
    dev.rebuild()
    assert not np.array_equal(bf16_bits(dev.tail_w), before)
    queries = _queries(host, n=4, seed=3)
    d_s, d_i = dev.search_batch(queries, k=10)
    _assert_rank_quality(host, queries, d_i)


def test_empty_corpus_returns_empty():
    idx = tbm25.BM25Index.build([], k1=0.5, b=0.3)
    dev = DeviceBM25(idx, n_head=4, l_small=16, pool_mid=2, pool_small=4,
                     q_block=4, device="cpu")
    scores, ids = dev.search_batch(["anything"], k=5)
    assert scores == [[]] and ids == [[]]
    d_s, d_i = dev.search_batch_device(["anything"], k=5)
    assert d_s.shape == d_i.shape == (4, 1)
    assert torch.isneginf(d_s).all() and (d_i == 2 ** 31 - 1).all()


def test_search_batch_device_matches_host_convention(host_index,
                                                     device_index):
    """search_batch_device returns the framework pad convention (-inf /
    INT32_MAX), row-identical to search_batch incl. overflow fallback
    rows; (n_pad, k) f32 scores and int32 ids."""
    tails = _tail_terms(host_index, device_index)
    queries = _queries(host_index, n=5, seed=13)
    queries.append(" ".join(tails[:23]))  # forces a host-fallback row
    _, overflow = device_index._plan(queries)
    assert overflow, "construction must include an overflow query"
    l_s, l_i = device_index.search_batch(queries, k=10)
    d_s, d_i = device_index.search_batch_device(queries, k=10)
    assert d_s.dtype == torch.float32 and d_i.dtype == torch.int32
    assert d_s.shape == d_i.shape == (8, 10)
    d_s, d_i = d_s.numpy(), d_i.numpy()
    pad = np.iinfo(np.int32).max
    for q in range(len(queries)):
        keep = d_i[q] != pad
        assert d_i[q][keep].tolist() == l_i[q]
        np.testing.assert_allclose(d_s[q][keep], l_s[q], rtol=1e-6)
        assert np.all(np.isneginf(d_s[q][~keep]))


def test_pools_scale_with_q_block(host_index):
    big = DeviceBM25(host_index, n_head=16, l_small=64, q_block=256,
                     device="cpu")
    assert big.pool_mid == 1088 and big.pool_small == 576
    small = DeviceBM25(host_index, n_head=16, l_small=64, q_block=128,
                       device="cpu")
    assert small.pool_mid == 704 and small.pool_small == 384
    queries = _queries(host_index, n=12, seed=7)
    s_big, i_big = big.search_batch(queries, k=10)
    s_small, i_small = small.search_batch(queries, k=10)
    for a, b in zip(i_big, i_small):
        assert a == b
    for a, b in zip(s_big, s_small):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_split_slots_match_unsplit(host_index):
    """A tiny l_mid cap forces wide terms to SPLIT across consecutive
    slots; scores must match an unsplit scorer (only f32 summation order
    can differ)."""
    unsplit = DeviceBM25(host_index, n_head=0, l_small=64, l_mid=1 << 20,
                         q_block=8, device="cpu")
    split = DeviceBM25(host_index, n_head=0, l_small=64, l_mid=128,
                       q_block=8, device="cpu")
    assert split.l_mid == 128
    assert unsplit.l_mid > split.l_mid, "fixture corpus too small to split"
    assert split.head_dense.shape == (0, split.d_pad)
    queries = _queries(host_index, n=16, seed=11)
    s_u, i_u = unsplit.search_batch(queries, k=10)
    s_s, i_s = split.search_batch(queries, k=10)
    assert split.last_overflow == 0, "split pools must absorb the chunks"
    for a, b in zip(i_u, i_s):
        assert a == b
    for a, b in zip(s_u, s_s):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_last_overflow_counter(host_index):
    dev = DeviceBM25(host_index, n_head=16, l_small=64, pool_mid=2,
                     pool_small=2, q_block=8, device="cpu")
    queries = _queries(host_index, n=16, seed=17)
    dev.search_batch(queries, k=10)
    assert dev.last_overflow > 0
    dev.search_batch_device(queries[:2], k=10)
    assert dev.last_overflow <= 2
    roomy = DeviceBM25(host_index, n_head=16, l_small=64, q_block=8,
                       device="cpu")
    roomy.search_batch(queries, k=10)
    assert roomy.last_overflow == 0


# ---- what the port does differently from XLA -----------------------------
def test_head_product_keeps_f32_sums(host_index):
    """A head-only query with two terms: the score of a doc that holds both
    is the f32 sum of two bf16 weights, bit for bit, not that sum rounded
    to bf16 (what a bf16 product with a bf16 result would return)."""
    dev = DeviceBM25(host_index, n_head=16, l_small=64, q_block=8,
                     device="cpu")
    head_terms = [t for t, tid in host_index.vocab.items()
                  if dev.head_pos[tid] in (0, 1)]
    assert len(head_terms) == 2
    rows = [dev.head_pos[host_index.vocab[t]] for t in head_terms]
    dense = dev.head_dense.float().numpy()
    want = 2.0 * dense[rows[0]] + dense[rows[1]]           # exact in f32
    query = f"{head_terms[0]} {head_terms[0]} {head_terms[1]}"
    d_s, d_i = dev.search_batch_device([query], k=10)
    ids = d_i[0].numpy()
    assert (ids < host_index.n_docs).all()
    np.testing.assert_array_equal(d_s[0].numpy(), want[ids])
    rounded = torch.from_numpy(want[ids]).to(torch.bfloat16).float().numpy()
    assert not np.array_equal(rounded, want[ids]), (
        "the fixture must tell f32 sums from bf16-rounded ones")


@pytest.mark.parametrize("n_docs", [400, 383],
                         ids=["many-pad-columns", "one-pad-column"])
def test_masked_lanes_change_no_score(n_docs):
    """Masked lanes add 0.0 to the pad columns n_docs .. D_pad-1 (one
    column when n_docs + 1 is a multiple of 128): every lane's target is
    in the block, and no real document's score moves."""
    host = tbm25.BM25Index.build(_synth_corpus(n_docs=n_docs), k1=0.5,
                                 b=0.3)
    dev = DeviceBM25(host, device="cpu", **SMALL)
    assert dev.d_pad - n_docs == (112 if n_docs == 400 else 1)
    plan, _ = dev._plan(_queries(host, n=8, seed=5))
    head_w, ms, ml, mr, mq, ss, sl, sr, sq = plan
    up = torch.from_numpy
    flat, vals = tdev._pool_lanes(
        dev.tail_docs, dev.tail_w, up(ms[0]), up(ml[0]), up(mr[0]),
        up(mq[0]), dev.l_mid, n_docs, dev.d_pad)
    docs = (flat % dev.d_pad).numpy()
    rows = (flat // dev.d_pad).numpy()
    masked = np.arange(dev.l_mid)[None, :] >= ml[0][:, None]
    assert masked.any() and (~masked).any()
    assert (docs[masked] >= n_docs).all() and (docs < dev.d_pad).all()
    assert (docs[~masked] < n_docs).all()
    assert (vals.numpy()[masked] == 0).all()
    assert (rows == mr[0][:, None]).all()


def test_gather_ranges_stay_in_bounds(host_index, device_index):
    """The trailing pad of l_mid entries keeps start + cap inside the tail
    arrays for the last posting range (an index gather does not clamp)."""
    dev = device_index
    n_tail = int(dev.tail_offsets[-1])
    assert dev.tail_docs.shape[0] == dev.tail_w.shape[0] == n_tail + dev.l_mid
    assert (dev.tail_docs[n_tail:] == host_index.n_docs).all()
    assert (dev.tail_w[n_tail:] == 0).all()


def test_refuses_to_fall_back_to_the_cpu(host_index, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceBM25(host_index, **SMALL)


# ---- the port against the JAX class --------------------------------------
@pytest.fixture(scope="module")
def jax_pair(host_index):
    from viquae_tpu.ops import bm25 as jbm25
    from viquae_tpu.ops.bm25_device import DeviceBM25 as JDeviceBM25

    j_host = jbm25.BM25Index.build(_synth_corpus(), k1=0.5, b=0.3)
    return j_host, JDeviceBM25


CONFIGS = {
    "small-pools": SMALL,
    "defaults-q8": dict(n_head=16, l_small=64, q_block=8),
    "no-head-split": dict(n_head=0, l_small=64, l_mid=128, q_block=8),
    "tiny-pools": dict(n_head=16, l_small=64, pool_mid=2, pool_small=2,
                       q_block=8),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_built_arrays_bit_equal_to_jax(host_index, jax_pair, name):
    """head_dense, tail_w (bf16 bit patterns: the host rounding through
    torch equals the reference's ml_dtypes cast), tail_docs, head_pos,
    tail_offsets and the derived widths."""
    j_host, JDeviceBM25 = jax_pair
    ours = device_bm25_arrays(DeviceBM25(host_index, device="cpu",
                                         **CONFIGS[name]))
    ref = device_bm25_arrays(JDeviceBM25(j_host, **CONFIGS[name]))
    assert ours.keys() == ref.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_equals_jax(host_index, jax_pair, name):
    """_plan is host Python carried over as it is: every plan array, the
    bf16 head query weights and the overflow list are equal."""
    import jax.numpy as jnp

    j_host, JDeviceBM25 = jax_pair
    ours = DeviceBM25(host_index, device="cpu", **CONFIGS[name])
    ref = JDeviceBM25(j_host, **CONFIGS[name])
    queries = _queries(host_index, n=20, seed=23)
    queries.append(" ".join(_tail_terms(host_index, ours)[:23]))
    plan, overflow = ours._plan(queries)
    j_plan, j_overflow = ref._plan(queries)
    assert overflow == j_overflow
    if name in ("small-pools", "tiny-pools"):
        assert overflow
    for a, b in zip(plan, j_plan):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        bf16_bits(tdev._to_bf16(plan[0])),
        bf16_bits(np.asarray(j_plan[0].astype(jnp.bfloat16))))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_search_matches_jax(host_index, jax_pair, name):
    """Top-k scores within 1e-5 relative of the JAX scorer's; ids equal
    except between documents whose scores lie within that tolerance; the
    lists and the device form agree with JAX's on length, pad convention
    and overflow count."""
    j_host, JDeviceBM25 = jax_pair
    ours = DeviceBM25(host_index, device="cpu", **CONFIGS[name])
    ref = JDeviceBM25(j_host, **CONFIGS[name])
    queries = _queries(host_index, n=20, seed=29)
    s, i = ours.search_batch(queries, k=15)
    j_s, j_i = ref.search_batch(queries, k=15)
    assert ours.last_overflow == ref.last_overflow
    for q in range(len(queries)):
        assert len(i[q]) == len(j_i[q]), q
        np.testing.assert_allclose(s[q], j_s[q], rtol=1e-5, atol=1e-7)
        for pos, (a, b) in enumerate(zip(i[q], j_i[q])):
            if a != b:
                other = j_s[q][j_i[q].index(a)] if a in j_i[q] else None
                assert other is not None and abs(
                    other - j_s[q][pos]) <= 1e-5 * abs(j_s[q][pos]), (q, pos)
    d_s, d_i = ours.search_batch_device(queries, k=15)
    jd_s, jd_i = ref.search_batch_device(queries, k=15)
    jd_s, jd_i = np.asarray(jd_s), np.asarray(jd_i)
    assert d_s.shape == jd_s.shape and d_i.shape == jd_i.shape
    np.testing.assert_array_equal(np.isneginf(d_s.numpy()), np.isneginf(jd_s))
    finite = np.isfinite(jd_s)
    np.testing.assert_allclose(d_s.numpy()[finite], jd_s[finite], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(d_i.numpy() == 2 ** 31 - 1,
                                  jd_i == 2 ** 31 - 1)


# ---- the smoke script's corpus synthesis and helpers ----------------------
@pytest.mark.parametrize("n_docs,vocab,seed", [(2000, 500, 0), (300, 4000, 7)])
def test_smoke_corpus_synthesis_equals_synth_zipf_index(n_docs, vocab, seed):
    """chip_smoke.synth_zipf_index_on_device (the same numpy draws, unique
    and stable sort done with torch) builds the index that
    ops.bm25.synth_zipf_index builds, array for array."""
    import chip_smoke

    ours = chip_smoke.synth_zipf_index_on_device(
        n_docs, vocab_size=vocab, mean_len=40, seed=seed, device="cpu")
    ref = tbm25.synth_zipf_index(n_docs, vocab_size=vocab, mean_len=40,
                                 seed=seed)
    for name in ("offsets", "docs", "tfs", "doc_len", "idf", "norm"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.vocab == ref.vocab and ours.n_docs == ref.n_docs
    assert (ours.k1, ours.b) == (ref.k1, ref.b) == (0.5, 0.3)


def test_smoke_rows_agree_allows_only_near_ties():
    import chip_smoke

    ids, scores = [[3, 5, 9]], [[2.0, 1.0, 0.5]]
    assert chip_smoke.rows_agree(ids, scores, ids, scores, 1e-5)["agree"]
    swapped = chip_smoke.rows_agree([[5, 3, 9]], [[2.0, 2.0 - 1e-7, 0.5]],
                                    [[3, 5, 9]], [[2.0, 2.0 - 1e-7, 0.5]],
                                    1e-5)
    assert swapped["agree"] and swapped["rows_with_another_order"] == 1
    assert not chip_smoke.rows_agree([[5, 3, 9]], scores, ids, scores,
                                     1e-5)["agree"]
    assert not chip_smoke.rows_agree([[3, 5]], [[2.0, 1.0]], ids, scores,
                                     1e-5)["agree"]
    assert not chip_smoke.rows_agree(ids, [[2.0, 1.1, 0.5]], ids, scores,
                                     1e-5)["agree"]


def test_smoke_folding_tokenizer_stays_inside_the_encoder_vocabulary():
    import chip_smoke

    tok = chip_smoke.FoldingTokenizer()
    ids = tok(["t0 t399999 t29000", ""], max_length=64)["input_ids"]
    assert ids[0] == [101, 1000, 1000 + 399999 % 29000, 1000, 102]
    assert ids[1] == [101, 102]
    assert max(max(row) for row in ids) < 30000
