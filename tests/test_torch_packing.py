"""The port's packer (viquae_torch/ops/packing.py + native/packer.cpp) is
bit-identical to the JAX package's on both the native and the Python path."""
import numpy as np
import pytest
import torch

from viquae_torch.ops import packing as tpack
from viquae_tpu.ops import packing as jpack

torch.set_num_threads(2)

FIELDS = ("input_ids", "segment_ids", "position_ids", "cls_rows",
          "cls_cols")


def _random_seqs(seed, n, max_len=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 3000, size=int(rng.integers(1, max_len)))
            .astype(np.int32) for _ in range(n)]


def _assert_same(a, b):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
        assert getattr(a, field).dtype == getattr(b, field).dtype, field
    assert a.n_seqs == b.n_seqs


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("seed,n,kwargs", [
    (0, 50, dict(row_len=32)),
    (1, 200, dict(row_len=64, pad_rows_to=32, n_cls=256)),
    (2, 17, dict(row_len=16, n_rows=64, n_cls=17)),
    (3, 1, dict(row_len=8)),
])
def test_pack_matches_jax(monkeypatch, native, seed, n, kwargs):
    if not native:
        monkeypatch.setenv("VIQUAE_NO_NATIVE", "1")
    else:
        from viquae_torch.native.build import load_packer

        if load_packer() is None:
            pytest.skip("g++ unavailable: no native packer")
    seqs = _random_seqs(seed, n)
    _assert_same(tpack.pack_token_sequences(seqs, **kwargs),
                 jpack.pack_token_sequences(seqs, **kwargs))


def test_native_and_python_paths_agree(monkeypatch):
    seqs = _random_seqs(7, 120, max_len=64)
    native = tpack.pack_token_sequences(seqs, row_len=64, pad_rows_to=32)
    monkeypatch.setenv("VIQUAE_NO_NATIVE", "1")
    _assert_same(native,
                 tpack.pack_token_sequences(seqs, row_len=64, pad_rows_to=32))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_fixed_rows_overflow_raises(monkeypatch, native):
    if not native:
        monkeypatch.setenv("VIQUAE_NO_NATIVE", "1")
    seqs = [np.arange(1, 30, dtype=np.int32)] * 5
    with pytest.raises(ValueError, match="n_rows=2"):
        tpack.pack_token_sequences(seqs, row_len=32, n_rows=2)
    with pytest.raises(ValueError, match="n_cls"):
        tpack.pack_token_sequences(seqs, row_len=32, n_cls=3)


def test_empty_sequence_raises():
    with pytest.raises(ValueError, match="empty sequence at position 1"):
        tpack.pack_token_sequences(
            [np.array([1, 2], np.int32), np.array([], np.int32)], row_len=8)


def test_pad_packed_rows_and_efficiency():
    seqs = _random_seqs(11, 30)
    p = tpack.pack_token_sequences(seqs, row_len=48)
    grown = tpack.pad_packed_rows(p, p.rows + 5, pad_token_id=9)
    ref = jpack.pad_packed_rows(jpack.pack_token_sequences(seqs, row_len=48),
                                p.rows + 5, pad_token_id=9)
    _assert_same(grown, ref)
    assert grown.rows == p.rows + 5
    assert (grown.input_ids[p.rows:] == 9).all()
    assert (grown.segment_ids[p.rows:] == 0).all()
    assert tpack.pad_packed_rows(p, p.rows) is p
    with pytest.raises(ValueError):
        tpack.pad_packed_rows(p, p.rows - 1)
    assert tpack.packing_efficiency(grown) == pytest.approx(
        jpack.packing_efficiency(ref))


@pytest.mark.parametrize("seed,n,kwargs", [
    (0, 50, dict(row_len=32)),
    (1, 90, dict(row_len=64, pad_rows_to=16, n_cls=96)),
    (2, 17, dict(row_len=48, n_rows=24, n_cls=20)),
])
def test_pack_parallel_and_gather_indices_match_jax(seed, n, kwargs):
    seqs = _random_seqs(seed, n, max_len=kwargs["row_len"])
    rng = np.random.default_rng(seed)
    feats = [rng.integers(0, 2, size=len(s)).astype(np.int32) for s in seqs]
    p = tpack.pack_token_sequences(seqs, **kwargs)
    ref = jpack.pack_token_sequences(seqs, **kwargs)
    for pad_value in (0, 7):
        ours = tpack.pack_parallel(p, feats, pad_value=pad_value)
        theirs = jpack.pack_parallel(ref, feats, pad_value=pad_value)
        np.testing.assert_array_equal(ours, theirs)
        assert ours.dtype == theirs.dtype
    # the features land where their tokens did
    canvas = tpack.pack_parallel(p, seqs)
    np.testing.assert_array_equal(canvas[p.segment_ids > 0],
                                  p.input_ids[p.segment_ids > 0])
    for out_len in (kwargs["row_len"], 8):   # 8 cuts the longer sequences
        idx, mask = tpack.gather_indices(p, out_len)
        ref_idx, ref_mask = jpack.gather_indices(ref, out_len)
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_array_equal(mask, ref_mask)
        assert idx.dtype == ref_idx.dtype == np.int32
        assert mask.dtype == ref_mask.dtype == np.bool_
        assert idx.shape == (len(p.cls_rows), out_len)
        flat = p.input_ids.reshape(-1)[idx]
        for i, s in enumerate(seqs):
            ln = min(len(s), out_len)
            np.testing.assert_array_equal(flat[i, :ln], s[:ln])
            assert mask[i, :ln].all() and not mask[i, ln:].any()
        # entries past n_seqs are unmasked and point at position 0
        assert not mask[n:].any() and not idx[n:].any()


@pytest.mark.parametrize("seed,n,n_reserved,kwargs", [
    (0, 40, 3, dict(row_len=32)),
    (1, 25, 5, dict(row_len=24, n_cls=32, pad_rows_to=8)),
    (2, 9, 1, dict(row_len=16, n_rows=16, n_cls=12, pad_token_id=4)),
])
def test_pack_with_reserved_matches_jax(seed, n, n_reserved, kwargs):
    """Sequences longer than row_len - n_reserved are cut; reserved slots
    of entries past n_seqs point out of bounds, at (rows, 0)."""
    seqs = _random_seqs(seed, n, max_len=40)
    p, rows, cols = tpack.pack_with_reserved(seqs, n_reserved, **kwargs)
    ref, ref_rows, ref_cols = jpack.pack_with_reserved(seqs, n_reserved,
                                                       **kwargs)
    _assert_same(p, ref)
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_array_equal(cols, ref_cols)
    assert rows.dtype == ref_rows.dtype == np.int32
    assert cols.dtype == ref_cols.dtype == np.int32
    n_cls = len(p.cls_rows)
    assert rows.shape == cols.shape == (n_cls, n_reserved)
    assert (rows[:n] < p.rows).all() and (cols[:n] < p.row_len).all()
    assert (rows[n:] == p.rows).all() and (cols[n:] == 0).all()
    # a reserved slot lies inside its own sequence's segment
    seg = p.segment_ids
    for i in range(n):
        own = seg[p.cls_rows[i], p.cls_cols[i]]
        assert (seg[rows[i], cols[i]] == own).all()


def test_pack_with_reserved_refuses_a_row_of_reserved_slots_only():
    with pytest.raises(AssertionError):
        tpack.pack_with_reserved(_random_seqs(0, 3), 8, row_len=8)
