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
