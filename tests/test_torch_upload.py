"""Host->device uploads (viquae_torch/core/device.py ``upload``): on the
CPU the path is a plain ``from_numpy`` and the values are unchanged (exact
equality); the pinned staging pool is exercised with stand-in events (the
card's own behaviour is held in tests/test_torch_cuda.py under torch's
sync debug mode)."""
import numpy as np
import pytest
import torch

from viquae_torch.core import device as tdevice
from viquae_torch.core.device import upload

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.uint8,
                                   np.bool_])
def test_cpu_upload_keeps_values_and_dtype(dtype):
    rng = np.random.default_rng(0)
    a = (rng.integers(0, 2, (5, 7)) if dtype == np.bool_
         else rng.integers(0, 100, (5, 7))).astype(dtype)
    t = upload(a, torch.device("cpu"))
    assert t.device.type == "cpu" and tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.numpy(), a)
    assert t.numpy().dtype == a.dtype


def test_cpu_upload_of_views_and_tensors():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    np.testing.assert_array_equal(upload(a[:, ::2], "cpu").numpy(),
                                  a[:, ::2])
    np.testing.assert_array_equal(upload(a[1:3], "cpu").numpy(), a[1:3])
    bf = torch.from_numpy(a).to(torch.bfloat16)
    assert upload(bf, "cpu") is bf
    assert upload(np.zeros((0, 3), np.int32), "cpu").shape == (0, 3)


def test_pipelines_upload_through_the_shared_path():
    """PackedTextEmbedder.upload, AnswerPipeline.upload, the multi-index
    features and the hybrid host leg go through core.device.upload and copy
    nothing from pageable memory themselves; so do DeviceBM25's per-block
    plan arrays (its build-time uploads are not on a serving step)."""
    import inspect

    from viquae_torch.ir import embedding, qa_serving, serving
    from viquae_torch.ops import bm25_device

    for module in (embedding, qa_serving, serving):
        assert module.upload is upload
        assert "from_numpy(" not in inspect.getsource(module), module
    assert bm25_device.upload is upload
    for fn in (bm25_device.DeviceBM25._score_blocks,
               bm25_device.DeviceBM25.search_batch_device):
        source = inspect.getsource(fn)
        assert "upload(" in source and ".to(self.device)" not in source


class _FakeEvent:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_staging_reuses_a_block_only_after_its_event(monkeypatch):
    """A staging block goes back to the free list only once the event
    recorded behind its copy has completed; sizes are powers of two."""
    made = []
    real_empty = torch.empty

    def empty(size, dtype=None, pin_memory=False):
        made.append(size)
        return real_empty(size, dtype=dtype)

    monkeypatch.setattr(tdevice.torch, "empty", empty)
    pool = tdevice._PinnedStaging()
    a = pool._take(5000)
    assert a.numel() == 8192 and a.dtype == torch.uint8
    ev = _FakeEvent()
    pool._busy.append((ev, a))
    b = pool._take(5000)
    assert b is not a                       # the first copy is in flight
    ev.done = True
    c = pool._take(8192)
    assert c is a                           # handed out again afterwards
    assert pool._take(1).numel() == tdevice._PinnedStaging.MIN_BYTES
    assert made == [8192, 8192, 4096]
