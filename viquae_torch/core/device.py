"""Device choice, float32 precision and host<->device copies for the
whole port.

Entry points run on the GPU unless the caller asks for the CPU; there is
no silent fallback. TF32 is switched off here, once, for every importer:
a float32 product on TF32 keeps ~10 mantissa bits, which breaks the
float32 parity contract with the JAX reference (the JAX package pins
``precision=HIGHEST`` on its float32 products for the same reason).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, else what
    the caller names. Raises when no device was given and there is no
    GPU — the CPU is only ever used when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")


class HostCopy:
    """Device->host copies started now, read later.

    CUDA tensors are copied with ``non_blocking=True`` into PINNED buffers
    (into pageable memory such a copy is silently synchronous), and an
    event is recorded after the copies; :meth:`result` waits on the event,
    because pinned memory read before the copy has landed holds garbage.
    CPU tensors pass through."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if not tensors[0].is_cuda:
            self.host = tensors
            return
        self.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in tensors)
        for h, t in zip(self.host, tensors):
            h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(tensors[0].device))

    def result(self) -> Tuple[torch.Tensor, ...]:
        if self.event is not None:
            self.event.synchronize()
        return self.host


class _PinnedStaging:
    """Pinned staging buffers for host->device uploads.

    A copy from pageable memory makes CUDA wait for the stream before it
    returns, so a serving step that uploads its inputs that way waits for
    the step before it. Here the host array is first copied into a pinned
    buffer (a host memcpy), the upload is enqueued with
    ``non_blocking=True``, and an event is recorded behind it: the buffer
    is handed out again only once that event has completed. Buffers are
    flat byte blocks in power-of-two sizes, so a stream of canvases of
    varying height settles on a few of them. Thread-safe: prefetch threads
    and batcher workers upload concurrently."""

    MIN_BYTES = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._busy: List[Tuple[torch.cuda.Event, torch.Tensor]] = []

    def _take(self, nbytes: int) -> torch.Tensor:
        size = max(self.MIN_BYTES, 1 << max(nbytes - 1, 0).bit_length())
        with self._lock:
            still_busy = []
            for event, block in self._busy:
                if event.query():
                    self._free.setdefault(block.numel(), []).append(block)
                else:
                    still_busy.append((event, block))
            self._busy = still_busy
            free = self._free.get(size)
            if free:
                return free.pop()
        return torch.empty(size, dtype=torch.uint8, pin_memory=True)

    def upload(self, src: torch.Tensor, device: torch.device) -> torch.Tensor:
        nbytes = src.numel() * src.element_size()
        block = self._take(nbytes)
        staged = block[:nbytes].view(src.dtype).view(src.shape)
        staged.copy_(src)
        out = staged.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        with self._lock:
            self._busy.append((event, block))
        return out


_STAGING = _PinnedStaging()


def upload(array, device: torch.device) -> torch.Tensor:
    """A host array (numpy, or a CPU tensor) as a tensor on ``device``,
    without waiting for the device: through a pinned staging buffer and a
    non-blocking copy on a CUDA device, a plain ``from_numpy`` on the CPU.
    The values and the dtype are the array's own."""
    src = (array if isinstance(array, torch.Tensor)
           else torch.from_numpy(np.ascontiguousarray(array)))
    device = torch.device(device)
    if device.type != "cuda":
        return src
    if src.numel() == 0:
        return torch.empty(src.shape, dtype=src.dtype, device=device)
    return _STAGING.upload(src.contiguous(), device)


def _is_host_only(value) -> bool:
    """Strings and lists that are ragged or hold strings: host-side
    bookkeeping (answer strings, ...) that no device step takes."""
    if isinstance(value, (str, bytes)):
        return True
    if isinstance(value, np.ndarray):
        return value.dtype.kind in "OUS"
    if isinstance(value, list):
        # rectangular numeric nested lists are array data
        try:
            arr = np.asarray(value)
        except (ValueError, TypeError):
            return True
        return arr.dtype.kind in "OUS"
    return False


def upload_batch(batch, device: torch.device):
    """A (nested) dict of host arrays as the same tree of tensors on
    ``device``, each through :func:`upload`; host-only leaves
    (:func:`_is_host_only`) are dropped."""
    if isinstance(batch, dict):
        return {k: upload_batch(v, device) for k, v in batch.items()
                if not _is_host_only(v)}
    if isinstance(batch, torch.Tensor) and batch.device.type != "cpu":
        return batch.to(device)
    return upload(batch if isinstance(batch, torch.Tensor)
                  else np.asarray(batch), device)
