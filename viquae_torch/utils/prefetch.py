"""Background-thread prefetch (counterpart of viquae_tpu/train/prefetch.py).

A producer thread runs the wrapped iterable ahead of the consumer and hands
items through a bounded queue, so host work (tokenize, pack, enqueue GPU
work) for batch i+1 overlaps the consumer's handling of batch i.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


class PrefetchIterable:
    """Wrap an iterable with background-thread prefetch.

    Re-iterable: each iter() starts a fresh producer thread. Exceptions in
    the producer propagate to the consumer.
    """

    def __init__(self, batches: Iterable, buffer_size: int = 2):
        self._batches = batches
        self._buffer_size = buffer_size

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._buffer_size)
        stop = threading.Event()
        error: list = []

        def _put(item) -> bool:
            # bounded put that notices consumer abandonment: a plain
            # q.put() would block forever once the consumer breaks out of
            # the loop, leaking the producer thread
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches:
                    if not _put(batch):
                        return
            except BaseException as e:  # noqa: BLE001 — propagate to consumer
                error.append(e)
            finally:
                _put(_SENTINEL)

        thread = threading.Thread(
            target=producer, daemon=True, name="viquae-torch-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
