"""Async host input pipeline.

The reference overlaps batch construction with GPU compute through torch
DataLoader worker processes (SURVEY.md §2.4 "host parallelism"). Here a
background thread runs the collator ahead of the training loop and hands
ready batches through a bounded queue, so host-side tokenization/sampling
overlaps device steps (the single-process JAX equivalent; the jitted step
itself is async-dispatched by JAX already).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

_SENTINEL = object()


class PrefetchIterable:
    """Wrap an iterable of batches with background-thread prefetch.

    Re-iterable: each iter() starts a fresh producer thread (the Trainer
    re-iterates per epoch). Exceptions in the producer propagate to the
    consumer.
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
            # q.put() would block FOREVER once the consumer breaks out of
            # the loop (max_steps training ends mid-epoch), leaking one
            # producer thread + a pinned collator generator per epoch
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
            target=producer, daemon=True, name="viquae-prefetch")
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


class CollatorLoader:
    """Dataset + collator -> prefetched batch stream (the DataLoader role).

    Deterministic order per (seed, epoch); drops the final partial batch
    (XLA static shapes).
    """

    def __init__(self, dataset, collate_fn: Callable, batch_size: int,
                 shuffle: bool = False, seed: int = 42,
                 buffer_size: int = 2):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.buffer_size = buffer_size
        self.epoch = 0

    def _raw_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for start in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
            items = [
                self.dataset[int(i)]
                for i in order[start: start + self.batch_size]
            ]
            yield self.collate_fn(items)
        self.epoch += 1

    def __iter__(self):
        return iter(PrefetchIterable(
            self._raw_batches(), buffer_size=self.buffer_size
        ))

    def __len__(self):
        return len(self.dataset) // self.batch_size
