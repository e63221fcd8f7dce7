"""Host data pipeline: background prefetch and global-batch sharding.

Checked against ``repro/data/pipeline.py`` (``Prefetcher``,
``shard_batch``, ``checked_iterator``; numpy and the standard library
only).  Batches stay numpy arrays on the host: the train step moves them
to its device, so the producer thread never touches the card.
``shard_batch`` carves one process's slice of a global batch (dim 0).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["Prefetcher", "shard_batch", "checked_iterator"]


class Prefetcher:
    """Background-thread prefetch with a bounded queue and clean shutdown;
    an exception in the producer is raised again by ``__next__``."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except BaseException as e:  # smelint: disable=EXC001 — producer thread: stored and re-raised on __next__()
            self._exc = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._exc:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def shard_batch(batch: Dict[str, np.ndarray], process_index: int,
                process_count: int) -> Dict[str, np.ndarray]:
    """Host-local slice of the global batch (dim 0)."""
    def one(x):
        b = x.shape[0]
        assert b % process_count == 0, (b, process_count)
        k = b // process_count
        return x[process_index * k:(process_index + 1) * k]
    return {k: one(v) for k, v in batch.items()}


def checked_iterator(it: Iterator[Dict], expect_keys) -> Iterator[Dict]:
    """Validates batch structure once, then passes through."""
    first = next(it)
    missing = set(expect_keys) - set(first)
    if missing:
        raise ValueError(f"data pipeline missing keys {missing}")
    yield first
    yield from it
