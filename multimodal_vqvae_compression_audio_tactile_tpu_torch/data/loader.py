"""Host-side batch iterator with background prefetch threads.

The JAX package's ``data/loader.py``: the epoch's order is
``random.Random(seed + epoch)``'s shuffle, batches are collated by worker
threads and handed out in order, as numpy ``[B, 1, T]`` float32 pairs that
the training loop moves to the device.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Iterator, Tuple

import numpy as np

from .segments import SegmentDataset


def _collate(samples) -> Tuple[np.ndarray, np.ndarray]:
    """Stack to [B, 1, T] and sanitize."""
    A = np.stack([s[0] for s in samples])[:, None, :]
    T = np.stack([s[1] for s in samples])[:, None, :]
    A = np.clip(np.nan_to_num(A, nan=0.0, posinf=0.9999, neginf=-0.9999), -1, 1)
    T = np.clip(np.nan_to_num(T, nan=0.0, posinf=0.9999, neginf=-0.9999), -1, 1)
    return A.astype(np.float32), T.astype(np.float32)


def batch_iterator(ds: SegmentDataset, batch: int, shuffle: bool = True,
                   drop_last: bool = True, seed: int = 7, epoch: int = 0,
                   prefetch: int = 2, num_threads: int = 4,
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield collated [B, 1, T] batches, made by background threads."""
    if hasattr(ds, "set_epoch"):
        ds.set_epoch(epoch)
    order = list(range(len(ds)))
    if shuffle:
        random.Random(seed + epoch).shuffle(order)
    batches = [order[i: i + batch] for i in range(0, len(order), batch)]
    if drop_last:
        batches = [b for b in batches if len(b) == batch]
    elif batches and not batches[-1]:
        batches.pop()
    if not batches:
        return

    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    idx_q: "queue.Queue" = queue.Queue()
    for j, b in enumerate(batches):
        idx_q.put((j, b))
    results: dict = {}
    lock = threading.Lock()
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            try:
                j, b = idx_q.get_nowait()
            except queue.Empty:
                return
            try:
                batch_np = _collate([ds[i] for i in b])
            except BaseException as e:  # raised in the consumer, not a deadlock
                with lock:
                    results[j] = e
                q.put(j)
                return
            with lock:
                results[j] = batch_np
            q.put(j)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, num_threads))]
    for t in threads:
        t.start()
    try:
        emitted = 0
        ready: dict = {}
        next_j = 0
        while emitted < len(batches):
            j = q.get()
            with lock:
                ready[j] = results.pop(j)
            while next_j in ready:
                item = ready.pop(next_j)
                if isinstance(item, BaseException):
                    raise item
                yield item
                next_j += 1
                emitted += 1
    finally:
        stop.set()
