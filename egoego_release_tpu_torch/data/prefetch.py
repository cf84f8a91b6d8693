"""Background-thread batch prefetching (port of
egoego_release_tpu/data/prefetch.py).

The reference overlaps data loading with compute through DataLoader
workers. Here a daemon thread drains the host batch iterator into a bounded
queue; with a CUDA ``device`` it turns each batch's arrays into pinned host
tensors and starts their copies to the card (``non_blocking=True``), so the
loading, the pinning and the enqueue of the copy overlap the previous
step. The copies run on the thread's current stream, the default stream,
ahead of the step that reads them. Order is kept, and an error in the
iterator is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays -> tensors on ``device``: through pinned memory and an
    asynchronous copy for a CUDA device."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class PrefetchIterator:
    """Wrap a batch iterator with a bounded background prefetch queue.

    iterator:  yields dicts of numpy arrays (host batches)
    prefetch:  queue depth (2 is enough to hide loading behind compute)
    device:    optional torch device; batches then arrive as tensors there
    """

    _DONE = object()

    def __init__(self, iterator, prefetch: int = 2, device=None):
        self._it = iterator
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._it:
                if self._device is not None:
                    batch = batch_to_device(batch, self._device)
                self._q.put(batch)
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._q.put(self._DONE)  # later calls stop too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch_to_device(iterator, prefetch: int = 2, device=None):
    """``for batch in prefetch_to_device(it, device="cuda"): ...``"""
    return PrefetchIterator(iterator, prefetch=prefetch, device=device)
