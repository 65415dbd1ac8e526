"""Input pipeline: threaded host collate, pinned memory, async copies.

Port of ``handpose_tpu/data/pipeline.py:29,110-161``.  A worker thread
collates raw batches from the memmap cache and copies them into pinned
(page-locked) host memory; the consuming thread issues
``non_blocking`` host-to-device copies on the current stream, so the copy
of batch i+1 overlaps the device work of batch i.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from .preprocess import RawBatch

COLLATE_WORKERS = 1


def epoch_index_chunks(n: int, batch_size: int, shuffle: bool = False,
                       seed: int = 0, drop_remainder: bool = True):
    """Deterministic epoch order chunked into batch index lists (the same
    order as the JAX package for the same seed)."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = n - (n % batch_size) if drop_remainder else n
    return [list(order[s:s + batch_size]) for s in range(0, end, batch_size)]


def prefetch_map(fn, items, *, depth: int = 4) -> Iterator:
    """Ordered, bounded map over ``items`` in a thread pool: up to
    ``depth`` results in flight, yielded in input order."""
    with ThreadPoolExecutor(COLLATE_WORKERS) as ex:
        futs: deque = deque()
        try:
            for item in items:
                futs.append(ex.submit(fn, item))
                if len(futs) >= depth:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()
        finally:
            for f in futs:
                f.cancel()


def _host_tensors(raw: RawBatch, pin: bool) -> RawBatch:
    out = []
    for a in raw:
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.pin_memory() if pin else t)
    return RawBatch(*out)


def raw_device_batches(dataset, batch_size: int, device: torch.device, *,
                       shuffle: bool = False, seed: int = 0,
                       drop_remainder: bool = False,
                       depth: int = 2) -> Iterator[RawBatch]:
    """Raw batches as tensors on ``device``, in the order of
    :func:`epoch_index_chunks` (by default the in-order evaluation epoch,
    trailing partial batch included; training shuffles and drops it).

    ``dataset`` needs ``__len__`` and ``raw_batch(indices)``.  The worker
    thread collates (numpy, releases the interpreter lock in its copies)
    and pins; the calling thread issues the copies to the card.
    """
    device = torch.device(device)
    pin = device.type == "cuda"
    chunks = epoch_index_chunks(len(dataset), batch_size, shuffle, seed,
                                drop_remainder)

    def collate(idx):
        return _host_tensors(dataset.raw_batch(idx), pin)

    for raw in prefetch_map(collate, chunks, depth=depth):
        yield raw.to(device, non_blocking=pin)
