"""Input pipeline: threaded host collate, pinned memory, async copies.

Port of ``handpose_tpu/data/pipeline.py:29,110-161``.  A worker thread
collates raw batches (RHD or InterHand2.6M: decoded from PNG/JPEG inside
one C++ call, or read from the memmap cache) and copies them into pinned
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

from ..utils.tracing import span
from .interhand import InterHandDataset
from .rhd import RHDDataset

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


def open_dataset(cfg, split: str):
    """``split`` of ``cfg.dataset_name`` ('RHD' or 'InterHand2.6M') as
    the JAX Worker and Evaluator open it: ``cfg.num_workers`` decode
    threads, ``cfg.cache_decoded``, InterHand's frames zero-padded to the
    largest annotated size."""
    if cfg.dataset_name == "InterHand2.6M":
        return InterHandDataset(cfg.dataset_root_dir, split,
                                cfg.fast_trainval, cfg.trans_test,
                                cfg.input_img_shape, cfg.num_workers,
                                pad_to="auto",
                                cache_decoded=cfg.cache_decoded)
    return RHDDataset(cfg.dataset_root_dir, split, cfg.num_workers,
                      cfg.image_size[0], cache_decoded=cfg.cache_decoded)


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


def _host_tensors(raw, pin: bool):
    """A raw-batch NamedTuple of numpy arrays as one of host tensors of
    the same type, pinned when ``pin``."""
    out = []
    for a in raw:
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.pin_memory() if pin else t)
    return type(raw)(*out)


def raw_device_batches(dataset, batch_size: int, device: torch.device, *,
                       shuffle: bool = False, seed: int = 0,
                       drop_remainder: bool = False,
                       depth: int = 2) -> Iterator:
    """Raw batches as tensors on ``device``, in the order of
    :func:`epoch_index_chunks` (by default the in-order evaluation epoch,
    trailing partial batch included; training shuffles and drops it).

    ``dataset`` needs ``__len__`` and ``raw_batch(indices)``, which
    returns a raw-batch NamedTuple with ``.to`` (``RawBatch``,
    ``InterHandRawBatch``).  The worker thread collates (the decoder and
    numpy's copies release the interpreter lock) and pins; the calling
    thread issues the copies to the card.
    """
    yield from sampled_device_batches(
        dataset, epoch_index_chunks(len(dataset), batch_size, shuffle, seed,
                                    drop_remainder), device, depth=depth)


def sampled_device_batches(dataset, chunks, device: torch.device, *,
                           depth: int = 2) -> Iterator:
    """:func:`raw_device_batches` over given index ``chunks`` (a
    sampler's, ``parallel.HostShardSampler``): each an index list, or an
    ``(indices, valid)`` pair whose False rows (padding) get their
    keypoint visibility zeroed, so they weigh nothing in the MPJPE sums
    and the masked losses."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def collate(chunk):
        with span("hp.data.collate"):
            if isinstance(chunk, tuple):
                idx, valid = chunk
                raw = dataset.raw_batch(idx)
                if not valid.all():
                    vis = np.asarray(raw.keypoint_vis)
                    raw = raw._replace(keypoint_vis=vis * valid.reshape(
                        (-1,) + (1,) * (vis.ndim - 1)).astype(vis.dtype))
            else:
                raw = dataset.raw_batch(chunk)
            return _host_tensors(raw, pin)

    for raw in prefetch_map(collate, chunks, depth=depth):
        yield raw.to(device, non_blocking=pin)
