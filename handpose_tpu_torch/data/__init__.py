"""Data layer: memmap-cache reads, pinned prefetch, device preprocessing."""

from .pipeline import epoch_index_chunks, prefetch_map, raw_device_batches
from .preprocess import RawBatch, model_input, preprocess_batch
from .rhd import RHDDataset, write_synthetic_rhd

__all__ = [
    "RawBatch", "preprocess_batch", "model_input",
    "RHDDataset", "write_synthetic_rhd",
    "epoch_index_chunks", "prefetch_map", "raw_device_batches",
]
