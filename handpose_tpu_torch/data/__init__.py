"""Data layer: memmap-cache reads, pinned prefetch, device preprocessing
and its augmentations, fake batches."""

from .pipeline import epoch_index_chunks, prefetch_map, raw_device_batches
from .preprocess import (AugmentDraws, RawBatch, draw_augmentations,
                         model_input, preprocess_batch)
from .rhd import RHDDataset, write_synthetic_rhd
from .synthetic import fake_sample_batch

__all__ = [
    "RawBatch", "AugmentDraws", "draw_augmentations", "preprocess_batch",
    "model_input", "RHDDataset", "write_synthetic_rhd", "fake_sample_batch",
    "epoch_index_chunks", "prefetch_map", "raw_device_batches",
]
