"""Data layer: PNG/JPEG decode and the decoded caches, the RHD and
InterHand2.6M datasets, pinned prefetch, device preprocessing and its
augmentations, fake batches."""

from .interhand import InterHandDataset, write_synthetic_interhand
from .pipeline import epoch_index_chunks, prefetch_map, raw_device_batches
from .preprocess import (AugmentDraws, InterHandRawBatch, RawBatch,
                         draw_augmentations, model_input, preprocess_batch,
                         preprocess_interhand_batch)
from .rhd import RHDDataset, write_synthetic_rhd
from .synthetic import fake_sample_batch

__all__ = [
    "RawBatch", "InterHandRawBatch", "AugmentDraws", "draw_augmentations",
    "preprocess_batch", "preprocess_interhand_batch", "model_input",
    "RHDDataset", "write_synthetic_rhd", "InterHandDataset",
    "write_synthetic_interhand", "fake_sample_batch",
    "epoch_index_chunks", "prefetch_map", "raw_device_batches",
]
