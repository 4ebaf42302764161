"""Data pipeline: folder discovery, host decode and prefetch (copies of
the JAX package's host modules) and the device-side paired augmentation
(``transforms``, rewritten in PyTorch)."""

from .folder import (
    IMG_EXTENSIONS,
    find_aligned_pairs,
    find_temporal_sequences,
    make_dataset,
)
from .loader import DataLoader, create_dataloader
from .native import decoder_in_use
from .synthetic import synthetic_pair_batch, write_synthetic_dataset
from .transforms import preprocess_pair_batch, preprocess_sequence_batch

__all__ = ["DataLoader", "IMG_EXTENSIONS", "create_dataloader",
           "decoder_in_use", "find_aligned_pairs", "find_temporal_sequences",
           "make_dataset", "preprocess_pair_batch",
           "preprocess_sequence_batch", "synthetic_pair_batch",
           "write_synthetic_dataset"]
