"""Data pipeline: folder discovery, host decode and prefetch (copies of
the JAX package's host modules) and the device-side paired augmentation
(``transforms``, rewritten in PyTorch).

Exports resolve on first use (``_lazy.py``): ``data.video`` and
``data.native`` import without torch.
"""

_EXPORTS = {
    "DataLoader": ".loader",
    "IMG_EXTENSIONS": ".folder",
    "create_dataloader": ".loader",
    "decoder_in_use": ".native",
    "find_aligned_pairs": ".folder",
    "find_temporal_sequences": ".folder",
    "make_dataset": ".folder",
    "preprocess_pair_batch": ".transforms",
    "preprocess_sequence_batch": ".transforms",
    "synthetic_pair_batch": ".synthetic",
    "write_synthetic_dataset": ".synthetic",
}

__all__ = sorted(_EXPORTS)

from ir2rgb_tpu_torch._lazy import lazy_exports  # noqa: E402

__getattr__ = lazy_exports(__name__, _EXPORTS, globals())
