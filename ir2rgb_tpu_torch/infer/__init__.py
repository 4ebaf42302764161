"""Inference and serving: batch-1 streaming (``stream``), quality metrics
(``metrics``), multi-stream batched serving (``multistream``), the TCP
daemon's protocol (``server``), netE's test-time features
(``features``) and sealed serving artifacts (``export``).

Exports resolve on first use (``_lazy.py``), so the protocol client
(``infer.server``) imports without torch.
"""

_EXPORTS = {
    "ExportedStream": ".export",
    "FrameClient": ".server",
    "FrameServer": ".server",
    "MultiStreamServer": ".multistream",
    "StreamingGenerator": ".stream",
    "collect_dataset_features": ".features",
    "export_multistream_artifact": ".export",
    "export_serving_artifact": ".export",
    "flicker": ".metrics",
    "host_to_wire_u8": ".wire",
    "kmeans": ".features",
    "label2im": ".stream",
    "load_clusters": ".features",
    "load_multistream_artifact": ".export",
    "load_serving_artifact": ".export",
    "psnr": ".metrics",
    "sample_feature_map": ".features",
    "save_clusters": ".features",
    "single_frame_infer": ".stream",
    "ssim": ".metrics",
    "tensor2im": ".stream",
    "translate_clip": ".stream",
}

__all__ = sorted(_EXPORTS)

from ir2rgb_tpu_torch._lazy import lazy_exports  # noqa: E402

__getattr__ = lazy_exports(__name__, _EXPORTS, globals())
