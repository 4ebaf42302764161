"""Test-time feature control for the pix2pixHD netE path — the port of
``ir2rgb_tpu/infer/features.py``:

1. **Precompute**: run netE over a dataset and keep one pooled feature
   vector per (image, instance) (``collect_dataset_features``, through
   ``nn.encoders.instance_feature_table`` on the model's device);
2. **Cluster**: K-means the vectors into style centroids (``kmeans``,
   plain numpy on the host, a copy of the JAX package's);
3. **Sample**: give every instance of a test frame a centroid drawn at
   random (``sample_feature_map``: one draw per hash segment from an
   explicit ``torch.Generator``, gathered back through the id map).

The clustering is global (one centroid table), not per semantic class.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ir2rgb_tpu_torch.nn.encoders import (
    hash_instance_ids,
    instance_feature_table,
)


def batch_instance_features(model, image: torch.Tensor, inst: torch.Tensor
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Pooled netE features of one batch: (B, num_instances, C) means and
    (B, num_instances) pixel counts, on the host."""
    feat = model.encode_features(image)
    means, cnts, _ = instance_feature_table(
        feat, inst.to(feat.device), model.enc_cfg.num_instances)
    return means.cpu().numpy(), cnts.cpu().numpy()


def collect_dataset_features(model, loader: Iterable,
                             max_items: Optional[int] = None) -> np.ndarray:
    """One feature vector per (image, instance) over ``loader``'s host
    batches: netE encodes each batch's real target image (uint8 ``b``,
    normalised on the device), pooled per instance of ``inst``; the
    populated segments are kept. Returns (N, feat_num) float32."""
    out = []
    seen = 0
    for batch in loader:
        if "inst" not in batch:
            raise ValueError(
                "collect_dataset_features needs instance maps "
                "(<phase>Inst/ folder) — use_instance_feat datasets only")
        b = torch.from_numpy(np.ascontiguousarray(batch["b"])).to(
            model.device).to(torch.float32) / 127.5 - 1.0
        inst = torch.from_numpy(np.ascontiguousarray(batch["inst"]))
        means, cnts = batch_instance_features(model, b, inst)
        for i in range(means.shape[0]):
            out.append(means[i][cnts[i] > 0])
        seen += means.shape[0]
        if max_items is not None and seen >= max_items:
            break
    if not out:
        raise ValueError("dataset produced no instance features")
    return np.concatenate(out, axis=0).astype(np.float32)


def kmeans(x: np.ndarray, k: int, iters: int = 50,
           seed: int = 0) -> np.ndarray:
    """Plain-numpy K-means (k-means++ init). x: (N, C) -> (k', C)
    centers, k' = min(k, number of distinct points)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    rng = np.random.RandomState(seed)
    k = min(k, n)
    # k-means++ seeding
    centers = [x[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min(
            ((x[:, None, :] - np.asarray(centers)[None]) ** 2).sum(-1),
            axis=1)
        total = d2.sum()
        if total <= 0:  # all remaining points coincide with a center
            break
        centers.append(x[rng.choice(n, p=d2 / total)])
    centers = np.asarray(centers)
    for _ in range(iters):
        assign = np.argmin(
            ((x[:, None, :] - centers[None]) ** 2).sum(-1), axis=1)
        new = np.array([
            x[assign == j].mean(0) if np.any(assign == j) else centers[j]
            for j in range(len(centers))])
        if np.allclose(new, centers):
            break
        centers = new
    return centers.astype(np.float32)


def save_clusters(path: str, centers: np.ndarray) -> None:
    np.savez(path, centers=np.asarray(centers, np.float32))


def load_clusters(path: str) -> np.ndarray:
    with np.load(path) as z:
        return np.asarray(z["centers"], np.float32)


def draw_centroids(batch: int, k: int, generator: torch.Generator,
                   num_instances: int = 1024) -> torch.Tensor:
    """One centroid index in [0, k) per (image, hash segment), drawn from
    ``generator`` on its device: (batch, num_instances) int64."""
    return torch.randint(0, k, (batch, num_instances), generator=generator,
                         device=generator.device)


def feature_map(inst: torch.Tensor, centers: torch.Tensor,
                choice: torch.Tensor,
                num_instances: int = 1024) -> torch.Tensor:
    """Every pixel takes the centroid its hash segment drew: inst
    (B, H, W) ids, centers (k, C), choice (B, num_instances) indices ->
    (B, H, W, C) float32 on ``inst``'s device."""
    b, h, w = inst.shape
    centers = centers.to(inst.device, torch.float32)
    per_segment = centers[choice.to(inst.device)]  # (B, num_instances, C)
    ids = hash_instance_ids(inst.reshape(b, h * w), num_instances)
    out = torch.gather(per_segment, 1, ids[..., None].expand(
        b, h * w, centers.shape[1]))
    return out.reshape(b, h, w, centers.shape[1])


def sample_feature_map(inst: torch.Tensor, centers: torch.Tensor,
                       generator: torch.Generator,
                       num_instances: int = 1024) -> torch.Tensor:
    """A random centroid for every instance, broadcast over its pixels
    (the reference's sample_features): :func:`draw_centroids` from
    ``generator``, then :func:`feature_map`. An instance's pixels always
    agree; distinct instances draw independently up to hash collisions.
    Returns (B, H, W, C) float32."""
    choice = draw_centroids(inst.shape[0], centers.shape[0], generator,
                            num_instances)
    return feature_map(inst, centers, choice, num_instances)
