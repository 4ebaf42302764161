"""Precompute and cluster instance style features — ``python -m
ir2rgb_tpu_torch.cli.precompute_feats``, the counterpart of
``ir2rgb_tpu/cli/precompute_feats.py`` (the reference's
``precompute_feature_maps`` pass): run a trained netE over a dataset's
real frames, pool one style vector per instance, K-means them into
``--infer.n_clusters`` centroids and save the table for
``cli.infer --infer.cluster_path``.

    python -m ir2rgb_tpu_torch.cli.precompute_feats \\
        --train.name exp1 --train.checkpoints_dir ./ckpts \\
        --data.dataroot ./datasets/d [--out feats.npz] [--device cpu]

netE's weights come from the run's checkpoint at
``--infer.which_epoch``. It runs on the CUDA device; ``--device cpu``
runs the port's plain PyTorch path on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    from ir2rgb_tpu_torch.cli.common import pop_flag

    device_flag = pop_flag(argv, "--device")
    out_path = pop_flag(argv, "--out") or "features_clustered.npz"
    if out_path.startswith("--"):
        raise SystemExit("--out needs a path argument")

    from ir2rgb_tpu_torch.checkpoint import CheckpointManager
    from ir2rgb_tpu_torch.config import parse_cli
    from ir2rgb_tpu_torch.data import DataLoader
    from ir2rgb_tpu_torch.infer.features import (
        collect_dataset_features,
        kmeans,
        save_clusters,
    )
    from ir2rgb_tpu_torch.runtime import resolve_device, set_parity_mode
    from ir2rgb_tpu_torch.train import create_model

    device = resolve_device(device_flag)
    cfg = parse_cli(argv)
    if not cfg.model.use_instance_feat:
        raise SystemExit(
            "precompute_feats needs a use_instance_feat model "
            "(--model.use_instance_feat true)")
    if cfg.model.compute_dtype == "float32":
        # full-fp32 convolutions, as the JAX package's HIGHEST precision
        set_parity_mode()
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))

    loader = DataLoader(cfg, phase=cfg.data.phase, shuffle=False)
    model = create_model(cfg, device=device,
                         steps_per_epoch=max(len(loader), 1),
                         seed=cfg.train.seed)
    ckpt = CheckpointManager(os.path.join(cfg.run_dir(), "ckpt"))
    state = ckpt.restore(ckpt.step_for_label(cfg.infer.which_epoch))
    model.netE.load_state_dict(state["netE"])

    feats = collect_dataset_features(model, loader.epoch())
    centers = kmeans(feats, cfg.infer.n_clusters)
    save_clusters(out_path, centers)
    print(f"clustered {feats.shape[0]} instance features "
          f"({feats.shape[1]}-d) -> {len(centers)} centers -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
