"""Inference entry point of the port — ``python -m
ir2rgb_tpu_torch.cli.infer``, the counterpart of ``ir2rgb_tpu/cli/infer.py``
(the reference ``test.py``): sequential batch-1 translation of a frame
folder, PNG outputs and an HTML gallery, PSNR / SSIM against ground
truth where there is some, and optionally an MJPEG video a sequence.

    python -m ir2rgb_tpu_torch.cli.infer --preset pix2pixhd_512 \\
        --data.dataroot /data/ir2rgb --train.name run1 \\
        [--infer.which_epoch 10] [--torch_g G.pth] [--infer.video out.avi] \\
        [--device cpu]

The generator comes from the run's checkpoint at ``--infer.which_epoch``
(``--infer.use_ema`` for its EMA shadow), or from a reference ``.pth``
with ``--torch_g``. It runs on the CUDA device; ``--device cpu`` runs
the port's plain PyTorch path on the CPU. An fp32 model (the presets'
default) runs its convolutions without TF32, as the JAX package runs f32
convolutions at HIGHEST precision. Temporal models stream frame by frame
with the carry on the device, reset at every sequence boundary. Not
ported yet, and refused: netE's feature inputs
(``--infer.use_encoded_image``, ``--infer.cluster_path``; ROADMAP A12),
the CycleGAN model and its reconstruction column (A13), and quantized
serving (A11).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np


def _refuse_unported(cfg, single: bool) -> None:
    if single and cfg.infer.use_encoded_image:
        raise SystemExit("--infer.use_encoded_image needs ground-truth "
                         "images; dataset_mode=single has none")
    if cfg.infer.use_encoded_image or cfg.infer.cluster_path:
        raise SystemExit("--infer.use_encoded_image / --infer.cluster_path "
                         "need netE, which is not ported yet (ROADMAP A12)")
    if cfg.model.model == "cycle_gan":
        raise SystemExit("model=cycle_gan (its reconstruction column "
                         "included) is not ported yet (ROADMAP A13)")
    if cfg.infer.quant != "none":
        raise SystemExit(f"--infer.quant {cfg.infer.quant}: quantized "
                         "serving is not ported yet (ROADMAP A11)")


def main(argv=None) -> int:
    import torch

    from ir2rgb_tpu_torch.cli.common import load_generator_params, pop_flag
    from ir2rgb_tpu_torch.config import parse_cli
    from ir2rgb_tpu_torch.data import DataLoader, preprocess_pair_batch
    from ir2rgb_tpu_torch.data.video import sequence_key
    from ir2rgb_tpu_torch.infer.metrics import psnr, ssim
    from ir2rgb_tpu_torch.infer.stream import (
        StreamingGenerator,
        label2im,
        tensor2im,
    )
    from ir2rgb_tpu_torch.nn.encoders import instance_edges
    from ir2rgb_tpu_torch.obs import HTMLPage, MJPEGAviWriter, Visualizer
    from ir2rgb_tpu_torch.runtime import resolve_device, set_parity_mode
    from ir2rgb_tpu_torch.train import create_model

    argv = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device(pop_flag(argv, "--device"))
    torch_g = pop_flag(argv, "--torch_g")
    cfg = parse_cli(argv)
    if cfg.model.compute_dtype == "float32":
        # full-fp32 convolutions, as the JAX package's HIGHEST precision
        set_parity_mode()
    # test-time invariants (reference TestOptions): sequential batch-1
    # frames, no augmentation. Temporal models stream frame by frame with
    # the carry on the device, so a temporal dataset is read as aligned
    # pairs in sequence order; dataset_mode single (input-only folders)
    # is kept. Serving needs no VGG.
    single = cfg.data.dataset_mode == "single"
    _refuse_unported(cfg, single)
    cfg = cfg.replace(
        data=dataclasses.replace(
            cfg.data, phase="test", serial_batches=True, no_flip=True,
            batch_size=1, dataset_mode="single" if single else "aligned"),
        loss=dataclasses.replace(cfg.loss, no_vgg_loss=True))

    loader = DataLoader(cfg, phase="test", shuffle=False)
    model = create_model(cfg, device=device,
                         steps_per_epoch=max(len(loader), 1),
                         seed=cfg.train.seed)
    model.netG.load_state_dict(load_generator_params(cfg, model, torch_g))

    # crop only in crop-style preprocess modes (as cli/train.py and the
    # reference test path): scale_width / none run the whole decoded frame
    if "crop" in cfg.data.preprocess:
        crop = cfg.data.crop_size
        th, tw = loader.target_hw
        if th < crop or tw < crop:
            raise ValueError(
                f"decoded frames are {th}x{tw}, smaller than "
                f"crop_size={crop}; lower --data.crop_size or use a "
                f"non-crop preprocess mode")
        size_hw = (crop, crop)
    else:
        crop = None
        size_hw = loader.target_hw
    stream = StreamingGenerator(model, size_hw)

    results_dir = os.path.join(cfg.infer.results_dir, cfg.train.name,
                               f"{cfg.data.phase}_{cfg.infer.which_epoch}")
    page = HTMLPage(results_dir, f"Results: {cfg.train.name}")
    vis = Visualizer(results_dir, cfg.train.name)
    label_nc = cfg.model.label_nc

    # --infer.video: the generated frames as MJPEG/AVI, one file a source
    # sequence (the 2nd and later suffixed with the sequence's name)
    video_paths = []

    def open_video(video_dir: str) -> MJPEGAviWriter:
        base = cfg.infer.video
        if video_paths:
            # the sequence key is a directory for frame folders and the
            # container file for AVI sources: clip2.avi -> out_clip2.avi
            seq = os.path.basename(video_dir)
            if seq.lower().endswith(".avi"):
                seq = os.path.splitext(seq)[0]
            root, ext = os.path.splitext(base)
            base = f"{root}_{seq}{ext or '.avi'}"
        video_paths.append(base)
        return MJPEGAviWriter(base, fps=cfg.infer.video_fps,
                              quality=cfg.infer.video_quality)

    def aspect(img: np.ndarray) -> np.ndarray:
        # reference --aspect_ratio: stretch the output width for display
        if cfg.infer.aspect_ratio == 1.0:
            return img
        from PIL import Image
        h, w = img.shape[:2]
        if img.ndim == 3 and img.shape[2] == 1:  # PIL rejects (H, W, 1)
            img = img[..., 0]
        return np.asarray(Image.fromarray(img).resize(
            (int(w * cfg.infer.aspect_ratio), h), Image.BICUBIC))

    def on_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    psnrs, ssims = [], []
    how_many = cfg.infer.how_many or float("inf")
    count = 0
    video_writer = None
    prev_video = None
    for host_batch in loader.epoch():
        if count >= how_many:
            break
        # a multi-video dataroot restarts the carry (and the video file)
        # at each sequence boundary, as the reference runs sequences
        # independently
        video = sequence_key(host_batch["paths"][0][0])
        if prev_video is not None and video != prev_video:
            stream.reset()
            if video_writer is not None:
                video_writer.close()
                video_writer = open_video(video)
        if cfg.infer.video and video_writer is None:
            video_writer = open_video(video)
        prev_video = video
        batch = preprocess_pair_batch(
            on_device(host_batch["a"]), on_device(host_batch["b"]), None,
            crop_size=crop, train=False,
            inst=(on_device(host_batch["inst"]) if "inst" in host_batch
                  else None),
            label_a=label_nc > 0)
        edges = None
        if "inst" in batch and cfg.model.use_instance_edges:
            edges = instance_edges(batch["inst"])
        input_img = (label2im(batch["a"], label_nc) if label_nc > 0
                     else tensor2im(batch["a"]))
        fake = stream.push_device(batch["a"], edges=edges)
        if not single:  # single mode: batch['b'] is the input, not truth
            psnrs.append(float(psnr(fake, batch["b"])))
            ssims.append(float(ssim(fake, batch["b"])))
        visuals = {"input": aspect(input_img),
                   "generated": aspect(tensor2im(fake))}
        if video_writer is not None:
            video_writer.add(visuals["generated"])
        if not single:
            visuals["target"] = aspect(tensor2im(batch["b"]))
        vis.save_images(page, visuals, host_batch["paths"][0][0])
        count += 1
    vis.flush()  # the gallery's images are on disk before the page
    page.save()
    if video_writer is not None:
        video_writer.close()
        print(f"video: {', '.join(video_paths)}", flush=True)
    if psnrs:
        print(f"frames: {count}  PSNR: {np.mean(psnrs):.2f} dB  "
              f"SSIM: {np.mean(ssims):.4f}", flush=True)
    elif single:
        print(f"frames: {count}  (single mode: no ground truth, "
              f"no PSNR/SSIM)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
