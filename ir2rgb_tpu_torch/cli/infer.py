"""Inference entry point of the port — ``python -m
ir2rgb_tpu_torch.cli.infer``, the counterpart of ``ir2rgb_tpu/cli/infer.py``
(the reference ``test.py``): sequential batch-1 translation of a frame
folder, PNG outputs and an HTML gallery, PSNR / SSIM against ground
truth where there is some, and optionally an MJPEG video a sequence.

    python -m ir2rgb_tpu_torch.cli.infer --preset pix2pixhd_512 \\
        --data.dataroot /data/ir2rgb --train.name run1 \\
        [--infer.which_epoch 10] [--torch_g G.pth] [--infer.video out.avi] \\
        [--infer.quant int8_mixed] [--device cpu]

The generator comes from the run's checkpoint at ``--infer.which_epoch``
(``--infer.use_ema`` for its EMA shadow), or from a reference ``.pth``
with ``--torch_g``. It runs on the CUDA device; ``--device cpu`` runs
the port's plain PyTorch path on the CPU. An fp32 model (the presets'
default) runs its convolutions without TF32, as the JAX package runs f32
convolutions at HIGHEST precision. Temporal models stream frame by frame
with the carry on the device, reset at every sequence boundary. A
CycleGAN serves ``G_A``; its gallery adds the reconstruction column,
``G_B`` of the translation, when the checkpoint holds ``G_B`` (a
``--torch_g`` import serves fake-only galleries). ``--infer.quant``
serves in a quantized mode (``nn/quant.py``). A ``use_instance_feat``
model conditions on netE's features where the frame has an instance
map: with ``--infer.use_encoded_image`` those of the real target
(netE's weights from the run checkpoint), with ``--infer.cluster_path``
a centroid of ``cli.precompute_feats``'s table drawn per instance (the
draws of frame i from seed i), else zeros.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np


def _refuse_misapplied(cfg, single: bool) -> None:
    """The JAX CLI's refusals of feature flags that would serve zeros
    labelled as styles (``ir2rgb_tpu/cli/infer.py:47-49``, ``:80-90``)."""
    if single and cfg.infer.use_encoded_image:
        raise SystemExit("--infer.use_encoded_image needs ground-truth "
                         "images; dataset_mode=single has none")
    if ((cfg.infer.use_encoded_image or cfg.infer.cluster_path)
            and not cfg.model.use_instance_feat):
        raise SystemExit(
            "--infer.use_encoded_image/--infer.cluster_path need a "
            "use_instance_feat model (this run has no netE)")
    if cfg.infer.use_encoded_image and cfg.infer.cluster_path:
        raise SystemExit(
            "--infer.use_encoded_image and --infer.cluster_path are "
            "mutually exclusive (encode the real image OR sample "
            "clustered styles)")


def main(argv=None) -> int:
    import torch

    from ir2rgb_tpu_torch.cli.common import load_generator_params, pop_flag
    from ir2rgb_tpu_torch.config import parse_cli
    from ir2rgb_tpu_torch.data import DataLoader, preprocess_pair_batch
    from ir2rgb_tpu_torch.data.video import sequence_key
    from ir2rgb_tpu_torch.infer.features import sample_feature_map
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
    _refuse_misapplied(cfg, single)
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
    centers = None
    if cfg.infer.use_encoded_image:
        enc = load_generator_params(cfg, model, torch_g, "netE")
        if enc is None:
            raise SystemExit("--infer.use_encoded_image needs netE's "
                             "weights from a run checkpoint; --torch_g "
                             "imports the generator only")
        model.netE.load_state_dict(enc)
    elif cfg.infer.cluster_path:
        from ir2rgb_tpu_torch.infer.features import load_clusters
        centers = torch.from_numpy(load_clusters(cfg.infer.cluster_path)
                                   ).to(device)
    # a CycleGAN's gallery reconstructs the input from the translation
    # when the weights hold G_B (cli/infer.py:109-117 of the JAX package)
    reverse = None
    if cfg.model.model == "cycle_gan":
        reverse = load_generator_params(cfg, model, torch_g, "netG_B")
        if reverse is not None:
            model.netG_B.load_state_dict(reverse)

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
        # test-time feature control: the real target's netE style, or a
        # clustered style per instance; zeros without an instance map
        feat = edges = None
        if "inst" in batch:
            if cfg.infer.use_encoded_image:
                feat = model.encode_features(batch["b"], batch["inst"])
            elif centers is not None:
                feat = sample_feature_map(
                    batch["inst"], centers,
                    torch.Generator(device).manual_seed(count),
                    model.enc_cfg.num_instances)
            if cfg.model.use_instance_edges:
                edges = instance_edges(batch["inst"])
        input_img = (label2im(batch["a"], label_nc) if label_nc > 0
                     else tensor2im(batch["a"]))
        fake = stream.push_device(batch["a"], feat=feat, edges=edges)
        if not single:  # single mode: batch['b'] is the input, not truth
            psnrs.append(float(psnr(fake, batch["b"])))
            ssims.append(float(ssim(fake, batch["b"])))
        visuals = {"input": aspect(input_img),
                   "generated": aspect(tensor2im(fake))}
        if video_writer is not None:
            video_writer.add(visuals["generated"])
        if reverse is not None:
            visuals["reconstructed"] = aspect(tensor2im(
                model.generate(fake, direction="BtoA")))
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
