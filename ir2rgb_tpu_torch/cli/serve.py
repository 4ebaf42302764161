"""Serving daemon of the port — ``python -m ir2rgb_tpu_torch.cli.serve``,
the counterpart of ``ir2rgb_tpu/cli/serve.py``: load the generator's
weights once, then translate frames arriving over TCP from up to N
concurrent clients, each with its own temporal carry, batched into one
tick (``infer/multistream.py``; protocol and client in
``infer/server.py``).

    python -m ir2rgb_tpu_torch.cli.serve --preset temporal_512 \\
        --train.name run1 --infer.serve_port 7788 --infer.serve_slots 8 \\
        [--infer.use_ema true] [--torch_g G.pth] [--serve.hw 512x512] \\
        [--device cpu]
    python -m ir2rgb_tpu_torch.cli.serve --artifact run1.ir2rgb \\
        --infer.serve_port 7788 [--infer.serve_slots 4] [--device cpu]

It serves on the CUDA device; ``--device cpu`` serves the port's plain
PyTorch path on the CPU. An fp32 model (the presets' default) runs its
convolutions without TF32, as the JAX package runs f32 convolutions at
HIGHEST precision; ``--model.compute_dtype bf16`` serves in bf16. Frame
geometry defaults to ``--data.crop_size`` square; ``--serve.hw HxW``
sets another. ``--infer.quant`` serves in a quantized mode
(``nn/quant.py``).

``--artifact`` serves a sealed multi-stream artifact (``cli.export
--slots N``; ``infer/export.py``): no model code, no checkpoint. Its
geometry, slot count, weights, dtype and quantization are sealed, so the
flags that would silently not apply are refused (``--torch_g``,
``--infer.quant``, ``--serve.hw``, ``--infer.use_ema``,
``--infer.which_epoch``). An explicit ``--infer.serve_slots`` caps the
attachable streams at or below the sealed batch; without it every sealed
slot serves.
"""

from __future__ import annotations

import dataclasses
import os
import sys


def main(argv=None) -> int:
    from ir2rgb_tpu_torch.cli.common import load_generator_params, pop_flag
    from ir2rgb_tpu_torch.config import parse_cli
    from ir2rgb_tpu_torch.infer.multistream import MultiStreamServer
    from ir2rgb_tpu_torch.infer.server import FrameServer
    from ir2rgb_tpu_torch.runtime import resolve_device, set_parity_mode
    from ir2rgb_tpu_torch.train import create_model

    argv = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device(pop_flag(argv, "--device"))
    torch_g = pop_flag(argv, "--torch_g")
    artifact = pop_flag(argv, "--artifact")
    hw_flag = pop_flag(argv, "--serve.hw")
    # the config default (8) must not cap a sealed artifact with more
    # slots: only an explicit flag caps
    slots_explicit = any(a.split("=", 1)[0] == "--infer.serve_slots"
                         for a in argv)
    cfg = parse_cli(argv)
    if cfg.model.compute_dtype == "float32":
        # full-fp32 convolutions, as the JAX package's HIGHEST precision
        set_parity_mode()

    if artifact is not None:
        if torch_g is not None:
            raise SystemExit("--artifact and --torch_g are mutually "
                             "exclusive (the artifact seals its weights)")
        if cfg.infer.quant != "none":
            raise SystemExit(
                "--infer.quant has no effect on a sealed artifact "
                "(quantization is baked at export: cli.export "
                "--infer.quant int8 --slots N)")
        if hw_flag:
            raise SystemExit("--serve.hw has no effect on a sealed "
                             "artifact (geometry is baked at export)")
        if cfg.infer.use_ema:
            raise SystemExit("--infer.use_ema has no effect on a sealed "
                             "artifact (export the EMA weights instead)")
        if cfg.infer.which_epoch != "latest":
            raise SystemExit("--infer.which_epoch has no effect on a "
                             "sealed artifact (it has no checkpoint "
                             "directory; export the epoch you want)")
        srv = MultiStreamServer.from_artifact(
            artifact,
            n_slots=cfg.infer.serve_slots if slots_explicit else None,
            clamp=True, device=device)
        h, w = srv.frame_hw
        label = f"artifact {os.path.basename(artifact)}"
    else:
        # serving needs no VGG
        cfg = cfg.replace(loss=dataclasses.replace(cfg.loss,
                                                   no_vgg_loss=True))
        if hw_flag:
            try:
                h, w = (int(v) for v in hw_flag.lower().split("x"))
            except ValueError:
                raise SystemExit(f"--serve.hw expects HxW (e.g. 512x512), "
                                 f"got {hw_flag!r}")
        else:
            h = w = cfg.data.crop_size
        model = create_model(cfg, device=device, steps_per_epoch=1,
                             seed=cfg.train.seed)
        model.netG.load_state_dict(load_generator_params(cfg, model,
                                                         torch_g))
        srv = MultiStreamServer(model, (h, w),
                                n_slots=cfg.infer.serve_slots)
        label = f"{cfg.model.model}/{cfg.model.net_g}"

    fs = FrameServer(srv, host=cfg.infer.serve_host,
                     port=cfg.infer.serve_port,
                     encode=cfg.infer.serve_encode,
                     quality=cfg.infer.serve_quality,
                     tick_ms=cfg.infer.serve_tick_ms,
                     max_pending=cfg.infer.serve_max_pending)
    fs.start()  # resolves an ephemeral port before the banner
    print(f"serving {label} at "
          f"{fs.host}:{fs.port}  frame {h}x{w}x{srv.in_nc} -> "
          f"{fs.out_nc}ch  slots {srv.n_slots} "
          f"(physical {srv.physical_slots})  encode {fs.encode}",
          flush=True)
    fs.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
