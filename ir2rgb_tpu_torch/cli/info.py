"""Inspect the on-disk artifacts — ``python -m ir2rgb_tpu_torch.cli.info``,
the port of ``ir2rgb_tpu/cli/info.py``.

One command answers "what is this file/run?" for every artifact kind the
port produces or consumes:

    python -m ir2rgb_tpu_torch.cli.info run_dir/      # config, checkpoint steps/epochs
    python -m ir2rgb_tpu_torch.cli.info model.ir2rgb  # sealed artifact: kind, geometry
    python -m ir2rgb_tpu_torch.cli.info G.pth         # torch checkpoint: layer table
    python -m ir2rgb_tpu_torch.cli.info clip.avi      # video: frames/fps/codec/size

A run directory is the port's (``checkpoint/manager.py``'s ``ckpt/`` of
``<step>.pt`` files and ``epochs.json``). An artifact is read from its
zip and ``meta.json`` only, so the JAX package's artifacts (StableHLO
programs) are described too, with their program format. Prints
human-readable text; ``--json`` emits one JSON object instead (for
scripts). It reads files only: it needs no card.
"""

from __future__ import annotations

import json
import os
import sys


def inspect_path(path: str) -> dict:
    """Classify and summarize ``path``; returns a JSON-able dict with a
    ``kind`` field (run_dir | artifact | torch_checkpoint | video)."""
    if os.path.isdir(path):
        return _inspect_run_dir(path)
    low = path.lower()
    if low.endswith(".ir2rgb"):
        return _inspect_artifact(path)
    if low.endswith(".avi"):
        return _inspect_video(path)
    if low.endswith((".pth", ".pt")):
        return _inspect_torch(path)
    raise SystemExit(
        f"don't know how to inspect {path!r} — expected a run directory, "
        f".ir2rgb artifact, .pth torch checkpoint, or .avi video")


def _inspect_run_dir(path: str) -> dict:
    if not (os.path.exists(os.path.join(path, "config.json"))
            or os.path.isdir(os.path.join(path, "ckpt"))):
        raise SystemExit(
            f"{path} is a directory but not an ir2rgb run dir (no "
            f"config.json or ckpt/ inside)")
    out: dict = {"kind": "run_dir", "path": path}
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as fh:
            cfg = json.load(fh)
        m = cfg.get("model", {})
        out["model"] = {k: m.get(k) for k in
                        ("model", "net_g", "net_d", "ngf", "ndf",
                         "input_nc", "output_nc", "label_nc") if k in m}
        out["data"] = {k: cfg.get("data", {}).get(k) for k in
                       ("dataroot", "load_size", "crop_size",
                        "batch_size", "dataset_mode")}
    ckpt_dir = os.path.join(path, "ckpt")
    if os.path.isdir(ckpt_dir):
        from ir2rgb_tpu_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(ckpt_dir)
        out["checkpoint_steps"] = sorted(int(s) for s in mgr.all_steps())
        epochs_path = os.path.join(ckpt_dir, "epochs.json")
        if os.path.exists(epochs_path):
            with open(epochs_path) as fh:
                out["epoch_labels"] = json.load(fh)
    loss_log = os.path.join(path, "loss_log.txt")
    if os.path.exists(loss_log):
        with open(loss_log) as fh:
            lines = fh.read().strip().splitlines()
        if lines:
            out["loss_log_lines"] = len(lines)
            out["last_loss_line"] = lines[-1]
    return out


def _inspect_artifact(path: str) -> dict:
    import zipfile
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        names = zf.namelist()
        param_bytes = sum(zi.file_size for zi in zf.infolist()
                          if zi.filename.startswith("param_"))
        program_bytes = zf.getinfo("program.bin").file_size
    h, w = meta["frame_hw"]
    return {
        "kind": "artifact", "path": path,
        "artifact_kind": ("multistream" if meta.get("multistream")
                          else "single-stream"),
        "temporal": meta["temporal"],
        "frame_hw": [h, w],
        "slots" if meta.get("multistream") else "batch": meta["batch"],
        "input_nc": meta["input_nc"],
        "output_nc": meta["output_nc"],
        "label_nc": meta.get("label_nc", 0),
        "carry_c": meta["carry_c"],
        "platforms": meta["platforms"],
        "format_version": meta["format_version"],
        # the JAX package's artifacts carry none of these three
        "program_format": meta.get("program_format", "jax.export"),
        "compute_dtype": meta.get("compute_dtype"),
        "quant": meta.get("quant"),
        "params": len(meta["param_paths"]),
        "param_mbytes": round(param_bytes / 1e6, 1),
        "program_mbytes": round(program_bytes / 1e6, 1),
        "file_mbytes": round(os.path.getsize(path) / 1e6, 1),
        "files": len(names),
    }


def _inspect_torch(path: str) -> dict:
    import pickle

    import torch
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        # weights_only refuses full pickled nn.Modules (torch.save(model))
        # — unpickling those executes arbitrary code, which an inspection
        # tool must never do on an untrusted file
        raise SystemExit(
            f"{path} is not a plain state_dict checkpoint (torch.load"
            f"(weights_only=True) failed: {e}). If it is a whole pickled "
            f"module, re-save its weights in a trusted environment with "
            f"torch.save(model.state_dict(), ...) and inspect that.")
    if not isinstance(sd, dict):
        raise SystemExit(f"{path} unpickled to {type(sd).__name__}, not "
                         f"a state_dict")
    n_params = sum(int(v.numel()) for v in sd.values()
                   if hasattr(v, "numel"))
    convs = [k for k in sd if k.endswith(".weight")
             and getattr(sd[k], "ndim", 0) == 4]
    return {
        "kind": "torch_checkpoint", "path": path,
        "tensors": len(sd),
        "parameters": n_params,
        "conv_layers": len(convs),
        "first_keys": list(sd)[:6],
        "mbytes": round(os.path.getsize(path) / 1e6, 1),
    }


def _inspect_video(path: str) -> dict:
    from ir2rgb_tpu_torch.data.video import avi_index, avi_native_size
    idx = avi_index(path)
    h, w = avi_native_size(path)
    return {
        "kind": "video", "path": path,
        "frames": idx.n,
        "fps": round(idx.fps, 3),
        "frame_hw": [h, w],
        "duration_s": round(idx.n / idx.fps, 2) if idx.fps else None,
        "codec": "MJPEG",
        "mbytes": round(os.path.getsize(path) / 1e6, 1),
    }


def _print_human(info: dict) -> None:
    kind = info.pop("kind")
    path = info.pop("path")
    print(f"{kind}: {path}")
    for k, v in info.items():
        if isinstance(v, dict):
            print(f"  {k}:")
            for kk, vv in v.items():
                print(f"    {kk}: {vv}")
        else:
            print(f"  {k}: {v}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    if len(argv) != 1:
        raise SystemExit("usage: python -m ir2rgb_tpu_torch.cli.info "
                         "[--json] <run_dir | model.ir2rgb | G.pth | "
                         "clip.avi>")
    info = inspect_path(argv[0])
    if as_json:
        print(json.dumps(info))
    else:
        _print_human(info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
