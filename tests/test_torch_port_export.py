"""Sealed serving artifacts of the port on the CPU: ``infer/export.py``,
``cli/export.py``, ``MultiStreamServer.from_artifact`` and ``cli.serve
--artifact``, the counterparts of tests/test_export.py and the artifact
tests of tests/test_serve.py, and the kernels as ``torch.library`` ops.

- An artifact's frames equal the live path's bit for bit (the same aten
  ops and the same plain kernel versions run in the program): a temporal
  and a single-frame model, fp32 and bf16, every quant mode, through
  ``reset()`` and the pipelined ``stream()``; the multi-stream artifact's
  ticks equal the live server's.
- The port's artifact holds to the JAX package's on the same weights
  (``checkpoint/from_jax.py``) at the bars of test_torch_port_stream.py:
  uint8 within 1 LSB, the carry within 1e-4.
- Loading imports no model code, and refuses what JAX refuses, and a
  JAX artifact.

Small shapes (32x32, ngf 8) and one torch thread: each export traces in
about a second."""

import io
import json
import os
import pathlib
import selectors
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir2rgb_tpu.config import Config as JConfig
from ir2rgb_tpu.config import DataConfig as JDataConfig
from ir2rgb_tpu.config import LossConfig as JLossConfig
from ir2rgb_tpu.config import ModelConfig as JModelConfig
from ir2rgb_tpu.infer import export as jexport
from ir2rgb_tpu.train import create_model as jax_create_model

from ir2rgb_tpu_torch.checkpoint import (
    CheckpointManager,
    generator_state_dict_from_jax,
)
from ir2rgb_tpu_torch.config import (
    Config,
    DataConfig,
    InferConfig,
    LossConfig,
    ModelConfig,
)
from ir2rgb_tpu_torch.infer import MultiStreamServer, StreamingGenerator
from ir2rgb_tpu_torch.infer.export import (
    export_multistream_artifact,
    export_serving_artifact,
    load_multistream_artifact,
    load_serving_artifact,
)
from ir2rgb_tpu_torch.infer.server import FrameClient
from ir2rgb_tpu_torch.train import create_model

import torch_refs

ROOT = pathlib.Path(__file__).resolve().parents[1]
HW = (32, 32)
ARCH = dict(net_g="resnet_6blocks", net_d="n_layers", ngf=8, ndf=8,
            n_frames_g=2)
CARRY_ATOL = 1e-4  # fp32 port against JAX: summation order only


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU graphs: the full thread pool only contends with the other
    test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(temporal=True, dtype="float32", quant="none", **model):
    return Config(model=ModelConfig(
        model="temporal" if temporal else "pix2pix", compute_dtype=dtype,
        **{**ARCH, **model}),
        data=DataConfig(crop_size=32), loss=LossConfig(no_vgg_loss=True),
        infer=InferConfig(quant=quant))


def _model(temporal=True, dtype="float32", quant="none", **model):
    return create_model(_cfg(temporal, dtype, quant, **model), device="cpu",
                        seed=5)


def _frames(n, seed=0, hw=HW):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*hw, 3) * 255).astype(np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """``exported(temporal, dtype, quant, multistream=0)`` -> (model,
    path): each artifact exported once for the module."""
    cache = {}

    def get(temporal=True, dtype="float32", quant="none", slots=0):
        key = (temporal, dtype, quant, slots)
        if key not in cache:
            model = _model(temporal, dtype, quant)
            path = str(tmp_path_factory.mktemp("art") / "m.ir2rgb")
            if slots:
                export_multistream_artifact(model, HW, path, n_slots=slots)
            else:
                export_serving_artifact(model, HW, path)
            cache[key] = (model, path)
        return cache[key]
    return get


def _rewrite_meta(path, edit):
    with zipfile.ZipFile(path) as zf:
        data = {n: zf.read(n) for n in zf.namelist()}
    meta = json.loads(data["meta.json"])
    edit(meta)
    data["meta.json"] = json.dumps(meta).encode()
    with zipfile.ZipFile(path, "w") as zf:
        for n, b in data.items():
            zf.writestr(n, b)


# ---------------------------------------------------------------------------
# The kernels as torch.library ops
# ---------------------------------------------------------------------------

def _op_cases():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 8, 16)
                         .astype(np.float32))
    _, mean, rstd = torch.ops.ir2rgb.instance_norm_act(x, "relu", 1e-5, 0.2)
    g = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 8, 16)
                         .astype(np.float32))
    return {
        "instance_norm_act": (torch.ops.ir2rgb.instance_norm_act.default,
                              (x, "leaky_relu", 1e-5, 0.2)),
        "instance_norm_act_bwd": (
            torch.ops.ir2rgb.instance_norm_act_bwd.default,
            (x, mean, rstd, g, "tanh", 0.2)),
        "tail_fused": (torch.ops.ir2rgb.tail_fused.default,
                       (x.bfloat16(), torch.randn(7, 7, 16, 3),
                        torch.randn(3))),
        "d2s": (torch.ops.ir2rgb.d2s.default, (x, 4)),
        "s2d": (torch.ops.ir2rgb.s2d.default, (x,)),
    }


@pytest.mark.parametrize("name", ["instance_norm_act",
                                  "instance_norm_act_bwd", "tail_fused",
                                  "d2s", "s2d"])
def test_kernel_ops_pass_opcheck(name):
    """Each C entry point is a custom op whose fake implementation gives
    its CPU implementation's shapes, dtypes and strides, and that traces
    and compiles (``torch.library.opcheck``)."""
    op, args = _op_cases()[name]
    got = torch.library.opcheck(op, args)
    assert set(got.values()) == {"SUCCESS"}, got


def test_d2s_op_output_is_never_a_view_of_its_input():
    """A 1x1 phase tensor permutes to a view of itself; the op copies, as
    a custom op's output may not alias its input."""
    y = torch.randn(1, 1, 1, 8)
    x = torch.ops.ir2rgb.d2s(y, 2)
    assert x.untyped_storage().data_ptr() != y.untyped_storage().data_ptr()
    assert torch.equal(torch.ops.ir2rgb.s2d(x), y)


# ---------------------------------------------------------------------------
# Single-stream artifacts (tests/test_export.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("temporal", [True, False],
                         ids=["temporal", "single_frame"])
def test_artifact_matches_live_path(exported, temporal, dtype):
    """The exported step equals the live StreamingGenerator bit for bit,
    the carry included, through reset(); the pipelined stream equals
    sequential pushes."""
    model, path = exported(temporal, dtype)
    live = StreamingGenerator(model, HW)
    art = load_serving_artifact(path, device="cpu")
    assert art.temporal is temporal
    frames = _frames(4, seed=1)
    pushed = []
    for f in frames:
        pushed.append(art.push(f))
        np.testing.assert_array_equal(pushed[-1], live.push(f))
        if temporal:
            assert torch.equal(art.carry, live.carry)
    art.reset()
    np.testing.assert_array_equal(
        art.push(frames[0]), StreamingGenerator(model, HW).push(frames[0]))
    art.reset()
    piped = list(art.stream(frames))
    assert len(piped) == len(frames)
    for p, want in zip(piped, pushed):
        np.testing.assert_array_equal(p, want)


@pytest.mark.parametrize("quant", ["int8", "int8_mixed", "int8_w"])
def test_quantized_artifact_matches_live_path(exported, quant):
    """Quantization is baked in at export: the program quantizes its
    weights from its params in every call and equals the live quantized
    path (which keeps them) bit for bit, the carry included.
    No cache of the live path (Deconv's rearranged weight, the quantized
    weights, the kept index tensors) holds a tensor of the trace."""
    from ir2rgb_tpu_torch.nn import ops, quant as pquant
    from ir2rgb_tpu_torch.nn.generators import Deconv
    model, path = exported(True, "float32", quant)
    net = model.serving_generator()
    kept = [m._wk[3] for m in net.modules()
            if isinstance(m, Deconv) and m._wk is not None]
    kept += [t for _, entries in pquant._kept.values()
             for v in entries.values()
             for t in (v if isinstance(v, tuple) else (v,))]
    kept += [ops._subpixel_index(8, 8, 3, 1, torch.device("cpu")),
             ops._reflect_index(32, 3, torch.device("cpu"))]
    assert all(type(t) is torch.Tensor for t in kept)
    live = StreamingGenerator(model, HW)
    art = load_serving_artifact(path, device="cpu")
    assert art.meta["quant"] == quant
    for f in _frames(3, seed=2):
        np.testing.assert_array_equal(art.push(f), live.push(f))
        assert torch.equal(art.carry, live.carry)


def test_artifact_is_self_contained(exported):
    """The zip holds the program, meta.json and the weights (stored fp32,
    cast back to their dtype); the program holds no weight of its own:
    they are its inputs, keyed by the generator's reference keys, and its
    graph calls the kernels as ir2rgb ops, a frame's launches of each."""
    model, path = exported(True, "bf16")
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        program = torch.export.load(io.BytesIO(zf.read("program.bin")))
    assert {"program.bin", "meta.json"} <= names
    art = load_serving_artifact(path, device="cpu")
    meta = art.meta
    sd = model.serving_generator().state_dict()
    assert meta["param_paths"] == list(sd)
    assert len(names) == 2 + len(sd)
    assert meta["program_format"] == "torch.export"
    assert meta["frame_hw"] == [32, 32] and meta["temporal"] is True
    assert meta["platforms"] == ["cuda", "cpu"]
    for k, v in sd.items():
        assert torch.equal(art._params[k], v), k
    # no parameter, buffer or example input; the constants are the
    # subpixel deconvs' integer gather indices, no weight
    assert not program.state_dict and program.example_inputs is None
    assert {s.kind.name for s in program.graph_signature.input_specs} <= {
        "USER_INPUT", "CONSTANT_TENSOR"}
    assert not any(c.is_floating_point() for c in program.constants.values())
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function" and str(n.target).startswith("ir2rgb")]
    assert ops.count("ir2rgb.instance_norm_act.default") == 17
    assert ops.count("ir2rgb.d2s.default") == 2
    assert ops.count("ir2rgb.tail_fused.default") == 1


def test_format_version_guard(exported, tmp_path):
    _, src = exported(False)
    path = str(tmp_path / "m.ir2rgb")
    with open(src, "rb") as a, open(path, "wb") as b:
        b.write(a.read())
    _rewrite_meta(path, lambda m: m.update(format_version=999))
    with pytest.raises(ValueError, match="format"):
        load_serving_artifact(path, device="cpu")


def test_program_format_guard(exported, tmp_path):
    """An artifact without the port's program format (a JAX StableHLO
    one) is refused, naming the field."""
    _, src = exported(False)
    path = str(tmp_path / "m.ir2rgb")
    with open(src, "rb") as a, open(path, "wb") as b:
        b.write(a.read())
    _rewrite_meta(path, lambda m: m.pop("program_format"))
    with pytest.raises(ValueError, match="program_format"):
        load_serving_artifact(path, device="cpu")


def test_batched_export_geometry(tmp_path):
    model = _model()
    path = str(tmp_path / "m.ir2rgb")
    export_serving_artifact(model, HW, path, batch=2)
    art = load_serving_artifact(path, device="cpu")
    out = art.push(np.stack(_frames(2, seed=9)))
    assert out.shape == (2, 32, 32, 3) and out.dtype == np.uint8


@pytest.mark.parametrize("model,match", [
    (dict(use_instance_feat=True, nef=4, n_downsample_e=2), "instance maps"),
    (dict(use_instance_edges=True), "instance maps"),
    (dict(label_nc=300), "do not fit the uint8"),
], ids=["features", "edges", "label_nc"])
def test_export_refuses_what_jax_refuses(tmp_path, model, match):
    """Feature- or edge-conditioned models (the sealed wire carries only
    frames) and class ids above a byte are refused, before any trace."""
    m = create_model(_cfg(False, **model), device="cpu")
    with pytest.raises(ValueError, match=match):
        export_serving_artifact(m, HW, str(tmp_path / "m.ir2rgb"))


def test_export_refuses_the_tpu_platform(tmp_path):
    with pytest.raises(ValueError, match="JAX package"):
        export_serving_artifact(_model(False), HW, str(tmp_path / "m"),
                                platforms=("tpu", "cpu"))


def test_label_artifact_takes_raw_class_ids(tmp_path):
    """A label model's wire carries one id byte a pixel, one-hot encoded
    in the program, as the live path does."""
    model = _model(False, label_nc=5, input_nc=5)
    path = str(tmp_path / "m.ir2rgb")
    export_serving_artifact(model, HW, path)
    art = load_serving_artifact(path, device="cpu")
    assert art.meta["input_nc"] == 1
    ids = np.random.RandomState(0).randint(0, 5, HW + (1,)).astype(np.uint8)
    np.testing.assert_array_equal(art.push(ids),
                                  StreamingGenerator(model, HW).push(ids))


def test_artifact_holds_to_jax(tmp_path):
    """The same weights (JAX's, converted by checkpoint/from_jax.py)
    sealed by both packages: the port's frames within 1 LSB of JAX's
    artifact and the carries within 1e-4 over four free-running frames;
    the port's loader refuses the JAX artifact."""
    jmodel = jax_create_model(JConfig(
        model=JModelConfig(model="temporal", **ARCH),
        data=JDataConfig(crop_size=32), loss=JLossConfig(no_vgg_loss=True)),
        steps_per_epoch=10)
    rng = np.random.RandomState(4)
    g = jax.tree.map(
        lambda s: jnp.asarray(rng.randn(*s.shape).astype(np.float32) * 0.05),
        jax.eval_shape(jmodel.g_init, jax.random.PRNGKey(0)))
    jpath = str(tmp_path / "jax.ir2rgb")
    jexport.export_serving_artifact(jmodel, g, HW, jpath,
                                    platforms=("cpu",))
    pmodel = _model()
    pmodel.netG.load_state_dict(generator_state_dict_from_jax(
        jax.tree.map(np.asarray, g), pmodel.gen_cfg))
    ppath = str(tmp_path / "port.ir2rgb")
    export_serving_artifact(pmodel, HW, ppath)
    ja = jexport.load_serving_artifact(jpath)
    pa = load_serving_artifact(ppath, device="cpu")
    for f in _frames(4, seed=6):
        u_j, u_p = ja.push(f), pa.push(f)
        assert np.abs(u_p.astype(np.int16) - u_j.astype(np.int16)).max() <= 1
        np.testing.assert_allclose(pa.carry.numpy(), np.asarray(ja._carry),
                                   atol=CARRY_ATOL)
    with pytest.raises(ValueError, match="program_format"):
        load_serving_artifact(jpath, device="cpu")


def test_loading_imports_no_model_code(exported):
    """A fresh process loads and serves an artifact with infer/export.py,
    the uint8 wire and the kernel ops only: no jax and no nn/, train/ or
    config/ module of the port."""
    _, path = exported(True)
    code = (
        "import sys, numpy as np\n"
        "from ir2rgb_tpu_torch.infer.export import load_serving_artifact\n"
        f"art = load_serving_artifact({path!r}, device='cpu')\n"
        "out = art.push(np.zeros((32, 32, 3), np.uint8))\n"
        "assert out.shape == (32, 32, 3) and out.dtype == np.uint8\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'ir2rgb_tpu.', 'ir2rgb_tpu_torch.nn', "
        "'ir2rgb_tpu_torch.train', 'ir2rgb_tpu_torch.config')))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout


def test_loading_defaults_to_the_card(exported, monkeypatch):
    _, path = exported(False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving_artifact(path)


# ---------------------------------------------------------------------------
# The export CLI
# ---------------------------------------------------------------------------

CLI_ARCH = ["--model.model", "temporal", "--model.net_g", "resnet_6blocks",
            "--model.net_d", "n_layers", "--model.ngf", "8",
            "--model.ndf", "8", "--model.n_frames_g", "2",
            "--loss.no_vgg_loss", "true", "--device", "cpu"]


def _checkpoint(tmp_path, name):
    """A run checkpoint at step 0 holding a temporal model's netG."""
    model = _model()
    mgr = CheckpointManager(str(tmp_path / "ckpts" / name / "ckpt"))
    mgr.save(0, {"netG": model.netG.state_dict()})
    mgr.wait()
    return model


def test_export_cli_from_checkpoint(tmp_path):
    from ir2rgb_tpu_torch.cli.export import main
    model = _checkpoint(tmp_path, "runx")
    out = str(tmp_path / "runx.ir2rgb")
    rc = main(CLI_ARCH + ["--data.crop_size", "32", "--train.name", "runx",
                          "--train.checkpoints_dir", str(tmp_path / "ckpts"),
                          "--out", out, "--platforms", "cpu"])
    assert rc == 0 and os.path.exists(out)
    art = load_serving_artifact(out, device="cpu")
    f = _frames(1, seed=3)[0]
    np.testing.assert_array_equal(art.push(f),
                                  StreamingGenerator(model, HW).push(f))


def test_export_cli_size_flag_and_noncrop_guard(tmp_path):
    """A non-crop preprocess has no geometry export can infer: --size is
    demanded, and --size HxW seals that geometry."""
    from ir2rgb_tpu_torch.cli.export import main
    _checkpoint(tmp_path, "runsz")
    common = CLI_ARCH + ["--data.preprocess", "none", "--train.name",
                         "runsz", "--train.checkpoints_dir",
                         str(tmp_path / "ckpts"), "--platforms", "cpu"]
    with pytest.raises(SystemExit, match="--size"):
        main(common + ["--out", str(tmp_path / "x.ir2rgb")])
    out = str(tmp_path / "sized.ir2rgb")
    assert main(common + ["--out", out, "--size", "32x64"]) == 0
    art = load_serving_artifact(out, device="cpu")
    assert art.push(_frames(1, hw=(32, 64))[0]).shape == (32, 64, 3)


def test_export_cli_slots_from_torch_g(tmp_path, capsys):
    """--torch_g exports a reference .pth; --slots N seals the
    multi-stream tick."""
    from ir2rgb_tpu_torch.cli.export import main
    t = torch_refs.ResnetGenerator(ngf=8, n_blocks=6, norm="instance")
    ckpt = str(tmp_path / "latest_net_G.pth")
    torch.save(t.state_dict(), ckpt)
    out = str(tmp_path / "cli.ir2rgb")
    rc = main(["--model.model", "pix2pix", "--model.net_g",
               "resnet_6blocks", "--model.ngf", "8", "--model.ndf", "8",
               "--loss.no_vgg_loss", "true", "--data.crop_size", "32",
               "--device", "cpu", "--torch_g", ckpt, "--out", out,
               "--slots", "2", "--platforms", "cpu"])
    assert rc == 0
    assert "multistream slots 2" in capsys.readouterr().out
    _, params, meta = load_multistream_artifact(out, device="cpu")
    assert meta["batch"] == 2 and meta["multistream"]
    for k, v in t.state_dict().items():
        assert torch.equal(params[k], v), k


@pytest.mark.parametrize("argv,match", [
    (["--batch", "4", "--slots", "8"], "mutually exclusive"),
    (["--slots", "0"], "must be >= 1"),
    (["--slots", "x8"], "expects an integer"),
    (["--batch", "-1"], "must be >= 1"),
])
def test_export_cli_flag_validation(argv, match):
    from ir2rgb_tpu_torch.cli.export import main
    with pytest.raises(SystemExit, match=match):
        main(argv)


# ---------------------------------------------------------------------------
# Multi-stream artifacts and cli.serve --artifact (tests/test_serve.py)
# ---------------------------------------------------------------------------

def test_multistream_artifact_matches_live_server(exported):
    """The sealed tick serves as the live MultiStreamServer does, bit for
    bit: batched ticks, a skipped slot's carry held, a reused slot reset,
    with no model behind it."""
    model, path = exported(True, slots=3)
    live = MultiStreamServer(model, HW, n_slots=3)
    sealed = MultiStreamServer.from_artifact(path, device="cpu")
    assert sealed.model is None
    assert sealed.physical_slots == 3 and sealed.n_slots == 3
    assert (sealed.in_nc, sealed.out_nc) == (3, 3)
    fa, fb = _frames(3, seed=20), _frames(3, seed=21)
    ids = [(live.open(), sealed.open()) for _ in range(2)]
    for feed in ({0: fa[0], 1: fb[0]}, {0: fa[1]}, {0: fa[2], 1: fb[1]}):
        lo = live.step({ids[k][0]: v for k, v in feed.items()})
        so = sealed.step({ids[k][1]: v for k, v in feed.items()})
        for k in feed:
            np.testing.assert_array_equal(so[ids[k][1]], lo[ids[k][0]])
        assert torch.equal(sealed._carry, live._carry)
    live.close(ids[1][0])
    sealed.close(ids[1][1])
    lb, sb = live.open(), sealed.open()
    np.testing.assert_array_equal(sealed.step({sb: fb[2]})[sb],
                                  live.step({lb: fb[2]})[lb])


def test_multistream_artifact_loader_guards(exported):
    _, single = exported(False)
    _, multi = exported(False, slots=2)
    with pytest.raises(ValueError, match="MULTI-STREAM artifact"):
        load_serving_artifact(multi, device="cpu")
    with pytest.raises(ValueError, match="single-stream artifact"):
        load_multistream_artifact(single, device="cpu")
    with pytest.raises(ValueError, match="exceeds the artifact"):
        MultiStreamServer.from_artifact(multi, n_slots=5, device="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        MultiStreamServer.from_artifact(multi, n_slots=0, device="cpu")
    srv = MultiStreamServer.from_artifact(multi, n_slots=5, clamp=True,
                                          device="cpu")
    assert srv.n_slots == 2 and srv.physical_slots == 2
    _, _, meta = load_multistream_artifact(multi, device="cpu")
    assert meta["format_version"] == 2


def _banner(proc, timeout: float) -> str:
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        if not sel.select(timeout):
            pytest.fail(f"no banner within {timeout} s")
        return proc.stdout.readline()
    finally:
        sel.close()


def test_serve_cli_artifact_e2e(exported):
    """cli.export --slots -> cli.serve --artifact -> a client: fp32 replies
    equal the live server's, and an explicit --infer.serve_slots caps the
    streams below the sealed batch."""
    model, path = exported(False, slots=2)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ir2rgb_tpu_torch.cli.serve", "--device",
         "cpu", "--infer.serve_port", "0", "--infer.serve_slots", "1",
         "--artifact", path],
        stdout=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        line = _banner(proc, 120)
        assert "serving artifact m.ir2rgb at" in line, line
        assert "slots 1 (physical 2)" in line, line
        port = int(line.split(" at ")[1].split()[0].rsplit(":", 1)[1])
        ref = MultiStreamServer(model, HW, n_slots=1)
        sid = ref.open()
        with FrameClient("127.0.0.1", port, timeout=60) as c:
            for f in _frames(3, seed=2):
                np.testing.assert_array_equal(c.push(f),
                                              ref.step({sid: f})[sid])
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("flags,match", [
    (["--torch_g", "g.pth"], "mutually exclusive"),
    (["--infer.quant", "int8"], "quant has no effect"),
    (["--serve.hw", "64x64"], "serve.hw has no effect"),
    (["--infer.use_ema", "true"], "use_ema has no effect"),
    (["--infer.which_epoch", "30"], "which_epoch has no effect"),
], ids=["torch_g", "quant", "hw", "use_ema", "which_epoch"])
def test_serve_cli_artifact_flag_refusals(tmp_path, flags, match):
    """What a sealed artifact fixes is refused as a flag, before the file
    is opened."""
    from ir2rgb_tpu_torch.cli.serve import main
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", "--artifact", str(tmp_path / "x.ir2rgb"),
              *flags])


def test_op_overhead_tool_needs_a_card(monkeypatch):
    """The op-overhead measurement refuses to run without a card rather
    than time the CPU."""
    from ir2rgb_tpu_torch import op_overhead
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        op_overhead.main([])
