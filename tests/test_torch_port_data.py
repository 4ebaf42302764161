"""The port's config and data layer held to the JAX package on the CPU:
the config's field set, presets, CLI and JSON; the folder loader's batches
byte for byte over two epochs in every dataset and preprocess mode, with
its errors; the device transforms' apply bit for bit at the crop and flip
parameters JAX chose; the port's own draws; native decode and AVI frames."""

import dataclasses
import itertools
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ir2rgb_tpu import config as jconfig
from ir2rgb_tpu.data import loader as jloader
from ir2rgb_tpu.data import transforms as jtransforms
from ir2rgb_tpu.data.folder import make_dataset as jax_make_dataset

from ir2rgb_tpu_torch import config as pconfig
from ir2rgb_tpu_torch.data import loader as ploader
from ir2rgb_tpu_torch.data import native as pnative
from ir2rgb_tpu_torch.data import transforms as ptransforms
from ir2rgb_tpu_torch.data.folder import make_dataset
from ir2rgb_tpu_torch.data.synthetic import (
    synthetic_pair_batch,
    write_synthetic_dataset,
)
from ir2rgb_tpu_torch.obs.video import MJPEGAviWriter, read_mjpeg_avi

SECTIONS = ("model", "data", "loss", "train", "infer")


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("section", SECTIONS)
def test_config_fields_equal_jax_by_name_type_and_default(section):
    got = dataclasses.fields(getattr(pconfig.Config(), section))
    want = dataclasses.fields(getattr(jconfig.Config(), section))
    assert ([(f.name, f.type, getattr(pconfig.Config(), section).__dict__[
        f.name]) for f in got] ==
            [(f.name, f.type, getattr(jconfig.Config(), section).__dict__[
                f.name]) for f in want])


@pytest.mark.parametrize("name", sorted(pconfig.PRESETS))
def test_preset_equals_jax_field_for_field(name):
    assert set(pconfig.PRESETS) == set(jconfig.PRESETS)
    assert (dataclasses.asdict(pconfig.PRESETS[name])
            == dataclasses.asdict(jconfig.PRESETS[name]))


@pytest.mark.parametrize("writer,reader", [(jconfig, pconfig),
                                           (pconfig, jconfig)])
def test_config_json_loads_in_the_other_package(tmp_path, writer, reader):
    cfg = writer.parse_cli(["--preset", "temporal_512", "--train.name", "x",
                            "--data.max_dataset_size", "7",
                            "--loss.lambda_vgg", "2.5"])
    path = str(tmp_path / "config.json")
    writer.save_config(cfg, path)
    loaded = reader.load_config(path)
    assert type(loaded) is reader.Config
    assert dataclasses.asdict(loaded) == dataclasses.asdict(cfg)
    assert loaded.run_dir() == os.path.join("./checkpoints", "x")


ARGVS = {
    "preset": ["--preset", "pix2pixhd_512"],
    "bool_int_float": ["--preset", "resnet9_256", "--data.no_flip", "true",
                       "--data.batch_size", "3", "--train.lr", "1e-3",
                       "--model.use_dropout", "yes",
                       "--train.continue_train", "False"],
    "optional_int_str": ["--data.max_dataset_size", "5", "--infer.how_many",
                         "2", "--train.name", "run7", "--train.which_epoch",
                         "3", "--model.compute_dtype", "bf16"],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_parse_cli_gives_jaxs_config(case):
    argv = ARGVS[case]
    assert (dataclasses.asdict(pconfig.parse_cli(argv))
            == dataclasses.asdict(jconfig.parse_cli(argv)))


def test_parse_cli_config_file_and_refusal(tmp_path):
    path = str(tmp_path / "c.json")
    pconfig.save_config(pconfig.PRESETS["pix2pixhd_1024"], path)
    argv = ["--config", path, "--train.niter", "3"]
    got = pconfig.parse_cli(argv)
    assert got.train.niter == 3 and got.model.num_d == 3
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jconfig.parse_cli(argv))
    for mod in (pconfig, jconfig):
        with pytest.raises(SystemExit):
            mod.parse_cli(["--config", path, "--preset", "resnet9_256"])


# ---------------------------------------------------------------------------
# The folder loader, byte for byte
# ---------------------------------------------------------------------------

def _write_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_data")
    rng = np.random.RandomState(0)
    write_synthetic_dataset(str(root / "pairs"), n=7, size=40)
    write_synthetic_dataset(str(root / "video"), n_videos=2,
                            frames_per_video=5, size=40)
    # phase-prefixed, non-square, with instance maps and label maps
    for i in range(5):
        for sub in ("trainA", "trainB"):
            _write_png(str(root / "wide" / sub / f"{i:03d}.png"),
                       (rng.rand(36, 52, 3) * 255).astype(np.uint8))
        _write_png(str(root / "wide" / "trainInst" / f"{i:03d}.png"),
                   rng.randint(0, 7, (36, 52)).astype(np.uint8))
        _write_png(str(root / "labels" / "trainA" / f"{i:03d}.png"),
                   rng.randint(0, 5, (36, 52)).astype(np.uint8))
        _write_png(str(root / "labels" / "trainB" / f"{i:03d}.png"),
                   (rng.rand(36, 52, 3) * 255).astype(np.uint8))
    # unpaired sets of different sizes
    for i in range(4):
        _write_png(str(root / "unpaired" / "trainA" / f"a{i}.png"),
                   (rng.rand(40, 40, 3) * 255).astype(np.uint8))
    for i in range(3):
        _write_png(str(root / "unpaired" / "trainB" / f"b{i}.png"),
                   (rng.rand(40, 40, 3) * 255).astype(np.uint8))
    # faults: a count mismatch, mixed native sizes
    for i in range(3):
        _write_png(str(root / "mismatch" / "A" / f"{i}.png"),
                   np.zeros((8, 8, 3), np.uint8))
    for i in range(2):
        _write_png(str(root / "mismatch" / "B" / f"{i}.png"),
                   np.zeros((8, 8, 3), np.uint8))
    for i, hw in enumerate([(16, 16), (16, 16), (20, 16)]):
        for sub in ("A", "B"):
            _write_png(str(root / "mixed" / sub / f"{i}.png"),
                       np.zeros(hw + (3,), np.uint8))
    return root


LOADER_CASES = {
    "aligned_shuffled": ("pairs", ["--data.batch_size", "2"]),
    "aligned_btoa": ("pairs", ["--data.direction", "BtoA"]),
    "aligned_serial": ("pairs", ["--data.serial_batches", "true",
                                 "--data.batch_size", "3"]),
    "temporal": ("video", ["--data.dataset_mode", "temporal",
                           "--data.n_frames_total", "3",
                           "--data.batch_size", "2"]),
    "temporal_btoa": ("video", ["--data.dataset_mode", "temporal",
                                "--data.n_frames_total", "4",
                                "--data.direction", "BtoA"]),
    "instance_maps": ("wide", ["--model.use_instance_edges", "true",
                               "--data.batch_size", "2"]),
    "label_maps": ("labels", ["--model.label_nc", "5"]),
    "single": ("wide", ["--data.dataset_mode", "single",
                        "--data.phase", "train"]),
    "unaligned": ("unpaired", ["--data.dataset_mode", "unaligned",
                               "--data.batch_size", "2"]),
    "unaligned_serial": ("unpaired", ["--data.dataset_mode", "unaligned",
                                      "--data.serial_batches", "true"]),
    "gray_max_size": ("pairs", ["--model.input_nc", "1",
                                "--data.max_dataset_size", "5"]),
    "crop": ("wide", ["--data.preprocess", "crop"]),
    "scale_width": ("wide", ["--data.preprocess", "scale_width",
                             "--data.load_size", "32"]),
    "scale_width_and_crop": ("wide", ["--data.preprocess",
                                      "scale_width_and_crop",
                                      "--data.load_size", "40"]),
    "none": ("wide", ["--data.preprocess", "none"]),
}


def _loaders(root, argv):
    argv = argv + ["--data.dataroot", str(root), "--train.seed", "3"]
    if "--data.load_size" not in argv:
        argv += ["--data.load_size", "40"]
    return (ploader.DataLoader(pconfig.parse_cli(argv)),
            jloader.DataLoader(jconfig.parse_cli(argv)))


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "paths":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == \
                want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_yields_jaxs_batches_for_two_epochs(folders, case):
    sub, argv = LOADER_CASES[case]
    port, jax_ = _loaders(folders / sub, argv)
    assert len(port) == len(jax_) > 0
    assert port.target_hw == jax_.target_hw
    got = list(port.epoch()) + list(port.epoch())
    want = list(jax_.epoch()) + list(jax_.epoch())
    assert len(got) == len(want) == 2 * len(port)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_prefetched_stream_is_the_epochs(folders):
    port, jax_ = _loaders(folders / "pairs", ["--data.batch_size", "2"])
    n = 2 * len(port)
    for g, w in zip(itertools.islice(iter(port), n),
                    itertools.islice(iter(jax_), n)):
        _assert_batches_equal(g, w)


@pytest.mark.parametrize("sub,argv,error", [
    ("mismatch", [], ValueError),
    ("pairs", ["--data.batch_size", "8"], ValueError),
    ("mixed", ["--data.preprocess", "crop"], ValueError),
    ("unpaired", ["--data.dataset_mode", "unaligned",
                  "--model.label_nc", "3"], ValueError),
    ("pairs", ["--data.dataset_mode", "bogus"], ValueError),
    ("pairs", ["--model.use_instance_edges", "true"], FileNotFoundError),
])
def test_loader_errors_match_jax(folders, sub, argv, error):
    argv = argv + ["--data.dataroot", str(folders / sub),
                   "--data.load_size", "16"]
    with pytest.raises(error) as got:
        ploader.DataLoader(pconfig.parse_cli(argv))
    with pytest.raises(error) as want:
        jloader.DataLoader(jconfig.parse_cli(argv))
    # the same message, but that the port has no jit
    assert str(got.value) == str(want.value).replace(
        "static shapes under jit", "static shapes")


def test_synthetic_and_native_decode_are_jaxs(tmp_path):
    from ir2rgb_tpu.data import synthetic as jsynthetic
    from ir2rgb_tpu.data import native as jnative
    got, want = synthetic_pair_batch(3, 24, seed=5), \
        jsynthetic.synthetic_pair_batch(3, 24, seed=5)
    assert all(np.array_equal(got[k], want[k]) for k in ("a", "b"))
    write_synthetic_dataset(str(tmp_path), n=3, size=24)
    paths = make_dataset(str(tmp_path / "A"))
    assert paths == jax_make_dataset(str(tmp_path / "A"))
    assert pnative.decoder_in_use() == (
        "native" if jnative.native_available() else "pil")
    for gray in (False, True):
        np.testing.assert_array_equal(
            pnative.decode_batch(paths, 20, 28, gray=gray),
            jnative.decode_batch(paths, 20, 28, gray=gray))


def test_avi_virtual_frames_round_trip(tmp_path):
    frames = synthetic_pair_batch(4, 32, seed=1)["a"]
    path = str(tmp_path / "A" / "clip.avi")
    with MJPEGAviWriter(path, fps=12) as w:
        for f in frames:
            w.add(f)
    read, fps = read_mjpeg_avi(path)
    assert fps == 12 and read.shape == frames.shape
    paths = make_dataset(str(tmp_path / "A"))
    assert paths == [f"{path}#{i:06d}" for i in range(4)]
    from ir2rgb_tpu.data import native as jnative
    np.testing.assert_array_equal(pnative.decode_batch(paths, 32, 32),
                                  jnative.decode_batch(paths, 32, 32))


# ---------------------------------------------------------------------------
# Device transforms: the apply at JAX's own parameters
# ---------------------------------------------------------------------------

def _coded(n, h, w, salt=0):
    """uint8 frames whose channel 0 is the row, 1 the column, 2 the item:
    a crop and flip can be read back off any output."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((n, h, w, 3), np.uint8)
    out[..., 0] = yy
    out[..., 1] = xx
    out[..., 2] = (np.arange(n)[:, None, None] * 7 + salt) % 256
    return out


def _u8(x):
    """A normalized JAX output back to its uint8 values (exact)."""
    return np.rint((np.asarray(x, np.float64) + 1.0) * 127.5).astype(int)


def _params_from(out_u8):
    """(oy, ox, flip) per item of a cropped, maybe flipped coded batch
    (B, h, w, 3) or windows (B, T, h, w, 3)."""
    if out_u8.ndim == 5:
        out_u8 = out_u8[:, 0]
    oy = out_u8[:, 0, 0, 0]
    first, last = out_u8[:, 0, 0, 1], out_u8[:, 0, -1, 1]
    flip = first > last
    return ptransforms.CropFlip(torch.as_tensor(oy),
                                torch.as_tensor(np.minimum(first, last)),
                                torch.as_tensor(flip))


def _port_apply(x, p, crop):
    return ptransforms.normalize(
        ptransforms.apply_crop_flip(torch.from_numpy(x), p, crop)).numpy()


def _eq(got, want):
    assert got.dtype == np.asarray(want).dtype
    assert got.tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_pair_apply_at_jaxs_crop_and_flip_is_bit_exact(seed):
    a, b = _coded(6, 44, 40), _coded(6, 44, 40, salt=100)
    inst = np.random.RandomState(seed).randint(0, 9, (6, 44, 40)).astype(
        np.int32)
    out = jtransforms.preprocess_pair_batch(
        a, b, jax.random.PRNGKey(seed), crop_size=32, inst=inst)
    p = _params_from(_u8(out["a"]))
    _eq(_port_apply(a, p, 32), out["a"])
    _eq(_port_apply(b, p, 32), out["b"])
    _eq(ptransforms.apply_crop_flip(torch.from_numpy(inst)[..., None], p,
                                    32)[..., 0].numpy(), out["inst"])


def test_label_and_unpaired_apply_at_jaxs_parameters():
    a, b = _coded(4, 40, 40), _coded(4, 40, 40, salt=50)
    ids = (a[..., :1] % 5).astype(np.int32)
    out = jtransforms.preprocess_pair_batch(
        ids, b, jax.random.PRNGKey(7), crop_size=24, label_a=True)
    p = _params_from(_u8(out["b"]))
    _eq(ptransforms.apply_crop_flip(torch.from_numpy(ids), p, 24).to(
        torch.int32).numpy(), out["a"])
    out = jtransforms.preprocess_pair_batch(
        a, b, jax.random.PRNGKey(8), crop_size=24, unpaired=True)
    pa, pb = _params_from(_u8(out["a"])), _params_from(_u8(out["b"]))
    assert not (torch.equal(pa.oy, pb.oy) and torch.equal(pa.ox, pb.ox))
    _eq(_port_apply(a, pa, 24), out["a"])
    _eq(_port_apply(b, pb, 24), out["b"])


def test_flip_only_and_eval_paths_match_jax():
    a, b = _coded(5, 36, 44), _coded(5, 36, 44, salt=9)
    out = jtransforms.preprocess_pair_batch(a, b, jax.random.PRNGKey(3),
                                            crop_size=None)
    p = _params_from(_u8(out["a"]))
    assert int(p.oy.max()) == int(p.ox.max()) == 0
    _eq(_port_apply(a, p, None), out["a"])
    _eq(_port_apply(b, p, None), out["b"])
    for crop in (32, None):
        want = jtransforms.preprocess_pair_batch(
            a, b, jax.random.PRNGKey(0), crop_size=crop, train=False)
        got = ptransforms.preprocess_pair_batch(
            torch.from_numpy(a), torch.from_numpy(b), None, crop_size=crop,
            train=False)
        for k in ("a", "b"):
            _eq(got[k].numpy(), want[k])
    want = jtransforms.preprocess_pair_batch(a, b, jax.random.PRNGKey(0),
                                             crop_size=32, no_flip=True)
    assert not bool(_params_from(_u8(want["a"])).flip.any())


@pytest.mark.parametrize("crop,train", [(24, True), (None, True),
                                        (24, False)])
def test_sequence_apply_at_jaxs_parameters(crop, train):
    a = np.stack([_coded(3, 32, 36, salt=t) for t in range(4)], axis=1)
    b = np.stack([_coded(3, 32, 36, salt=40 + t) for t in range(4)], axis=1)
    out = jtransforms.preprocess_sequence_batch(
        a, b, jax.random.PRNGKey(11), crop_size=crop, train=train)
    u8 = _u8(out["a"])
    # one decision per window: every frame shows frame 0's crop and flip
    assert all(np.array_equal(u8[:, t, ..., :2], u8[:, 0, ..., :2])
               for t in range(4))
    p = _params_from(u8)
    if train:
        got = {k: _port_apply(x, p, crop) for k, x in (("a", a), ("b", b))}
    else:
        got = {k: v.numpy() for k, v in ptransforms.preprocess_sequence_batch(
            torch.from_numpy(a), torch.from_numpy(b), None, crop,
            train=False).items()}
    _eq(got["a"], out["a"])
    _eq(got["b"], out["b"])


# ---------------------------------------------------------------------------
# The port's own draws
# ---------------------------------------------------------------------------

def test_draws_keep_pairs_together_in_range_and_reproducible():
    a = torch.from_numpy(_coded(16, 40, 48))
    inst = torch.from_numpy(_coded(16, 40, 48)[..., 0].astype(np.int32))

    def run(seed):
        return ptransforms.preprocess_pair_batch(
            a, a.clone(), torch.Generator().manual_seed(seed), 32,
            inst=inst)

    out = run(5)
    # the same pair in, the same pair out; the instance map moves with it
    assert torch.equal(out["a"], out["b"])
    _eq(_u8(out["a"].numpy())[..., 0].astype(np.int32), out["inst"].numpy())
    p = _params_from(_u8(out["a"].numpy()))
    assert 0 <= int(p.oy.min()) and int(p.oy.max()) <= 40 - 32
    assert 0 <= int(p.ox.min()) and int(p.ox.max()) <= 48 - 32
    assert 0 < int(p.flip.sum()) < 16
    again = run(5)
    assert all(torch.equal(out[k], again[k]) for k in out)
    assert not torch.equal(run(6)["a"], out["a"])
    g = torch.Generator().manual_seed(1)
    draws = ptransforms.draw_crop_flip(4000, 40, 48, 32, True, g)
    assert set(draws.oy.tolist()) == set(range(9))
    assert set(draws.ox.tolist()) == set(range(17))
    seq = ptransforms.preprocess_sequence_batch(
        a[:, None].expand(16, 3, 40, 48, 3), a[:, None].expand(
            16, 3, 40, 48, 3), torch.Generator().manual_seed(5), 32)
    assert torch.equal(seq["a"][:, 2], seq["a"][:, 0])
    assert torch.equal(seq["a"], seq["b"])
