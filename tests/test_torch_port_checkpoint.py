"""The port's CheckpointManager (torch.save in place of Orbax): the JAX
manager's retention, labels, fork and clear semantics, the full train
state round trip and resume, and the asynchronous save's snapshot (an
in-place step right after ``save`` does not reach the file)."""

import copy
import json
import os

import pytest
import torch

from ir2rgb_tpu_torch.checkpoint import (
    CheckpointManager,
    manager,
    restore_train_state,
    save_train_state,
)
from ir2rgb_tpu_torch.config import (
    Config,
    DataConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from ir2rgb_tpu_torch.data.synthetic import synthetic_pair_batch
from ir2rgb_tpu_torch.data.transforms import normalize
from ir2rgb_tpu_torch.train import create_model


def _setup(**model_kw):
    cfg = Config(
        model=ModelConfig(model="pix2pix", net_g="resnet_6blocks",
                          net_d="n_layers", ngf=4, ndf=4, **model_kw),
        data=DataConfig(crop_size=32, batch_size=1),
        loss=LossConfig(no_vgg_loss=True, pool_size=4),
        train=TrainConfig(),
    )
    model = create_model(cfg, device="cpu", steps_per_epoch=10)
    host = synthetic_pair_batch(1, 32)
    batch = {k: normalize(torch.from_numpy(host[k])) for k in ("a", "b")}
    return model, batch


def _equal_states(x, y):
    """Bit-equal nested states (tensors compared exactly)."""
    if isinstance(x, torch.Tensor):
        return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                and torch.equal(x.cpu(), y.cpu()))
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_equal_states(x[k], y[k])
                                            for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(map(_equal_states, x, y))
    return x == y


@pytest.mark.parametrize("dropout", [False, True])
def test_save_restore_resume_identical(tmp_path, dropout):
    # with dropout and the pool, the restored random state and pool make
    # the next step's draws, and so its result, the same
    model, batch = _setup(use_dropout=dropout)
    model.train_step(batch)
    model.train_step(batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, model.state_dict())
    mgr.wait()
    m_direct = model.train_step(batch)
    direct = model.state_dict()

    fresh, _ = _setup(use_dropout=dropout)
    fresh.load_state_dict(mgr.restore(2))
    assert fresh.step == 2
    m_restored = fresh.train_step(batch)
    assert {k: float(v) for k, v in m_direct.items()} == \
        {k: float(v) for k, v in m_restored.items()}
    assert _equal_states(fresh.state_dict(), direct)


def test_async_save_is_a_snapshot_before_the_next_step(tmp_path):
    # save, step again at once (Adam updates the parameters in place),
    # then wait: the file holds the state before that step, bit for bit
    model, batch = _setup()
    model.train_step(batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    expected = copy.deepcopy(model.state_dict())
    mgr.save(1, model.state_dict())
    model.train_step(batch)
    assert mgr.all_steps() == [1]  # counted while it is written
    mgr.wait()
    assert _equal_states(mgr.restore(1), expected)
    assert not _equal_states(model.state_dict()["netG"], expected["netG"])
    assert not [f for f in os.listdir(tmp_path / "ckpt")
                if f.endswith(".tmp")]


def test_a_half_written_step_is_never_picked(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, {"x": torch.ones(2)})
    mgr.wait()
    # what a crash mid-write leaves: the temporary name only
    (tmp_path / "ckpt" / ".4.pt.tmp").write_bytes(b"partial")
    assert mgr.latest_step() == 3 and mgr.all_steps() == [3]
    assert torch.equal(mgr.restore()["x"], torch.ones(2))


def test_latest_step_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"step": s})
    mgr.wait()
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]


def test_epoch_labeled_steps_survive_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    mgr.save(10, {"step": 10})
    mgr.record_epoch(1, 10)
    for s in (20, 30, 40, 50):
        mgr.save(s, {"step": s})
    mgr.wait()
    assert mgr.all_steps() == [10, 40, 50]
    assert mgr.step_for_label("1") == 10
    assert mgr.restore(10) == {"step": 10}
    assert mgr.step_for_label("latest") == 50
    assert mgr.step_for_label("40") == 40  # a saved step by number
    with pytest.raises(FileNotFoundError, match="which_epoch='9'"):
        mgr.step_for_label("9")
    mgr.close()


def test_a_failed_write_leaves_no_epoch_label(tmp_path, monkeypatch):
    # the label of a step still being written waits for the file: a
    # write that fails raises at wait() and leaves no label behind
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, {"step": 2})
    mgr.record_epoch(1, 2)
    mgr.wait()

    def fail(path, state):
        raise OSError("disk full")

    monkeypatch.setattr(manager, "_write", fail)
    mgr.save(4, {"step": 4})
    mgr.record_epoch(3, 4)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    with open(tmp_path / "ckpt" / "epochs.json") as fh:
        assert json.load(fh) == {"1": 2}
    assert mgr.all_steps() == [2]
    with pytest.raises(FileNotFoundError, match="which_epoch='3'"):
        mgr.step_for_label("3")
    monkeypatch.undo()
    # a label for a step that is being written is found once it lands
    mgr.save(6, {"step": 6})
    mgr.record_epoch(4, 6)
    assert mgr.step_for_label("4") == 6
    assert mgr.restore(6) == {"step": 6}


def test_delete_after_forks_with_a_warning_and_clear(tmp_path, caplog):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for s, e in ((2, 1), (4, 2), (6, 3)):
        mgr.save(s, {"step": s})
        mgr.record_epoch(e, s)
    mgr.wait()
    with caplog.at_level("WARNING"):
        mgr.delete_after(4)
    assert "FORKS the run" in caplog.text and "[6]" in caplog.text
    assert mgr.all_steps() == [2, 4]
    with open(tmp_path / "ckpt" / "epochs.json") as fh:
        assert json.load(fh) == {"1": 2, "2": 4}
    mgr.clear()
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    assert mgr.step_for_label("latest") is None
    assert not os.path.exists(tmp_path / "ckpt" / "epochs.json")
    with pytest.raises(FileNotFoundError):
        mgr.restore()


def test_one_shot_save_and_restore(tmp_path):
    model, _ = _setup()
    save_train_state(str(tmp_path), 7, model.state_dict())
    got = restore_train_state(str(tmp_path), 7)
    assert _equal_states(got, model.state_dict())
    # the file holds tensors and plain values only: a weights-only load
    assert json.loads(got["config"])["model"]["net_g"] == "resnet_6blocks"
    assert got["pool"]["buffer"].shape == (4, 32, 32, 3)
