"""Crash-safe resume of the port on the CPU, at small sizes, flagship
family: a run restored from a mid-training checkpoint and continued is
bit-identical to the uninterrupted run, for the iDBN and the iMDBN joint
phase (stopped before, at and after the warm-up boundary), and for the
``train_multimodal`` entry point end to end (a crash injected right after
a checkpoint write, then the same command again). The bimodal family:
tests/test_torch_resume_bimodal.py. Everything here is exact.
"""

import numpy as np
import pytest
import torch
import yaml

import multimodal_idbn_tpu_torch.checkpoint as tck
from multimodal_idbn_tpu_torch import train_multimodal
from multimodal_idbn_tpu_torch.models import iMDBN

from torch_parity import (InjectedCrash, assert_models_equal, crash_after,
                          payload_arrays, randomize, resume_config,
                          small_bimodal, small_imdbn)


@pytest.mark.parametrize("every", [1, 2, 3])
def test_idbn_resume_bit_identical(tmp_path, every):
    straight = small_imdbn().image_idbn
    straight.train(4)
    assert len(straight.loss_history) == 4

    ck = str(tmp_path / "image.ckpt.npz")
    saving = small_imdbn().image_idbn
    saving.train(4, checkpoint_every=every, checkpoint_path=ck)
    assert_models_equal(saving, straight)  # checkpointing changes nothing

    resumed = small_imdbn(seed=9).image_idbn  # other initial weights
    phase, start = tck.load_train_checkpoint(resumed, ck)
    assert phase == "image" and start == (3 // every) * every
    assert resumed.loss_history == straight.loss_history[:start]
    resumed.train(4, start_epoch=start)
    assert_models_equal(resumed, straight)
    assert resumed.loss_history == straight.loss_history


def test_train_arg_validation(tmp_path):
    for model, train in ((small_imdbn().image_idbn, "train"),
                         (small_imdbn(), "train_joint"),
                         (small_bimodal(), "train_joint")):
        with pytest.raises(ValueError, match=r"start_epoch 3 outside \[0, 2\]"):
            getattr(model, train)(2, start_epoch=3)
        with pytest.raises(ValueError,
                           match="checkpoint_every needs a checkpoint_path"):
            getattr(model, train)(2, checkpoint_every=1)
    d = small_imdbn().image_idbn
    d.train(2, start_epoch=2)  # nothing left to do
    assert d.loss_history == []


@pytest.fixture(scope="module")
def straight_joint():
    m = randomize(small_imdbn(), np.random.RandomState(0), momentum=False)
    m.train_joint(10)
    return m


@pytest.mark.parametrize("stop", [4, 8, 9])
def test_imdbn_joint_resume_bit_identical(tmp_path, monkeypatch,
                                          straight_joint, stop):
    """10 joint epochs, 8 of them warm-up: stopped inside the warm-up, at
    its boundary (an edge checkpointed whatever the cadence) and after the
    first main epoch."""
    ck = str(tmp_path / "joint.ckpt.npz")
    crashed = randomize(small_imdbn(), np.random.RandomState(0),
                        momentum=False)
    crash_after(monkeypatch, "joint", stop)
    with pytest.raises(InjectedCrash):
        crashed.train_joint(10, checkpoint_every=3 if stop != 4 else 2,
                            checkpoint_path=ck)
    monkeypatch.undo()

    resumed = small_imdbn(seed=5)
    phase, start = tck.load_train_checkpoint(resumed, ck)
    assert (phase, start) == ("joint", stop)
    assert len(resumed.joint_metrics_history) == stop
    resumed.train_joint(10, start_epoch=start)
    assert_models_equal(resumed, straight_joint)
    assert torch.equal(resumed.z_class_mean, straight_joint.z_class_mean)
    assert resumed.joint_metrics_history == \
        straight_joint.joint_metrics_history
    assert [m["epoch"] for m in resumed.joint_metrics_history] == \
        list(range(10))


# ---------------------------------------------------------------------------
# The entry point, crashed and run again
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase,stop,message", [
    ("image", 2, "resuming image training at epoch 2/4"),
    ("joint", 8, "resuming joint training at epoch 8/10")])
def test_train_multimodal_crash_and_rerun(tmp_path, monkeypatch, capsys,
                                          phase, stop, message):
    crash_cfg, crash_dir = resume_config(tmp_path, "smoke_multimodal", "crash")
    clean_cfg, clean_dir = resume_config(tmp_path, "smoke_multimodal", "clean")
    crash_after(monkeypatch, phase, stop)
    with pytest.raises(InjectedCrash):
        train_multimodal.main(["--config", str(crash_cfg), "--device", "cpu"])
    monkeypatch.undo()
    ckpts = crash_dir / "checkpoints"
    assert (ckpts / f"{phase}.ckpt.npz").exists()
    assert (ckpts / "image.ckpt.npz").exists()  # the marker, or the phase
    assert not (crash_dir / "imdbn_smoke.pkl").exists()

    # a changed learning rate refuses to resume, with the JAX package's text
    cfg = yaml.safe_load(crash_cfg.read_text())
    cfg["training"]["learning_rate"] = 0.2
    edited = tmp_path / "edited.yaml"
    edited.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match=(
            r"was written by a run with different training configuration "
            r"\(LEARNING_RATE: checkpoint=0.1 run=0.2\)")):
        train_multimodal.main(["--config", str(edited), "--device", "cpu"])

    capsys.readouterr()
    resumed = train_multimodal.main(["--config", str(crash_cfg),
                                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert message in out and "Saved multimodal model" in out
    if phase == "joint":
        assert "Training image iDBN" not in out
    assert not any(ckpts.iterdir())  # gone after the completed run

    clean = train_multimodal.main(["--config", str(clean_cfg),
                                   "--device", "cpu"])
    assert_models_equal(resumed["model"], clean["model"])
    if phase == "image":  # a joint checkpoint carries no image loss curve
        assert resumed["image_loss"] == clean["image_loss"]
    assert resumed["model"].joint_metrics_history == \
        clean["model"].joint_metrics_history
    a = payload_arrays(crash_dir / "imdbn_smoke.pkl", iMDBN.load_model)
    b = payload_arrays(clean_dir / "imdbn_smoke.pkl", iMDBN.load_model)
    assert sorted(a) == sorted(b) and len(a) == 19
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
