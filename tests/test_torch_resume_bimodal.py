"""Crash-safe resume of the port on the CPU, at small sizes, bimodal
family: the bimodal joint phase restored from a mid-training checkpoint
and continued is bit-identical to the uninterrupted run, and so is the
``train_bimodal`` entry point crashed right after a checkpoint write (in
the joint phase and inside the MOD2 phase) and run again. The flagship
family: tests/test_torch_resume.py. Everything here is exact.
"""

import numpy as np
import pytest

import multimodal_idbn_tpu_torch.checkpoint as tck
from multimodal_idbn_tpu_torch import train_bimodal
from multimodal_idbn_tpu_torch.models import iMDBN_BiModal

from torch_parity import (InjectedCrash, assert_models_equal, crash_after,
                          payload_arrays, randomize, resume_config,
                          small_bimodal)


@pytest.mark.parametrize("stop", [3, 8])
def test_bimodal_joint_resume_bit_identical(tmp_path, monkeypatch, stop):
    def model(seed=0):
        return randomize(small_bimodal(seed), np.random.RandomState(1),
                         momentum=False)

    straight = model()
    straight.train_joint(9)
    ck = str(tmp_path / "bimodal_joint.ckpt.npz")
    crashed = model()
    crash_after(monkeypatch, "bimodal_joint", stop)
    with pytest.raises(InjectedCrash):
        crashed.train_joint(9, checkpoint_every=3, checkpoint_path=ck)
    monkeypatch.undo()
    resumed = small_bimodal(seed=4)
    assert tck.load_train_checkpoint(resumed, ck) == ("bimodal_joint", stop)
    resumed.train_joint(9, start_epoch=stop)
    assert_models_equal(resumed, straight)
    assert resumed.joint_metrics_history == straight.joint_metrics_history
    assert resumed.last_metrics == straight.last_metrics


def test_train_bimodal_crash_and_rerun(tmp_path, monkeypatch, capsys):
    kw = dict(epochs_joint=9)
    crash_cfg, crash_dir = resume_config(tmp_path, "smoke_bimodal", "crash", **kw)
    clean_cfg, clean_dir = resume_config(tmp_path, "smoke_bimodal", "clean", **kw)
    crash_after(monkeypatch, "bimodal_joint", 8, train_bimodal)
    with pytest.raises(InjectedCrash):
        train_bimodal.main(["--config", str(crash_cfg), "--device", "cpu"])
    monkeypatch.undo()
    ckpts = crash_dir / "checkpoints"
    # both modality phases were marked complete before the joint crash
    assert sorted(f.name for f in ckpts.iterdir()) == [
        "bimodal_joint.ckpt.npz", "mod1.ckpt.npz", "mod2.ckpt.npz"]
    capsys.readouterr()
    resumed = train_bimodal.main(["--config", str(crash_cfg),
                                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resuming joint training at epoch 8/9" in out
    assert "Training MOD1 iDBN" not in out and "Saved bimodal model" in out
    assert not any(ckpts.iterdir())
    clean = train_bimodal.main(["--config", str(clean_cfg), "--device",
                                "cpu"])
    assert_models_equal(resumed["model"], clean["model"])
    assert resumed["model"].joint_metrics_history == \
        clean["model"].joint_metrics_history
    a = payload_arrays(crash_dir / "bimodal_smoke.pkl",
                        iMDBN_BiModal.load_model)
    b = payload_arrays(clean_dir / "bimodal_smoke.pkl",
                        iMDBN_BiModal.load_model)
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_modality_phase_resumes_mid_way(tmp_path, monkeypatch, capsys):
    """A crash inside the MOD2 phase: MOD1 is not retrained, MOD2 goes on
    from its checkpoint, and the model equals the uninterrupted run's."""
    kw = dict(epochs_joint=1, epochs_mod2=4)
    crash_cfg, _ = resume_config(tmp_path, "smoke_bimodal", "crash", **kw)
    clean_cfg, _ = resume_config(tmp_path, "smoke_bimodal", "clean", **kw)
    crash_after(monkeypatch, "mod2", 2, train_bimodal)
    with pytest.raises(InjectedCrash):
        train_bimodal.main(["--config", str(crash_cfg), "--device", "cpu"])
    monkeypatch.undo()
    capsys.readouterr()
    resumed = train_bimodal.main(["--config", str(crash_cfg), "--device",
                                  "cpu"])
    out = capsys.readouterr().out
    assert "resuming MOD1 training at epoch 2/2" in out
    assert "resuming MOD2 training at epoch 2/4" in out
    assert "Training MOD1 iDBN" not in out
    clean = train_bimodal.main(["--config", str(clean_cfg), "--device",
                                "cpu"])
    assert_models_equal(resumed["model"], clean["model"])
    assert resumed["mod2_loss"] == clean["mod2_loss"]
    assert len(resumed["mod2_loss"]) == 4
