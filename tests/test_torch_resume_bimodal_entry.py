"""The ``train_bimodal`` entry point on the CPU, crashed right after a
checkpoint write (in the joint phase and inside the MOD2 phase) and run
again: it resumes there and ends bit-identical to an uninterrupted run
(split from tests/test_torch_resume_bimodal.py). Everything here is exact.
"""

import numpy as np
import pytest

from multimodal_idbn_tpu_torch import train_bimodal
from multimodal_idbn_tpu_torch.models import iMDBN_BiModal

from torch_parity import (InjectedCrash, assert_models_equal, crash_after,
                          payload_arrays, resume_config)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


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
