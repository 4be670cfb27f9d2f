"""Crash-safe resume of the port on the CPU, at small sizes: a run restored
from a mid-training checkpoint and continued is bit-identical to the
uninterrupted run, for the iDBN, the iMDBN joint phase (stopped before,
at and after the warm-up boundary) and the bimodal joint phase, and for
both entry points end to end (a crash injected right after a checkpoint
write, then the same command again). Everything here is exact.
"""

import numpy as np
import pytest
import torch
import yaml

import multimodal_idbn_tpu_torch.checkpoint as tck
from multimodal_idbn_tpu_torch import train_bimodal, train_multimodal
from multimodal_idbn_tpu_torch.models import iMDBN, iMDBN_BiModal

from torch_parity import (assert_models_equal, randomize, rbm_arrays,
                          small_bimodal, small_imdbn)


class InjectedCrash(RuntimeError):
    pass


def crash_after(monkeypatch, phase, next_epoch, *modules):
    """Let ``save_train_checkpoint`` write the checkpoint of (phase,
    next_epoch) and then raise, as a kill right after the write would."""
    real = tck.save_train_checkpoint

    def crashing(model, path, phase_=None, next_epoch_=None,
                 loss_history=None, **kw):
        ph = kw.get("phase", phase_)
        ne = kw.get("next_epoch", next_epoch_)
        real(model, path, phase=ph, next_epoch=ne, loss_history=loss_history)
        if ph == phase and int(ne) == next_epoch:
            raise InjectedCrash(f"{ph}@{ne}")

    for mod in (tck, *modules):
        monkeypatch.setattr(mod, "save_train_checkpoint", crashing)


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


# ---------------------------------------------------------------------------
# Both entry points, crashed and run again
# ---------------------------------------------------------------------------

def _config(tmp_path, yaml_name, name, **training):
    cfg = yaml.safe_load(open(f"configs/{yaml_name}.yaml"))
    out = tmp_path / name
    out.mkdir()
    cfg["paths"]["save_dir"] = str(out)
    cfg["training"].update(checkpoint_every=2, **training)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, out


def _payload_arrays(path, load):
    payload = load(str(path), device="cpu")
    out = {}
    for key in ("image_idbn", "joint_rbm", "mod1_dbn", "mod2_dbn"):
        if key in payload:
            out.update({f"{key}/{k}": a
                        for k, a in rbm_arrays(payload[key]).items()})
    for i, r in enumerate(payload.get("joint_layers", [])):
        out.update({f"joint{i}/{k}": a for k, a in rbm_arrays(r).items()})
    if "z_class_mean" in payload:
        out["z_class_mean"] = np.asarray(payload["z_class_mean"])
    return out


@pytest.mark.parametrize("phase,stop,message", [
    ("image", 2, "resuming image training at epoch 2/4"),
    ("joint", 8, "resuming joint training at epoch 8/10")])
def test_train_multimodal_crash_and_rerun(tmp_path, monkeypatch, capsys,
                                          phase, stop, message):
    crash_cfg, crash_dir = _config(tmp_path, "smoke_multimodal", "crash")
    clean_cfg, clean_dir = _config(tmp_path, "smoke_multimodal", "clean")
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
    a = _payload_arrays(crash_dir / "imdbn_smoke.pkl", iMDBN.load_model)
    b = _payload_arrays(clean_dir / "imdbn_smoke.pkl", iMDBN.load_model)
    assert sorted(a) == sorted(b) and len(a) == 19
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_bimodal_crash_and_rerun(tmp_path, monkeypatch, capsys):
    kw = dict(epochs_joint=9)
    crash_cfg, crash_dir = _config(tmp_path, "smoke_bimodal", "crash", **kw)
    clean_cfg, clean_dir = _config(tmp_path, "smoke_bimodal", "clean", **kw)
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
    a = _payload_arrays(crash_dir / "bimodal_smoke.pkl",
                        iMDBN_BiModal.load_model)
    b = _payload_arrays(clean_dir / "bimodal_smoke.pkl",
                        iMDBN_BiModal.load_model)
    assert sorted(a) == sorted(b) and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_modality_phase_resumes_mid_way(tmp_path, monkeypatch, capsys):
    """A crash inside the MOD2 phase: MOD1 is not retrained, MOD2 goes on
    from its checkpoint, and the model equals the uninterrupted run's."""
    kw = dict(epochs_joint=1, epochs_mod2=4)
    crash_cfg, _ = _config(tmp_path, "smoke_bimodal", "crash", **kw)
    clean_cfg, _ = _config(tmp_path, "smoke_bimodal", "clean", **kw)
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
