"""The diagnostics slice end to end on the CPU, flagship family: the
``train_multimodal`` entry point on the smoke configuration with
``wandb.enable: true`` and W&B's ``init`` replaced by one that returns a
``RecorderRun``, as a user without W&B would run it (the bimodal family:
tests/test_torch_logging_slice_bimodal.py).

Checks: every diagnostic logs at its configured cadence and the epoch
timers are filled; logging on and off end in bit-equal models; a pickle of
a model holds no run object; with matplotlib and pandas blocked (the card's
installation) every numeric key is still logged with the same values, the
only warnings are ``*_figure_skipped`` and the confusion counts are
unchanged.
"""

import pickle

import pytest

from multimodal_idbn_tpu_torch import train_multimodal
from multimodal_idbn_tpu_torch.models import iMDBN
from multimodal_idbn_tpu_torch.utils.wandb_compat import RecorderRun, wandb

from torch_parity import (check_logging_leaves_training_unchanged,
                          check_wandb_enable_is_accepted,
                          check_without_matplotlib_and_pandas, logged_runs)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

YAML = "configs/smoke_multimodal.yaml"
MULTIMODAL_LOGGING = {
    "log_every": 3, "log_every_pca": 2, "log_every_probe": 4,
    "log_every_energy": 5, "log_every_convergence": 5,
    "log_every_neighbors": 5, "log_every_trajectory": 5,
    "energy": {"enable": True}, "neighbors": {"enable": True, "k": 3},
    "trajectory": {"enable": True, "num_samples": 2},
    "convergence": {"enable": True, "num_steps": 6}}


@pytest.fixture(scope="module")
def multimodal(tmp_path_factory):
    """{"on": (summary, run), "off": (summary, None), "blocked": ...}."""
    return logged_runs(train_multimodal, YAML, MULTIMODAL_LOGGING,
                       tmp_path_factory, "multimodal")


def test_multimodal_diagnostics_at_their_cadences(multimodal):
    summary, run = multimodal["on"]
    model = summary["model"]
    assert run.finished and run.config["_derived_params"]["SEED"] == 0
    assert run.epochs("idbn/loss") == [0, 1, 2, 3]
    assert len(run.values("perf/idbn_epoch_seconds")) == 4
    assert len(run.values("perf/joint_epoch_seconds")) == 10
    assert model.image_idbn.epoch_timer.count == 4
    assert model.epoch_timer.count == 10
    assert run.epochs("idbn/auto_recon_mse") == [0]
    assert len(run.values(
        "embeddings/val/iDBN_layer2/pca_2d_correlations")) == 2  # 0, 2
    assert run.epochs("probe/layer1/labels/acc") == [0]
    assert run.epochs("probe/joint/labels/acc") == [0, 4, 8]
    assert len(run.values(
        "embeddings/val/Joint_top/pca_3d_correlations")) == 5
    assert run.epochs("joint/cd_loss") == [8, 9]
    assert run.epochs("cross_modality/text_top1") == list(range(10))
    assert run.epochs("snap/image_mse") == [0, 3, 6, 9]
    for key in ("case/fixed/summary", "conv/panel/panel/summary",
                "zcheck/z_check/cosine_mean", "auto_recon/text_top1"):
        assert run.epochs(key) == [0, 5], key
    assert len(run.values("vecdb/knn_zT")) == 2
    assert len(run.values("pca_traj_with_recon/sample1/plot")) == 2
    for k in run.keys():
        if k.endswith("/acc"):
            assert all(0.0 <= a <= 1.0 for a in run.values(k))
    assert not [k for k in run.keys() if k.startswith("warn/")
                and k != "warn/idbn_blank_recon"]


@pytest.mark.parametrize("path", ["multimodal"])
def test_logging_leaves_training_unchanged(request, path):
    check_logging_leaves_training_unchanged(request.getfixturevalue(path))


def test_pickles_hold_no_run(multimodal):
    summary, run = multimodal["on"]
    model = summary["model"]
    assert model.wandb_run is run and model.image_idbn.wandb_run is run
    blob = pickle.dumps(model)
    assert b"RecorderRun" not in blob
    back = pickle.loads(blob)
    assert back.wandb_run is None and back.image_idbn.wandb_run is None
    saved = open(summary["save_path"], "rb").read()
    assert b"RecorderRun" not in saved
    loaded = iMDBN.from_payload(iMDBN.load_model(summary["save_path"],
                                                 device="cpu"))
    assert loaded.wandb_run is None and loaded.image_idbn.wandb_run is None
    assert model.wandb_run is run  # pickling left the live model as it was


@pytest.mark.parametrize("path", ["multimodal"])
def test_without_matplotlib_and_pandas(request, path):
    check_without_matplotlib_and_pandas(request.getfixturevalue(path))


@pytest.mark.parametrize("entry", [train_multimodal])
def test_wandb_enable_is_accepted(entry):
    check_wandb_enable_is_accepted(entry, YAML)


def test_maybe_wandb(capsys):
    cfg = {"wandb": {"enable": False}}
    assert train_multimodal.maybe_wandb(cfg, {}) is None
    cfg = {"wandb": {"enable": True, "project": "p"}}
    assert train_multimodal.maybe_wandb(cfg, {}) is None  # the stub's init

    def failing(**kw):
        raise RuntimeError("offline")

    wandb.init = failing
    try:
        assert train_multimodal.maybe_wandb(cfg, {}) is None
    finally:
        del wandb.init
    assert "[maybe_wandb] disabled (offline)" in capsys.readouterr().out
    wandb.init = RecorderRun
    try:
        run = train_multimodal.maybe_wandb(cfg, {"SEED": 3})
    finally:
        del wandb.init
    assert run.init_kw["project"] == "p"
    assert run.config["_derived_params"] == {"SEED": 3}
