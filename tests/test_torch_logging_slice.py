"""The diagnostics slice end to end on the CPU: both entry points on the
smoke configurations with ``wandb.enable: true`` and W&B's ``init``
replaced by one that returns a ``RecorderRun``, as a user without W&B
would run them.

Checks: every diagnostic logs at its configured cadence and the epoch
timers are filled; logging on and off end in bit-equal models; a pickle of
a model holds no run object; with matplotlib and pandas blocked (the card's
installation) every numeric key is still logged with the same values, the
only warnings are ``*_figure_skipped`` and the confusion counts are
unchanged.
"""

import pickle
import sys

import numpy as np
import pytest
import yaml

from multimodal_idbn_tpu_torch import train_bimodal, train_multimodal
from multimodal_idbn_tpu_torch.models import iMDBN
from multimodal_idbn_tpu_torch.utils.wandb_compat import RecorderRun, wandb

from torch_parity import assert_models_equal

MULTIMODAL_LOGGING = {
    "log_every": 3, "log_every_pca": 2, "log_every_probe": 4,
    "log_every_energy": 5, "log_every_convergence": 5,
    "log_every_neighbors": 5, "log_every_trajectory": 5,
    "energy": {"enable": True}, "neighbors": {"enable": True, "k": 3},
    "trajectory": {"enable": True, "num_samples": 2},
    "convergence": {"enable": True, "num_steps": 6}}
BIMODAL_LOGGING = {
    "log_every": 5, "log_every_pca": 3, "log_every_probe": 3,
    "log_every_trajectory": 4,
    "trajectory": {"enable": True, "num_samples": 2}}


def _run(entry, yaml_path, tmp_path, logging, wandb_on=True):
    """Run ``entry`` on the smoke YAML with ``logging`` laid over its
    ``logging:`` section; returns (summary, the recorder run or None)."""
    cfg = yaml.safe_load(open(yaml_path))
    cfg["paths"]["save_dir"] = str(tmp_path)
    cfg["wandb"] = {"enable": wandb_on}
    cfg.setdefault("logging", {}).update(logging)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    runs = []
    wandb.init = lambda **kw: runs.append(RecorderRun(**kw)) or runs[-1]
    try:
        summary = entry.main(["--config", str(path), "--device", "cpu"])
    finally:
        del wandb.init
    return summary, (runs[0] if runs else None)


def _blocked():
    """matplotlib and pandas made unimportable, as on the card."""
    mp = pytest.MonkeyPatch()
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("matplotlib", "pandas")]:
        mp.delitem(sys.modules, name)
    mp.setitem(sys.modules, "matplotlib", None)
    mp.setitem(sys.modules, "pandas", None)
    return mp


@pytest.fixture(scope="module")
def multimodal(tmp_path_factory):
    """{"on": (summary, run), "off": (summary, None), "blocked": ...}."""
    out = {}
    for mode in ("on", "off", "blocked"):
        d = tmp_path_factory.mktemp(f"multimodal-{mode}")
        mp = _blocked() if mode == "blocked" else None
        try:
            out[mode] = _run(train_multimodal, "configs/smoke_multimodal.yaml",
                             d, MULTIMODAL_LOGGING, wandb_on=mode != "off")
        finally:
            if mp is not None:
                mp.undo()
    return out


@pytest.fixture(scope="module")
def bimodal(tmp_path_factory):
    out = {}
    for mode in ("on", "off", "blocked"):
        d = tmp_path_factory.mktemp(f"bimodal-{mode}")
        mp = _blocked() if mode == "blocked" else None
        try:
            out[mode] = _run(train_bimodal, "configs/smoke_bimodal.yaml", d,
                             BIMODAL_LOGGING, wandb_on=mode != "off")
        finally:
            if mp is not None:
                mp.undo()
    return out


def _epochs(run, key):
    return run.epochs(key)


def test_multimodal_diagnostics_at_their_cadences(multimodal):
    summary, run = multimodal["on"]
    model = summary["model"]
    assert run.finished and run.config["_derived_params"]["SEED"] == 0
    assert _epochs(run, "idbn/loss") == [0, 1, 2, 3]
    assert len(run.values("perf/idbn_epoch_seconds")) == 4
    assert len(run.values("perf/joint_epoch_seconds")) == 10
    assert model.image_idbn.epoch_timer.count == 4
    assert model.epoch_timer.count == 10
    assert _epochs(run, "idbn/auto_recon_mse") == [0]
    assert len(run.values(
        "embeddings/val/iDBN_layer2/pca_2d_correlations")) == 2  # 0, 2
    assert _epochs(run, "probe/layer1/labels/acc") == [0]
    assert _epochs(run, "probe/joint/labels/acc") == [0, 4, 8]
    assert len(run.values(
        "embeddings/val/Joint_top/pca_3d_correlations")) == 5
    assert _epochs(run, "joint/cd_loss") == [8, 9]
    assert _epochs(run, "cross_modality/text_top1") == list(range(10))
    assert _epochs(run, "snap/image_mse") == [0, 3, 6, 9]
    for key in ("case/fixed/summary", "conv/panel/panel/summary",
                "zcheck/z_check/cosine_mean", "auto_recon/text_top1"):
        assert _epochs(run, key) == [0, 5], key
    assert len(run.values("vecdb/knn_zT")) == 2
    assert len(run.values("pca_traj_with_recon/sample1/plot")) == 2
    for k in run.keys():
        if k.endswith("/acc"):
            assert all(0.0 <= a <= 1.0 for a in run.values(k))
    assert not [k for k in run.keys() if k.startswith("warn/")
                and k != "warn/idbn_blank_recon"]


def test_bimodal_diagnostics_at_their_cadences(bimodal):
    summary, run = bimodal["on"]
    model = summary["model"]
    assert run.finished
    assert len(run.values("idbn/loss")) == 4        # MOD1 and MOD2, 2 each
    assert model.mod1_dbn.epoch_timer.count == 2
    assert _epochs(run, "probe/joint/labels/acc") == [0, 3, 6]
    assert len(run.values(
        "embeddings/val/MOD2_MNIST100/pca_2d_correlations")) == 3
    assert _epochs(run, "snap/mod1_mse") == [0, 5]
    assert len(run.values("trajectory/sample1/mod2_to_mod1")) == 3
    assert len(run.values("trajectory/mod2_to_mod1_3d")) == 3
    assert _epochs(run, "joint/cd_loss") == [8]
    assert not [k for k in run.keys() if k.startswith("warn/")
                and k != "warn/idbn_blank_recon"]


@pytest.mark.parametrize("path", ["multimodal", "bimodal"])
def test_logging_leaves_training_unchanged(request, path):
    runs = request.getfixturevalue(path)
    on, off = runs["on"][0]["model"], runs["off"][0]["model"]
    assert runs["off"][1] is None
    assert_models_equal(on, off)
    assert on.joint_metrics_history == off.joint_metrics_history


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


@pytest.mark.parametrize("path", ["multimodal", "bimodal"])
def test_without_matplotlib_and_pandas(request, path):
    runs = request.getfixturevalue(path)
    run, blocked = runs["on"][1], runs["blocked"][1]
    numeric = run.numeric_keys()
    assert numeric == blocked.numeric_keys()
    # figures log an epoch too, and timings vary
    for k in numeric - {k for k in numeric if k.startswith("perf/")} - {
            "epoch"}:
        with_mpl, without = run.values(k), blocked.values(k)
        assert len(with_mpl) == len(without), k
        for a, b in zip(with_mpl, without):
            if isinstance(a, dict):
                assert a == b, k
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
    warns = [k for k in blocked.keys() if k.startswith("warn/")
             and k != "warn/idbn_blank_recon"]
    assert warns and all(k.endswith("_figure_skipped") for k in warns)
    assert all("matplotlib" in blocked.values(k)[0] for k in warns)
    tables = [k for k in run.keys() if k.endswith("/confusion_table")]
    assert tables
    for k in tables:
        for with_pd, without in zip(run.values(k), blocked.values(k)):
            assert with_pd.dataframe is not None and without.dataframe is None
            assert without.columns[0] == "True"
            np.testing.assert_array_equal(
                with_pd.dataframe.values, [row[1:] for row in without.data])
            assert list(with_pd.dataframe.index) == [row[0] for row in
                                                     without.data]


@pytest.mark.parametrize("entry", [train_multimodal, train_bimodal])
def test_wandb_enable_is_accepted(entry):
    path = ("configs/smoke_multimodal.yaml" if entry is train_multimodal
            else "configs/smoke_bimodal.yaml")
    cfg = yaml.safe_load(open(path))
    cfg["wandb"] = {"enable": True}
    entry.check_supported(cfg)


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
