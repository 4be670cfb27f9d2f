"""The diagnostics slice end to end on the CPU, bimodal family: the
``train_bimodal`` entry point on the smoke configuration with
``wandb.enable: true`` and W&B's ``init`` replaced by one that returns a
``RecorderRun`` (the flagship family: tests/test_torch_logging_slice.py,
whose checks these are).
"""

import pytest

from multimodal_idbn_tpu_torch import train_bimodal

from torch_parity import (check_logging_leaves_training_unchanged,
                          check_wandb_enable_is_accepted,
                          check_without_matplotlib_and_pandas, logged_runs)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

YAML = "configs/smoke_bimodal.yaml"
BIMODAL_LOGGING = {
    "log_every": 5, "log_every_pca": 3, "log_every_probe": 3,
    "log_every_trajectory": 4,
    "trajectory": {"enable": True, "num_samples": 2}}


@pytest.fixture(scope="module")
def bimodal(tmp_path_factory):
    return logged_runs(train_bimodal, YAML, BIMODAL_LOGGING,
                       tmp_path_factory, "bimodal")


def test_bimodal_diagnostics_at_their_cadences(bimodal):
    summary, run = bimodal["on"]
    model = summary["model"]
    assert run.finished
    assert len(run.values("idbn/loss")) == 4        # MOD1 and MOD2, 2 each
    assert model.mod1_dbn.epoch_timer.count == 2
    assert run.epochs("probe/joint/labels/acc") == [0, 3, 6]
    assert len(run.values(
        "embeddings/val/MOD2_MNIST100/pca_2d_correlations")) == 3
    assert run.epochs("snap/mod1_mse") == [0, 5]
    assert len(run.values("trajectory/sample1/mod2_to_mod1")) == 3
    assert len(run.values("trajectory/mod2_to_mod1_3d")) == 3
    assert run.epochs("joint/cd_loss") == [8]
    assert not [k for k in run.keys() if k.startswith("warn/")
                and k != "warn/idbn_blank_recon"]


@pytest.mark.parametrize("path", ["bimodal"])
def test_logging_leaves_training_unchanged(request, path):
    check_logging_leaves_training_unchanged(request.getfixturevalue(path))


@pytest.mark.parametrize("path", ["bimodal"])
def test_without_matplotlib_and_pandas(request, path):
    check_without_matplotlib_and_pandas(request.getfixturevalue(path))


@pytest.mark.parametrize("entry", [train_bimodal])
def test_wandb_enable_is_accepted(entry):
    check_wandb_enable_is_accepted(entry, YAML)
