"""Crash-safe resume of the port's iMDBN joint phase on the CPU, at small
sizes: stopped before, at and after the warm-up boundary, restored from
its checkpoint and continued, it is bit-identical to the uninterrupted
run (split from tests/test_torch_resume.py). Everything here is exact.
"""

import numpy as np
import pytest
import torch

import multimodal_idbn_tpu_torch.checkpoint as tck

from torch_parity import (InjectedCrash, assert_models_equal, crash_after,
                          randomize, small_imdbn)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


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
