"""Crash-safe resume of the port on the CPU, at small sizes, bimodal
family: the bimodal joint phase restored from a mid-training checkpoint
and continued is bit-identical to the uninterrupted run. The
``train_bimodal`` entry point crashed and run again:
tests/test_torch_resume_bimodal_entry.py; the flagship family:
tests/test_torch_resume*.py. Everything here is exact.
"""

import numpy as np
import pytest

import multimodal_idbn_tpu_torch.checkpoint as tck

from torch_parity import (InjectedCrash, assert_models_equal, crash_after,
                          randomize, small_bimodal)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _model(seed=0):
    return randomize(small_bimodal(seed), np.random.RandomState(1),
                     momentum=False)


@pytest.fixture(scope="module")
def straight_bimodal():
    """The uninterrupted 9-epoch run both stops are held against."""
    m = _model()
    m.train_joint(9)
    return m


@pytest.mark.parametrize("stop", [3, 8])
def test_bimodal_joint_resume_bit_identical(tmp_path, monkeypatch,
                                            straight_bimodal, stop):
    straight = straight_bimodal
    ck = str(tmp_path / "bimodal_joint.ckpt.npz")
    crashed = _model()
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
