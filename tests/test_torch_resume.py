"""Crash-safe resume of the port on the CPU, at small sizes, flagship
family: an iDBN restored from a mid-training checkpoint and continued is
bit-identical to the uninterrupted run, and the train calls check their
resume arguments. The iMDBN joint phase: tests/test_torch_resume_joint.py;
the ``train_multimodal`` entry point crashed and run again:
tests/test_torch_resume_entry*.py; the bimodal family:
tests/test_torch_resume_bimodal*.py. Everything here is exact.
"""

import pytest

import multimodal_idbn_tpu_torch.checkpoint as tck

from torch_parity import assert_models_equal, small_bimodal, small_imdbn
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


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
