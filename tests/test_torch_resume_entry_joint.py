"""The ``train_multimodal`` entry point on the CPU, crashed right after a
checkpoint write in its joint phase and run again: it resumes there and
ends bit-identical to an uninterrupted run (split by phase from
tests/test_torch_resume.py; the checks: ``torch_parity.
check_train_multimodal_crash_and_rerun``). Everything here is exact.
"""

import pytest

from torch_parity import check_train_multimodal_crash_and_rerun
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("phase,stop,message", [
    ("joint", 8, "resuming joint training at epoch 8/10")])
def test_train_multimodal_crash_and_rerun(tmp_path, monkeypatch, capsys,
                                          phase, stop, message):
    check_train_multimodal_crash_and_rerun(tmp_path, monkeypatch, capsys,
                                           phase, stop, message)
