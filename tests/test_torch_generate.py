"""The port's serving entry point on the CPU: ``python -m
multimodal_idbn_tpu_torch.generate`` on a model the port saved, in both
modes, against the model's own methods (exact) and against the JAX
package's ``scripts/generate.py`` flow on the same weights under the
deterministic sampler modes (1e-5 absolute).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.models import iMDBN as JiMDBN
from multimodal_idbn_tpu_torch import generate

from torch_parity import (IMG_LAYERS, JOINT_HIDDEN, K, SMALL_PARAMS,
                          both_deterministic, jax_state, randomize,
                          small_imdbn, state_np, t)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def saved(tmp_path):
    m = randomize(small_imdbn(), np.random.RandomState(0))
    m.z_class_mean = t(np.random.RandomState(1).rand(K, 32))
    m.save_model(str(tmp_path / "m.pkl"))
    return m, str(tmp_path / "m.pkl")


def _run(model_path, tmp_path, *extra):
    out = tmp_path / "draws.npz"
    imgs = generate.main(["--model", model_path, "--device", "cpu", "--out",
                          str(out), *extra])
    with np.load(out) as f:
        np.testing.assert_array_equal(f["images"], imgs)
        return imgs, f["labels"]


def test_sampled_mode(saved, tmp_path, capsys):
    m, path = saved
    imgs, labels = _run(path, tmp_path, "--labels", "3", "0", "1",
                        "--n-per-label", "2", "--seed", "4")
    assert imgs.shape == (6, 256) and imgs.dtype == np.float32
    np.testing.assert_array_equal(labels, [3, 3, 0, 0, 1, 1])
    assert labels.dtype == np.int64
    assert np.isfinite(imgs).all() and imgs.min() >= 0 and imgs.max() <= 1
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"[generate] 6 images (sampled) -> "
                    f"{tmp_path / 'draws.npz'} "
                    f"(pixel mean {imgs.mean():.4f})")
    np.testing.assert_array_equal(
        imgs, m.sample_txt2img(labels, seed=4).numpy())
    again, _ = _run(path, tmp_path, "--labels", "3", "0", "1",
                    "--n-per-label", "2", "--seed", "4")
    np.testing.assert_array_equal(again, imgs)  # --seed fixes the draw
    other, _ = _run(path, tmp_path, "--labels", "3", "0", "1",
                    "--n-per-label", "2", "--seed", "5")
    assert not np.array_equal(other, imgs)
    short, _ = _run(path, tmp_path, "--labels", "3", "0", "1",
                    "--n-per-label", "2", "--seed", "4", "--gibbs-steps", "1")
    np.testing.assert_array_equal(
        short, m.sample_txt2img(labels, gibbs_steps=1, seed=4).numpy())
    assert not np.array_equal(short, imgs)


def test_mean_mode(saved, tmp_path, capsys):
    m, path = saved
    imgs, labels = _run(path, tmp_path, "--labels", "2", "1", "--mean",
                        "--seed", "7", "--png", str(tmp_path / "g.png"))
    assert imgs.shape == (2, 256) and (tmp_path / "g.png").stat().st_size > 0
    assert "(mean decode)" in capsys.readouterr().out
    m.joint_rbm.reseed(7)
    np.testing.assert_array_equal(imgs, m.txt2img([2, 1]).numpy())
    m.joint_rbm.reseed(7)
    m.cross_steps = 2
    short, _ = _run(path, tmp_path, "--labels", "2", "1", "--mean", "--seed",
                    "7", "--gibbs-steps", "2")
    np.testing.assert_array_equal(short, m.txt2img([2, 1]).numpy())
    assert not np.array_equal(short, imgs)


def test_generate_matches_the_jax_flow(saved, tmp_path, monkeypatch):
    """scripts/generate.py:74-89 on the same weights: load, from_payload,
    sample_txt2img / txt2img."""
    m, path = saved
    jm = JiMDBN(IMG_LAYERS, JOINT_HIDDEN, params=dict(SMALL_PARAMS),
                dataloader=None, val_loader=None, num_labels=K, seed=0)
    jm.image_idbn._set_states(tuple(jax_state(state_np(s))
                                    for s in m.image_idbn.states()))
    jm.joint_rbm.state = jax_state(state_np(m.joint_rbm.state))
    jm.z_class_mean = jnp.asarray(m.z_class_mean.numpy())
    jm.save_model(str(tmp_path / "j.pkl"))
    jm = JiMDBN.from_payload(JiMDBN.load_model(str(tmp_path / "j.pkl")))
    ids = np.repeat(np.asarray([1, 3], np.int64), 2)
    with both_deterministic(monkeypatch):
        sampled, _ = _run(path, tmp_path, "--labels", "1", "3",
                          "--n-per-label", "2", "--gibbs-steps", "3")
        mean, _ = _run(path, tmp_path, "--labels", "1", "3", "--n-per-label",
                       "2", "--mean")
        np.testing.assert_allclose(
            sampled, np.asarray(jm.sample_txt2img(ids, gibbs_steps=3,
                                                  seed=0)), atol=1e-5)
        np.testing.assert_allclose(mean, np.asarray(jm.txt2img(ids)),
                                   atol=1e-5)


def test_refusals(saved, tmp_path):
    _, path = saved
    for bad in (["--labels", "4"], ["--labels", "0", "-1"]):
        with pytest.raises(ValueError, match=r"label ids must be in \[0, 4\)"):
            _run(path, tmp_path, *bad)
    # --matmul-precision, refused until the variants were ported, now sets
    # the precision of the plain products; only JAX's three names pass
    before = torch.get_float32_matmul_precision()
    try:
        _run(path, tmp_path, "--labels", "0", "--matmul-precision", "default")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
    with pytest.raises(SystemExit):
        _run(path, tmp_path, "--labels", "0", "--matmul-precision", "bf16")
    with pytest.raises(SystemExit):
        _run(path, tmp_path, "--labels", "0", "--n-per-label", "0")
    assert generate.parse_args(["--model", "m", "--labels", "1"]).device == \
        "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate.main(["--model", path, "--labels", "0"])


def test_module_runs_as_a_program(saved, tmp_path):
    _, path = saved
    base = [sys.executable, "-m", "multimodal_idbn_tpu_torch.generate",
            "--model", path, "--device", "cpu", "--out",
            str(tmp_path / "o.npz"), "--labels"]
    ok = subprocess.run(base + ["0", "2"], cwd=ROOT, capture_output=True,
                        text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert "[generate] 2 images (sampled)" in ok.stdout
    with np.load(tmp_path / "o.npz") as f:
        assert f["images"].shape == (2, 256)
    bad = subprocess.run(base + ["9"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode != 0 and "label ids must be in [0, 4)" in bad.stderr
