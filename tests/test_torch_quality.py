"""The port's quality protocol (``multimodal_idbn_tpu_torch.quality``)
held against the JAX package's own (benchmarks/reference_head_to_head.py,
benchmarks/merge_h2h.py), imported the way tests/test_merge_h2h.py does:
the dataset bytes, the evaluation metrics (rtol 1e-6), the probes from
JAX's initial weights (equal accuracies), the statistics (equal results),
and a QUICK-schedule run of both arms on the CPU whose files the JAX
package's merge reads.
"""

import io
import json
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmarks"))

import merge_h2h  # noqa: E402
import reference_head_to_head as h2h  # noqa: E402

from multimodal_idbn_tpu_torch import quality  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several workers at once, and
    torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_schedules_and_params_are_the_protocols():
    assert quality.FLAGSHIP == h2h.FLAGSHIP
    assert quality.SCHEDULE == h2h.SCHEDULE
    assert quality.QUICK == h2h.QUICK
    for s in (quality.FLAGSHIP, quality.QUICK):
        assert quality.make_params(s, 7) == h2h.make_params(s, 7)


def test_build_dataset_is_byte_equal_to_jax(tmp_path):
    s = dict(h2h.QUICK, n_samples=96)
    h2h.build_dataset(s, tmp_path / "d.npz")
    want = np.load(tmp_path / "d.npz")
    got = quality.build_dataset(s)
    assert sorted(got) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_flagship_split_sizes():
    """2048 samples split 1434 / 307 / 307, the training split twelve
    batches (eleven of 128 and one of 26): the launch derivation's."""
    from multimodal_idbn_tpu_torch.data import train_val_test_split
    tr, va, te = train_val_test_split(2048, 0.15, 0.15, seed=42)
    assert (len(tr), len(va), len(te)) == (1434, 307, 307)
    d = quality.derived_launches("flagship", quality.FLAGSHIP, len(tr))
    assert d == {"half_step_sample": 12 * 100 * 2 * 21,
                 "chain_run": 8 * 12 * 4 + 142 * (12 * 3 + 1)}
    assert quality.derived_launches("bimodal", quality.BIMODAL, len(tr)) == {
        "half_step_sample": 12 * 100 * 5 * 21,
        "chain_run": 8 * 12 * 4 + 142 * 12 * 2}


def test_eval_metrics_match_jax():
    rs = np.random.RandomState(0)
    n, npix, k = 57, 100, 16
    y = np.eye(k, dtype=np.float32)[rs.randint(0, k, n)]
    p_y = rs.dirichlet(np.ones(k), n).astype(np.float32)
    img = (rs.rand(n, npix) > 0.8).astype(np.float32)
    img_ft = rs.rand(n, npix).astype(np.float32)
    rec = (rs.rand(n, npix) * 1.2 - 0.1).astype(np.float32)
    z = rs.rand(n, 8).astype(np.float32)
    got = quality.eval_metrics_numpy(z, y, p_y, img_ft, img, rec)
    want = h2h.eval_metrics_numpy(z, y, p_y, img_ft, img, rec)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_probe_init_is_jax_draw():
    """The kept initial probe weights are JAX's ``jax.random.key(0)``
    uniforms (multimodal_idbn_tpu/utils/probe_utils.py:192-197)."""
    key = jax.random.key(0)
    for D in (128, 500):
        lim = 1.0 / np.sqrt(D)
        W0, b0 = quality.jax_probe_init(D)
        w = jax.random.uniform(key, (D, 5), minval=-lim, maxval=lim)
        b = jax.random.uniform(jax.random.fold_in(key, 1), (5,),
                               minval=-lim, maxval=lim)
        assert W0.numpy().tobytes() == np.asarray(w).tobytes()
        assert b0.numpy().tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError):
        quality.jax_probe_init(64)


@pytest.mark.parametrize("D", [128, 500])
def test_probe_metrics_match_jax(D):
    """Both sides probe the same embeddings from the same initial
    weights: equal accuracies on every target."""
    rs = np.random.RandomState(D)
    n, k = 150, 16
    y = np.eye(k, dtype=np.float32)[rs.randint(0, k, n)]
    img = (rs.rand(n, 64) > 0.7).astype(np.float32)
    signal = np.outer(y.argmax(1) + img.sum(1) / 8, rs.randn(D))
    z = (1 / (1 + np.exp(-(signal / 8 + rs.randn(n, D))))).astype(np.float32)
    h = rs.rand(n, D).astype(np.float32)
    got = quality.probe_metrics(z, h, y, img)
    want = h2h.probe_metrics(z, h, y, img)
    assert got == want
    assert len(set(want.values())) > 1  # not all at one chance level


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_matches_merge_h2h(seed):
    rs = np.random.RandomState(seed)
    a = rs.rand(13) * 0.3
    b = rs.rand(26) * 0.3 + 0.02 * seed
    assert quality.compare(a, b) == merge_h2h.compare(a, b)
    assert quality.summarize(b) == merge_h2h.summarize(b)
    same = np.full(5, 0.092)
    assert quality.compare(same, same) == merge_h2h.compare(same, same)


def test_holm():
    # m = 4: the smallest p must be at most 0.05 / 4, so none is rejected
    assert not any(quality.holm({"a": 0.0126, "b": 0.02, "c": 0.5,
                                 "d": 0.9}).values())
    # 0.001 <= 0.05 / 4, 0.016 <= 0.05 / 3, 0.03 > 0.05 / 2: the step-down
    # stops at c, so d is kept whatever its p
    got = quality.holm({"a": 0.001, "b": 0.016, "c": 0.03, "d": 0.031})
    assert got == {"a": True, "b": True, "c": False, "d": False}


def test_recorded_arms_and_collapse_criterion():
    arms = quality.recorded_arms("flagship")
    assert (len(arms["jax"]), len(arms["reference"])) == (26, 13)
    for rec in arms["jax"].values():
        assert set(quality.FLAGSHIP_METRICS) <= set(rec)
    bim = quality.recorded_arms("bimodal")["jax"]
    recorded = json.loads(quality.RECORDED_BIMODAL.read_text())
    assert len(bim) == 11
    assert quality.collapsed("bimodal", bim) == recorded["collapsed_seeds"]
    # the recorded pool against itself: nothing is rejected
    stats = quality.compare_pools(bim, bim, quality.BIMODAL_METRICS)
    assert not any(s["holm_reject"] for s in stats.values())


def test_quick_run_of_both_arms(tmp_path):
    """One QUICK seed of each arm on the CPU: the same keys, the port's
    file in the recorded layout, read by merge_h2h and by ``compare``."""
    data = tmp_path / "d.npz"
    h2h.build_dataset(h2h.QUICK, data)
    with redirect_stderr(io.StringIO()), redirect_stdout(io.StringIO()):
        jax_rec = h2h.run_ours(h2h.QUICK, 0, data)
    out = tmp_path / "port.json"
    with redirect_stderr(io.StringIO()), redirect_stdout(io.StringIO()):
        res = quality.main(["flagship", "--seeds", "0", "--quick",
                            "--device", "cpu", "--out", str(out)])
    port_rec = res["ours"]["0"]
    assert list(port_rec) == list(jax_rec)
    assert all(np.isfinite(v) for v in port_rec.values())
    written = json.loads(out.read_text())
    ext = json.loads((ROOT / "benchmarks"
                      / "head_to_head_r5_ours_ext.json").read_text())
    assert set(ext) - {"summary"} <= set(written)
    assert written["ref"] == {} and written["seeds"] == [0]
    assert written["matmul_precision"] == "highest"
    assert set(written["digests"]) == set(written["launches"]) == {"0"}
    # the JAX package's merge reads the port's file unchanged
    jax_file = tmp_path / "jax.json"
    jax_file.write_text(json.dumps({"schedule": h2h.QUICK, "seeds": [0],
                                    "ref": {"0": jax_rec}, "ours": {}}))
    argv = sys.argv
    sys.argv = ["merge_h2h.py", f"{jax_file}:ref", str(out)]
    buf = io.StringIO()
    try:
        with redirect_stdout(buf), redirect_stderr(io.StringIO()):
            merge_h2h.main()
    finally:
        sys.argv = argv
    merged = json.loads(buf.getvalue())
    assert set(merged["stats"]) == set(quality.FLAGSHIP_METRICS)
    assert merged["ours"]["0"] == port_rec
    # and the port's own comparison against the recorded arms
    cmp = quality.comparison("flagship", [str(out)])
    assert set(cmp["arms"]) == {"jax", "reference"}
    assert set(cmp["arms"]["jax"]["stats"]) == set(quality.FLAGSHIP_METRICS)
    assert "| top1 | jax (n=26)" in quality.comparison_table(cmp)


def test_quick_bimodal_protocol_writes_the_recorded_layout(tmp_path):
    """The bimodal protocol at a cut size (16-wide stacks, 2 + 2 epochs)
    on the CPU: a per-seed record with the recorded pool's keys."""
    s = dict(quality.BIMODAL, n_samples=96, mod1_layers=(10000, 16),
             mod2_layers=(1568, 16), joint_layers=(12,), epochs_mod=2,
             epochs_joint=2, cross_steps=3, aux_cond_steps=2, cd=1,
             joint_cd=1)
    data = quality.build_bimodal_dataset(s)
    rec, launches, model = quality.run_bimodal_seed(s, 0, data, "cpu")
    want = json.loads(quality.RECORDED_BIMODAL.read_text())["seeds"]["0"]
    assert list(rec) == list(want)
    assert all(np.isfinite(v) for v in rec.values())
    assert launches == {"half_step_sample": 0, "chain_run": 0}  # the CPU
    assert len(quality.state_digest(model)) == 64


def test_merge_files_unites_per_seed_files(tmp_path):
    """``pools`` writes one file per seed; ``merge_files`` unites them in
    the recorded layouts (seeds in order, launches and digests kept)."""
    recorded = json.loads(quality.RECORDED_BIMODAL.read_text())["seeds"]
    paths = []
    for seed in ("10", "2"):
        rec = dict(recorded[seed])
        p = tmp_path / f"bimodal-{seed}.json"
        p.write_text(json.dumps({
            "schedule": quality.BIMODAL, "seeds": {seed: rec},
            "launches": {seed: {"half_step_sample": 1, "chain_run": 2}},
            "digests": {seed: seed * 32}}))
        paths.append(p)
    res = quality.merge_files("bimodal", paths)
    assert list(res["seeds"]) == ["2", "10"]
    assert res["collapse_rate"] == "0/2" and res["collapsed_seeds"] == []
    assert set(res["launches"]) == set(res["digests"]) == {"2", "10"}
    with pytest.raises(ValueError):
        quality.merge_files("bimodal", paths + paths[:1])
