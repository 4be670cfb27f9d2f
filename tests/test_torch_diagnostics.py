"""The port's diagnostics (``multimodal_idbn_tpu_torch.utils``) held against
the JAX package's (``multimodal_idbn_tpu.utils``) on one tiny iMDBN whose
weights are carried into both packages through ``convert``: image
[144, 32, 16], 4 labels, joint 20x12, the same loaders on both sides.

Tolerances: PCA, bin labels, the stratified split and the top-k indices
exactly; Spearman to 1e-6 (both are scipy's); the linear probe's
predictions exactly and its best parameters to 1e-5 given the same
initial weights; free energies, the IMG→TXT / TXT→IMG traces and their
post-hoc statistics to 1e-5 (fp32, another summation order), with the
draws pinned by ``torch_parity.both_deterministic``. For every logging
function that tests/test_utils_diagnostics.py covers, a recorder run
receives the same keys, with payloads of the same types, in both
packages (matplotlib and pandas are installed here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.models import iMDBN as JiMDBN
from multimodal_idbn_tpu.utils import conditional_steps as jcs
from multimodal_idbn_tpu.utils import energy_utils as jeu
from multimodal_idbn_tpu.utils import imdbn_logging as jil
from multimodal_idbn_tpu.utils import pca as jpca
from multimodal_idbn_tpu.utils import probe_utils as jpu
from multimodal_idbn_tpu.utils import profiling as jprof
from multimodal_idbn_tpu.utils import wandb_utils as jwu
from multimodal_idbn_tpu_torch import convert
from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform
from multimodal_idbn_tpu_torch.models import iMDBN
from multimodal_idbn_tpu_torch.utils import conditional_steps as tcs
from multimodal_idbn_tpu_torch.utils import energy_utils as teu
from multimodal_idbn_tpu_torch.utils import imdbn_logging as til
from multimodal_idbn_tpu_torch.utils import pca as tpca
from multimodal_idbn_tpu_torch.utils import probe_utils as tpu
from multimodal_idbn_tpu_torch.utils import profiling as tprof
from multimodal_idbn_tpu_torch.utils import wandb_utils as twu
from multimodal_idbn_tpu_torch.utils.wandb_compat import RecorderRun

from torch_parity import (SMALL_PARAMS, both_deterministic, jax_state,
                          randomize, state_np)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
K, SIDE = 4, 12
LAYERS, JOINT = [SIDE * SIDE, 32, 16], 12
Dz = LAYERS[-1]
PARAMS = dict(SMALL_PARAMS, CROSS_GIBBS_STEPS=4, JOINT_AUX_COND_STEPS=3)


@pytest.fixture(scope="module", autouse=True)
def _free_compiled_programs():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """The same iMDBN in both packages on the same loaders: seeded weights
    and class means in the port's, carried into the JAX package's."""
    train, val, _ = create_dataloaders_uniform(
        batch_size=16, n_samples=80, num_classes=K, side=SIDE, seed=0)
    tm = iMDBN(LAYERS, JOINT, params=dict(PARAMS), dataloader=train,
               val_loader=val, device="cpu", num_labels=K, seed=0)
    randomize(tm, np.random.RandomState(3), momentum=False)
    tm.z_class_mean = torch.as_tensor(
        np.random.RandomState(4).rand(K, Dz).astype(np.float32))
    layout = convert.to_numpy(tm.image_idbn.states(), tm.joint_rbm.state,
                              tm.z_class_mean)
    jm = JiMDBN(LAYERS, JOINT, params=dict(PARAMS), dataloader=train,
                val_loader=val, num_labels=K, seed=0)
    parts = convert.from_jax_numpy(layout, device="cpu")
    jm.image_idbn._set_states(tuple(jax_state(state_np(s))
                                    for s in parts["image"]))
    jm.joint_rbm.state = jax_state(state_np(parts["joint"]))
    jm.z_class_mean = jnp.asarray(layout["z_class_mean"])
    arch = tmp_path_factory.mktemp("arch")
    tm.image_idbn.arch_dir = jm.image_idbn.arch_dir = str(arch)
    return tm, jm


def _jax_init(D, n_classes):
    """The initial probe weights JAX draws (probe_utils.py:192-197)."""
    key = jax.random.key(0)
    lim = 1.0 / np.sqrt(max(1, D))
    return (np.asarray(jax.random.uniform(key, (D, n_classes), jnp.float32,
                                          -lim, lim)),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                          (n_classes,), jnp.float32, -lim,
                                          lim)))


def _fresh_runs(tm, jm, monkeypatch):
    """New recorder runs on both models, no cached val case, panel or bank,
    and the port's probes started from JAX's initial weights."""
    monkeypatch.setattr(tpu, "default_probe_init", _jax_init)
    tm.wandb_run, jm.wandb_run = RecorderRun(), RecorderRun()
    tm.image_idbn.wandb_run = tm.wandb_run
    jm.image_idbn.wandb_run = jm.wandb_run
    for m in (tm, jm):
        for cache in ("_fixed_val_case", "_fixed_val_panel", "_Z_bank"):
            if hasattr(m, cache):
                delattr(m, cache)
    return tm.wandb_run, jm.wandb_run


def _close(a, b, atol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=atol)


def _assert_trace_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list) and w and isinstance(w[0], float):
            _close(g, w)
        elif isinstance(w, float):
            _close(g, w)
        else:
            assert g == w, k


# ------------------------- numpy functions -------------------------------

@pytest.mark.parametrize("shape,k", [((50, 10), 2), ((7, 3), 3), ((4, 2), 3)])
def test_pca_equals_jax(shape, k):
    X = np.random.RandomState(shape[0]).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(tpca.pca_fit_transform(X, k),
                                  jpca.pca_fit_transform(X, k))
    np.testing.assert_array_equal(tpca.PCA(k).fit_transform(X),
                                  jpca.PCA(k).fit_transform(X))


@pytest.mark.parametrize("values,n_bins", [
    (np.arange(100, dtype=np.float32), 5), (np.ones(20, np.float32), 3),
    (np.random.RandomState(0).rand(58).astype(np.float32), 5)])
def test_bins_split_and_spearman_equal_jax(values, n_bins):
    yt, et = tpu.make_bin_labels(values, n_bins)
    yj, ej = jpu.make_bin_labels(values, n_bins)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(et, ej)
    assert tpu._format_bin_names(et) == jpu._format_bin_names(ej)
    assert tpu.stratified_split(yt, 0.2, 42) == jpu.stratified_split(
        yj, 0.2, 42)
    other = np.random.RandomState(1).randn(len(values))
    if np.ptp(values) > 0:
        assert abs(twu._spearmanr(other, values)
                   - jwu._spearmanr(other, values)) <= 1e-6


# ------------------------- the linear probe ------------------------------

def _jax_probe_best(Xtr, ytr, Xva, yva, W0, b0, max_steps, lr, patience):
    """JAX probe_utils.py:199-228 with its best parameters returned (the
    JAX function keeps them inside): its ``_adamw_step`` and its loop."""
    def ce(params, X, y):
        logp = jax.nn.log_softmax(X @ params[0] + params[1], axis=-1)
        return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

    grad_fn = jax.value_and_grad(ce)

    def cond(s):
        return (s[0] < max_steps) & (s[6] < patience)

    def body(s):
        step, params, m, v, best_loss, best_params, no_improve = s
        _, g = grad_fn(params, Xtr, ytr)
        params, m, v = jpu._adamw_step(params, m, v, g, step + 1, lr, 0.0)
        v_loss = ce(params, Xva, yva)
        improved = v_loss < best_loss
        best_params = jax.tree_util.tree_map(
            lambda bp, p: jnp.where(improved, p, bp), best_params, params)
        return (step + 1, params, m, v, jnp.where(improved, v_loss,
                                                  best_loss), best_params,
                jnp.where(improved, 0, no_improve + 1))

    zeros = (jnp.zeros_like(W0), jnp.zeros_like(b0))
    state = jax.lax.while_loop(cond, body, (
        jnp.asarray(0), (W0, b0), zeros, zeros,
        jnp.asarray(jnp.inf, jnp.float32), (W0, b0), jnp.asarray(0)))
    return state[5]


@pytest.mark.parametrize("max_steps,patience,check_every", [
    (300, 20, 25), (300, 20, 1), (1000, 3, 1000), (50, 0, 25), (300, 20, 7),
    (300, 20, 300)])
def test_linear_probe_matches_jax(max_steps, patience, check_every):
    rs = np.random.RandomState(max_steps + patience)
    X = rs.randn(120, 8).astype(np.float32)
    y = (X @ rs.randn(8, 3)).argmax(1)
    Xtr, ytr, Xva, yva = X[:90], y[:90], X[90:], y[90:]
    W0, b0 = (jnp.asarray(a) for a in _jax_init(8, 3))
    acc_j, true_j, pred_j = jpu.train_linear_classifier(
        Xtr, ytr, Xva, yva, n_classes=3, max_steps=max_steps, lr=5e-2,
        patience=patience)
    acc_t, true_t, pred_t = tpu.train_linear_classifier(
        Xtr, ytr, Xva, yva, n_classes=3, max_steps=max_steps, lr=5e-2,
        patience=patience, init=(np.asarray(W0), np.asarray(b0)),
        check_every=check_every)
    assert (acc_t, true_t, pred_t) == (acc_j, true_j, pred_j)
    Wj, bj = _jax_probe_best(*(jnp.asarray(a) for a in (Xtr, ytr, Xva, yva)),
                             W0, b0, max_steps, 5e-2, patience)
    pj = np.asarray((jnp.asarray(Xva) @ Wj + bj).argmax(1))
    np.testing.assert_array_equal(pj, pred_j)  # the copy is JAX's loop
    Wt, bt = tpu.fit_linear_probe(
        *(torch.as_tensor(a) for a in (Xtr, ytr.astype(np.int64), Xva,
                                       yva.astype(np.int64))),
        torch.tensor(np.array(W0)), torch.tensor(np.array(b0)),
        max_steps=max_steps, lr=5e-2, patience=patience,
        check_every=check_every)
    _close(Wt, Wj)
    _close(bt, bj)


def test_default_probe_init_is_torch_linear_range_and_device_free():
    W0, b0 = tpu.default_probe_init(16, 5)
    assert W0.shape == (16, 5) and b0.shape == (5,)
    assert float(W0.abs().max()) <= 0.25 and float(b0.abs().max()) <= 0.25
    W1, _ = tpu.default_probe_init(16, 5)
    assert torch.equal(W0, W1)


# ------------------------- energy and traces ------------------------------

def test_free_energies_match_jax(twins):
    tm, jm = twins
    rs = np.random.RandomState(5)
    v = rs.rand(6, Dz + K).astype(np.float32)
    _close(teu.rbm_free_energy(tm.joint_rbm, v),
           jeu.rbm_free_energy(jm.joint_rbm, v))
    z = rs.rand(5, Dz).astype(np.float32)
    _close(teu.class_free_energies(tm.joint_rbm, z, K, Dz),
           jeu.class_free_energies(jm.joint_rbm, z, K, Dz))
    step = np.concatenate([z, np.full((5, K), 0.25, np.float32)], 1)
    for softmax_y in (True, False):
        _close(teu._deterministic_img2txt_step(tm.joint_rbm, step, Dz, K,
                                               softmax_y),
               jeu._deterministic_img2txt_step(jm.joint_rbm, step, Dz, K,
                                               softmax_y))


@pytest.mark.parametrize("steps", [8, 30])
def test_energy_trace_matches_jax(twins, steps):
    tm, jm = twins
    img, lbl = teu.pick_fixed_val_case(tm)
    _assert_trace_close(teu.trace_single_img2txt(tm, img, lbl, steps=steps),
                        jeu.trace_single_img2txt(jm, img, lbl, steps=steps))


@pytest.mark.parametrize("sample_h,sample_v", [(False, False), (True, True)])
def test_img2txt_traces_match_jax(monkeypatch, twins, sample_h, sample_v):
    tm, jm = twins
    imgs, lbls = tcs.build_or_get_fixed_val_panel(tm, per_class=2)
    with both_deterministic(monkeypatch):
        got = tcs.trace_img2txt_cross_batch(tm, imgs, lbls, max_steps=12,
                                            sample_h=sample_h,
                                            sample_v=sample_v)
        want = jcs.trace_img2txt_cross_batch(jm, imgs, lbls, max_steps=12,
                                             sample_h=sample_h,
                                             sample_v=sample_v)
    assert len(got) == len(want) == len(imgs)
    for g, w in zip(got, want):
        _assert_trace_close(g, w)
    steps = [o["steps_to_converge"] for o in got]
    assert tcs._steps_stats(steps, 12)[0] == jcs._steps_stats(steps, 12)[0]


@pytest.mark.parametrize("init,ema_beta", [("reference", 0.0),
                                           ("reference", 0.4),
                                           ("random", 0.0)])
def test_txt2img_traces_match_jax(monkeypatch, twins, init, ema_beta):
    tm, jm = twins
    imgs, lbls = tcs.build_or_get_fixed_val_panel(tm, per_class=2)
    with both_deterministic(monkeypatch):
        got, zt = tcs.trace_txt2img_cross_batch(tm, imgs, lbls, max_steps=9,
                                                ema_beta=ema_beta, init=init)
        want, zj = jcs.trace_txt2img_cross_batch(jm, imgs, lbls,
                                                 max_steps=9,
                                                 ema_beta=ema_beta,
                                                 init=init)
    _close(zt, zj)
    for g, w in zip(got, want):
        _assert_trace_close(g, w)


def test_trajectory_chain_matches_jax(monkeypatch, twins):
    tm, jm = twins
    y = np.eye(K, dtype=np.float32)[[2]]
    with both_deterministic(monkeypatch):
        _close(til._run_traj(tm, y, 6), jil._run_traj(jm, y, 6))


# ------------------------- banks and neighbours ----------------------------

@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_val_bank_and_topk_equal_jax(twins, metric):
    tm, jm = twins
    til.ensure_val_bank(tm)
    jil.ensure_val_bank(jm)
    _close(tm._Z_bank, jm._Z_bank)
    for bank in ("_X_bank", "_Y_bank", "_H_bank"):
        np.testing.assert_array_equal(getattr(tm, bank), getattr(jm, bank))
    q = jm._Z_bank[:5]
    it, st = til.topk_similar_in_latent(tm, q, k=4, metric=metric)
    ij, sj = jil.topk_similar_in_latent(jm, q, k=4, metric=metric)
    np.testing.assert_array_equal(it, ij)
    _close(st, sj)
    for k in range(K):
        assert til.find_first_val_index_with_label(tm, k) == \
            jil.find_first_val_index_with_label(jm, k)


# ------------------------- logged keys -------------------------------------

def _probe(pkg):
    return lambda m: pkg.log_linear_probe(m.image_idbn, epoch=0, n_bins=3,
                                          steps=50, layer_tag="layer2",
                                          upto_layer=2)


LOGGERS = {
    "log_linear_probe": (_probe(tpu), _probe(jpu)),
    "log_joint_linear_probe": tuple(
        (lambda pkg: lambda m: pkg.log_joint_linear_probe(
            m, epoch=0, n_bins=3, steps=50))(p) for p in (tpu, jpu)),
    "run_and_log_fixed_case": tuple(
        (lambda pkg: lambda m: pkg.run_and_log_fixed_case(
            m, epoch=0, steps=6))(p) for p in (teu, jeu)),
    "run_and_log_cross_panel": tuple(
        (lambda pkg: lambda m: pkg.run_and_log_cross_panel(
            m, epoch=0, per_class=1, max_steps=5))(p) for p in (tcs, jcs)),
    "run_and_log_z_mismatch_check": tuple(
        (lambda pkg: lambda m: pkg.run_and_log_z_mismatch_check(
            m, epoch=0, max_steps=4))(p) for p in (tcs, jcs)),
    "run_and_log_cross_fixed_case": tuple(
        (lambda pkg: lambda m: pkg.run_and_log_cross_fixed_case(
            m, epoch=0, max_steps=5))(p) for p in (tcs, jcs)),
    "log_vecdb_neighbors_for_traj": tuple(
        (lambda pkg: lambda m: pkg.log_vecdb_neighbors_for_traj(
            m, sample_idx=0, steps=3, k=3))(p) for p in (til, jil)),
    "trajectory_panels": tuple(
        (lambda pkg: lambda m: (
            pkg.log_latent_trajectory_with_recon_panel(m, sample_idx=0,
                                                       steps=5),
            pkg.log_pca3_trajectory(m, sample_idx=0, steps=3),
            pkg.log_pca3_trajectory_with_recon_panel(m, sample_idx=0,
                                                     steps=3)))(p)
        for p in (til, jil)),
    "log_joint_auto_recon": tuple(
        (lambda pkg: lambda m: pkg.log_joint_auto_recon(m, epoch=0,
                                                        num=4))(p)
        for p in (til, jil)),
}


def _types(run):
    out = {}
    for d in run.logged:
        for k, v in d.items():
            out.setdefault(k, set()).add(type(v).__name__)
    return out


@pytest.mark.parametrize("name", sorted(LOGGERS))
def test_logged_keys_equal_jax(monkeypatch, twins, name):
    tm, jm = twins
    run_t, run_j = _fresh_runs(tm, jm, monkeypatch)
    call_t, call_j = LOGGERS[name]
    with both_deterministic(monkeypatch):
        call_t(tm)
        call_j(jm)
    assert run_t.keys() == run_j.keys()
    assert _types(run_t) == _types(run_j)
    for k in run_j.numeric_keys():
        if k.endswith("/acc") or k.endswith("_mse") or "auto_recon" in k:
            _close(run_t.values(k), run_j.values(k))


def test_probe_confusion_counts_equal_jax(monkeypatch, twins):
    """The confusion tables and bin edges of one probe, as JAX's
    DataFrames (pandas is installed here), hold the same counts."""
    tm, jm = twins
    run_t, run_j = _fresh_runs(tm, jm, monkeypatch)
    _probe(tpu)(tm)
    _probe(jpu)(jm)
    for k in run_j.keys():
        if k.endswith("/confusion_table"):
            np.testing.assert_array_equal(
                run_t.values(k)[0].dataframe.values,
                run_j.values(k)[0].dataframe.values)
        if k.endswith("/bin_edges"):
            np.testing.assert_array_equal(run_t.values(k)[0],
                                          run_j.values(k)[0])


# ------------------------- profiling ---------------------------------------

def test_step_timer_logs_jax_keys():
    tt, tj = tprof.StepTimer(), jprof.StepTimer()
    for timer in (tt, tj):
        for n in (1, 3):
            with timer.step(n):
                pass
    assert tt.count == tj.count == 4
    rt, rj = RecorderRun(), RecorderRun()
    tt.log_to(rt, prefix="perf/x", epoch=2)
    tj.log_to(rj, prefix="perf/x", epoch=2)
    assert rt.keys() == rj.keys()
    tprof.StepTimer().log_to(rt)  # no steps: nothing logged
    assert len(rt.logged) == 1


def test_trace_writes_a_chrome_trace_and_passes_exceptions(tmp_path):
    with tprof.trace(str(tmp_path / "t")):
        torch.ones(3).sum()
    files = list((tmp_path / "t").glob("*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    with pytest.raises(KeyError, match="body"):
        with tprof.trace(str(tmp_path / "u")):
            raise KeyError("body")
    with tprof.trace(str(tmp_path / "v"), enabled=False):
        pass
    assert not (tmp_path / "v").exists()


def test_measure_gibbs_steps_per_sec_on_the_cpu():
    out = tprof.measure_gibbs_steps_per_sec(num_visible=12, num_hidden=8,
                                            batch_size=4, n_steps=5,
                                            groups=((8, 12),), device="cpu")
    assert sorted(out) == ["cell_updates_per_sec", "chain_steps_per_sec",
                           "elapsed_s"]
    assert out["elapsed_s"] > 0 and out["chain_steps_per_sec"] > 0


def test_global_run_helpers(monkeypatch):
    """``log_barplot`` and ``log_reconstructions_to_wandb`` log to the
    global ``wandb.run``: nothing with the stub's, their keys with one."""
    twu.log_barplot({"1-2": 0.5}, "acc", "arch", "val")
    run = RecorderRun()
    monkeypatch.setattr(twu.wandb, "run", run, raising=False)
    monkeypatch.setattr(twu.wandb, "log", run.log, raising=False)
    twu.log_barplot({"1-2": 0.5, "3-4": 0.7}, "acc", "arch", "val")
    rs = np.random.RandomState(0)
    twu.log_reconstructions_to_wandb(rs.rand(3, 16), rs.rand(3, 16))
    assert run.keys() == {"arch_val_acc_bins_plot", "reconstruction_grid"}
