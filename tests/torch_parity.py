"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy inputs, state conversion both ways, the two
deterministic-sampler modes (JAX: the ``det_random`` monkeypatch of
tests/test_rbm_oracle.py:24-38; port: ``ops.rng.deterministic``), and the
same small iMDBN / iMDBN_BiModal built in both packages."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.ops import rbm_ops as jrbm
from multimodal_idbn_tpu_torch import convert
from multimodal_idbn_tpu_torch.ops import rng as trng

FIELDS = convert.FIELDS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op threads pinned to one for the tests of a module
    that imports this fixture, and restored after them: the suite runs six
    workers on a few cores, where every worker's thread pool would compete
    for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_state(rs: np.random.RandomState, V: int, H: int, momentum=False):
    """Seeded numpy RBM fields; nonzero momentum buffers on request."""
    out = {"w": (rs.randn(V, H) / np.sqrt(V)).astype(np.float32),
           "hb": (0.1 * rs.randn(H)).astype(np.float32),
           "vb": (0.1 * rs.randn(V)).astype(np.float32)}
    for f, shape in (("w_m", (V, H)), ("hb_m", (H,)), ("vb_m", (V,))):
        out[f] = ((0.01 * rs.randn(*shape)).astype(np.float32) if momentum
                  else np.zeros(shape, np.float32))
    return out


def jax_state(fields) -> jrbm.RBMState:
    return jrbm.RBMState(*(jnp.asarray(fields[f]) for f in FIELDS))


def torch_state(fields):
    return convert.state_from_numpy(fields, "", device="cpu")


def state_np(state) -> dict:
    """numpy fields of a JAX or a port state (bf16 widened exactly to
    fp32)."""
    if isinstance(state, jrbm.RBMState):
        return {f: np.asarray(getattr(state, f), np.float32) for f in FIELDS}
    return {f: getattr(state, f).detach().cpu().float().numpy()
            for f in FIELDS}


def assert_states_close(a, b, atol):
    a, b = state_np(a), state_np(b)
    for f in FIELDS:
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=atol,
                                   err_msg=f"field {f}")


def t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def close(a, b, atol):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol)


@contextlib.contextmanager
def both_deterministic(monkeypatch):
    """JAX draws pinned like tests/test_rbm_oracle.py:24-38 (uniform 0.5,
    normal 0, categorical argmax) and the port in its deterministic
    sampler mode. Jit caches are cleared so no trace made with real
    draws is reused."""
    def fake_uniform(key, shape=(), dtype=jnp.float32, minval=0.0,
                     maxval=1.0):
        return jnp.full(shape, 0.5, dtype)

    def fake_normal(key, shape=(), dtype=jnp.float32):
        return jnp.zeros(shape, dtype)

    def fake_categorical(key, logits, axis=-1, shape=None):
        return jnp.argmax(logits, axis=axis)

    jax.clear_caches()
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(jax.random, "normal", fake_normal)
    monkeypatch.setattr(jax.random, "categorical", fake_categorical)
    try:
        with trng.deterministic():
            yield
    finally:
        monkeypatch.undo()
        jax.clear_caches()


# The small models of the persistence, resume and inference tests: image
# [256, 64, 32], joint 36x24, 4 labels; bimodal [256, 32] + [1568, 32],
# joint [16].
SMALL_PARAMS = {
    "LEARNING_RATE": 0.1, "WEIGHT_PENALTY": 1e-4, "INIT_MOMENTUM": 0.5,
    "FINAL_MOMENTUM": 0.9, "LEARNING_RATE_DYNAMIC": True, "CD": 1,
    "JOINT_CD": 1, "JOINT_LEARNING_RATE": 0.04, "CROSS_GIBBS_STEPS": 3,
    "JOINT_AUX_COND_STEPS": 2, "SEED": 0}
SIDE, K = 16, 4
IMG_LAYERS, JOINT_HIDDEN = [SIDE * SIDE, 64, 32], 24
MOD1_LAYERS, MOD2_LAYERS, BIMODAL_JOINT = [SIDE * SIDE, 32], [1568, 32], [16]


class FakeGraph:
    """A stand-in ``torch.cuda.CUDAGraph``: a replay runs nothing."""

    def replay(self):
        pass


def graph_stand_ins(monkeypatch):
    """A launch counter and the CUDA calls of a capture replaced by
    stand-ins that run on the CPU (a stand-in capture runs its body once,
    a replay nothing); returns (the counter's library, a serving cache on
    the CPU)."""
    from multimodal_idbn_tpu_torch.ops import _cuda, graphs
    lib = _cuda.CudaLibrary.__new__(_cuda.CudaLibrary)
    lib.source = _cuda.CSRC / "fake.cu"
    lib.functions = {"k": []}
    lib.launches_by_entry = {"k": 0}
    monkeypatch.setattr(_cuda, "LIBRARIES", [lib])

    class Stream:
        def wait_stream(self, other):
            pass

    for name, fn in (("Stream", lambda *a: Stream()),
                     ("current_stream", lambda *a: Stream()),
                     ("stream", lambda s: contextlib.nullcontext()),
                     ("graph", lambda g, **k: contextlib.nullcontext()),
                     ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("memory_reserved", lambda *a: 0),
                     ("CUDAGraph", FakeGraph)):
        monkeypatch.setattr(torch.cuda, name, fn)
    cache = graphs.ServingGraphs.__new__(graphs.ServingGraphs)
    cache.device = torch.device("cpu")
    cache.graphs, cache.buffers = {}, graphs._Buffers()
    return lib, cache


def small_loaders(bimodal=False, **kw):
    """The port's loaders over 64 seeded samples (44 training rows: two
    batches of 16 and a remainder of 12)."""
    from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform
    kw = dict(dict(batch_size=16, n_samples=64, num_classes=K, side=SIDE,
                   seed=0), **kw)
    if bimodal:
        kw["second_modality"] = "mnist100"
    return create_dataloaders_uniform(**kw)


def small_imdbn(seed=0, loaders=None, **params):
    from multimodal_idbn_tpu_torch.models import iMDBN
    train, val, _ = loaders or small_loaders()
    return iMDBN(IMG_LAYERS, JOINT_HIDDEN,
                 params=dict(SMALL_PARAMS, **params), dataloader=train,
                 val_loader=val, device="cpu", num_labels=K, seed=seed)


def small_bimodal(seed=0, loaders=None, **params):
    from multimodal_idbn_tpu_torch.models import iMDBN_BiModal
    train, val, _ = loaders or small_loaders(bimodal=True)
    return iMDBN_BiModal(MOD1_LAYERS, MOD2_LAYERS, BIMODAL_JOINT,
                         dict(SMALL_PARAMS, **params), train, val,
                         device="cpu", seed=seed)


def randomize(model, rs, momentum=True):
    """Seeded weights, biases and momentum into every RBM of a port model."""
    from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    for rbm in _collect_rbms(model).values():
        rbm.state = torch_state(np_state(rs, rbm.num_visible, rbm.num_hidden,
                                         momentum=momentum))
    return model


def rbm_arrays(model) -> dict:
    """{checkpoint name/field: numpy array} of a model of either package."""
    if type(model).__module__.startswith("multimodal_idbn_tpu_torch"):
        from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    else:
        from multimodal_idbn_tpu.checkpoint import _collect_rbms
    return {f"{name}/{f}": a for name, rbm in _collect_rbms(model).items()
            for f, a in state_np(rbm.state).items()}


def assert_models_equal(a, b):
    """Every state of two models (of either package) is bit-equal."""
    fa, fb = rbm_arrays(a), rbm_arrays(b)
    assert sorted(fa) == sorted(fb) and fa
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# -- the logged smoke runs (test_torch_logging_slice*.py) ---------------------

def run_logged(entry, yaml_path, tmp_path, logging, wandb_on=True):
    """Run ``entry`` on the smoke YAML with ``logging`` laid over its
    ``logging:`` section and W&B's ``init`` replaced by one that returns a
    ``RecorderRun``; returns (summary, the recorder run or None)."""
    import yaml
    from multimodal_idbn_tpu_torch.utils.wandb_compat import (RecorderRun,
                                                              wandb)
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


def _blocked_optional():
    """matplotlib and pandas made unimportable, as on the card."""
    import sys

    import pytest
    mp = pytest.MonkeyPatch()
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("matplotlib", "pandas")]:
        mp.delitem(sys.modules, name)
    mp.setitem(sys.modules, "matplotlib", None)
    mp.setitem(sys.modules, "pandas", None)
    return mp


def logged_runs(entry, yaml_path, logging, tmp_path_factory, tag):
    """{"on": (summary, run), "off": (summary, None), "blocked": (summary,
    run with matplotlib and pandas unimportable)} of one entry point."""
    out = {}
    for mode in ("on", "off", "blocked"):
        d = tmp_path_factory.mktemp(f"{tag}-{mode}")
        mp = _blocked_optional() if mode == "blocked" else None
        try:
            out[mode] = run_logged(entry, yaml_path, d, logging,
                                   wandb_on=mode != "off")
        finally:
            if mp is not None:
                mp.undo()
    return out


def check_logging_leaves_training_unchanged(runs):
    on, off = runs["on"][0]["model"], runs["off"][0]["model"]
    assert runs["off"][1] is None
    assert_models_equal(on, off)
    assert on.joint_metrics_history == off.joint_metrics_history


def check_without_matplotlib_and_pandas(runs):
    """Every numeric key logged with the same values, the only warnings
    ``*_figure_skipped`` and the confusion counts unchanged."""
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


def check_wandb_enable_is_accepted(entry, yaml_path):
    import yaml
    cfg = yaml.safe_load(open(yaml_path))
    cfg["wandb"] = {"enable": True}
    entry.check_supported(cfg)


# -- crash-safe resume (test_torch_resume*.py) -------------------------------

class InjectedCrash(RuntimeError):
    pass


def crash_after(monkeypatch, phase, next_epoch, *modules):
    """Let ``save_train_checkpoint`` write the checkpoint of (phase,
    next_epoch) and then raise, as a kill right after the write would."""
    import multimodal_idbn_tpu_torch.checkpoint as tck
    real = tck.save_train_checkpoint

    def crashing(model, path, phase_=None, next_epoch_=None,
                 loss_history=None, **kw):
        ph = kw.get("phase", phase_)
        ne = kw.get("next_epoch", next_epoch_)
        real(model, path, phase=ph, next_epoch=ne, loss_history=loss_history)
        if ph == phase and int(ne) == next_epoch:
            raise InjectedCrash(f"{ph}@{ne}")

    for mod in (tck, *modules):
        monkeypatch.setattr(mod, "save_train_checkpoint", crashing)


def resume_config(tmp_path, yaml_name, name, **training):
    """A copy of a smoke YAML that checkpoints every 2 epochs into its own
    directory: (its path, that directory)."""
    import yaml
    cfg = yaml.safe_load(open(f"configs/{yaml_name}.yaml"))
    out = tmp_path / name
    out.mkdir()
    cfg["paths"]["save_dir"] = str(out)
    cfg["training"].update(checkpoint_every=2, **training)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path, out


def payload_arrays(path, load):
    """{part/field: array} of a saved pickle payload, loaded on the CPU."""
    payload = load(str(path), device="cpu")
    out = {}
    for key in ("image_idbn", "joint_rbm", "mod1_dbn", "mod2_dbn"):
        if key in payload:
            out.update({f"{key}/{k}": a
                        for k, a in rbm_arrays(payload[key]).items()})
    for i, r in enumerate(payload.get("joint_layers", [])):
        out.update({f"joint{i}/{k}": a for k, a in rbm_arrays(r).items()})
    if "z_class_mean" in payload:
        out["z_class_mean"] = np.asarray(payload["z_class_mean"])
    return out


def check_train_multimodal_crash_and_rerun(tmp_path, monkeypatch, capsys,
                                           phase, stop, message):
    """``train_multimodal`` crashed right after the checkpoint of (phase,
    stop), refused with a changed learning rate, then run again: it
    resumes with ``message`` and ends bit-equal to an uninterrupted run,
    its pickle too."""
    import yaml

    from multimodal_idbn_tpu_torch import train_multimodal
    from multimodal_idbn_tpu_torch.models import iMDBN
    crash_cfg, crash_dir = resume_config(tmp_path, "smoke_multimodal", "crash")
    clean_cfg, clean_dir = resume_config(tmp_path, "smoke_multimodal", "clean")
    crash_after(monkeypatch, phase, stop)
    with pytest.raises(InjectedCrash):
        train_multimodal.main(["--config", str(crash_cfg), "--device", "cpu"])
    monkeypatch.undo()
    ckpts = crash_dir / "checkpoints"
    assert (ckpts / f"{phase}.ckpt.npz").exists()
    assert (ckpts / "image.ckpt.npz").exists()  # the marker, or the phase
    assert not (crash_dir / "imdbn_smoke.pkl").exists()

    # a changed learning rate refuses to resume, with the JAX package's text
    cfg = yaml.safe_load(crash_cfg.read_text())
    cfg["training"]["learning_rate"] = 0.2
    edited = tmp_path / "edited.yaml"
    edited.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match=(
            r"was written by a run with different training configuration "
            r"\(LEARNING_RATE: checkpoint=0.1 run=0.2\)")):
        train_multimodal.main(["--config", str(edited), "--device", "cpu"])

    capsys.readouterr()
    resumed = train_multimodal.main(["--config", str(crash_cfg),
                                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert message in out and "Saved multimodal model" in out
    if phase == "joint":
        assert "Training image iDBN" not in out
    assert not any(ckpts.iterdir())  # gone after the completed run

    clean = train_multimodal.main(["--config", str(clean_cfg),
                                   "--device", "cpu"])
    assert_models_equal(resumed["model"], clean["model"])
    if phase == "image":  # a joint checkpoint carries no image loss curve
        assert resumed["image_loss"] == clean["image_loss"]
    assert resumed["model"].joint_metrics_history == \
        clean["model"].joint_metrics_history
    a = payload_arrays(crash_dir / "imdbn_smoke.pkl", iMDBN.load_model)
    b = payload_arrays(clean_dir / "imdbn_smoke.pkl", iMDBN.load_model)
    assert sorted(a) == sorted(b) and len(a) == 19
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
