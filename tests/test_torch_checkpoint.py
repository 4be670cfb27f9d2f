"""The port's persistence, held against the JAX package's at small sizes
(image [256, 64, 32], joint 36x24, 4 labels; bimodal [256, 32] +
[1568, 32], joint [16]): npz checkpoints (round trips, atomic write, both
directions across the two packages, the JAX package's error texts, the
fingerprint and the block splitting), the ``torch.save`` pair, the pickle
payloads, the reference pickle export/import, pretrained loading, the
retry rescue and the fine-tunes.

Everything here is exact (bit-equal arrays, equal strings and integers)
except the numpy shims' ``represent`` / ``decode`` against the models'
(1e-6 absolute: numpy's and the frameworks' sigmoid).
"""

import importlib.util
import io
import json
import pickle
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import multimodal_idbn_tpu.checkpoint as jck
from multimodal_idbn_tpu.models import RBM as JRBM
from multimodal_idbn_tpu.models import iDBN as JiDBN
from multimodal_idbn_tpu.models import iMDBN as JiMDBN
from multimodal_idbn_tpu.models import iMDBN_BiModal as JBiModal
import multimodal_idbn_tpu_torch.checkpoint as tck
from multimodal_idbn_tpu_torch import convert, train_bimodal, train_multimodal
from multimodal_idbn_tpu_torch.models import RBM, iDBN, iMDBN, iMDBN_BiModal

from torch_parity import (BIMODAL_JOINT, IMG_LAYERS, JOINT_HIDDEN, K,
                          MOD1_LAYERS, MOD2_LAYERS, SMALL_PARAMS,
                          assert_models_equal, jax_state, randomize,
                          rbm_arrays, small_bimodal, small_imdbn,
                          small_loaders, state_np, t)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


def _port_model(kind, seed=0, rs=None):
    if kind == "rbm":
        m = RBM(20, 10, 0.1, 1e-4, 0.5, softmax_groups=[(16, 20)], seed=seed,
                device="cpu")
    elif kind == "idbn":
        m = iDBN(IMG_LAYERS, dict(SMALL_PARAMS), None, device="cpu",
                 seed=seed)
    elif kind == "imdbn":
        m = small_imdbn(seed)
    else:
        m = small_bimodal(seed)
    if rs is not None:
        randomize(m, rs)
        if kind == "imdbn":
            m.z_class_mean = t(rs.rand(K, 32))
    return m


def _jax_model(kind, seed=0):
    p = dict(SMALL_PARAMS)
    if kind == "rbm":
        return JRBM(20, 10, 0.1, 1e-4, 0.5, softmax_groups=[(16, 20)],
                    seed=seed)
    if kind == "idbn":
        return JiDBN(IMG_LAYERS, p, None, None, seed=seed)
    if kind == "imdbn":
        return JiMDBN(IMG_LAYERS, JOINT_HIDDEN, params=p, dataloader=None,
                      val_loader=None, num_labels=K, seed=seed)
    return JBiModal(MOD1_LAYERS, MOD2_LAYERS, BIMODAL_JOINT, params=p,
                    dataloader=None, val_loader=None, seed=seed)


KINDS = ["rbm", "idbn", "imdbn", "bimodal"]


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_round_trip(tmp_path, kind):
    m = _port_model(kind, 0, np.random.RandomState(0))
    rbms = tck._collect_rbms(m)
    for r in rbms.values():
        r._next_key()  # move every stream off its start
    tck.save_checkpoint(m, str(tmp_path / "ck"),
                        extra={"note": np.arange(3)})
    assert [f.name for f in tmp_path.iterdir()] == ["ck.npz"]
    m2 = _port_model(kind, 5)
    extras = tck.load_checkpoint(m2, str(tmp_path / "ck"))
    np.testing.assert_array_equal(extras["note"], np.arange(3))
    assert_models_equal(m, m2)
    for a, b in zip(rbms.values(), tck._collect_rbms(m2).values()):
        assert a._next_key() == b._next_key()
    if kind == "imdbn":
        assert torch.equal(m.z_class_mean, m2.z_class_mean)
    with np.load(tmp_path / "ck.npz") as f:
        meta = json.loads(bytes(f["__meta__"]).decode())
        assert meta["format"] == "multimodal_idbn_tpu.ckpt.v1"
        assert sorted(meta["rbms"]) == sorted(rbms)
        assert not any(k.endswith("/key") for k in f.files)


def test_atomic_write_leaves_the_old_file_on_a_failed_save(tmp_path,
                                                           monkeypatch):
    m = _port_model("idbn", 0, np.random.RandomState(1))
    p = str(tmp_path / "atomic")
    tck.save_checkpoint(m, p)
    tck.save_checkpoint(m, p)  # overwrite by os.replace, no stale tmp
    assert sorted(f.name for f in tmp_path.iterdir()) == ["atomic.npz"]
    before = (tmp_path / "atomic.npz").read_bytes()
    real_savez = np.savez

    def failing_savez(path, **arrays):
        real_savez(path, **{k: arrays[k] for k in list(arrays)[:2]})
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", failing_savez)
    randomize(m, np.random.RandomState(2))
    with pytest.raises(OSError, match="disk full"):
        tck.save_checkpoint(m, p)
    monkeypatch.undo()
    assert (tmp_path / "atomic.npz").read_bytes() == before
    m2 = _port_model("idbn", 3)
    tck.load_checkpoint(m2, p)
    assert_models_equal(m2, _port_model("idbn", 0, np.random.RandomState(1)))


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_loads_into_the_port(tmp_path, kind):
    jm = _jax_model(kind, seed=1)
    if kind == "imdbn":
        jm.z_class_mean = jnp.asarray(np.random.RandomState(3).rand(K, 32),
                                      jnp.float32)
    jck.save_checkpoint(jm, str(tmp_path / "jax"),
                        extra={"phase": np.frombuffer(b"joint", np.uint8)})
    tm = _port_model(kind, seed=7)
    keys_before = [r._gen.get_state() for r in tck._collect_rbms(tm).values()]
    extras = tck.load_checkpoint(tm, str(tmp_path / "jax"))
    assert bytes(extras["phase"]) == b"joint"
    assert_models_equal(tm, jm)
    # the JAX package's key arrays mean nothing here: streams stay
    for r, before in zip(tck._collect_rbms(tm).values(), keys_before):
        assert torch.equal(r._gen.get_state(), before)
    if kind == "imdbn":
        np.testing.assert_array_equal(tm.z_class_mean.numpy(),
                                      np.asarray(jm.z_class_mean))


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_loads_into_jax(tmp_path, kind):
    tm = _port_model(kind, 2, np.random.RandomState(4))
    tck.save_train_checkpoint(tm, str(tmp_path / "port"), phase="joint",
                              next_epoch=3, loss_history=[0.5, 0.25])
    jm = _jax_model(kind, seed=9)
    key_before = np.asarray(jax_key_data(jm))
    phase, nxt = jck.load_train_checkpoint(jm, str(tmp_path / "port"))
    assert (phase, nxt) == ("joint", 3)
    assert_models_equal(jm, tm)
    np.testing.assert_array_equal(np.asarray(jax_key_data(jm)), key_before)
    if kind == "idbn":
        assert jm.loss_history == [0.5, 0.25]
    if kind == "imdbn":
        np.testing.assert_array_equal(np.asarray(jm.z_class_mean),
                                      tm.z_class_mean.numpy())


def jax_key_data(model):
    import jax
    return np.stack([np.asarray(jax.random.key_data(r._key))
                     for r in jck._collect_rbms(model).values()])


@pytest.mark.parametrize("kind", ["imdbn", "bimodal"])
def test_convert_layout_and_checkpoint_names(tmp_path, kind):
    """A checkpoint of either package reads as a ``convert`` layout, and a
    layout written under the checkpoint names loads into both packages."""
    jm = _jax_model(kind, seed=4)
    jck.save_checkpoint(jm, str(tmp_path / "jax"))
    layout = convert.layout_from_checkpoint(dict(np.load(tmp_path
                                                         / "jax.npz")))
    if kind == "imdbn":
        parts = convert.from_jax_numpy(layout, device="cpu")
        got = parts["image"] + [parts["joint"]]
        want = [r.state for r in jm.image_idbn.layers] + [jm.joint_rbm.state]
    else:
        parts = convert.bimodal_from_numpy(layout, device="cpu")
        got = parts["mod1"] + parts["mod2"] + parts["joint"]
        want = [r.state for r in jck._collect_rbms(jm).values()]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f, arr in state_np(a).items():
            np.testing.assert_array_equal(arr, state_np(b)[f])
    back = convert.checkpoint_from_layout(layout)
    assert sorted(back) == sorted(rbm_arrays(jm))
    np.savez(tmp_path / "renamed.npz", **back)
    tm, jm2 = _port_model(kind, 8), _jax_model(kind, seed=6)
    tck.load_checkpoint(tm, str(tmp_path / "renamed"))
    jck.load_checkpoint(jm2, str(tmp_path / "renamed"))
    assert_models_equal(tm, jm)
    assert_models_equal(jm2, jm)


def test_config_fingerprint_equals_jax():
    params = dict(SMALL_PARAMS, CHECKPOINT_EVERY=5, CROSS_METRICS_EVERY=2,
                  DP_DEVICES=None, DTYPE="float32", SR=None)
    extra = dict(image_layers=[256, 64, 32], joint_hidden=24, num_labels=4,
                 matmul_precision="highest")
    fp = tck.config_fingerprint(params, **extra)
    assert fp == jck.config_fingerprint(params, **extra)
    assert "CHECKPOINT_EVERY" not in fp and "LEARNING_RATE" in fp
    assert fp == tck.config_fingerprint(dict(params, CHECKPOINT_EVERY=9),
                                        **extra)
    assert fp != tck.config_fingerprint(dict(params, LEARNING_RATE=0.2),
                                        **extra)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,port,config", [
    ("train_multimodal", train_multimodal, "multimodal_training_config"),
    ("train_multimodal", train_multimodal, "smoke_multimodal"),
    ("train_bimodal", train_bimodal, "bimodal_training_config"),
    ("train_bimodal", train_bimodal, "smoke_bimodal")])
def test_build_params_equal_the_jax_scripts(name, port, config):
    """Same YAML, same params dict, hence the same fingerprint: the entry
    points of the two packages agree on what a changed config is."""
    cfg = yaml.safe_load(open(ROOT / "configs" / f"{config}.yaml"))
    assert port.build_params(cfg) == _script(name).build_params(cfg)


@pytest.mark.parametrize("start,end,every,extra", [
    (0, 10, 0, ()), (0, 10, 3, ()), (0, 10, 5, ()), (0, 10, 10, ()),
    (4, 10, 3, ()), (6, 10, 3, ()), (0, 20, 5, (8,)), (8, 20, 5, (8,)),
    (3, 20, 4, (8, 8)), (0, 5, 2, (8,)), (0, 0, 2, ()), (7, 7, 1, (3,)),
    (0, 9, 1, (8,)), (2, 9, -1, (4, 6)), (0, 150, 10, (8,))])
def test_checkpoint_epochs_equals_jax(start, end, every, extra):
    got = tck.checkpoint_epochs(start, end, every, *extra)
    assert got == jck.checkpoint_epochs(start, end, every, *extra)
    if got:
        assert got[0][0] == start and got[-1][1] == end
        assert all(a < b for a, b in got)
        assert all(x[1] == y[0] for x, y in zip(got, got[1:]))


def _raises(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_errors_have_the_jax_texts(tmp_path):
    """Wrong model, wrong phase and a changed configuration raise with the
    JAX package's messages, word for word."""
    ti, ji = _port_model("idbn", 0), _jax_model("idbn", 0)
    for m, ck in ((ti, tck), (ji, jck)):
        m._ckpt_fingerprint = ck.config_fingerprint(
            dict(SMALL_PARAMS), image_layers=IMG_LAYERS)
    p = str(tmp_path / "ck.npz")
    tck.save_train_checkpoint(ti, p, phase="image", next_epoch=1)

    tb, jb = _port_model("bimodal", 0), _jax_model("bimodal", 0)
    msg = _raises(lambda: tck.load_checkpoint(tb, p))
    assert msg == _raises(lambda: jck.load_checkpoint(jb, p))
    assert "does not match this model" in msg and "mod1_dbn/layer0" in msg

    msg = _raises(lambda: tck.load_train_checkpoint_expecting(ti, p, "mod1"))
    assert msg == _raises(
        lambda: jck.load_train_checkpoint_expecting(ji, p, "mod1"))
    assert "is a 'image'-phase checkpoint but this run expected 'mod1'" in msg

    for m, ck in ((ti, tck), (ji, jck)):
        m._ckpt_fingerprint = ck.config_fingerprint(
            dict(SMALL_PARAMS, LEARNING_RATE=0.2), image_layers=IMG_LAYERS)
    msg = _raises(lambda: tck.load_train_checkpoint_expecting(ti, p, "image"))
    assert msg == _raises(
        lambda: jck.load_train_checkpoint_expecting(ji, p, "image"))
    assert "LEARNING_RATE: checkpoint=0.1 run=0.2" in msg
    assert "training.resume_ignore_config: true" in msg
    assert not hasattr(ti, "_ckpt_loaded_fingerprint")
    assert tck.load_train_checkpoint_expecting(ti, p, "image",
                                               ignore_config=True) == 1
    with pytest.raises(TypeError, match="don't know how to checkpoint"):
        tck.save_checkpoint(object(), p)


def test_histories_and_loader_counters_survive(tmp_path):
    m = small_imdbn()
    m.joint_metrics_history = [{"epoch": 0, "cross_modality/text_top1": 0.25,
                                "cross_modality/image_mse": 1 / 3}]
    m.dataloader._epoch = 4
    p = str(tmp_path / "j")
    tck.save_train_checkpoint(m, p, phase="joint", next_epoch=1)
    m2 = small_imdbn(seed=3)
    assert tck.load_train_checkpoint(m2, p) == ("joint", 1)
    assert m2.joint_metrics_history == m.joint_metrics_history
    assert m2.dataloader._epoch == 4
    m2.dataloader = small_loaders()[0]  # a loader attached after the load
    tck.align_loader_for_resume(m2, 1)
    assert m2.dataloader._epoch == 4
    m2.dataloader._epoch = 0
    tck.align_loader_for_resume(m2, 2)  # no stash left: the epoch guess
    assert m2.dataloader._epoch == 2

    d = m.image_idbn
    d.loss_history = [1.5, 0.75]
    assert tck.maybe_save_train_checkpoint(
        d, str(tmp_path / "i"), 2, "image", 2, 4,
        loss_history=d.loss_history)
    assert not tck.maybe_save_train_checkpoint(d, str(tmp_path / "x"), 2,
                                               "image", 4, 4)
    assert not tck.maybe_save_train_checkpoint(d, str(tmp_path / "x"), 2,
                                               "image", 3, 4,
                                               cadence_only=True)
    assert not tck.maybe_save_train_checkpoint(d, None, 2, "image", 2, 4)
    d2 = small_imdbn(seed=4).image_idbn
    assert tck.load_train_checkpoint(d2, str(tmp_path / "i")) == ("image", 2)
    assert d2.loss_history == [1.5, 0.75]
    assert not (tmp_path / "x.npz").exists()


def test_cli_paths_and_removal(tmp_path):
    cfg = {"paths": {"save_dir": str(tmp_path / "out")}}
    got = tck.cli_checkpoint_paths(cfg, ("image", "joint"))
    assert got == jck.cli_checkpoint_paths(cfg, ("image", "joint"))
    assert got["joint"] == tmp_path / "out" / "checkpoints" / "joint.ckpt.npz"
    got["image"].write_bytes(b"x")
    tck.remove_checkpoints((got["image"], got["joint"], None))
    assert not got["image"].exists()
    cfg["paths"]["checkpoint_dir"] = str(tmp_path / "elsewhere")
    assert tck.cli_checkpoint_paths(cfg, ("a",))["a"].parent.name == \
        "elsewhere"


def test_torch_save_pair_round_trip(tmp_path):
    m = _port_model("imdbn", 0, np.random.RandomState(5))
    p = str(tmp_path / "tree.pt")
    tck.save_checkpoint_torch(m, p)
    tree = torch.load(p, weights_only=True)
    assert sorted(tree) == ["image_idbn.layer0", "image_idbn.layer1",
                            "joint_rbm", "z_class_mean"]
    m2 = _port_model("imdbn", 6)
    tck.load_checkpoint_torch(m2, p)
    assert_models_equal(m, m2)
    assert torch.equal(m.z_class_mean, m2.z_class_mean)


def test_pcd_and_bf16_are_refused(tmp_path):
    """PCD chains and bf16 states, which these files refused until the
    opt-in variants were ported, now travel: chains in numeric order, a
    JAX bf16 checkpoint loads as bf16 bit for bit, and a port bf16 state
    writes JAX's bit-view. What is still refused is a dtype neither
    package can carry."""
    m = _port_model("idbn", 0)
    m._pcd_chains = [torch.full((2, 2), float(i)) for i in range(11)]
    tck.save_train_checkpoint(m, str(tmp_path / "a"), "image", 1)
    m2 = _port_model("idbn", 0)
    tck.load_train_checkpoint(m2, str(tmp_path / "a.npz"))
    assert [float(c[0, 0]) for c in m2._pcd_chains] == list(range(11))
    jm = _jax_model("rbm", 0)
    jm.state = type(jm.state)(*(x.astype(jnp.bfloat16) for x in jm.state))
    jck.save_checkpoint(jm, str(tmp_path / "bf16"))
    r = _port_model("rbm", 0)
    tck.load_checkpoint(r, str(tmp_path / "bf16"))
    assert r.state.w.dtype == torch.bfloat16
    np.testing.assert_array_equal(r.state.w.float().numpy(),
                                  np.asarray(jm.state.w, np.float32))
    r.state = r.state.replace(w=r.state.w * 2)
    tck.save_checkpoint(r, str(tmp_path / "b"))
    jck.load_checkpoint(jm, str(tmp_path / "b"))
    assert jm.state.w.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jm.state.w, np.float32),
                                  r.state.w.float().numpy())
    with pytest.raises(TypeError, match="unsupported dtype"):
        tck.save_checkpoint(_port_model("rbm", 0), str(tmp_path / "c"),
                            extra={"v": np.zeros(2, dtype="V2")})


# ---------------------------------------------------------------------------
# Pickle payloads
# ---------------------------------------------------------------------------

class _TensorFinder(pickle.Pickler):
    """Pickler that records every torch object it is asked to pickle."""

    def __init__(self):
        super().__init__(io.BytesIO())
        self.found = []

    def reducer_override(self, obj):
        if isinstance(obj, (torch.Tensor, torch.Generator, torch.device,
                            torch.Size)):
            self.found.append(type(obj).__name__)
        return NotImplemented


def test_imdbn_pickle_round_trip(tmp_path):
    m = _port_model("imdbn", 0, np.random.RandomState(6))
    m.reference_best_of_k_bug = False
    m.z_affine_scale = np.full(32, 1.25, np.float32)
    m.z_affine_bias = t(np.full(32, 0.05))
    p = str(tmp_path / "m.pkl")
    m.save_model(p)
    with open(p, "rb") as f:
        raw = pickle.load(f)
    assert sorted(raw) == sorted([
        "layers", "params", "image_idbn", "joint_rbm", "num_labels",
        "Dz_img", "arch_str", "features", "metadata", "z_class_mean",
        "z_affine_scale", "z_affine_bias", "reference_best_of_k_bug"])
    assert raw["metadata"]["model_type"] == "iMDBN"
    assert raw["layers"][-1] is raw["joint_rbm"]
    assert raw["layers"][0] is raw["image_idbn"].layers[0]
    finder = _TensorFinder()
    finder.dump(raw)
    assert finder.found == []

    payload = iMDBN.load_model(p, device="cpu")
    m2 = iMDBN.from_payload(payload)
    assert m2.params is payload["params"] is m2.image_idbn.params
    assert m2.params == m.params
    assert m2.reference_best_of_k_bug is False
    assert m2.arch_str == "IMG256-64-32_JOINT24" and m2.Dz_img == 32
    assert_models_equal(m, m2)
    imgs = m.dataloader.materialize()[0][:4]
    for model in (m, m2):
        model.joint_rbm.reseed(3)
    assert m.joint_rbm._next_key() == m2.joint_rbm._next_key()
    assert torch.equal(m.img2txt(imgs), m2.img2txt(imgs))
    assert torch.equal(m.txt2img([0, 2]), m2.txt2img([0, 2]))
    assert torch.equal(m.sample_txt2img([1, 3], seed=2),
                       m2.sample_txt2img([1, 3], seed=2))
    assert torch.equal(m.represent((imgs, np.eye(K)[[0, 1, 2, 3]])),
                       m2.represent((imgs, np.eye(K)[[0, 1, 2, 3]])))
    # a model rebuilt from a payload trains once it has a loader
    m3 = iMDBN.from_payload(iMDBN.load_model(p, device="cpu"),
                            *small_loaders()[:2])
    m3.train_joint(1)
    assert len(m3.joint_metrics_history) == 1

    whole = pickle.loads(pickle.dumps(m))  # __getstate__ / __setstate__
    assert whole.dataloader is None and whole.device == torch.device("cpu")
    assert torch.equal(whole.z_class_mean, m.z_class_mean)
    assert_models_equal(whole, m)


def test_bimodal_pickle_round_trip(tmp_path):
    m = _port_model("bimodal", 0, np.random.RandomState(7))
    p = str(tmp_path / "b.pkl")
    m.save_model(p)
    with open(p, "rb") as f:
        raw = pickle.load(f)
    assert sorted(raw) == sorted([
        "mod1_dbn", "mod2_dbn", "joint_layers", "num_joint_layers",
        "Dz_mod1", "Dz_mod2", "params", "arch_str", "features", "metadata"])
    finder = _TensorFinder()
    finder.dump(raw)
    assert finder.found == []
    payload = iMDBN_BiModal.load_model(p, device="cpu")
    assert payload["params"] is payload["mod1_dbn"].params
    for got, want in ((payload["mod1_dbn"], m.mod1_dbn),
                      (payload["mod2_dbn"], m.mod2_dbn)):
        assert_models_equal(got, want)
    for got, want in zip(payload["joint_layers"], m.joint_layers):
        assert_models_equal(got, want)
    m1 = m.dataloader.materialize()[0][:3]
    assert torch.equal(payload["mod1_dbn"].represent(m1),
                       m.mod1_dbn.represent(m1))
    old = dict(raw, joint_rbm=raw["joint_layers"][0])
    del old["joint_layers"], old["num_joint_layers"]
    with open(tmp_path / "old.pkl", "wb") as f:
        pickle.dump(old, f)
    up = iMDBN_BiModal.load_model(str(tmp_path / "old.pkl"), device="cpu")
    assert up["num_joint_layers"] == 1 and len(up["joint_layers"]) == 1
    whole = pickle.loads(pickle.dumps(m))
    assert whole.joint_rbm is whole.joint_layers[0]
    assert whole.device == torch.device("cpu") and whole.dataloader is None


def test_load_model_device_rule(tmp_path):
    m = _port_model("imdbn", 0)
    m.save_model(str(tmp_path / "m.pkl"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            iMDBN.load_model(str(tmp_path / "m.pkl"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.import_reference_pickle(str(tmp_path / "m.pkl"))


def test_reference_pickle_export_equals_jax(tmp_path):
    tm = _port_model("imdbn", 0, np.random.RandomState(8))
    jm = _jax_model("imdbn", 0)
    for name, rbm in jck._collect_rbms(jm).items():
        rbm.state = jax_state(state_np(tck._collect_rbms(tm)[name].state))
    jm.z_class_mean = jnp.asarray(tm.z_class_mean.numpy())
    tp = tck.export_reference_pickle(tm, str(tmp_path / "t.pkl"))
    jp = jck.export_reference_pickle(jm, str(tmp_path / "j.pkl"))
    assert sorted(tp) == sorted(jp)
    assert tp["metadata"]["exporter"] == "multimodal_idbn_tpu_torch"
    with open(tmp_path / "t.pkl", "rb") as f:
        tp = pickle.load(f)
    assert isinstance(tp["image_idbn"], tck.NumpyDBN)
    assert all(isinstance(r, tck.NumpyRBM) for r in tp["layers"])
    for a, b in zip(tp["layers"], jp["layers"]):
        for f in ("W", "hid_bias", "vis_bias", "W_m", "hb_m", "vb_m"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.softmax_groups == b.softmax_groups
        assert (a.lr, a.momentum, a.final_momentum) == (b.lr, b.momentum,
                                                        b.final_momentum)
    np.testing.assert_array_equal(tp["z_class_mean"], jp["z_class_mean"])
    x = tm.dataloader.materialize()[0][:4]
    np.testing.assert_array_equal(tp["image_idbn"].represent(x),
                                  jp["image_idbn"].represent(x))
    top = np.random.RandomState(9).rand(4, 32).astype(np.float32)
    np.testing.assert_array_equal(tp["image_idbn"].decode(top),
                                  jp["image_idbn"].decode(top))
    np.testing.assert_allclose(tp["image_idbn"].represent(x),
                               tm.image_idbn.represent(x).numpy(), atol=1e-6)
    np.testing.assert_allclose(tp["image_idbn"].decode(top),
                               tm.image_idbn.decode(top).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        tp["joint_rbm"].visible_probs(np.ones((2, 24), np.float32)),
        tm.joint_rbm.visible_probs(np.ones((2, 24))).numpy(), atol=1e-6)


def _install_fake_module(module_path, class_names):
    """A stand-in for the reference's module, so that a pickle can name its
    classes (the reference checkout itself is not here)."""
    created, parent = [], None
    for i, part in enumerate(module_path.split(".")):
        name = ".".join(module_path.split(".")[:i + 1])
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
            created.append(name)
        if parent is not None:
            setattr(sys.modules[parent], part, sys.modules[name])
        parent = name
    classes = {}
    for cn in class_names:
        classes[cn] = type(cn, (object,), {"__module__": module_path})
        setattr(sys.modules[module_path], cn, classes[cn])
    return created, classes


@pytest.mark.parametrize("module_path", ["imdbn.models.rbm",
                                         "src.classes.rbm_model"])
def test_import_reference_pickle(tmp_path, module_path):
    created, classes = _install_fake_module(module_path, ["RBM"])
    try:
        layers = []
        g = torch.Generator().manual_seed(0)
        for v, h, groups in ((256, 64, []), (64, 40, [(60, 64)])):
            r = classes["RBM"]()
            r.W = torch.randn(v, h, generator=g) * 0.01
            r.hid_bias = torch.zeros(h)
            r.vis_bias = torch.randn(v, generator=g)
            r.lr, r.weight_decay, r.momentum = 0.2, 1e-4, 0.5
            r.final_momentum, r.softmax_groups = 0.95, groups
            r.W_m = torch.ones(v, h)
            layers.append(r)
        with open(tmp_path / "ref.pkl", "wb") as f:
            pickle.dump({"layers": layers, "params": {"CD": 5}}, f)
        W_ref = [r.W.numpy().copy() for r in layers]
    finally:
        for n in created:
            sys.modules.pop(n, None)

    payload = tck.import_reference_pickle(str(tmp_path / "ref.pkl"),
                                          device="cpu")
    assert payload["params"]["CD"] == 5
    for rbm, W in zip(payload["layers"], W_ref):
        assert isinstance(rbm, RBM) and rbm.device == torch.device("cpu")
        np.testing.assert_array_equal(rbm.W.numpy(), W)
        assert float(rbm.W_m.abs().sum()) == 0.0  # momentum re-zeroed
    top = payload["layers"][1]
    assert (top.lr, top.final_momentum) == (0.2, 0.95)
    assert top.softmax_groups == [(60, 64)]
    assert tuple(top.forward(np.zeros((2, 64), np.float32)).shape) == (2, 40)

    # the converted layers feed load_pretrained_image_idbn, which rebuilds
    # the joint RBM for the new top width (40, not 32)
    with open(tmp_path / "converted.pkl", "wb") as f:
        pickle.dump({"layers": payload["layers"], "params": {}}, f)
    m = small_imdbn()
    assert m.load_pretrained_image_idbn(str(tmp_path / "converted.pkl"))
    assert m.Dz_img == 40 and m.joint_rbm.num_visible == 40 + K
    assert m.joint_rbm.softmax_groups == [(40, 44)]
    assert tuple(m.img2txt(np.zeros((3, 256), np.float32)).shape) == (3, K)


def test_load_pretrained_rezeros_momentum(tmp_path, capsys):
    pre = randomize(_port_model("idbn", 0), np.random.RandomState(10))
    assert float(pre.layers[0].W_m.abs().sum()) > 0
    pre.save_model(str(tmp_path / "idbn.pkl"))
    m = small_imdbn(seed=5)
    joint_before = m.joint_rbm
    assert m.load_pretrained_image_idbn(str(tmp_path / "idbn.pkl"))
    assert m.joint_rbm is joint_before  # same top width: the joint stays
    for got, want in zip(m.image_idbn.layers, pre.layers):
        assert torch.equal(got.W, want.W) and torch.equal(got.hid_bias,
                                                          want.hid_bias)
        for buf in (got.W_m, got.hb_m, got.vb_m):
            assert float(buf.abs().sum()) == 0.0
    with open(tmp_path / "whole.pkl", "wb") as f:
        pickle.dump(pre, f)  # an object with .layers
    assert small_imdbn().load_pretrained_image_idbn(str(tmp_path
                                                        / "whole.pkl"))
    assert not m.load_pretrained_image_idbn(str(tmp_path / "missing.pkl"))
    with open(tmp_path / "odd.pkl", "wb") as f:
        pickle.dump([1, 2], f)
    assert not m.load_pretrained_image_idbn(str(tmp_path / "odd.pkl"))
    assert "unrecognized format" in capsys.readouterr().out

    b = small_bimodal()
    pre1 = randomize(iDBN(MOD1_LAYERS, dict(SMALL_PARAMS), None,
                          device="cpu", seed=2), np.random.RandomState(11))
    pre1.save_model(str(tmp_path / "m1.pkl"))
    assert b.load_pretrained_mod1_dbn(str(tmp_path / "m1.pkl"))
    assert torch.equal(b.mod1_dbn.layers[0].W, pre1.layers[0].W)
    assert float(b.mod1_dbn.layers[0].W_m.abs().sum()) == 0.0
    assert not b.load_pretrained_mod2_dbn(str(tmp_path / "nope.pkl"))


def test_train_with_retry_reinitialises_on_forced_collapse(monkeypatch,
                                                           tmp_path):
    m = small_imdbn().image_idbn
    assert m.val_batch is not None and m._recon_collapse_ratio() > 0
    ratios = iter([1.0, 1.0, 0.5])
    monkeypatch.setattr(m, "_recon_collapse_ratio", lambda: next(ratios))
    calls = []
    real_train = m.train
    monkeypatch.setattr(m, "train", lambda epochs, **kw: (
        calls.append(kw), real_train(epochs, **kw)))
    w0 = m.layers[0].W.clone()
    ck = tmp_path / "image.ckpt.npz"
    used = m.train_with_retry(2, max_retries=3, start_epoch=0,
                              checkpoint_every=1, checkpoint_path=str(ck))
    assert used == 2
    assert [c.get("start_epoch") for c in calls] == [0, None, None]
    assert len(m.loss_history) == 6  # kept across the re-initialisations
    assert (tmp_path / "image.ckpt.npz.collapsed1").exists()
    assert (tmp_path / "image.ckpt.npz.collapsed2").exists()
    assert not torch.equal(m.layers[0].W, w0)
    m.reinit_layers(seed_offset=5)  # the seed of layer i is 0 + i + 5
    fresh = iDBN(IMG_LAYERS, dict(SMALL_PARAMS), None, device="cpu", seed=5)
    for got, want in zip(m.layers, fresh.layers):
        assert torch.equal(got.W, want.W)
        assert float(got.W_m.abs().sum()) == float(got.hid_bias.abs().sum()) \
            == 0.0

    quiet = small_imdbn().image_idbn
    monkeypatch.setattr(quiet, "_recon_collapse_ratio", lambda: 1.0)
    assert quiet.train_with_retry(1, max_retries=0) == 0
    assert quiet._warn_if_collapsed() is True
    healthy = small_imdbn().image_idbn
    monkeypatch.setattr(healthy, "_recon_collapse_ratio", lambda: 0.5)
    assert healthy.train_with_retry(1, max_retries=2) == 0
    assert healthy._warn_if_collapsed() is False
    no_val = iDBN(IMG_LAYERS, dict(SMALL_PARAMS), small_loaders()[0],
                  device="cpu", seed=0)
    assert no_val._recon_collapse_ratio() is None


@pytest.mark.parametrize("family", ["imdbn", "mod1", "mod2"])
def test_finetune_restores_the_learning_rate(family, monkeypatch):
    seen = []
    real = RBM.train_epoch
    monkeypatch.setattr(RBM, "train_epoch", lambda self, *a, **kw: (
        seen.append((self.lr, a[0].shape, kw["CD"])), real(self, *a, **kw))[1])
    if family == "imdbn":
        m = small_imdbn()
        dbn, run = m.image_idbn, m.finetune_image_last_layer
    else:
        m = small_bimodal()
        dbn = getattr(m, f"{family}_dbn")
        run = getattr(m, f"finetune_{family}_last_layer")
    top, below = dbn.layers[-1], [r.W.clone() for r in dbn.layers[:-1]]
    w_top = top.W.clone()
    run(epochs=0)
    assert seen == []
    run(epochs=2, lr_scale=0.3, cd_k=2)
    assert top.lr == 0.1
    assert len(seen) == 2 * 3  # two epochs of three batches (44 rows)
    assert all(abs(lr - 0.03) < 1e-12 and cd == 2 for lr, _, cd in seen)
    assert seen[0][1] == (16, top.num_visible)
    assert not torch.equal(top.W, w_top)
    for r, w in zip(dbn.layers[:-1], below):
        assert torch.equal(r.W, w)  # the lower layers stay frozen
    monkeypatch.setattr(RBM, "train_epoch", lambda self, *a, **kw: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        run(epochs=1)
    assert top.lr == 0.1  # restored after a failure too
