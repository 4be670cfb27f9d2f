"""The port's flagship-training slice as a whole, held against the JAX
package on seeded inputs at small widths: one iDBN epoch over two layers,
the cross-modal round trip, one joint batch (warm-up and main), the data
copy, the parameter carry-over, and the training entry point on the CPU.

Tolerance: atol 1e-4 for whole epochs, batches and chains. Sampled steps
run with both sides in their deterministic sampler mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_idbn_tpu.data import numerosity as jnum
from multimodal_idbn_tpu.data import loaders as jloaders
from multimodal_idbn_tpu.ops import dbn_train as jdbn
from multimodal_idbn_tpu.ops import imdbn_ops as jimdbn
from multimodal_idbn_tpu_torch import convert, resolve_device
from multimodal_idbn_tpu_torch import train_multimodal
from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform
from multimodal_idbn_tpu_torch.data import numerosity as tnum
from multimodal_idbn_tpu_torch.models import iDBN, iMDBN
from multimodal_idbn_tpu_torch.ops import dbn_train as tdbn
from multimodal_idbn_tpu_torch.ops import imdbn_ops as timdbn

from torch_parity import (assert_states_close, both_deterministic, close,
                          jax_state, np_state, t, torch_state)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

Dz, K, Hj, D, B = 12, 4, 10, 20, 6
V = Dz + K
GROUPS = ((Dz, V),)
KEY = jax.random.key(0)
SMOKE_YAML = "configs/smoke_multimodal.yaml"


def test_idbn_epoch_two_layers(monkeypatch):
    rs = np.random.RandomState(0)
    f1, f2 = np_state(rs, 30, 16), np_state(rs, 16, 8)
    data = (rs.rand(3 * B, 30) > 0.7).astype(np.float32)
    kw = dict(cd=2, sparsity_flags=(False, True), batch_size=B)
    with both_deterministic(monkeypatch):
        jstates, jloss = jdbn.idbn_epoch(
            (jax_state(f1), jax_state(f2)), KEY, jnp.asarray(data), 0.1, 0.5,
            1e-4, 0.1, shuffle=False, **kw)
        tstates, tloss = tdbn.idbn_epoch(
            [torch_state(f1), torch_state(f2)], 0, t(data), lr=0.1, mom=0.5,
            weight_decay=1e-4, sparsity_factor=0.1, fast_sampler=True, **kw)
    for js, ts in zip(jstates, tstates):
        assert_states_close(ts, js, 1e-4)
    assert tuple(tloss.shape) == (3, 2)
    close(tloss, jloss, 1e-4)
    close(tdbn.dbn_represent(tstates, t(data), 2),
          jdbn.dbn_represent(jstates, jnp.asarray(data), 2), 1e-4)
    top = rs.rand(B, 8).astype(np.float32)
    close(tdbn.dbn_decode(tstates, t(top)),
          jdbn.dbn_decode(jstates, jnp.asarray(top)), 1e-4)


def _joint_models(seed):
    rs = np.random.RandomState(seed)
    jf, imf = np_state(rs, V, Hj), np_state(rs, D, Dz)
    z = rs.rand(B, Dz).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[rs.randint(0, K, B)]
    zcm = rs.rand(K, Dz).astype(np.float32)
    img = (rs.rand(B, D) > 0.5).astype(np.float32)
    return jf, imf, z, y, zcm, img


@pytest.mark.parametrize("affine", [False, True])
def test_cross_reconstruct(monkeypatch, affine):
    jf, imf, z, y, zcm, _ = _joint_models(1)
    scale = np.full(Dz, 2.0, np.float32)
    bias = np.full(Dz, 0.1, np.float32)
    kw = dict(steps=7, Dz=Dz, groups=GROUPS)
    with both_deterministic(monkeypatch):
        jimg, jpy = jimdbn.cross_reconstruct(
            jax_state(jf), (jax_state(imf),), KEY, jnp.asarray(z),
            jnp.asarray(y), z_class_mean=jnp.asarray(zcm),
            z_affine=((jnp.asarray(scale), jnp.asarray(bias)) if affine
                      else None), use_free_energy=False, **kw)
        timg, tpy = timdbn.cross_reconstruct(
            torch_state(jf), [torch_state(imf)], 0, t(z), t(y),
            z_class_mean=t(zcm),
            z_affine=(t(scale), t(bias)) if affine else None, **kw)
    close(tpy, jpy, 1e-4)
    close(timg, jimg, 1e-4)
    m_t = timdbn.cross_metrics_batch(timg, tpy, t(np.zeros((B, D))), t(y))
    m_j = jimdbn.cross_metrics_batch(jimg, jpy, jnp.zeros((B, D)),
                                     jnp.asarray(y))
    for a, b in zip(m_t, m_j):
        close(a, b, 1e-3)


@pytest.mark.parametrize("warmup,b_idx", [(True, 0), (False, 0),
                                          (False, 3)])
def test_joint_train_batch(monkeypatch, warmup, b_idx):
    jf, imf, z, y, zcm, img = _joint_models(2)
    kw = dict(warmup=warmup, joint_cd=2, aux_cond_steps=4, Dz=Dz, steps=3,
              groups=GROUPS, zclamp_every=50, compute_metrics=True)
    with both_deterministic(monkeypatch):
        jnew, jcd, jm = jimdbn._joint_train_batch(
            jax_state(jf), (jax_state(imf),), KEY, jnp.asarray(z),
            jnp.asarray(y), jnp.asarray(img), jnp.asarray(b_idx), 0.04, 0.5,
            1e-4, jnp.asarray(zcm), use_free_energy=False, **kw)
        tnew, tcd, tm = timdbn._joint_train_batch(
            torch_state(jf), [torch_state(imf)], 0, t(z), t(y), t(img),
            b_idx, 0.04, 0.5, 1e-4, t(zcm), **kw)
    assert_states_close(tnew, jnew, 1e-4)
    close(tcd, jcd, 1e-5)
    for a, b in zip(tm, jm):
        close(a, b, 1e-3)


def test_joint_epoch_and_bias_stats(monkeypatch):
    rs = np.random.RandomState(3)
    jf, imf = np_state(rs, V, Hj), np_state(rs, D, Dz)
    Z = rs.rand(2 * B + 2, Dz).astype(np.float32)
    Y = np.eye(K, dtype=np.float32)[rs.randint(0, K - 1, 2 * B + 2)]
    X = (rs.rand(2 * B + 2, D) > 0.5).astype(np.float32)
    for a, b in zip(timdbn.joint_bias_stats(t(Z), t(Y), num_classes=K),
                    jimdbn.joint_bias_stats(jnp.asarray(Z), jnp.asarray(Y),
                                            num_classes=K)):
        close(a, b, 1e-5)
    kw = dict(warmup=False, joint_cd=1, aux_cond_steps=3, Dz=Dz, steps=2,
              groups=GROUPS, zclamp_every=50, batch_size=B)
    with both_deterministic(monkeypatch):
        jj, jcd, jtot = jimdbn.joint_epoch(
            jax_state(jf), (jax_state(imf),), KEY, jnp.asarray(Z),
            jnp.asarray(Y), jnp.asarray(X), 0.04, 0.5, 1e-4,
            jnp.asarray(Z[:K]), shuffle=False, use_free_energy=False, **kw)
        tj, tcd, ttot = timdbn.joint_epoch(
            torch_state(jf), [torch_state(imf)], 0, t(Z), t(Y), t(X), 0.04,
            0.5, 1e-4, t(Z[:K]), **kw)
    assert_states_close(tj, jj, 1e-4)
    close(tcd, jcd, 1e-5)
    for a, b in zip(ttot, jtot):
        close(a, b, 1e-3)


@pytest.mark.parametrize("every,batches", [(1, [16, 16, 12]), (2, [16]),
                                           (3, [16])])
def test_remainder_batch_metrics_follow_jax(monkeypatch, every, batches):
    """With ``CROSS_METRICS_EVERY`` > 1 the JAX package computes the
    cross-modal metrics on every Nth full batch and never on the remainder
    batch (ops/imdbn_ops.py:430); the rows that enter an epoch's metrics
    are the same in the port."""
    from torch_parity import small_imdbn
    rs = np.random.RandomState(6)
    n, bs = 44, 16
    Z = rs.rand(n, Dz).astype(np.float32)
    Y = np.eye(K, dtype=np.float32)[rs.randint(0, K, n)]
    X = (rs.rand(n, D) > 0.5).astype(np.float32)
    _, _, _, totals = jimdbn.joint_epoch_block(
        jax_state(np_state(rs, V, Hj)), (jax_state(np_state(rs, D, Dz)),),
        KEY, jnp.asarray(Z), jnp.asarray(Y), jnp.asarray(X),
        jnp.arange(1, dtype=jnp.int32), jnp.asarray([0.04]),
        jnp.asarray([0.5]), 1e-4, jnp.asarray(Z[:K]), warmup=True,
        joint_cd=1, aux_cond_steps=2, Dz=Dz, steps=2, groups=GROUPS,
        use_free_energy=False, zclamp_every=50, batch_size=bs,
        metrics_every=every, n_epochs=1)
    assert float(totals.n[0]) == sum(batches)

    seen = []
    real = timdbn.cross_metrics_batch
    monkeypatch.setattr(timdbn, "cross_metrics_batch", lambda *a: (
        seen.append(a[0].shape[0]), real(*a))[1])
    m = small_imdbn(CROSS_METRICS_EVERY=every)  # 44 training rows
    m.train_joint(1)
    assert seen == batches
    assert len(m.joint_metrics_history) == 1


def test_data_copy_matches_python_backend():
    j = jnum.generate_numerosity_dataset(n_samples=12, num_classes=6, side=24,
                                         seed=4, backend="python")
    p = tnum.generate_numerosity_dataset(n_samples=12, num_classes=6,
                                         side=24, seed=4, backend="python")
    assert sorted(j) == sorted(p)
    for k in j:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    tr, va, te = create_dataloaders_uniform(batch_size=5, num_classes=6,
                                            n_samples=40, side=16)
    jtr, jva, jte = jloaders.train_val_test_split(40, seed=42)
    assert tr.dataset.indices == list(jtr)
    assert va.dataset.indices == list(jva) and te.dataset.indices == list(jte)
    imgs, onehot = tr.materialize()
    assert imgs.shape == (len(jtr), 16, 16) and onehot.shape == (len(jtr), 6)


def test_convert_round_trip():
    rs = np.random.RandomState(5)
    arrays = {}
    for i, (v, h) in enumerate([(20, 12), (12, 6)]):
        arrays.update({f"image.{i}.{k}": a for k, a in
                       np_state(rs, v, h, momentum=True).items()})
    arrays.update({f"joint.{k}": a for k, a in np_state(rs, 10, 7).items()})
    arrays["z_class_mean"] = rs.rand(4, 6).astype(np.float32)
    arrays["z_affine_scale"] = rs.rand(6).astype(np.float32)
    arrays["z_affine_bias"] = rs.rand(6).astype(np.float32)
    parts = convert.from_jax_numpy(arrays, device="cpu")
    assert len(parts["image"]) == 2
    assert parts["image"][1].w.shape == (12, 6)
    back = convert.to_numpy(parts["image"], parts["joint"],
                            parts["z_class_mean"], parts["z_affine"])
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


def _smoke_config(tmp_path, paths=None, **training):
    cfg = yaml.safe_load(open(SMOKE_YAML))
    cfg["paths"]["save_dir"] = str(tmp_path)
    cfg["paths"].update(paths or {})
    cfg["training"]["epochs_joint"] = 9  # 8 warm-up epochs + 1 main epoch
    cfg["training"].update(training)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_train_multimodal_cpu_smoke(tmp_path):
    summary = train_multimodal.main(
        ["--config", str(_smoke_config(tmp_path)), "--device", "cpu"])
    assert summary["device"] == "cpu"
    assert len(summary["image_loss"]) == 4
    assert all(np.isfinite(summary["image_loss"]))
    m = summary["cross_metrics"]
    assert 0.0 <= m["cross_modality/text_top1"] <= 1.0
    assert summary["save_path"].endswith(".pkl")
    loaded = iMDBN.from_payload(iMDBN.load_model(summary["save_path"],
                                                 device="cpu"))
    npz = tmp_path / "layout.npz"
    loaded.export_npz(str(npz))
    saved = dict(np.load(npz))
    parts = convert.from_jax_numpy(saved, device="cpu")
    assert [s.w.shape for s in parts["image"]] == [(256, 64), (64, 32)]
    assert parts["joint"].w.shape == (32 + 4, 24)
    assert parts["z_class_mean"].shape == (4, 32)
    for k, a in saved.items():
        assert np.isfinite(a).all(), k
    live = convert.to_numpy(summary["model"].image_idbn.states(),
                            summary["model"].joint_rbm.state,
                            summary["model"].z_class_mean)
    assert sorted(live) == sorted(saved)
    for k, a in live.items():
        np.testing.assert_array_equal(saved[k], a, err_msg=k)


@pytest.mark.parametrize("section,key,value", [
    ("training", "dp_devices", 2),
    ("training", "dtype", "bfloat16"), ("training", "compute_dtype", "bf16"),
    ("training", "stochastic_rounding", True),
    ("training", "matmul_precision", "default"),
    ("dataset", "distribution", "zipfian")])
def test_unsupported_settings_raise(section, key, value):
    """Every setting that raised until its part of the port came is
    accepted and reaches the params. ``dp_devices`` of more devices than
    the process group has raises ValueError naming torchrun, as JAX's
    "requested N devices, have M"; one device is accepted."""
    cfg = yaml.safe_load(open(SMOKE_YAML))
    cfg.setdefault(section, {})[key] = value
    if key == "dp_devices":
        with pytest.raises(ValueError, match="torchrun"):
            train_multimodal.check_supported(cfg)
        cfg["training"]["dp_devices"] = 1
        train_multimodal.check_supported(cfg)
        assert train_multimodal.build_params(cfg)["DP_DEVICES"] == 1
        return
    train_multimodal.check_supported(cfg)
    params = train_multimodal.build_params(cfg)
    name = {"dtype": "DTYPE", "compute_dtype": "COMPUTE_DTYPE",
            "stochastic_rounding": "SR"}.get(key)
    if name is not None:
        assert params[name] == value


@pytest.mark.parametrize("setting", [
    "checkpoint_every", "init_retry", "image_idbn_pretrained",
    "image_idbn_finetune_last_epochs"])
def test_setting_is_accepted_and_takes_effect(tmp_path, monkeypatch, capsys,
                                              setting):
    """The settings that used to raise now run, and each changes the run."""
    import multimodal_idbn_tpu_torch.checkpoint as ckpt
    training, paths = {"epochs_joint": 1}, {}
    saves = []
    if setting == "checkpoint_every":
        training["checkpoint_every"] = 1
        real = ckpt.save_train_checkpoint

        def counting(model, path, phase, next_epoch, loss_history=None):
            saves.append((phase, next_epoch))
            real(model, path, phase, next_epoch, loss_history)

        monkeypatch.setattr(ckpt, "save_train_checkpoint", counting)
    elif setting == "init_retry":
        training["init_retry"] = 1
        monkeypatch.setattr(iDBN, "_recon_collapse_ratio", lambda self: 1.0)
    elif setting == "image_idbn_pretrained":
        pre = iDBN([256, 64, 32], train_multimodal.build_params(
            yaml.safe_load(open(SMOKE_YAML))), None, device="cpu", seed=3)
        pre.save_model(str(tmp_path / "pre.pkl"))
        paths["image_idbn_pretrained"] = str(tmp_path / "pre.pkl")
    else:
        paths[setting] = 1
    summary = train_multimodal.main(
        ["--config", str(_smoke_config(tmp_path, paths, **training)),
         "--device", "cpu"])
    out = capsys.readouterr().out
    if setting == "checkpoint_every":
        # cadence saves of the 4 image epochs; the joint phase has 1 epoch
        assert saves == [("image", 1), ("image", 2), ("image", 3)]
        assert not any((tmp_path / "checkpoints").iterdir())
    elif setting == "init_retry":
        assert "init_retry: re-initialized 1 time(s)" in out
        assert len(summary["image_loss"]) == 8
    elif setting == "image_idbn_pretrained":
        assert "[load_pretrained_image_idbn] loaded from" in out
        assert summary["image_loss"] == []
        np.testing.assert_array_equal(
            summary["model"].image_idbn.layers[0].W.numpy(),
            pre.layers[0].W.numpy())
    else:
        assert "[finetune_image_last_layer] done" in out
    assert np.isfinite(summary["cross_metrics"]["cross_modality/text_ce"])


def test_flagship_configs_are_supported():
    for name in ("multimodal_training_config", "fast_multimodal",
                 "smoke_multimodal"):
        train_multimodal.check_supported(
            yaml.safe_load(open(f"configs/{name}.yaml")))


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_multimodal.main(["--config", SMOKE_YAML])
