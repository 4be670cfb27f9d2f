"""The port's bimodal training slice as a whole, held against the JAX
package at small widths: the MNIST-100 data copy and the bimodal loaders
(bit for bit), the model's bias init, encode and cross-modal inference
(deterministic sampler modes, atol 1e-5), the bimodal parameter layout,
and the training entry point on the CPU with its refusals.
"""

import functools

import numpy as np
import pytest
import torch
import yaml

import multimodal_idbn_tpu.data as jdata
from multimodal_idbn_tpu.data import numerosity as jnum
from multimodal_idbn_tpu.models import iMDBN_BiModal as JBiModal
from multimodal_idbn_tpu_torch import convert, cuts, train_bimodal
from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform
from multimodal_idbn_tpu_torch.data import numerosity as tnum
from multimodal_idbn_tpu_torch.models import iMDBN_BiModal

from torch_parity import (both_deterministic, close, jax_state, np_state,
                          state_np, torch_state)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

SMOKE_YAML = "configs/smoke_bimodal.yaml"
SIDE, K = 12, 4
LOADER_KW = dict(batch_size=16, n_samples=80, num_classes=K, side=SIDE,
                 seed=0, second_modality="mnist100")
PARAMS = train_bimodal.build_params(yaml.safe_load(open(SMOKE_YAML)))


@pytest.fixture
def python_backend(monkeypatch):
    """Both data layers on their Python generator (the default of both is
    the native generator when it builds; tests/test_torch_data_native.py
    holds the two native generators together)."""
    from multimodal_idbn_tpu_torch import data as tdata
    monkeypatch.setattr(jdata, "generate_numerosity_dataset",
                        functools.partial(jnum.generate_numerosity_dataset,
                                          backend="python"))
    monkeypatch.setattr(tdata, "generate_numerosity_dataset",
                        lambda **kw: tnum.generate_numerosity_dataset(
                            **dict(kw, backend="python")))


def test_mnist100_copy_matches():
    for d in range(10):
        np.testing.assert_array_equal(tnum._digit_glyph(d),
                                      jnum._digit_glyph(d))
    values = np.arange(0, 130, 7)
    for seed, noise in ((0, 0.02), (3, 0.0)):
        np.testing.assert_array_equal(
            tnum.generate_mnist100_images(values, seed=seed, noise=noise),
            jnum.generate_mnist100_images(values, seed=seed, noise=noise))


def test_bimodal_loaders_match(python_backend):
    ours = create_dataloaders_uniform(**LOADER_KW)
    theirs = jdata.create_dataloaders_uniform(**LOADER_KW)
    for a, b in zip(ours, theirs):
        assert a.dataset.indices == b.dataset.indices
        ma, mb = a.materialize(), b.materialize()
        assert ma[0].shape[1:] == (SIDE, SIDE) and ma[1].shape[1:] == (28,
                                                                      56)
        for x, y in zip(ma, mb):
            np.testing.assert_array_equal(x, y)
    tr = ours[0]
    assert [len(x) for x in next(iter(tr))] == [16, 16]
    for i in (0, 1):
        loader = train_bimodal.modality_loader(tr, i)
        imgs, onehot = loader.materialize()
        np.testing.assert_array_equal(imgs, tr.materialize()[i])
        np.testing.assert_array_equal(
            onehot, tr.dataset.dataset.onehot[tr.dataset.indices])
    base = tr.dataset.dataset
    base.mode = "mod2"
    np.testing.assert_array_equal(base.gather([3])[0], base.mod2_images[[3]])
    with pytest.raises(ValueError, match="second_modality"):
        create_dataloaders_uniform(**dict(LOADER_KW,
                                          second_modality="mnist10"))


def _twin_models(rs, train, val):
    """The same bimodal model in both packages: random JAX modality
    stacks and joint layers, copied into the port."""
    layers = ([SIDE * SIDE, 10], [28 * 56, 12, 8], [9, 5])
    jm = JBiModal(*layers, params=PARAMS, dataloader=train[1],
                  val_loader=val, seed=0)
    tm = iMDBN_BiModal(*layers, params=PARAMS, dataloader=train[0],
                       device="cpu", seed=0)
    for jd, td in ((jm.mod1_dbn, tm.mod1_dbn), (jm.mod2_dbn, tm.mod2_dbn)):
        fs = [np_state(rs, r.num_visible, r.num_hidden) for r in jd.layers]
        jd._set_states(tuple(jax_state(f) for f in fs))
        td._set_states([torch_state(f) for f in fs])
    for jr, tr in zip(jm.joint_layers, tm.joint_layers):
        f = np_state(rs, jr.num_visible, jr.num_hidden)
        jr.state, tr.state = jax_state(f), torch_state(f)
    return jm, tm


def test_model_matches_jax(monkeypatch, python_backend):
    ours = create_dataloaders_uniform(**LOADER_KW)
    theirs = jdata.create_dataloaders_uniform(**LOADER_KW)
    jm, tm = _twin_models(np.random.RandomState(0), (ours[0], theirs[0]),
                          theirs[1])
    assert tm.arch_str == "MOD1144-10_MOD21568-12-8_JOINT9-5"
    assert tm.joint_rbm is tm.joint_layers[0]
    assert [r.num_visible for r in tm.joint_layers] == [18, 9]

    jm.init_joint_bias_from_data(n_batches=2)
    tm.init_joint_bias_from_data(n_batches=2)
    close(tm.joint_rbm.vis_bias, jm.joint_rbm.vis_bias, 1e-5)

    m1, m2 = (np.asarray(a[:5]) for a in ours[1].materialize())
    close(tm.represent((m1, m2)), jm.represent((m1, m2)), 1e-5)
    with both_deterministic(monkeypatch):
        for name in ("mod1_to_mod2", "mod2_to_mod1"):
            x = m1 if name == "mod1_to_mod2" else m2
            close(getattr(tm, name)(x), getattr(jm, name)(x), 1e-5)
        for name in ("sample_mod1_to_mod2", "sample_mod2_to_mod1"):
            x = m1 if name == "sample_mod1_to_mod2" else m2
            close(getattr(tm, name)(x, gibbs_steps=3, seed=1),
                  getattr(jm, name)(x, gibbs_steps=3, seed=1), 1e-5)
        z1, z2 = np.zeros((5, 10), np.float32), np.ones((5, 8), np.float32)
        for got, want in zip(tm._cross_reconstruct(z1, z2, steps=2),
                             jm._cross_reconstruct(z1, z2, steps=2)):
            close(got, want, 1e-5)
    a = tm.sample_mod2_to_mod1(m2, gibbs_steps=3, seed=7)
    assert tuple(a.shape) == (5, SIDE * SIDE)
    assert torch.equal(a, tm.sample_mod2_to_mod1(m2, gibbs_steps=3, seed=7))


def test_bimodal_convert_round_trip():
    rs = np.random.RandomState(5)
    arrays = {}
    for name, shapes in (("mod1", [(20, 12), (12, 6)]), ("mod2", [(9, 4)]),
                         ("joint", [(10, 7), (7, 3)])):
        for i, (v, h) in enumerate(shapes):
            arrays.update({f"{name}.{i}.{k}": a for k, a in
                           np_state(rs, v, h, momentum=True).items()})
    parts = convert.bimodal_from_numpy(arrays, device="cpu")
    assert [len(parts[k]) for k in ("mod1", "mod2", "joint")] == [2, 1, 2]
    assert parts["joint"][1].w.shape == (7, 3)
    back = convert.bimodal_to_numpy(parts["mod1"], parts["mod2"],
                                    parts["joint"])
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


def _smoke_config(tmp_path, paths=None, **training):
    cfg = yaml.safe_load(open(SMOKE_YAML))
    cfg["paths"]["save_dir"] = str(tmp_path)
    cfg["paths"].update(paths or {})
    cfg["training"].update(training)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_train_bimodal_cpu_smoke(tmp_path):
    summary = train_bimodal.main(
        ["--config", str(_smoke_config(tmp_path, epochs_joint=9)),
         "--device", "cpu"])
    assert summary["device"] == "cpu"
    assert set(summary["seconds"]) == {"setup", "mod1", "mod2", "joint"}
    assert len(summary["mod1_loss"]) == len(summary["mod2_loss"]) == 2
    for v in (summary["mse_mod1"], summary["mse_mod2"]):
        assert np.isfinite(v) and 0.0 < v < 1.0
    model = summary["model"]
    assert len(model.joint_metrics_history) == 9
    payload = iMDBN_BiModal.load_model(summary["save_path"], device="cpu")
    assert payload["arch_str"] == model.arch_str
    assert payload["mod1_dbn"].params is payload["params"]
    model.export_npz(str(tmp_path / "layout.npz"))
    parts = convert.bimodal_from_numpy(
        dict(np.load(tmp_path / "layout.npz")), device="cpu")
    for name, dbn in (("mod1", payload["mod1_dbn"]),
                      ("mod2", payload["mod2_dbn"])):
        for st, loaded in zip(parts[name], dbn.states()):
            for f, a in state_np(st).items():
                np.testing.assert_array_equal(a, state_np(loaded)[f])
    assert [s.w.shape for s in parts["mod1"]] == [(256, 32)]
    assert [s.w.shape for s in parts["mod2"]] == [(1568, 32)]
    assert [s.w.shape for s in parts["joint"]] == [(64, 16)]
    for name, states in parts.items():
        for st, live in zip(states, {"mod1": model.mod1_dbn.states(),
                                     "mod2": model.mod2_dbn.states(),
                                     "joint": [model.joint_rbm.state]}[name]):
            for f, a in state_np(st).items():
                assert np.isfinite(a).all()
                np.testing.assert_array_equal(a, state_np(live)[f])
    m1, m2 = model.dataloader.materialize()
    assert tuple(model.mod1_to_mod2(m1[:3]).shape) == (3, 1568)
    assert tuple(model.mod2_to_mod1(m2[:3]).shape) == (3, 256)
    assert tuple(model.represent((m1[:3], m2[:3])).shape) == (3, 16)


@pytest.mark.parametrize("section,key,value", [
    ("training", "dp_devices", 2),
    ("training", "dtype", "bfloat16"), ("training", "compute_dtype", "bf16"),
    ("training", "stochastic_rounding", True),
    ("training", "matmul_precision", "default"),
    ("dataset", "distribution", "zipfian")])
def test_unsupported_bimodal_settings_raise(section, key, value):
    """Every setting that raised until its part of the port came is
    accepted and reaches the params. ``dp_devices`` of more devices than
    the process group has raises ValueError naming torchrun, as JAX's
    "requested N devices, have M"; one device is accepted."""
    cfg = yaml.safe_load(open(SMOKE_YAML))
    cfg.setdefault(section, {})[key] = value
    if key == "dp_devices":
        with pytest.raises(ValueError, match="torchrun"):
            train_bimodal.check_supported(cfg)
        cfg["training"]["dp_devices"] = 1
        train_bimodal.check_supported(cfg)
        assert train_bimodal.build_params(cfg)["DP_DEVICES"] == 1
        return
    train_bimodal.check_supported(cfg)
    params = train_bimodal.build_params(cfg)
    name = {"dtype": "DTYPE", "compute_dtype": "COMPUTE_DTYPE",
            "stochastic_rounding": "SR"}.get(key)
    if name is not None:
        assert params[name] == value


@pytest.mark.parametrize("setting", [
    "checkpoint_every", "init_retry", "mod1_pretrained", "mod2_pretrained",
    "mod1_finetune_last_epochs", "mod2_finetune_last_epochs"])
def test_bimodal_setting_is_accepted_and_takes_effect(tmp_path, monkeypatch,
                                                      capsys, setting):
    """The settings that used to raise now run, and each changes the run."""
    import multimodal_idbn_tpu_torch.checkpoint as ckpt
    from multimodal_idbn_tpu_torch.models import iDBN
    training, paths = {"epochs_joint": 1}, {}
    saves, seen_lr = [], []
    if setting == "checkpoint_every":
        training["checkpoint_every"] = 1
        real = ckpt.save_train_checkpoint

        def counting(model, path, phase, next_epoch, loss_history=None):
            saves.append((phase, next_epoch))
            real(model, path, phase, next_epoch, loss_history)

        monkeypatch.setattr(ckpt, "save_train_checkpoint", counting)
        monkeypatch.setattr(train_bimodal, "save_train_checkpoint", counting)
    elif setting == "init_retry":
        training["init_retry"] = 1
        monkeypatch.setattr(iDBN, "_recon_collapse_ratio", lambda self: 1.0)
        real_reinit = iDBN.reinit_layers
        monkeypatch.setattr(
            iDBN, "reinit_layers", lambda self, seed_offset=0: (
                saves.append(seed_offset), real_reinit(self, seed_offset)))
    elif setting.endswith("_pretrained"):
        sizes = [256, 32] if setting.startswith("mod1") else [1568, 32]
        pre = iDBN(sizes, PARAMS, None, device="cpu", seed=9)
        pre.save_model(str(tmp_path / "pre.pkl"))
        paths[setting] = str(tmp_path / "pre.pkl")
    else:
        paths[setting] = 1
        from multimodal_idbn_tpu_torch.models import RBM
        real_epoch = RBM.train_epoch
        monkeypatch.setattr(
            RBM, "train_epoch", lambda self, *a, **kw: (
                seen_lr.append(self.lr), real_epoch(self, *a, **kw))[1])
    summary = train_bimodal.main(
        ["--config", str(_smoke_config(tmp_path, paths, **training)),
         "--device", "cpu"])
    out = capsys.readouterr().out
    name = setting[:4]
    if setting == "checkpoint_every":
        # a cadence save and the phase-complete marker per modality
        assert saves == [("mod1", 1), ("mod1", 2), ("mod2", 1), ("mod2", 2)]
        assert not any((tmp_path / "checkpoints").iterdir())
    elif setting == "init_retry":
        # the val-less modality stacks have no collapse ratio of their own;
        # the patched one retries each stack once
        assert saves == [7919, 7919]
        assert len(summary["mod1_loss"]) == 4
    elif setting.endswith("_pretrained"):
        assert f"[load_pretrained_{name}_dbn] loaded from" in out
        assert summary[f"{name}_loss"] == []
        np.testing.assert_array_equal(
            getattr(summary["model"], f"{name}_dbn").layers[0].W.numpy(),
            pre.layers[0].W.numpy())
    else:
        top = getattr(summary["model"], f"{name}_dbn").layers[-1]
        assert seen_lr and all(abs(lr - 0.3 * top.lr) < 1e-12
                               for lr in seen_lr)
    assert np.isfinite(summary["mse_mod1"])


def test_bimodal_configs_are_supported_and_cut():
    for name in ("bimodal_training_config", "smoke_bimodal"):
        train_bimodal.check_supported(
            yaml.safe_load(open(f"configs/{name}.yaml")))
    cfg = yaml.safe_load(open(SMOKE_YAML))
    cfg["dataset"]["second_modality"] = None
    with pytest.raises(ValueError, match="second modality"):
        train_bimodal.check_supported(cfg)


def test_cut_configs_keep_every_width(tmp_path):
    full = yaml.safe_load(open("configs/bimodal_training_config.yaml"))
    cut = yaml.safe_load(cuts.write_cut("bimodal-cut", tmp_path).read_text())
    assert cut["model"] == full["model"]
    changed = {(s, k) for s in ("dataset", "training") for k in full[s]
               if full[s][k] != cut[s][k]}
    assert changed == {("dataset", "n_samples"), ("training", "epochs_mod1"),
                       ("training", "epochs_mod2"),
                       ("training", "epochs_joint")}
    assert cut["paths"]["save_dir"] == str(tmp_path)
    train_bimodal.check_supported(cut)


def test_train_bimodal_device_rule():
    args = train_bimodal.parse_args([])
    assert args.device == "cuda"
    assert args.config.name == "bimodal_training_config.yaml"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_bimodal.main(["--config", SMOKE_YAML])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            iMDBN_BiModal([8, 4], [6, 3], [5], params=PARAMS)
