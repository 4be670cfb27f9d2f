"""The multimodal DBN's visible units on the CPU: the Gaussian and
replicated-softmax CD-k updates, the batch step and the epoch of the
port against the plain reference of ``tests/mdbn_reference.py``, the new
half-step entries' and the word sampler's plain versions against plain
formulas, the two copies of the reference against each other,
``train_bimodal`` on a cut copy of the multimodal DBN's YAML, the
checkpoint's record of the visible types, and the routes that raise."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import mdbn_reference as ref
from multimodal_idbn_tpu_torch.ops import (dbn_train, fast_cd, half_step,
                                           rng, rsoftmax)
from multimodal_idbn_tpu_torch.ops.rbm_ops import RBMState, init_rbm_state
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("w", "hb", "vb", "w_m", "hb_m", "vb_m")
VISIBLE = ("gaussian", "replicated_softmax")


def _data(visible, n, V, seed=0):
    g = torch.Generator().manual_seed(seed)
    if visible == "gaussian":
        return torch.randn((n, V), generator=g)
    if visible == "bernoulli":
        return (torch.rand((n, V), generator=g) < 0.3).float()
    out = torch.zeros((n, V))
    idx = torch.randint(0, V, (n, 10), generator=g)
    take = (torch.arange(10)[None] < torch.randint(1, 11, (n, 1),
                                                    generator=g)).float()
    return out.scatter_add_(1, idx, take)


def _states(sizes, seed=1):
    out = []
    for i, (v, h) in enumerate(zip(sizes[:-1], sizes[1:])):
        st = init_rbm_state(seed + i, v, h)
        g = torch.Generator().manual_seed(seed + 10 + i)
        # biases and momentum not zero, so every term of the update counts
        out.append(st.replace(hb=0.1 * torch.randn(h, generator=g),
                              vb=0.1 * torch.randn(v, generator=g),
                              w_m=0.01 * torch.randn((v, h), generator=g)))
    return out


def _as_ref(st):
    return {f: getattr(st, f).clone() for f in FIELDS}


def _close(port, want, tol=2e-5):
    for f in FIELDS:
        a, b = getattr(port, f), want[f]
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol * scale, f


@pytest.mark.parametrize("visible", VISIBLE)
def test_cd_update_matches_the_reference(visible):
    sizes = [37, 13]
    (st,) = _states(sizes)
    data = _data(visible, 19, 37)
    upd = fast_cd.visible_update(visible)
    new, loss = upd(st, 77, data, lr=0.05, mom=0.5, weight_decay=1e-3, cd=3)
    want, want_loss = ref.UPDATES[visible](_as_ref(st), 77, data, lr=0.05,
                                           mom=0.5, wd=1e-3, cd=3)
    _close(new, want)
    assert abs(float(loss) - want_loss) <= 1e-5 * max(1.0, want_loss)


@pytest.mark.parametrize("visible", VISIBLE)
def test_batch_step_matches_the_reference(visible):
    sizes = [37, 20, 11]
    states = _states(sizes)
    data = _data(visible, 23, 37)
    kw = dict(cd=2, sparsity_flags=[False, False], fast_sampler=True)
    new, losses = dbn_train.idbn_batch_step(
        states, 99, data, 0.1, 0.5, 1e-4, 0.1, visible=visible,
        visible_lr_scale=0.01, **kw)
    want, want_losses = ref.step([_as_ref(s) for s in states], 99, data,
                                 visible=visible, lr=0.1, mom=0.5, wd=1e-4,
                                 cd=2, lr_scale=0.01)
    for a, b in zip(new, want):
        _close(a, b)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-5)


@pytest.mark.parametrize("visible", VISIBLE)
def test_epoch_of_the_model_matches_the_reference(visible):
    """Two epochs through ``iDBN._train_epoch`` and its runner (the
    benchmark's entry), the remainder batch included."""
    from multimodal_idbn_tpu_torch.models.idbn import iDBN
    sizes = [29, 16, 8]
    params = dict(LEARNING_RATE=0.1, WEIGHT_PENALTY=1e-4, INIT_MOMENTUM=0.5,
                  FINAL_MOMENTUM=0.9, LEARNING_RATE_DYNAMIC=True, CD=2,
                  SEED=4)

    class Loader:
        batch_size = 16

    dbn = iDBN(sizes, params, Loader(), device="cpu", seed=4,
               visible=visible, visible_lr_scale=0.1)
    states = _states(sizes)
    dbn._set_states(states)
    data = _data(visible, 41, 29)
    runner = dbn._epoch_runner(data, 16)
    layers = [_as_ref(s) for s in states]
    for e in range(2):
        loss = dbn._train_epoch(e, runner, 16)
        lr = 0.1 / (1 + 0.01 * e)
        layers, want = ref.epoch(layers, data, rng.fold_in(4, e), batch=16,
                                 visible=visible, lr=lr, mom=0.5, wd=1e-4,
                                 cd=2, lr_scale=0.1)
        assert abs(loss - want) <= 1e-5 * max(1.0, abs(want))
    for a, b in zip(dbn.states(), layers):
        _close(a, b)


def test_bernoulli_reference_is_the_ports_image_step():
    """The reference's Bernoulli stack is the port's batch step as it
    always was (no ``visible``)."""
    sizes = [30, 12, 7]
    states = _states(sizes)
    data = _data("bernoulli", 17, 30)
    new, losses = dbn_train.idbn_batch_step(
        states, 5, data, 0.1, 0.9, 1e-4, 0.1, cd=2,
        sparsity_flags=[False, False], fast_sampler=True)
    want, want_losses = ref.step([_as_ref(s) for s in states], 5, data,
                                 visible="bernoulli", lr=0.1, mom=0.9,
                                 wd=1e-4, cd=2)
    for a, b in zip(new, want):
        _close(a, b)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-5)


@pytest.mark.parametrize("visible", VISIBLE)
def test_the_two_reference_copies_agree(visible):
    from portbench.reference import mdbn as bench_ref
    from portbench.reference.rbm import Arith
    sizes = [33, 14, 9]
    layers = [_as_ref(s) for s in _states(sizes)]
    data = _data(visible, 45, 33)
    kw = dict(lr=0.1, mom=0.5, wd=1e-4, cd=2, lr_scale=0.05)
    a, la = bench_ref.epoch(Arith(), [dict(s) for s in layers], data, 123,
                            batch=16, visible=visible, **kw)
    b, lb = ref.epoch([dict(s) for s in layers], data, 123, batch=16,
                      visible=visible, **kw)
    assert abs(la - lb) <= 1e-6 * max(1.0, abs(lb))
    for x, y in zip(a, b):
        for f in FIELDS:
            assert torch.allclose(x[f], y[f], rtol=1e-5, atol=1e-6), f


def test_epilogue_plain_versions_against_formulas():
    g = torch.Generator().manual_seed(8)
    B, K, N = 37, 77, 130
    h = (torch.rand((B, K), generator=g) < 0.4).float()
    w_t = torch.randn((N, K), generator=g) * K ** -0.5
    b = 0.1 * torch.randn(N, generator=g)
    mean = h @ w_t.T + b
    lin = half_step.half_step_linear(h, w_t, b, T=0.5)
    assert torch.allclose(lin, mean / 0.5, atol=1e-6)
    m, s = half_step.half_step_gauss(h, w_t, b, 11)
    assert torch.allclose(m, mean, atol=1e-6)
    u1 = torch.clamp(rng.bits_to_uniform(rng.philox_bits(11, B, N)), 1e-7)
    x1 = rng.philox4x32(rng._grid_counter(B, N, 0, 0, None),
                        rng.key_word(11))[1]
    noise = torch.sqrt(-2 * torch.log(u1)) * torch.cos(
        2 * np.pi * rng.bits_to_uniform(x1))
    assert torch.allclose(s - m, noise, atol=1e-5)
    D = torch.randint(1, 11, (B,), generator=g).float()
    x = torch.randn((B, N), generator=g)
    p, smp = half_step.half_step_scaled(x, w_t, torch.full((K,), 0.3), D,
                                        12)
    want = torch.sigmoid(x @ w_t + 0.3 * D[:, None])
    assert torch.allclose(p, want, atol=1e-6)
    u = rng.philox_uniform(12, B, K)
    assert torch.equal(smp, (p > u).float())
    with pytest.raises(ValueError):
        half_step.half_step_scaled(x, w_t, torch.zeros(K), D[:3], 12)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sampler_counts_sum_to_the_words_of_every_row(seed):
    g = torch.Generator().manual_seed(seed)
    logits = 3.0 * torch.randn((40, 301), generator=g)
    words = torch.randint(1, 11, (40,), generator=g).float()
    counts, mean = rsoftmax.rs_sample(logits, words, seed)
    assert torch.equal(counts.sum(1), words)
    assert bool((counts >= 0).all()) and torch.equal(counts, counts.round())
    assert torch.allclose(mean.sum(1), words, rtol=1e-5)
    again, _ = rsoftmax.rs_sample(logits, words, seed)
    assert torch.equal(again, counts)
    # the kernel's order of sums is a cumulative sum of the weights
    cdf = rsoftmax.cumulative_weights(logits)
    e = torch.exp(logits - logits.max(1, keepdim=True).values)
    assert torch.allclose(cdf, e.double().cumsum(1).float(), rtol=1e-5)


def test_sampler_draws_follow_the_softmax():
    logits = torch.tensor([[0.0, np.log(3.0), -50.0]]).repeat(4000, 1)
    words = torch.full((4000,), 2.0)
    counts, _ = rsoftmax.rs_sample(logits, words, 5)
    share = counts.sum(0) / counts.sum()
    assert abs(float(share[1]) - 0.75) < 0.02 and float(share[2]) == 0.0


def _cut_yaml(tmp_path, **training):
    cfg = yaml.safe_load((REPO / "configs" /
                          "mdbn_flickr_training_config.yaml").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["dataset"].update(batch_size=16, n_samples=80)
    cfg["model"].update(mod1_layers=[37, 24, 16], mod2_layers=[40, 20, 12],
                        joint_hidden=[16], num_labels=4)
    cfg["training"].update(cd=2, epochs_mod1=2, epochs_mod2=2, joint_cd=1,
                           epochs_joint=9, cross_gibbs_steps=4,
                           JOINT_AUX_COND_STEPS=3, **training)
    cfg["paths"].update(save_dir=str(tmp_path / "out"), save_name="mdbn")
    path = tmp_path / "mdbn.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_train_bimodal_runs_the_multimodal_dbn_yaml(tmp_path):
    from multimodal_idbn_tpu_torch import train_bimodal
    out = train_bimodal.main(["--config", str(_cut_yaml(tmp_path)),
                              "--device", "cpu"])
    model = out["model"]
    assert model.visibles == ("gaussian", "replicated_softmax")
    assert model.mod1_dbn.visible_lr_scale == 0.01
    assert all(np.isfinite(out["mod1_loss"] + out["mod2_loss"]))
    assert np.isfinite(out["mse_mod1"]) and np.isfinite(out["mse_mod2"])
    words = torch.zeros((3, 40))
    words[:, :5] = 1.0
    dist = model.mod2_to_mod1(words)
    assert dist.shape == (3, 37)
    text = model.mod1_to_mod2(torch.randn(3, 37))
    assert torch.allclose(text.sum(1), torch.ones(3), atol=1e-5)
    with pytest.raises(NotImplementedError, match="replicated_softmax"):
        model.sample_mod1_to_mod2(torch.randn(3, 37))
    with pytest.raises(NotImplementedError, match="gaussian"):
        model.sample_mod2_to_mod1(words)


def test_a_yaml_without_the_keys_builds_the_bernoulli_model():
    from multimodal_idbn_tpu_torch import train_bimodal
    cfg = yaml.safe_load((REPO / "configs" /
                          "bimodal_training_config.yaml").read_text())
    params = train_bimodal.build_params(cfg)
    assert not any("VISIBLE" in k for k in params)
    mdbn = yaml.safe_load((REPO / "configs" /
                           "mdbn_flickr_training_config.yaml").read_text())
    got = train_bimodal.build_params(mdbn)
    assert got["MOD1_VISIBLE"] == "gaussian"
    assert got["MOD2_VISIBLE"] == "replicated_softmax"
    bad = copy.deepcopy(mdbn)
    bad["model"]["mod1_visible"] = "poisson"
    with pytest.raises(ValueError, match="poisson"):
        train_bimodal.check_supported(bad)


def _bimodal(params=None, seed=1):
    from multimodal_idbn_tpu_torch.models.imdbn_bimodal import iMDBN_BiModal
    base = dict(LEARNING_RATE=0.1, WEIGHT_PENALTY=1e-4, INIT_MOMENTUM=0.5,
                FINAL_MOMENTUM=0.95, LEARNING_RATE_DYNAMIC=True, CD=1,
                SEED=5)
    return iMDBN_BiModal([12, 8], [10, 6], [5], params=dict(base,
                                                            **(params or {})),
                         device="cpu", seed=seed)


MDBN = dict(MOD1_VISIBLE="gaussian", MOD2_VISIBLE="replicated_softmax")


def test_checkpoint_saves_loads_and_refuses_the_visible_types(tmp_path):
    from multimodal_idbn_tpu_torch import checkpoint
    g, b = _bimodal(MDBN), _bimodal()
    checkpoint.save_checkpoint(g, str(tmp_path / "g"))
    checkpoint.save_checkpoint(b, str(tmp_path / "b"))
    g2 = _bimodal(MDBN, seed=2)
    checkpoint.load_checkpoint(g2, str(tmp_path / "g"))
    assert torch.equal(g2.mod1_dbn.layers[0].state.w,
                       g.mod1_dbn.layers[0].state.w)
    with pytest.raises(ValueError, match="gaussian"):
        checkpoint.load_checkpoint(_bimodal(), str(tmp_path / "g"))
    # a file without the record (every older checkpoint) holds Bernoulli
    # stacks: it loads into a Bernoulli model, not into a multimodal DBN
    checkpoint.load_checkpoint(_bimodal(seed=3), str(tmp_path / "b"))
    with pytest.raises(ValueError, match="bernoulli"):
        checkpoint.load_checkpoint(_bimodal(MDBN), str(tmp_path / "b"))
    fp_g = checkpoint.config_fingerprint(g.params)
    fp_b = checkpoint.config_fingerprint(b.params)
    assert "MOD1_VISIBLE" in fp_g and "VISIBLE" not in fp_b


def test_pickle_keeps_the_types_and_an_old_pickle_is_bernoulli():
    import pickle
    g = _bimodal(MDBN)
    assert pickle.loads(pickle.dumps(g)).visibles == ("gaussian",
                                                      "replicated_softmax")
    old = pickle.loads(pickle.dumps(_bimodal().mod1_dbn))
    del old.__dict__["visible"], old.__dict__["visible_lr_scale"]
    old.__setstate__(dict(old.__dict__))
    assert old.visible == "bernoulli" and old.visible_lr_scale == 1.0


@pytest.mark.parametrize("visible", VISIBLE)
def test_unsupported_routes_raise(visible):
    from multimodal_idbn_tpu_torch.models.idbn import iDBN
    params = dict(LEARNING_RATE=0.1, WEIGHT_PENALTY=1e-4, INIT_MOMENTUM=0.5,
                  FINAL_MOMENTUM=0.9, LEARNING_RATE_DYNAMIC=True, CD=1,
                  SEED=1)
    data = _data(visible, 20, 12)

    class Loader:
        batch_size = 8

        def __iter__(self):
            yield data[:8], None

    for extra in (dict(DTYPE="bfloat16"), dict(PCD=True)):
        dbn = iDBN([12, 6], dict(params, **extra), Loader(), device="cpu",
                   seed=1, visible=visible)
        with pytest.raises(NotImplementedError, match=visible):
            dbn._epoch_runner(data, 8)
    dbn = iDBN([12, 6], params, Loader(), device="cpu", seed=1,
               visible=visible)
    with pytest.raises(NotImplementedError, match=visible):
        dbn.train(1, fused=False)
    with pytest.raises(NotImplementedError, match=visible):
        dbn_train.check_visible_route(visible, mesh=object())
    with pytest.raises(NotImplementedError, match=visible):
        dbn_train.dbn_decode_sampled(dbn.states(), torch.rand(2, 6), 3,
                                     visible)
    with pytest.raises(NotImplementedError, match=visible):
        dbn_train.check_visible_route(visible, groups=((0, 4),))
    dbn_train.check_visible_route("bernoulli", fast_sampler=False, pcd=True,
                                  mesh=object(), groups=((0, 4),))


def test_decode_gives_the_mean_and_the_word_distribution():
    states = _states([12, 6])
    top = torch.rand(4, 6)
    mean = dbn_train.dbn_decode(states, top, "gaussian")
    assert torch.allclose(mean, top @ states[0].w.T + states[0].vb,
                          atol=1e-6)
    dist = dbn_train.dbn_decode(states, top, "replicated_softmax")
    assert torch.allclose(dist, torch.softmax(mean, 1), atol=1e-6)
    v = _data("replicated_softmax", 4, 12)
    z = dbn_train.dbn_represent(states, v, 1, "replicated_softmax")
    want = torch.sigmoid(v @ states[0].w + v.sum(1, keepdim=True)
                         * states[0].hb)
    assert torch.allclose(z, want, atol=1e-6)
    assert isinstance(states[0], RBMState)


def test_the_card_drive_cuts_only_scale(tmp_path):
    """``cuts`` "mdbn-cut", the drive of ``chip_smoke.py --mdbn``: the
    YAML's widths, unit types and CD kept, one epoch of each phase, the
    benchmark cells' 1 434 training rows."""
    from multimodal_idbn_tpu_torch import cuts
    full = yaml.safe_load((REPO / "configs" /
                           "mdbn_flickr_training_config.yaml").read_text())
    cut = yaml.safe_load(cuts.write_cut("mdbn-cut", tmp_path).read_text())
    assert cut["model"] == full["model"]
    assert cut["training"]["cd"] == full["training"]["cd"] == 10
    assert [cut["training"][f"epochs_{p}"]
            for p in ("mod1", "mod2", "joint")] == [1, 1, 1]
    assert int(0.7 * cut["dataset"]["n_samples"]) in (1433, 1434)
    assert cut["paths"]["save_dir"] == str(tmp_path)
