"""Elementwise parity of the port's ops (multimodal_idbn_tpu_torch.ops)
with the JAX package's, on seeded numpy inputs.

Tolerances: atol 1e-5 for single functions (fp32, different summation
order), 1e-4 for whole chains and updates. Sampled functions run with
both sides in their deterministic sampler mode (``both_deterministic``):
a Bernoulli draw is then ``p > 0.5``, and the seeded inputs keep every
such p far enough from 0.5 that no draw flips (0 flips allowed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.ops import rbm_ops as jrbm
from multimodal_idbn_tpu.ops import sampling as jsampling
from multimodal_idbn_tpu.ops import schedules as jsched
from multimodal_idbn_tpu_torch.ops import rbm_ops as trbm
from multimodal_idbn_tpu_torch.ops import rng as trng
from multimodal_idbn_tpu_torch.ops import sampling as tsampling
from multimodal_idbn_tpu_torch.ops import schedules as tsched

from torch_parity import (assert_states_close, both_deterministic, close,
                          jax_state, np_state, t, torch_state)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

Dz, K, H, B = 20, 5, 12, 8
V = Dz + K
GROUPS = ((Dz, V),)
KEY = jax.random.key(0)


def _setup(seed=0, v=V, h=H, momentum=False):
    rs = np.random.RandomState(seed)
    f = np_state(rs, v, h, momentum=momentum)
    return rs, f, jax_state(f), torch_state(f)


def _binary(rs, rows, cols, onehot_tail=False):
    x = (rs.rand(rows, cols) > 0.5).astype(np.float32)
    if onehot_tail:
        x[:, Dz:] = np.eye(K, dtype=np.float32)[rs.randint(0, K, rows)]
    return x


@pytest.mark.parametrize("n", [1, 2, 7, 30, 50])
def test_schedules(n):
    close(tsched.annealed_temperature(n, 3.0, 1.0, 3, 0.9),
          jsched.annealed_temperature(n, 3.0, 1.0, 3, 0.9), 1e-7)
    close(tsched.annealed_temperature(n, 3.0, 1.0, 2, 0.9),
          jsched.annealed_temperature(n, 3.0, 1.0, 2, 0.9), 1e-7)
    close(tsched.noise_sigma(n, 0.9), jsched.noise_sigma(n, 0.9), 1e-7)
    close(tsched.mu_pull_eta(n, 0.15), jsched.mu_pull_eta(n, 0.15), 1e-7)
    steps = np.arange(n)
    close(tsched.lin_schedule(steps, n, 2.5, 1.0),
          jsched.lin_schedule(steps, n, 2.5, 1.0), 1e-7)


@pytest.mark.parametrize("epoch", [0, 5, 6, 40])
def test_host_schedules(epoch):
    assert tsched.effective_lr(0.1, epoch, True) == \
        jsched.effective_lr(0.1, epoch, True)
    assert tsched.effective_lr(0.1, epoch, False) == 0.1
    assert tsched.effective_momentum(0.5, 0.95, epoch) == \
        jsched.effective_momentum(0.5, 0.95, epoch)


@pytest.mark.parametrize("T", [1.0, 1.7, 0.4])
def test_conditionals(T):
    rs, _, js, ts = _setup(1)
    v = _binary(rs, B, V, onehot_tail=True)
    h = rs.rand(B, H).astype(np.float32)
    close(trbm.hidden_probs(ts, t(v), T),
          jrbm.hidden_probs(js, jnp.asarray(v), T), 1e-5)
    close(trbm.visible_logits(ts, t(h), T),
          jrbm.visible_logits(js, jnp.asarray(h), T), 1e-5)
    close(trbm.visible_probs(ts, t(h), T, GROUPS),
          jrbm.visible_probs(js, jnp.asarray(h), T, GROUPS), 1e-5)
    close(trbm.free_energy(ts, t(v)), jrbm.free_energy(js, jnp.asarray(v)),
          1e-5)


def test_sampling_helpers():
    rs = np.random.RandomState(2)
    p = rs.rand(B, V).astype(np.float32)
    logits = rs.randn(B, V).astype(np.float32)
    close(tsampling.apply_softmax_groups(t(p), t(logits), GROUPS),
          jsampling.apply_softmax_groups(jnp.asarray(p), jnp.asarray(logits),
                                         GROUPS), 1e-6)
    vk = rs.rand(B, V).astype(np.float32)
    km = (rs.rand(B, V) > 0.5).astype(np.float32)
    close(tsampling.clamp_mask(t(p), t(vk), t(km)),
          jsampling.clamp_mask(jnp.asarray(p), jnp.asarray(vk),
                               jnp.asarray(km)), 0)
    close(tsampling.group_mask(V, GROUPS), jsampling.group_mask(V, GROUPS), 0)


def test_samplers_real_draws():
    """Real draws: Bernoulli rates, one-hot groups, key determinism."""
    p = torch.full((4000, 3), 0.3)
    s = tsampling.sample_bernoulli(11, p)
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(s.mean()) - 0.3) < 0.02
    assert torch.equal(s, tsampling.sample_bernoulli(11, p))
    assert not torch.equal(s, tsampling.sample_bernoulli(12, p))
    probs = torch.tensor([[0.7, 0.2, 0.1]]).repeat(4000, 1)
    oh = tsampling.sample_categorical_onehot(5, probs)
    assert torch.equal(oh.sum(1), torch.ones(4000))
    np.testing.assert_allclose(oh.mean(0).numpy(), [0.7, 0.2, 0.1],
                               atol=0.03)
    v = tsampling.sample_visible(3, torch.rand(50, V), GROUPS)
    assert torch.equal(v[:, Dz:].sum(1), torch.ones(50))


@pytest.mark.parametrize("groups,cd,sparsity",
                         [((), 1, False), ((), 3, True), (GROUPS, 2, False)])
def test_cd_update(monkeypatch, groups, cd, sparsity):
    rs, _, js, ts = _setup(3, momentum=True)
    x = _binary(rs, B, V, onehot_tail=bool(groups))
    kw = dict(lr=0.05, mom=0.5, weight_decay=1e-4, cd=cd, sparsity=sparsity,
              sparsity_factor=0.1, groups=groups)
    with both_deterministic(monkeypatch):
        jnew, jloss = jrbm.cd_update(js, KEY, jnp.asarray(x), **kw)
        tnew, tloss = trbm.cd_update(ts, 0, t(x), **kw)
    assert_states_close(tnew, jnew, 1e-4)
    close(tloss, jloss, 1e-5)


@pytest.mark.parametrize("reclamp,sample_h,noisy_init",
                         [(True, False, True), (False, False, True),
                          (True, True, False)])
def test_clamped_cd_update(monkeypatch, reclamp, sample_h, noisy_init):
    rs, _, js, ts = _setup(4)
    y = np.eye(K, dtype=np.float32)[rs.randint(0, K, B)]
    vk = np.concatenate([np.zeros((B, Dz), np.float32), y], 1)
    km = np.concatenate([np.zeros((B, Dz)), np.ones((B, K))],
                        1).astype(np.float32)
    kw = dict(lr=0.04, mom=0.5, weight_decay=1e-4, cd=1, cond_init_steps=4,
              sample_h=sample_h, sample_v=False, reclamp_negative=reclamp,
              aux_lr_mult=0.3, use_noisy_init=noisy_init, groups=GROUPS)
    with both_deterministic(monkeypatch):
        jnew, jloss = jrbm.clamped_cd_update(js, KEY, jnp.asarray(vk),
                                             jnp.asarray(km), **kw)
        tnew, tloss = trbm.clamped_cd_update(ts, 0, t(vk), t(km), **kw)
    assert_states_close(tnew, jnew, 1e-4)
    close(tloss, jloss, 1e-5)


@pytest.mark.parametrize("n_steps,sample_h", [(0, False), (6, False),
                                              (5, True)])
def test_conditional_gibbs(monkeypatch, n_steps, sample_h):
    rs, _, js, ts = _setup(5)
    z = rs.rand(B, Dz).astype(np.float32)
    vk = np.concatenate([z, np.zeros((B, K), np.float32)], 1)
    km = np.concatenate([np.ones((B, Dz)), np.zeros((B, K))],
                        1).astype(np.float32)
    kw = dict(n_steps=n_steps, sample_h=sample_h, sample_v=False,
              groups=GROUPS)
    with both_deterministic(monkeypatch):
        jout = jrbm.conditional_gibbs(js, KEY, jnp.asarray(vk),
                                      jnp.asarray(km), **kw)
        tout = trbm.conditional_gibbs(ts, 0, t(vk), t(km), **kw)
    close(tout, jout, 1e-4)


@pytest.mark.parametrize("with_mu,n_steps", [(False, 9), (True, 12),
                                             (True, 0)])
def test_noisy_meanfield_annealed(monkeypatch, with_mu, n_steps):
    rs, _, js, ts = _setup(6)
    y = np.eye(K, dtype=np.float32)[rs.randint(0, K, B)]
    vk = np.concatenate([np.zeros((B, Dz), np.float32), y], 1)
    km = np.concatenate([np.zeros((B, Dz)), np.ones((B, K))],
                        1).astype(np.float32)
    mu = rs.rand(B, Dz).astype(np.float32) if with_mu else None
    kw = dict(n_steps=n_steps, T0=3.0, T1=1.0, sigma0=0.9, hot_frac=0.7,
              sharpen_last=3, T_cold_plus=0.9, eta0=0.15, groups=GROUPS)
    with both_deterministic(monkeypatch):
        jout = jrbm.noisy_meanfield_annealed(
            js, KEY, jnp.asarray(vk), jnp.asarray(km),
            mu_k=None if mu is None else jnp.asarray(mu), **kw)
        tout = trbm.noisy_meanfield_annealed(
            ts, 0, t(vk), t(km), mu_k=None if mu is None else t(mu), **kw)
    close(tout, jout, 1e-4)
    close(tout[:, Dz:], y, 0)  # the label block comes back clamped


def test_noisy_chain_real_noise_properties():
    """Real draws: in [0, 1], clamped block exact, deterministic per key,
    different keys differ."""
    rs, _, _, ts = _setup(7)
    y = np.eye(K, dtype=np.float32)[rs.randint(0, K, B)]
    vk = t(np.concatenate([np.zeros((B, Dz), np.float32), y], 1))
    km = t(np.concatenate([np.zeros((B, Dz)), np.ones((B, K))], 1))
    run = lambda key: trbm.noisy_meanfield_annealed(  # noqa: E731
        ts, key, vk, km, n_steps=10, mu_k=t(rs.rand(B, Dz)), groups=GROUPS)
    a, b, c = run(1), run(1), run(2)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert torch.equal(a[:, Dz:], vk[:, Dz:])
    assert not torch.equal(a[:, :Dz], c[:, :Dz])
    assert a.shape == b.shape


def test_init_rbm_state_is_device_independent_and_scaled():
    s = trbm.init_rbm_state(123, 400, 30)
    assert s.w.shape == (400, 30) and float(s.hb.abs().sum()) == 0.0
    assert abs(float(s.w.std()) * np.sqrt(400) - 1.0) < 0.05
    assert torch.equal(s.w, trbm.init_rbm_state(123, 400, 30).w)


def test_keys():
    assert trng.fold_in(1, 2) == trng.fold_in(1, 2)
    assert len({trng.fold_in(7, i) for i in range(1000)}) == 1000
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert trng.next_key(g1) == trng.next_key(g2)
    assert 0 <= trng.next_key(g1) < 2 ** 64
