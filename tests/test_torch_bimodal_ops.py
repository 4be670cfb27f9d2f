"""The port's bimodal ops and its last two half-step kernels, held against
the JAX package on seeded numpy inputs at small widths.

- Kernels 3 and 4 (probs-only and resident sampled half-step): the plain
  versions against the JAX ``half_step_probs`` run in interpret mode (as
  tests/test_pallas.py runs it) and ``reference_half_step``; the sample
  against its own Philox plain draw. Tolerance 1e-5: fp32 sums of at most
  300 terms in another order, through a sigmoid.
- ``sampled_conditional_chain``, ``dbn_decode_sampled``,
  ``bimodal_cross_reconstruct`` and ``sample_cross``: deterministic under
  both sides' deterministic sampler modes; atol 1e-5.
- One bimodal batch (warm-up and main, two joint layers) and one epoch
  with a remainder batch: whole CD updates and chains; atol 1e-5 on
  parameters and metrics means, which these widths reach (sums of at most
  20 fp32 terms per product); the summed metrics and epoch statistics
  atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.ops import bimodal_ops as jbi
from multimodal_idbn_tpu.ops import dbn_train as jdbn
from multimodal_idbn_tpu.ops import pallas_kernels as pk
from multimodal_idbn_tpu.ops import rbm_ops as jrbm
from multimodal_idbn_tpu_torch.ops import bimodal_ops as tbi
from multimodal_idbn_tpu_torch.ops import dbn_train as tdbn
from multimodal_idbn_tpu_torch.ops import half_step, rbm_ops, rng

from torch_parity import (assert_states_close, both_deterministic, close,
                          jax_state, np_state, t, torch_state)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

KEY = jax.random.key(0)
B, D1, D2, Dz1, Dz2 = 6, 20, 18, 12, 8
JOINT = [(Dz1 + Dz2, 10), (10, 6)]


def _run_interpret(kernel_call, *args, **kw):
    """Run a Pallas kernel in interpret mode on the CPU, as
    tests/test_pallas.py:18-35 does."""
    from jax.experimental import pallas as pl_mod
    orig = pl_mod.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl_mod.pallas_call = patched
    try:
        return kernel_call(*args, **kw)
    finally:
        pl_mod.pallas_call = orig


def _half_step_inputs(B_, V, H, seed):
    rs = np.random.RandomState(seed)
    v = rs.rand(B_, V).astype(np.float32)
    w = (rs.randn(V, H) / np.sqrt(V)).astype(np.float32)
    b = (0.1 * rs.randn(H)).astype(np.float32)
    return v, w, b


@pytest.mark.parametrize("shape,T", [((32, 100, 64), 1.3),
                                     ((130, 200, 300), 1.0),
                                     ((7, 33, 5), 0.5)])
def test_half_step_probs_plain_matches_interpret(shape, T):
    v, w, b = _half_step_inputs(*shape, seed=shape[0])
    want = _run_interpret(pk.half_step_probs, jnp.asarray(v), jnp.asarray(w),
                          jnp.asarray(b), T)
    close(half_step.half_step_probs(t(v), t(w), t(b), T), want, 1e-5)
    st = rbm_ops.RBMState(t(w), t(b), t(np.zeros(shape[1])), *(
        torch.zeros(1),) * 3)
    jst = jrbm.RBMState(jnp.asarray(w), jnp.asarray(b),
                        jnp.zeros(shape[1]), *(jnp.zeros(1),) * 3)
    close(half_step.hidden_probs_kernel(st, t(v), T),
          pk.hidden_probs_pallas(jst, jnp.asarray(v), T), 1e-5)


@pytest.mark.parametrize("seed", [7, -123456, 2 ** 31 - 1])
def test_half_step_sample_resident_plain(seed):
    v, w, b = _half_step_inputs(64, 40, 96, seed=1)
    p, s = half_step.half_step_sample_resident(t(v), t(w), t(b), seed, 1.2)
    close(p, pk.reference_half_step(jnp.asarray(v), jnp.asarray(w),
                                    jnp.asarray(b), 1.2), 1e-5)
    u = rng.philox_uniform(seed & 0xFFFFFFFF, 64, 96)
    assert torch.equal(s, (p > u).float())
    assert set(np.unique(s.numpy())) <= {0.0, 1.0}
    assert abs(float(s.mean()) - float(p.mean())) < 0.05
    _, again = half_step.half_step_sample_resident(t(v), t(w), t(b), seed,
                                                   1.2)
    assert torch.equal(s, again)
    _, other = half_step.half_step_sample_resident(t(v), t(w), t(b),
                                                   seed ^ 1, 1.2)
    assert not torch.equal(s, other)
    with rng.deterministic():
        p_d, s_d = half_step.half_step_sample_resident(t(v), t(w), t(b),
                                                       seed, 1.2)
    assert torch.equal(s_d, (p_d > 0.5).float())


@pytest.mark.parametrize("seed", [2 ** 31, -(2 ** 31) - 1])
def test_half_step_sample_resident_refuses_non_int32_seeds(seed):
    v, w, b = _half_step_inputs(4, 5, 3, seed=0)
    with pytest.raises(ValueError, match="int32"):
        half_step.half_step_sample_resident(t(v), t(w), t(b), seed)


@pytest.mark.parametrize("groups,mask_1d", [((), False), (((3, 7),), True)])
def test_sampled_conditional_chain(monkeypatch, groups, mask_1d):
    rs = np.random.RandomState(4)
    f = np_state(rs, 12, 9)
    vk = rs.rand(B, 12).astype(np.float32)
    km = (rs.rand(12) < 0.5).astype(np.float32) if mask_1d else (
        rs.rand(B, 12) < 0.5).astype(np.float32)
    with both_deterministic(monkeypatch):
        want = jrbm.sampled_conditional_chain(
            jax_state(f), KEY, jnp.asarray(vk), jnp.asarray(km), n_steps=4,
            groups=groups)
        got = rbm_ops.sampled_conditional_chain(
            torch_state(f), 0, t(vk), t(km), n_steps=4, groups=groups)
    close(got, want, 1e-5)
    with pytest.raises(ValueError, match="n_steps >= 1"):
        rbm_ops.sampled_conditional_chain(torch_state(f), 0, t(vk), t(km),
                                          n_steps=0)


def test_dbn_decode_sampled(monkeypatch):
    rs = np.random.RandomState(5)
    fs = [np_state(rs, 20, 14), np_state(rs, 14, 9), np_state(rs, 9, 5)]
    top = rs.rand(B, 5).astype(np.float32)
    with both_deterministic(monkeypatch):
        want = jdbn.dbn_decode_sampled(tuple(jax_state(f) for f in fs),
                                       jnp.asarray(top), KEY)
        got = tdbn.dbn_decode_sampled([torch_state(f) for f in fs], t(top),
                                      0)
    close(got, want, 1e-5)


def _bimodal(seed, n=B):
    rs = np.random.RandomState(seed)
    m1 = [np_state(rs, D1, Dz1)]
    m2 = [np_state(rs, D2, 10), np_state(rs, 10, Dz2)]
    joint = [np_state(rs, v, h, momentum=True) for v, h in JOINT]
    z1 = rs.rand(n, Dz1).astype(np.float32)
    z2 = rs.rand(n, Dz2).astype(np.float32)
    v1 = (rs.rand(n, D1) > 0.5).astype(np.float32)
    v2 = (rs.rand(n, D2) > 0.5).astype(np.float32)
    return m1, m2, joint, z1, z2, v1, v2


def _jax(fs):
    return tuple(jax_state(f) for f in fs)


def _torch(fs):
    return [torch_state(f) for f in fs]


@pytest.mark.parametrize("direction", ["both", "1to2", "2to1"])
def test_bimodal_cross_reconstruct(monkeypatch, direction):
    m1, m2, joint, z1, z2, _, _ = _bimodal(1)
    with both_deterministic(monkeypatch):
        want = jbi.bimodal_cross_reconstruct(
            jax_state(joint[0]), _jax(m1), _jax(m2), KEY, jnp.asarray(z1),
            jnp.asarray(z2), steps=5, Dz1=Dz1, direction=direction)
        got = tbi.bimodal_cross_reconstruct(
            torch_state(joint[0]), _torch(m1), _torch(m2), 0, t(z1), t(z2),
            steps=5, Dz1=Dz1, direction=direction)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            close(g, w, 1e-5)
    with pytest.raises(ValueError, match="direction"):
        tbi.bimodal_cross_reconstruct(
            torch_state(joint[0]), _torch(m1), _torch(m2), 0, t(z1), t(z2),
            steps=5, Dz1=Dz1, direction="sideways")


@pytest.mark.parametrize("warmup", [True, False])
def test_bimodal_batch_step(monkeypatch, warmup):
    m1, m2, joint, z1, z2, v1, v2 = _bimodal(2)
    kw = dict(warmup=warmup, joint_cd=2, aux_cond_steps=4, Dz1=Dz1, steps=3,
              compute_metrics=True)
    with both_deterministic(monkeypatch):
        jnew, jcd, jm = jbi._bimodal_train_batch(
            _jax(joint), _jax(m1), _jax(m2), KEY, *map(jnp.asarray,
                                                       (z1, z2, v1, v2)),
            0.04, 0.5, 1e-4, **kw)
        tnew, tcd, tm = tbi.bimodal_batch_step(
            _torch(joint), _torch(m1), _torch(m2), 0, *map(t, (z1, z2, v1,
                                                              v2)),
            0.04, 0.5, 1e-4, **kw)
    assert len(tnew) == 2
    for ts, js in zip(tnew, jnew):
        assert_states_close(ts, js, 1e-5)
    if warmup:  # only layer 0 moves in warm-up
        assert_states_close(tnew[1], torch_state(joint[1]), 0.0)
    close(tcd, jcd, 1e-5)
    close(tm.n, jm.n, 0.0)
    close(tm.mse_mod1 / (B * D1), jm.mse_mod1 / (B * D1), 1e-5)
    close(tm.mse_mod2 / (B * D2), jm.mse_mod2 / (B * D2), 1e-5)


@pytest.mark.parametrize("warmup,metrics_every", [(True, 1), (False, 2)])
def test_bimodal_epoch_with_remainder(monkeypatch, warmup, metrics_every):
    n = 2 * B + 3
    m1, m2, joint, Z1, Z2, V1, V2 = _bimodal(3, n)
    kw = dict(warmup=warmup, joint_cd=1, aux_cond_steps=3, Dz1=Dz1, steps=2)
    with both_deterministic(monkeypatch):
        jj, jmean, jtot = jbi.bimodal_joint_epoch(
            _jax(joint), _jax(m1), _jax(m2), KEY,
            *map(jnp.asarray, (Z1, Z2, V1, V2)), 0.04, 0.5, 1e-4,
            batch_size=B, metrics_every=metrics_every, shuffle=False, **kw)
        jj, jrem, jm = jbi.bimodal_batch_step(
            jj, _jax(m1), _jax(m2), KEY,
            *(jnp.asarray(a[2 * B:]) for a in (Z1, Z2, V1, V2)), 0.04, 0.5,
            1e-4, compute_metrics=(metrics_every == 1), **kw)
        tj, tsum, tcount, ttot = tbi.bimodal_epoch(
            _torch(joint), _torch(m1), _torch(m2), 0,
            *map(t, (Z1, Z2, V1, V2)), 0.04, 0.5, 1e-4, batch_size=B,
            metrics_every=metrics_every, **kw)
    for ts, js in zip(tj, jj):
        assert_states_close(ts, js, 1e-4)
    assert tcount == (0 if warmup else 3)
    close(tsum, 2 * float(jmean) + float(jrem), 1e-4)
    for a, b_jax, b_rem in zip(ttot, jtot, jm):
        close(a, float(b_jax) + float(b_rem), 1e-4)
    # metrics ran on batches 0 (and 1 and the remainder when every batch)
    assert float(ttot.n) == (n if metrics_every == 1 else B)


@pytest.mark.parametrize("direction", ["1to2", "2to1"])
def test_sample_cross(monkeypatch, direction):
    m1, m2, joint, z1, z2, _, _ = _bimodal(4)
    with both_deterministic(monkeypatch):
        want = jbi.sample_cross(jax_state(joint[0]), _jax(m1), _jax(m2), KEY,
                                jnp.asarray(z1), jnp.asarray(z2), steps=3,
                                Dz1=Dz1, direction=direction)
        got = tbi.sample_cross(torch_state(joint[0]), _torch(m1),
                               _torch(m2), 0, t(z1), t(z2), steps=3,
                               Dz1=Dz1, direction=direction)
    assert tuple(got.shape) == (B, D2 if direction == "1to2" else D1)
    close(got, want, 1e-5)
