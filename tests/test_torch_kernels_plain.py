"""The plain versions of the port's two kernels, held against the JAX
package, and the Philox generator the kernels share with them.

- ``chain.chain_plain`` against JAX ``pallas_chain._chain_call`` run in
  interpret mode, as tests/test_pallas_chain.py runs it (noiseless family,
  same v_init on both sides), atol 1e-4 (whole chains);
- ``half_step.half_step_plain`` against ``pallas_kernels.reference_half_step``
  (atol 1e-5), and ``fast_cd`` against JAX ``rbm_ops.cd_update`` with both
  sides in their deterministic sampler mode (atol 1e-4);
- Philox4x32-10 against the known-answer vectors of Random123.

On CPU tensors the wrappers run the plain versions; the kernels themselves
are held against these on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("jax.experimental.pallas")

from multimodal_idbn_tpu.ops import pallas_chain as jchain  # noqa: E402
from multimodal_idbn_tpu.ops import pallas_kernels as jkernels  # noqa: E402
from multimodal_idbn_tpu.ops import rbm_ops as jrbm  # noqa: E402
from multimodal_idbn_tpu_torch.ops import chain, fast_cd, half_step  # noqa
from multimodal_idbn_tpu_torch.ops import rbm_ops as trbm  # noqa: E402
from multimodal_idbn_tpu_torch.ops import rng  # noqa: E402

from torch_parity import (assert_states_close, both_deterministic,  # noqa
                          close, jax_state, np_state, t, torch_state)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

Dz, K, H, B = 24, 4, 16, 8
V = Dz + K


def _interpret(fn, *args, **kw):
    """Run a Pallas call in interpret mode on the CPU test mesh."""
    from jax.experimental import pallas as pl_mod
    orig = pl_mod.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    pl_mod.pallas_call = patched
    try:
        return fn(*args, **kw)
    finally:
        pl_mod.pallas_call = orig


@pytest.mark.parametrize("n_steps,groups", [
    (12, ((Dz, V),)), (5, ()), (6, ((16, 20), (20, 28))), (0, ((Dz, V),))])
def test_chain_plain_vs_jax_chain_kernel(n_steps, groups):
    rs = np.random.RandomState(n_steps)
    f = np_state(rs, V, H)
    v_known = np.concatenate([rs.rand(B, Dz), np.zeros((B, K))],
                             1).astype(np.float32)
    km = np.concatenate([np.ones((B, Dz)), np.zeros((B, K))],
                        1).astype(np.float32)
    v_init = (v_known * km + (1 - km) * rs.rand(B, V)).astype(np.float32)
    dz = groups[0][0] if groups else V
    jout = _interpret(
        jchain._chain_call, jnp.asarray([0], jnp.int32),
        jnp.ones((max(1, n_steps), 4), jnp.float32), jnp.asarray(f["w"]),
        jnp.asarray(f["hb"]).reshape(1, -1),
        jnp.asarray(f["vb"]).reshape(1, -1), jnp.asarray(v_known),
        jnp.asarray(km), jnp.asarray(v_init),
        jnp.zeros((B, dz), jnp.float32), n_steps=n_steps, groups=groups,
        noisy=False, use_mu=False, final_unclamped=True, Dz=dz)
    sched = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n_steps, 1)
    tout = chain.clamped_chain(t(f["w"]), t(f["hb"]), t(f["vb"]), t(v_init),
                               t(v_known), t(km), sched, groups=groups,
                               final_unclamped=True)
    close(tout, jout, 1e-4)
    for s, e in groups:
        close(tout[:, s:e].sum(1), np.ones(B), 1e-5)


def test_chain_plain_noise_follows_philox():
    """With a seed, chain_plain adds σ_t·philox_normal(row, col, t, half):
    one step by hand."""
    rs = np.random.RandomState(1)
    f = {k: t(v) for k, v in np_state(rs, V, H).items()}
    vk = t(np.concatenate([np.zeros((B, Dz)), np.eye(K)[rs.randint(0, K, B)]],
                          1))
    km = t(np.concatenate([np.zeros((B, Dz)), np.ones((B, K))], 1))
    v0 = vk * km + (1 - km) * t(rs.rand(B, V))
    sched = torch.tensor([[0.5, 0.7, 0.2]])
    mu = t(rs.rand(B, Dz))
    out = chain.chain_plain(f["w"], f["hb"], f["vb"], v0, vk, km, sched,
                            groups=((Dz, V),), mu=mu, seed=99)
    h = torch.sigmoid((v0 @ f["w"] + f["hb"]) * 0.5
                      + rng.philox_normal(99, B, H, step=0, stream=0) * 0.7)
    lv = (h @ f["w"].T + f["vb"]) * 0.5 + rng.philox_normal(
        99, B, V, step=0, stream=1) * 0.7
    p = torch.sigmoid(lv)
    p[:, Dz:] = torch.softmax(lv[:, Dz:], 1)
    p[:, :Dz] = 0.8 * p[:, :Dz] + 0.2 * mu
    close(out, p * (1 - km) + vk * km, 1e-6)


def test_chain_rejects_bad_operands():
    w = torch.zeros(V, H)
    args = (w, torch.zeros(H), torch.zeros(V), torch.zeros(B, V),
            torch.zeros(B, V), torch.zeros(B, V))
    with pytest.raises(ValueError):
        chain.clamped_chain(*args, torch.zeros(3, 2))
    with pytest.raises(ValueError):
        chain.clamped_chain(*args, torch.zeros(3, 3), groups=((20, 40),))
    with pytest.raises(ValueError):
        chain.clamped_chain(w, torch.zeros(H + 1), *args[2:],
                            torch.zeros(3, 3))


@pytest.mark.parametrize("Bx,K_,N,transpose,T", [
    (8, 40, 24, False, 1.0), (13, 30, 50, True, 1.0), (5, 64, 9, False, 0.7)])
def test_half_step_plain_vs_reference(Bx, K_, N, transpose, T):
    rs = np.random.RandomState(Bx)
    w = (rs.randn(N, K_) if transpose else rs.randn(K_, N)).astype(
        np.float32) / np.sqrt(K_)
    b = (0.1 * rs.randn(N)).astype(np.float32)
    x = (rs.rand(Bx, K_) > 0.5).astype(np.float32)
    probs, sample = half_step.half_step_sample(t(x), t(w), t(b), seed=5, T=T,
                                               transpose_w=transpose)
    ref = jkernels.reference_half_step(
        jnp.asarray(x), jnp.asarray(w.T if transpose else w),
        jnp.asarray(b), T)
    close(probs, ref, 1e-5)
    u = rng.philox_uniform(5, Bx, N)
    assert torch.equal(sample, (probs > u).float())


@pytest.mark.parametrize("Bx,V,H,T", [(37, 77, 130, 1.0), (1, 1, 1, 0.5),
                                      (129, 513, 65, 1.0)])
def test_half_step_sample_big_plain_vs_reference(Bx, V, H, T):
    """JAX's standalone wrapper (pallas_kernels.py:311) at ragged shapes,
    unpadded: probabilities as the fp32 reference (the TPU kernel's were
    bf16-operand products, a difference by design), the sample as Philox."""
    rs = np.random.RandomState(V)
    w = (rs.randn(V, H) / np.sqrt(V)).astype(np.float32)
    b = (0.1 * rs.randn(H)).astype(np.float32)
    v = (rs.rand(Bx, V) > 0.5).astype(np.float32)
    probs, sample = half_step.half_step_sample_big(t(v), t(w), t(b), 9, T)
    close(probs, jkernels.reference_half_step(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(b), T), 1e-5)
    assert probs.shape == sample.shape == (Bx, H)
    for a, c in zip((probs, sample), half_step.half_step_sample_big_plain(
            t(v), t(w), t(b), 9, T)):
        assert torch.equal(a, c)
    assert torch.equal(sample, (probs > rng.philox_uniform(9, Bx, H)).float())


def test_half_step_rejects_bad_shapes():
    with pytest.raises(ValueError):
        half_step.half_step_sample(torch.zeros(4, 5), torch.zeros(6, 3),
                                   torch.zeros(3), 0)
    with pytest.raises(ValueError):
        half_step.half_step_sample(torch.zeros(4, 5), torch.zeros(5, 3),
                                   torch.zeros(4), 0)


@pytest.mark.parametrize("cd,sparsity", [(1, False), (4, True)])
def test_fast_cd_vs_jax_cd_update(monkeypatch, cd, sparsity):
    rs = np.random.RandomState(cd)
    f = np_state(rs, 30, 14, momentum=True)
    x = (rs.rand(B, 30) > 0.6).astype(np.float32)
    kw = dict(lr=0.1, mom=0.5, weight_decay=1e-4, cd=cd, sparsity=sparsity,
              sparsity_factor=0.1)
    with both_deterministic(monkeypatch):
        jnew, jloss = jrbm.cd_update(jax_state(f), jax.random.key(0),
                                     jnp.asarray(x), groups=(), **kw)
        tnew, tloss = fast_cd.fast_sampled_cd_update(torch_state(f), 0, t(x),
                                                     **kw)
        tgen, _ = trbm.cd_update(torch_state(f), 0, t(x), groups=(), **kw)
    assert_states_close(tnew, jnew, 1e-4)
    assert_states_close(tnew, tgen, 1e-5)
    close(tloss, jloss, 1e-5)


def test_fast_cd_real_draws_follow_seeds():
    rs = np.random.RandomState(3)
    st = torch_state(np_state(rs, 30, 14))
    x = t(rs.rand(B, 30) > 0.6)
    kw = dict(lr=0.1, mom=0.5, weight_decay=1e-4, cd=2)
    a, _ = fast_cd.fast_sampled_cd_update(st, 1, x, **kw)
    b, _ = fast_cd.fast_sampled_cd_update(st, 1, x, **kw)
    c, _ = fast_cd.fast_sampled_cd_update(st, 2, x, **kw)
    assert torch.equal(a.w, b.w) and not torch.equal(a.w, c.w)
    with pytest.raises(ValueError):
        fast_cd.fast_sampled_cd_update(st, 1, x, lr=0.1, mom=0.5,
                                       weight_decay=0.0, cd=0)


@pytest.mark.parametrize("counter,key,expected", [
    ((0, 0, 0, 0), 0, (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, 0xffffffffffffffff,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0x299f31d0 << 32) | 0xa4093822,
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, expected):
    out = rng.philox4x32([torch.tensor(c) for c in counter], key)
    assert tuple(int(o) for o in out) == expected


def test_philox_uniform_and_normal():
    u = rng.philox_uniform(7, 300, 200, step=3, stream=1)
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0
    assert float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.01
    assert torch.equal(u * 2 ** 24, torch.floor(u * 2 ** 24))  # 24-bit grid
    assert not torch.equal(u, rng.philox_uniform(7, 300, 200, step=4,
                                                 stream=1))
    # the value at (r, c) does not depend on the grid it is drawn in
    assert torch.equal(u[:10, :20], rng.philox_uniform(7, 10, 20, step=3,
                                                       stream=1))
    n = rng.philox_normal(7, 300, 200, step=0, stream=0)
    assert abs(float(n.mean())) < 0.02 and abs(float(n.std()) - 1) < 0.02
    with rng.deterministic():
        assert float(rng.philox_uniform(7, 2, 2).max()) == 0.5
        assert float(rng.philox_normal(7, 2, 2).abs().max()) == 0.0
    assert not rng.is_deterministic()
