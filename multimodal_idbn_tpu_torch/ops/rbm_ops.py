"""RBM operations over an explicit parameter state.

Port of multimodal_idbn_tpu/ops/rbm_ops.py: ``RBMState``, the
conditionals of both directions, ``free_energy``, ``gibbs_step``
(rbm_ops.py:95), the CD-k update in the exact order of rbm_ops.py:192-323,
the persistent-CD update and its fantasy particles (``pcd_update``,
``init_pcd_chains``, :326-397), the conditional chains (rbm_ops.py:403-577,
``conditional_gibbs_annealed`` among them) and the auxiliary clamped CD
(rbm_ops.py:584-664). ``lax.scan`` becomes a Python loop; keys are 64-bit
ints (``ops.rng``).

Precision variants, as in the JAX module: a state may be stored in
bfloat16 (``init_rbm_state(dtype=...)``); ``compute_cast`` (:173-189) runs
the Gibbs chain of an fp32 state on a bf16 copy of its weights
(``compute_dtype=``); ``stochastic_round`` (:145-170) rounds an fp32-exact
update into bf16 storage without bias (``sr=``; on by default for bf16
storage). Products follow JAX's type promotion (``_mm``): bf16 with bf16
stays bf16, bf16 with fp32 is computed in fp32, as ``jnp.matmul`` does.

The mean-field chains (``conditional_gibbs`` with
``sample_h=sample_v=False``, and ``noisy_meanfield_annealed``) run through
``ops.chain.clamped_chain``: the chain kernel on CUDA tensors, its plain
version on CPU tensors. A bf16-stored state enters it widened to fp32
(``_chain_params``), which is exact and is what JAX's jnp chain computes:
there the bf16 weights meet the fp32 chain state in fp32 products. The
stochastic-h/v variants of
``conditional_gibbs`` are a different function, which the chain kernel
does not compute, and stay plain torch here.

Groupless CD on the card goes through ``ops.fast_cd`` (the fused
half-step kernel); ``cd_update`` below is the generic update that the
joint RBM, which has a softmax group, uses.

Data parallelism: inside ``shard.batch_rows`` the updates sum their batch
statistics and loss over the data group before ``apply_update``
(``shard.reduce_update``), the draws are the single device's for the
rank's rows (``ops.rng``) and the chains launch as part of the whole batch.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from multimodal_idbn_tpu_torch.ops import chain, rng, schedules, shard
from multimodal_idbn_tpu_torch.ops.sampling import (SoftmaxGroups,
                                                    apply_softmax_groups,
                                                    clamp_mask,
                                                    sample_bernoulli,
                                                    sample_visible, sigmoid)


@dataclasses.dataclass
class RBMState:
    """Parameters and momentum buffers of one RBM (rbm_ops.py:36-44)."""

    w: torch.Tensor     # [V, H]
    hb: torch.Tensor    # [H]  hidden bias
    vb: torch.Tensor    # [V]  visible bias
    w_m: torch.Tensor   # momentum buffers, same shapes
    hb_m: torch.Tensor
    vb_m: torch.Tensor

    def replace(self, **changes) -> "RBMState":
        return dataclasses.replace(self, **changes)


def weights_only(state: RBMState) -> RBMState:
    """``state`` without its momentum buffers (None): what the inference
    calls read, so that a serving graph holds no copy of the momentum."""
    return RBMState(state.w, state.hb, state.vb, None, None, None)


def init_rbm_state(key: int, num_visible: int, num_hidden: int,
                   dtype: torch.dtype = torch.float32, device=None
                   ) -> RBMState:
    """W ~ N(0,1)/sqrt(max(1,V)); biases and momentum zero, every field
    stored in ``dtype`` (rbm_ops.py:47-56). W is drawn in fp32 on the CPU
    from ``key``, then cast and moved, so an initial state does not depend
    on the device."""
    w = torch.randn((num_visible, num_hidden),
                    generator=rng.generator(key, "cpu")) / math.sqrt(
                        max(1, num_visible))
    w = w.to(device=device, dtype=dtype)
    z_h = torch.zeros((num_hidden,), device=device, dtype=dtype)
    z_v = torch.zeros((num_visible,), device=device, dtype=dtype)
    return RBMState(w=w, hb=z_h, vb=z_v, w_m=torch.zeros_like(w),
                    hb_m=z_h.clone(), vb_m=z_v.clone())


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype JAX's promotion gives the pair (bf16 with
    bf16 stays bf16, bf16 with fp32 is fp32); torch's matmul promotes
    nothing."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.matmul(a, b, preferred_element_type=float32)``: bf16 operands
    widened exactly, products summed in fp32."""
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# Conditionals p(h|v), p(v|h)
# ---------------------------------------------------------------------------

def hidden_logits(state: RBMState, v: torch.Tensor, T=1.0) -> torch.Tensor:
    return (_mm(v, state.w) + state.hb) / max(1e-6, T)


def hidden_probs(state: RBMState, v: torch.Tensor, T=1.0) -> torch.Tensor:
    """p(h|v) = sigmoid((vW + b_h)/max(1e-6,T)) (rbm_ops.py:67-69)."""
    return sigmoid(hidden_logits(state, v, T))


def visible_logits(state: RBMState, h: torch.Tensor, T=1.0) -> torch.Tensor:
    """(h Wᵀ + b_v)/max(1e-6,T) (rbm_ops.py:72-74)."""
    return (_mm(h, state.w.T) + state.vb) / max(1e-6, T)


def visible_probs(state: RBMState, h: torch.Tensor, T=1.0,
                  groups: SoftmaxGroups = ()) -> torch.Tensor:
    """Sigmoid of the logits, softmax of the *logits* inside each group
    (rbm_ops.py:77-82)."""
    logits = visible_logits(state, h, T)
    return apply_softmax_groups(sigmoid(logits), logits, groups)


def free_energy(state: RBMState, v: torch.Tensor) -> torch.Tensor:
    """F(v) = −v·b_v − Σ_j softplus(b_h + vW)_j (rbm_ops.py:85-92)."""
    return -_mm(v, state.vb) - torch.nn.functional.softplus(
        state.hb + _mm(v, state.w)).sum(dim=1)


def gibbs_step(state: RBMState, key: int, v: torch.Tensor,
               sample_h: bool = True, sample_v: bool = True,
               groups: SoftmaxGroups = ()):
    """One v -> h -> v' Gibbs step; returns (v_next, v_prob, h, h_prob)
    (rbm_ops.py:95-105)."""
    h_prob = hidden_probs(state, v)
    h = sample_bernoulli(rng.fold_in(key, 0), h_prob) if sample_h else h_prob
    v_prob = visible_probs(state, h, groups=groups)
    v_next = sample_visible(rng.fold_in(key, 1), v_prob, groups) \
        if sample_v else v_prob
    return v_next, v_prob, h, h_prob


# ---------------------------------------------------------------------------
# CD-k training update (rbm_ops.py:112-142, :192-323)
# ---------------------------------------------------------------------------

def _negative_chain(state: RBMState, key: int, h0: torch.Tensor, cd: int,
                    groups: SoftmaxGroups):
    """h0 -> (v, v_prob, h_prob) over ``cd`` steps; per step
    v_prob -> v=sample -> h_prob -> h=sample (rbm_ops.py:112-142)."""
    h = h0
    v = v_prob = h_prob = None
    for st in range(cd):
        k = rng.fold_in(key, st)
        v_prob = visible_probs(state, h, groups=groups)
        v = sample_visible(rng.fold_in(k, 0), v_prob, groups)
        h_prob = hidden_probs(state, v)
        h = sample_bernoulli(rng.fold_in(k, 1), h_prob)
    return v, v_prob, h_prob


def stochastic_round_bits(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """bf16 of ``x`` rounded with the random low bits ``r`` (integers in
    [0, 2^16)): ``r`` is added to the fp32 bits, which are then truncated
    to the top 16, exactly the arithmetic of rbm_ops.py:166-170. The
    truncated fp32 is a bf16 value, so the final cast is exact."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    out = ((bits & 0xFFFFFFFF) + r.to(torch.int64)) & 0xFFFF0000
    out = torch.where(out >= 1 << 31, out - (1 << 32), out)
    return out.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def stochastic_round(key: rng.AnyKey, x: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Unbiased rounding of fp32 values into ``dtype`` (rbm_ops.py:145-170):
    16 uniform random bits below the bf16 mantissa cut are added and the
    result truncated, so ``E[stochastic_round(x)] == x`` for finite x.
    Nearest-rounded bf16 updates drop every increment below ~0.4% of the
    parameter, the measured quality collapse of bf16 storage
    (benchmarks/quality_bf16sr_r5.json). The bits are
    ``rng.random_bits16`` of ``key`` (Philox, as every draw of the port);
    the deterministic sampler mode leaves them real, as the ``det_random``
    fixture leaves ``jax.random.bits``. An fp32 target is the identity."""
    if dtype == torch.float32:
        return x.float()
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic_round supports bfloat16/float32 "
                         f"targets, got {dtype}")
    return stochastic_round_bits(x, rng.random_bits16(key, x.shape,
                                                      x.device))


def compute_cast(state: RBMState,
                 compute_dtype: Optional[torch.dtype] = None) -> RBMState:
    """Weights and biases cast once to a reduced compute dtype (mixed
    precision, rbm_ops.py:173-189); the momentum buffers are update-only
    and stay as they are. ``None`` or the state's own dtype returns the
    state itself."""
    if compute_dtype is None or state.w.dtype == compute_dtype:
        return state
    return state.replace(w=state.w.to(compute_dtype),
                         hb=state.hb.to(compute_dtype),
                         vb=state.vb.to(compute_dtype))


def _sr_on(state: RBMState, sr: Optional[bool]) -> bool:
    """The auto rule of rbm_ops.py:241: stochastic rounding on exactly
    when the state is stored in bf16, unless ``sr`` says otherwise."""
    return state.w.dtype == torch.bfloat16 if sr is None else bool(sr)


def _statistics(data, pos_h, v, h_prob, f32: bool):
    """(pos_assoc, neg_assoc, pos_h_sum, neg_h_sum, pos_h_mean, data_sum,
    v_sum) of a CD update; with ``f32`` the products and sums are taken in
    fp32 from the (possibly bf16) operands (rbm_ops.py:244-263)."""
    if f32:
        pos_h32 = pos_h.float()
        return (_mm_f32(data.T, pos_h), _mm_f32(v.T, h_prob),
                pos_h32.sum(0), h_prob.float().sum(0), pos_h32.mean(0),
                data.float().sum(0), v.float().sum(0))
    return (data.T @ pos_h, v.T @ h_prob, pos_h.sum(0), h_prob.sum(0),
            pos_h.mean(0), data.sum(0), v.sum(0))


def cd_update(state: RBMState, key: int, data: torch.Tensor, *, lr, mom,
              weight_decay, cd: int, sparsity: bool = False,
              sparsity_factor: float = 0.05, groups: SoftmaxGroups = (),
              compute_dtype: Optional[torch.dtype] = None,
              sr: Optional[bool] = None) -> Tuple[RBMState, torch.Tensor]:
    """One CD-k update on a batch; returns (new_state, mse loss).

    Reference order (rbm_ops.py:192-266): positive statistics from the
    probabilities, a sampled chain start, ``neg_assoc = v_sampledᵀ·h_prob``,
    momentum then apply, sparsity into ``hb_m``. The chain runs in the
    state's dtype, or on ``compute_cast(state, compute_dtype)``; with
    mixed precision or stochastic rounding the statistics are fp32. The
    loss is fp32 whatever the storage.
    """
    if int(cd) < 1:
        raise ValueError(f"cd_update requires CD >= 1, got {cd}")
    k_pos, k_neg = rng.fold_in(key, 0), rng.fold_in(key, 1)
    mixed = compute_dtype is not None
    sr_on = _sr_on(state, sr)
    cstate = compute_cast(state, compute_dtype) if mixed else state
    data = data.to(cstate.w.dtype)
    pos_h = hidden_probs(cstate, data)
    h0 = sample_bernoulli(k_pos, pos_h)
    v, v_prob, h_prob = _negative_chain(cstate, k_neg, h0, int(cd), groups)
    stats, loss, bsz = shard.reduce_update(
        _statistics(data, pos_h, v, h_prob, mixed or sr_on),
        torch.mean(torch.square((data - v_prob).float())), data.shape[0])
    new_state = apply_update(
        state, *stats, lr=lr, mom=mom, weight_decay=weight_decay, bsz=bsz,
        sparsity=sparsity, sparsity_factor=sparsity_factor, key=key,
        sr_on=sr_on)
    return new_state, loss


def apply_update(state: RBMState, pos_assoc, neg_assoc, pos_h_sum,
                 neg_h_sum, pos_h_mean, data_sum, v_sum, *, lr, mom,
                 weight_decay, bsz, sparsity: bool, sparsity_factor: float,
                 key: Optional[int] = None, sr_on: bool = False
                 ) -> RBMState:
    """Momentum-buffer-then-apply update (rbm_ops.py:269-323), shared by
    ``cd_update``, ``pcd_update``, ``fast_cd`` and ``clamped_cd_update``.

    ``sr_on``: the update is computed exactly in fp32, then each stored
    array is rounded once by ``stochastic_round``, keyed
    ``fold_in(fold_in(key, 13), i)``, a child the chain keys never reach.
    Off: the update runs in the promoted dtype of its operands and each
    field is cast back to the storage dtype, as the reference does in
    fp32 (for fp32 storage the casts are no-ops); a Python scalar meets a
    bf16 operand rounded to bf16 (``_weak``), as in JAX."""
    dt = state.w.dtype
    if sr_on:
        f = [getattr(state, n).float() for n in ("w", "hb", "vb", "w_m",
                                                 "hb_m", "vb_m")]
        w_m = mom * f[3] + lr * ((pos_assoc - neg_assoc) / bsz
                                 - weight_decay * f[0])
        hb_m = mom * f[4] + lr * (pos_h_sum - neg_h_sum) / bsz
        if sparsity:
            hb_m = hb_m + (-lr * (pos_h_mean - sparsity_factor))
        vb_m = mom * f[5] + lr * (data_sum - v_sum) / bsz
        ks = rng.fold_in(key, 13)
        return RBMState(*(stochastic_round(rng.fold_in(ks, i), x, dt)
                          for i, x in enumerate((f[0] + w_m, f[1] + hb_m,
                                                 f[2] + vb_m, w_m, hb_m,
                                                 vb_m))))
    wd = _weak(weight_decay, state.w)
    w_step = (pos_assoc - neg_assoc) / bsz - wd * state.w
    w_m = (_weak(mom, state.w_m) * state.w_m
           + _weak(lr, w_step) * w_step).to(dt)
    w = (state.w + w_m).to(dt)
    h_step = pos_h_sum - neg_h_sum
    hb_m = (_weak(mom, state.hb_m) * state.hb_m
            + _weak(lr, h_step) * h_step / bsz)
    if sparsity:
        h_dev = pos_h_mean - _weak(sparsity_factor, pos_h_mean)
        hb_m = hb_m + (_weak(-lr, h_dev) * h_dev)
    hb_m = hb_m.to(dt)
    hb = (state.hb + hb_m).to(dt)
    v_step = data_sum - v_sum
    vb_m = (_weak(mom, state.vb_m) * state.vb_m
            + _weak(lr, v_step) * v_step / bsz).to(dt)
    vb = (state.vb + vb_m).to(dt)
    return RBMState(w, hb, vb, w_m, hb_m, vb_m)


def _weak(x, t: torch.Tensor):
    """The scalar ``x`` (a Python float, or a 0-d float64 tensor of an
    epoch body's schedule) as it meets ``t`` in JAX: a weakly typed scalar
    takes the array's dtype, so it is rounded to bf16 before a bf16
    product; torch keeps it at fp32 and rounds only the result."""
    if t.dtype == torch.float32:
        return x
    if isinstance(x, torch.Tensor):
        return x.to(t.dtype)
    if t.dtype != torch.bfloat16:
        raise ValueError(f"no weak scalar rule for {t.dtype}")
    return _round_bf16(float(x))


def _round_bf16(x: float) -> float:
    """``x`` rounded as torch rounds a Python float into bf16 (to fp32,
    then to the nearest bf16, ties to even), on the host and without a
    tensor."""
    b = int(np.float32(x).view(np.uint32))
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return float(np.uint32(b).view(np.float32))


def pcd_update(state: RBMState, chain_v: torch.Tensor, key: int,
               data: torch.Tensor, *, lr, mom, weight_decay, cd: int,
               sparsity: bool = False, sparsity_factor: float = 0.05,
               groups: SoftmaxGroups = (),
               compute_dtype: Optional[torch.dtype] = None,
               sr: Optional[bool] = None
               ) -> Tuple[RBMState, torch.Tensor, torch.Tensor]:
    """Persistent-CD update (Tieleman 2008; rbm_ops.py:326-388): the
    negative chain continues from the fantasy particles ``chain_v``
    instead of restarting at the data. Returns (new_state, new_chain_v,
    loss). Keys: ``fold_in(key, 0)`` samples the data's h0,
    ``fold_in(key, 1)`` lifts the particles to h, ``fold_in(key, 2)`` runs
    the chain. Positive statistics, update order and momentum are those of
    ``cd_update``; the loss is the one-step reconstruction from h0, the
    quantity CD-1 reports. The new particles are the chain's last sampled
    v in the state's dtype. The port's fp32 image stacks run this update
    through the half-step kernel (``fast_cd.fast_sampled_pcd_update``)."""
    if int(cd) < 1:
        raise ValueError(f"pcd_update requires CD >= 1, got {cd}")
    k_pos, k_chain, k_neg = (rng.fold_in(key, i) for i in range(3))
    mixed = compute_dtype is not None
    sr_on = _sr_on(state, sr)
    cstate = compute_cast(state, compute_dtype) if mixed else state
    data = data.to(cstate.w.dtype)
    chain_v = chain_v.to(cstate.w.dtype)
    pos_h = hidden_probs(cstate, data)
    h0 = sample_bernoulli(k_pos, pos_h)
    h_chain = sample_bernoulli(k_chain, hidden_probs(cstate, chain_v))
    v, _, h_prob = _negative_chain(cstate, k_neg, h_chain, int(cd), groups)
    v_recon = visible_probs(cstate, h0, groups=groups)
    stats, loss, bsz = shard.reduce_update(
        _statistics(data, pos_h, v, h_prob, mixed or sr_on),
        torch.mean(torch.square((data - v_recon).float())), data.shape[0])
    new_state = apply_update(
        state, *stats, lr=lr, mom=mom, weight_decay=weight_decay, bsz=bsz,
        sparsity=sparsity, sparsity_factor=sparsity_factor, key=key,
        sr_on=sr_on)
    return new_state, v.to(state.w.dtype), loss


def init_pcd_chains(key: int, batch_size: int, num_visible: int,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """Fantasy particles U(0,1)-thresholded at 0.5, the standard PCD start
    (rbm_ops.py:391-397). Drawn on the CPU from ``key`` and moved, so the
    start does not depend on the device; all 0 in the deterministic
    sampler mode, as JAX's under ``det_random``."""
    u = rng.uniform(key, (batch_size, num_visible), "cpu")
    return (u > 0.5).to(dtype).to(device)


# ---------------------------------------------------------------------------
# Conditional samplers (rbm_ops.py:403-434, :522-577)
# ---------------------------------------------------------------------------

def _chain_init(key: int, v_known: torch.Tensor,
                known_mask: torch.Tensor) -> torch.Tensor:
    """Unknown coordinates U(0,1), known ones clamped (rbm_ops.py:413-416)."""
    u = rng.uniform(key, v_known.shape, v_known.device)
    return v_known * known_mask + (1.0 - known_mask) * u


def _chain_params(state: RBMState):
    """(w, hb, vb) for the chain kernel, which takes fp32. A bf16-stored
    state is widened, exactly: JAX's jnp chain promotes it to meet the
    fp32 chain state (``_chain_init`` draws fp32), so the kernel computes
    the same function on it."""
    return tuple(x.float() for x in (state.w, state.hb, state.vb))


def conditional_gibbs(state: RBMState, key: int, v_known: torch.Tensor,
                      known_mask: torch.Tensor, *, n_steps: int = 30,
                      sample_h: bool = False, sample_v: bool = False,
                      groups: SoftmaxGroups = ()) -> torch.Tensor:
    """Conditional Gibbs / mean-field chain (rbm_ops.py:403-434).

    Known coordinates are re-clamped every step. Returns
    ``visible_probs(hidden_probs(v))``: the reference's final mean-field
    pass, which is NOT re-clamped (rbm_ops.py:434).
    """
    v = _chain_init(rng.fold_in(key, 0), v_known, known_mask)
    n_steps = int(n_steps)
    if not sample_h and not sample_v:
        sched = _meanfield_schedule_on(v.device, max(0, n_steps))
        row0, total = shard.kernel_rows(v.shape[0])
        return chain.clamped_chain(*_chain_params(state), v, v_known,
                                   known_mask, sched, groups=groups,
                                   final_unclamped=True, row0=row0,
                                   plan_rows=total)
    kloop = rng.fold_in(key, 1)
    for t in range(n_steps):
        k = rng.fold_in(kloop, t)
        h_prob = hidden_probs(state, v)
        h = sample_bernoulli(rng.fold_in(k, 0), h_prob) if sample_h \
            else h_prob
        v = clamp_mask(visible_probs(state, h, groups=groups), v_known,
                       known_mask)
        if sample_v:
            v = clamp_mask(sample_visible(rng.fold_in(k, 1), v, groups),
                           v_known, known_mask)
    return visible_probs(state, hidden_probs(state, v), groups=groups)


def sampled_conditional_chain(state: RBMState, key: int,
                              v_known: torch.Tensor,
                              known_mask: torch.Tensor, *, n_steps: int,
                              groups: SoftmaxGroups = ()) -> torch.Tensor:
    """Fully sampled clamped Gibbs chain (rbm_ops.py:437-473): h and v are
    sampled every step (groups categorically), the known coordinates
    re-clamped, and the last sampled v returned, with no mean-field pass.
    Unknown coordinates start U(0,1). Plain torch, as in the JAX package.
    """
    if int(n_steps) < 1:
        raise ValueError("sampled_conditional_chain needs n_steps >= 1 "
                         "(with 0 steps the output would be decoded "
                         "uniform noise, independent of the clamp)")
    v = _chain_init(rng.fold_in(key, 0), v_known, known_mask)
    kloop = rng.fold_in(key, 1)
    for t in range(int(n_steps)):
        k = rng.fold_in(kloop, t)
        h = sample_bernoulli(rng.fold_in(k, 0), hidden_probs(state, v))
        v_prob = visible_probs(state, h, groups=groups)
        v = clamp_mask(sample_visible(rng.fold_in(k, 1), v_prob, groups),
                       v_known, known_mask)
    return v


def conditional_gibbs_annealed(state: RBMState, key: int,
                               v_known: torch.Tensor,
                               known_mask: torch.Tensor, *,
                               n_steps: int = 40, T0: float = 2.5,
                               T1: float = 1.0, sample_h_until: int = 20,
                               sample_v_every: int = 0,
                               final_meanfield: bool = True,
                               groups: SoftmaxGroups = ()) -> torch.Tensor:
    """Annealed conditional Gibbs (rbm_ops.py:475-519): linear T0→T1 with
    the last 3 steps sharpened to min(0.9, T); h sampled while
    ``t < sample_h_until``; v sampled on every ``sample_v_every``-th hot
    step; an optional final T=1 mean-field pass, re-clamped. Plain torch,
    as in the JAX package: the chain kernel computes the mean-field
    family only."""
    n_steps = int(n_steps)
    v = _chain_init(rng.fold_in(key, 0), v_known, known_mask)
    hot = int(max(0, min(n_steps, sample_h_until)))
    temps = schedules.gibbs_annealed_temperature(n_steps, T0, T1).tolist()
    kloop = rng.fold_in(key, 1)
    for t, T in enumerate(temps):
        k = rng.fold_in(kloop, t)
        h = hidden_probs(state, v, T)
        if t < hot:
            h = sample_bernoulli(rng.fold_in(k, 0), h)
        v_new = visible_probs(state, h, T, groups=groups)
        if sample_v_every > 0 and t < hot and t % sample_v_every == 0:
            v_new = sample_visible(rng.fold_in(k, 1), v_new, groups)
        v = clamp_mask(v_new, v_known, known_mask)
    if final_meanfield:
        v = clamp_mask(visible_probs(state, hidden_probs(state, v),
                                     groups=groups), v_known, known_mask)
    return v


def annealed_schedule(n_steps: int, T0, T1, sigma0, sharpen_last: int,
                      T_cold_plus, eta0) -> torch.Tensor:
    """[n, 3] float32 rows (1/max(1e-6,T_t), σ_t, η_t) of the noisy
    annealed chain, the reciprocals the chain kernel reads
    (pallas_chain.py:236-242)."""
    T = schedules.annealed_temperature(n_steps, T0, T1, sharpen_last,
                                       T_cold_plus)
    return torch.stack([1.0 / torch.clamp(T, min=1e-6),
                        schedules.noise_sigma(n_steps, sigma0),
                        schedules.mu_pull_eta(n_steps, eta0)], dim=1)


@functools.lru_cache(maxsize=64)
def _meanfield_schedule_on(device: torch.device, n_steps: int
                           ) -> torch.Tensor:
    """[n, 3] rows (1, 0, 0) of the plain mean-field chain on ``device``.
    Cached, so a chain launch copies no schedule from the host."""
    return torch.tensor([[1.0, 0.0, 0.0]]).repeat(n_steps, 1).to(device)


@functools.lru_cache(maxsize=64)
def _annealed_schedule_on(device: torch.device, n_steps: int, T0, T1,
                          sigma0, sharpen_last: int, T_cold_plus, eta0
                          ) -> torch.Tensor:
    """``annealed_schedule`` on ``device``, built and copied there once
    per distinct argument tuple (a run has a handful)."""
    return annealed_schedule(n_steps, T0, T1, sigma0, sharpen_last,
                             T_cold_plus, eta0).to(device)


def noisy_meanfield_annealed(state: RBMState, key: int,
                             v_known: torch.Tensor,
                             known_mask: torch.Tensor, *,
                             n_steps: int = 72, T0: float = 3.0,
                             T1: float = 1.0, sigma0: float = 0.9,
                             hot_frac: float = 0.7, sharpen_last: int = 3,
                             T_cold_plus: float = 0.9,
                             mu_k: Optional[torch.Tensor] = None,
                             eta0: float = 0.15,
                             groups: SoftmaxGroups = ()) -> torch.Tensor:
    """Noisy mean-field annealing with optional μ-pull (rbm_ops.py:522-577).

    σ_t noise on BOTH the h- and v-logits; softmax groups on the noisy
    v-logits; μ-pull on the first ``mu_k.shape[1]`` coordinates.
    ``hot_frac`` is accepted and unused, as in the reference
    (rbm_ops.py:541). ``n_steps <= 0`` returns the clamped init.
    """
    del hot_frac
    v = _chain_init(rng.fold_in(key, 0), v_known, known_mask)
    n_steps = int(n_steps)
    if n_steps <= 0:
        return v
    sched = _annealed_schedule_on(v.device, n_steps, T0, T1, sigma0,
                                  sharpen_last, T_cold_plus, eta0)
    seed = rng.fold_in(key, 1) if sigma0 > 0 else None
    row0, total = shard.kernel_rows(v.shape[0])
    return chain.clamped_chain(*_chain_params(state), v, v_known,
                               known_mask, sched, groups=groups, mu=mu_k,
                               seed=seed, final_unclamped=False, row0=row0,
                               plan_rows=total)


# ---------------------------------------------------------------------------
# Auxiliary clamped CD (rbm_ops.py:584-664)
# ---------------------------------------------------------------------------

def clamped_cd_update(state: RBMState, key: int, v_known: torch.Tensor,
                      known_mask: torch.Tensor, *, lr, mom, weight_decay,
                      cd: int = 1, cond_init_steps: int = 50,
                      sample_h: bool = True, sample_v: bool = False,
                      reclamp_negative: bool = True,
                      aux_lr_mult: float = 0.3, use_noisy_init: bool = True,
                      mu_k: Optional[torch.Tensor] = None,
                      eta0: float = 0.15,
                      groups: SoftmaxGroups = (),
                      sr: Optional[bool] = None
                      ) -> Tuple[RBMState, torch.Tensor]:
    """Auxiliary clamped-CD update (rbm_ops.py:584-664).

    The positive state comes from conditional inference (noisy mean-field
    with the reference's hard-coded constants by default, at least 10
    steps); the negative chain starts from it; the update is scaled by
    ``aux_lr_mult`` with weight decay inside the scaled bracket. ``sr``
    follows the rule of ``cd_update``: with stochastic rounding the
    statistics are fp32 and the update is rounded once per stored array.
    """
    k_init, k_neg = rng.fold_in(key, 0), rng.fold_in(key, 1)
    if use_noisy_init:
        v_plus = noisy_meanfield_annealed(
            state, k_init, v_known, known_mask,
            n_steps=max(10, int(cond_init_steps)), T0=3.0, T1=1.0,
            sigma0=0.9, hot_frac=0.7, sharpen_last=2, T_cold_plus=0.9,
            mu_k=mu_k, eta0=eta0, groups=groups)
    else:
        v_plus = conditional_gibbs(
            state, k_init, v_known, known_mask,
            n_steps=int(cond_init_steps), sample_h=sample_h,
            sample_v=sample_v, groups=groups)
    h_plus = hidden_probs(state, v_plus)

    v_neg = v_plus
    for t in range(int(cd)):
        k = rng.fold_in(k_neg, t)
        h_prob = hidden_probs(state, v_neg)
        h = sample_bernoulli(rng.fold_in(k, 0), h_prob) if sample_h \
            else h_prob
        v_prob = visible_probs(state, h, groups=groups)
        v_neg = clamp_mask(v_prob, v_known, known_mask) if reclamp_negative \
            else v_prob
        if sample_v:  # NOT re-clamped (rbm_ops.py:637)
            v_neg = sample_visible(rng.fold_in(k, 1), v_neg, groups)
    h_neg = hidden_probs(state, v_neg)

    sr_on = _sr_on(state, sr)
    if sr_on:
        stats = (_mm_f32(v_plus.T, h_plus), _mm_f32(v_neg.T, h_neg),
                 h_plus.float().sum(0), h_neg.float().sum(0), None,
                 v_plus.float().sum(0), v_neg.float().sum(0))
    else:
        stats = (v_plus.T @ h_plus, v_neg.T @ h_neg, h_plus.sum(0),
                 h_neg.sum(0), None, v_plus.sum(0), v_neg.sum(0))
    stats, loss, bsz = shard.reduce_update(
        stats, torch.mean(torch.square((v_plus - v_neg).float())),
        v_known.shape[0])
    new_state = apply_update(
        state, *stats, lr=aux_lr_mult * lr, mom=mom,
        weight_decay=weight_decay, bsz=bsz, sparsity=False,
        sparsity_factor=0.0, key=key, sr_on=sr_on)
    return new_state, loss
