"""RBM operations over an explicit parameter state (fp32).

Port of multimodal_idbn_tpu/ops/rbm_ops.py: ``RBMState``, the
conditionals of both directions, ``free_energy``, ``gibbs_step``
(rbm_ops.py:95), the CD-k update in the exact order of rbm_ops.py:192-323,
the conditional chains (rbm_ops.py:403-577, ``conditional_gibbs_annealed``
among them) and the auxiliary clamped CD
(rbm_ops.py:584-664). ``lax.scan`` becomes a Python loop; keys are 64-bit
ints (``ops.rng``). The bf16, stochastic-rounding and ``compute_cast``
paths of the JAX module are not ported.

The mean-field chains (``conditional_gibbs`` with
``sample_h=sample_v=False``, and ``noisy_meanfield_annealed``) run through
``ops.chain.clamped_chain``: the chain kernel on CUDA tensors, its plain
version on CPU tensors. The stochastic-h/v variants of
``conditional_gibbs`` are a different function, which the chain kernel
does not compute, and stay plain torch here.

Groupless CD on the card goes through ``ops.fast_cd`` (the fused
half-step kernel); ``cd_update`` below is the generic update that the
joint RBM, which has a softmax group, uses.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from multimodal_idbn_tpu_torch.ops import chain, rng, schedules
from multimodal_idbn_tpu_torch.ops.sampling import (SoftmaxGroups,
                                                    apply_softmax_groups,
                                                    clamp_mask,
                                                    sample_bernoulli,
                                                    sample_visible)


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


def init_rbm_state(key: int, num_visible: int, num_hidden: int,
                   device=None) -> RBMState:
    """W ~ N(0,1)/sqrt(max(1,V)); biases and momentum zero
    (rbm_ops.py:47-56). W is drawn on the CPU from ``key`` and moved, so
    an initial state does not depend on the device."""
    w = torch.randn((num_visible, num_hidden),
                    generator=rng.generator(key, "cpu")) / math.sqrt(
                        max(1, num_visible))
    w = w.to(device)
    z_h = torch.zeros((num_hidden,), device=device)
    z_v = torch.zeros((num_visible,), device=device)
    return RBMState(w=w, hb=z_h, vb=z_v, w_m=torch.zeros_like(w),
                    hb_m=z_h.clone(), vb_m=z_v.clone())


# ---------------------------------------------------------------------------
# Conditionals p(h|v), p(v|h)
# ---------------------------------------------------------------------------

def hidden_logits(state: RBMState, v: torch.Tensor, T=1.0) -> torch.Tensor:
    return (v @ state.w + state.hb) / max(1e-6, T)


def hidden_probs(state: RBMState, v: torch.Tensor, T=1.0) -> torch.Tensor:
    """p(h|v) = sigmoid((vW + b_h)/max(1e-6,T)) (rbm_ops.py:67-69)."""
    return torch.sigmoid(hidden_logits(state, v, T))


def visible_logits(state: RBMState, h: torch.Tensor, T=1.0) -> torch.Tensor:
    """(h Wᵀ + b_v)/max(1e-6,T) (rbm_ops.py:72-74)."""
    return (h @ state.w.T + state.vb) / max(1e-6, T)


def visible_probs(state: RBMState, h: torch.Tensor, T=1.0,
                  groups: SoftmaxGroups = ()) -> torch.Tensor:
    """Sigmoid of the logits, softmax of the *logits* inside each group
    (rbm_ops.py:77-82)."""
    logits = visible_logits(state, h, T)
    return apply_softmax_groups(torch.sigmoid(logits), logits, groups)


def free_energy(state: RBMState, v: torch.Tensor) -> torch.Tensor:
    """F(v) = −v·b_v − Σ_j softplus(b_h + vW)_j (rbm_ops.py:85-92)."""
    return -(v @ state.vb) - torch.nn.functional.softplus(
        state.hb + v @ state.w).sum(dim=1)


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


def cd_update(state: RBMState, key: int, data: torch.Tensor, *, lr, mom,
              weight_decay, cd: int, sparsity: bool = False,
              sparsity_factor: float = 0.05,
              groups: SoftmaxGroups = ()) -> Tuple[RBMState, torch.Tensor]:
    """One CD-k update on a batch; returns (new_state, mse loss).

    Reference order (rbm_ops.py:192-266): positive statistics from the
    probabilities, a sampled chain start, ``neg_assoc = v_sampledᵀ·h_prob``,
    momentum then apply, sparsity into ``hb_m``.
    """
    if int(cd) < 1:
        raise ValueError(f"cd_update requires CD >= 1, got {cd}")
    k_pos, k_neg = rng.fold_in(key, 0), rng.fold_in(key, 1)
    pos_h = hidden_probs(state, data)
    h0 = sample_bernoulli(k_pos, pos_h)
    v, v_prob, h_prob = _negative_chain(state, k_neg, h0, int(cd), groups)
    loss = torch.mean(torch.square(data - v_prob))
    new_state = apply_update(
        state, data.T @ pos_h, v.T @ h_prob, pos_h.sum(0), h_prob.sum(0),
        pos_h.mean(0), data.sum(0), v.sum(0), lr=lr, mom=mom,
        weight_decay=weight_decay, bsz=data.shape[0], sparsity=sparsity,
        sparsity_factor=sparsity_factor)
    return new_state, loss


def apply_update(state: RBMState, pos_assoc, neg_assoc, pos_h_sum,
                 neg_h_sum, pos_h_mean, data_sum, v_sum, *, lr, mom,
                 weight_decay, bsz, sparsity: bool,
                 sparsity_factor: float) -> RBMState:
    """Momentum-buffer-then-apply update (rbm_ops.py:269-323, f32 path),
    shared by ``cd_update``, ``fast_cd`` and ``clamped_cd_update``."""
    w_m = mom * state.w_m + lr * ((pos_assoc - neg_assoc) / bsz
                                  - weight_decay * state.w)
    w = state.w + w_m
    hb_m = mom * state.hb_m + lr * (pos_h_sum - neg_h_sum) / bsz
    if sparsity:
        hb_m = hb_m + (-lr * (pos_h_mean - sparsity_factor))
    hb = state.hb + hb_m
    vb_m = mom * state.vb_m + lr * (data_sum - v_sum) / bsz
    vb = state.vb + vb_m
    return RBMState(w, hb, vb, w_m, hb_m, vb_m)


# ---------------------------------------------------------------------------
# Conditional samplers (rbm_ops.py:403-434, :522-577)
# ---------------------------------------------------------------------------

def _chain_init(key: int, v_known: torch.Tensor,
                known_mask: torch.Tensor) -> torch.Tensor:
    """Unknown coordinates U(0,1), known ones clamped (rbm_ops.py:413-416)."""
    u = rng.uniform(key, v_known.shape, v_known.device)
    return v_known * known_mask + (1.0 - known_mask) * u


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
        return chain.clamped_chain(state.w, state.hb, state.vb, v, v_known,
                                   known_mask, sched, groups=groups,
                                   final_unclamped=True)
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
    return chain.clamped_chain(state.w, state.hb, state.vb, v, v_known,
                               known_mask, sched, groups=groups, mu=mu_k,
                               seed=seed, final_unclamped=False)


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
                      groups: SoftmaxGroups = ()
                      ) -> Tuple[RBMState, torch.Tensor]:
    """Auxiliary clamped-CD update (rbm_ops.py:584-664).

    The positive state comes from conditional inference (noisy mean-field
    with the reference's hard-coded constants by default, at least 10
    steps); the negative chain starts from it; the update is scaled by
    ``aux_lr_mult`` with weight decay inside the scaled bracket.
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

    loss = torch.mean(torch.square(v_plus - v_neg))
    new_state = apply_update(
        state, v_plus.T @ h_plus, v_neg.T @ h_neg, h_plus.sum(0),
        h_neg.sum(0), None, v_plus.sum(0), v_neg.sum(0),
        lr=aux_lr_mult * lr, mom=mom, weight_decay=weight_decay,
        bsz=v_known.shape[0], sparsity=False, sparsity_factor=0.0)
    return new_state, loss
