"""CD-k and persistent-CD trainers of the image iDBN around the fused
half-step.

Port of multimodal_idbn_tpu/ops/pallas_cd.py:49-121. Every half-step of
the update, in both directions, is one call of ``half_step.half_step_sample``
(the CUDA kernel on CUDA tensors, its plain version on CPU tensors): one
for the positive phase and chain start, then two per CD step. The update
follows the reference order (rbm_ops.py:192-323): positive statistics from
the probabilities, the chain started from the sampled h,
``neg_assoc = v_sampledᵀ·h_prob``, momentum then apply, sparsity into
``hb_m``. ``pos_assoc``/``neg_assoc`` are plain ``torch.matmul``, as the
JAX trainer leaves them to XLA. Nothing is padded, so the statistics are
taken on the real blocks directly.

In the port's image iDBN this is the fp32 CD path, and
``fast_sampled_pcd_update`` the fp32 PCD path: the same kernel for the
update of JAX's ``rbm_ops.pcd_update`` (:326-388), which the JAX package
runs in jnp. Both take fp32 states only: bf16 storage and mixed precision
go to ``rbm_ops.cd_update`` / ``pcd_update``, a route the model chooses
from its config before any launch. Softmax groups are not supported
(image stacks have none); the joint RBM uses ``rbm_ops.cd_update``.

Two more updates train a visible layer that is not Bernoulli, each with
the same order and keys (``fold_in(key, i)``: the positive phase, then per
step the visible draw and the hidden one):
``fast_gaussian_cd_update`` (v | h ~ N(b + h·Wᵀ, 1), drawn by
``half_step_gauss``) and ``fast_rsm_cd_update`` (replicated softmax:
p(h|v̂) = sigmoid(v̂·W + D·a) by ``half_step_scaled``, v̂ | h ~
Multinomial(D, softmax(b + h·Wᵀ)) by ``half_step_linear`` and
``rsoftmax.rs_sample``, D the row's words; the hidden bias's statistic is
D·h). Their loss is the mean squared error of the data against the last
step's mean (the Gaussian's mean, the expected counts). They run on one
device, in fp32.

Inside ``shard.batch_rows`` (a data-parallel rank's rows of a batch) every
half-step draws and plans as part of the whole batch
(``shard.kernel_rows``), and the statistics and the loss are summed over
the data group before the update (``shard.reduce_update``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimodal_idbn_tpu_torch.ops import rbm_ops, rng, rsoftmax, shard
from multimodal_idbn_tpu_torch.ops.half_step import (half_step_gauss,
                                                     half_step_linear,
                                                     half_step_sample,
                                                     half_step_scaled)

# The unit types of a visible layer: Bernoulli (every layer of the shipped
# models), a Gaussian of unit variance over standardised real data, and a
# replicated softmax over a row's word counts.
BERNOULLI, GAUSSIAN, REPLICATED_SOFTMAX = ("bernoulli", "gaussian",
                                           "replicated_softmax")
VISIBLE_TYPES = (BERNOULLI, GAUSSIAN, REPLICATED_SOFTMAX)


def _half_step(x, w, b, seed, *, transpose_w=False):
    """``half_step_sample`` at this process's rows of the batch."""
    row0, total = shard.kernel_rows(x.shape[0])
    plan = None if total is None else (
        total, w.shape[0] if transpose_w else w.shape[1])
    return half_step_sample(x, w, b, seed, transpose_w=transpose_w,
                            row0=row0, plan_shape=plan)


def _update(state, data, pos_h, v, h_prob, loss, **kw):
    """``apply_update`` on the statistics of the whole batch; returns
    (new_state, loss of the whole batch)."""
    stats, loss, bsz = shard.reduce_update(
        (data.T @ pos_h, v.T @ h_prob, pos_h.sum(0), h_prob.sum(0),
         pos_h.mean(0), data.sum(0), v.sum(0)), loss, data.shape[0])
    return rbm_ops.apply_update(state, *stats, bsz=bsz, **kw), loss


def fast_sampled_cd_update(state: rbm_ops.RBMState, key: int,
                           data: torch.Tensor, *, lr, mom, weight_decay,
                           cd: int, sparsity: bool = False,
                           sparsity_factor: float = 0.05
                           ) -> Tuple[rbm_ops.RBMState, torch.Tensor]:
    """One groupless CD-k update; returns (new_state, mse loss)."""
    if int(cd) < 1:
        raise ValueError("fast_sampled_cd_update requires CD >= 1")
    data = data.contiguous()
    seeds = [rng.fold_in(key, i) for i in range(1 + 2 * int(cd))]

    # positive phase: probs + sampled chain start in one launch
    pos_h, h = _half_step(data, state.w, state.hb, seeds[0])
    # negative chain: v_prob -> v=sample -> h_prob -> h=sample per step
    v = v_prob = h_prob = None
    for st in range(int(cd)):
        v_prob, v = _half_step(h, state.w, state.vb, seeds[1 + 2 * st],
                               transpose_w=True)
        h_prob, h = _half_step(v, state.w, state.hb, seeds[2 + 2 * st])

    return _update(state, data, pos_h, v, h_prob,
                   torch.mean(torch.square(data - v_prob)), lr=lr, mom=mom,
                   weight_decay=weight_decay, sparsity=sparsity,
                   sparsity_factor=sparsity_factor)


def cd_update(state: rbm_ops.RBMState, key: int, data: torch.Tensor, *,
              groups=(), sr=None, **kw) -> Tuple[rbm_ops.RBMState,
                                                  torch.Tensor]:
    """The CD update of one RBM on its route: a groupless fp32 state
    through the half-step kernel (``fast_sampled_cd_update``), a softmax
    group or bf16 storage through ``rbm_ops.cd_update``. ``kw``: lr, mom,
    weight_decay, cd, sparsity, sparsity_factor."""
    if groups or state.w.dtype != torch.float32:
        return rbm_ops.cd_update(state, key, data, groups=groups, sr=sr,
                                 **kw)
    return fast_sampled_cd_update(state, key, data, **kw)


def fast_sampled_pcd_update(state: rbm_ops.RBMState,
                            chain_v: torch.Tensor, key: int,
                            data: torch.Tensor, *, lr, mom, weight_decay,
                            cd: int, sparsity: bool = False,
                            sparsity_factor: float = 0.05
                            ) -> Tuple[rbm_ops.RBMState, torch.Tensor,
                                       torch.Tensor]:
    """One groupless persistent-CD update (JAX rbm_ops.pcd_update,
    :326-388); returns (new_state, new_chain_v, loss). Every half-step is
    one ``half_step_sample`` call, 3 + 2·cd in all: the data's positive
    phase with its sampled h0, the persistent particles lifted to a
    sampled h, two per chain step, and the monitor's one-step
    reconstruction from h0 (its sample unused). The update order and the
    loss are ``pcd_update``'s; the new particles are the chain's last
    sampled v."""
    if int(cd) < 1:
        raise ValueError("fast_sampled_pcd_update requires CD >= 1")
    data = data.contiguous()
    seeds = [rng.fold_in(key, i) for i in range(3 + 2 * int(cd))]

    pos_h, h0 = _half_step(data, state.w, state.hb, seeds[0])
    _, h = _half_step(chain_v.contiguous(), state.w, state.hb, seeds[1])
    v = h_prob = None
    for st in range(int(cd)):
        _, v = _half_step(h, state.w, state.vb, seeds[2 + 2 * st],
                          transpose_w=True)
        h_prob, h = _half_step(v, state.w, state.hb, seeds[3 + 2 * st])
    v_recon, _ = _half_step(h0, state.w, state.vb, seeds[-1],
                            transpose_w=True)

    new_state, loss = _update(
        state, data, pos_h, v, h_prob,
        torch.mean(torch.square(data - v_recon)), lr=lr, mom=mom,
        weight_decay=weight_decay, sparsity=sparsity,
        sparsity_factor=sparsity_factor)
    return new_state, v, loss


def check_visible(visible: str) -> str:
    """``visible`` if it names a unit type of ``VISIBLE_TYPES``."""
    if visible not in VISIBLE_TYPES:
        raise ValueError(f"unknown visible unit type {visible!r}; expected "
                         f"one of {VISIBLE_TYPES}")
    return visible


def _single_device(visible: str) -> None:
    if shard.current() is not None:
        raise NotImplementedError(
            f"{visible} visible units train on one device: a mesh's share "
            f"of the batch is not supported")


def fast_gaussian_cd_update(state: rbm_ops.RBMState, key: int,
                            data: torch.Tensor, *, lr, mom, weight_decay,
                            cd: int, sparsity: bool = False,
                            sparsity_factor: float = 0.05
                            ) -> Tuple[rbm_ops.RBMState, torch.Tensor]:
    """One CD-k update of an RBM with Gaussian visible units of unit
    variance and Bernoulli hidden units: ``p(h=1|v) = sigmoid(v·W + a)``,
    ``v | h ~ N(b + h·Wᵀ, 1)``. The chain's v are drawn, the negative
    statistics taken from the last drawn v and h probabilities, as in
    ``fast_sampled_cd_update``; returns (new_state, mean squared error of
    the data against the last step's mean)."""
    if int(cd) < 1:
        raise ValueError("fast_gaussian_cd_update requires CD >= 1")
    _single_device(GAUSSIAN)
    data = data.contiguous()
    seeds = [rng.fold_in(key, i) for i in range(1 + 2 * int(cd))]
    pos_h, h = half_step_sample(data, state.w, state.hb, seeds[0])
    v = v_mean = h_prob = None
    for st in range(int(cd)):
        v_mean, v = half_step_gauss(h, state.w, state.vb, seeds[1 + 2 * st])
        h_prob, h = half_step_sample(v, state.w, state.hb,
                                     seeds[2 + 2 * st])
    return _update(state, data, pos_h, v, h_prob,
                   torch.mean(torch.square(data - v_mean)), lr=lr, mom=mom,
                   weight_decay=weight_decay, sparsity=sparsity,
                   sparsity_factor=sparsity_factor)


def rsm_hidden_probs(state: rbm_ops.RBMState, v: torch.Tensor
                     ) -> torch.Tensor:
    """p(h=1|v̂) = sigmoid(v̂·W + D·a) of a replicated-softmax layer, D the
    row's words: the mean-field pass to the layer above."""
    words = v.sum(dim=1, keepdim=True)
    return torch.sigmoid(rbm_ops._mm(v, state.w) + words * state.hb)


def fast_rsm_cd_update(state: rbm_ops.RBMState, key: int,
                       data: torch.Tensor, *, lr, mom, weight_decay,
                       cd: int, sparsity: bool = False,
                       sparsity_factor: float = 0.05
                       ) -> Tuple[rbm_ops.RBMState, torch.Tensor]:
    """One CD-k update of a replicated-softmax RBM (Salakhutdinov & Hinton,
    NIPS 2009) over word counts ``data``: ``p(h=1|v̂) = sigmoid(v̂·W +
    D·a)``, ``v̂ | h ~ Multinomial(D, softmax(b + h·Wᵀ))`` with the row's
    own D. The hidden bias's statistics are D·h; returns (new_state, mean
    squared error of the counts against the last step's expected
    counts)."""
    if int(cd) < 1:
        raise ValueError("fast_rsm_cd_update requires CD >= 1")
    _single_device(REPLICATED_SOFTMAX)
    data = data.contiguous()
    words = data.sum(dim=1)
    seeds = [rng.fold_in(key, i) for i in range(1 + 2 * int(cd))]
    pos_h, h = half_step_scaled(data, state.w, state.hb, words, seeds[0])
    v = v_mean = h_prob = None
    for st in range(int(cd)):
        logits = half_step_linear(h, state.w, state.vb)
        v, v_mean = rsoftmax.rs_sample(logits, words, seeds[1 + 2 * st])
        h_prob, h = half_step_scaled(v, state.w, state.hb, words,
                                     seeds[2 + 2 * st])
    B = data.shape[0]
    new = rbm_ops.apply_update(
        state, data.T @ pos_h, v.T @ h_prob, words @ pos_h, words @ h_prob,
        pos_h.mean(0), data.sum(0), v.sum(0), lr=lr, mom=mom,
        weight_decay=weight_decay, bsz=B, sparsity=sparsity,
        sparsity_factor=sparsity_factor)
    return new, torch.mean(torch.square(data - v_mean))


def visible_update(visible: str):
    """The fused CD-k update of a layer whose visible units are of type
    ``visible``."""
    return {BERNOULLI: fast_sampled_cd_update,
            GAUSSIAN: fast_gaussian_cd_update,
            REPLICATED_SOFTMAX: fast_rsm_cd_update}[check_visible(visible)]
