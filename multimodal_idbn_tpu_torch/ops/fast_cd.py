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
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimodal_idbn_tpu_torch.ops import rbm_ops, rng
from multimodal_idbn_tpu_torch.ops.half_step import half_step_sample


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
    pos_h, h = half_step_sample(data, state.w, state.hb, seeds[0])
    # negative chain: v_prob -> v=sample -> h_prob -> h=sample per step
    v = v_prob = h_prob = None
    for st in range(int(cd)):
        v_prob, v = half_step_sample(h, state.w, state.vb, seeds[1 + 2 * st],
                                     transpose_w=True)
        h_prob, h = half_step_sample(v, state.w, state.hb, seeds[2 + 2 * st])

    new_state = rbm_ops.apply_update(
        state, data.T @ pos_h, v.T @ h_prob, pos_h.sum(0), h_prob.sum(0),
        pos_h.mean(0), data.sum(0), v.sum(0), lr=lr, mom=mom,
        weight_decay=weight_decay, bsz=data.shape[0], sparsity=sparsity,
        sparsity_factor=sparsity_factor)
    loss = torch.mean(torch.square(data - v_prob))
    return new_state, loss


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

    pos_h, h0 = half_step_sample(data, state.w, state.hb, seeds[0])
    _, h = half_step_sample(chain_v.contiguous(), state.w, state.hb,
                            seeds[1])
    v = h_prob = None
    for st in range(int(cd)):
        _, v = half_step_sample(h, state.w, state.vb, seeds[2 + 2 * st],
                                transpose_w=True)
        h_prob, h = half_step_sample(v, state.w, state.hb,
                                     seeds[3 + 2 * st])
    v_recon, _ = half_step_sample(h0, state.w, state.vb, seeds[-1],
                                  transpose_w=True)

    new_state = rbm_ops.apply_update(
        state, data.T @ pos_h, v.T @ h_prob, pos_h.sum(0), h_prob.sum(0),
        pos_h.mean(0), data.sum(0), v.sum(0), lr=lr, mom=mom,
        weight_decay=weight_decay, bsz=data.shape[0], sparsity=sparsity,
        sparsity_factor=sparsity_factor)
    loss = torch.mean(torch.square(data - v_recon))
    return new_state, v, loss
