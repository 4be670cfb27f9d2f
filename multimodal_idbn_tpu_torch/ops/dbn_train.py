"""iDBN training epochs and the DBN encode/decode passes.

Port of multimodal_idbn_tpu/ops/dbn_train.py:31-139 (``idbn_epoch``) and
:388-434 (``dbn_represent``, ``dbn_decode``, ``dbn_decode_sampled``,
``dbn_reconstruct``). The
JAX epoch is one ``lax.scan``; here it is a Python loop over static batch slices of
already-permuted data (``shuffle=False``), with the same iterative
schedule: every layer updates on every batch, and layer i+1 is fed the
post-update ``hidden_probs`` of layer i (dbn_train.py:117-136). Every
layer update is ``fast_cd.fast_sampled_cd_update``, the fused half-step
kernel's trainer. Keys: batch b, layer i gets ``fold_in(fold_in(key, b), i)``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from multimodal_idbn_tpu_torch.ops import fast_cd, rbm_ops, rng
from multimodal_idbn_tpu_torch.ops.sampling import sample_bernoulli

States = List[rbm_ops.RBMState]


def idbn_batch_step(states: Sequence[rbm_ops.RBMState], key: int,
                    batch: torch.Tensor, *, lr, mom, weight_decay,
                    sparsity_factor, cd: int,
                    sparsity_flags: Sequence[bool]
                    ) -> Tuple[States, torch.Tensor]:
    """All-layers update on one batch (dbn_train.py:366-385); returns
    (states, losses[L])."""
    v = batch
    new_states, losses = [], []
    for i, st in enumerate(states):
        st, loss = fast_cd.fast_sampled_cd_update(
            st, rng.fold_in(key, i), v, lr=lr, mom=mom,
            weight_decay=weight_decay, cd=cd, sparsity=sparsity_flags[i],
            sparsity_factor=sparsity_factor)
        v = rbm_ops.hidden_probs(st, v)
        new_states.append(st)
        losses.append(loss)
    return new_states, torch.stack(losses)


def idbn_epoch(states: Sequence[rbm_ops.RBMState], key: int,
               data: torch.Tensor, *, lr, mom, weight_decay, sparsity_factor,
               cd: int, sparsity_flags: Sequence[bool], batch_size: int
               ) -> Tuple[States, torch.Tensor]:
    """One iDBN epoch over the ``n // batch_size`` full batches of ``data``
    in order; returns (states, losses[nb, L]). Rows beyond
    ``nb * batch_size`` are left to the caller (dbn_train.py:82-90)."""
    nb = data.shape[0] // batch_size
    states = list(states)
    losses = []
    for b in range(nb):
        states, lb = idbn_batch_step(
            states, rng.fold_in(key, b),
            data[b * batch_size:(b + 1) * batch_size], lr=lr, mom=mom,
            weight_decay=weight_decay, sparsity_factor=sparsity_factor,
            cd=cd, sparsity_flags=sparsity_flags)
        losses.append(lb)
    if not losses:
        return states, torch.zeros((0, len(states)), device=data.device)
    return states, torch.stack(losses)


def dbn_represent(states: Sequence[rbm_ops.RBMState], v: torch.Tensor,
                  upto: int) -> torch.Tensor:
    """Mean-field encode through the first ``upto`` layers
    (dbn_train.py:388-394)."""
    for st in states[:upto]:
        v = rbm_ops.hidden_probs(st, v)
    return v


def dbn_decode(states: Sequence[rbm_ops.RBMState],
               top: torch.Tensor) -> torch.Tensor:
    """Decode top activations back to input space (dbn_train.py:397-404)."""
    cur = top
    for st in reversed(list(states)):
        cur = rbm_ops.visible_probs(st, cur)
    return cur


def dbn_decode_sampled(states: Sequence[rbm_ops.RBMState],
                       top: torch.Tensor, key: int) -> torch.Tensor:
    """Ancestral-sampled decode (dbn_train.py:407-424): every layer above
    the bottom is Bernoulli-sampled on the way down (layer i from the top
    with ``fold_in(key, i)``); the bottom layer's probabilities are
    returned."""
    states = list(states)
    cur = top
    for i, st in enumerate(reversed(states)):
        cur = rbm_ops.visible_probs(st, cur)
        if i < len(states) - 1:
            cur = sample_bernoulli(rng.fold_in(key, i), cur)
    return cur


def dbn_reconstruct(states: Sequence[rbm_ops.RBMState],
                    v: torch.Tensor) -> torch.Tensor:
    """Encode through all layers, then decode back (dbn_train.py:427-434)."""
    return dbn_decode(states, dbn_represent(states, v, len(states)))
