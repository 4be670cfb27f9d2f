"""Sampling primitives for Bernoulli / softmax-group RBM units.

Port of multimodal_idbn_tpu/ops/sampling.py:22-80. Draws come from
``ops.rng`` (Philox keyed by an int or by an epoch body's ``rng.Key``),
so they follow the sampler hook's deterministic mode in the parity tests.
Nothing here reads a tensor on the host, so an epoch body that samples can
be captured as a CUDA graph.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from multimodal_idbn_tpu_torch.ops import rng

# Static (start, end) index pairs of the categorical blocks of the
# visible layer (sampling.py:17-19).
SoftmaxGroups = Tuple[Tuple[int, int], ...]


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``one_hot(idx, n)`` as a comparison with ``arange(n)``: the same
    0/1 values with no host check of ``idx`` (torch's ``one_hot`` reads
    its input's range on the host, on the CPU)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def sample_bernoulli(key: rng.AnyKey, p: torch.Tensor) -> torch.Tensor:
    """``(p > u)`` with strict ``>``, as the reference (sampling.py:22-29)."""
    u = rng.uniform(key, p.shape, p.device)
    return (p > u).to(p.dtype)


def sample_categorical_onehot(key: rng.AnyKey,
                              probs: torch.Tensor) -> torch.Tensor:
    """One-hot rows by Gumbel-max over ``log(clip(probs, 1e-8, 1))``
    (sampling.py:32-41)."""
    logp = torch.log(torch.clamp(probs, 1e-8, 1.0))
    idx = torch.argmax(logp + rng.gumbel(key, probs.shape, probs.device),
                       dim=-1)
    return one_hot(idx, probs.shape[-1], probs.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``torch.sigmoid`` in fp32; in bf16 the
    expansion XLA computes, ``1 / (1 + exp(-x))`` with every operation
    rounded to bf16, which torch's fused bf16 sigmoid does not reproduce
    (it rounds once)."""
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``torch.softmax`` in fp32;
    in bf16 as XLA computes it, ``exp(x - max)`` rounded to bf16 over its
    fp32 sum rounded to bf16."""
    if x.dtype == torch.bfloat16:
        e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
        return e / e.float().sum(dim=-1, keepdim=True).to(x.dtype)
    return torch.softmax(x, dim=-1)


def apply_softmax_groups(v_prob: torch.Tensor, logits: torch.Tensor,
                         groups: SoftmaxGroups) -> torch.Tensor:
    """Overwrite each group's block with the softmax of the *logits*
    (sampling.py:44-54)."""
    if not groups:
        return v_prob
    v_prob = v_prob.clone()
    for s, e in groups:
        v_prob[:, s:e] = softmax(logits[:, s:e])
    return v_prob


def sample_visible(key: rng.AnyKey, v_prob: torch.Tensor,
                   groups: SoftmaxGroups) -> torch.Tensor:
    """Bernoulli units elementwise; each group re-sampled categorically
    as a one-hot block (sampling.py:57-67)."""
    v = sample_bernoulli(key, v_prob)
    for gi, (s, e) in enumerate(groups):
        v[:, s:e] = sample_categorical_onehot(rng.fold_in(key, gi + 1),
                                              v_prob[:, s:e])
    return v


def clamp_mask(v_new: torch.Tensor, v_known: torch.Tensor,
               known_mask: torch.Tensor) -> torch.Tensor:
    """``v_new*(1-m) + v_known*m`` (sampling.py:70-72)."""
    return v_new * (1.0 - known_mask) + v_known * known_mask


def group_mask(num_visible: int, groups: Sequence[Tuple[int, int]],
               dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """1 on coordinates covered by any softmax group, else 0
    (sampling.py:75-80)."""
    m = torch.zeros((num_visible,), dtype=dtype, device=device)
    for s, e in groups:
        m[s:e] = 1.0
    return m
