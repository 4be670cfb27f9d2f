"""Annealing and learning-rate schedules.

Port of multimodal_idbn_tpu/ops/schedules.py:17-80. Schedules are float32
tensors of length ``n_steps`` computed in the same float32 operation order
as the JAX package, so the two agree elementwise.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def lin_schedule(t, t_max: int, start, end) -> torch.Tensor:
    """Linear schedule from start to end over t_max steps
    (schedules.py:17-25)."""
    t = torch.as_tensor(t, dtype=_F32)
    if t_max <= 1:
        return torch.full_like(t, float(end))
    alpha = torch.clamp(t / (t_max - 1), 0.0, 1.0)
    return (torch.tensor(start, dtype=_F32)
            + (torch.tensor(end, dtype=_F32) - start) * alpha)


def hot_steps(n_steps: int, hot_frac: float) -> int:
    """Number of 'hot' (stochastic) steps, a Python int
    (schedules.py:28-30)."""
    return int(max(0, min(n_steps, round(hot_frac * n_steps))))


def steps_iota(n_steps: int) -> torch.Tensor:
    """0, 1, ..., n_steps - 1 as float32 (schedules.py:33-34)."""
    return torch.arange(n_steps, dtype=_F32)



def annealed_temperature(n_steps: int, T0, T1, sharpen_last: int,
                         T_cold_plus) -> torch.Tensor:
    """Linear T0→T1 with the last ``max(1, sharpen_last)`` steps pinned to
    ``T_cold_plus`` (schedules.py:37-46)."""
    t = steps_iota(n_steps)
    T = lin_schedule(t, n_steps, T0, T1)
    tail = max(1, int(sharpen_last))
    return torch.where((n_steps - t) <= tail,
                       torch.tensor(T_cold_plus, dtype=_F32), T)


def gibbs_annealed_temperature(n_steps: int, T0, T1) -> torch.Tensor:
    """Linear T0→T1 with the last 3 steps sharpened to ``min(0.9, T)``
    (schedules.py:49-56)."""
    t = steps_iota(n_steps)
    T = lin_schedule(t, n_steps, T0, T1)
    return torch.where((n_steps - t) <= 3, torch.clamp(T, max=0.9), T)


def noise_sigma(n_steps: int, sigma0) -> torch.Tensor:
    """``sigma0 * max(0, 1 - t/(n-1))`` (schedules.py:59-62)."""
    t = steps_iota(n_steps)
    return torch.tensor(sigma0, dtype=_F32) * torch.clamp(
        1.0 - t / max(1, n_steps - 1), min=0.0)


def mu_pull_eta(n_steps: int, eta0) -> torch.Tensor:
    """``eta0 * max(0, 1 - t/(n-1))`` (schedules.py:65-68)."""
    t = steps_iota(n_steps)
    return torch.tensor(eta0, dtype=_F32) * torch.clamp(
        1.0 - t / max(1, n_steps - 1), min=0.0)


def effective_lr(base_lr: float, epoch, dynamic_lr: bool):
    """``lr/(1+0.01*epoch)`` iff dynamic (schedules.py:71-75)."""
    if dynamic_lr:
        return base_lr / (1.0 + 0.01 * epoch)
    return base_lr


def effective_momentum(momentum: float, final_momentum: float, epoch):
    """Initial momentum through epoch 5, then final (schedules.py:78-80)."""
    return momentum if epoch <= 5 else final_momentum
