"""Fused half-steps: wrappers of the CUDA kernel ``csrc/half_step.cu``
and their plain PyTorch versions.

``probs = sigmoid((x·W[ᵀ] + b)/max(1e-6, T))`` and, when sampling,
``sample = probs > u`` with ``u`` the Philox uniform of (seed, row, col)
(``ops.rng.philox_uniform``). Three public functions, each the port of
one TPU kernel (multimodal_idbn_tpu/ops/pallas_kernels.py):

- ``half_step_sample``: ``half_step_sample_aligned`` (:198-306), the
  k-tiled sampled half-step of the image-stack CD trainer.
  ``transpose_w`` computes ``x·Wᵀ`` from the same row-major [V, H] W.
- ``half_step_probs`` and ``hidden_probs_kernel``: ``half_step_probs``
  (:95-126) and ``hidden_probs_pallas`` (:174-183), the probabilities
  alone. The port's kernel has no on-chip ceiling on V, so
  ``hidden_probs_kernel`` launches it at every shape where the TPU
  dispatcher fell back to jnp.
- ``half_step_sample_resident``: ``half_step_sample`` (:129-171),
  probabilities and sample of ``x·W`` from an int32 seed.

Unlike the TPU kernels, operands are not padded: the kernel masks ragged
edges itself. It computes in fp32 where the TPU kernels rounded operands
to bf16. On CUDA tensors a wrapper launches the kernel (or raises); on
CPU tensors it runs the plain version, which reproduces the kernel's
uniforms bit for bit. Launches are counted per entry
(``KERNEL.launches_by_entry``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from multimodal_idbn_tpu_torch.ops import _cuda, rng

KERNEL = _cuda.CudaLibrary("half_step.cu", {
    "half_step_sample": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_uint64, ctypes.c_void_p],
    "half_step_probs": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
    "half_step_sample_resident": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_uint32, ctypes.c_void_p],
})
_INT32 = (-(1 << 31), (1 << 31) - 1)


def _out_dim(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             transpose_w: bool) -> int:
    if x.ndim != 2 or w.ndim != 2 or b.ndim != 1:
        raise ValueError(f"expected x[B,K], w 2-D, b[N]; got {tuple(x.shape)}"
                         f", {tuple(w.shape)}, {tuple(b.shape)}")
    K, N = (w.shape[1], w.shape[0]) if transpose_w else w.shape
    if x.shape[1] != K or b.shape[0] != N:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w}), "
                         f"b {tuple(b.shape)}")
    return N


def half_step_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    seed: int, T=1.0, *, transpose_w: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch: addmm, sigmoid, Philox."""
    _out_dim(x, w, b, transpose_w)
    inv_T = 1.0 / max(1e-6, T)
    p = torch.sigmoid(torch.addmm(b, x, w.T if transpose_w else w) * inv_T)
    u = rng.philox_uniform(seed, p.shape[0], p.shape[1], device=p.device)
    return p, (p > u).to(p.dtype)


def half_step_sample(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     seed: int, T=1.0, *, transpose_w: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs, sample), both [B, N] fp32: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if not x.is_cuda:
        return half_step_plain(x, w, b, seed, T, transpose_w=transpose_w)
    if rng.is_deterministic():
        raise RuntimeError("the deterministic sampler mode is a CPU test "
                           "hook; the CUDA kernel draws real uniforms")
    N = _out_dim(x, w, b, transpose_w)
    _cuda.check_cuda_operands(x, w, b)
    B, K = x.shape
    probs = torch.empty((B, N), device=x.device)
    sample = torch.empty((B, N), device=x.device)
    KERNEL.launch("half_step_sample", _cuda.ptr(x), _cuda.ptr(w),
                  _cuda.ptr(b), _cuda.ptr(probs), _cuda.ptr(sample), B, K, N,
                  int(transpose_w), 1.0 / max(1e-6, T),
                  int(seed) & ((1 << 64) - 1), _cuda.stream_handle(x))
    return probs, sample


def half_step_probs_plain(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          T=1.0) -> torch.Tensor:
    """``sigmoid((v·w + b)/max(1e-6, T))`` in plain torch."""
    _out_dim(v, w, b, False)
    return torch.sigmoid(torch.addmm(b, v, w) / max(1e-6, T))


def half_step_probs(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    T=1.0) -> torch.Tensor:
    """[B, H] fp32 probabilities of ``v·w`` (the TPU ``half_step_probs``):
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if not v.is_cuda:
        return half_step_probs_plain(v, w, b, T)
    H = _out_dim(v, w, b, False)
    _cuda.check_cuda_operands(v, w, b)
    B, V = v.shape
    probs = torch.empty((B, H), device=v.device)
    KERNEL.launch("half_step_probs", _cuda.ptr(v), _cuda.ptr(w),
                  _cuda.ptr(b), _cuda.ptr(probs), B, V, H,
                  1.0 / max(1e-6, T), _cuda.stream_handle(v))
    return probs


def hidden_probs_kernel(state, v: torch.Tensor, T=1.0) -> torch.Tensor:
    """``rbm_ops.hidden_probs`` through ``half_step_probs`` (the TPU
    ``hidden_probs_pallas``)."""
    return half_step_probs(v, state.w, state.hb, T)


def _resident_seed(seed: int) -> int:
    if not _INT32[0] <= int(seed) <= _INT32[1]:
        raise ValueError(f"seed {seed} is not an int32, as the TPU kernel's")
    return int(seed) & 0xFFFFFFFF


def half_step_sample_resident_plain(v: torch.Tensor, w: torch.Tensor,
                                    b: torch.Tensor, seed: int, T=1.0
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The resident sampled half-step in plain torch: its probabilities
    and the Philox draw keyed by the seed's 32 bits."""
    p = half_step_probs_plain(v, w, b, T)
    u = rng.philox_uniform(_resident_seed(seed), p.shape[0], p.shape[1],
                           device=p.device)
    return p, (p > u).to(p.dtype)


def half_step_sample_resident(v: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, seed: int, T=1.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs, sample), both [B, H] fp32, of ``v·w`` from an int32 seed
    (the TPU ``half_step_sample``): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not v.is_cuda:
        return half_step_sample_resident_plain(v, w, b, seed, T)
    if rng.is_deterministic():
        raise RuntimeError("the deterministic sampler mode is a CPU test "
                           "hook; the CUDA kernel draws real uniforms")
    H = _out_dim(v, w, b, False)
    key = _resident_seed(seed)
    _cuda.check_cuda_operands(v, w, b)
    B, V = v.shape
    probs = torch.empty((B, H), device=v.device)
    sample = torch.empty((B, H), device=v.device)
    KERNEL.launch("half_step_sample_resident", _cuda.ptr(v), _cuda.ptr(w),
                  _cuda.ptr(b), _cuda.ptr(probs), _cuda.ptr(sample), B, V, H,
                  1.0 / max(1e-6, T), key, _cuda.stream_handle(v))
    return probs, sample
