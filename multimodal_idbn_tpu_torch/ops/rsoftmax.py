"""Replicated-softmax sampler: wrapper of the CUDA kernel
``csrc/rsoftmax.cu`` and its plain PyTorch version.

A replicated-softmax visible layer (Salakhutdinov & Hinton, NIPS 2009)
holds a row's word counts; given its hidden units, the D words of a row
are D draws from one softmax over the vocabulary:
``counts ~ Multinomial(D, softmax(logits))``, the logits from
``half_step.half_step_linear``. Word j of row r is the category that the
uniform of counter (row0 + r, j) under the key selects by inverse CDF
(the kernels' Philox uniforms, ``rng.philox_uniform``). The cumulative
weights ``exp(l − max)`` are summed in a fixed order, each of 256 chunks of
ceil(V / 256) words in turn, then the chunks' sums in turn, here as in the
kernel, so both draw the same words wherever the two ``exp`` agree; both
also return the counts' expectation ``D · softmax(logits)``. The key is an
int or an ``rng.Key`` of an epoch body (read from its key table in device
memory, ``rng.key_operand``), so a CUDA graph replays with each epoch's
keys.

No TPU kernel: the JAX package has no replicated-softmax layer. On CUDA
tensors the kernel launches (or raises), on CPU tensors the plain version
runs. Launches are counted (``KERNEL.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from multimodal_idbn_tpu_torch.ops import _cuda, rng

KERNEL = _cuda.CudaLibrary("rsoftmax.cu", {
    "rs_sample": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
       ctypes.c_void_p],
})
THREADS = 256  # the kernel's block: one chunk of words a thread


def _check(logits: torch.Tensor, words: torch.Tensor) -> None:
    if logits.ndim != 2 or words.ndim != 1 \
            or words.shape[0] != logits.shape[0]:
        raise ValueError(f"expected logits [B, V] and words [B]; got "
                         f"{tuple(logits.shape)}, {tuple(words.shape)}")


def cumulative_weights(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] cumulative sums of ``exp(l − max)``, in the kernel's order:
    each thread's chunk in turn, then the chunks' sums in turn."""
    B, V = logits.shape
    C = -(-V // THREADS)
    e = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
    e = torch.nn.functional.pad(e, (0, THREADS * C - V)).view(B, THREADS, C)
    run = torch.zeros((B, THREADS), dtype=e.dtype, device=e.device)
    local = []
    for i in range(C):
        run = run + e[:, :, i]
        local.append(run)
    acc = torch.zeros((B,), dtype=e.dtype, device=e.device)
    offsets = []
    for t in range(THREADS):
        offsets.append(acc)
        acc = acc + run[:, t]
    cdf = torch.stack(offsets, 1)[:, :, None] + torch.stack(local, 2)
    return cdf.reshape(B, THREADS * C)[:, :V]


def rs_sample_plain(logits: torch.Tensor, words: torch.Tensor,
                    seed: rng.AnyKey, *, row0: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch: (counts, D · softmax)."""
    _check(logits, words)
    B, V = logits.shape
    cdf = cumulative_weights(logits)
    total = cdf[:, -1]
    n = int(words.max()) if B else 0
    u = rng.philox_uniform(seed, B, max(1, n), device=logits.device,
                           row0=row0)
    k = torch.searchsorted(cdf.contiguous(), (u * total[:, None])
                           .contiguous(), right=True).clamp_(max=V - 1)
    take = (torch.arange(u.shape[1], device=logits.device)[None, :]
            < words[:, None]).to(logits.dtype)
    counts = torch.zeros_like(logits).scatter_add_(1, k, take)
    e = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
    return counts, words[:, None] * (e / total[:, None])


def rs_sample(logits: torch.Tensor, words: torch.Tensor, seed: rng.AnyKey,
              *, row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts, mean), both [B, V] fp32: ``words[r]`` words of row r drawn
    from ``softmax(logits[r])``, and their expectation. The kernel on CUDA
    tensors, the plain version on CPU tensors. ``row0``: the global index
    of the first row."""
    if not logits.is_cuda:
        return rs_sample_plain(logits, words, seed, row0=row0)
    if rng.is_deterministic():
        raise RuntimeError("the deterministic sampler mode is a CPU test "
                           "hook; the CUDA kernel draws real uniforms")
    _check(logits, words)
    logits, words = logits.contiguous(), words.contiguous()
    _cuda.check_cuda_operands(logits, words)
    B, V = logits.shape
    keys, index, value = rng.key_operand(seed)
    out = torch.empty((2, B, V), device=logits.device)
    KERNEL.launch("rs_sample", logits.data_ptr(), words.data_ptr(),
                  out[0].data_ptr(), out[1].data_ptr(), B, V,
                  _cuda.ptr(keys), index, value, int(row0),
                  _cuda.stream_handle(logits))
    return out[0], out[1]
