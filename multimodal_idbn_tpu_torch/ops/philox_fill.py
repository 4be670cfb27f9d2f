"""Philox fill: wrapper of the CUDA kernel ``csrc/philox_fill.cu`` and its
plain PyTorch version, the source of every uniform and random bit that the
port's plain torch code draws (``rng.uniform``, ``rng.gumbel``,
``rng.random_bits16``).

No TPU kernel: the JAX package draws these with ``jax.random``
(multimodal_idbn_tpu/ops/sampling.py:22-41, rbm_ops.py:145-170). The fill
is word 0 of Philox4x32-10 at the counter (row0 + row, col0 + col, 0,
stream), the kernels' scheme (``csrc/philox.cuh``): as uniforms
``(bits >> 8) * 2^-24``, or as the 16 bits ``bits >> 16``. Its key is an
int passed by value, or an ``rng.Key`` of an epoch body, which the kernel
reads from the body's key table (``rng.key_operand``), so a CUDA graph of
the body replays with each epoch's keys. On CUDA tensors the kernel
launches (or raises), on CPU tensors the plain version runs
(``rng.philox_bits``, bit for bit the kernel's). Launches are counted
(``KERNEL.launches``).

What bounds it on an H100: a few hundred kilobytes and a few million
integer operations per call, under a microsecond of work: the launch.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_idbn_tpu_torch.ops import _cuda, rng

KERNEL = _cuda.CudaLibrary("philox_fill.cu", {
    "philox_fill": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64]
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
})


def fill_plain(key: rng.AnyKey, rows: int, cols: int, *, device=None,
               row0: int = 0, col0: int = 0,
               bits16: bool = False) -> torch.Tensor:
    """The kernel's function in torch integer arithmetic."""
    stream = rng.STREAM_BITS if bits16 else rng.STREAM_UNIFORM
    bits = rng.philox_bits(key, rows, cols, stream=stream, device=device,
                           row0=row0, col0=col0)
    if bits16:
        return (bits >> 16).to(torch.int32)
    return rng.bits_to_uniform(bits)


def fill(key: rng.AnyKey, rows: int, cols: int, *, device=None,
         row0: int = 0, col0: int = 0, bits16: bool = False
         ) -> torch.Tensor:
    """[rows, cols] float32 uniforms, or int32 bits in [0, 2^16)."""
    device = torch.device(device if device is not None else "cpu")
    dtype = torch.int32 if bits16 else torch.float32
    if device.type != "cuda":
        return fill_plain(key, rows, cols, device=device, row0=row0,
                          col0=col0, bits16=bits16)
    keys, index, seed = rng.key_operand(key)
    out = torch.empty((rows, cols), dtype=dtype, device=device)
    if rows * cols == 0:
        return out
    if keys is not None and (keys.device != out.device
                             or keys.dtype != torch.int64):
        raise ValueError(f"key table on {keys.device} ({keys.dtype}), "
                         f"expected int64 on {out.device}")
    KERNEL.launch("philox_fill", out.data_ptr(), rows, cols,
                  _cuda.ptr(keys), index, seed, int(row0), int(col0),
                  rng.STREAM_BITS if bits16 else rng.STREAM_UNIFORM,
                  int(bits16), _cuda.stream_handle(out))
    return out
