"""Random numbers of the port: keys, Philox4x32-10, and the sampler hook.

No JAX counterpart. The JAX package draws from threefry keys and, inside
its Pallas kernels, from the TPU's on-core PRNG
(multimodal_idbn_tpu/ops/pallas_kernels.py:239-250,
ops/pallas_chain.py:72-82). The port replaces them so:

- A *key* is a 64-bit Python int. ``fold_in`` derives child keys
  (splitmix64 mixing), the way JAX code derives per-step keys.
  ``next_key`` draws a fresh key from an explicit ``torch.Generator``,
  the stream each RBM shell holds for its own calls. The training loops
  use no stream: epoch e's key is ``fold_in(SEED-derived key, e)`` and
  its permutation ``permutation(key, n)``, as the JAX package derives
  ``fold_in(epoch_key, epoch)`` (models/idbn.py:348, :433), so a run
  resumed at epoch e draws what the uninterrupted run draws.
- Draws made by plain torch code (chain inits, the Bernoulli and Gumbel
  draws of the generic CD, the bits of stochastic rounding) come from a
  ``torch.Generator`` seeded by a key.
- Draws made inside the CUDA kernels come from Philox4x32-10 keyed by a
  64-bit seed, with the counter (row, column, step, stream). It is written
  twice: in ``csrc/philox.cuh`` and here in torch integer arithmetic, so the
  kernels' plain versions reproduce their uniforms bit for bit.
  ``u = (bits >> 8) * 2^-24`` as in pallas_kernels.py:248; Gaussians by
  Box-Muller as in pallas_chain.py:72-82.

Draws of a data-parallel rank. Inside ``shard.batch_rows`` a process
holds rows ``row0 ..`` of a larger batch. ``uniform`` and ``gumbel`` then
draw at the whole batch's shape and return the rank's rows, and
``philox_uniform`` / ``philox_normal`` take the global row (``row0``) and
column (``col0``) of their first element. So every element gets the
number a single device draws for it. This is the port's side of JAX's
partitionable threefry (parallel/data_parallel.py:10-15). At these widths
the drawing of the whole batch costs little.

``deterministic()`` is the sampler hook, the port's side of the
``det_random`` fixture of tests/test_rbm_oracle.py:24-38: uniforms are 0.5,
normals 0, Gumbel noise a constant (so categorical draws are the argmax),
and chain inits 0.5. It exists for the CPU tests that hold whole CD
updates and chains against the JAX package elementwise; the CUDA kernels
refuse it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence

import torch

from multimodal_idbn_tpu_torch.ops import shard

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_TWO_POW_M24 = 1.0 / (1 << 24)


class _Mode:
    deterministic = False


_MODE = _Mode()


@contextlib.contextmanager
def deterministic() -> Iterator[None]:
    """Replace every draw by its deterministic surrogate inside the block."""
    prev = _MODE.deterministic
    _MODE.deterministic = True
    try:
        yield
    finally:
        _MODE.deterministic = prev


def is_deterministic() -> bool:
    return _MODE.deterministic


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def _mix64(z: int) -> int:
    """splitmix64 finalizer: a bijection on 64-bit ints."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """Child key of ``key`` for the integer ``data``."""
    return _mix64(_mix64(int(key) & _M64) ^ (int(data) & _M64))


def next_key(gen: torch.Generator) -> int:
    """Fresh 64-bit key drawn from an explicit generator."""
    lo, hi = torch.randint(0, 1 << 32, (2,), generator=gen,
                           dtype=torch.int64).tolist()
    return (hi << 32) | lo


def generator(key: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key) & _M64)
    return gen


def permutation(key: int, n: int) -> torch.Tensor:
    """Permutation of ``range(n)`` drawn on the CPU from ``key`` alone (a
    child key that no batch or layer index reaches), so an epoch's order
    depends on (seed, epoch) and not on the epochs run before it."""
    return torch.randperm(n, generator=generator(fold_in(key, 0x7065726D),
                                                 "cpu"))


# ---------------------------------------------------------------------------
# Draws of the plain torch code
# ---------------------------------------------------------------------------

def _rand_rows(key: int, shape: Sequence[int], device) -> torch.Tensor:
    """U[0, 1) of ``generator(key)`` at ``shape``; inside
    ``shard.batch_rows`` the rank's rows of the draw at the whole batch's
    shape (module docstring)."""
    shape = tuple(shape)
    sh = shard.current()
    if sh is None:
        return torch.rand(shape, generator=generator(key, device),
                          device=device)
    if not shape or shape[0] != sh.rows:
        raise ValueError(f"a draw of shape {shape} inside a batch shard of "
                         f"{sh.rows} rows")
    full = torch.rand((sh.total,) + shape[1:],
                      generator=generator(key, device), device=device)
    return full[sh.row0:sh.row0 + sh.rows]


def uniform(key: int, shape: Sequence[int], device) -> torch.Tensor:
    """U[0, 1) float32; 0.5 in deterministic mode."""
    if _MODE.deterministic:
        return torch.full(tuple(shape), 0.5, device=device)
    return _rand_rows(key, shape, device)


def gumbel(key: int, shape: Sequence[int], device) -> torch.Tensor:
    """Standard Gumbel float32; a constant (0) in deterministic mode."""
    if _MODE.deterministic:
        return torch.zeros(tuple(shape), device=device)
    u = _rand_rows(key, shape, device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


# ---------------------------------------------------------------------------
# Philox4x32-10, the kernels' generator, in torch integer arithmetic
# ---------------------------------------------------------------------------

def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for 32-bit ``a`` (int64 tensor)
    and constant ``m``, in 16-bit halves so no int64 product overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    mid = a_lo * m_hi + a_hi * m_lo
    low = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    hi = a_hi * m_hi + (mid >> 16) + (low >> 32)
    return hi & _M32, low & _M32


def philox4x32(counter: Sequence[torch.Tensor], key: int):
    """Philox4x32-10 (Salmon et al. 2011) on int64 tensors holding 32-bit
    words. ``counter`` is four broadcastable tensors, ``key`` 64 bits."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _M32
                      for c in counter)
    k0, k1 = int(key) & _M32, (int(key) >> 32) & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * _TWO_POW_M24


def _grid_counter(rows: int, cols: int, step: int, stream: int, device,
                  row0: int = 0, col0: int = 0):
    r = torch.arange(row0, row0 + rows, dtype=torch.int64,
                     device=device)[:, None]
    c = torch.arange(col0, col0 + cols, dtype=torch.int64,
                     device=device)[None, :]
    return (r, c, torch.tensor(step, dtype=torch.int64, device=device),
            torch.tensor(stream, dtype=torch.int64, device=device))


def philox_uniform(seed: int, rows: int, cols: int, *, step: int = 0,
                   stream: int = 0, device=None, row0: int = 0,
                   col0: int = 0) -> torch.Tensor:
    """[rows, cols] uniforms of the kernels: word 0 of
    Philox(counter=(row0 + row, col0 + col, step, stream), key=seed); 0.5
    in deterministic mode."""
    if _MODE.deterministic:
        return torch.full((rows, cols), 0.5, device=device)
    x0, _, _, _ = philox4x32(_grid_counter(rows, cols, step, stream,
                                           device, row0, col0), seed)
    return _bits_to_uniform(x0)


def philox_normal(seed: int, rows: int, cols: int, *, step: int = 0,
                  stream: int = 0, device=None, row0: int = 0
                  ) -> torch.Tensor:
    """[rows, cols] N(0, 1) of the kernels: Box-Muller on words 0 and 1
    (pallas_chain.py:72-82) of the counter (row0 + row, col, step,
    stream); 0 in deterministic mode."""
    if _MODE.deterministic:
        return torch.zeros((rows, cols), device=device)
    x0, x1, _, _ = philox4x32(_grid_counter(rows, cols, step, stream,
                                            device, row0), seed)
    u1 = torch.clamp(_bits_to_uniform(x0), min=1e-7)
    u2 = _bits_to_uniform(x1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        (2.0 * math.pi) * u2)
