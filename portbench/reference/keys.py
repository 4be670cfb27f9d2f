"""Keys and Philox4x32-10 draws, a frozen copy of the arithmetic the port
documents (a key is a 64-bit int; ``fold_in`` mixes with splitmix64;
every draw is word 0 of Philox4x32-10 at the counter (row, column, step,
stream), ``u = (bits >> 8) * 2**-24``; an epoch's order is
``torch.randperm`` from a CPU generator seeded by a child key).

Kept here so that the reference draws the uniforms the program draws,
without importing the program."""

from __future__ import annotations

import math

import torch

M64 = (1 << 64) - 1
M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
STREAM_KERNEL = 0      # the kernels' sampled half-steps and the chain's h
STREAM_CHAIN_V = 1     # the chain's visible half
STREAM_UNIFORM = 2     # the plain code's uniforms and Gumbel noise
PERM_TAG = 0x7065726D  # the child key of an epoch's permutation


def _mix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    return _mix64(_mix64(int(key) & M64) ^ (int(data) & M64))


def permutation(key: int, n: int) -> torch.Tensor:
    """The epoch's order of ``range(n)`` (on the CPU)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(fold_in(key, PERM_TAG) & M64)
    return torch.randperm(n, generator=gen)


def _signed(key: int) -> int:
    key = int(key) & M64
    return key - (1 << 64) if key >> 63 else key


def _philox(c0, c1, c2, c3, key):
    """Philox4x32-10 on int64 tensors of 32-bit words; ``key`` an int or
    an int64 tensor of keys (their two's complement) that broadcasts
    against the counter."""
    if isinstance(key, torch.Tensor):
        k0, k1 = key & M32, (key >> 32) & M32
    else:
        k0, k1 = key & M32, (key >> 32) & M32
    for _ in range(10):
        p0 = c0 * _PHILOX_M0
        p1 = c2 * _PHILOX_M1
        hi0, lo0 = (p0 >> 32) & M32, p0 & M32
        hi1, lo1 = (p1 >> 32) & M32, p1 & M32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & M32
        k1 = (k1 + _PHILOX_W1) & M32
    return c0, c1


def _counter(rows: int, cols: int, step: int, stream: int, device):
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return (r, c, torch.full((), step, dtype=torch.int64, device=device),
            torch.full((), stream, dtype=torch.int64, device=device))


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(key: int, rows: int, cols: int, *, step: int = 0,
            stream: int = STREAM_KERNEL, device=None) -> torch.Tensor:
    """[rows, cols] uniforms in [0, 1) of (key, counter)."""
    x0, _ = _philox(*_counter(rows, cols, step, stream, device),
                    int(key) & M64)
    return _to_uniform(x0)


def uniform_stack(key_list, rows: int, cols: int, *,
                  stream: int = STREAM_KERNEL, device=None) -> torch.Tensor:
    """[len(key_list), rows, cols]: ``uniform`` of each key, in one call
    (the draws of a chain do not depend on its data)."""
    k = torch.tensor([_signed(x) for x in key_list], dtype=torch.int64,
                     device=device)[:, None, None]
    r, c, st, sm = _counter(rows, cols, 0, stream, device)
    x0, _ = _philox(r[None], c[None], st, sm, k)
    return _to_uniform(x0)


def normal_steps(key: int, rows: int, cols: int, steps: int, *,
                 stream: int, device=None) -> torch.Tensor:
    """[steps, rows, cols]: ``normal`` at steps 0 .. steps - 1."""
    r, c, _, sm = _counter(rows, cols, 0, stream, device)
    st = torch.arange(steps, dtype=torch.int64, device=device)[:, None,
                                                                 None]
    x0, x1 = _philox(r[None], c[None], st, sm, int(key) & M64)
    u1 = torch.clamp(_to_uniform(x0), min=1e-7)
    u2 = _to_uniform(x1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def plain_uniform(key: int, shape, device=None) -> torch.Tensor:
    """The plain code's uniforms of ``shape``: axis 0 the rows, the other
    axes flattened into the columns, at stream 2."""
    shape = tuple(shape)
    rows = shape[0] if shape else 1
    cols = math.prod(shape[1:]) if len(shape) > 1 else 1
    return uniform(key, rows, cols, stream=STREAM_UNIFORM,
                   device=device).reshape(shape)
