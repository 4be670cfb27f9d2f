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
- Every draw is Philox4x32-10 keyed by a 64-bit key, with the counter
  (row, column, step, stream). It is written twice: in ``csrc/philox.cuh``
  (the CUDA kernels and ``philox_fill``, the fill of the plain torch
  code's uniforms and random bits) and here in torch integer arithmetic,
  so the plain versions reproduce the card's draws bit for bit.
  ``u = (bits >> 8) * 2^-24`` as in pallas_kernels.py:248; Gaussians by
  Box-Muller as in pallas_chain.py:72-82. The kernels draw at stream 0 (and
  the chain's visible half at 1); ``uniform`` and ``gumbel`` at stream 2,
  ``random_bits16`` at stream 3, every one at step 0. So every draw of the
  port is a function of (key, counter).

Keys of an epoch body. An epoch that the card replays as a CUDA graph
(``ops.graphs``) cannot take its keys as host integers: a captured launch
would keep them. Inside an epoch body the epoch's key is a ``Key``, a path
of ``fold_in`` data from the epoch's key, and ``fold_in`` extends the path.
A draw registers its key with the active ``KeyTable``. Run launch by
launch, the table computes the key's value on the host and the draw takes
it by value; captured, the draw reads it by index from the table's int64
tensor, which the host fills before each replay with the values ``fold_in``
gives for that epoch (``key_values``). Either way every key is the one the
same code computes with integers, so a replay and the same epoch run launch
by launch draw the same numbers.

``deterministic()`` is the sampler hook, the port's side of the
``det_random`` fixture of tests/test_rbm_oracle.py:24-38: uniforms are 0.5,
normals 0, Gumbel noise a constant (so categorical draws are the argmax),
and chain inits 0.5. It exists for the CPU tests that hold whole CD
updates and chains against the JAX package elementwise; the CUDA kernels
refuse it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

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


@dataclasses.dataclass(frozen=True)
class Key:
    """A key of an epoch body: ``fold_in`` applied along ``path`` to the
    epoch's key, which the body does not know (module docstring)."""

    path: Tuple[int, ...] = ()


def fold_in(key, data: int):
    """Child key of ``key`` for the integer ``data``: a 64-bit int, or a
    ``Key`` one step further along its path."""
    if isinstance(key, Key):
        return Key(key.path + (int(data) & _M64,))
    return _mix64(_mix64(int(key) & _M64) ^ (int(data) & _M64))


class KeyTable:
    """The keys of one run of an epoch body, in the order it draws them.

    By value (``keys`` None, ``root`` the epoch's key): each key's value is
    computed on the host as it is drawn and passed by value, and its path
    recorded (``paths``). From a table (``keys`` an int64 tensor on the
    body's device, filled with the values of the ``expected`` paths before
    each replay of the graph that reads it; a capture reads none of them):
    each key is read by index, and must be the ``expected`` path at that
    index, so a body whose draws depended on its data would raise."""

    def __init__(self, keys: Optional[torch.Tensor] = None,
                 expected: Optional[Sequence[Tuple[int, ...]]] = None, *,
                 root: Optional[Union[int, Sequence[int]]] = None):
        if (keys is None) == (root is None):
            raise ValueError("a key table is by value (root) or read from "
                             "a tensor (keys), not both")
        if keys is not None and expected is None:
            raise ValueError("a key table tensor needs its key paths")
        self.keys = keys
        self.expected = None if expected is None else list(expected)
        self.paths: List[Tuple[int, ...]] = []
        if root is None:
            self._memo: Dict[Tuple[int, ...], int] = {}
        elif isinstance(root, (tuple, list)):
            # several roots (``root_keys``): root i is the path (i,)
            self._memo = {(i,): int(r) & _M64 for i, r in enumerate(root)}
        else:
            self._memo = {(): int(root) & _M64}

    def index(self, key: Key) -> int:
        i = len(self.paths)
        if self.expected is not None and (i >= len(self.expected)
                                          or self.expected[i] != key.path):
            raise RuntimeError(
                f"draw {i} of the epoch body has key path {key.path}, not "
                f"the recorded one: the body's draws depend on its data")
        self.paths.append(key.path)
        return i

    def value(self, key: Key) -> int:
        """The 64-bit value of ``key`` from the root (by value)."""
        memo, path = self._memo, key.path
        for n in range(1, len(path) + 1):
            if path[:n] not in memo:
                memo[path[:n]] = fold_in(memo[path[:n - 1]], path[n - 1])
        return memo[path]


def root_keys(n: int) -> Tuple[Key, ...]:
    """The ``Key`` of each of ``n`` independent roots, for a body that
    takes several keys (a table made with ``root`` a sequence of n ints:
    one key for each RBM shell a call draws from)."""
    return tuple(Key((i,)) for i in range(n))


def key_values(root, paths: Sequence[Tuple[int, ...]]) -> List[int]:
    """The values of ``paths`` from the epoch key ``root`` (or the roots
    of ``root_keys``), in order, as int64 (the two's complement of each
    64-bit key), for a key table's tensor."""
    table = KeyTable(root=root)
    out = [table.value(Key(tuple(p))) for p in paths]
    return [v - (1 << 64) if v >> 63 else v for v in out]


_TABLES: List[KeyTable] = []


@contextlib.contextmanager
def key_table(table: KeyTable) -> Iterator[KeyTable]:
    """Resolve every ``Key`` drawn inside the block through ``table``."""
    _TABLES.append(table)
    try:
        yield table
    finally:
        _TABLES.pop()


AnyKey = Union[int, Key, torch.Tensor]


def key_operand(key: AnyKey) -> Tuple[Optional[torch.Tensor], int, int]:
    """(table, index, value) of a draw's key for a kernel: a ``Key`` is
    registered with the active table, and read by the kernel from the
    table's tensor at ``index``, or passed by value when the table is by
    value; an int is passed by value."""
    if isinstance(key, Key):
        if not _TABLES:
            raise RuntimeError("a Key outside an epoch body's key table")
        table = _TABLES[-1]
        i = table.index(key)
        if table.keys is None:
            return None, 0, table.value(key)
        return table.keys, i, 0
    if isinstance(key, torch.Tensor):
        raise TypeError("a kernel takes a Key or an int, not a tensor")
    return None, 0, int(key) & _M64


def key_word(key: AnyKey):
    """The key as the torch Philox takes it: an int as it is; a ``Key``
    registered with the active table and given as its value, or read from
    the table's tensor as a 0-d int64 tensor (no host synchronisation); a
    tensor as it is."""
    if isinstance(key, Key):
        keys, i, value = key_operand(key)
        return value if keys is None else keys[i]
    return key


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
# Philox4x32-10, the kernels' generator, in torch integer arithmetic
# ---------------------------------------------------------------------------

STREAM_UNIFORM = 2   # the counter's stream of ``uniform`` and ``gumbel``
STREAM_BITS = 3      # of ``random_bits16``


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for 32-bit ``a`` (int64 tensor)
    and constant ``m``: one int64 product, which wraps modulo 2^64 and so
    holds the 64 bits of the unsigned product."""
    p = a * m
    return (p >> 32) & _M32, p & _M32


def philox4x32(counter: Sequence[torch.Tensor], key):
    """Philox4x32-10 (Salmon et al. 2011) on int64 tensors holding 32-bit
    words. ``counter`` is four broadcastable tensors, ``key`` 64 bits: an
    int, or an int64 tensor (a key read from a table)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) & _M32
                      for c in counter)
    if isinstance(key, torch.Tensor):
        k0, k1 = key & _M32, (key >> 32) & _M32
    else:
        k0, k1 = int(key) & _M32, (int(key) >> 32) & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _M32
        k1 = (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * _TWO_POW_M24


def _grid_counter(rows: int, cols: int, step: int, stream: int, device,
                  row0: int = 0, col0: int = 0):
    r = torch.arange(row0, row0 + rows, dtype=torch.int64,
                     device=device)[:, None]
    c = torch.arange(col0, col0 + cols, dtype=torch.int64,
                     device=device)[None, :]
    return (r, c, torch.full((), step, dtype=torch.int64, device=device),
            torch.full((), stream, dtype=torch.int64, device=device))


def philox_bits(seed: AnyKey, rows: int, cols: int, *, step: int = 0,
                stream: int = 0, device=None, row0: int = 0,
                col0: int = 0) -> torch.Tensor:
    """[rows, cols] int64: word 0 of Philox(counter=(row0 + row, col0 +
    col, step, stream), key=seed)."""
    x0, _, _, _ = philox4x32(_grid_counter(rows, cols, step, stream,
                                           device, row0, col0),
                             key_word(seed))
    return x0


def philox_uniform(seed: AnyKey, rows: int, cols: int, *, step: int = 0,
                   stream: int = 0, device=None, row0: int = 0,
                   col0: int = 0) -> torch.Tensor:
    """[rows, cols] uniforms of the kernels: ``philox_bits`` to [0, 1);
    0.5 in deterministic mode."""
    if _MODE.deterministic:
        key_word(seed)
        return torch.full((rows, cols), 0.5, device=device)
    return bits_to_uniform(philox_bits(seed, rows, cols, step=step,
                                        stream=stream, device=device,
                                        row0=row0, col0=col0))


def philox_normal(seed: AnyKey, rows: int, cols: int, *, step: int = 0,
                  stream: int = 0, device=None, row0: int = 0,
                  col0: int = 0) -> torch.Tensor:
    """[rows, cols] N(0, 1) of the kernels: Box-Muller on words 0 and 1
    (pallas_chain.py:72-82) of the counter (row0 + row, col0 + col, step,
    stream); 0 in deterministic mode."""
    if _MODE.deterministic:
        key_word(seed)
        return torch.zeros((rows, cols), device=device)
    x0, x1, _, _ = philox4x32(_grid_counter(rows, cols, step, stream,
                                            device, row0, col0),
                              key_word(seed))
    u1 = torch.clamp(bits_to_uniform(x0), min=1e-7)
    u2 = bits_to_uniform(x1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        (2.0 * math.pi) * u2)


# ---------------------------------------------------------------------------
# Draws of the plain torch code, through ``ops.philox_fill``
# ---------------------------------------------------------------------------

def _rows_cols(shape: Sequence[int]) -> Tuple[int, int]:
    """A draw of ``shape`` as the [rows, cols] grid of its counter: axis 0
    the rows, the other axes flattened into the columns."""
    shape = tuple(shape)
    if not shape:
        return 1, 1
    return shape[0], math.prod(shape[1:])


def _fill(key: AnyKey, shape: Sequence[int], device, bits16: bool
          ) -> torch.Tensor:
    from multimodal_idbn_tpu_torch.ops import philox_fill
    rows, cols = _rows_cols(shape)
    row0 = 0
    sh = shard.current()
    if sh is not None and not bits16:
        if not tuple(shape) or shape[0] != sh.rows:
            raise ValueError(f"a draw of shape {tuple(shape)} inside a "
                             f"batch shard of {sh.rows} rows")
        row0 = sh.row0
    out = philox_fill.fill(key, rows, cols, device=device, row0=row0,
                           bits16=bits16)
    return out.reshape(tuple(shape))


def uniform(key: AnyKey, shape: Sequence[int], device) -> torch.Tensor:
    """U[0, 1) float32 of Philox(key) at stream 2, rows counted from the
    rank's first global row inside ``shard.batch_rows``; 0.5 in
    deterministic mode."""
    if _MODE.deterministic:
        key_word(key)
        return torch.full(tuple(shape), 0.5, device=device)
    return _fill(key, shape, device, bits16=False)


def gumbel(key: AnyKey, shape: Sequence[int], device) -> torch.Tensor:
    """Standard Gumbel float32 of ``uniform``'s draw; a constant (0) in
    deterministic mode."""
    if _MODE.deterministic:
        key_word(key)
        return torch.zeros(tuple(shape), device=device)
    u = _fill(key, shape, device, bits16=False)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def random_bits16(key: AnyKey, shape: Sequence[int], device
                  ) -> torch.Tensor:
    """int32 in [0, 2^16): the top 16 bits of word 0 of Philox(key) at
    stream 3, the same in every mode (the ``det_random`` fixture leaves
    ``jax.random.bits`` real)."""
    return _fill(key, shape, device, bits16=True)
