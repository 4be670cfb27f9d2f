"""Fused half-steps: wrappers of the CUDA kernel ``csrc/half_step.cu``
and their plain PyTorch versions.

``probs = sigmoid((x·W[ᵀ] + b)/max(1e-6, T))`` and, when sampling,
``sample = probs > u`` with ``u`` the Philox uniform of (seed, row0 + row,
col0 + col) (``ops.rng.philox_uniform``). ``row0``, ``col0`` and
``plan_shape`` place the operand in a larger one: a data-parallel rank's
rows of a batch, a model-parallel rank's columns of W. The rank draws the
uniforms of its global elements and sums each product in the order of the
whole operand's plan, so its outputs are the single-device outputs' rows
and columns bit for bit. Three public functions, each the port of
one TPU kernel (multimodal_idbn_tpu/ops/pallas_kernels.py):

- ``half_step_sample``: ``half_step_sample_aligned`` (:198-306), the
  k-tiled sampled half-step of the image-stack CD trainer.
  ``transpose_w`` computes ``x·Wᵀ`` from the same row-major [V, H] W. Its
  seed is an int, passed by value, or an ``rng.Key`` of an epoch body,
  which the kernel reads from the body's key table in device memory
  (``rng.key_operand``), so a CUDA graph of the epoch replays with each
  epoch's seeds.
  ``half_step_sample_big`` is JAX's standalone wrapper of the same kernel
  (:311-342) under its name.
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

On an H100 one launch at the flagship first layer is bound about
equally by streaming its 60 MB W from HBM (18 µs) and by the three TF32
tensor-core passes that keep fp32 accuracy (23 µs), and the product is
skinny: at most 128 batch rows. ``plan`` picks one of two kernel bodies
from the whole operand's shape and splits the contraction across blocks:
the ``wgmma`` body (one block holds the whole batch and 128 columns of W,
TMA loads, wgmma; every shape whose rows are 16-byte aligned, up to 128
rows) or the ``mma_sync`` body (64 x 64 tiles; ragged and unaligned
shapes). With more than one k-slice the wrapper hands the kernel a
scratch buffer for the partial products and zeroed counters, both kept
per stream, and the slices are summed in fixed order before the fused
epilogue. The result does not depend on the order in which blocks run:
the same inputs give the same bits on every launch and through every
entry. ``KERNEL.launches_by_body`` counts the launches of each body.

Visible units that are not Bernoulli take three more entries of the same
source, each on both bodies: ``half_step_gauss`` (a Gaussian visible of
unit variance, drawn downward), ``half_step_linear`` (the logits of a
replicated-softmax visible, whose words ``ops.rsoftmax`` draws) and
``half_step_scaled`` (the hidden layer above it, its bias counted once per
word of the row). No TPU kernel has them: the JAX package trains Bernoulli
and softmax-group units only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from multimodal_idbn_tpu_torch.ops import _cuda, rng

BODIES = ("wgmma", "mma_sync")
KERNEL = _cuda.CudaLibrary("half_step.cu", {
    "half_step_sample": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
       ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "half_step_probs": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "half_step_sample_resident": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_uint32, ctypes.c_void_p],
    "half_step_linear": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "half_step_gauss": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
       ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "half_step_scaled": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
       ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}, bodies=BODIES)
_INT32 = (-(1 << 31), (1 << 31) - 1)

# The wgmma body (csrc/wgmma_tile.cuh): slabs of 128 columns, k-tiles of
# 32, the whole batch in one block, at most one block per SM.
_WG_COLS = 128
_WG_K = 32
_SMS = 132                  # an H100's SMs: the plan's grid, on every card
# The mma_sync body (csrc/gemm_tile.cuh): 64 columns, k-tiles of 16, and
# 32 rows, or 64 for the large products of a full batch.
_TILE_COLS = 64
_TILE_K = 16
_TARGET_BLOCKS = 396        # three blocks for each of an H100's 132 SMs
_MIN_K_TILES_PER_SLICE = 8  # a shorter slice is all latency
_MAX_TERMS = 1024           # the tensor cores truncate when they add to a
#                             sum, so a slice sums at most 1024 terms
_LARGE_PRODUCT = 1 << 23    # K * N from which the 64-row tile pays


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _plan_wgmma(B: int, K: int, N: int) -> Tuple[int, int, int]:
    """(rows, slices, k_per_slice) of the wgmma body: the batch rounded up
    to 32, 64 or 128, and the slices that minimise a time model counted in
    k-tiles: the waves of (slab, slice) units over the card, each its
    k-tiles plus two of pipeline fill and its partial sums, written by the
    unit and read back spread over the grid, at their bytes' worth of
    k-tiles."""
    rows = 32 if B <= 32 else (64 if B <= 64 else 128)
    tiles = _ceil_div(N, _WG_COLS)
    k_tiles = max(1, _ceil_div(K, _WG_K))
    partial = rows * 512 / (rows * 128 + _WG_COLS * _WG_K * 4)
    best = None
    for want in range(_ceil_div(k_tiles, _MAX_TERMS // _WG_K), k_tiles + 1):
        per = _ceil_div(k_tiles, want)
        slices = _ceil_div(k_tiles, per)
        units = tiles * slices
        waves = _ceil_div(units, _SMS)
        cost = waves * (per + 2 + partial) + partial * units / _SMS
        if best is None or cost < best[0] - 1e-9:
            best = (cost, slices, per)
    return rows, best[1], best[2] * _WG_K


def _plan_mma_sync(B: int, K: int, N: int) -> Tuple[int, int, int]:
    """(rows, slices, k_per_slice) of the mma_sync body: about three
    blocks per SM, slices of 128 to 1024 terms."""
    tile_rows = 64 if B > 32 and K * N >= _LARGE_PRODUCT else 32
    tiles = _ceil_div(B, tile_rows) * _ceil_div(N, _TILE_COLS)
    k_tiles = max(1, _ceil_div(K, _TILE_K))
    slices = max(1, min(k_tiles // _MIN_K_TILES_PER_SLICE,
                        _ceil_div(_TARGET_BLOCKS, tiles)))
    per_slice = min(_ceil_div(k_tiles, slices), _MAX_TERMS // _TILE_K)
    return tile_rows, _ceil_div(k_tiles, per_slice), per_slice * _TILE_K


@functools.lru_cache(maxsize=256)
def plan(B: int, K: int, N: int) -> Tuple[str, int, int, int]:
    """(body, tile_rows, slices, k_per_slice) of one half-step. The body
    is ``wgmma`` where the rows of x and W are 16-byte aligned (K and N
    multiples of 4) and B is at most 128, else ``mma_sync``; tile_rows is
    the block tile's rows (wgmma: the batch rounded up to 32, 64 or 128;
    mma_sync: 32 or 64); the contraction is split into ``slices`` k-slices
    of ``k_per_slice`` terms, a multiple of the body's k-tile (32, 16) and
    at most 1024. A pure function of the shape, the same on every device,
    so that a result never depends on where or when it is computed.
    ``slices * k_per_slice >= K`` and no slice is empty. Chosen from the
    sweep of ``bench_kernels`` on an H100."""
    if B <= 128 and K % 4 == 0 and N % 4 == 0:
        return ("wgmma", *_plan_wgmma(B, K, N))
    return ("mma_sync", *_plan_mma_sync(B, K, N))


_WORKSPACES: Dict[Tuple[torch.device, Optional[int]],
                  Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: Optional[int], n_floats: int,
               n_tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scratch for the slices' partial products, zeroed int32 ticket
    counters) of at least the given sizes, kept per (device, stream):
    launches on one stream run in order, so they can share both, and the
    kernel leaves the tickets zero again. While a CUDA graph is being
    captured the buffers are allocated anew, so that they belong to the
    graph."""
    if torch.cuda.is_current_stream_capturing():
        return (torch.empty(n_floats, device=device),
                torch.zeros(n_tiles, dtype=torch.int32, device=device))
    key = (device, stream)
    held = _WORKSPACES.get(key)
    if held is None or held[0].numel() < n_floats \
            or held[1].numel() < n_tiles:
        held = (torch.empty(max(n_floats, 1 << 22), device=device),
                torch.zeros(max(n_tiles, 4096), dtype=torch.int32,
                            device=device))
        _WORKSPACES[key] = held
    return held


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            n_out: int, B: int, K: int, N: int, head: Tuple[int, ...],
            tail: Tuple, *,
            tiling: Optional[Tuple[str, int, int, int]] = None,
            plan_shape: Optional[Tuple[int, int]] = None,
            operands: Tuple[torch.Tensor, ...] = ()
            ) -> Tuple[torch.Tensor, ...]:
    """Launch one entry and return its ``n_out`` outputs, each [B, N]
    (one allocation, cut once: a half-step is short, and the host's time
    to enqueue it counts). The C arguments are the operands, the outputs,
    scratch and tickets, the shape, ``head`` (the transpose flag, where
    the entry has one), the body and the tiling (``plan``'s tuple), then
    ``tail`` (1/T, and the seed and offsets where the entry has them).
    ``plan_shape``: the (rows, columns) of the whole operand the tiling is
    chosen for; ``operands``: inputs of the entry after b (the row scale of
    ``half_step_scaled``)."""
    pB, pN = plan_shape or (B, N)
    body, tile_rows, slices, k_per_slice = tiling or plan(pB, K, pN)
    stream = _cuda.stream_handle(x)
    out = torch.empty((n_out, B, N), device=x.device)
    base = out.data_ptr()
    scratch = tickets = None
    if body == "wgmma":
        scratch, tickets = _workspace(
            x.device, stream.value,
            slices * _ceil_div(N, _WG_COLS) * _WG_COLS * tile_rows, 2)
    elif slices > 1:
        scratch, tickets = _workspace(
            x.device, stream.value, slices * B * _ceil_div(N, 4) * 4,
            _ceil_div(B, tile_rows) * _ceil_div(N, _TILE_COLS))
    KERNEL.launch(entry, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                  *(t.data_ptr() for t in operands),
                  *(base + 4 * B * N * i for i in range(n_out)),
                  _cuda.ptr(scratch), _cuda.ptr(tickets), B, K, N, *head,
                  int(body == "wgmma"), tile_rows, slices, k_per_slice,
                  *tail, stream, body=body)
    return out.unbind(0)


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
                    seed: rng.AnyKey, T=1.0, *, transpose_w: bool = False,
                    row0: int = 0, col0: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch: addmm, sigmoid, Philox."""
    _out_dim(x, w, b, transpose_w)
    inv_T = 1.0 / max(1e-6, T)
    p = torch.sigmoid(torch.addmm(b, x, w.T if transpose_w else w) * inv_T)
    u = rng.philox_uniform(seed, p.shape[0], p.shape[1], device=p.device,
                           row0=row0, col0=col0)
    return p, (p > u).to(p.dtype)


def half_step_sample(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     seed: rng.AnyKey, T=1.0, *, transpose_w: bool = False,
                     row0: int = 0, col0: int = 0,
                     plan_shape: Optional[Tuple[int, int]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs, sample), both [B, N] fp32: the kernel on CUDA tensors, the
    plain version on CPU tensors. ``row0`` / ``col0``: the global index of
    the first row / column; ``plan_shape``: (rows, columns) of the whole
    output (module docstring)."""
    if not x.is_cuda:
        return half_step_plain(x, w, b, seed, T, transpose_w=transpose_w,
                               row0=row0, col0=col0)
    return _sampled_launch("half_step_sample", x, w, b, seed, T,
                           transpose_w, row0, col0, plan_shape,
                           head=(int(transpose_w),))


def half_step_sample_big_plain(v: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor, seed: int, T=1.0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``half_step_sample_big`` in plain torch (``half_step_plain``)."""
    return half_step_plain(v, w, b, seed, T)


def half_step_sample_big(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         seed: int, T=1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs, Bernoulli sample), both [B, H], of ``v·w`` for any B, V, H
    (the TPU ``half_step_sample_big``, pallas_kernels.py:311-342, which
    pads to its tiles and calls ``half_step_sample_aligned``). Here it is
    the ``half_step_sample`` entry, which takes ragged shapes unpadded: the
    kernel on CUDA tensors, the plain version on CPU tensors.

    A difference by design: the probabilities are fp32-accurate (three
    TF32 passes with fp32 sums), where the TPU wrapper's ran the MXU at
    bf16 operands (:320-324). The seed is a 64-bit int, not an int32
    pair."""
    return half_step_sample(v, w, b, seed, T)


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
    return _launch("half_step_probs", v, w, b, 1, B, V, H, (),
                   (1.0 / max(1e-6, T),))[0]


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
    probs, sample = _launch("half_step_sample_resident", v, w, b, 2, B, V, H,
                            (), (1.0 / max(1e-6, T), key))
    return probs, sample


# ---------------------------------------------------------------------------
# Visible units that are not Bernoulli: a Gaussian visible layer of unit
# variance and a replicated-softmax one (ops/fast_cd.py)
# ---------------------------------------------------------------------------

def _sampled_launch(entry: str, x, w, b, seed, T, transpose_w: bool,
                    row0: int, col0: int, plan_shape, operands=(), *,
                    head: Tuple[int, ...] = (),
                    tiling: Optional[Tuple[str, int, int, int]] = None):
    """(out, sample) of an entry that draws from ``seed``: the launch of
    ``half_step_sample``, ``half_step_gauss`` and ``half_step_scaled``.
    ``head`` and ``tiling`` as ``_launch`` takes them (the transpose flag
    of ``half_step_sample``; a tiling other than ``plan``'s, for
    ``bench_kernels``)."""
    if rng.is_deterministic():
        raise RuntimeError("the deterministic sampler mode is a CPU test "
                           "hook; the CUDA kernel draws real uniforms")
    N = _out_dim(x, w, b, transpose_w)
    _cuda.check_cuda_operands(x, w, b, *operands)
    B, K = x.shape
    if plan_shape is not None and (plan_shape[0] < row0 + B
                                   or plan_shape[1] < col0 + N):
        raise ValueError(f"plan_shape {plan_shape} does not hold rows "
                         f"{row0}+{B}, columns {col0}+{N}")
    keys, index, value = rng.key_operand(seed)
    return _launch(entry, x, w, b, 2, B, K, N, head,
                   (1.0 / max(1e-6, T), _cuda.ptr(keys), index, value,
                    int(row0), int(col0)), tiling=tiling,
                   plan_shape=plan_shape, operands=operands)


def half_step_linear_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           T=1.0) -> torch.Tensor:
    """``(h·Wᵀ + b)/max(1e-6, T)`` in plain torch."""
    _out_dim(h, w, b, True)
    return torch.addmm(b, h, w.T) * (1.0 / max(1e-6, T))


def half_step_linear(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     T=1.0) -> torch.Tensor:
    """[B, V] ``(h·Wᵀ + b)/max(1e-6, T)`` of a [V, H] W, no draw: the
    logits of a replicated-softmax visible layer (the ``half_step_linear``
    entry on CUDA tensors, the plain version on CPU tensors)."""
    if not h.is_cuda:
        return half_step_linear_plain(h, w, b, T)
    V = _out_dim(h, w, b, True)
    _cuda.check_cuda_operands(h, w, b)
    B, H = h.shape
    return _launch("half_step_linear", h, w, b, 1, B, H, V, (),
                   (1.0 / max(1e-6, T),))[0]


def half_step_gauss_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          seed: rng.AnyKey, T=1.0, *, row0: int = 0,
                          col0: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean ``(h·Wᵀ + b)/max(1e-6, T)`` and the mean plus the kernels'
    N(0, 1) of (seed, row0 + row, col0 + col), in plain torch."""
    mean = half_step_linear_plain(h, w, b, T)
    noise = rng.philox_normal(seed, mean.shape[0], mean.shape[1],
                              device=mean.device, row0=row0, col0=col0)
    return mean, mean + noise


def half_step_gauss(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    seed: rng.AnyKey, T=1.0, *, row0: int = 0, col0: int = 0,
                    plan_shape: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, sample), both [B, V] fp32, of a Gaussian visible layer of
    unit variance below ``h``: v ~ N(h·Wᵀ + b, 1) (the ``half_step_gauss``
    entry on CUDA tensors, the plain version on CPU tensors)."""
    if not h.is_cuda:
        return half_step_gauss_plain(h, w, b, seed, T, row0=row0, col0=col0)
    return _sampled_launch("half_step_gauss", h, w, b, seed, T, True, row0,
                           col0, plan_shape)


def half_step_scaled_plain(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           scale: torch.Tensor, seed: rng.AnyKey, T=1.0, *,
                           row0: int = 0, col0: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sigmoid((v·W + scale[:, None]·b)/max(1e-6, T))`` and its Bernoulli
    sample against the kernels' uniforms, in plain torch."""
    _out_dim(v, w, b, False)
    p = torch.sigmoid((torch.mm(v, w) + scale[:, None] * b)
                      * (1.0 / max(1e-6, T)))
    u = rng.philox_uniform(seed, p.shape[0], p.shape[1], device=p.device,
                           row0=row0, col0=col0)
    return p, (p > u).to(p.dtype)


def half_step_scaled(v: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     scale: torch.Tensor, seed: rng.AnyKey, T=1.0, *,
                     row0: int = 0, col0: int = 0,
                     plan_shape: Optional[Tuple[int, int]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs, sample), both [B, H] fp32, of the hidden layer above a
    replicated-softmax visible: the bias counted ``scale[row]`` times (the
    row's words), ``sigmoid(v·W + D·b)`` (the ``half_step_scaled`` entry on
    CUDA tensors, the plain version on CPU tensors)."""
    if scale.ndim != 1 or scale.shape[0] != v.shape[0]:
        raise ValueError(f"scale {tuple(scale.shape)} is not one factor "
                         f"per row of v {tuple(v.shape)}")
    if not v.is_cuda:
        return half_step_scaled_plain(v, w, b, scale, seed, T, row0=row0,
                                      col0=col0)
    return _sampled_launch("half_step_scaled", v, w, b, seed, T, False,
                           row0, col0, plan_shape,
                           operands=(scale.contiguous(),))
