"""Clamped mean-field chain: wrapper of the CUDA kernel ``csrc/chain.cu``
and its plain PyTorch version.

Port of the TPU kernel ``_chain_call`` / ``_make_chain_kernel``
(multimodal_idbn_tpu/ops/pallas_chain.py:85-253). One call runs all
``n_steps`` of a clamped chain for the whole batch:

    h = σ((vW + hb)·(1/T_t) [+ σ_t·N])
    l = (hWᵀ + vb)·(1/T_t) [+ σ_t·N]
    v = σ(l), softmax of l in each group, μ-pull by η_t on the first
        Dz = mu.shape[1] columns, then the known coordinates re-clamped

and, with ``final_unclamped``, one more pass at T=1 with no noise, μ-pull
or re-clamp (rbm_ops.py:434). ``sched`` holds the rows
(1/max(1e-6,T_t), σ_t, η_t). Noise is drawn iff ``seed`` is given: Philox
of (row0 + row, col, step, half) (``ops.rng.philox_normal``), so the plain
version reproduces the kernel's draws. The seed is an int, passed by
value, or an ``rng.Key`` of an epoch body, which the kernel reads from the
body's key table in device memory, so a CUDA graph of the epoch replays
with each epoch's seeds (``ops.graphs``). The chain init is drawn by the
caller, as in pallas_chain.py:207-209.

``row0`` and ``plan_rows`` place the batch in a larger one (a
data-parallel rank's rows ``row0 ..`` of a batch of ``plan_rows``): the
noise is that of the global rows, and the kernel sums every product in the
order it would for the whole batch, so each row equals the single-device
chain's row.

``rbm_ops.conditional_gibbs`` (mean-field) and
``rbm_ops.noisy_meanfield_annealed`` call ``clamped_chain``: the kernel on
CUDA tensors, ``chain_plain`` on CPU tensors.

On an H100 a chain is 60-101 small products in strict sequence, so it is
bound by how much of the card works on each one and by the latency between
them. The kernel is one cooperative launch of a grid that is resident as a
whole: every half-step is a split-K product over all blocks followed by a
finishing pass, with grid barriers between (``csrc/chain.cu``). The wrapper
asks the library for the launch's plan (``plan``: tile, grid, slices,
barriers), allocates the state and partial-product scratch the plan needs
and a zeroed barrier counter, and enqueues no host-to-device copy when the
schedule already lies on the device (``rbm_ops`` keeps its schedules
there) and the groups were seen before. W is used as it is in both
directions: no transposed copy is made. The kernel has no limit on V, H or
B; a launch the card refuses raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from multimodal_idbn_tpu_torch.ops import _cuda, rng
from multimodal_idbn_tpu_torch.ops.sampling import (SoftmaxGroups,
                                                    apply_softmax_groups,
                                                    clamp_mask)

KERNEL = _cuda.CudaLibrary("chain.cu", {
    "chain_run": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64] + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}, helpers={
    "chain_plan": [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)],
})
_MAX_GROUPS = 8        # MAX_GROUPS in csrc/chain.cu
_PLAN_FIELDS = ("tile_rows", "grid", "slices_h", "slices_v",
                "partial_floats", "barriers")


def plan(B: int, V: int, H: int, n_steps: int, final_unclamped: bool, *,
         tile_rows: int = 0, max_grid: int = 0,
         plan_rows: Optional[int] = None) -> Dict[str, int]:
    """The launch the library would make for this chain on the current
    CUDA device: block tile rows, grid size (all blocks resident), k-slices
    of the hidden and the visible half, floats of partial-product scratch
    and the number of grid barriers. ``tile_rows`` and ``max_grid``
    > 0 override the tile and cap the blocks (for measurements; the port
    launches with 0, the library's own choice). ``plan_rows``: the batch
    the tiling is chosen for, when the ``B`` rows are part of a larger
    one."""
    out = (ctypes.c_longlong * len(_PLAN_FIELDS))()
    KERNEL.call("chain_plan", B, V, H, max(0, int(n_steps)),
                int(final_unclamped), tile_rows, max_grid,
                int(plan_rows or 0), out)
    return dict(zip(_PLAN_FIELDS, (int(x) for x in out)))


@functools.lru_cache(maxsize=64)
def _groups_on(device: torch.device,
               groups: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """Flat int32 (start, end) pairs on ``device``, copied there once."""
    return torch.tensor(groups, dtype=torch.int32).reshape(-1).to(device)


def _check(w, hb, vb, v_init, v_known, km, sched, groups, mu) -> None:
    V, H = w.shape
    B = v_init.shape[0]
    for name, t, shape in (("hb", hb, (H,)), ("vb", vb, (V,)),
                           ("v_init", v_init, (B, V)),
                           ("v_known", v_known, (B, V)), ("km", km, (B, V))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if sched.ndim != 2 or sched.shape[1] != 3:
        raise ValueError(f"sched must be [n_steps, 3], got "
                         f"{tuple(sched.shape)}")
    if mu is not None and (mu.ndim != 2 or mu.shape[0] != B
                           or mu.shape[1] > V):
        raise ValueError(f"mu has shape {tuple(mu.shape)} for batch {B}, "
                         f"V {V}")
    if len(groups) > _MAX_GROUPS:
        raise ValueError(f"at most {_MAX_GROUPS} softmax groups")
    for s, e in groups:
        if not 0 <= s < e <= V:
            raise ValueError(f"softmax group {(s, e)} outside [0, {V})")


def chain_plain(w, hb, vb, v_init, v_known, km, sched, *,
                groups: SoftmaxGroups = (), mu=None,
                seed: Optional[rng.AnyKey] = None,
                final_unclamped: bool = False,
                row0: int = 0) -> torch.Tensor:
    """The kernel's function in plain torch, one step at a time."""
    _check(w, hb, vb, v_init, v_known, km, sched, groups, mu)
    B, V = v_init.shape
    H = w.shape[1]
    sched = sched.to(v_init.device)
    if seed is not None:
        seed = rng.key_word(seed)
    v = v_init
    for t in range(sched.shape[0]):
        inv_T, sig, eta = sched[t, 0], sched[t, 1], sched[t, 2]
        h_logits = (v @ w + hb) * inv_T
        if seed is not None:
            h_logits = h_logits + rng.philox_normal(
                seed, B, H, step=t, stream=0, device=v.device,
                row0=row0) * sig
        h = torch.sigmoid(h_logits)
        v_logits = (h @ w.T + vb) * inv_T
        if seed is not None:
            v_logits = v_logits + rng.philox_normal(
                seed, B, V, step=t, stream=1, device=v.device,
                row0=row0) * sig
        v_prob = apply_softmax_groups(torch.sigmoid(v_logits), v_logits,
                                      groups)
        if mu is not None:
            dz = mu.shape[1]
            v_prob = torch.cat([(1.0 - eta) * v_prob[:, :dz] + eta * mu,
                                v_prob[:, dz:]], dim=1)
        v = clamp_mask(v_prob, v_known, km)
    if final_unclamped:
        h = torch.sigmoid(v @ w + hb)
        v_logits = h @ w.T + vb
        v = apply_softmax_groups(torch.sigmoid(v_logits), v_logits, groups)
    return v


def clamped_chain(w, hb, vb, v_init, v_known, km, sched, *,
                  groups: SoftmaxGroups = (), mu=None,
                  seed: Optional[rng.AnyKey] = None,
                  final_unclamped: bool = False, row0: int = 0,
                  plan_rows: Optional[int] = None) -> torch.Tensor:
    """[B, V] chain output: the kernel on CUDA tensors, the plain version
    on CPU tensors. ``row0`` / ``plan_rows``: the batch's first global row
    and the rows of the whole batch (module docstring)."""
    if not v_init.is_cuda:
        return chain_plain(w, hb, vb, v_init, v_known, km, sched,
                           groups=groups, mu=mu, seed=seed,
                           final_unclamped=final_unclamped, row0=row0)
    if rng.is_deterministic():
        raise RuntimeError("the deterministic sampler mode is a CPU test "
                           "hook; the CUDA kernel draws real noise")
    _check(w, hb, vb, v_init, v_known, km, sched, groups, mu)
    return _launch(w, hb, vb, v_init, v_known, km, sched, groups, mu, seed,
                   final_unclamped, row0=row0, plan_rows=plan_rows)


def _launch(w, hb, vb, v_init, v_known, km, sched, groups, mu, seed,
            final_unclamped, *, tile_rows: int = 0,
            max_grid: int = 0, row0: int = 0,
            plan_rows: Optional[int] = None) -> torch.Tensor:
    B, V = v_init.shape
    H = w.shape[1]
    dev = v_init.device
    sched = sched.to(device=dev, dtype=torch.float32).contiguous()
    if mu is not None:
        mu = mu.contiguous()
    gr = (_groups_on(dev, tuple((int(s), int(e)) for s, e in groups))
          if groups else None)
    _cuda.check_cuda_operands(w, hb, vb, v_init, v_known, km, mu, sched)
    keys, index, value = (rng.key_operand(seed) if seed is not None
                          else (None, 0, 0))
    out = torch.empty((B, V), device=dev)
    if B == 0:
        return out
    p = plan(B, V, H, sched.shape[0], final_unclamped, tile_rows=tile_rows,
             max_grid=max_grid, plan_rows=plan_rows)
    v = torch.empty((B, -(-V // 4) * 4), device=dev)
    h = torch.empty((B, -(-H // 4) * 4), device=dev)
    logits = torch.empty((B, V), device=dev)
    partial = torch.empty((p["partial_floats"],), device=dev)
    barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    KERNEL.launch(
        "chain_run", _cuda.ptr(w), _cuda.ptr(hb), _cuda.ptr(vb),
        _cuda.ptr(v_init), _cuda.ptr(v_known), _cuda.ptr(km), _cuda.ptr(mu),
        _cuda.ptr(sched), _cuda.ptr(gr), _cuda.ptr(out), _cuda.ptr(v),
        _cuda.ptr(h), _cuda.ptr(logits), _cuda.ptr(partial),
        _cuda.ptr(barrier), B, V, H, sched.shape[0], len(groups),
        0 if mu is None else mu.shape[1], int(seed is not None),
        _cuda.ptr(keys), index, value, int(final_unclamped), tile_rows,
        max_grid, int(row0),
        int(plan_rows or 0), _cuda.stream_handle(v_init))
    return out
