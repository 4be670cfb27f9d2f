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
bound by the latency between them more than by their arithmetic. The
kernel has two bodies (``csrc/chain.cu``), and ``body`` picks one from
the shape of W and the softmax groups alone, never from the batch, so that
a data-parallel rank and the whole batch take the same one:

- ``cluster``, where W's slices and the state fit the shared memory of a
  cluster of 16 blocks (the flagship joint, 532×500): the batch's rows are
  dealt to thread-block clusters and each cluster runs its rows' whole
  chain with W held in its blocks' shared memory, the state handed
  between them through the cluster's exchange area at L2 and two cluster
  barriers a step; no barrier counter, no grid-wide meeting;
- ``grid``, everywhere else (the bimodal joint, whose W fits no cluster):
  one cooperative launch of a grid that is resident as a whole, every
  half-step a split-K product over all blocks and a finishing pass, with
  grid barriers between.

The wrapper asks the library for the launch's plan (``plan``), allocates
the scratch it names (the grid body's state, partial products and a
zeroed barrier counter; the cluster body's exchange areas), and enqueues
no host-to-device copy when the schedule already lies on the device
(``rbm_ops`` keeps its schedules there) and the groups (and the cluster
body's column bounds) were seen before. W is used as it is in both
directions: no transposed copy is made. Neither body has a
limit on B; a launch the card refuses raises. ``KERNEL.launches_by_body``
counts the launches of each body.
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

BODIES = ("cluster", "grid")
KERNEL = _cuda.CudaLibrary("chain.cu", {
    "chain_run": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64] + [ctypes.c_int] * 6
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}, helpers={
    "chain_plan": [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_longlong)],
}, bodies=BODIES)
_MAX_GROUPS = 8        # MAX_GROUPS in csrc/chain.cu
_PLAN_FIELDS = ("tile_rows", "grid", "slices_h", "slices_v",
                "partial_floats", "barriers", "cluster", "smem_bytes")

# The cluster body (csrc/chain.cu, namespace cluster): blocks of a
# cluster, warps a block and the warps that split the hidden half's
# contraction; a cluster takes at most 8 rows a row tile, and the body
# rule asks for room for two tiles. SMEM_BYTES: the dynamic shared memory
# a block may take on an H100 (227 KB, less room for the kernel's static
# arrays).
CLUSTER_BLOCKS = 16
_CLUSTER_WARPS_K = 8
_RULE_ROW_TILES = 2
SMEM_BYTES = 227 * 1024 - 1024


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=256)
def cluster_layout(V: int, H: int, groups: Tuple[Tuple[int, int], ...] = ()
                   ) -> Optional[Tuple[int, Tuple[int, ...]]]:
    """(hw, bounds) of the cluster body at W [V, H], or None where the
    groups overlap. Block b of a cluster holds the hidden columns
    [b·hw, (b+1)·hw) (hw a multiple of 32) and the visible columns
    [bounds[b], bounds[b+1]): slices of a common width, the narrowest for
    which the 16 slices cover V with every softmax group inside one slice
    (a boundary that would cut a group moves to the group's start, or
    past its end where the group starts the slice)."""
    spans = sorted(groups)
    if any(e0 > s1 for (_, e0), (s1, _) in zip(spans, spans[1:])):
        return None
    hw = _ceil(-(-H // CLUSTER_BLOCKS), 32)
    width = _ceil(-(-V // CLUSTER_BLOCKS), 4)
    while True:
        bounds = [0]
        while bounds[-1] < V and len(bounds) <= CLUSTER_BLOCKS:
            s = bounds[-1]
            e = min(V, s + width)
            for gs, ge in spans:
                if gs < e < ge:
                    e = gs if gs > s else ge
            bounds.append(e)
        if bounds[-1] == V:
            break
        width += 4
    bounds += [V] * (CLUSTER_BLOCKS + 1 - len(bounds))
    return hw, tuple(bounds)


def cluster_smem_bytes(V: int, hw: int, bounds: Tuple[int, ...],
                       row_tiles: int) -> int:
    """A block's dynamic shared memory on the cluster body with
    ``row_tiles`` tiles of 8 rows (``layout`` in ``csrc/chain.cu``): W's
    slice, the rows of v, the block's h (TF32 head and tail), the hidden
    half's k-parts, every block's share of its logits, its columns' clamp
    data, mu and noise."""
    vw = max(e - s for s, e in zip(bounds, bounds[1:]))
    rows, vp = 8 * row_tiles, _ceil(V, 8)
    floats = ((vp + 16) * hw + rows * (vp + 4) + 2 * rows * (hw + 4)
              + _CLUSTER_WARPS_K * hw * rows + CLUSTER_BLOCKS * vw * rows
              + 4 * rows * vw + rows * hw + hw + vw)
    return 4 * floats


def _cluster_args(V: int, H: int, groups: SoftmaxGroups):
    """(hw, bounds, widest slice) of the cluster body, or raise where it
    cannot take the groups."""
    lay = cluster_layout(V, H, tuple((int(s), int(e)) for s, e in groups))
    if lay is None:
        raise ValueError(f"the cluster body cannot take the groups {groups}")
    hw, bounds = lay
    return hw, bounds, max(e - s for s, e in zip(bounds, bounds[1:]))


def body(V: int, H: int, groups: SoftmaxGroups = ()) -> str:
    """The kernel body of a chain over W [V, H] with these softmax
    groups: ``"cluster"`` where W's slices and the state of 16 rows a
    cluster fit a block's shared memory, else ``"grid"``. A pure function
    of the shape: it takes no batch, so a data-parallel rank and the whole
    batch take the same body."""
    lay = cluster_layout(V, H, tuple((int(s), int(e)) for s, e in groups))
    return ("cluster" if lay is not None and cluster_smem_bytes(
        V, *lay, _RULE_ROW_TILES) <= SMEM_BYTES else "grid")


def plan(B: int, V: int, H: int, n_steps: int, final_unclamped: bool, *,
         groups: SoftmaxGroups = (), tile_rows: int = 0, max_grid: int = 0,
         plan_rows: Optional[int] = None,
         body_name: Optional[str] = None) -> Dict:
    """The launch the library would make for this chain on the current
    CUDA device: ``body`` (``body(V, H, groups)``, or ``body_name``), then
    for the grid body block tile rows, grid size (all blocks resident),
    k-slices of the hidden and the visible half, floats of partial-product
    scratch and the number of grid barriers; for the cluster body rows a
    cluster, blocks, the hidden half's k-parts and the visible half's
    shares (one a block), floats of the clusters' exchange areas and no
    grid barrier.
    ``cluster``: blocks of a cluster (0 on the grid body); ``smem_bytes``:
    a block's shared memory. ``tile_rows`` and ``max_grid`` > 0 override
    the grid body's tile and cap its blocks (for measurements; the port
    launches with 0, the library's own choice). ``plan_rows``: the batch
    the grid body's tiling is chosen for, when the ``B`` rows are part of
    a larger one."""
    name = body_name or body(V, H, groups)
    hw, _, vw = _cluster_args(V, H, groups) if name == "cluster" else (0, 0, 0)
    out = (ctypes.c_longlong * len(_PLAN_FIELDS))()
    KERNEL.call("chain_plan", B, V, H, max(0, int(n_steps)),
                int(final_unclamped), tile_rows, max_grid,
                int(plan_rows or 0), int(name == "cluster"), hw, vw, out)
    return dict(body=name, **dict(zip(_PLAN_FIELDS, (int(x) for x in out))))


@functools.lru_cache(maxsize=64)
def _groups_on(device: torch.device, groups: tuple) -> torch.Tensor:
    """Flat int32 (start, end) pairs (or the cluster body's column
    bounds) on ``device``, copied there once."""
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
            plan_rows: Optional[int] = None,
            body_name: Optional[str] = None) -> torch.Tensor:
    """One launch. ``body_name`` forces a body (tests and measurements;
    the port launches with None, ``body``'s choice); ``tile_rows`` and
    ``max_grid`` apply to the grid body (``plan``)."""
    B, V = v_init.shape
    H = w.shape[1]
    dev = v_init.device
    sched = sched.to(device=dev, dtype=torch.float32).contiguous()
    if mu is not None:
        mu = mu.contiguous()
    groups = tuple((int(s), int(e)) for s, e in groups)
    gr = _groups_on(dev, groups) if groups else None
    _cuda.check_cuda_operands(w, hb, vb, v_init, v_known, km, mu, sched)
    keys, index, value = (rng.key_operand(seed) if seed is not None
                          else (None, 0, 0))
    out = torch.empty((B, V), device=dev)
    if B == 0:
        return out
    name = body_name or body(V, H, groups)
    p = plan(B, V, H, sched.shape[0], final_unclamped, groups=groups,
             tile_rows=tile_rows, max_grid=max_grid, plan_rows=plan_rows,
             body_name=name)
    partial = torch.empty((p["partial_floats"],), device=dev)
    v = h = logits = barrier = bounds = None
    hw = vw = 0
    if name == "cluster":
        hw, cuts, vw = _cluster_args(V, H, groups)
        bounds = _groups_on(dev, cuts)
    else:
        v = torch.empty((B, -(-V // 4) * 4), device=dev)
        h = torch.empty((B, -(-H // 4) * 4), device=dev)
        logits = torch.empty((B, V), device=dev)
        barrier = torch.zeros((1,), dtype=torch.int32, device=dev)
    KERNEL.launch(
        "chain_run", _cuda.ptr(w), _cuda.ptr(hb), _cuda.ptr(vb),
        _cuda.ptr(v_init), _cuda.ptr(v_known), _cuda.ptr(km), _cuda.ptr(mu),
        _cuda.ptr(sched), _cuda.ptr(gr), _cuda.ptr(out), _cuda.ptr(v),
        _cuda.ptr(h), _cuda.ptr(logits), _cuda.ptr(partial),
        _cuda.ptr(barrier), B, V, H, sched.shape[0], len(groups),
        0 if mu is None else mu.shape[1], int(seed is not None),
        _cuda.ptr(keys), index, value, int(final_unclamped), tile_rows,
        max_grid, int(row0), int(plan_rows or 0), int(name == "cluster"),
        _cuda.ptr(bounds), hw, vw, _cuda.stream_handle(v_init), body=name)
    return out
