"""2-D (data × model) mesh training: the batch split over ``data``, the
hidden units of each RBM over ``model``.

Port of multimodal_idbn_tpu/parallel/mesh2d.py, the Megatron-style
column split, here over process groups: the processes of the job form a
``dp × mp`` grid (rank = data index · mp + model index), with one group
for each column of the grid (the data groups) and one for each row (the
model groups), made by ``dist.new_group``.

- ``W [V, H]`` and ``hb [H]`` and their momenta are split by hidden
  columns over ``model``: a process holds columns ``col0 ..`` of them
  (``shard_state``, the layout ``state_pspecs`` describes); ``vb`` is
  whole on every process.
- ``p(h|v) = σ(vW + hb)`` is local: the half-step kernel on the column
  block, with ``col0`` and the plan of the whole output, so each column
  is the single device's column bit for bit, draw included.
- ``p(v|h) = σ(hWᵀ + vb)`` contracts over the split axis: each process
  computes its partial product with ``torch.matmul`` (JAX leaves it to
  XLA, outside any Pallas kernel), the model group sums them, and the
  sigmoid, the softmax groups and the Bernoulli or categorical draw follow
  at global indices (Philox of (row, column), as the kernel draws).
- The CD statistics contract over the batch: the data group sums them
  (``ops.shard.reduce_update``); ``dW`` is split like ``W``, so the update
  is local.

``tp_cd_update`` is ``fast_cd.fast_sampled_cd_update`` with the column
split (and softmax groups on the visible side); only the visible product
and the cross-process sums round differently from one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_idbn_tpu_torch.ops import rbm_ops, rng, shard
from multimodal_idbn_tpu_torch.ops.half_step import half_step_sample
from multimodal_idbn_tpu_torch.ops.sampling import (apply_softmax_groups,
                                                    sigmoid)
from multimodal_idbn_tpu_torch.device import DeviceLike
from multimodal_idbn_tpu_torch.parallel.data_parallel import mesh_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh2D:
    """A ``dp × mp`` grid of processes: this process's place in it, the
    data group of its grid column and the model group of its grid row
    (None where a group would hold this process alone)."""

    dp: int
    mp: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any
    device: torch.device
    backend: Optional[str]
    axis_names: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self):
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}

    @property
    def data_size(self) -> int:
        return self.dp


def make_mesh_2d(dp: Optional[int] = None, mp: int = 2,
                 devices=None, device: DeviceLike = None) -> Mesh2D:
    """A ``(dp, mp)`` mesh with axes ``("data", "model")`` over the
    processes of the group, or over ``devices``, a list of its ranks
    (JAX mesh2d.py:53-73). ``dp`` defaults to ``n // mp``. Every process
    of the group calls it: the groups are made collectively. ``device``:
    this process's device (``data_parallel.mesh_device``: ``cuda`` unless
    the CPU is asked for)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    n = len(ranks)
    if dp is None:
        if n % mp:
            raise ValueError(f"{n} devices not divisible by mp={mp}")
        dp = n // mp
    if dp * mp > n:
        raise ValueError(f"requested dp*mp={dp * mp} devices, have {n}")
    grid = np.array(ranks[:dp * mp]).reshape(dp, mp)
    me = dist.get_rank() if dist.is_initialized() else 0
    data_group = model_group = None
    for m in range(mp):   # every process makes every group, in one order
        g = _new_group(grid[:, m])
        if me in grid[:, m]:
            data_group = g
    for d in range(dp):
        g = _new_group(grid[d, :])
        if me in grid[d, :]:
            model_group = g
    where = np.argwhere(grid == me)
    if not len(where):
        raise ValueError(f"process {me} is not in the mesh {grid.tolist()}")
    d, m = (int(x) for x in where[0])
    return Mesh2D(dp, mp, d, m, data_group, model_group,
                  mesh_device(device),
                  dist.get_backend() if dist.is_initialized() else None)


def _new_group(ranks):
    return dist.new_group([int(r) for r in ranks]) if len(ranks) > 1 \
        else None


@dataclasses.dataclass
class ShardedState(rbm_ops.RBMState):
    """An RBM state split by hidden columns: this process's columns
    ``col0 .. col0 + w.shape[1]`` of ``hidden``, and its mesh."""

    mesh: Any = None
    col0: int = 0
    hidden: int = 0


def state_pspecs() -> rbm_ops.RBMState:
    """The split of an RBM state under hidden-dim model parallelism, as
    PartitionSpec-like tuples: ``W`` and ``hb`` (and their momenta) by
    columns over ``model``, ``vb`` whole."""
    return rbm_ops.RBMState(
        w=(None, MODEL_AXIS), hb=(MODEL_AXIS,), vb=(),
        w_m=(None, MODEL_AXIS), hb_m=(MODEL_AXIS,), vb_m=())


def shard_state(mesh: Mesh2D, state: rbm_ops.RBMState) -> ShardedState:
    """This process's columns of a whole state (a sharded one is returned
    as it is)."""
    if isinstance(state, ShardedState):
        return state
    H = state.w.shape[1]
    c0, cols = shard.split_rows(H, mesh.mp, mesh.model_rank)
    sl = slice(c0, c0 + cols)
    return ShardedState(
        w=state.w[:, sl].contiguous(), hb=state.hb[sl].clone(),
        vb=state.vb.clone(), w_m=state.w_m[:, sl].contiguous(),
        hb_m=state.hb_m[sl].clone(), vb_m=state.vb_m.clone(), mesh=mesh,
        col0=c0, hidden=H)


def shard_batch_2d(mesh: Mesh2D, *arrays, dtype=torch.float32,
                   trim: bool = False):
    """This process's rows of each array, axis 0 split over ``data``."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a).to(dtype)
        n = t.shape[0]
        if n % mesh.dp:
            if not trim:
                raise ValueError(f"batch axis ({n}) must divide dp="
                                 f"{mesh.dp}; pass trim=True or pad")
            n = (n // mesh.dp) * mesh.dp
        per = n // mesh.dp
        out.append(t[mesh.data_rank * per:(mesh.data_rank + 1) * per])
    return out[0] if len(out) == 1 else tuple(out)


def _columns_whole(mesh: Mesh2D, x: torch.Tensor, col0: int,
                   total: int) -> torch.Tensor:
    """[rows, total] from this process's columns ``col0 ..`` of it: the
    blocks of the model group summed into zeros, which is exact."""
    if mesh.model_group is None:
        return x
    out = torch.zeros((x.shape[0], total), dtype=x.dtype, device=x.device)
    out[:, col0:col0 + x.shape[1]] = x
    return shard.all_reduce_sum([out], mesh.model_group)[0]


def _visible_sample(mesh: Mesh2D, st: ShardedState, h: torch.Tensor,
                    seed: int, groups, row0: int):
    """(v_prob, v) of the visible half from this process's hidden columns:
    the partial products summed over the model group, the softmax groups,
    and the draws of the global rows (Philox, as the half-step kernel's)."""
    logits = shard.all_reduce_sum([h @ st.w.T], mesh.model_group)[0] + st.vb
    p = apply_softmax_groups(sigmoid(logits), logits, groups)
    B, V = p.shape
    v = (p > rng.philox_uniform(seed, B, V, device=p.device,
                                row0=row0)).to(p.dtype)
    tiny = torch.finfo(torch.float32).tiny
    for gi, (s, e) in enumerate(groups):
        u = rng.philox_uniform(rng.fold_in(seed, gi + 1), B, e - s,
                               device=p.device, row0=row0)
        g = -torch.log(-torch.log(u.clamp(min=tiny)))
        idx = torch.argmax(torch.log(torch.clamp(p[:, s:e], 1e-8, 1.0)) + g,
                           dim=-1)
        v[:, s:e] = torch.nn.functional.one_hot(idx, e - s).to(p.dtype)
    return p, v


def _tp_update(mesh: Mesh2D, st: ShardedState, key: int,
               batch: torch.Tensor, *, lr, mom, weight_decay, cd: int,
               sparsity: bool, sparsity_factor: float, groups=()):
    """One CD-k update of a column-split state on this process's rows of
    ``batch`` (whole on every process); returns (state, loss)."""
    if int(cd) < 1:
        raise ValueError("tp_cd_update requires CD >= 1")
    total = batch.shape[0]
    seeds = [rng.fold_in(key, i) for i in range(1 + 2 * int(cd))]
    plan = (total, st.hidden)
    with shard.batch_rows(total, mesh.data_rank, mesh.dp,
                          mesh.data_group) as rows:
        data = batch[rows].contiguous()
        r0 = rows.start

        def hidden(x, seed):
            return half_step_sample(x, st.w, st.hb, seed, row0=r0,
                                    col0=st.col0, plan_shape=plan)

        pos_h, h = hidden(data, seeds[0])
        v = v_prob = h_prob = None
        for s in range(int(cd)):
            v_prob, v = _visible_sample(mesh, st, h, seeds[1 + 2 * s],
                                        groups, r0)
            h_prob, h = hidden(v, seeds[2 + 2 * s])
        stats, loss, bsz = shard.reduce_update(
            (data.T @ pos_h, v.T @ h_prob, pos_h.sum(0), h_prob.sum(0),
             pos_h.mean(0), data.sum(0), v.sum(0)),
            torch.mean(torch.square(data - v_prob)), data.shape[0])
    new = rbm_ops.apply_update(st, *stats, lr=lr, mom=mom,
                               weight_decay=weight_decay, bsz=bsz,
                               sparsity=sparsity,
                               sparsity_factor=sparsity_factor)
    return dataclasses.replace(st, **{
        f.name: getattr(new, f.name)
        for f in dataclasses.fields(rbm_ops.RBMState)}), loss


def tp_cd_update(mesh: Mesh2D, state: rbm_ops.RBMState, key: int, data, *,
                 lr, mom, weight_decay, cd: int, sparsity: bool = False,
                 sparsity_factor: float = 0.05, groups=()):
    """One CD-k update with the batch (whole on every process) split over
    ``data`` and the layer over ``model`` (module docstring). Returns
    (this process's ``ShardedState``, loss of the whole batch);
    ``gather_state`` makes the state whole."""
    st = shard_state(mesh, state)
    data = torch.as_tensor(data, dtype=torch.float32, device=st.w.device)
    return _tp_update(mesh, st, key, data, lr=lr, mom=mom,
                      weight_decay=weight_decay, cd=cd, sparsity=sparsity,
                      sparsity_factor=sparsity_factor, groups=tuple(groups))


def tp_idbn_epoch(mesh: Mesh2D, states: Sequence[rbm_ops.RBMState],
                  key: int, data, lr, mom, weight_decay, sparsity_factor, *,
                  cd: int, sparsity_flags, batch_size: int,
                  shuffle: bool = False):
    """An iDBN epoch on the 2-D mesh over the full batches of ``data``
    (whole on every process), every layer split over ``model``: the keys
    of ``dbn_train.idbn_epoch`` (batch b, layer i:
    ``fold_in(fold_in(key, b), i)``), layer i+1 fed the mean-field
    activations of the updated layer i, made whole over the model group.
    Returns (the processes' ``ShardedState`` of each layer,
    losses[nb, L]) (JAX mesh2d.py:126-201)."""
    states = [shard_state(mesh, st) for st in states]
    data = torch.as_tensor(data, dtype=torch.float32,
                           device=states[0].w.device)
    if shuffle:
        data = data[rng.permutation(key, data.shape[0]).to(data.device)]
    nb = data.shape[0] // batch_size
    losses = []
    for b in range(nb):
        bkey = rng.fold_in(key, b)
        v = data[b * batch_size:(b + 1) * batch_size]
        lb = []
        for i, st in enumerate(states):
            st, loss = _tp_update(mesh, st, rng.fold_in(bkey, i), v, lr=lr,
                                  mom=mom, weight_decay=weight_decay, cd=cd,
                                  sparsity=bool(sparsity_flags[i]),
                                  sparsity_factor=sparsity_factor)
            v = _columns_whole(mesh, rbm_ops.hidden_probs(st, v), st.col0,
                               st.hidden)
            states[i] = st
            lb.append(loss)
        losses.append(torch.stack(lb))
    if not losses:
        return states, torch.zeros((0, len(states)), device=data.device)
    return states, torch.stack(losses)


def gather_state(state: rbm_ops.RBMState) -> rbm_ops.RBMState:
    """The whole state from a column-split one (every process of the model
    group calls it); a whole state comes back as it is."""
    if not isinstance(state, ShardedState):
        return rbm_ops.RBMState(*(getattr(state, f.name) for f in
                                  dataclasses.fields(rbm_ops.RBMState)))
    mesh, c0, H = state.mesh, state.col0, state.hidden

    def whole(x):
        if x.ndim == 1:
            return _columns_whole(mesh, x[None, :], c0, H)[0]
        return _columns_whole(mesh, x, c0, H)

    return rbm_ops.RBMState(w=whole(state.w), hb=whole(state.hb),
                            vb=state.vb, w_m=whole(state.w_m),
                            hb_m=whole(state.hb_m), vb_m=state.vb_m)
