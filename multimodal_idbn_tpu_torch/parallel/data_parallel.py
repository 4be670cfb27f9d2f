"""Data-parallel RBM/DBN training: one process per device, the batch split.

Port of multimodal_idbn_tpu/parallel/data_parallel.py. There one
controller shards the batch axis over a 1-D device mesh and XLA inserts
the all-reduce of every batch contraction. Here, in PyTorch's idiom, every
device has a process of its own, all in one ``torch.distributed`` group
(``initialize_distributed``), and a ``Mesh`` is that group:

- every process holds the whole data and the same parameters (its
  replica), computes the same permutation from the epoch key, and trains
  on its rows of each full batch (``ops.shard.rows_of``);
- every update sums its batch statistics and loss over the group before it
  is applied (``ops.shard.reduce_update``), so the replicas stay equal bit
  for bit; the cross-metric sums are summed once an epoch;
- the draws do not depend on the split: each element gets the number a
  single device draws for it, and the kernels sum every row's products in
  the single-device order. Results agree with one device up to the order
  of the cross-process sums, and a one-process mesh gives the
  single-device bits;
- the remainder batch of an epoch runs whole on every process, nothing
  summed (JAX models/idbn.py:265-269).

The ``dp_*`` functions take the arguments of their JAX namesakes (the
mesh first, the whole batch or dataset on every process) and run the
port's epoch functions with the mesh (``ops.dbn_train``, ``ops.imdbn_ops``,
``ops.bimodal_ops``). A process group over one card runs too: two
processes share it over ``gloo``, which is how a one-card machine checks
that two ranks train to the one-rank result.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_idbn_tpu_torch.device import DeviceLike, resolve_device
from multimodal_idbn_tpu_torch.ops import (bimodal_ops, dbn_train, fast_cd,
                                           imdbn_ops, rbm_ops, shard)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D data mesh: ``size`` processes of ``group`` (None for a mesh
    of this process alone, without a process group), this process's
    ``rank``, its ``device`` and the group's ``backend``."""

    group: Any
    size: int
    rank: int
    device: torch.device
    backend: Optional[str]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def shape(self):
        return {self.axis_names[0]: self.size}

    # the data axis, as ops.shard reads it from a 1-D or 2-D mesh
    @property
    def data_group(self):
        return self.group

    @property
    def data_size(self) -> int:
        return self.size

    @property
    def data_rank(self) -> int:
        return self.rank


def mesh_device(device: DeviceLike = None) -> torch.device:
    """This process's device in a mesh: the caller's (the model's device,
    or an explicit one), ``cuda`` (the current card) unless the CPU is
    asked for; without a GPU a CUDA request raises, as every entry point
    of the port does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device: DeviceLike = None) -> Mesh:
    """The 1-D mesh over the process group (default: every process; JAX
    data_parallel.py:40-51). Each process is one device, so the mesh spans
    the whole group: more devices than processes raises, as JAX's "have
    M" does, and so does a count below the group's size. Without a group
    the mesh is this process alone. ``device``: this process's device
    (``mesh_device``)."""
    if dist.is_initialized():
        have, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        have, rank, group, backend = 1, 0, None, None
    n = have if n_devices is None else int(n_devices)
    if n > have:
        raise ValueError(
            f"requested {n} devices, have {have}: run one process per "
            f"device (torchrun --nproc-per-node {n}) and join them with "
            f"initialize_distributed()")
    if n < 1 or n < have:
        raise ValueError(f"requested {n} devices, but the mesh spans every "
                         f"process of the group ({have})")
    return Mesh(group, have, rank, mesh_device(device), backend,
                (axis_name,))


def resolve_mesh(spec, device: DeviceLike = None) -> Optional[Mesh]:
    """A user-facing mesh spec as a mesh, or None: None (no data
    parallelism), a mesh (used as it is), a device count or ``"all"``;
    what ``set_mesh`` and ``params["DP_DEVICES"]`` take. A mesh made here
    lies on ``device`` (the model's)."""
    if spec is None or isinstance(spec, Mesh):
        return spec
    if isinstance(spec, str):
        if spec.lower() == "all":
            return make_mesh(device=device)
        spec = int(spec)
    return make_mesh(int(spec), device=device)


def batch_sharding(mesh: Mesh, ndim: int = 2) -> Tuple[Optional[str], ...]:
    """How a batch is split: axis 0 over the mesh's axis, the others
    whole; the PartitionSpec of JAX's ``batch_sharding`` as a tuple."""
    return (mesh.axis_names[0],) + (None,) * (ndim - 1)


def replicated(mesh: Mesh) -> Tuple[()]:
    """The split of a replicated array: no axis split (JAX's ``P()``)."""
    return ()


def pad_to_multiple(x, multiple: int):
    """Pad axis 0 up to a multiple of ``multiple`` by repeating the last
    row; returns (padded, original n). numpy arrays and tensors alike."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].repeat_interleave(rem, dim=0)]), n
    return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0), n


def shard_batch(mesh: Mesh, *arrays, dtype=None, trim: bool = False):
    """This process's rows of each array (axis 0 split evenly over the
    mesh), as tensors on its device. A batch axis that does not divide
    raises, or with ``trim=True`` is cut to the largest length that does."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if dtype is not None:
            t = t.to(dtype)
        n = t.shape[0]
        if n % mesh.size:
            if not trim:
                raise ValueError(
                    f"batch axis ({n}) must divide evenly across "
                    f"{mesh.size} devices; use pad_to_multiple() or "
                    f"shard_batch(trim=True)")
            n = (n // mesh.size) * mesh.size
        per = n // mesh.size
        out.append(t[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device))
    return out[0] if len(out) == 1 else tuple(out)


def _broadcast(mesh: Mesh, x):
    if isinstance(x, torch.Tensor):
        x = x.clone()
        if mesh.group is not None:
            dist.broadcast(x, src=0, group=mesh.group)
        return x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _broadcast(mesh, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(_broadcast(mesh, v) for v in x)
    return x


def replicate(mesh: Mesh, tree):
    """Every process's copy of a parameter tree (states, lists, tensors)
    made equal to rank 0's."""
    return _broadcast(mesh, tree)


def _fp32(states) -> bool:
    """The kernel route: every state stored in fp32."""
    return all(st.w.dtype == torch.float32 for st in states)


def dp_cd_update(mesh: Mesh, state: rbm_ops.RBMState, key: int, data, *,
                 lr, mom, weight_decay, cd: int, sparsity: bool = False,
                 sparsity_factor: float = 0.05, groups=()):
    """One data-parallel CD-k update on the batch ``data`` (whole on every
    process); returns (new replicated state, loss of the whole batch).
    The update of ``fast_cd.cd_update``: the half-step kernel for a
    groupless fp32 state, ``rbm_ops.cd_update`` otherwise."""
    data = torch.as_tensor(data, dtype=torch.float32, device=state.w.device)
    with shard.rows_of(mesh, data.shape[0]) as rows:
        return fast_cd.cd_update(
            state, key, data[rows], groups=tuple(groups), lr=lr, mom=mom,
            weight_decay=weight_decay, cd=cd, sparsity=sparsity,
            sparsity_factor=sparsity_factor)


def dp_idbn_epoch(mesh: Mesh, states, key: int, data, lr, mom,
                  weight_decay, sparsity_factor, *, cd: int,
                  sparsity_flags, batch_size: int, shuffle: bool = False,
                  sr=None):
    """Data-parallel iDBN epoch over the full batches of ``data``
    (``dbn_train.idbn_epoch`` with the mesh); returns (states,
    losses[nb, L])."""
    return dbn_train.idbn_epoch(
        list(states), key, data, lr=lr, mom=mom, weight_decay=weight_decay,
        sparsity_factor=sparsity_factor, cd=cd,
        sparsity_flags=tuple(sparsity_flags), batch_size=batch_size,
        shuffle=shuffle, sr=sr, fast_sampler=_fp32(states), mesh=mesh)


def dp_idbn_epoch_block(mesh: Mesh, states, epoch_key: int, data,
                        epoch_idx, lr_arr, mom_arr, weight_decay,
                        sparsity_factor, *, cd: int, sparsity_flags,
                        batch_size: int, n_epochs: int, sr=None):
    """Data-parallel iDBN epochs ``epoch_idx``, each permuted, its full
    batches split over the mesh and its remainder run whole
    (``dbn_train.idbn_epoch_block`` with the mesh); returns (states, loss
    sums[E], loss counts[E])."""
    return dbn_train.idbn_epoch_block(
        list(states), epoch_key, data, epoch_idx, lr_arr, mom_arr,
        weight_decay, sparsity_factor, cd=cd,
        sparsity_flags=tuple(sparsity_flags), batch_size=batch_size,
        n_epochs=n_epochs, sr=sr, fast_sampler=_fp32(states), mesh=mesh)


def dp_joint_epoch(mesh: Mesh, joint, idbn_states, key: int, Z, Y, IMG, lr,
                   mom, weight_decay, z_class_mean, **static):
    """Data-parallel joint epoch over the full batches
    (``imdbn_ops.joint_epoch`` with the mesh; same static arguments)."""
    return imdbn_ops.joint_epoch(joint, idbn_states, key, Z, Y, IMG, lr,
                                 mom, weight_decay, z_class_mean,
                                 mesh=mesh, **static)


def dp_joint_epoch_block(mesh: Mesh, joint, idbn_states, epoch_key: int, Z,
                         Y, IMG, epoch_idx, lr_arr, mom_arr, weight_decay,
                         z_class_mean, **static):
    """Data-parallel joint epochs ``epoch_idx``
    (``imdbn_ops.joint_epoch_block`` with the mesh)."""
    return imdbn_ops.joint_epoch_block(
        joint, idbn_states, epoch_key, Z, Y, IMG, epoch_idx, lr_arr,
        mom_arr, weight_decay, z_class_mean, mesh=mesh, **static)


def dp_bimodal_joint_epoch(mesh: Mesh, joint, mod1_states, mod2_states,
                           key: int, Z1, Z2, V1, V2, lr, mom, weight_decay,
                           **static):
    """Data-parallel bimodal joint epoch over the full batches
    (``bimodal_ops.bimodal_joint_epoch`` with the mesh)."""
    return bimodal_ops.bimodal_joint_epoch(
        joint, mod1_states, mod2_states, key, Z1, Z2, V1, V2, lr, mom,
        weight_decay, mesh=mesh, **static)


def dp_bimodal_epoch_block(mesh: Mesh, joint, mod1_states, mod2_states,
                           epoch_key: int, Z1, Z2, V1, V2, epoch_idx,
                           lr_arr, mom_arr, weight_decay, **static):
    """Data-parallel bimodal joint epochs ``epoch_idx``
    (``bimodal_ops.bimodal_epoch_block`` with the mesh)."""
    return bimodal_ops.bimodal_epoch_block(
        joint, mod1_states, mod2_states, epoch_key, Z1, Z2, V1, V2,
        epoch_idx, lr_arr, mom_arr, weight_decay, mesh=mesh, **static)
