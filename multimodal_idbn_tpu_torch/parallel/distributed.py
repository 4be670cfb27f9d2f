"""Process-group initialization: the entry to multi-process training.

Port of multimodal_idbn_tpu/parallel/distributed.py. The JAX package runs
one controller per host and ``jax.distributed.initialize`` joins the hosts;
the port runs one process per device, as PyTorch does, and
``initialize_distributed`` joins the processes into one
``torch.distributed`` group, on which ``parallel.make_mesh`` builds the
data mesh. Usage, one call per process before any mesh is made::

    from multimodal_idbn_tpu_torch.parallel import initialize_distributed
    initialize_distributed()      # under torchrun: RANK, WORLD_SIZE, ...
    initialize_distributed("tcp://localhost:29500", 2, rank)  # explicit
    initialize_distributed("file:///path/store", 2, rank, backend="gloo")

The backend is ``nccl`` when the process has a CUDA device and ``gloo``
otherwise, unless ``backend`` names one. NCCL refuses two processes on one
card; ``gloo`` takes the all-reduces and broadcasts of CUDA tensors too, so
two ranks that share a card pass ``backend="gloo"``. The mesh records the
backend it runs on (``Mesh.backend``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout_s: Optional[float] = None, *,
                           backend: Optional[str] = None) -> bool:
    """Join this process to the job's process group; idempotent.

    Returns True if the group is active after the call. With no arguments
    it joins a launcher's group (``torchrun`` sets ``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR``), or returns False when there is
    none: a single-process run. With an explicit ``coordinator_address``
    (``host:port``, or a ``tcp://`` / ``file://`` URL) ``num_processes``
    and ``process_id`` are required and a failure raises: the caller said
    the process belongs to a job, and a standalone run would diverge from
    it. The call blocks until every process has joined, or ``timeout_s``
    has passed (JAX distributed.py:28-85).
    """
    if dist.is_initialized():
        return True
    backend = backend or default_backend()
    timeout = (None if timeout_s is None
               else datetime.timedelta(seconds=float(timeout_s)))
    if coordinator_address is None:
        if not all(k in os.environ for k in _LAUNCHER_ENV):
            return False
        rank = int(os.environ["RANK"])
        kwargs = dict(init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs "
                             "num_processes and process_id")
        rank = int(process_id)
        url = str(coordinator_address)
        kwargs = dict(init_method=url if "://" in url else f"tcp://{url}",
                      world_size=int(num_processes), rank=rank)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(backend, **kwargs)
    return True


def is_multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_rank_and_count():
    """(rank, number of processes) of the group, (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main_process() -> bool:
    """True on rank 0, or without a group: the process that prints the
    summary and writes the files of a run."""
    return process_rank_and_count()[0] == 0


def local_batch_slice(global_batch: int) -> slice:
    """The [start, stop) rows of a globally ordered batch that this
    process trains on (an equal split by rank; ``global_batch`` must
    divide evenly, JAX distributed.py:88-101)."""
    i, n = process_rank_and_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
