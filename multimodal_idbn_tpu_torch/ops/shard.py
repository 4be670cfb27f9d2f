"""The rows of a data-parallel batch that this process trains on.

JAX's data parallelism (multimodal_idbn_tpu/parallel/data_parallel.py:1-15)
shards the batch axis of one program over a device mesh, and XLA inserts
the all-reduce of every batch contraction. The port runs one process per
device (``parallel.data_parallel``): each process runs the single-device
code on its rows of every batch inside ``batch_rows``, and three places
read that context:

- the draws of ``ops.rng``: every element gets the number a single device
  draws for it (the whole batch is drawn and the rank's rows kept, or
  Philox is counted from the rank's first global row);
- the callers of the kernels (``ops.fast_cd``, ``ops.rbm_ops``):
  ``kernel_rows`` gives the first global row, for the kernels' draws, and
  the whole batch's rows, for their plans, so every row's products are
  summed in the single-device order;
- the CD updates: ``reduce_update`` sums the batch statistics and the loss
  over the data group before ``rbm_ops.apply_update``, which then divides
  by the whole batch.

Outside ``batch_rows`` every function here is the identity, so
single-device results do not move. A group of one process sums nothing and
scales by 1, so its results are the single-device bits as well. Only the
cross-rank sums differ from one device, by the order of the reduction.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rows ``row0 .. row0 + rows`` of a batch of ``total`` rows, and the
    process group the batch is split over (None: a group of one process,
    nothing to sum)."""

    row0: int
    rows: int
    total: int
    group: Any = None


_STACK: List[BatchShard] = []


def split_rows(total: int, size: int, rank: int) -> Tuple[int, int]:
    """(first row, rows) of rank ``rank`` of ``size`` in a batch of
    ``total``: contiguous blocks whose sizes differ by at most one."""
    row0 = total * rank // size
    return row0, total * (rank + 1) // size - row0


@contextlib.contextmanager
def batch_rows(total: int, rank: int, size: int,
               group=None) -> Iterator[slice]:
    """Run the block as rank ``rank`` of ``size`` on a batch of ``total``
    rows; yields the slice of the batch that is this rank's."""
    row0, rows = split_rows(int(total), int(size), int(rank))
    _STACK.append(BatchShard(row0, rows, int(total), group))
    try:
        yield slice(row0, row0 + rows)
    finally:
        _STACK.pop()


def rows_of(mesh, total: int):
    """``batch_rows`` over ``mesh``'s data axis (its ``data_rank``,
    ``data_size``, ``data_group``), or, without a mesh, a block that
    yields the whole batch."""
    if mesh is None:
        return contextlib.nullcontext(slice(None))
    return batch_rows(total, mesh.data_rank, mesh.data_size,
                      mesh.data_group)


def current() -> Optional[BatchShard]:
    return _STACK[-1] if _STACK else None


def kernel_rows(rows: int) -> Tuple[int, Optional[int]]:
    """(first global row, rows of the whole batch or None) for a kernel
    launched on ``rows`` rows."""
    sh = current()
    if sh is None:
        return 0, None
    if rows != sh.rows:
        raise ValueError(f"a kernel on {rows} rows inside a batch shard of "
                         f"{sh.rows} rows")
    return sh.row0, sh.total


def all_reduce_sum(tensors: Sequence[Optional[torch.Tensor]],
                   group=None) -> List[Optional[torch.Tensor]]:
    """Elementwise sums over ``group`` of each tensor (None stays None):
    one all-reduce for each dtype, of the tensors flattened into one
    buffer. Without a group the tensors come back as they are."""
    out = list(tensors)
    if group is None:
        return out
    import torch.distributed as dist

    by_dtype = {}
    for i, t in enumerate(out):
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([out[i].reshape(-1) for i in idx])
        dist.all_reduce(buf, group=group)
        for i, part in zip(idx, buf.split([out[i].numel() for i in idx])):
            out[i] = part.view(out[i].shape)
    return out


def reduce_update(stats: Sequence[Optional[torch.Tensor]],
                  loss: torch.Tensor, bsz: int):
    """(stats, loss, bsz) of the whole batch from this rank's.

    ``stats`` are the seven arguments of ``rbm_ops.apply_update``
    (pos_assoc, neg_assoc, pos_h_sum, neg_h_sum, pos_h_mean, data_sum,
    v_sum): sums over the rows, but for ``pos_h_mean``, a mean, which like
    the loss is weighted by this rank's share of the rows before the sum.
    """
    sh = current()
    if sh is None:
        return tuple(stats), loss, bsz
    if bsz != sh.rows:
        raise ValueError(f"an update on {bsz} rows inside a batch shard of "
                         f"{sh.rows} rows")
    share = sh.rows / sh.total
    parts = list(stats)
    if parts[4] is not None:
        parts[4] = parts[4] * share
    reduced = all_reduce_sum(parts + [loss * share], sh.group)
    return tuple(reduced[:7]), reduced[7], sh.total
