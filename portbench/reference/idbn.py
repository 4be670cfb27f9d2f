"""Reference of the image iDBN's training epoch: every layer updated on
every batch by sampled CD-k, layer i + 1 fed the hidden probabilities of
the updated layer i; the epoch's rows permuted by its key, its full
batches in order (batch b keyed ``fold_in(key, b)``, layer i
``fold_in(batch key, i)``), then the remainder rows keyed
``fold_in(key, 987)``."""

from __future__ import annotations

from typing import List, Tuple

import torch

from portbench.reference import keys
from portbench.reference.rbm import Arith, State, cd_update, hidden_probs

REMAINDER_TAG = 987


def batch_step(ar: Arith, layers: List[State], key: int, v: torch.Tensor,
               *, lr: float, mom: float, wd: float, cd: int
               ) -> Tuple[List[State], List[float]]:
    """All layers' CD updates on one batch; returns (layers, the loss of
    each layer)."""
    out, losses = [], []
    for i, st in enumerate(layers):
        st, loss = cd_update(ar, st, keys.fold_in(key, i), v, lr=lr,
                             mom=mom, wd=wd, cd=cd)
        v = hidden_probs(ar, st, v)
        out.append(st)
        losses.append(float(loss))
    return out, losses


def epoch(ar: Arith, layers: List[State], data: torch.Tensor,
          epoch_key: int, *, lr: float, mom: float, wd: float, cd: int,
          batch: int) -> Tuple[List[State], float]:
    """One epoch; returns (layers, mean loss over the (batch, layer)
    entries, the remainder batch counted as one)."""
    n = data.shape[0]
    perm = keys.permutation(epoch_key, n).to(data.device)
    data = data.index_select(0, perm)
    nb = n // batch
    total = 0.0
    for b in range(nb):
        layers, s = batch_step(ar, layers, keys.fold_in(epoch_key, b),
                               data[b * batch:(b + 1) * batch], lr=lr,
                               mom=mom, wd=wd, cd=cd)
        total += sum(s)
    if n > nb * batch:
        layers, s = batch_step(ar, layers,
                               keys.fold_in(epoch_key, REMAINDER_TAG),
                               data[nb * batch:], lr=lr, mom=mom, wd=wd,
                               cd=cd)
        total += sum(s)
    return layers, total / (-(-n // batch) * len(layers))
