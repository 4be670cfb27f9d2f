"""Reference of the multimodal DBN's modality pathways (Srivastava &
Salakhutdinov, "Multimodal Learning with Deep Boltzmann Machines", JMLR 15,
2014; the DBN variant): a stack whose bottom RBM has Gaussian visible units
(image features) or replicated-softmax ones (word counts, Salakhutdinov &
Hinton, NIPS 2009), Bernoulli units above, trained by sampled CD-k.

With sigma = 1 (the data standardised per dimension):
- Gaussian: p(h=1|v) = sigmoid(v·W + a); v | h ~ N(b + h·Wᵀ, 1).
- Replicated softmax, D = the row's words: p(h=1|v̂) = sigmoid(v̂·W + D·a);
  v̂ | h ~ Multinomial(D, softmax(b + h·Wᵀ)); the hidden bias's statistic
  is D·h.

The chain draws its v (Gaussian noise, or the row's D words by inverse CDF
of the softmax) and its h; the negative statistics come from the last
drawn v and h probabilities; the loss is the mean squared error of the data
against the last step's mean (the Gaussian's mean, the expected counts).

Departures from the paper: every layer is updated on every batch, layer
i + 1 fed the p(h|v) of the updated layer i (the repository's iterative
schedule), not greedily layer by layer; the bottom layer's learning rate is
the others' times ``lr_scale``; momentum and weight decay are the
repository's. Draws: per layer ``fold_in(batch key, i)``, then per half-step
``fold_in(layer key, j)``: the uniforms and normals of ``keys`` at the
counter (row, column) of stream 0; word j of a row the uniform at (row,
j)."""

from __future__ import annotations

from typing import List, Tuple

import torch

from portbench.reference import keys
from portbench.reference.rbm import (Arith, State, apply_update, cd_update,
                                     half_step, hidden_probs)

BERNOULLI, GAUSSIAN, REPLICATED_SOFTMAX = ("bernoulli", "gaussian",
                                           "replicated_softmax")
REMAINDER_TAG = 987


def rs_draw(logits: torch.Tensor, words: torch.Tensor, u: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts, expected counts): ``words[r]`` draws from
    ``softmax(logits[r])``, draw j the least word whose cumulative weight
    exceeds ``u[r, j]`` times the total."""
    e = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
    cdf = torch.cumsum(e, dim=1)
    total = cdf[:, -1:]
    k = torch.searchsorted(cdf.contiguous(), (u * total).contiguous(),
                           right=True).clamp(max=logits.shape[1] - 1)
    take = (torch.arange(u.shape[1], device=u.device)[None, :]
            < words[:, None]).float()
    counts = torch.zeros_like(logits).scatter_add(1, k, take)
    return counts, words[:, None] * (e / total)


def gaussian_cd_update(ar: Arith, st: State, key: int, data: torch.Tensor,
                       *, lr: float, mom: float, wd: float, cd: int
                       ) -> Tuple[State, torch.Tensor]:
    """One CD-k update of a Gaussian-visible RBM; returns (state, loss)."""
    data = ar.rows(data)
    seeds = [keys.fold_in(key, i) for i in range(1 + 2 * cd)]
    w, hb, vb = st["w"], st["hb"], st["vb"]
    (V, H), B, dev = w.shape, data.shape[0], data.device
    uh = keys.uniform_stack(seeds[0::2], B, H, device=dev)
    pos_h, h = half_step(ar, data, w, hb, uh[0])
    for s in range(cd):
        v_mean = ar.mm(h, w.T) + vb
        v = v_mean + keys.normal_steps(seeds[1 + 2 * s], B, V, 1, stream=0,
                                       device=dev)[0]
        h_prob, h = half_step(ar, v, w, hb, uh[s + 1])
    new = apply_update(st, ar.mm(data.T, pos_h), ar.mm(v.T, h_prob),
                       pos_h.sum(0), h_prob.sum(0), data.sum(0), v.sum(0),
                       lr=lr, mom=mom, wd=wd, bsz=B)
    return ar.updated(st, new), torch.mean(torch.square(data - v_mean))


def rsm_hidden(ar: Arith, st: State, v: torch.Tensor) -> torch.Tensor:
    """p(h=1|v̂) of a replicated-softmax RBM."""
    return torch.sigmoid(ar.mm(v, st["w"]) + v.sum(1, keepdim=True)
                         * st["hb"])


def rsm_cd_update(ar: Arith, st: State, key: int, data: torch.Tensor, *,
                  lr: float, mom: float, wd: float, cd: int
                  ) -> Tuple[State, torch.Tensor]:
    """One CD-k update of a replicated-softmax RBM; returns (state,
    loss)."""
    data = ar.rows(data)
    seeds = [keys.fold_in(key, i) for i in range(1 + 2 * cd)]
    w, hb, vb = st["w"], st["hb"], st["vb"]
    (V, H), B, dev = w.shape, data.shape[0], data.device
    words = data.sum(1)
    n = max(1, int(words.max()))
    uh = keys.uniform_stack(seeds[0::2], B, H, device=dev)
    uw = keys.uniform_stack(seeds[1::2], B, n, device=dev)

    def up(v, u):
        p = torch.sigmoid(ar.mm(v, w) + words[:, None] * hb)
        return p, (p > u).float()

    pos_h, h = up(data, uh[0])
    for s in range(cd):
        v, v_mean = rs_draw(ar.mm(h, w.T) + vb, words, uw[s])
        h_prob, h = up(v, uh[s + 1])
    new = apply_update(st, ar.mm(data.T, pos_h), ar.mm(v.T, h_prob),
                       ar.mm(words[None], pos_h)[0],
                       ar.mm(words[None], h_prob)[0], data.sum(0), v.sum(0),
                       lr=lr, mom=mom, wd=wd, bsz=B)
    return ar.updated(st, new), torch.mean(torch.square(data - v_mean))


def batch_step(ar: Arith, layers: List[State], key: int, v: torch.Tensor,
               *, lr: float, mom: float, wd: float, cd: int, visible: str,
               lr_scale: float = 1.0) -> Tuple[List[State], List[float]]:
    """All layers' CD updates on one batch, layer 0 of unit type
    ``visible``; returns (layers, the loss of each layer)."""
    out, losses = [], []
    for i, st in enumerate(layers):
        k = keys.fold_in(key, i)
        if i == 0 and visible == GAUSSIAN:
            st, loss = gaussian_cd_update(ar, st, k, v, lr=lr * lr_scale,
                                          mom=mom, wd=wd, cd=cd)
            v = hidden_probs(ar, st, v)
        elif i == 0 and visible == REPLICATED_SOFTMAX:
            st, loss = rsm_cd_update(ar, st, k, v, lr=lr * lr_scale,
                                     mom=mom, wd=wd, cd=cd)
            v = rsm_hidden(ar, st, v)
        elif i == 0 and visible != BERNOULLI:
            raise ValueError(f"unknown visible unit type {visible!r}")
        else:
            st, loss = cd_update(ar, st, k, v, lr=lr, mom=mom, wd=wd, cd=cd)
            v = hidden_probs(ar, st, v)
        out.append(st)
        losses.append(float(loss))
    return out, losses


def epoch(ar: Arith, layers: List[State], data: torch.Tensor,
          epoch_key: int, *, lr: float, mom: float, wd: float, cd: int,
          batch: int, visible: str, lr_scale: float = 1.0
          ) -> Tuple[List[State], float]:
    """One epoch: the rows permuted by the key, the full batches in order
    (batch b keyed ``fold_in(key, b)``), then the remainder rows keyed
    ``fold_in(key, 987)``; returns (layers, mean loss over the (batch,
    layer) entries)."""
    n = data.shape[0]
    data = data.index_select(0, keys.permutation(epoch_key, n).to(
        data.device))
    nb = n // batch
    total = 0.0
    kw = dict(lr=lr, mom=mom, wd=wd, cd=cd, visible=visible,
              lr_scale=lr_scale)
    for b in range(nb):
        layers, s = batch_step(ar, layers, keys.fold_in(epoch_key, b),
                               data[b * batch:(b + 1) * batch], **kw)
        total += sum(s)
    if n > nb * batch:
        layers, s = batch_step(ar, layers,
                               keys.fold_in(epoch_key, REMAINDER_TAG),
                               data[nb * batch:], **kw)
        total += sum(s)
    return layers, total / (-(-n // batch) * len(layers))
