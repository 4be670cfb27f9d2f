"""A plain reference of the multimodal DBN's modality pathways for the CPU
tests: CD-k of a stack whose bottom RBM has Gaussian visible units (sigma
1) or replicated-softmax ones (Salakhutdinov & Hinton, NIPS 2009), the
Bernoulli RBMs above it, the iterative schedule (every layer on every
batch, layer i + 1 fed the p(h|v) of the updated layer i) and the epoch's
order of batches. fp32, TF32 off; it imports no JAX and nothing of the
port, and draws through the frozen key arithmetic of
``portbench/reference/keys.py`` (the benchmark keeps its own copy of this
reference, ``portbench/reference/mdbn.py``; a test holds the two equal).

Equations (Srivastava & Salakhutdinov, JMLR 15, 2014):
- Gaussian: p(h=1|v) = sigmoid(v·W + a); v | h ~ N(b + h·Wᵀ, 1).
- Replicated softmax, D = Σ_k v̂_k: p(h=1|v̂) = sigmoid(v̂·W + D·a);
  v̂ | h ~ Multinomial(D, softmax(b + h·Wᵀ)); the hidden bias's gradient
  is D·h.
Departures from the paper: all layers train on every batch, not greedily
layer by layer; the bottom layer's rate is the others' times a factor."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import keys

Params = Dict[str, torch.Tensor]


def _bernoulli(logits: torch.Tensor, u: torch.Tensor):
    p = torch.sigmoid(logits)
    return p, (p > u).float()


def _momentum_step(st: Params, grads, lr, mom, wd) -> Params:
    dw, dh, dv = grads
    out = dict(st)
    out["w_m"] = mom * st["w_m"] + lr * (dw - wd * st["w"])
    out["hb_m"] = mom * st["hb_m"] + lr * dh
    out["vb_m"] = mom * st["vb_m"] + lr * dv
    for f in ("w", "hb", "vb"):
        out[f] = st[f] + out[f + "_m"]
    return out


def _draws(key: int, cd: int, B: int, V: int, H: int, words: int):
    """Per half-step j the key fold_in(key, j): the up passes' uniforms
    [cd + 1, B, H], the down passes' keys."""
    ks = [keys.fold_in(key, j) for j in range(1 + 2 * cd)]
    up = torch.stack([keys.uniform(k, B, H) for k in ks[0::2]])
    return up, ks[1::2]


def bernoulli_cd(st: Params, key: int, v0: torch.Tensor, *, lr, mom, wd,
                 cd: int) -> Tuple[Params, float]:
    B, (V, H) = v0.shape[0], st["w"].shape
    up, down = _draws(key, cd, B, V, H, 0)
    ph0, h = _bernoulli(v0 @ st["w"] + st["hb"], up[0])
    for s in range(cd):
        pv, v = _bernoulli(h @ st["w"].T + st["vb"],
                           keys.uniform(down[s], B, V))
        ph, h = _bernoulli(v @ st["w"] + st["hb"], up[s + 1])
    grads = ((v0.T @ ph0 - v.T @ ph) / B, (ph0.sum(0) - ph.sum(0)) / B,
             (v0.sum(0) - v.sum(0)) / B)
    return (_momentum_step(st, grads, lr, mom, wd),
            float(((v0 - pv) ** 2).mean()))


def gaussian_cd(st: Params, key: int, v0: torch.Tensor, *, lr, mom, wd,
                cd: int) -> Tuple[Params, float]:
    B, (V, H) = v0.shape[0], st["w"].shape
    up, down = _draws(key, cd, B, V, H, 0)
    ph0, h = _bernoulli(v0 @ st["w"] + st["hb"], up[0])
    for s in range(cd):
        mean = h @ st["w"].T + st["vb"]
        v = mean + keys.normal_steps(down[s], B, V, 1, stream=0)[0]
        ph, h = _bernoulli(v @ st["w"] + st["hb"], up[s + 1])
    grads = ((v0.T @ ph0 - v.T @ ph) / B, (ph0.sum(0) - ph.sum(0)) / B,
             (v0.sum(0) - v.sum(0)) / B)
    return (_momentum_step(st, grads, lr, mom, wd),
            float(((v0 - mean) ** 2).mean()))


def multinomial(logits: torch.Tensor, D: torch.Tensor, key: int):
    """(counts, D·softmax): word j of row r the least word whose
    cumulative weight exceeds u(r, j) times the total."""
    e = torch.exp(logits - logits.max(1, keepdim=True).values)
    cdf = e.cumsum(1)
    n = int(D.max())
    u = keys.uniform(key, logits.shape[0], n)
    counts = torch.zeros_like(logits)
    for r in range(logits.shape[0]):
        for j in range(int(D[r])):
            k = int(torch.searchsorted(cdf[r], u[r, j] * cdf[r, -1],
                                       right=True))
            counts[r, min(k, logits.shape[1] - 1)] += 1
    return counts, D[:, None] * e / cdf[:, -1:]


def softmax_cd(st: Params, key: int, v0: torch.Tensor, *, lr, mom, wd,
               cd: int) -> Tuple[Params, float]:
    B, (V, H) = v0.shape[0], st["w"].shape
    D = v0.sum(1)
    up, down = _draws(key, cd, B, V, H, 0)
    ph0, h = _bernoulli(v0 @ st["w"] + D[:, None] * st["hb"], up[0])
    for s in range(cd):
        v, mean = multinomial(h @ st["w"].T + st["vb"], D, down[s])
        ph, h = _bernoulli(v @ st["w"] + D[:, None] * st["hb"], up[s + 1])
    grads = ((v0.T @ ph0 - v.T @ ph) / B, (D @ ph0 - D @ ph) / B,
             (v0.sum(0) - v.sum(0)) / B)
    return (_momentum_step(st, grads, lr, mom, wd),
            float(((v0 - mean) ** 2).mean()))


UPDATES = {"bernoulli": bernoulli_cd, "gaussian": gaussian_cd,
           "replicated_softmax": softmax_cd}


def up_pass(st: Params, v: torch.Tensor, visible: str) -> torch.Tensor:
    bias = st["hb"] * (v.sum(1, keepdim=True)
                       if visible == "replicated_softmax" else 1.0)
    return torch.sigmoid(v @ st["w"] + bias)


def step(layers: List[Params], key: int, v: torch.Tensor, *, visible: str,
         lr: float, mom: float, wd: float, cd: int, lr_scale: float = 1.0
         ) -> Tuple[List[Params], List[float]]:
    out, losses = [], []
    for i, st in enumerate(layers):
        kind = visible if i == 0 else "bernoulli"
        st, loss = UPDATES[kind](st, keys.fold_in(key, i), v,
                                 lr=lr * (lr_scale if i == 0 else 1.0),
                                 mom=mom, wd=wd, cd=cd)
        v = up_pass(st, v, kind)
        out.append(st)
        losses.append(loss)
    return out, losses


def epoch(layers: List[Params], data: torch.Tensor, epoch_key: int, *,
          batch: int, **kw) -> Tuple[List[Params], float]:
    n = data.shape[0]
    data = data[keys.permutation(epoch_key, n)]
    starts = list(range(0, n - n % batch, batch))
    total = 0.0
    for b, s in enumerate(starts):
        layers, ls = step(layers, keys.fold_in(epoch_key, b),
                          data[s:s + batch], **kw)
        total += sum(ls)
    if n % batch:
        layers, ls = step(layers, keys.fold_in(epoch_key, 987),
                          data[n - n % batch:], **kw)
        total += sum(ls)
    return layers, total / (-(-n // batch) * len(layers))
