"""Plain PyTorch RBM arithmetic of the reference: products, half-steps,
the CD-k update and the momentum-then-apply step, in float32 with TF32
off.

``precision`` "tf32" is the control: every operand of a product is
rounded to TF32 (10 mantissa bits) before an fp32 product, the arithmetic
of a TF32 tensor-core pass, on any device. ``fault`` plants a fault of the
timed path in the reference: "half_batch" trains each update on the first
half of its rows, the mean taken over them; "unchanged" returns every
update's state as it was given (its loss still computed)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.reference import keys

State = Dict[str, torch.Tensor]
FIELDS = ("w", "hb", "vb", "w_m", "hb_m", "vb_m")


class Arith:
    """How the reference computes: ``precision`` "fp32" or "tf32",
    ``fault`` None or "half_batch"."""

    def __init__(self, precision: str = "fp32", fault=None):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        if fault not in (None, "half_batch", "unchanged"):
            raise ValueError(f"unknown fault {fault!r}")
        self.precision = precision
        self.fault = fault

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            a, b = to_tf32(a), to_tf32(b)
        return a @ b

    def updated(self, old: State, new: State) -> State:
        """The state an update hands on."""
        return old if self.fault == "unchanged" else new

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rows an update trains on."""
        if self.fault == "half_batch":
            return x[: max(1, x.shape[0] // 2)]
        return x


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def fp32_products() -> None:
    """True fp32 products: the reference never runs a TF32 pass."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def clone(st: State) -> State:
    return {k: v.clone() for k, v in st.items()}


def half_step(ar: Arith, x, w, b, u: torch.Tensor, transpose: bool = False):
    """(probs, Bernoulli sample against the uniforms ``u``) of
    ``x·W[ᵀ] + b``."""
    p = torch.sigmoid(ar.mm(x, w.T if transpose else w) + b)
    return p, (p > u).float()


def hidden_probs(ar: Arith, st: State, v: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(ar.mm(v, st["w"]) + st["hb"])


def visible_probs(ar: Arith, st: State, h: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(ar.mm(h, st["w"].T) + st["vb"])


def apply_update(st: State, pos, neg, pos_h_sum, neg_h_sum, data_sum,
                 v_sum, *, lr: float, mom: float, wd: float,
                 bsz: int) -> State:
    """Momentum buffer first, then the parameters."""
    w_m = mom * st["w_m"] + lr * ((pos - neg) / bsz - wd * st["w"])
    hb_m = mom * st["hb_m"] + lr * (pos_h_sum - neg_h_sum) / bsz
    vb_m = mom * st["vb_m"] + lr * (data_sum - v_sum) / bsz
    return dict(w=st["w"] + w_m, hb=st["hb"] + hb_m, vb=st["vb"] + vb_m,
                w_m=w_m, hb_m=hb_m, vb_m=vb_m)


def cd_update(ar: Arith, st: State, key: int, data: torch.Tensor, *,
              lr: float, mom: float, wd: float, cd: int
              ) -> Tuple[State, torch.Tensor]:
    """One sampled CD-k update of a groupless RBM: positive phase and
    chain start, then per step v (probabilities and sample) and h; the
    negative statistics from the last sampled v and h probabilities.
    Returns (state, mean squared error of the data against the last
    visible probabilities)."""
    data = ar.rows(data)
    seeds = [keys.fold_in(key, i) for i in range(1 + 2 * cd)]
    w, hb, vb = st["w"], st["hb"], st["vb"]
    (V, H), B, dev = w.shape, data.shape[0], data.device
    uh = keys.uniform_stack(seeds[0::2], B, H, device=dev)
    uv = keys.uniform_stack(seeds[1::2], B, V, device=dev)
    pos_h, h = half_step(ar, data, w, hb, uh[0])
    for s in range(cd):
        v_prob, v = half_step(ar, h, w, vb, uv[s], True)
        h_prob, h = half_step(ar, v, w, hb, uh[s + 1])
    new = apply_update(st, ar.mm(data.T, pos_h), ar.mm(v.T, h_prob),
                       pos_h.sum(0), h_prob.sum(0), data.sum(0), v.sum(0),
                       lr=lr, mom=mom, wd=wd, bsz=data.shape[0])
    return ar.updated(st, new), torch.mean(torch.square(data - v_prob))
