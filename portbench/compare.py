"""The numbers that decide ``correct``, and their judgement.

A training cell compares, against the reference run on the same inputs:
- ``loss_gap``: the worst over the first steps of |loss − reference's| /
  |reference's|;
- ``grad_gap``: the first gradient as the optimizer holds it (its
  momentum buffers after step 1), by the worst leaf;
- ``change_gap``: the change of the parameters over the first steps, by
  the worst leaf;
- ``grad_gap_median`` and ``change_gap_median``: the same by the median
  leaf, steadier where one small leaf's noise sets the worst.
A leaf's gap is |‖program‖ − ‖reference‖| / max(‖reference‖, the median
leaf's ‖reference‖): the gap of the norms, not the norm of the
difference. Leaves whose first gradient in the reference is under a
thousandth of the median leaf's are left out of both.

Sampled CD turns the first Bernoulli draw that rounding flips into
another realisation of the same training, so numbers taken over epochs
read a precision change as sampling noise. The ``step_*`` numbers are
taken where no draw has had room to grow: one batch step of the window's
body from the state the program left, the reference started from that
same state (``step_numbers``).

A limit file (``checks/<workload>.json``) maps each compared number to its
limit; numbers not in it are printed with their value alone."""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CHECKS = Path(__file__).resolve().parent / "checks"
ZERO_GRADIENT_SHARE = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def kept_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding."""
    norms = {k: _norm(v) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= ZERO_GRADIENT_SHARE * med]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap of the norms, against the larger of its reference
    norm and the median leaf's."""
    leaves = list(leaves)
    ref_n = {k: _norm(ref[k]) for k in leaves}
    med = statistics.median(ref_n.values())
    out = {}
    for k in leaves:
        gap = abs(_norm(prog[k]) - ref_n[k]) / max(ref_n[k], med, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def loss_gap(prog: List[float], ref: List[float]) -> float:
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (one per step),
    ``grads`` (leaf → momentum after step 1) and ``change`` (leaf →
    parameters after the steps minus before); the leaves of ``grads``
    are named ``<param leaf>_m``. Where both hold ``metrics`` (the
    epoch's metric sums of each step), ``metric_gap`` is their worst
    relative gap."""
    kept_g = kept_leaves(ref["grads"])
    kept_p = [k[:-2] for k in kept_g]
    grads = leaf_gaps(prog["grads"], ref["grads"], kept_g)
    change = leaf_gaps(prog["change"], ref["change"], kept_p)
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "grad_gap": max(grads.values()),
           "grad_gap_median": statistics.median(grads.values()),
           "change_gap": max(change.values()),
           "change_gap_median": statistics.median(change.values())}
    if "metrics" in ref:
        out["metric_gap"] = loss_gap(
            [x for m in prog["metrics"] for x in m],
            [x for m in ref["metrics"] for x in m])
    return out


def diff_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Iterable[str]) -> Dict[str, float]:
    """Each leaf's ‖program − reference‖, against the larger of its
    reference norm and the median leaf's."""
    leaves = list(leaves)
    ref_n = {k: _norm(ref[k]) for k in leaves}
    med = statistics.median(ref_n.values())
    out = {}
    for k in leaves:
        gap = _norm(prog[k] - ref[k]) / max(ref_n[k], med, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def step_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """One batch step from one state on both sides. ``prog`` and ``ref``
    each hold ``losses`` (the step's losses) and ``change`` (leaf →
    parameters after the step minus before); leaves whose reference
    change is under a thousandth of the median leaf's are left out.
    ``step_loss_gap``: the worst relative gap of the losses;
    ``step_change_gap``: the worst leaf's gap of the norms of the change;
    ``step_change_diff``: the worst leaf's norm of the difference of the
    changes. Where both hold ``metrics``, ``step_metric_gap`` is their
    worst relative gap."""
    kept = kept_leaves(ref["change"])
    out = {"step_loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "step_change_gap": max(leaf_gaps(prog["change"], ref["change"],
                                            kept).values()),
           "step_change_diff": max(diff_gaps(prog["change"], ref["change"],
                                             kept).values())}
    if "metrics" in ref:
        out["step_metric_gap"] = loss_gap(prog["metrics"], ref["metrics"])
    return out


def limits(workload: str) -> Dict[str, float]:
    path = CHECKS / f"{workload}.json"
    return json.loads(path.read_text())["limits"]


def judge(numbers: Dict[str, float], lims: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(every limited number within its limit, the checks as printed):
    each number with its value and, where it has one, its limit. A
    limited number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        entry = {"value": value}
        if name in lims:
            entry["limit"] = lims[name]
            if not (math.isfinite(value) and value <= lims[name]):
                ok = False
        checks[name] = entry
    for name in lims:
        if name not in numbers:
            ok = False
            checks[name] = {"value": None, "limit": lims[name]}
    return ok, checks
