"""Launches, operations and bytes of the modality cells' kernels, counted
once from the shapes (``counts.py``'s rules), by entry and body.

A stack's layer 0 may be Gaussian or replicated softmax
(``configs/mdbn-flickr.json``); its half-steps then take the entries of
that unit type, and a replicated-softmax layer draws its words once a
chain step (``rs_sample``). Every launch's body is the one the program's
plan documents: ``wgmma`` where the operand's rows are 16-byte aligned
(K and N multiples of 4) and B <= 128, else ``mma_sync``."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from portbench.counts import (F32, PEAK_HBM_BYTES_PER_S, PEAK_TF32_FLOPS,
                              batch_sizes, mm_flops)

Launch = Tuple[str, int, int, int]   # (entry, B, K, N)
UP = {"bernoulli": "half_step_sample", "gaussian": "half_step_sample",
      "replicated_softmax": "half_step_scaled"}
DOWN = {"bernoulli": "half_step_sample", "gaussian": "half_step_gauss",
        "replicated_softmax": "half_step_linear"}
OUTPUTS = {"half_step_sample": 2, "half_step_gauss": 2,
           "half_step_scaled": 2, "half_step_linear": 1}


def body(B: int, K: int, N: int) -> str:
    return "wgmma" if B <= 128 and K % 4 == 0 and N % 4 == 0 else "mma_sync"


def stack_launches(sizes: Sequence[int], visible: str, cd: int, n: int,
                   batch: int) -> Tuple[List[Launch], List[Tuple[int, int]]]:
    """(half-step launches, word draws [B, V]) of one epoch of a stack
    whose layer 0 is of type ``visible``: per batch and layer 1 + cd
    upward ([B, V]·[V, H]) and cd downward; the draws of a
    replicated-softmax layer 0 once a step."""
    half, words = [], []
    for B in batch_sizes(n, batch):
        for i, (V, H) in enumerate(zip(sizes[:-1], sizes[1:])):
            kind = visible if i == 0 else "bernoulli"
            half += [(UP[kind], B, V, H)] * (1 + cd) \
                + [(DOWN[kind], B, H, V)] * cd
            if kind == "replicated_softmax":
                words += [(B, V)] * cd
    return half, words


def half_step_bound_s(entry: str, B: int, K: int, N: int) -> float:
    """Least seconds of one half-step launch: its product over the TF32
    peak or its bytes (x, W, b, the row scale, the outputs) over HBM."""
    ops = mm_flops(B, K, N) / PEAK_TF32_FLOPS
    moved = F32 * (B * K + K * N + N + OUTPUTS[entry] * B * N
                   + (B if entry == "half_step_scaled" else 0))
    return max(ops, moved / PEAK_HBM_BYTES_PER_S)


def rs_sample_bound_s(B: int, V: int) -> float:
    """Least seconds of one word draw: the logits and words read, the
    counts and their expectation written, once each, over HBM."""
    return F32 * (B * V + B + 2 * B * V) / PEAK_HBM_BYTES_PER_S


def expected_launches(half: Sequence[Launch], words: Sequence) -> dict:
    """The launch counts the program should report: per entry, per body
    (``body:<name>``) and ``rs_sample``."""
    out = {"rs_sample": len(words)}
    for entry, B, K, N in half:
        out[entry] = out.get(entry, 0) + 1
        key = f"body:{body(B, K, N)}"
        out[key] = out.get(key, 0) + 1
    return out
