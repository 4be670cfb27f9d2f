"""Operations and bytes of the work a cell does, counted once from the
shapes, and the peaks of the chip they are held against.

Each product of an [m, k] and a [k, n] operand is 2·m·k·n operations,
whatever passes a kernel makes to compute it. A kernel's bytes count
each input read once and each output written once."""

from __future__ import annotations

from typing import List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES_PER_S = 3.35e12
F32 = 4


def mm_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def half_step_bound_s(B: int, K: int, N: int) -> Tuple[float, str]:
    """(least seconds, the bound that sets it) of one sampled half-step
    ``x[B, K]·W[K, N] + b`` with probabilities and samples written."""
    ops = mm_flops(B, K, N) / PEAK_TF32_FLOPS
    moved = F32 * (B * K + K * N + N + 2 * B * N) / PEAK_HBM_BYTES_PER_S
    return (ops, "operations") if ops >= moved else (moved, "bytes")


def batch_sizes(n: int, batch: int) -> List[int]:
    """The batches of an epoch over ``n`` rows: full ones, then the
    remainder."""
    full = [batch] * (n // batch)
    return full + ([n - len(full) * batch] if n % batch else [])


def image_half_steps(sizes: Sequence[int], cd: int, n: int, batch: int
                     ) -> List[Tuple[int, int, int]]:
    """The (B, K, N) of every sampled half-step of one image epoch: per
    batch and layer 1 + cd upward ([B, V]·[V, H]) and cd downward."""
    out = []
    for B in batch_sizes(n, batch):
        for V, H in zip(sizes[:-1], sizes[1:]):
            out += [(B, V, H)] * (1 + cd) + [(B, H, V)] * cd
    return out


def image_epoch_flops(sizes: Sequence[int], cd: int, n: int, batch: int
                      ) -> float:
    """Operations of one image epoch: per batch and layer the 1 + 2·cd
    half-steps, the two products of the update's statistics and the
    hidden probabilities handed to the next layer."""
    total = 0.0
    for B in batch_sizes(n, batch):
        for V, H in zip(sizes[:-1], sizes[1:]):
            total += (1 + 2 * cd + 2 + 1) * mm_flops(B, V, H)
    return total


def chain_bound_s(B: int, V: int, H: int, steps: int, final: bool,
                  mu_cols: int = 0) -> Tuple[float, str]:
    """(least seconds, the bound that sets it) of one clamped chain
    launch: per step the products v·W and h·Wᵀ, one more pair for the
    final pass; bytes: W, the biases, the initial, known and mask rows,
    the pull targets, the schedule and the output, once each."""
    pairs = steps + (1 if final else 0)
    ops = pairs * 2 * mm_flops(B, V, H) / PEAK_TF32_FLOPS
    moved = F32 * (V * H + V + H + 4 * B * V + B * mu_cols
                   + 3 * steps) / PEAK_HBM_BYTES_PER_S
    return (ops, "operations") if ops >= moved else (moved, "bytes")


AUX_CD = 3   # the negative steps of the bimodal joint's clamped updates


def bimodal_main_epoch_flops(joint_sizes: Sequence[int],
                             mod1_sizes: Sequence[int],
                             mod2_sizes: Sequence[int], n: int, batch: int,
                             *, joint_cd: int, init_steps: int,
                             steps: int) -> float:
    """Operations of one main epoch of the bimodal joint: per batch,
    sampled CD-k on every joint layer (positive pass, two products a
    step, two for the statistics, the next layer's input); on layer 0
    two clamped updates (the noisy init's two products a step, the
    positive hidden pass, two a negative step, the negative hidden pass,
    the statistics); two cross-reconstructions (two products a step and
    a final pair) decoded through the other modality's stack."""
    V0, H0 = joint_sizes[0], joint_sizes[1]
    clamped = 2 * init_steps + 1 + 2 * AUX_CD + 1 + 2
    cross = 2 * steps + 2
    total = 0.0
    for B in batch_sizes(n, batch):
        for V, H in zip(joint_sizes[:-1], joint_sizes[1:]):
            total += (4 + 2 * joint_cd) * mm_flops(B, V, H)
        total += (2 * clamped + 2 * cross) * mm_flops(B, V0, H0)
        for sizes in (mod1_sizes, mod2_sizes):
            for V, H in zip(sizes[:-1], sizes[1:]):
                total += mm_flops(B, H, V)
    return total


def flagship_joint_epoch_flops(V: int, H: int, image_sizes: Sequence[int],
                               n: int, batch: int, *, joint_cd: int,
                               init_steps: int, steps: int) -> float:
    """Operations of one main epoch of the flagship joint: per batch,
    sampled CD-k (positive pass, two products a step, two for the
    statistics); the y-clamped update, and on batch 0 of every 50 the
    z-clamped one (the noisy init's two products a step, the positive
    hidden pass, one mean-field negative step of two, the negative
    hidden pass, the statistics); the round trip (two products a step
    each way, the img2txt half's final pair) and the decode of its image
    through the image stack."""
    clamped = 2 * init_steps + 1 + 2 + 1 + 2
    total = 0.0
    for b, B in enumerate(batch_sizes(n, batch)):
        per = (1 + 2 * joint_cd + 2) + clamped + (2 * steps + 2) \
            + 2 * steps
        if b % 50 == 0:
            per += clamped
        total += per * mm_flops(B, V, H)
        for Vi, Hi in zip(image_sizes[:-1], image_sizes[1:]):
            total += mm_flops(B, Hi, Vi)
    return total
