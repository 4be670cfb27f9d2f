#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``multimodal_idbn_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build both kernel sources from ``multimodal_idbn_tpu_torch/csrc`` with
   nvcc for sm_90a, one nvcc per source, all started together;
2. hold each of the four kernels against its plain PyTorch version on the
   card, at the shapes of the flagship and the bimodal paths, and time
   kernel, plain version and, for the half-steps, the one-call library
   yardstick ``addmm`` + ``sigmoid`` (``ms``: back-to-back calls through
   the wrapper; ``graph_ms``: the same calls replayed from a CUDA graph,
   device time without the host; for the chain also ``device_ms``: one
   launch between two CUDA events):
   - the sampled half-step at every layer shape of both paths, and at two
     edge shapes (K not a multiple of 4 at batch 12: the 4-byte copies;
     K shorter than one k-slice),
   - the probs-only and the resident sampled half-steps at
     [128,1568]·[1568,500] and [128,2500]·[2500,1500],
   - the chain at the flagship joint (532×500, batch 128, 26 and 12, and
     with a second softmax group) on the cluster body, and at the bimodal
     joint layer 0 (2500×1500, batch 128 and the ragged remainder of 12)
     on the grid body, as ``chain.body`` picks them, and at the flagship
     joint at the batch sizes a serving request brings (1, 3, 96, 200; 50
     steps, both families); each timed flagship case also on the grid
     body, forced,
   - determinism: every entry launched twice on the same inputs must
     return bit-equal tensors, at the first-layer shape and a ragged one;
   - ``half_step_sample_big`` (JAX's standalone wrapper of the sampled
     half-step, here the same entry) at one ragged shape;
3. the RBM learns: ``RBM(64, 32)`` on noisy bars through the fused CD
   path; reconstruction MSE must drop by more than 2x;
4. the two training paths at full width, each a shipped YAML with every
   width and step count kept and only the scale cut
   (``multimodal_idbn_tpu_torch.cuts``): flagship-cut through
   ``train_multimodal``, then bimodal-cut through ``train_bimodal``. The
   launch counts are reset just before each path and read just after; the
   sampled half-step and the chain must have launched, every parameter
   must be finite and every weight of the expected shape;
5. the resident drive: the probs-only and the resident sampled half-steps
   through their public functions (``half_step.hidden_probs_kernel``,
   ``half_step.half_step_sample_resident``) on the trained bimodal model,
   encoding MOD2 images and the joint input of one batch, with the counts
   reset just before and read just after. No training path calls these
   two, as in the JAX package, where only tests call their TPU kernels;
6. save -> load -> serve: the trained flagship-cut model is pickled
   (``save_model``), loaded into fresh objects on the card
   (``iMDBN.load_model`` + ``from_payload``) and served through
   ``txt2img`` (all 32 labels x 4, and 3 labels), ``img2txt`` (128 images,
   and 1) and ``sample_txt2img`` (128 and 3 rows). Each call runs three
   times from the same key: launch by launch (``graphs.launch_by_launch``),
   then through the model's graph cache twice (a capture and a replay,
   then a replay under ``torch.cuda.set_sync_debug_mode("error")``); the
   three outputs must be bit-equal, for the trained and the loaded model,
   and the two models' too; each kernel's launches the same three ways
   and as derived (``txt2img`` / ``img2txt`` one chain and one fill, the
   sampled call 2 + 3 x steps fills and no chain, no half-step), one
   replay per call JAX jits (``img2txt``: the encode and the cross). Each
   call is timed replayed and launch by launch (median wall, CUDA events,
   device busy ms); each capture's seconds and graph pool are printed.
   Then the trained model takes one more image epoch and one more joint
   epoch and every call is served again: bit-equal to launch by launch
   on the new weights, every output changed, no new capture;
6b. the bimodal serving drive on bimodal-cut's trained model and on the
   same model pickled and loaded onto the card: ``mod1_to_mod2``,
   ``mod2_to_mod1``, ``_cross_reconstruct`` both ways, and
   ``sample_mod1_to_mod2`` / ``sample_mod2_to_mod1``, at B = 128 and 3,
   each held the same three ways (launches as derived: no chain, the
   sampled cross 1 + steps fills a direction, the sampled chain 2 + 2 x
   steps), outputs in [0, 1], loaded equal to trained, the B = 128 calls
   timed both ways;
7. ``python -m multimodal_idbn_tpu_torch.generate`` as a subprocess on
   that pickle, sampled and ``--mean``; the ``--mean`` images must equal
   phase 6's ``txt2img``; then both requests once more in this process,
   each one capture and one replay with the subprocess's images;
8. resume: flagship-cut with checkpoints (``cuts.RESUME``) once
   uninterrupted, and stopped right after a checkpoint write in the image
   phase, inside the joint warm-up and after the warm-up boundary, each
   resumed by running the entry point again on the same config; the same
   for bimodal-cut's joint phase. Final states and metric histories must
   be bit-equal to the uninterrupted run's, a changed learning rate must
   refuse to resume, and the checkpoints must be gone after a completed
   run;
9. ``train_with_retry`` (two image epochs, one retry allowed) and
   ``finetune_image_last_layer`` (one epoch) at full width;
10. the diagnostics drive: both cuts trained again through their entry
   points with W&B on (``cuts.DIAGNOSTICS``: every ``logging`` section
   enabled, every cadence 8), W&B's ``init`` replaced by one that returns
   a ``RecorderRun``. The final states must be bit-equal to phase 4's;
   every numeric key finite; one probe accuracy in [0, 1] per target and
   monitored layer at each firing; no ``warn/*`` key but the figures
   skipped for want of matplotlib (and the collapse verdict
   ``warn/idbn_blank_recon``, which the model logs as JAX's does); and the
   numeric keys the same set as the same cut's at small widths on the CPU
   (``cuts.TINY``). Then each diagnostic once more on the trained model,
   alone, launch by launch and replayed from the same key streams: the
   numbers it logs and the output of every call it makes through the
   graphs (the probe chunks, the energy, panel and trajectory chains, the
   bias statistics, the encodes) bit-equal both ways, its kernel launches
   the same, graph replays only replayed (under
   ``torch.cuda.set_sync_debug_mode("error")``), with its seconds and the
   device busy ms and device operations of one more, profiled call both
   ways (the probes' at ``PROBE_PROFILE_STEPS`` steps); every graph of
   the model's caches, launches per replay as derived
   (``derived_replay_launches``); ``measure_gibbs_steps_per_sec`` at its
   defaults replayed and launch by launch, and one
   ``utils.profiling.trace`` around one joint epoch;
11. the variants drive (``cuts.VARIANTS``): flagship-cut through its
   entry point under PCD (params), bf16 storage with stochastic rounding
   left to auto and switched off, mixed precision, ``matmul_precision:
   high`` and zipfian data (drawn by the native generator), and
   bimodal-cut under bf16 storage. Each run's launches are held against
   the counts derived for it (fp32 PCD: 3 + 2·CD half-steps per layer and
   full batch; bf16 storage: no half-step launch, its joints through the
   chain kernel on weights widened to fp32), every
   state must be in its configured dtype and finite. The fp32 PCD update
   at the first layer is held against its plain version half-step by
   half-step and repeated bit-equal; the PCD run stopped after an image
   checkpoint and run again must end bit-equal, fantasy chains included;
   a bf16 model's checkpoint must load bit-equal; the native generator is
   built from its source, checked deterministic per seed and timed
   against the Python one at 2048 images of side 100;
12. per-batch training and ``parallel/``: kernels 1 and 2 launched on a
   part of their operand (``row0``, and ``col0`` for kernel 1) against
   their plain versions and, with the whole operand's plan, bit-equal to
   that part of one launch on the whole; both cuts through loaders that
   hide ``materialize()`` (launches as derived, one graph replay a batch,
   two runs bit-equal, the second's replays under the sync check of
   ``replays_checked``, the flagship stopped after a joint checkpoint and
   run again bit-equal, a run launch by launch bit-equal with the same
   launches, the last image loss within 10% of phase 4's; one flagship
   image epoch per batch timed beside a fused one); flagship-cut with
   ``training.dp_devices: 1`` in a one-rank NCCL group, bit-equal to phase
   4; both cuts with ``dp_devices: 2`` in two processes sharing the card
   over gloo (``chip_smoke.py --dp-rank R STORE OUT``, started after the
   build): replicas bit-equal, each rank phase 4's launches, states
   within the tolerance stated at ``PAR_REL_TOL``; and the 1 x 2 split of
   flagship layer 0 (``tp_cd_update``, ``gather_state``) against one
   device;
13. the shipped flagship schedule: configs/multimodal_training_config.yaml
   end to end through ``train_multimodal`` (2048 samples, 100 image and
   150 joint epochs), the launches of kernels 1 and 2 against their
   derivation, every state finite, the 14 metrics of the quality protocol
   (``multimodal_idbn_tpu_torch.quality``) and a collapse check (training
   top-1 below 3/32, or image auto-reconstruction at the blank level);
14. graph replays against launch by launch: ``philox_fill`` (the Philox
   fill of the plain torch draws) against its plain version and a repeat,
   by value and from a key table, and timed; then flagship-cut,
   bimodal-cut and flagship-cut under PCD through their entry points
   with every call of an epoch function recorded (``EPOCH_BLOCKS``): every
   epoch must have run as one replay of a graphed runner, launched the
   kernels its capture launched and as derived, with the replays under
   ``torch.cuda.set_sync_debug_mode("error")``; the same epoch functions
   called again with the recorded arguments and no runner (launch by
   launch) must return bit-equal states, losses and metric sums with the
   same launches. Each cut's joint phase is then run again from the
   recorded inputs, replayed and launch by launch, timed on the host clock
   and profiled (busy ms, idle share), beside PERF.md's launch-by-launch
   figures; each capture's seconds and graph memory are printed;
15. the RBM shell's jitted entries (``forward``, ``visible_probs``,
   ``backward``, ``free_energy``, ``sample_visible``,
   ``backward_sample``, ``gibbs_step``, the three conditional chains,
   ``train_epoch`` and ``train_epoch_clamped``) at the joint widths of
   both families (532x500 with the 32-wide label group, 2500x1500; B =
   128): each launch by launch, through the shell's graphs and replayed
   under the sync check, from the same key stream (and state), bit-equal,
   launches as derived, one replay a call; after one more ``train_epoch``
   every entry again bit-equal, changed and without a new capture; each
   timed both ways; then the three per-batch steps JAX jits
   (``idbn_batch_step``, ``joint_train_batch_step``,
   ``bimodal_batch_step``) called directly at full width, each one
   replay bit-equal to launch by launch.

From phase 4 on, every fused epoch of a training path on the card is one
replay of a CUDA graph (``ops.graphs``), so phases 4, 8 and 10-13 hold
the graphed paths (and ``graph_replays``, the replays, beside each
path's launches); the data-parallel runs of phase 12 run launch by
launch, and the one-rank NCCL run is held bit-equal to phase 4's
replays. Every other call the JAX package jits is one replay of its
graph wherever it is called: the serving calls, the diagnostics' chains,
the bias statistics and the RBM shell's reads (``serving_replays``), and
the per-batch steps, the probe chunks and the shell's training entries
(``step_replays``).

``python3 chip_smoke.py --phase-14`` runs the build and phase 14 alone;
``python3 chip_smoke.py --serving`` the build, phase 4 and the serving
phases 6, 6b and 7; ``python3 chip_smoke.py --replays`` the build, phase
4, the diagnostics alone both ways (phase 10's), the per-batch drive
(phase 12 (a)) and phase 15.

The last three lines of stdout are the ``kernels`` JSON, the card's name
and power limit from nvidia-smi, and ``{"ok": true, "device": ...}``.
Exits non-zero, printing no result, without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): dense TF32 in the tensor
# cores, fp32 outside them, HBM3 bandwidth. The kernels' products are
# three TF32 passes with fp32 sums (fp32 accuracy), so bound_ms counts
# three times the operations at the TF32 peak, or the bytes, whichever
# takes longer; bound_fp32_ms is the same work at the CUDA-core peak.
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Tolerances, stated before measuring:
# - half-step probs: sums of up to 10000 terms in another order than
#   cuBLAS (k-slices of at most 1024 terms, each an error-compensated
#   TF32 sum with fp32 accumulation), through a sigmoid (slope <= 1/4);
# - a sample, of the sampled and of the resident sampled half-step alike,
#   may differ only where |p - u| is within that tolerance: a sum taken in
#   another order may move p by ~1e-7 across u;
# - two launches on the same inputs must agree bit for bit;
# - chains: 30-50 dependent steps of the same arithmetic; the noise
#   normals use the card's and the CPU library's logf/cosf (a few ulps).
TOL_HALF_STEP = 1e-5
TOL_CHAIN = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(fn, reps: int = 10) -> float:
    """Device time of one call: the median over ``reps`` calls of the time
    between two CUDA events recorded on the stream just before and just
    after the call. For a call that is one kernel launch (the chain) this
    is the kernel's time plus, on the grid body, the wrapper's barrier
    memset."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def bounds(flops: float, nbytes: float):
    """bound_ms, what bounds it, and the CUDA-core bound of the same work."""
    t_ops = TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_fp32 = max(flops / PEAK_FP32_FLOPS * 1e3, t_bytes)
    if t_ops >= t_bytes:
        return dict(bound_ms=t_ops, bound_by="operations",
                    bound_fp32_ms=t_fp32)
    return dict(bound_ms=t_bytes, bound_by="bytes", bound_fp32_ms=t_fp32)


def build_kernels():
    from multimodal_idbn_tpu_torch.ops import (_cuda, chain, half_step,
                                               philox_fill, rsoftmax)
    libs = [half_step.KERNEL, chain.KERNEL, philox_fill.KERNEL,
            rsoftmax.KERNEL]
    t0 = time.perf_counter()
    _cuda.build_all(libs)
    log(f"[build] nvcc {' '.join(_cuda.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        lib.lib()
        if lib.log_path.exists():
            for line in lib.log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {lib.source.name}: {line.strip()}")


def reset_launches():
    """Zero every kernel's launch count and the graph replays."""
    from multimodal_idbn_tpu_torch.ops import (chain, graphs, half_step,
                                               philox_fill, rsoftmax)
    half_step.KERNEL.reset_launches()
    chain.KERNEL.reset_launches()
    philox_fill.KERNEL.reset_launches()
    rsoftmax.KERNEL.reset_launches()
    graphs.reset_stats()


def read_launches():
    """Launches of each kernel entry since the last reset, and the CUDA
    graph replays: of epochs (one per epoch on a graphed path), of pure
    calls (``serving_replays``: one per call of a jitted function in JAX:
    serving, diagnostics, the RBM shell's reads) and of in-place updates
    (``step_replays``: a per-batch step, a probe chunk, the shell's
    training entries)."""
    from multimodal_idbn_tpu_torch.ops import (chain, graphs, half_step,
                                               philox_fill, rsoftmax)
    out = dict(half_step.KERNEL.launches_by_entry)
    out["chain_run"] = chain.KERNEL.launches
    out["philox_fill"] = philox_fill.KERNEL.launches
    out["rs_sample"] = rsoftmax.KERNEL.launches
    replays = graphs.STATS["replays"]
    out["graph_replays"] = sum(n for k, n in replays.items()
                               if not k.startswith(("serve:", "step:")))
    out["serving_replays"] = sum(n for k, n in replays.items()
                                 if k.startswith("serve:"))
    out["step_replays"] = sum(n for k, n in replays.items()
                              if k.startswith("step:"))
    return out


def half_step_inputs(g, dev, B, K, N, transpose, density):
    import torch
    V, H = (N, K) if transpose else (K, N)
    w = (torch.randn((V, H), generator=g) / V ** 0.5).to(dev)
    b = (0.1 * torch.randn((N,), generator=g)).to(dev)
    x = (torch.rand((B, K), generator=g) < density).float().to(dev)
    return x, w, b


def sample_flips(p_plain, s_k, s_p, seed):
    """(all flips, flips outside the tolerance band |p - u| <= tol)."""
    from multimodal_idbn_tpu_torch.ops import rng
    u = rng.philox_uniform(seed, s_k.shape[0], s_k.shape[1],
                           device=s_k.device)
    flips = s_k != s_p
    return int(flips.sum()), int((flips & ((p_plain - u).abs()
                                           > TOL_HALF_STEP)).sum())


def check_half_step(dev):
    """Kernel 1 in both directions of every layer shape of both paths, and
    at two edge shapes of the tile."""
    import torch
    from multimodal_idbn_tpu_torch.bench_kernels import graph_ms
    from multimodal_idbn_tpu_torch.ops import half_step
    g = torch.Generator().manual_seed(0)
    rows = []
    for name, (B, K, N, transpose, density) in {
            "flagship L1 v->h": (128, 10000, 1500, False, 0.15),
            "flagship L1 h->v": (128, 1500, 10000, True, 0.5),
            "flagship L2 v->h": (128, 1500, 500, False, 0.5),
            "flagship L2 h->v": (128, 500, 1500, True, 0.5),
            "mod1 L2 v->h": (128, 1500, 1500, False, 0.5),
            "mod1 L2 h->v": (128, 1500, 1500, True, 0.5),
            "mod2 L1 v->h": (128, 1568, 500, False, 0.2),
            "mod2 L1 h->v": (128, 500, 1568, True, 0.5),
            "mod2 L2 v->h": (128, 500, 500, False, 0.5),
            "mod2 L3 v->h": (128, 500, 1000, False, 0.5),
            "mod2 L3 h->v": (128, 1000, 500, True, 0.5),
            "edge: K % 4 != 0, B=12 v->h": (12, 1501, 499, False, 0.5),
            "edge: K % 4 != 0, B=12 h->v": (12, 1501, 499, True, 0.5),
            "edge: K < one slice": (128, 40, 1500, False, 0.5)}.items():
        x, w, b = half_step_inputs(g, dev, B, K, N, transpose, density)
        seed = 0x1234_5678_9ABC_DEF0 + len(rows)
        p_k, s_k = half_step.half_step_sample(x, w, b, seed,
                                              transpose_w=transpose)
        p_p, s_p = half_step.half_step_plain(x, w, b, seed,
                                             transpose_w=transpose)
        torch.cuda.synchronize()
        err = float((p_k - p_p).abs().max())
        flips, bad = sample_flips(p_p, s_k, s_p, seed)
        body, tile_rows, slices, k_per_slice = half_step.plan(B, K, N)
        log(f"[half_step] {name} [{B},{K}]x[{K},{N}]: {body} body, "
            f"{tile_rows}-row tiles, {slices} k-slices of {k_per_slice}; "
            f"max|dp| {err:.3e},"
            f" sample flips {flips} (outside tol: {bad})")
        if not err <= TOL_HALF_STEP or bad:
            raise AssertionError(f"half_step {name} disagrees with plain")

        def kernel():
            return half_step.half_step_sample(x, w, b, seed,
                                              transpose_w=transpose)

        wm = w.T if transpose else w

        def library():
            return torch.sigmoid(torch.addmm(b, x, wm))

        row = dict(shape=name, body=body, max_abs_err=err,
                   sample_flips=flips,
                   ms=time_ms(kernel, 100), graph_ms=graph_ms(kernel),
                   plain_ms=time_ms(lambda: half_step.half_step_plain(
                       x, w, b, seed, transpose_w=transpose), 10),
                   library_ms=time_ms(library, 100),
                   library_graph_ms=graph_ms(library),
                   **bounds(2.0 * B * K * N,
                            4.0 * (B * K + K * N + N + 2 * B * N)))
        rows.append(row)
        log(f"[half_step] {name}: kernel {row['ms']:.4f} ms (device "
            f"{row['graph_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
            f"addmm+sigmoid {row['library_ms']:.4f} ms (device "
            f"{row['library_graph_ms']:.4f}), bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']}), fp32 bound "
            f"{row['bound_fp32_ms']:.4f} ms")
    return rows[0], rows


def check_half_step_big(dev):
    """``half_step_sample_big`` (TPU pallas_kernels.py:311) against its
    plain version at one ragged shape; returns its kernels-line row."""
    import torch
    from multimodal_idbn_tpu_torch.ops import half_step
    B, K, N = 37, 1501, 499
    x, w, b = half_step_inputs(torch.Generator().manual_seed(4), dev, B, K,
                               N, False, 0.3)
    seed = 0x5EED_B16
    p_k, s_k = half_step.half_step_sample_big(x, w, b, seed)
    p_p, s_p = half_step.half_step_sample_big_plain(x, w, b, seed)
    torch.cuda.synchronize()
    err = float((p_k - p_p).abs().max())
    flips, bad = sample_flips(p_p, s_k, s_p, seed)
    log(f"[half_step_sample_big] [{B},{K}]x[{K},{N}]: max|dp| {err:.3e}, "
        f"sample flips {flips} (outside tol: {bad})")
    if not err <= TOL_HALF_STEP or bad:
        raise AssertionError("half_step_sample_big disagrees with plain")
    row = dict(shape=f"[{B},{K}]x[{K},{N}]", max_abs_err=err,
               sample_flips=flips,
               ms=time_ms(lambda: half_step.half_step_sample_big(
                   x, w, b, seed), 100),
               plain_ms=time_ms(lambda: half_step.half_step_sample_big_plain(
                   x, w, b, seed), 10),
               library_ms=time_ms(lambda: torch.sigmoid(torch.addmm(b, x, w)),
                                  100),
               **bounds(2.0 * B * K * N,
                        4.0 * (B * K + K * N + N + 2 * B * N)))
    log(f"[half_step_sample_big]: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, addmm+sigmoid {row['library_ms']:.4f} "
        f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


# The multimodal DBN's bottom layers on its main path:
# (entry, B, K, N) of each launch shape of an epoch, the Gaussian layer
# [3857, 1024] on the mma_sync body, the tag layer [2000, 1024] on wgmma
MDBN_SHAPES = (
    ("half_step_sample", 128, 3857, 1024),   # image features up
    ("half_step_gauss", 128, 1024, 3857),    # the Gaussian visibles down
    ("half_step_scaled", 128, 2000, 1024),   # word counts up, D·a
    ("half_step_linear", 128, 1024, 2000),   # the word logits down
    ("half_step_gauss", 128, 1024, 2000),    # each entry on the other body
    ("half_step_linear", 128, 1024, 3857),
    ("half_step_scaled", 128, 3857, 1024),
)
MDBN_WORDS = 10   # a row's tags: 1 .. 10 words


def check_mdbn_kernels(dev):
    """The entries of visible units that are not Bernoulli and the word
    sampler at the multimodal DBN's shapes, each against its plain
    version: means to 1e-5; a Gaussian draw its mean plus the kernels'
    N(0, 1) to 1e-5; a Bernoulli draw may differ only inside the
    tolerance band; the words of a row sum to its D and are the plain
    version's but where a draw lies on a boundary of the cumulative
    weights (at most 2% of rows). Returns {entry: [rows]}, the first row
    of each at its main-path shape."""
    import torch
    from multimodal_idbn_tpu_torch.bench_kernels import graph_ms
    from multimodal_idbn_tpu_torch.ops import half_step, rng, rsoftmax
    g = torch.Generator().manual_seed(21)
    out = {}
    for entry, B, K, N in MDBN_SHAPES:
        seed = 0x6D64_626E + len(out.get(entry, ()))
        transpose = entry in ("half_step_gauss", "half_step_linear")
        V, H = (N, K) if transpose else (K, N)
        w = (torch.randn((V, H), generator=g) / V ** 0.5).to(dev)
        b = (0.1 * torch.randn((N,), generator=g)).to(dev)
        if entry == "half_step_sample":
            x = torch.randn((B, K), generator=g).to(dev)
        elif entry == "half_step_scaled":
            x = torch.zeros((B, K))
            idx = torch.randint(0, K, (B, MDBN_WORDS), generator=g)
            take = (torch.arange(MDBN_WORDS)[None] < torch.randint(
                1, MDBN_WORDS + 1, (B, 1), generator=g)).float()
            x = x.scatter_add_(1, idx, take).to(dev)
        else:
            x = (torch.rand((B, K), generator=g) < 0.4).float().to(dev)
        scale = x.sum(1) if entry == "half_step_scaled" else None
        wm = w.T if transpose else w
        if entry == "half_step_sample":
            def kernel():
                return half_step.half_step_sample(x, w, b, seed)

            def library():
                return torch.sigmoid(torch.addmm(b, x, w))
            p_k, _ = kernel()
            want = torch.sigmoid(x.double() @ w.double() + b.double())
            err, flips = float((p_k.double() - want).abs().max()), 0
        elif entry == "half_step_scaled":
            def kernel():
                return half_step.half_step_scaled(x, w, b, scale, seed)

            def library():
                return torch.sigmoid(torch.addmm(scale[:, None] * b, x, w))
            p_k, s_k = kernel()
            p_p, s_p = half_step.half_step_scaled_plain(x, w, b, scale, seed)
            err = float((p_k - p_p).abs().max())
            flips, bad = sample_flips(p_p, s_k, s_p, seed)
            if bad:
                raise AssertionError(f"{entry} [{B},{K}]x[{K},{N}]: {bad} "
                                     f"draws outside the band")
        elif entry == "half_step_gauss":
            def kernel():
                return half_step.half_step_gauss(x, w, b, seed)

            def library():
                m = torch.addmm(b, x, wm)
                return m, m + torch.randn_like(m)
            m_k, v_k = kernel()
            m_p, _ = half_step.half_step_gauss_plain(x, w, b, seed)
            noise = rng.philox_normal(seed, B, N, device=dev)
            err = max(float((m_k - m_p).abs().max()),
                      float(((v_k - m_k) - noise).abs().max()))
            flips = 0
        else:
            def kernel():
                return half_step.half_step_linear(x, w, b)

            def library():
                return torch.addmm(b, x, wm)
            err = float((kernel() - half_step.half_step_linear_plain(
                x, w, b)).abs().max())
            flips = 0
        torch.cuda.synchronize()
        body = half_step.plan(B, K, N)[0]
        if not err <= TOL_HALF_STEP:
            raise AssertionError(f"{entry} [{B},{K}]x[{K},{N}] ({body}): "
                                 f"max error {err:.3e}")
        plain = {"half_step_sample": lambda: half_step.half_step_plain(
                     x, w, b, seed),
                 "half_step_scaled": lambda: half_step.half_step_scaled_plain(
                     x, w, b, scale, seed),
                 "half_step_gauss": lambda: half_step.half_step_gauss_plain(
                     x, w, b, seed),
                 "half_step_linear": lambda: half_step.half_step_linear_plain(
                     x, w, b)}[entry]
        outs = 1 if entry == "half_step_linear" else 2
        row = dict(shape=f"[{B},{K}]x[{K},{N}]", body=body,
                   max_abs_err=err, sample_flips=flips,
                   ms=time_ms(kernel, 100), graph_ms=graph_ms(kernel),
                   plain_ms=time_ms(plain, 10),
                   library_ms=time_ms(library, 100),
                   **bounds(2.0 * B * K * N, 4.0 * (
                       B * K + K * N + N + outs * B * N
                       + (B if scale is not None else 0))))
        out.setdefault(entry, []).append(row)
        log(f"[mdbn] {entry} {row['shape']} ({body}): max|d| {err:.3e}, "
            f"flips {flips}; kernel {row['ms']:.4f} ms (device "
            f"{row['graph_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    for B in (128, 26):
        V = 2000
        logits = (2.0 * torch.randn((B, V), generator=g)).to(dev)
        words = torch.randint(1, MDBN_WORDS + 1, (B,),
                              generator=g).float().to(dev)

        def kernel():
            return rsoftmax.rs_sample(logits, words, 0x7273)

        def library():
            return torch.multinomial(torch.softmax(logits, 1), MDBN_WORDS,
                                     replacement=True)
        counts, mean = kernel()
        c_p, m_p = rsoftmax.rs_sample_plain(logits, words, 0x7273)
        torch.cuda.synchronize()
        err = float((mean - m_p).abs().max())
        differ = float((counts != c_p).any(1).float().mean())
        if not (err <= TOL_HALF_STEP and torch.equal(counts.sum(1), words)
                and differ <= 0.02):
            raise AssertionError(f"rs_sample [{B},{V}]: mean error "
                                 f"{err:.3e}, rows of other words {differ}")
        row = dict(shape=f"[{B},{V}], D 1-{MDBN_WORDS}", max_abs_err=err,
                   rows_differ=differ, ms=time_ms(kernel, 100),
                   graph_ms=graph_ms(kernel),
                   plain_ms=time_ms(lambda: rsoftmax.rs_sample_plain(
                       logits, words, 0x7273), 10),
                   library_ms=time_ms(library, 100),
                   **bounds(0.0, 4.0 * (3 * B * V + B)))
        out.setdefault("rs_sample", []).append(row)
        log(f"[mdbn] rs_sample {row['shape']}: mean max|d| {err:.3e}, rows "
            f"of other words {differ:.3f}; kernel {row['ms']:.4f} ms (device "
            f"{row['graph_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
            f"softmax+multinomial {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    return out


def run_mdbn_path(workdir: Path) -> dict:
    """The multimodal DBN's YAML through ``train_bimodal`` at its widths,
    one epoch of each pathway and one of the joint (``cuts`` "mdbn-cut"),
    with the launch counts reset just before and read just after: the new
    entries' launches on their main path, by entry and by body. An epoch
    of each pathway launches, for its nb batches at CD-k, nb·k Gaussian
    down passes, nb·(k + 1) scaled up passes, nb·k logits and nb·k word
    draws; later calls of the run (the joint's inputs, the cross metrics)
    may add more."""
    from multimodal_idbn_tpu_torch import cuts
    from multimodal_idbn_tpu_torch.ops import half_step
    reset_launches()
    summary = cuts.run_cut("mdbn-cut", workdir)
    launches = read_launches()
    bodies = dict(half_step.KERNEL.launches_by_body)
    cfg = cuts.CUTS["mdbn-cut"]
    n = int(0.7 * cfg["cut"]["dataset"]["n_samples"])
    nb, k = -(-n // 128), 10
    want = {"half_step_gauss": nb * k, "half_step_linear": nb * k,
            "half_step_scaled": nb * (k + 1), "rs_sample": nb * k}
    losses = summary["mod1_loss"] + summary["mod2_loss"]
    log(f"[mdbn-cut] launches {json.dumps(launches)}; by body "
        f"{json.dumps(bodies)}; one pathway epoch derives {json.dumps(want)}"
        f"; phase seconds {json.dumps(summary['seconds'])}; MOD1 / MOD2 CD "
        f"loss {summary['mod1_loss']} / {summary['mod2_loss']}")
    if any(launches[e] < n_ for e, n_ in want.items()) or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mdbn-cut: launches {launches}, derived at "
                             f"least {want}; losses {losses}")
    if bodies["mma_sync"] <= 0 or bodies["wgmma"] <= 0:
        raise AssertionError(f"mdbn-cut: a body did not run: {bodies}")
    return dict(launches, **{f"body:{b}": c for b, c in bodies.items()})


def check_determinism(dev):
    """Every entry launched twice on the same inputs returns the same
    bits: the split-K sums are taken in a fixed order, whichever block
    arrives last, and the chain's result does not depend on how its grid
    is scheduled."""
    import torch
    from multimodal_idbn_tpu_torch.ops import chain, half_step, rbm_ops
    g = torch.Generator().manual_seed(5)
    for name, (B, K, N) in {"first layer [128,10000]x[10000,1500]":
                            (128, 10000, 1500),
                            "ragged [37,1501]x[1501,499]":
                            (37, 1501, 499)}.items():
        x, w, b = half_step_inputs(g, dev, B, K, N, False, 0.3)
        xt, wt, bt = half_step_inputs(g, dev, B, N, K, True, 0.5)
        runs = {
            "half_step_sample": lambda: half_step.half_step_sample(
                x, w, b, 11),
            "half_step_sample (transposed)": lambda:
                half_step.half_step_sample(xt, wt, bt, 11, transpose_w=True),
            "half_step_probs": lambda: (half_step.half_step_probs(x, w, b),),
            "half_step_sample_resident": lambda:
                half_step.half_step_sample_resident(x, w, b, 11)}
        for entry, run in runs.items():
            first, second = run(), run()
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(first, second)):
                raise AssertionError(f"{entry} at {name}: two launches "
                                     f"differ")
        p_probs = runs["half_step_probs"]()[0]
        p_res = runs["half_step_sample_resident"]()[0]
        if not torch.equal(p_probs, p_res):
            raise AssertionError(f"probs-only and resident entries differ "
                                 f"at {name}")
        log(f"[determinism] half-step entries at {name}: bit-equal")
    for name, (B, V, H, groups) in {
            "bimodal joint 2500x1500, B=128": (128, 2500, 1500, ()),
            "ragged 131x77 with groups, B=37": (37, 131, 77,
                                                ((60, 70), (100, 131)))
            }.items():
        j = chain_inputs(dev, B, V, H, min(V, 64), 9)
        km = (j["u"] < 0.4).float()
        sched = rbm_ops.annealed_schedule(12, 3.0, 1.0, 0.9, 2, 0.9, 0.15)
        args = (j["w"], j["hb"], j["vb"], j["z"] * km + (1 - km) * j["u"],
                j["z"], km, sched)
        kw = dict(groups=groups, mu=j["mu"], seed=0xD37)
        first = chain.clamped_chain(*args, **kw)
        second = chain.clamped_chain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"chain at {name}: two launches differ")
        log(f"[determinism] chain at {name}: bit-equal")


def check_resident(dev):
    """Kernels 3 (probs only) and 4 (resident sampled) at the two shapes
    of the bimodal path under the TPU kernels' VMEM ceiling."""
    import torch
    from multimodal_idbn_tpu_torch.bench_kernels import graph_ms
    from multimodal_idbn_tpu_torch.ops import half_step
    g = torch.Generator().manual_seed(2)
    B = 128
    rows = {"half_step_probs": [], "half_step_sample_resident": []}
    for name, (K, N, density) in {
            "mod2 L1 [128,1568]x[1568,500]": (1568, 500, 0.2),
            "joint L0 [128,2500]x[2500,1500]": (2500, 1500, 0.5)}.items():
        x, w, b = half_step_inputs(g, dev, B, K, N, False, density)
        seed = -0x1234_5678 + len(rows["half_step_probs"])
        def library():
            return torch.sigmoid(torch.addmm(b, x, w))

        lib = dict(library_ms=time_ms(library, 100),
                   library_graph_ms=graph_ms(library))
        lib_ms = lib["library_ms"]
        flops = 2.0 * B * K * N

        p_k = half_step.half_step_probs(x, w, b)
        p_p = half_step.half_step_probs_plain(x, w, b)
        torch.cuda.synchronize()
        err = float((p_k - p_p).abs().max())
        log(f"[half_step_probs] {name}: max|dp| {err:.3e}")
        if not err <= TOL_HALF_STEP:
            raise AssertionError(f"half_step_probs {name} disagrees")
        ms = time_ms(lambda: half_step.half_step_probs(x, w, b), 100)
        gms = graph_ms(lambda: half_step.half_step_probs(x, w, b))
        plain_ms = time_ms(lambda: half_step.half_step_probs_plain(x, w, b),
                           20)
        bnd = bounds(flops, 4.0 * (B * K + K * N + N + B * N))
        rows["half_step_probs"].append(dict(
            shape=name, max_abs_err=err, ms=ms, graph_ms=gms,
            plain_ms=plain_ms, **lib, **bnd))
        log(f"[half_step_probs] {name}: kernel {ms:.4f} ms (device "
            f"{gms:.4f}), plain {plain_ms:.4f} ms, addmm+sigmoid "
            f"{lib_ms:.4f} ms (device {lib['library_graph_ms']:.4f}), "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")

        p_k, s_k = half_step.half_step_sample_resident(x, w, b, seed)
        p_p, s_p = half_step.half_step_sample_resident_plain(x, w, b, seed)
        torch.cuda.synchronize()
        err = float((p_k - p_p).abs().max())
        flips, bad = sample_flips(p_p, s_k, s_p, seed & 0xFFFFFFFF)
        log(f"[half_step_sample_resident] {name}: max|dp| {err:.3e}, "
            f"sample flips {flips} (outside tol: {bad})")
        if not err <= TOL_HALF_STEP or bad:
            raise AssertionError(f"half_step_sample_resident {name} "
                                 f"disagrees with plain")
        ms = time_ms(lambda: half_step.half_step_sample_resident(
            x, w, b, seed), 100)
        gms = graph_ms(lambda: half_step.half_step_sample_resident(
            x, w, b, seed))
        plain_ms = time_ms(lambda: half_step.half_step_sample_resident_plain(
            x, w, b, seed), 10)
        bnd = bounds(flops, 4.0 * (B * K + K * N + N + 2 * B * N))
        rows["half_step_sample_resident"].append(dict(
            shape=name, max_abs_err=err, sample_flips=flips, ms=ms,
            graph_ms=gms, plain_ms=plain_ms, **lib, **bnd))
        log(f"[half_step_sample_resident] {name}: kernel {ms:.4f} ms "
            f"(device {gms:.4f}), plain {plain_ms:.4f} ms, addmm+sigmoid "
            f"{lib_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")
    return rows


def chain_inputs(dev, B, V, H, Dz, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return dict(
        w=(torch.randn((V, H), generator=g) / V ** 0.5).to(dev),
        hb=(0.1 * torch.randn((H,), generator=g)).to(dev),
        vb=(0.1 * torch.randn((V,), generator=g)).to(dev),
        z=torch.rand((B, V), generator=g).to(dev),
        mu=torch.rand((B, Dz), generator=g).to(dev),
        u=torch.rand((B, V), generator=g).to(dev))


def check_chain(dev):
    """Kernel 2: both families at the flagship joint (532×500, a 32-wide
    label group; batch 128 and the epoch's remainder of 26; once more with
    a second group), the aux-CD init of the bimodal joint layer 0
    (2500×1500, no group) at batch 128 and at the remainder of 12, and the
    flagship joint at the batch sizes a serving request brings. Each case
    runs on the body ``chain.body`` picks (the cluster body at 532×500, the
    grid body at 2500×1500) against the plain version; a timed case at the
    flagship joint is timed on both bodies (the other one forced), so that
    the kernel table gives the two side by side."""
    import torch
    from multimodal_idbn_tpu_torch.bench_kernels import graph_ms
    from multimodal_idbn_tpu_torch.ops import chain, rbm_ops
    aux_sched = rbm_ops.annealed_schedule(30, 3.0, 1.0, 0.9, 2, 0.9,
                                          0.15).to(dev)
    cases = []
    # flagship: z (first 500) and y (last 32, one-hot) blocks
    B, Dz, K = 128, 500, 32
    j = chain_inputs(dev, B, Dz + K, 500, Dz, 1)
    y = torch.nn.functional.one_hot(
        torch.randint(0, K, (B,), generator=torch.Generator().manual_seed(1)),
        K).float().to(dev)
    km_z = torch.cat([torch.ones((B, Dz), device=dev),
                      torch.zeros((B, K), device=dev)], 1)
    vk_z = torch.cat([j["z"][:, :Dz], torch.zeros((B, K), device=dev)], 1)
    vk_y = torch.cat([torch.zeros((B, Dz), device=dev), y], 1)
    groups = ((Dz, Dz + K),)
    for n in (30, 50):
        cases.append((f"flagship mean-field {n} steps", j, vk_z, km_z,
                      torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1).to(dev),
                      groups, None, None, True, n == 50))
    cases.append(("flagship noisy 30 steps", j, vk_y, 1.0 - km_z, aux_sched,
                  groups, None, 0xC0FFEE, False, True))
    cases.append(("flagship noisy 50 steps + mu", j, vk_y, 1.0 - km_z,
                  rbm_ops.annealed_schedule(50, 3.0, 1.0, 0.9, 3, 0.9,
                                            0.15).to(dev), groups, j["mu"],
                  0xBEEF, False, True))
    for Bs in (26, 12):
        cases.append((f"flagship noisy 30 steps B={Bs}", j, vk_y[:Bs],
                      1.0 - km_z[:Bs], aux_sched, groups, None, 0xC0FFEE,
                      False, Bs == 26))
    cases.append(("flagship noisy 50 steps + mu B=26", j, vk_y[:26],
                  1.0 - km_z[:26],
                  rbm_ops.annealed_schedule(50, 3.0, 1.0, 0.9, 3, 0.9,
                                            0.15).to(dev), groups, j["mu"],
                  0xBEEF, False, True))
    cases.append(("flagship noisy 30 steps + mu, two groups", j, vk_y,
                  1.0 - km_z, aux_sched, ((56, 72), (Dz, Dz + K)), j["mu"],
                  0xC0FFEE, True, False))
    # bimodal joint layer 0: [z_mod1 (1500) ⊕ z_mod2 (1000)], mod1 clamped
    for Bb in (128, 12):
        jb = chain_inputs(dev, Bb, 2500, 1500, 1500, 3)
        km1 = torch.cat([torch.ones((Bb, 1500), device=dev),
                         torch.zeros((Bb, 1000), device=dev)], 1)
        cases.append((f"bimodal noisy 30 steps B={Bb}", jb, jb["z"] * km1,
                      km1, aux_sched, (), None, 0xFACE, False, True))
    # the flagship joint at the batch sizes a serving request brings
    for Br in (1, 3, 96, 200):
        jr = chain_inputs(dev, Br, Dz + K, 500, Dz, 10 + Br)
        yr = torch.nn.functional.one_hot(
            torch.arange(Br) % K, K).float().to(dev)
        km_r = torch.cat([torch.ones((Br, Dz), device=dev),
                          torch.zeros((Br, K), device=dev)], 1)
        cases.append((f"serving txt2img B={Br}: noisy 50 steps + mu", jr,
                      torch.cat([torch.zeros((Br, Dz), device=dev), yr], 1),
                      1.0 - km_r,
                      rbm_ops.annealed_schedule(50, 3.0, 1.0, 0.9, 3, 0.9,
                                                0.15).to(dev), groups,
                      jr["mu"], 0x5E21 + Br, False, True))
        cases.append((f"serving img2txt B={Br}: mean-field 50 steps + final",
                      jr, torch.cat([jr["z"][:, :Dz],
                                     torch.zeros((Br, K), device=dev)], 1),
                      km_r,
                      torch.tensor([[1.0, 0.0, 0.0]]).repeat(50, 1).to(dev),
                      groups, None, None, True, True))
    rows = {}
    for name, j, vk, km, sched, groups, mu, seed, final, timed in cases:
        Bc, V = vk.shape
        H = j["w"].shape[1]
        if mu is not None:
            mu = mu[:Bc]
        v0 = vk * km + (1.0 - km) * j["u"][:Bc]
        args = (j["w"], j["hb"], j["vb"], v0, vk, km, sched)
        kw = dict(groups=groups, mu=mu, seed=seed, final_unclamped=final)
        body = chain.body(V, H, groups)
        plan = chain.plan(Bc, V, H, sched.shape[0], final, groups=groups)
        before = dict(chain.KERNEL.launches_by_body)
        out_k = chain.clamped_chain(*args, **kw)
        out_p = chain.chain_plain(*args, **kw)
        torch.cuda.synchronize()
        if chain.KERNEL.launches_by_body != dict(
                before, **{body: before[body] + 1}):
            raise AssertionError(f"chain {name}: not one {body} launch")
        err = float((out_k - out_p).abs().max())
        finite = bool(torch.isfinite(out_k).all())
        log(f"[chain] {name}: {body} body, grid {plan['grid']} blocks "
            f"(clusters of {plan['cluster']}), {plan['tile_rows']} rows a "
            f"tile or cluster, k-parts {plan['slices_h']} / "
            f"{plan['slices_v']}, {plan['barriers']} grid barriers, "
            f"{plan['smem_bytes']} B shared a block; max|dv| {err:.3e}")
        if not (finite and err <= TOL_CHAIN):
            raise AssertionError(f"chain {name} disagrees with plain")
        if not timed:
            continue
        n = sched.shape[0]
        plain_ms = time_ms(lambda: chain.chain_plain(*args, **kw), 3)
        bnd = bounds(
            (n + int(final)) * 2 * 2.0 * Bc * V * H,
            4.0 * (V * H + V + H + 4 * Bc * V
                   + (0 if mu is None else mu.numel()) + 3 * n))
        timed_bodies = {}
        for b in ([body] + [o for o in chain.BODIES if o != body]
                  if body == "cluster" else [body]):
            def run(b=b):
                return chain._launch(*args, groups, mu, seed, final,
                                     body_name=b)
            if b != body:    # the forced body against the plain version
                err_b = float((run() - out_p).abs().max())
                if not err_b <= TOL_CHAIN:
                    raise AssertionError(f"chain {name} on the {b} body "
                                         f"disagrees with plain")
            timed_bodies[b] = dict(ms=time_ms(run, 5),
                                   device_ms=launch_ms(run),
                                   graph_ms=graph_ms(run, 10))
            t = timed_bodies[b]
            log(f"[chain] {name}, {b} body: kernel {t['ms']:.4f} ms (one "
                f"launch between events {t['device_ms']:.4f}, graph replay "
                f"{t['graph_ms']:.4f}), plain {plain_ms:.4f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), fp32 bound "
                f"{bnd['bound_fp32_ms']:.4f} ms")
        rows[name] = dict(shape=name, body=body, max_abs_err=err,
                          **timed_bodies[body], plain_ms=plain_ms,
                          library_ms=None, grid=plan["grid"],
                          barriers=plan["barriers"],
                          by_body=timed_bodies, **bnd)
    return rows


def check_learns(dev):
    """RBM(64, 32) on noisy bars through the fused CD path (the verify
    skill's drive 1): reconstruction MSE must drop by more than 2x."""
    import numpy as np
    import torch
    from multimodal_idbn_tpu_torch.models import RBM
    rs = np.random.RandomState(0)
    x = np.zeros((256, 8, 8), np.float32)
    for i in range(256):
        k = rs.randint(0, 8)
        if rs.rand() < 0.5:
            x[i, k, :] = 1.0
        else:
            x[i, :, k] = 1.0
    x = np.where(rs.rand(*x.shape) < 0.05, 1.0 - x, x).reshape(256, 64)
    rbm = RBM(64, 32, learning_rate=0.1, weight_decay=1e-4, momentum=0.5,
              seed=0, device=dev)
    xt = torch.as_tensor(x, device=dev)

    def recon_mse():
        return float(((xt - rbm.backward(rbm.forward(xt))) ** 2).mean())

    before = recon_mse()
    for epoch in range(30):
        rbm.train_epoch(xt, epoch, 30, CD=1)
    after = recon_mse()
    log(f"[learns] RBM(64,32) noisy bars: recon MSE {before:.4f} -> "
        f"{after:.4f}")
    if not after * 2 < before:
        raise AssertionError("RBM did not learn (MSE drop <= 2x)")


def check_states(states, widths):
    import torch
    for st in states:
        for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m"):
            if not bool(torch.isfinite(getattr(st, f)).all()):
                raise AssertionError(f"non-finite {f} after training")
    got = [tuple(s.w.shape) for s in states]
    if got != widths:
        raise AssertionError(f"unexpected widths {got}, expected {widths}")


def cut_states(name, model):
    """(every RBM state of a trained cut, the widths they must have)."""
    if name == "flagship-cut":
        return (model.image_idbn.states() + [model.joint_rbm.state],
                [(10000, 1500), (1500, 500), (532, 500)])
    return (model.mod1_dbn.states() + model.mod2_dbn.states()
            + [r.state for r in model.joint_layers],
            [(10000, 1500), (1500, 1500), (1568, 500), (500, 500),
             (500, 1000), (2500, 1500), (1500, 500)])


def run_path(name, workdir: Path):
    """Train one cut at full width with the launch counts reset just
    before and read just after; check what comes out."""
    from multimodal_idbn_tpu_torch import cuts
    reset_launches()
    summary = cuts.run_cut(name, workdir)
    launches = read_launches()
    model = summary["model"]
    check_states(*cut_states(name, model))
    if name == "flagship-cut":
        m = summary["cross_metrics"]
        if m is None or not all(v == v for v in m.values()):
            raise AssertionError(f"no finite cross metrics: {m}")
        extra = f"image CD loss {summary['image_loss']}"
    else:
        m = {"mse_mod1": summary["mse_mod1"], "mse_mod2": summary["mse_mod2"]}
        if not all(isinstance(v, float) and math.isfinite(v)
                   for v in m.values()):
            raise AssertionError(f"no finite cross MSEs: {m}")
        extra = (f"MOD1 CD loss {summary['mod1_loss']}, MOD2 CD loss "
                 f"{summary['mod2_loss']}")
    log(f"[{name}] launches {json.dumps(launches)}; phase seconds "
        f"{json.dumps(summary['seconds'])}; {extra}; cross metrics "
        f"{json.dumps(m)}")
    if min(launches[k] for k in ("half_step_sample", "chain_run",
                                 "philox_fill", "graph_replays")) <= 0:
        raise AssertionError(f"{name}: a kernel was not launched, or no "
                             f"epoch replayed a graph: {launches}")
    return launches, summary


def run_resident_drive(dev, model):
    """Kernels 3 and 4 through their public functions on the trained
    bimodal model: encode 128 MOD2 images (hidden_probs_kernel, the
    counterpart of hidden_probs_pallas) and sample joint layer 0's hidden
    units for the joint input of the same batch."""
    import torch
    from multimodal_idbn_tpu_torch.device import as_tensor
    from multimodal_idbn_tpu_torch.ops import half_step, rbm_ops
    m1, m2 = model.dataloader.materialize()
    v1, v2 = as_tensor(m1[:128], dev), as_tensor(m2[:128], dev)
    mod2_l0, joint0 = model.mod2_dbn.states()[0], model.joint_rbm.state
    v_joint = torch.cat([model.mod1_dbn.represent(v1),
                         model.mod2_dbn.represent(v2)], dim=1)
    seed = 20260
    reset_launches()
    z2_first = half_step.hidden_probs_kernel(mod2_l0, v2)
    p_joint, s_joint = half_step.half_step_sample_resident(
        v_joint, joint0.w, joint0.hb, seed)
    launches = read_launches()
    err = max(float((z2_first - rbm_ops.hidden_probs(mod2_l0, v2)).abs()
                    .max()),
              float((p_joint - rbm_ops.hidden_probs(joint0, v_joint)).abs()
                    .max()))
    p_plain, s_plain = half_step.half_step_sample_resident_plain(
        v_joint, joint0.w, joint0.hb, seed)
    flips, bad = sample_flips(p_plain, s_joint, s_plain, seed)
    log(f"[resident-drive] launches {json.dumps(launches)}; shapes "
        f"{tuple(v2.shape)}x{tuple(mod2_l0.w.shape)}, "
        f"{tuple(v_joint.shape)}x{tuple(joint0.w.shape)}; max|dp| "
        f"{err:.3e}, sample flips {flips} (outside tol: {bad})")
    if not err <= TOL_HALF_STEP or bad:
        raise AssertionError("resident drive disagrees with plain")
    if (launches["half_step_probs"] <= 0
            or launches["half_step_sample_resident"] <= 0):
        raise AssertionError(f"resident drive: a kernel was not launched: "
                             f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# Save -> load -> serve, generate, resume, retry and fine-tune
# ---------------------------------------------------------------------------

def model_states(model):
    """Every parameter and momentum tensor of a model, by name."""
    from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    return {f"{name}/{f}": getattr(rbm.state, f)
            for name, rbm in _collect_rbms(model).items()
            for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m")}


def assert_bit_equal(a, b, what: str) -> None:
    import torch
    sa, sb = model_states(a), model_states(b)
    if sorted(sa) != sorted(sb):
        raise AssertionError(f"{what}: different sets of states")
    for k in sa:
        if not torch.equal(sa[k], sb[k]):
            diff = float((sa[k] - sb[k]).abs().max())
            raise AssertionError(f"{what}: {k} differs (max abs {diff:.3e})")
    for attr in ("z_class_mean",):
        za, zb = getattr(a, attr, None), getattr(b, attr, None)
        if (za is None) != (zb is None) or (
                za is not None and not torch.equal(za, zb)):
            raise AssertionError(f"{what}: {attr} differs")


def timed_call(fn):
    """(result, wall ms on the host clock around the synchronised call,
    ms between CUDA events just before and just after it)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx"}
# spin kernels launched, and waited for, at the start of each profile
HEAD = 32


def busy_ms(fn):
    """(device busy ms, device operations, kernel records missing) of one
    profiled call.

    A profile is complete when it holds a device record for every kernel
    launch it saw on the host. On the H100 the profiler keeps every launch
    call but can lose the records of the first kernels launched after it
    starts, all of a small call's at times. So each profile starts
    with ``HEAD`` spin kernels, waited for and left out of the counts,
    before the call. A profile with records missing all the same is taken
    once more, and the attempt with fewer missing is returned; its busy ms
    then count only the recorded kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from multimodal_idbn_tpu_torch.profile_main_path import _device_kernels
    best = None
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(HEAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        kernels, busy, _ = _device_kernels(prof, skip="spin_kernel")
        launched = sum(e.name in LAUNCH_CALLS for e in prof.events()) - HEAD
        ran = sum(not e.name.startswith(("Memcpy", "Memset"))
                  for e in kernels)
        got = (busy / 1e3, len(kernels), max(launched - ran, 0))
        if best is None or got[2] < best[2]:
            best = got
        if not got[2]:
            break
        log(f"[profile] attempt {attempt}: {launched} kernel launches on the "
            f"host, {ran} kernel records on the device")
    return best


SERVE_SEED = 20261
KERNEL_ENTRIES = ("half_step_sample", "half_step_probs",
                  "half_step_sample_resident", "chain_run", "philox_fill",
                  "half_step_gauss", "half_step_linear", "half_step_scaled",
                  "rs_sample")


@contextlib.contextmanager
def replays_checked():
    """Inside the block every replay of a graph of a model's cache (a
    pure call or an in-place update whose signature was captured before:
    the buffers' refresh, the key table's copy, the replay and the
    outputs' clones) runs under ``torch.cuda.set_sync_debug_mode("error")``:
    a host synchronisation raises."""
    import torch
    from multimodal_idbn_tpu_torch.ops import graphs
    real_call, real_update = (graphs.ServingGraphs.call,
                              graphs.ServingGraphs.update)

    def checked(self, sig, real, *a, **k):
        if sig not in self.graphs:
            return real(self, *a, **k)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def call(self, fn, key, *args, **kwargs):
        return checked(self, self.signature(fn, args, kwargs), real_call,
                       fn, key, *args, **kwargs)

    def update(self, fn, key, state, *args, **kwargs):
        return checked(self, self.signature(fn, args, kwargs, state, True),
                       real_update, fn, key, state, *args, **kwargs)

    graphs.ServingGraphs.call = call
    graphs.ServingGraphs.update = update
    try:
        yield
    finally:
        graphs.ServingGraphs.call = real_call
        graphs.ServingGraphs.update = real_update


def serve_three_ways(m, call, reseed):
    """``call(m)`` three times from the same key stream (``reseed(m)``
    before each): launch by launch (``graphs.launch_by_launch``), its
    first call through the model's graph cache (a capture where the
    signature is new, then a replay) and once more (replays alone, under
    ``replays_checked``). Returns [(output, launches, captures)] in that
    order."""
    import torch
    from multimodal_idbn_tpu_torch.ops import graphs
    runs = []
    for way in ("launch by launch", "first call", "replay"):
        reseed(m)
        reset_launches()
        with (graphs.launch_by_launch() if way == "launch by launch" else
              replays_checked() if way == "replay" else
              contextlib.nullcontext()):
            out = call(m)
        torch.cuda.synchronize()
        runs.append((out, read_launches(), list(graphs.STATS["captures"])))
    return runs


def check_served(name, runs, want, rows, simplex=False):
    """The three runs of ``serve_three_ways``: outputs bit-equal; each
    kernel's launches equal in the three and to ``want`` (derived), with
    ``want["serving_replays"]`` replays (one per call that JAX jits) in
    the cache's runs and none launch by launch; no capture in the last
    run; every output finite with ``rows`` rows, its values in [0, 1] or,
    with ``simplex``, its rows summing to 1. Returns (the output, the
    launches of a replayed call, the captures of the first call)."""
    import torch
    from multimodal_idbn_tpu_torch.ops import graphs
    (eager, le, _), (first, lf, caps), (again, lr, caps2) = runs
    for what, out in (("first call", first), ("replay", again)):
        if not _trees_equal(out, eager):
            raise AssertionError(f"{name}: the {what} through the graph "
                                 f"cache is not bit-equal to launch by "
                                 f"launch")
    kernels = {k: le.get(k, 0) for k in KERNEL_ENTRIES}
    for what, got in (("first call", lf), ("replay", lr)):
        if {k: got.get(k, 0) for k in KERNEL_ENTRIES} != kernels:
            raise AssertionError(f"{name}: launches {got} in the {what}, "
                                 f"{le} launch by launch")
    derived = dict(dict.fromkeys(KERNEL_ENTRIES, 0), **want)
    got = dict(kernels, serving_replays=lr["serving_replays"])
    if got != derived or le["serving_replays"] or \
            lf["serving_replays"] != want["serving_replays"] or caps2:
        raise AssertionError(f"{name}: launches {got}, derived {derived}; "
                             f"replays launch by launch "
                             f"{le['serving_replays']}, first call "
                             f"{lf['serving_replays']}; captures in the "
                             f"replay run {len(caps2)}")
    leaves, _ = graphs.flatten(eager)
    for t in leaves:
        if t.shape[0] != rows or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: bad output {tuple(t.shape)}")
        if simplex:
            off = float((t.sum(dim=1) - 1.0).abs().max())
            if not off <= 1e-5:
                raise AssertionError(f"{name}: rows sum to 1 +- {off:.2e}")
        elif float(t.min()) < 0.0 or float(t.max()) > 1.0:
            raise AssertionError(f"{name}: values outside [0, 1]")
    return eager, lr, caps


def drive_launches(calls) -> dict:
    """The launches of every call of ``calls`` once, summed from each
    call's derivation (the second item of each entry)."""
    total = dict.fromkeys(KERNEL_ENTRIES + ("serving_replays",), 0)
    for entry in calls.values():
        for k, n in entry[1].items():
            total[k] += n
    return total


def time_served(name, m, call, reps: int = 5) -> dict:
    """Median wall and CUDA-event ms of ``call(m)`` over ``reps`` calls,
    and the device busy ms of one profiled call, replayed and launch by
    launch."""
    import statistics
    from multimodal_idbn_tpu_torch.ops import graphs
    row = {}
    for way in ("replayed", "launch by launch"):
        with (graphs.launch_by_launch() if way == "launch by launch"
              else contextlib.nullcontext()):
            call(m)
            times = [timed_call(lambda: call(m))[1:] for _ in range(reps)]
            busy, ops, missing = busy_ms(lambda: call(m))
        row[way] = dict(
            wall_ms=round(statistics.median(t[0] for t in times), 4),
            event_ms=round(statistics.median(t[1] for t in times), 4),
            busy_ms=round(busy, 4), device_ops=ops, records_missing=missing)
    log(f"[serve] {name}: replayed {json.dumps(row['replayed'])}; launch "
        f"by launch {json.dumps(row['launch by launch'])}")
    return row


def log_captures(tag: str, caps) -> None:
    for c in caps:
        log(f"[{tag}] capture {c['name']} at {c['shapes'][-2:]}: "
            f"{c['seconds']:.3f} s, graph pool "
            f"{c['pool_bytes'] / 2 ** 20:.1f} MiB, launches per replay "
            f"{json.dumps(c['launches'])}")


def run_serving(dev, model, workdir: Path):
    """Phase 6. Returns (launches of the serving drive, the pickle's path,
    the txt2img images of all 32 labels x 4 under SERVE_SEED)."""
    import numpy as np
    import torch
    from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform
    from multimodal_idbn_tpu_torch.models import iMDBN

    t_phase = time.perf_counter()
    pkl = workdir / "served.pkl"
    t0 = time.perf_counter()
    model.save_model(str(pkl))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload = iMDBN.load_model(str(pkl))
    loaded = iMDBN.from_payload(payload)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[serve] pickle {pkl.stat().st_size / 2**20:.1f} MiB, written in "
        f"{save_s:.3f} s, loaded onto the card in {load_s:.3f} s")
    if loaded.device.type != "cuda" or not loaded.joint_rbm.W.is_cuda:
        raise AssertionError("the loaded model is not on the card")
    if loaded.params is not payload["params"] or \
            loaded.image_idbn.params is not loaded.params:
        raise AssertionError("from_payload broke the shared params object")
    assert_bit_equal(model, loaded, "loaded model vs trained model")

    # 128 unseen images at the flagship's size (its cut's own validation
    # split holds 58)
    images = create_dataloaders_uniform(
        batch_size=128, num_classes=32, n_samples=1024, side=100,
        seed=1)[1].materialize()[0][:128]
    all_labels = np.repeat(np.arange(32), 4)
    # derived launches: a mean-field call one chain and its init's one
    # fill; the sampled chain one fill for its init and three a step (h,
    # v, the label group's Gumbel), its decode one a layer above the
    # bottom; replays: img2txt encodes (dbn_represent), then the cross
    sampled = (1 + 3 * loaded.cross_steps
               + len(loaded.image_idbn.layers) - 1)
    mean = dict(chain_run=1, philox_fill=1)
    calls = {  # name: (call, derived launches, result rows, simplex)
        "txt2img B=128": (lambda m: m.txt2img(all_labels),
                          dict(mean, serving_replays=1), 128, False),
        "txt2img B=3": (lambda m: m.txt2img([3, 7, 12]),
                        dict(mean, serving_replays=1), 3, False),
        "img2txt B=128": (lambda m: m.img2txt(images),
                          dict(mean, serving_replays=2), 128, True),
        "img2txt B=1": (lambda m: m.img2txt(images[:1]),
                        dict(mean, serving_replays=2), 1, True),
        "sample_txt2img B=128": (
            lambda m: m.sample_txt2img(all_labels, seed=SERVE_SEED),
            dict(philox_fill=sampled, serving_replays=1), 128, False),
        "sample_txt2img B=3": (
            lambda m: m.sample_txt2img([3, 7, 12], seed=SERVE_SEED),
            dict(philox_fill=sampled, serving_replays=1), 3, False),
    }

    def reseed(m):
        m.joint_rbm.reseed(SERVE_SEED)

    outputs, captures = {}, []
    for name, (call, want, rows, simplex) in calls.items():
        out = {}
        for tag, m in (("trained", model), ("loaded", loaded)):
            out[tag], launches, caps = check_served(
                f"{name} ({tag})", serve_three_ways(m, call, reseed), want,
                rows, simplex)
            captures += caps
        if not torch.equal(out["trained"], out["loaded"]):
            raise AssertionError(f"{name}: the loaded model's output differs "
                                 f"from the trained model's")
        outputs[name] = out["trained"]
        log(f"[serve] {name}: capture then replay bit-equal to launch by "
            f"launch, trained and loaded; launches per call "
            f"{json.dumps(launches)}")
        time_served(name, loaded, call)
    log_captures("serve", captures)
    again = loaded.sample_txt2img(all_labels, seed=SERVE_SEED)
    other = loaded.sample_txt2img(all_labels, seed=SERVE_SEED + 1)
    if not torch.equal(again, outputs["sample_txt2img B=128"]) or \
            torch.equal(other, again):
        raise AssertionError("sample_txt2img: one seed must give one draw "
                             "and two seeds two")
    reset_launches()
    for call, _, _, _ in calls.values():
        call(loaded)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[serve] serving drive (six calls on the loaded model): launches "
        f"{json.dumps(launches)}")
    check_launches("serving drive", launches, drive_launches(calls))

    # the weights change under the graphs: one more image epoch and one
    # more joint epoch; every call must serve the new weights, from the
    # same graphs
    graphs_before = sum(len(o._serving.graphs)
                        for o in (model, model.image_idbn))
    model.image_idbn.train(2, start_epoch=1)
    done = len(model.joint_metrics_history)
    model.train_joint(done + 1, start_epoch=done)
    for name, (call, want, rows, simplex) in calls.items():
        runs = serve_three_ways(model, call, reseed)
        out, _, caps = check_served(f"{name} (trained further)", runs, want,
                                    rows, simplex)
        if caps or torch.equal(out, outputs[name]):
            raise AssertionError(f"{name}: after training, {len(caps)} "
                                 f"captures and an output that did not "
                                 f"change")
    graphs_after = sum(len(o._serving.graphs)
                       for o in (model, model.image_idbn))
    log(f"[serve] after one more image and one more joint epoch: every call "
        f"bit-equal to launch by launch on the new weights, every output "
        f"changed, no new capture ({graphs_before} graphs before training, "
        f"{graphs_after} after, the training's own encode included)")
    log(f"[serve] phase 6: {time.perf_counter() - t_phase:.1f} s")
    return launches, pkl, outputs["txt2img B=128"]


def run_bimodal_serving(dev, model):
    """Phase 6b: the bimodal serving calls on bimodal-cut's trained model
    and on the same model pickled and loaded onto the card, at B = 128 and
    B = 3: ``mod1_to_mod2`` / ``mod2_to_mod1`` (the modality encode, then
    the cross through joint layer 0: sampled h, no chain kernel, one fill
    for the init and one a step), ``_cross_reconstruct`` both ways on
    given latents, and ``sample_mod1_to_mod2`` / ``sample_mod2_to_mod1``
    (the sampled chain: a fill for the init and two a step; the decode one
    a layer above the bottom). Each through ``serve_three_ways``. Returns
    the launches of the drive (every call once on the loaded model)."""
    import pickle
    import torch
    from multimodal_idbn_tpu_torch.device import as_tensor

    t_phase = time.perf_counter()
    loaded = pickle.loads(pickle.dumps(model)).to(dev)
    assert_bit_equal(model, loaded, "bimodal loaded vs trained")
    m1, m2 = model.dataloader.materialize()
    v1, v2 = as_tensor(m1[:128], dev), as_tensor(m2[:128], dev)
    z1, z2 = model._latents(v1, v2)
    steps = model.cross_steps
    cross = dict(philox_fill=1 + steps)

    def sampled(target):      # the chain's init, h and v a step, the decode
        return dict(philox_fill=1 + 2 * steps + len(target.layers) - 1,
                    serving_replays=2)

    calls = {}
    for b in (128, 3):
        calls.update({
            f"mod1_to_mod2 B={b}": (lambda m, b=b: m.mod1_to_mod2(v1[:b]),
                                    dict(cross, serving_replays=2), b),
            f"mod2_to_mod1 B={b}": (lambda m, b=b: m.mod2_to_mod1(v2[:b]),
                                    dict(cross, serving_replays=2), b),
            f"_cross_reconstruct both B={b}": (
                lambda m, b=b: m._cross_reconstruct(z1[:b], z2[:b]),
                dict(philox_fill=2 * (1 + steps), serving_replays=1), b),
            f"sample_mod1_to_mod2 B={b}": (
                lambda m, b=b: m.sample_mod1_to_mod2(v1[:b],
                                                     seed=SERVE_SEED),
                sampled(model.mod2_dbn), b),
            f"sample_mod2_to_mod1 B={b}": (
                lambda m, b=b: m.sample_mod2_to_mod1(v2[:b],
                                                     seed=SERVE_SEED),
                sampled(model.mod1_dbn), b),
        })

    def reseed(m):
        m.joint_rbm.reseed(SERVE_SEED)

    captures = []
    for name, (call, want, rows) in calls.items():
        out = {}
        for tag, m in (("trained", model), ("loaded", loaded)):
            out[tag], launches, caps = check_served(
                f"bimodal {name} ({tag})", serve_three_ways(m, call, reseed),
                want, rows)
            captures += caps
        if not _trees_equal(out["trained"], out["loaded"]):
            raise AssertionError(f"bimodal {name}: the loaded model's output "
                                 f"differs from the trained model's")
        log(f"[serve-bimodal] {name}: capture then replay bit-equal to "
            f"launch by launch, trained and loaded; launches per call "
            f"{json.dumps(launches)}")
        if rows == 128:
            time_served(f"bimodal {name}", loaded, call)
    log_captures("serve-bimodal", captures)
    reset_launches()
    for call, _, _ in calls.values():
        call(loaded)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[serve-bimodal] drive (ten calls on the loaded model): launches "
        f"{json.dumps(launches)}; {time.perf_counter() - t_phase:.1f} s")
    check_launches("bimodal serving drive", launches, drive_launches(calls))
    return launches


def run_generate(pkl: Path, workdir: Path, mean_images):
    """Phase 7: the serving entry point as a user runs it, both modes
    started together."""
    import numpy as np
    labels = [str(i) for i in range(32)]
    procs, images = {}, {}
    try:
        for mode in ("sampled", "mean"):
            out = workdir / f"generate-{mode}.npz"
            procs[mode] = (out, subprocess.Popen(
                [sys.executable, "-m", "multimodal_idbn_tpu_torch.generate",
                 "--model", str(pkl), "--labels", *labels, "--n-per-label",
                 "4", "--seed", str(SERVE_SEED), "--out", str(out)]
                + (["--mean"] if mode == "mean" else []),
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        t0 = time.perf_counter()
        for mode, (out, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"generate ({mode}) exited with "
                                     f"{proc.returncode}: {stderr[-2000:]}")
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("[generate]")][-1]
            with np.load(out) as f:
                imgs, ids = f["images"], f["labels"]
            if imgs.shape != (128, 10000) or ids.shape != (128,) or \
                    not np.array_equal(ids, np.repeat(np.arange(32), 4)):
                raise AssertionError(f"generate ({mode}): shapes "
                                     f"{imgs.shape}, {ids.shape}")
            if not np.isfinite(imgs).all() or imgs.min() < 0 or \
                    imgs.max() > 1:
                raise AssertionError(f"generate ({mode}): values outside "
                                     f"[0, 1]")
            if mode == "mean" and not np.array_equal(
                    imgs, mean_images.cpu().numpy()):
                raise AssertionError("generate --mean differs from txt2img "
                                     "under the same seed")
            log(f"[generate] {mode}: exit 0 after "
                f"{time.perf_counter() - t0:.1f} s; {line}")
            images[mode] = imgs
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # the same requests in this process, with the replays counted: one
    # capture and one replay per request (a fresh model's first call)
    from multimodal_idbn_tpu_torch import generate
    from multimodal_idbn_tpu_torch.ops import graphs
    for mode, (out, _) in procs.items():
        reset_launches()
        imgs = generate.main(
            ["--model", str(pkl), "--labels", *labels, "--n-per-label", "4",
             "--seed", str(SERVE_SEED), "--out", str(out)]
            + (["--mean"] if mode == "mean" else []))
        launches, caps = read_launches(), list(graphs.STATS["captures"])
        if not np.array_equal(imgs, images[mode]) or len(caps) != 1 or \
                launches["serving_replays"] != 1:
            raise AssertionError(f"generate ({mode}) in process: "
                                 f"{len(caps)} captures, launches "
                                 f"{launches}, images equal to the "
                                 f"subprocess's: "
                                 f"{np.array_equal(imgs, images[mode])}")
        log(f"[generate] {mode} in process: one capture "
            f"({caps[0]['seconds']:.3f} s, graph pool "
            f"{caps[0]['pool_bytes'] / 2 ** 20:.1f} MiB) and one replay, "
            f"images equal to the subprocess's; launches "
            f"{json.dumps(launches)}")


class Interrupted(Exception):
    """Raised right after a checkpoint write, as a kill there would."""


@contextlib.contextmanager
def interrupt_after(at_phase: str, at_epoch: int):
    """Inside the block, the save of the ``at_phase`` checkpoint that
    resumes at ``at_epoch`` is written and then raises ``Interrupted``."""
    from multimodal_idbn_tpu_torch import checkpoint
    real = checkpoint.save_train_checkpoint

    def interrupting(model, path, phase, next_epoch, loss_history=None):
        real(model, path, phase=phase, next_epoch=next_epoch,
             loss_history=loss_history)
        if phase == at_phase and int(next_epoch) == at_epoch:
            raise Interrupted(f"{phase} checkpoint of epoch {next_epoch}")

    checkpoint.save_train_checkpoint = interrupting
    try:
        yield
    finally:
        checkpoint.save_train_checkpoint = real


def run_resume(name: str, stops, workdir: Path):
    """Phase 8 for one cut. ``stops`` are (phase, next_epoch) pairs; each
    is a run interrupted right after that checkpoint write and then run
    again with the same config. Returns the launches of the last resumed
    run."""
    from multimodal_idbn_tpu_torch import cuts
    over = cuts.RESUME[name]

    def run(tag):
        d = workdir / f"{name}-{tag}"
        d.mkdir(exist_ok=True)
        return cuts.run_cut(name, d, overrides=over), d

    straight, sdir = run("straight")
    if any((sdir / "checkpoints").iterdir()):
        raise AssertionError(f"{name}: checkpoints left after a completed "
                             f"run")
    history = straight["model"].joint_metrics_history
    log(f"[resume] {name}: uninterrupted run with checkpoints every "
        f"{over['training']['checkpoint_every']} epochs, phase seconds "
        f"{json.dumps(straight['seconds'])}")
    launches = None
    for i, (phase, epoch) in enumerate(stops):
        tag = f"{phase}-{epoch}"
        try:
            with interrupt_after(phase, epoch):
                run(tag)
        except Interrupted:
            pass
        else:
            raise AssertionError(f"{name}: no {phase} checkpoint of epoch "
                                 f"{epoch} was written")
        ckpt = workdir / f"{name}-{tag}" / "checkpoints" / f"{phase}.ckpt.npz"
        if not ckpt.exists():
            raise AssertionError(f"{name}: {ckpt} is missing")
        size = ckpt.stat().st_size / 2**20
        if i == 0:
            # a changed learning rate must refuse to resume
            changed = {"training": dict(over["training"],
                                        learning_rate=0.05)}
            try:
                cuts.run_cut(name, workdir / f"{name}-{tag}",
                             overrides=changed)
            except ValueError as e:
                if "was written by a run with different training " \
                        "configuration (LEARNING_RATE: checkpoint=0.1 " \
                        "run=0.05)" not in str(e):
                    raise
                log(f"[resume] {name}: a changed learning_rate refuses to "
                    f"resume")
            else:
                raise AssertionError(f"{name}: a changed learning_rate "
                                     f"resumed")
        reset_launches()
        resumed, rdir = run(tag)
        launches = read_launches()
        assert_bit_equal(straight["model"], resumed["model"],
                         f"{name} resumed after the {phase} checkpoint of "
                         f"epoch {epoch}")
        if resumed["model"].joint_metrics_history != history:
            raise AssertionError(f"{name}: joint_metrics_history differs "
                                 f"after the resume from {tag}")
        if any((rdir / "checkpoints").iterdir()):
            raise AssertionError(f"{name}: checkpoints left after the "
                                 f"resumed run")
        log(f"[resume] {name}: stopped after the {phase} checkpoint of "
            f"epoch {epoch} ({size:.1f} MiB), run again: states and "
            f"{len(history)} epochs of joint metrics bit-equal to the "
            f"uninterrupted run; launches {json.dumps(launches)}")
    return launches, straight["model"]


def time_checkpoint(model, workdir: Path, label: str) -> None:
    from multimodal_idbn_tpu_torch import checkpoint
    path = workdir / f"{label}.ckpt.npz"
    t0 = time.perf_counter()
    checkpoint.save_train_checkpoint(model, str(path), phase="joint",
                                     next_epoch=1)
    log(f"[resume] {label} checkpoint: {path.stat().st_size / 2**20:.1f} "
        f"MiB written in {time.perf_counter() - t0:.3f} s")
    path.unlink()


def run_retry_finetune(dev, workdir: Path):
    """Phase 9: the retry rescue and the last-layer fine-tune at the
    flagship's width, through the model's methods."""
    import yaml
    import torch
    from multimodal_idbn_tpu_torch import cuts, train_multimodal
    from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform
    from multimodal_idbn_tpu_torch.models import iMDBN
    cfg = yaml.safe_load(cuts.write_cut("flagship-cut", workdir).read_text())
    params = train_multimodal.build_params(cfg)
    train, val, _ = create_dataloaders_uniform(
        batch_size=cfg["dataset"]["batch_size"],
        num_classes=cfg["model"]["num_labels"],
        n_samples=cfg["dataset"]["n_samples"], side=cfg["dataset"]["side"])
    m = iMDBN(cfg["model"]["image_layers"], cfg["model"]["joint_hidden"],
              params=params, dataloader=train, val_loader=val, device=dev,
              num_labels=cfg["model"]["num_labels"], seed=params["SEED"])
    reset_launches()
    retries = m.image_idbn.train_with_retry(2, max_retries=1)
    after_retry = read_launches()
    ratio = m.image_idbn._recon_collapse_ratio()
    lr_before = m.image_idbn.layers[-1].lr
    reset_launches()
    m.finetune_image_last_layer(epochs=1, lr_scale=0.3)
    torch.cuda.synchronize()
    after_ft = read_launches()
    check_states(m.image_idbn.states(), [(10000, 1500), (1500, 500)])
    log(f"[retry] train_with_retry(2 epochs, max_retries=1): {retries} "
        f"retries, recon/blank ratio {ratio:.3f}, launches "
        f"{json.dumps(after_retry)}; finetune_image_last_layer(1 epoch): "
        f"launches {json.dumps(after_ft)}")
    # 2 epochs x 3 batches x 2 layers x (1 + 2 x CD-10) half-steps per
    # attempt; the fine-tune trains the top layer on 3 batches
    want = 2 * 3 * 2 * 21 * (1 + retries)
    if after_retry["half_step_sample"] != want or \
            after_ft["half_step_sample"] != 3 * 21:
        raise AssertionError(f"retry / fine-tune launches {after_retry} / "
                             f"{after_ft}, expected {want} / 63 half-steps")
    if m.image_idbn.layers[-1].lr != lr_before:
        raise AssertionError("the fine-tune did not restore the learning "
                             "rate")
    total = {k: after_retry[k] + after_ft[k] for k in after_retry}
    return total


# ---------------------------------------------------------------------------
# Phase 10: the diagnostics drive
# ---------------------------------------------------------------------------

def state_copy(model):
    """Every state of a model, copied off the card."""
    return {k: v.detach().cpu().clone() for k, v in
            model_states(model).items()}


def check_diagnostics_run(name: str, run, model, ref_states, ref_keys):
    """Phase 10 (c) and (d) for one cut's logged run."""
    import torch
    from multimodal_idbn_tpu_torch.utils.wandb_compat import all_finite
    now = state_copy(model)
    if sorted(now) != sorted(ref_states) or not all(
            torch.equal(now[k], ref_states[k]) for k in now):
        raise AssertionError(f"{name}: training with logging did not end in "
                             f"phase 4's states")
    numeric = {k for k in run.numeric_keys() if not k.startswith("warn/")}
    bad = sorted(k for k in numeric if not all(all_finite(v)
                                               for v in run.values(k)))
    if bad:
        raise AssertionError(f"{name}: non-finite values under {bad}")
    warns = sorted(k for k in run.keys() if k.startswith("warn/"))
    unexpected = [k for k in warns if not k.endswith("_figure_skipped")
                  and k != "warn/idbn_blank_recon"]
    if unexpected:
        raise AssertionError(f"{name}: diagnostics failed: " + "; ".join(
            f"{k}: {run.values(k)[0]}" for k in unexpected))
    targets = ["cum_area", "convex_hull", "labels"] + (
        ["density"] if "Density" in (model.features or {}) else [])
    firings = ({"layer1": 1, "layer2": 1, "joint": 2}
               if name == "flagship-cut" else {"joint": 2})
    want = {f"probe/{tag}/{t}/acc": n for tag, n in firings.items()
            for t in targets}
    got = {k: run.values(k) for k in run.keys()
           if k.startswith("probe/") and k.endswith("/acc")}
    if {k: len(v) for k, v in got.items()} != want or not all(
            0.0 <= a <= 1.0 for v in got.values() for a in v):
        raise AssertionError(f"{name}: probe accuracies {got}, expected "
                             f"one per target and layer at each firing: "
                             f"{want}")
    if numeric != ref_keys:
        raise AssertionError(
            f"{name}: numeric keys differ from the CPU run at small widths: "
            f"only on the card {sorted(numeric - ref_keys)}, only on the "
            f"CPU {sorted(ref_keys - numeric)}")
    log(f"[diagnostics {name}] states bit-equal to phase 4; {len(numeric)} "
        f"numeric keys, all finite and the same set as the CPU run's; probe "
        f"accuracies " + json.dumps({k: [round(a, 4) for a in v]
                                     for k, v in sorted(got.items())})
        + f"; warnings {warns}")


def diagnostic_calls(name: str, model, run, probe_steps: int = 1000):
    """{diagnostic: call} on a trained model, each as the model's hooks
    call it; the probes take at most ``probe_steps`` steps (1000, the
    hooks' default)."""
    from multimodal_idbn_tpu_torch.models import imdbn_bimodal
    from multimodal_idbn_tpu_torch.models.idbn import feature_map
    from multimodal_idbn_tpu_torch.utils import (conditional_steps,
                                                 energy_utils, imdbn_logging,
                                                 probe_utils)
    from multimodal_idbn_tpu_torch.utils.wandb_utils import (
        log_pca_embeddings)
    model.wandb_run = run
    if name == "bimodal-cut":
        return {
            "joint + MOD2 PCA": lambda: model._log_joint_epoch(
                1, None, 10 ** 9, 1, 10 ** 9, 10 ** 9),
            "joint probes": lambda: imdbn_bimodal.log_bimodal_joint_linear_probe(
                model, epoch=0, steps=probe_steps),
            "trajectory 2-D (4 samples)": lambda: [
                imdbn_bimodal.log_bimodal_latent_trajectory(
                    model, sample_idx=i, steps=model.cross_steps,
                    tag=f"trajectory/sample{i}") for i in range(4)],
            "trajectory 3-D": lambda: (
                imdbn_bimodal.log_bimodal_latent_trajectory_3d(
                    model, steps=model.cross_steps)),
            "snapshots": lambda: model._log_snapshots(0),
        }
    idbn = model.image_idbn
    idbn.wandb_run = run

    def image_pca():
        for layer in (1, 2):
            E, feats = probe_utils.compute_val_embeddings_and_features(
                idbn, upto_layer=layer)
            log_pca_embeddings(run, E, feature_map(feats), f"iDBN_layer{layer}")

    def joint_pca():
        E, feats = probe_utils.compute_joint_embeddings_and_features(model)
        log_pca_embeddings(run, E, feature_map(feats), "Joint_top")

    return {
        "image PCA (layers 1, 2)": image_pca,
        "image probes (layers 1, 2)": lambda: [
            probe_utils.log_linear_probe(idbn, 0, upto_layer=layer,
                                         layer_tag=f"layer{layer}",
                                         steps=probe_steps)
            for layer in (1, 2)],
        "joint PCA": joint_pca,
        "joint probes": lambda: probe_utils.log_joint_linear_probe(
            model, 0, steps=probe_steps),
        "energy fixed case": lambda: energy_utils.run_and_log_fixed_case(
            model, 0),
        "convergence panel (50 steps)": lambda: (
            conditional_steps.run_and_log_cross_panel(model, 0,
                                                      max_steps=50)),
        "z-mismatch check": lambda: (
            conditional_steps.run_and_log_z_mismatch_check(model, 0)),
        "neighbours": lambda: imdbn_logging.log_vecdb_neighbors_for_traj(
            model, k=5, dedup="image"),
        "trajectory 2-D (4 samples)": lambda: [
            imdbn_logging.log_latent_trajectory_with_recon_panel(
                model, sample_idx=i, steps=model.cross_steps,
                tag=f"pca_traj_with_recon/sample{i}") for i in range(4)],
        "trajectory 3-D": lambda: (
            imdbn_logging.log_pca3_trajectory_with_recon_panel(
                model, steps=model.cross_steps)),
        "joint auto-recon": lambda: imdbn_logging.log_joint_auto_recon(
            model, 0),
        "snapshots": lambda: model._log_snapshots(0),
    }


# The probes' profiled call takes at most this many steps: at 1000 steps
# a probe is ~64 000 host-bound device operations, which the profiler
# slows most and which make up most of phase 10 at full steps.
PROBE_PROFILE_STEPS = 100


def time_diagnostics(name: str, model):
    """Each diagnostic alone on the trained model, launch by launch and
    replayed, from the same key streams: the numbers it logs bit-equal
    both ways, the same kernel launches, graph replays only replayed
    (every replay under ``replays_checked``); seconds on the host clock
    around one synchronised call as the hooks make it, then device busy
    ms and operations of one more, profiled call (``busy_ms``; the
    probes' at ``PROBE_PROFILE_STEPS`` steps) and the share of that
    call's wall the device was busy (``busy_share``), both ways. Then every
    graph of the model's caches that this PR derives, launches per replay
    as derived. Returns ({diagnostic: row}, launches of the replayed
    calls of all diagnostics)."""
    from multimodal_idbn_tpu_torch.ops import graphs
    from multimodal_idbn_tpu_torch.utils.wandb_compat import RecorderRun
    run = RecorderRun()
    short = diagnostic_calls(name, model, run, PROBE_PROFILE_STEPS)
    streams = stream_states(model)
    rows = {}
    total = dict.fromkeys(KERNEL_ENTRIES + ("serving_replays",
                                            "step_replays"), 0)
    for diag, call in diagnostic_calls(name, model, run).items():
        row, logged = {}, {}
        for way in ("launch by launch", "replayed"):
            eager = way == "launch by launch"
            if not eager:       # any graph the logged run did not capture
                call()
                short[diag]()
            restore_streams(model, streams)
            run.logged.clear()
            reset_launches()
            with (graphs.launch_by_launch() if eager
                  else replays_checked()), recorded_calls() as outs:
                _, wall, _ = timed_call(call)
            launches = read_launches()
            logged[way] = (logged_numbers(run), outs)
            with (graphs.launch_by_launch() if eager
                  else contextlib.nullcontext()):
                _, short_wall, _ = timed_call(short[diag])
                busy, ops, missing = busy_ms(short[diag])
            row[way] = dict(
                seconds=round(wall / 1e3, 4), busy_ms=round(busy, 4),
                busy_share=round(busy / short_wall, 4),
                operations=ops, missing_records=missing,
                **{k: launches[k] for k in KERNEL_ENTRIES
                   + ("serving_replays", "step_replays") if launches[k]})
        eager, replayed = row["launch by launch"], row["replayed"]
        (nums, outs), (nums_e, outs_e) = (logged["replayed"],
                                          logged["launch by launch"])
        if not numbers_equal(nums, nums_e):
            raise AssertionError(f"{name} {diag}: the numbers logged "
                                 f"replayed differ from launch by launch")
        if len(outs) != len(outs_e) or not all(
                _trees_equal(a, b) for a, b in zip(outs, outs_e)):
            raise AssertionError(f"{name} {diag}: the outputs of its "
                                 f"{len(outs)} replayed calls differ from "
                                 f"launch by launch ({len(outs_e)} calls)")
        replays = [x.get("serving_replays", 0) + x.get("step_replays", 0)
                   for x in (eager, replayed)]
        if {k: eager.get(k, 0) for k in KERNEL_ENTRIES} != \
                {k: replayed.get(k, 0) for k in KERNEL_ENTRIES} or \
                replays[0] or not replays[1]:
            raise AssertionError(f"{name} {diag}: launches {replayed} "
                                 f"replayed, {eager} launch by launch")
        for k in total:
            total[k] += replayed.get(k, 0)
        rows[diag] = row
        log(f"[diagnostics {name}] {diag}: {len(nums)} numeric keys and "
            f"the outputs of {len(outs)} calls bit-equal both ways; replayed "
            f"{json.dumps(replayed)}; launch by launch {json.dumps(eager)}"
            + (f" (busy at {PROBE_PROFILE_STEPS} probe steps)"
               if "probes" in diag else ""))
    restore_streams(model, streams)
    check_derivations(f"diagnostics {name}",
                      rbm_owners(model) + [graphs.SHARED])
    model.wandb_run = None
    return rows, total


def run_diagnostics(dev, workdir: Path, ref_states):
    """Phase 10. ``ref_states``: {cut: phase 4's final states}."""
    from multimodal_idbn_tpu_torch import cuts
    from multimodal_idbn_tpu_torch.ops import graphs
    from multimodal_idbn_tpu_torch.utils.profiling import (
        measure_gibbs_steps_per_sec, trace)
    t_phase = time.perf_counter()
    launches = {}
    model = None
    for name in ("flagship-cut", "bimodal-cut"):
        d = workdir / f"{name}-logged"
        d.mkdir()
        reset_launches()
        t0 = time.perf_counter()
        summary = cuts.run_logged(name, d, "cuda")
        wall = time.perf_counter() - t0
        launches[name] = read_launches()
        log_captures(f"diagnostics {name}", [
            c for c in graphs.STATS["captures"]
            if c["name"].startswith(("serve:", "step:"))])
        log(f"[diagnostics {name}] logged run: {wall:.1f} s (phase seconds "
            f"{json.dumps(summary['seconds'])}), {len(summary['run'].logged)}"
            f" log calls; launches {json.dumps(launches[name])}")
        t0 = time.perf_counter()
        (d / "cpu").mkdir()
        cpu = cuts.run_logged(name, d / "cpu", "cpu", tiny=True)["run"]
        log(f"[diagnostics {name}] the same at small widths on the CPU: "
            f"{time.perf_counter() - t0:.1f} s")
        model = summary["model"]
        check_diagnostics_run(
            name, summary["run"], model, ref_states[name],
            {k for k in cpu.numeric_keys() if not k.startswith("warn/")})
        _, launches[f"diagnostics-alone {name}"] = time_diagnostics(name,
                                                                   model)
        if name == "flagship-cut":
            # one joint epoch more, traced
            tdir = d / "trace"
            with trace(str(tdir)):
                model.train_joint(10, start_epoch=9)
            files = sorted(tdir.glob("*.json"))
            if not files:
                raise AssertionError("trace() wrote no file")
            log(f"[diagnostics] trace() around one joint epoch: {files[0]}, "
                f"{files[0].stat().st_size / 2**20:.1f} MiB")
        del summary
    g = measure_gibbs_steps_per_sec(device=dev)
    with graphs.launch_by_launch():
        g_eager = measure_gibbs_steps_per_sec(device=dev)
    log(f"[diagnostics] measure_gibbs_steps_per_sec (532x500, B=128, 500 "
        f"steps, one chain launch): replayed {json.dumps(g)}; launch by "
        f"launch {json.dumps(g_eager)}")
    log(f"[diagnostics] phase 10: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the variants drive
# ---------------------------------------------------------------------------

def flagship_launches(variant: str, epochs_image: int = 1,
                      epochs_joint: int = 9, nb: int = 2, rem: bool = True,
                      layers: int = 2, cd: int = 10):
    """(half-step, chain) launches a flagship-cut run of ``variant`` must
    make. Image: every full batch and layer one CD update of 1 + 2·cd
    half-steps, or under fp32 PCD 3 + 2·cd (the data's positive phase, the
    particles lifted, 2·cd chain half-steps, the monitor's
    reconstruction), the remainder batch by CD; bf16 storage and mixed
    precision launch none. Joint: per warm-up batch two clamped CDs and
    the two cross chains; per main batch the y-clamp, the z-clamp on batch
    0 (every 50th) and the two cross chains, a bf16 joint's too (its
    weights widened to fp32)."""
    per_update = 3 + 2 * cd if variant == "pcd" else 1 + 2 * cd
    half = epochs_image * layers * (nb * per_update + rem * (1 + 2 * cd))
    batches = nb + int(rem)
    warm = min(8, epochs_joint)
    main = epochs_joint - warm
    chain = warm * batches * 4 + main * (batches * 3 + 1)
    if variant.startswith("bf16") or variant == "mixed-bf16":
        return 0, chain
    return half, chain


def bimodal_bf16_launches(epochs_joint: int = 9, nb: int = 2,
                          rem: bool = True):
    """(half-step, chain) launches of bimodal-cut under bf16 storage: no
    half-step; per warm-up batch four clamped CDs, per main batch two,
    each with one noisy-init chain on the widened joint weights (the cross
    metrics are sampled Gibbs in torch)."""
    batches = nb + int(rem)
    warm = min(8, epochs_joint)
    return 0, batches * (4 * warm + 2 * (epochs_joint - warm))


def state_dtypes(model):
    from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    return {name: str(rbm.state.w.dtype).replace("torch.", "")
            for name, rbm in _collect_rbms(model).items()}


def check_variant_run(variant: str, summary, launches, want_dtype: str):
    """Every state in its configured dtype (all six fields) and finite;
    the launches as derived."""
    import torch
    from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    model = summary["model"]
    for name, rbm in _collect_rbms(model).items():
        for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m"):
            t = getattr(rbm.state, f)
            if str(t.dtype).replace("torch.", "") != want_dtype:
                raise AssertionError(f"{variant}: {name}/{f} is {t.dtype}, "
                                     f"configured {want_dtype}")
            if not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"{variant}: non-finite {name}/{f}")
    if variant == "bimodal-bf16":
        want = bimodal_bf16_launches()
        loss = {"mod1": summary["mod1_loss"][-1],
                "mod2": summary["mod2_loss"][-1],
                "mse_mod1": summary["mse_mod1"],
                "mse_mod2": summary["mse_mod2"]}
    else:
        want = flagship_launches(variant)
        loss = {"image": summary["image_loss"][-1],
                **(summary["cross_metrics"] or {})}
    got = (launches["half_step_sample"], launches["chain_run"])
    if got != want or launches["half_step_probs"] or \
            launches["half_step_sample_resident"]:
        raise AssertionError(f"{variant}: launches {launches}, derived "
                             f"half-step / chain {want}")
    if not all(isinstance(v, float) and math.isfinite(v)
               for v in loss.values()):
        raise AssertionError(f"{variant}: a final loss is not finite: "
                             f"{loss}")
    log(f"[variants {variant}] phase seconds "
        f"{json.dumps(summary['seconds'])}; launches {json.dumps(launches)} "
        f"(derived half-step / chain {want[0]} / {want[1]}); dtypes "
        f"{json.dumps(state_dtypes(model))}, all finite; final loss "
        f"{json.dumps(loss)}")


def check_pcd_update(dev, model):
    """The fp32 PCD image update at the flagship's first layer (batch 128,
    CD-10) through the half-step kernel, held against its plain version on
    the same inputs: each of its 23 half-steps against ``half_step_plain``
    on that call's inputs (probabilities within tolerance, no sample
    flipped outside the band), then the whole update recomputed from the
    plain probabilities along the kernel's samples (states within
    tolerance); and the kernel update run twice, bit-equal. Returns the
    kernels-line row of the update."""
    import torch
    from multimodal_idbn_tpu_torch.ops import fast_cd, half_step
    dbn = model.image_idbn
    state = dbn.layers[0].state
    chain_v = dbn._pcd_chains[0]
    data = torch.as_tensor(dbn.dataloader.materialize()[0][:128]).reshape(
        128, -1).float().to(dev)
    kw = dict(lr=0.1, mom=0.5, weight_decay=1e-4, cd=10)
    seed = 0x5EED_9CD
    real = fast_cd.half_step_sample
    calls = []

    def recording(x, w, b, sd, T=1.0, *, transpose_w=False, **offsets):
        p, smp = real(x, w, b, sd, T, transpose_w=transpose_w, **offsets)
        calls.append((x, b, sd, transpose_w, p, smp))
        return p, smp

    def replaying(x, w, b, sd, T=1.0, *, transpose_w=False, row0=0,
                  plan_shape=None):
        _, _, _, _, _, smp = calls[len(replayed)]
        replayed.append(sd)
        return half_step.half_step_plain(x, w, b, sd, T,
                                         transpose_w=transpose_w,
                                         row0=row0)[0], smp

    def run(fn):
        fast_cd.half_step_sample = fn
        try:
            out = fast_cd.fast_sampled_pcd_update(state, chain_v, seed, data,
                                                  **kw)
        finally:
            fast_cd.half_step_sample = real
        torch.cuda.synchronize()
        return out

    k_state, k_chain, k_loss = run(recording)
    err, flips, bad = 0.0, 0, 0
    for x, b, sd, tr, p, smp in calls:
        pp, sp = half_step.half_step_plain(x, state.w, b, sd,
                                           transpose_w=tr)
        err = max(err, float((p - pp).abs().max()))
        f, bd = sample_flips(pp, smp, sp, sd)
        flips, bad = flips + f, bad + bd
    replayed = []
    p_state, p_chain, p_loss = run(replaying)
    st_err = max(float((getattr(k_state, f) - getattr(p_state, f)).abs()
                       .max()) for f in ("w", "hb", "vb", "w_m", "hb_m",
                                         "vb_m"))
    again = run(real)
    repeat = all(torch.equal(getattr(again[0], f), getattr(k_state, f))
                 for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m")) and \
        torch.equal(again[1], k_chain) and torch.equal(again[2], k_loss)
    shape = f"[128,{state.w.shape[0]}]x{list(state.w.shape)}"
    log(f"[variants pcd] fp32 PCD update at {shape}, CD-10:"
        f" {len(calls)} half-steps; max|dp| {err:.3e}, sample flips {flips}"
        f" (outside tol: {bad}); states vs the plain update along the "
        f"kernel's samples max|d| {st_err:.3e}, loss {float(k_loss):.6f} vs "
        f"{float(p_loss):.6f}; repeat bit-equal: {repeat}")
    if len(calls) != 23 or not err <= TOL_HALF_STEP or bad or \
            not st_err <= TOL_HALF_STEP or not repeat or \
            not torch.equal(p_chain, k_chain):
        raise AssertionError("the fp32 PCD update disagrees with its plain "
                             "version or does not repeat")

    def plain(x, w, b, sd, T=1.0, *, transpose_w=False, row0=0,
              plan_shape=None):
        return half_step.half_step_plain(x, w, b, sd, T,
                                         transpose_w=transpose_w, row0=row0)

    # bound: 23 half-step products as three TF32 passes, the two fp32
    # statistics products (cuBLAS) at the CUDA-core peak; bytes: W, W_m,
    # the biases, their momenta, the data and the particles read once, the
    # new state and particles written once
    B, K, N = 128, state.w.shape[0], state.w.shape[1]
    gemm = 2.0 * B * K * N
    t_ops = (TF32_PASSES * 23 * gemm / PEAK_TF32_FLOPS
             + 2 * gemm / PEAK_FP32_FLOPS) * 1e3
    t_bytes = 4.0 * (4 * K * N + 4 * (K + N) + 3 * B * K) / PEAK_HBM_BYTES \
        * 1e3
    row = dict(shape=f"fp32 PCD update {shape} CD-10",
               max_abs_err=max(err, st_err), sample_flips=flips,
               ms=time_ms(lambda: run(real), 5, warmup=1),
               plain_ms=time_ms(lambda: run(plain), 2, warmup=1),
               library_ms=None, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"[variants pcd] update: kernel {row['ms']:.3f} ms, plain "
        f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def run_pcd_resume(workdir: Path):
    """The PCD flagship-cut with an image checkpoint after each of its 2
    image epochs (``cuts.PCD_RESUME``): uninterrupted, then stopped after
    the checkpoint of image epoch 1 and run again. The resumed run must
    end bit-equal, fantasy chains included."""
    import torch
    from multimodal_idbn_tpu_torch import cuts

    def run(tag):
        d = workdir / f"pcd-{tag}"
        d.mkdir(exist_ok=True)
        return cuts.run_variant("pcd", d, extra=cuts.PCD_RESUME), d

    straight, _ = run("straight")
    try:
        with interrupt_after("image", 1):
            run("stopped")
    except Interrupted:
        pass
    else:
        raise AssertionError("pcd: no image checkpoint of epoch 1")
    reset_launches()
    resumed, _ = run("stopped")
    launches = read_launches()
    assert_bit_equal(straight["model"], resumed["model"],
                     "pcd resumed after the image checkpoint of epoch 1")
    a = straight["model"].image_idbn._pcd_chains
    b = resumed["model"].image_idbn._pcd_chains
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("pcd: fantasy chains differ after the resume")
    half, chain = flagship_launches("pcd", epochs_image=1, epochs_joint=1)
    if (launches["half_step_sample"], launches["chain_run"]) != (half,
                                                                 chain):
        raise AssertionError(f"pcd resumed run: launches {launches}, "
                             f"derived {half} / {chain}")
    log(f"[variants pcd] stopped after the image checkpoint of epoch 1, "
        f"run again: states and fantasy chains bit-equal to the "
        f"uninterrupted run; launches {json.dumps(launches)}")
    return launches


def check_bf16_round_trip(model, workdir: Path):
    """A bf16 model's checkpoint (uint16 bit-views) loads into a fresh
    model bit-equal, every state still bf16."""
    from multimodal_idbn_tpu_torch import checkpoint
    from multimodal_idbn_tpu_torch.models import iMDBN
    path = workdir / "bf16.ckpt.npz"
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(model, str(path))
    fresh = iMDBN([r.num_visible for r in model.image_idbn.layers]
                  + [model.image_idbn.layers[-1].num_hidden],
                  model.joint_rbm.num_hidden, params=model.params,
                  dataloader=model.dataloader, val_loader=model.val_loader,
                  device=model.device,
                  num_labels=model.num_labels, seed=12345)
    checkpoint.load_checkpoint(fresh, str(path))
    assert_bit_equal(model, fresh, "bf16 checkpoint round trip")
    if set(state_dtypes(fresh).values()) != {"bfloat16"}:
        raise AssertionError(f"bf16 round trip: {state_dtypes(fresh)}")
    log(f"[variants bf16-sr-auto] checkpoint {path.stat().st_size / 2**20:.1f}"
        f" MiB (bf16 bit-views) saved and loaded in "
        f"{time.perf_counter() - t0:.3f} s: bit-equal, every state bf16")


def check_native_generator(workdir: Path):
    """Build the native generator from the checkout's source, check it is
    deterministic per seed, and time it and the Python generator at the
    flagship's data size (2048 images, side 100)."""
    import numpy as np
    from multimodal_idbn_tpu_torch.data import native, numerosity
    t0 = time.perf_counter()
    if not native._compile_library(workdir / "dotgen-check.so"):
        raise AssertionError("the native generator does not build")
    build_s = time.perf_counter() - t0
    if not native.native_available():
        raise AssertionError("the native generator does not load")
    kw = dict(n_samples=2048, num_classes=32, side=100, seed=0)
    times = {}
    out = {}
    for backend in ("native", "native", "python"):
        t0 = time.perf_counter()
        d = numerosity.generate_numerosity_dataset(backend=backend, **kw)
        times.setdefault(backend, []).append(time.perf_counter() - t0)
        out.setdefault(backend, []).append(d)
    a, b = out["native"]
    if not all(np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError("the native generator is not deterministic")
    other = numerosity.generate_numerosity_dataset(
        backend="native", **dict(kw, seed=1, n_samples=64))
    if np.array_equal(other["images"], a["images"][:64]):
        raise AssertionError("the native generator ignores its seed")
    log(f"[variants native] g++ build {build_s:.2f} s; 2048 images at side "
        f"100: native {times['native'][0]:.3f} / {times['native'][1]:.3f} s,"
        f" python {times['python'][0]:.3f} s; deterministic per seed; "
        f"pixel means native {a['images'].mean():.4f}, python "
        f"{out['python'][0]['images'].mean():.4f}")


def run_variants(dev, workdir: Path):
    """Phase 11. Returns ({path: launches}, the PCD update's row)."""
    import torch
    from multimodal_idbn_tpu_torch import cuts
    from multimodal_idbn_tpu_torch.data import native
    from multimodal_idbn_tpu_torch.device import set_matmul_precision
    t_phase = time.perf_counter()
    if not native.native_available():
        raise AssertionError("the native generator does not build; the "
                             "zipfian run would not draw with it")
    by_path = {}
    row = None
    order = ("pcd", "bf16-sr-auto", "bf16-sr-off", "mixed-bf16",
             "zipfian-native", "bimodal-bf16", "matmul-high")
    for variant in order:
        d = workdir / f"variant-{variant}"
        d.mkdir()
        reset_launches()
        t0 = time.perf_counter()
        summary = cuts.run_variant(variant, d)
        wall = time.perf_counter() - t0
        launches = read_launches()
        by_path[f"variants-drive {variant}"] = launches
        want = "bfloat16" if "bf16" in variant and variant != "mixed-bf16" \
            else "float32"
        log(f"[variants {variant}] run: {wall:.1f} s")
        check_variant_run(variant, summary, launches, want)
        if variant == "matmul-high" and \
                torch.get_float32_matmul_precision() != "high":
            raise AssertionError("matmul_precision: high was not applied")
        if variant == "pcd":
            row = check_pcd_update(dev, summary["model"])
        if variant == "bf16-sr-auto":
            check_bf16_round_trip(summary["model"], d)
        del summary
    set_matmul_precision("highest")
    by_path["variants-drive pcd resumed"] = run_pcd_resume(workdir)
    check_native_generator(workdir)
    log(f"[variants] phase 11: {time.perf_counter() - t_phase:.1f} s")
    return by_path, row


# ---------------------------------------------------------------------------
# Phase 12: per-batch training and the parallel package
# ---------------------------------------------------------------------------

# Tolerance of the data-parallel runs of two ranks against phase 4 and of
# the 1 x 2 model split against one device, stated before the first run.
# The ranks draw the single device's numbers and sum every row's products
# in its order, so only the cross-rank sums of the CD statistics differ, by
# about an ulp per update; but a sample whose probability lies within that
# of its uniform flips, a discrete step of lr/B in a row of dW, after which
# the trajectories part. Elementwise 1e-5 (JAX's test at small widths)
# cannot be promised at full width, so: every W, hb and vb of every RBM
# within 1e-2 of the change training made to it, plus the JAX test's 1e-5
# per element as an RMS (a lost rank's statistics, a step divided by the
# rank's rows, or a rank on the wrong rows moves a state by its whole
# change), and the image losses within rtol 1e-2. Printed beside: max
# |diff| and the share of elements within 1e-5.
PAR_REL_TOL = 1e-2
PAR_ATOL = 1e-5
PAR_LOSS_RTOL = 1e-2
# Measured in the first run of this check: the bimodal joint's layer 0
# parted from phase 4 by 4.5% of its change, past PAR_REL_TOL, where the
# flagship stayed within 6.2e-7. The joint's training amplifies any
# difference, so the check measures that amplification on one device: the
# cut trained once more with every initial weight moved by one ulp. A
# state may also part from phase 4 by up to PAR_ULP_FACTOR times as much
# as that run does; the one-ulp run is printed beside.
PAR_ULP_FACTOR = 3.0
# The per-batch loop draws from the shells' streams and its loader's
# shuffle, the fused epochs from (seed, epoch): the same schedule on other
# draws, so its last image loss is held within 10% of the fused run's.
PER_BATCH_LOSS_RTOL = 0.10


class PerBatchLoader:
    """A training loader without ``materialize()``: the batches, batch
    size, dataset and shuffle counter of the loader it wraps."""

    def __init__(self, inner):
        self.inner = inner

    def __iter__(self):
        return iter(self.inner)

    def __len__(self):
        return len(self.inner)

    @property
    def batch_size(self):
        return self.inner.batch_size

    @property
    def dataset(self):
        return self.inner.dataset

    @property
    def _epoch(self):
        return self.inner._epoch

    @_epoch.setter
    def _epoch(self, value):
        self.inner._epoch = value


@contextlib.contextmanager
def per_batch_loaders():
    """Inside the block both entry points train from loaders that hide
    ``materialize()``: the training split and, for the bimodal cut, the
    two modality loaders cut from it."""
    from multimodal_idbn_tpu_torch import train_bimodal, train_multimodal
    real_make, real_modality = (train_multimodal.make_loaders,
                                train_bimodal.modality_loader)

    def make_loaders(dataset, tag="train_multimodal"):
        factory = real_make(dataset, tag)

        def build(**kw):
            train, val, test = factory(**kw)
            return PerBatchLoader(train), val, test
        return build

    train_multimodal.make_loaders = train_bimodal.make_loaders = make_loaders
    train_bimodal.modality_loader = (
        lambda loader, i: PerBatchLoader(real_modality(loader, i)))
    try:
        yield
    finally:
        train_multimodal.make_loaders = train_bimodal.make_loaders = \
            real_make
        train_bimodal.modality_loader = real_modality


def per_batch_launches(name: str, model):
    """The launches a per-batch run of a cut makes, derived from the code:
    every image-stack layer 1 + 2·CD half-steps per batch, the remainder
    included (``RBM.train_epoch`` through ``fast_cd``); chains per joint
    batch: flagship warm-up 2 (the y-clamps' noisy inits) and main 1 +
    1 every 50th batch (the z-clamp), plus 2 for the round trip at the
    metrics cadence; bimodal warm-up 4 and main 2 (the clamps' inits; its
    round trip samples h and runs no chain)."""
    p = model.params
    loader = model.dataloader
    nb = -(-len(loader.dataset) // loader.batch_size)
    per_layer = (1 + 2 * int(p["CD"])) * nb
    warm = 8
    if name == "flagship-cut":
        every = max(1, int(p.get("CROSS_METRICS_EVERY", 1)))
        hs = len(model.image_idbn.layers) * per_layer * int(p["EPOCHS_IMG"])
        chain = sum((2 if e < warm else 1 + (b % 50 == 0))
                    + 2 * (b % every == 0)
                    for e in range(int(p["EPOCHS_JOINT"]))
                    for b in range(nb))
    else:
        hs = per_layer * (len(model.mod1_dbn.layers) * int(p["EPOCHS_MOD1"])
                          + len(model.mod2_dbn.layers)
                          * int(p["EPOCHS_MOD2"]))
        chain = sum(4 if e < warm else 2
                    for e in range(int(p["EPOCHS_JOINT"]))
                    for _ in range(nb))
    return {"half_step_sample": hs, "chain_run": chain}


def check_launches(what: str, got, want) -> None:
    for entry, n in want.items():
        if got.get(entry) != n:
            raise AssertionError(f"{what}: {entry} launched {got.get(entry)}"
                                 f" times, derived {n}")


def check_row_offsets(dev):
    """Kernels 1 and 2 launched on a part of their operand: kernel 1 on
    rows 64.. of a batch of 128 (row0), in both directions, and on columns
    750.. of the flagship first layer (col0); kernel 2 on rows 64.. of the
    flagship and bimodal joint chains (row0). Each against its plain
    version at the offset (within the tolerances of phase 2, no sample
    flip outside it), and, with the whole operand's plan, bit-equal to the
    rows and columns of one launch on the whole operand. Returns the
    rows of the kernels line."""
    import torch
    from multimodal_idbn_tpu_torch.ops import chain, half_step, rbm_ops, rng
    g = torch.Generator().manual_seed(12)
    rows = []
    for name, (K, N, transpose) in {
            "v->h [128,10000]x[10000,1500]": (10000, 1500, False),
            "h->v [128,1500]x[1500,10000]": (1500, 10000, True)}.items():
        x, w, b = half_step_inputs(g, dev, 128, K, N, transpose, 0.2)
        seed = 0x5EED + len(rows)
        p_all, s_all = half_step.half_step_sample(x, w, b, seed,
                                                  transpose_w=transpose)
        parts = [("row0=64", x[64:], w, b, dict(row0=64),
                  (slice(64, None), slice(None)))]
        if not transpose:
            parts.append(("col0=750", x, w[:, 750:].contiguous(), b[750:],
                          dict(col0=750), (slice(None), slice(750, None))))
        for label, xp, wp, bp, off, (rs, cs) in parts:
            p_k, s_k = half_step.half_step_sample(
                xp, wp, bp, seed, transpose_w=transpose,
                plan_shape=(128, N), **off)
            p_p, s_p = half_step.half_step_plain(
                xp, wp, bp, seed, transpose_w=transpose, **off)
            torch.cuda.synchronize()
            err = float((p_k - p_p).abs().max())
            u = rng.philox_uniform(
                seed, p_k.shape[0], p_k.shape[1], device=dev,
                row0=off.get("row0", 0), col0=off.get("col0", 0))
            flips = s_k != s_p
            bad = int((flips & ((p_p - u).abs() > TOL_HALF_STEP)).sum())
            same = bool(torch.equal(p_k, p_all[rs, cs])
                        and torch.equal(s_k, s_all[rs, cs]))
            log(f"[row-offset] half_step {name} {label}: max|dp| vs plain "
                f"{err:.3e}, sample flips {int(flips.sum())} (outside tol: "
                f"{bad}); bit-equal to the whole launch's part: {same}")
            if not err <= TOL_HALF_STEP or bad or not same:
                raise AssertionError(f"half_step {name} {label} disagrees")
            rows.append(dict(shape=f"half_step {name} {label}",
                             max_abs_err=err, sample_flips=int(flips.sum()),
                             bit_equal_to_whole=same))
    sched = rbm_ops.annealed_schedule(30, 3.0, 1.0, 0.9, 2, 0.9,
                                      0.15).to(dev)
    for name, (V, H, groups, pull) in {
            "flagship joint 532x500": (532, 500, ((500, 532),), True),
            "bimodal joint 2500x1500": (2500, 1500, (), False)}.items():
        j = chain_inputs(dev, 128, V, H, 500, 77)
        km = torch.cat([torch.ones((128, V - 32), device=dev),
                        torch.zeros((128, 32), device=dev)], 1)
        vk = j["z"] * km
        v0 = vk + (1.0 - km) * j["u"]
        mu = j["mu"] if pull else None
        whole = chain.clamped_chain(j["w"], j["hb"], j["vb"], v0, vk, km,
                                    sched, groups=groups, mu=mu, seed=4242)
        part = (j["w"], j["hb"], j["vb"], v0[64:], vk[64:], km[64:], sched)
        kw = dict(groups=groups, mu=None if mu is None else mu[64:],
                  seed=4242, row0=64)
        out_k = chain.clamped_chain(*part, plan_rows=128, **kw)
        out_p = chain.chain_plain(*part, **kw)
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        same = bool(torch.equal(out_k, whole[64:]))
        log(f"[row-offset] chain {name} noisy 30 steps row0=64: max|d| vs "
            f"plain {err:.3e}; bit-equal to the whole launch's rows: "
            f"{same}")
        if not err <= TOL_CHAIN or not same:
            raise AssertionError(f"chain {name} row0=64 disagrees")
        rows.append(dict(shape=f"chain {name} row0=64", max_abs_err=err,
                         bit_equal_to_whole=same))
    return rows


def close_to(name: str, got, want, init, ulp=None):
    """Phase 12's agreement of two trainings: every W, hb and vb within
    PAR_REL_TOL of the change training made to it (``want - init``), or
    within PAR_ULP_FACTOR times the distance of the one-ulp run ``ulp``
    from ``want``, plus PAR_ATOL per element as an RMS. Logs each state's
    distances; returns (max |diff|, share of elements within PAR_ATOL)."""
    worst, within, total, bad = 0.0, 0, 0, []
    for k in sorted(want):
        if k.rsplit("/", 1)[1] not in ("w", "hb", "vb"):
            continue
        a, b, b0 = (x[k].double() for x in (got, want, init))
        d, change = float((a - b).norm()), float((b - b0).norm())
        sens = 0.0 if ulp is None else float((ulp[k].double() - b).norm())
        limit = max(PAR_REL_TOL * change, PAR_ULP_FACTOR * sens) \
            + PAR_ATOL * math.sqrt(b.numel())
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        within += int((diff <= PAR_ATOL).sum())
        total += b.numel()
        if d > PAR_ATOL * math.sqrt(b.numel()) or not d <= limit:
            log(f"[{name}] {k}: |diff| {d:.3e} (max {float(diff.max()):.3e})"
                f", change {change:.3e}, one-ulp run {sens:.3e}, limit "
                f"{limit:.3e}")
        if not d <= limit:
            bad.append(k)
    if bad:
        raise AssertionError(f"{name}: {bad} differ past their limits")
    return worst, within / max(1, total)


@contextlib.contextmanager
def nudged_initial_weights():
    """Inside the block every RBM starts from its weights moved up by one
    ulp each (the one-ulp run of ``close_to``)."""
    import torch
    from multimodal_idbn_tpu_torch.ops import rbm_ops
    real = rbm_ops.init_rbm_state

    def nudged(*args, **kw):
        st = real(*args, **kw)
        return st.replace(w=torch.nextafter(st.w, st.w + 1))

    rbm_ops.init_rbm_state = nudged
    try:
        yield
    finally:
        rbm_ops.init_rbm_state = real


def reference_runs(name: str, workdir: Path):
    """A cut's states before training (its entry point run for 0 epochs:
    the joint's visible biases set from the data, as a run sets them) and
    after the one-ulp run."""
    from multimodal_idbn_tpu_torch import cuts
    zero = {k: 0 for k in cuts.CUTS[name]["cut"]["training"]}
    out = []
    for tag, over in (("init", {"training": zero}), ("ulp", None)):
        d = workdir / f"{name}-{tag}"
        d.mkdir(exist_ok=True)
        with (nudged_initial_weights() if tag == "ulp"
              else contextlib.nullcontext()):
            summary = cuts.run_cut(name, d, overrides=over)
        out.append(state_copy(summary["model"]))
    log(f"[dp] {name} on one device from weights one ulp up (fused, warm): "
        f"phase seconds {json.dumps(summary['seconds'])}")
    return out


def per_batch_replays(name: str, model) -> int:
    """The step replays of a per-batch run, derived: one per batch of
    every per-batch phase (the image iDBN and the joint; MOD1, MOD2 and
    the joint), the remainder batch included."""
    p = model.params
    loader = model.dataloader
    nb = -(-len(loader.dataset) // loader.batch_size)
    phases = (("EPOCHS_IMG", "EPOCHS_JOINT") if name == "flagship-cut"
              else ("EPOCHS_MOD1", "EPOCHS_MOD2", "EPOCHS_JOINT"))
    return nb * sum(int(p[k]) for k in phases)


def time_image_epochs(model) -> dict:
    """Seconds of one flagship image epoch (StepTimer, synchronised; the
    median of epochs 2 and 3 of a 3-epoch ``train``, after the first
    epoch's captures): per batch (one replay a batch) and fused (one
    replay an epoch), and the host's time to draw one epoch of batches
    from the loader alone."""
    import statistics
    idbn = model.image_idbn
    loader = idbn.dataloader
    t0 = time.perf_counter()
    for _ in loader:
        pass
    draw = time.perf_counter() - t0
    row = {}
    for way, fused in (("per batch", False), ("fused", True)):
        if fused:
            idbn.dataloader = loader.inner
        idbn.train(3, fused=fused)
        row[way] = round(statistics.median(idbn.epoch_timer.durations[1:]),
                         5)
    idbn.dataloader = loader
    row["host draw of one epoch's batches"] = round(draw, 5)
    return row


def run_per_batch(workdir: Path, phase4):
    """Phase 12 (a): both cuts through loaders without ``materialize()``.
    flagship-cut four times: with checkpoints every 2 epochs, again (the
    repeat), stopped after its joint checkpoint of epoch 4 and run again
    (the resume), and launch by launch; bimodal-cut three times: twice
    and launch by launch. Run b's replays run under ``replays_checked``.
    Each per-batch batch is one replay (derived:
    ``per_batch_replays``); the launch-by-launch run makes no replay,
    launches what run a launches and ends bit-equal to it. On flagship-cut
    one image epoch per batch is timed beside a fused one
    (``time_image_epochs``). Returns {path: launches}."""
    from multimodal_idbn_tpu_torch import cuts
    from multimodal_idbn_tpu_torch.ops import graphs
    by_path = {}
    over = {"training": {"checkpoint_every": 2}}
    for name, runs in (("flagship-cut", ("a", "b", "resumed", "lbl")),
                       ("bimodal-cut", ("a", "b", "lbl"))):
        out = {}
        for tag in runs:
            d = workdir / f"per-batch-{name}-{tag}"
            d.mkdir(exist_ok=True)
            t0 = time.perf_counter()
            # run b's replays (every batch after its shape's first) under
            # the sync check
            with per_batch_loaders(), (graphs.launch_by_launch()
                                       if tag == "lbl" else
                                       replays_checked() if tag == "b"
                                       else contextlib.nullcontext()):
                if tag == "resumed":
                    try:
                        with interrupt_after("joint", 4):
                            cuts.run_cut(name, d, overrides=over)
                    except Interrupted:
                        pass
                    else:
                        raise AssertionError("no joint checkpoint of 4")
                reset_launches()
                summary = cuts.run_cut(name, d, overrides=over)
                launches = read_launches()
            model = summary["model"]
            if not isinstance(model.dataloader, PerBatchLoader):
                raise AssertionError(f"{name}: the loader materializes")
            out[tag] = (state_copy(model), summary)
            if tag == "a":
                want = per_batch_launches(name, model)
                check_launches(f"per-batch {name}", launches, want)
                if launches["step_replays"] != per_batch_replays(name,
                                                                 model):
                    raise AssertionError(
                        f"per-batch {name}: {launches['step_replays']} step "
                        f"replays, derived one a batch: "
                        f"{per_batch_replays(name, model)}")
                check_derivations(f"per-batch {name}", rbm_owners(model))
                log_captures(f"per-batch {name}", [
                    c for c in graphs.STATS["captures"]
                    if c["name"].startswith("step:")])
                by_path[f"per-batch {name}"] = launches
                check_states(*cut_states(name, model))
                if name == "flagship-cut":
                    log(f"[per-batch] flagship-cut one image epoch, seconds: "
                        f"{json.dumps(time_image_epochs(model))}")
            else:
                if tag == "lbl" and (
                        launches["step_replays"]
                        or {k: launches[k] for k in KERNEL_ENTRIES}
                        != {k: by_path[f"per-batch {name}"][k]
                            for k in KERNEL_ENTRIES}):
                    raise AssertionError(f"per-batch {name}: launch by "
                                         f"launch launched {launches}")
                a = out["a"][0]
                if sorted(a) != sorted(out[tag][0]) or not all(
                        torch_equal(a[k], out[tag][0][k]) for k in a):
                    raise AssertionError(f"per-batch {name}: run {tag} is "
                                         f"not bit-equal to run a")
            log(f"[per-batch] {name} run {tag}: {time.perf_counter() - t0:.1f}"
                f" s wall, phase seconds {json.dumps(summary['seconds'])}, "
                f"launches {json.dumps(launches)}")
        loss_key = "image_loss" if name == "flagship-cut" else "mod1_loss"
        got = out["a"][1][loss_key][-1]
        want = phase4[name][1][loss_key][-1]
        log(f"[per-batch] {name}: last {loss_key} {got:.6f}, fused (phase "
            f"4) {want:.6f}; runs a and b bit-equal"
            + ("; the resumed run bit-equal to run a"
               if name == "flagship-cut" else "")
            + "; one replay a batch, bit-equal to launch by launch")
        if not abs(got - want) <= PER_BATCH_LOSS_RTOL * abs(want):
            raise AssertionError(f"per-batch {name}: last {loss_key} {got} "
                                 f"not within 10% of the fused {want}")
    return by_path


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def run_dp_one_rank(workdir: Path, phase4):
    """Phase 12 (c): flagship-cut with ``training.dp_devices: 1`` in a
    process group of one rank over NCCL: the same launches as phase 4 and
    bit-equal states."""
    import torch.distributed as dist
    from multimodal_idbn_tpu_torch import cuts, parallel
    d = workdir / "dp1"
    d.mkdir(exist_ok=True)
    parallel.initialize_distributed(f"file://{d / 'store'}", 1, 0,
                                    backend="nccl")
    try:
        backend = dist.get_backend()
        reset_launches()
        summary = cuts.run_cut("flagship-cut", d, overrides={
            "training": {"dp_devices": 1}})
        launches = read_launches()
        mesh = summary["model"].mesh
    finally:
        dist.destroy_process_group()
    ref_states, ref_launches = phase4["flagship-cut"][2], \
        phase4["flagship-cut"][0]
    now = state_copy(summary["model"])
    same = sorted(now) == sorted(ref_states) and all(
        torch_equal(now[k], ref_states[k]) for k in now)
    log(f"[dp] one rank ({backend}, mesh of {mesh.size}): launches "
        f"{json.dumps(launches)}; states bit-equal to phase 4: {same}; "
        f"phase seconds {json.dumps(summary['seconds'])}")
    if not same or mesh is None or mesh.size != 1:
        raise AssertionError("DP_DEVICES=1 is not bit-equal to phase 4")
    check_launches("dp one rank", launches, {
        k: ref_launches[k] for k in ("half_step_sample", "chain_run")})
    return launches


TP_UPDATES = 3


def tp_inputs(dev):
    """Flagship layer 0 and three batches of 128 for the 1 x 2 split."""
    import torch
    from multimodal_idbn_tpu_torch.ops import rbm_ops
    state = rbm_ops.init_rbm_state(31, 10000, 1500, device=dev)
    g = torch.Generator().manual_seed(5)
    batches = [(torch.rand((128, 10000), generator=g) < 0.2).float().to(dev)
               for _ in range(TP_UPDATES)]
    return state, batches


def tp_train(mesh, dev):
    """TP_UPDATES CD-2 updates of flagship layer 0 over ``mesh``; returns
    the gathered states copied off the card and the losses."""
    from multimodal_idbn_tpu_torch import parallel
    state, batches = tp_inputs(dev)
    losses = []
    for i, batch in enumerate(batches):
        state, loss = parallel.tp_cd_update(mesh, state, 900 + i, batch,
                                            lr=0.1, mom=0.5,
                                            weight_decay=1e-4, cd=2)
        losses.append(float(loss))
    whole = parallel.gather_state(state)
    return {f"layer0/{f}": getattr(whole, f).detach().cpu().clone()
            for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m")}, losses


def dp_rank_main(argv) -> int:
    """One rank of phase 12 (d): ``chip_smoke.py --dp-rank R STORE OUT``.
    Joins the two-rank gloo group on the one card, trains flagship-cut
    and bimodal-cut with ``training.dp_devices: 2`` through their entry
    points, then the 1 x 2 model split of flagship layer 0; writes its
    states, launches and seconds to OUT/rank{R}.pt."""
    import torch
    import torch.distributed as dist
    from multimodal_idbn_tpu_torch import cuts, parallel
    rank, store, out = int(argv[0]), argv[1], Path(argv[2])
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    parallel.initialize_distributed(f"file://{store}", 2, rank,
                                    backend="gloo")
    res = {"backend": dist.get_backend(), "join_s": time.perf_counter() - t0}
    try:
        for name in ("flagship-cut", "bimodal-cut"):
            d = out / f"rank{rank}-{name}"
            d.mkdir(exist_ok=True)
            reset_launches()
            t = time.perf_counter()
            summary = cuts.run_cut(name, d, overrides={
                "training": {"dp_devices": 2}})
            res[name] = dict(
                states=state_copy(summary["model"]),
                launches=read_launches(), wall_s=time.perf_counter() - t,
                seconds=summary["seconds"], mesh=summary["model"].mesh.size,
                loss=summary["image_loss" if name == "flagship-cut"
                             else "mod1_loss"])
            del summary
        t = time.perf_counter()
        res["tp"] = tp_train(parallel.make_mesh_2d(dp=1, mp=2),
                             torch.device("cuda"))
        res["tp_s"] = time.perf_counter() - t
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def run_dp_two_ranks(workdir: Path, phase4, init):
    """Phase 12 (d): two ranks on the one card over gloo (NCCL refuses
    two ranks on one device), each a process started here after the
    kernels were built, so the ranks only load them. The replicas must be
    bit-equal, each rank's launches phase 4's (it launches every kernel of
    its rows), the states within the tolerance stated above; then the
    1 x 2 model split of flagship layer 0 against the same updates on one
    device. Returns {path: launches of rank 0}."""
    import torch
    from multimodal_idbn_tpu_torch import parallel
    d = workdir / "dp2"
    d.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--dp-rank", str(r), str(d / "store"),
                               str(d)]) for r in (0, 1)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if codes != [0, 0]:
        raise AssertionError(f"a data-parallel rank failed: exit codes "
                             f"{codes}")
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in (0, 1)]
    by_path = {}
    for name in ("flagship-cut", "bimodal-cut"):
        a, b = ranks[0][name], ranks[1][name]
        if sorted(a["states"]) != sorted(b["states"]) or not all(
                torch_equal(a["states"][k], b["states"][k])
                for k in a["states"]):
            raise AssertionError(f"dp {name}: the replicas differ")
        ref_launches, ref_summary, ref_states = phase4[name]
        for r in ranks:
            check_launches(f"dp {name} rank", r[name]["launches"], {
                k: ref_launches[k] for k in ("half_step_sample",
                                             "chain_run")})
        worst, share = close_to(f"dp {name}", a["states"], ref_states,
                                *init[name])
        loss_key = "image_loss" if name == "flagship-cut" else "mod1_loss"
        want = ref_summary[loss_key]
        if not all(abs(x - y) <= PAR_LOSS_RTOL * abs(y)
                   for x, y in zip(a["loss"], want)):
            raise AssertionError(f"dp {name}: losses {a['loss']} vs {want}")
        log(f"[dp] two ranks ({ranks[0]['backend']}, mesh of "
            f"{a['mesh']}) {name}: replicas bit-equal; launches per rank "
            f"{json.dumps(a['launches'])}; vs phase 4: max |diff| "
            f"{worst:.3e}, {100 * share:.4f}% of elements within "
            f"{PAR_ATOL:g}, {loss_key} {a['loss']} vs {want}; wall "
            f"{a['wall_s']:.1f} s (phase 4 "
            f"{sum(ref_summary['seconds'].values()):.1f} s in its phases), "
            f"phase seconds {json.dumps(a['seconds'])}")
        by_path[f"dp-2-ranks {name}"] = a["launches"]
    mesh1 = parallel.make_mesh_2d(dp=1, mp=1)
    one, one_losses = tp_train(mesh1, torch.device("cuda"))
    state0, _ = tp_inputs(torch.device("cuda"))
    init_tp = {f"layer0/{f}": getattr(state0, f).cpu() for f in
               ("w", "hb", "vb", "w_m", "hb_m", "vb_m")}
    (tp_a, tp_losses), (tp_b, _) = ranks[0]["tp"], ranks[1]["tp"]
    if not all(torch_equal(tp_a[k], tp_b[k]) for k in tp_a):
        raise AssertionError("tp: the gathered states differ across ranks")
    worst, share = close_to("tp 1x2", tp_a, one, init_tp)
    if not all(abs(x - y) <= PAR_LOSS_RTOL * abs(y)
               for x, y in zip(tp_losses, one_losses)):
        raise AssertionError(f"tp: losses {tp_losses} vs {one_losses}")
    log(f"[tp] 1 x 2 split of flagship layer 0, {TP_UPDATES} CD-2 updates: "
        f"gathered states equal on both ranks; vs one device max |diff| "
        f"{worst:.3e}, {100 * share:.4f}% within {PAR_ATOL:g}; losses "
        f"{tp_losses} vs {one_losses}; {ranks[0]['tp_s']:.1f} s")
    log(f"[dp] two ranks: {wall:.1f} s wall from start to exit, the "
        f"group joined in {ranks[0]['join_s']:.1f} s")
    return by_path


def run_phase12(dev, workdir: Path, phase4):
    """Phase 12. ``phase4``: {cut: (launches, summary fields, states)}."""
    t_phase = time.perf_counter()
    rows = check_row_offsets(dev)
    by_path = run_per_batch(workdir, phase4)
    by_path["dp-1-rank flagship-cut"] = run_dp_one_rank(workdir, phase4)
    init = {name: reference_runs(name, workdir)
            for name in ("flagship-cut", "bimodal-cut")}
    by_path.update(run_dp_two_ranks(workdir, phase4, init))
    log(f"[phase12] {time.perf_counter() - t_phase:.1f} s")
    return by_path, rows


# ---------------------------------------------------------------------------
# Phase 13: the shipped flagship schedule
# ---------------------------------------------------------------------------

# A run collapsed when its training-set top-1 is below 3/32 (chance is
# 1/32) or its image stack reconstructs at the blank level: validation
# auto-reconstruction MSE at or above 0.9 x the mean square of the images,
# the image iDBN's own collapse criterion (models/idbn.py
# _warn_if_collapsed). The TXT->IMG image MSE is printed beside its blank
# ratio and not held: it sits at the blank level on every seed of both
# recorded arms (benchmarks/RESULTS.md, "Round 5: flagship quality
# parity": medians 0.092 against a blank of 0.0922).
COLLAPSE_TOP1 = 3 / 32
COLLAPSE_BLANK = 0.9


def run_phase13(workdir: Path):
    """Phase 13: configs/multimodal_training_config.yaml end to end at its
    full schedule through ``train_multimodal`` (2048 samples, 100 image
    epochs of CD-10, 150 joint epochs of CD-5), the launches of kernels 1
    and 2 held against their derivation (``quality.derived_launches``),
    every state finite, then the 14 metrics of the quality protocol
    (``quality.evaluate_imdbn``) and the collapse check above. Returns
    the run's launches."""
    import numpy as np
    import yaml
    from multimodal_idbn_tpu_torch import quality, train_multimodal
    from multimodal_idbn_tpu_torch.data import DataLoader
    t_phase = time.perf_counter()
    cfg = yaml.safe_load((ROOT / "configs"
                          / "multimodal_training_config.yaml").read_text())
    cfg["paths"]["save_dir"] = str(workdir / "flagship-full")
    path = workdir / "flagship-full.yaml"
    path.write_text(yaml.safe_dump(cfg))
    t, m = cfg["training"], cfg["model"]
    schedule = dict(batch=cfg["dataset"]["batch_size"],
                    layers=m["image_layers"], epochs_img=t["epochs_image"],
                    epochs_joint=t["epochs_joint"], cd=t["cd"])
    reset_launches()
    summary = train_multimodal.main(["--config", str(path)])
    launches = read_launches()
    model = summary["model"]
    n_train = len(model.dataloader.dataset)
    want = dict(dict.fromkeys((k for k in launches if k not in (
        "philox_fill", "graph_replays", "serving_replays")), 0),
        **quality.derived_launches("flagship", schedule, n_train))
    want["graph_replays"] = schedule["epochs_img"] + schedule["epochs_joint"]
    check_launches("flagship-full", launches, want)
    check_states(*cut_states("flagship-cut", model))
    t0 = time.perf_counter()
    metrics = quality.evaluate_imdbn(model, model.val_loader, probes=True)
    train_eval = DataLoader(model.dataloader.dataset,
                            batch_size=model.dataloader.batch_size)
    metrics.update({f"train_{k}": v for k, v in quality.evaluate_imdbn(
        model, train_eval, probes=False).items()})
    eval_s = time.perf_counter() - t0
    val_imgs = np.asarray(model.val_loader.materialize()[0], np.float32)
    blank = float((val_imgs.reshape(len(val_imgs), -1) ** 2).mean())
    log(f"[phase13] flagship YAML at its full schedule: {n_train} training "
        f"rows, phase seconds {json.dumps(summary['seconds'])}, evaluation "
        f"{eval_s:.1f} s; launches {json.dumps(launches)} (derived "
        f"{json.dumps(want)}); last cross metrics "
        f"{json.dumps(summary['cross_metrics'])}")
    log(f"[phase13] the 14 metrics: {json.dumps(metrics)}")
    if sorted(metrics) != sorted(quality.FLAGSHIP_METRICS) or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"phase 13: metrics not finite or incomplete: "
                             f"{metrics}")
    collapsed = (metrics["train_top1"] < COLLAPSE_TOP1
                 or metrics["recon_mse"] >= COLLAPSE_BLANK * blank)
    log(f"[phase13] collapse check: train top-1 {metrics['train_top1']} "
        f"(limit {COLLAPSE_TOP1:.4f}), validation recon MSE "
        f"{metrics['recon_mse']} = {metrics['recon_mse'] / blank:.3f} x "
        f"blank {blank:.6f} (limit {COLLAPSE_BLANK}); TXT->IMG image MSE "
        f"{metrics['image_mse']} = {metrics['image_mse'] / blank:.3f} x "
        f"blank (not held); {'COLLAPSED' if collapsed else 'not collapsed'}")
    if collapsed:
        raise AssertionError("phase 13: the flagship run collapsed")
    log(f"[phase13] {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: graph replays against launch by launch
# ---------------------------------------------------------------------------

# The epoch functions the models call, by module of the port's ops.
EPOCH_BLOCKS = (("dbn_train", "idbn_epoch_block"),
                ("dbn_train", "idbn_epoch_block_pcd"),
                ("imdbn_ops", "joint_epoch_block"),
                ("bimodal_ops", "bimodal_epoch_block"))
# PERF.md section 5 (profile_main_path.py, F4; launch by launch, NVIDIA
# H100 80GB HBM3, 700 W): the joint phases of the cuts, 9 epochs.
F4_JOINT = {"flagship-cut": "joint 0.220 s, idle 44.0%",
            "bimodal-cut": "joint 0.64-0.93 s, idle 64.5%, ~60 000 "
                           "launches"}


def _clone_tree(tree):
    import torch
    from multimodal_idbn_tpu_torch.ops import graphs
    return graphs.map_tree(torch.clone, tree)


def _trees_equal(a, b) -> bool:
    import torch
    from multimodal_idbn_tpu_torch.ops import graphs
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    return sa == sb and len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


@contextlib.contextmanager
def recorded_epochs():
    """Inside the block every call of an epoch function of
    ``EPOCH_BLOCKS`` is recorded: its arguments (cloned), its runner, its
    outputs (cloned: a graphed runner's state lives in its buffers, which
    the next replay overwrites) and the kernel launches it made. Every
    replay of a captured graph runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation
    raises."""
    import importlib
    import torch
    from multimodal_idbn_tpu_torch.ops import graphs
    records, saved = [], []
    for mod_name, fn_name in EPOCH_BLOCKS:
        mod = importlib.import_module(
            f"multimodal_idbn_tpu_torch.ops.{mod_name}")
        real = getattr(mod, fn_name)

        def wrapper(*args, _real=real, _mod=mod_name, _fn=fn_name, **kw):
            rec = dict(mod=_mod, fn=_fn, args=_clone_tree(args),
                       kw={k: v for k, v in kw.items() if k != "runner"},
                       runner=kw.get("runner"))
            before = graphs.launch_counts()
            out = _real(*args, **kw)
            rec["launches"] = graphs.launches_since(before)
            rec["out"] = _clone_tree(out)
            records.append(rec)
            return out

        saved.append((mod, fn_name, real))
        setattr(mod, fn_name, wrapper)
    real_replay = graphs.EpochRunner._replay

    def checked_replay(self, *a):
        if self._graph is None:
            return real_replay(self, *a)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_replay(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    graphs.EpochRunner._replay = checked_replay
    try:
        yield records
    finally:
        graphs.EpochRunner._replay = real_replay
        for mod, fn_name, real in saved:
            setattr(mod, fn_name, real)


def derived_epoch_launches(rec) -> dict:
    """Launches of kernels 1 and 2 in one epoch of a record, derived:
    image CD 1 + 2·CD half-steps per layer and batch, PCD 3 + 2·CD per
    layer and full batch and 1 + 2·CD for the remainder; joint chains as
    ``quality.derived_launches`` per epoch (flagship warm-up 4 and main 3
    a batch, plus the z-clamp of every 50th; bimodal 4 and 2)."""
    kw, fn = rec["kw"], rec["fn"]
    bs = kw["batch_size"]
    if fn.startswith("idbn"):
        states, data = rec["args"][0], rec["args"][3 if fn.endswith("pcd")
                                                     else 2]
        n, L, cd = data.shape[0], len(states), kw["cd"]
        nb, rem = n // bs, n % bs
        per = 3 + 2 * cd if fn.endswith("pcd") else 1 + 2 * cd
        return {"half_step_sample": L * (nb * per
                                         + (1 + 2 * cd) * (rem > 0)),
                "chain_run": 0}
    nb = -(-rec["args"][3 if fn == "joint_epoch_block" else 4].shape[0]
           // bs)
    if kw["warmup"]:
        chain = 4 * nb
    elif fn == "joint_epoch_block":
        chain = 3 * nb + -(-nb // kw["zclamp_every"])
    else:
        chain = 2 * nb
    return {"half_step_sample": 0, "chain_run": chain}


def _port_launches(delta) -> dict:
    """Launches by entry. A kernel's launches by body (``body:<name>``,
    the half-step's and the chain's) are the same launches seen another
    way: they must add up to its launches by entry, and are left out."""
    out = {"half_step_sample": 0, "chain_run": 0, "philox_fill": 0}
    by_body, by_entry = {}, {}
    for (src, entry), n in delta.items():
        if entry.startswith("body:"):
            by_body[src] = by_body.get(src, 0) + n
            continue
        by_entry[src] = by_entry.get(src, 0) + n
        out[entry if entry in out else f"{src}:{entry}"] = n
    for src, n in by_body.items():
        if n != by_entry.get(src, 0):
            raise AssertionError(f"{src} launches by body {n}, by entry "
                                 f"{by_entry.get(src, 0)}: {delta}")
    return out


def check_replays(what: str, records) -> dict:
    """Every recorded epoch: run by a graphed runner, one replay per
    epoch, its launches those of the runner's capture and as derived;
    then the same epoch function called again with the same arguments and
    no runner (launch by launch) must return bit-equal states, losses and
    metric sums with the same launches. Returns {epoch function: epochs}."""
    import importlib
    from multimodal_idbn_tpu_torch.ops import graphs
    runners = {}
    for rec in records:
        r = rec["runner"]
        if r is None or not r.graphed:
            raise AssertionError(f"{what}: {rec['fn']} ran without a "
                                 f"graphed runner")
        runners.setdefault(id(r), [r, 0])[1] += 1
    for r, calls in runners.values():
        if r.replays != calls:
            raise AssertionError(f"{what}: {r.name} replayed {r.replays} "
                                 f"times in {calls} epochs")
    counts = {}
    for i, rec in enumerate(records):
        got = _port_launches(rec["launches"])
        want = derived_epoch_launches(rec)
        if any(got[k] != v for k, v in want.items()) or \
                rec["launches"] != rec["runner"].launches_per_replay:
            raise AssertionError(f"{what}: epoch {i} ({rec['fn']}) launched "
                                 f"{got}, derived {want}, the capture "
                                 f"{rec['runner'].launches_per_replay}")
        fn = getattr(importlib.import_module(
            f"multimodal_idbn_tpu_torch.ops.{rec['mod']}"), rec["fn"])
        before = graphs.launch_counts()
        eager = fn(*_clone_tree(rec["args"]), **rec["kw"])
        eager_launches = graphs.launches_since(before)
        if not _trees_equal(eager, rec["out"]):
            raise AssertionError(f"{what}: epoch {i} ({rec['fn']}) replayed "
                                 f"is not bit-equal to launch by launch")
        if eager_launches != rec["launches"]:
            raise AssertionError(f"{what}: epoch {i} launched "
                                 f"{eager_launches} by launch, "
                                 f"{rec['launches']} replayed")
        counts[rec["fn"]] = counts.get(rec["fn"], 0) + 1
    return counts


def profile_joint(what: str, records) -> dict:
    """The joint phase of a cut twice from the recorded inputs: replayed
    (each epoch's runner called again: a replay, its output bit-equal to
    the recorded one) and launch by launch (the epoch function without a
    runner). For each: wall seconds (host clock around the synchronised
    phase), device busy ms and operations (profiled once more) and the
    idle share of the wall time."""
    import importlib
    from multimodal_idbn_tpu_torch.ops import graphs, rng
    joint = [r for r in records if r["fn"] in ("joint_epoch_block",
                                               "bimodal_epoch_block")]
    out = {}

    def replayed():
        for rec in joint:
            a = rec["args"]
            state, epoch_key = _clone_tree(a[0]), a[2 if rec["fn"] ==
                                                    "joint_epoch_block"
                                                    else 3]
            e_idx, lr, mom = (a[6], a[7], a[8]) if rec["fn"] == \
                "joint_epoch_block" else (a[8], a[9], a[10])
            rec["runner"](state, rng.fold_in(epoch_key, int(e_idx[0])),
                          lr[0], mom[0])

    def eager():
        for rec in joint:
            fn = getattr(importlib.import_module(
                f"multimodal_idbn_tpu_torch.ops.{rec['mod']}"), rec["fn"])
            fn(*_clone_tree(rec["args"]), **rec["kw"])

    for label, fn in (("replayed", replayed), ("launch by launch", eager)):
        before = graphs.launch_counts()
        _, wall_ms, _ = timed_call(fn)
        launches = _port_launches(graphs.launches_since(before))
        busy, ops, missing = busy_ms(fn)
        out[label] = dict(wall_s=wall_ms / 1e3, busy_ms=busy,
                          device_ops=ops, records_missing=missing,
                          idle_share=max(0.0, 1 - busy / wall_ms),
                          launches=launches)
        log(f"[phase14] {what} joint phase ({len(joint)} epochs) {label}: "
            f"{wall_ms / 1e3:.4f} s wall, {busy:.1f} ms busy, idle "
            f"{100 * max(0.0, 1 - busy / wall_ms):.1f}%, {ops} device "
            f"operations ({missing} records missing), port kernels "
            f"{json.dumps(launches)}")
    return out


def check_philox_fill(dev):
    """philox_fill against its plain version on the card and against a
    repeat, bit for bit, keyed by value and from a key table, at the
    shapes of the main paths; the kernels-line row of [128, 1500], the
    bimodal cross metrics' Bernoulli draws."""
    import torch
    from multimodal_idbn_tpu_torch.ops import philox_fill, rng
    keys = torch.tensor(rng.key_values(7, [(1,), (2, 3)]),
                        dtype=torch.int64, device=dev)
    rows = []
    for (r, c, bits16, row0) in ((128, 1500, False, 0), (128, 532, False, 0),
                                 (12, 2500, False, 116), (500, 532, True, 0),
                                 (1500, 1, True, 0)):
        for how in ("value", "table"):
            if how == "value":
                key = rng.fold_in(rng.fold_in(7, 2), 3)
                k = philox_fill.fill(key, r, c, device=dev, row0=row0,
                                     bits16=bits16)
                again = philox_fill.fill(key, r, c, device=dev, row0=row0,
                                         bits16=bits16)
            else:
                table = rng.KeyTable(keys, [(1,), (2, 3)])
                with rng.key_table(table):
                    philox_fill.fill(rng.Key((1,)), 1, 1, device=dev)
                    k = philox_fill.fill(rng.Key((2, 3)), r, c, device=dev,
                                         row0=row0, bits16=bits16)
                again = k.clone()
            p = philox_fill.fill_plain(rng.fold_in(rng.fold_in(7, 2), 3), r,
                                       c, device=dev, row0=row0,
                                       bits16=bits16)
            if not (torch.equal(k, p) and torch.equal(k, again)):
                raise AssertionError(f"philox_fill [{r},{c}] bits16={bits16}"
                                     f" by {how}: not bit-equal")
        rows.append(dict(shape=f"[{r},{c}]{' bits16' if bits16 else ''}",
                         max_abs_err=float((k.double() - p.double())
                                           .abs().max())))
    r, c = 128, 1500
    key = rng.fold_in(3, 4)
    ms = time_ms(lambda: philox_fill.fill(key, r, c, device=dev), 200)
    plain_ms = time_ms(lambda: philox_fill.fill_plain(key, r, c,
                                                      device=dev), 20)
    rand_ms = time_ms(lambda: torch.rand((r, c), device=dev), 200)
    # 8 bytes of key and 4 of output per element; ~110 integer operations
    # per Philox4x32-10 element, at the CUDA-core rate (the published fp32
    # rate; the integer units run at most as fast)
    n = r * c
    t_ops = 110 * n / PEAK_FP32_FLOPS * 1e3
    t_bytes = (8 + 4 * n) / PEAK_HBM_BYTES * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=None, torch_rand_ms=rand_ms,
               max_abs_err=max(x["max_abs_err"] for x in rows),
               other_shapes=rows[1:])
    log(f"[phase14] philox_fill bit-equal to its plain version and to a "
        f"repeat, by value and from a key table, at "
        f"{[x['shape'] for x in rows]}; [128,1500]: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}); torch.rand (another function) {rand_ms:.4f} "
        f"ms")
    return row


def run_phase14(dev, workdir: Path):
    """Phase 14. Returns (the philox_fill row, launches by path)."""
    from multimodal_idbn_tpu_torch import cuts
    from multimodal_idbn_tpu_torch.ops import graphs
    t_phase = time.perf_counter()
    fill_row = check_philox_fill(dev)
    by_path, profiles = {}, {}
    for name, variant in (("flagship-cut", None), ("bimodal-cut", None),
                          ("flagship-cut", "pcd")):
        what = f"{name} {variant}" if variant else name
        sub = workdir / f"p14-{variant or name}"
        sub.mkdir()
        reset_launches()
        t0 = time.perf_counter()
        with recorded_epochs() as records:
            summary = (cuts.run_variant(variant, sub) if variant
                       else cuts.run_cut(name, sub))
        wall = time.perf_counter() - t0
        launches = read_launches()
        captures = list(graphs.STATS["captures"])
        warm = dict(graphs.STATS["warmup_launches"])
        counts = check_replays(what, records)
        log(f"[phase14] {what}: {wall:.1f} s through the entry point, phase "
            f"seconds {json.dumps(summary['seconds'])}; every epoch one "
            f"replay ({launches['graph_replays']} replays: "
            f"{json.dumps(counts)}), launches as derived, bit-equal to the "
            f"same epochs launch by launch, replays free of host "
            f"synchronisation; launches {json.dumps(launches)}; the "
            f"warm-ups' (not counted) {json.dumps(warm)}")
        for c in captures:
            log(f"[phase14] {what} capture {c['name']}: {c['seconds']:.3f} "
                f"s, graph pool {c['pool_bytes'] / 2 ** 20:.1f} MiB, "
                f"launches per replay {json.dumps(c['launches'])}")
        by_path[f"graphs {what}"] = launches
        if variant is None:
            profiles[name] = profile_joint(name, records)
            log(f"[phase14] {name} joint phase launch by launch in PERF.md "
                f"section 5 (profile_main_path.py, F4): {F4_JOINT[name]}")
        del records, summary
    log(f"[phase14] {time.perf_counter() - t_phase:.1f} s")
    return fill_row, by_path


# ---------------------------------------------------------------------------
# The rest of what the JAX package jits: derivations shared by phases 10, 12
# and 15, and phase 15, the RBM shell
# ---------------------------------------------------------------------------

def derived_replay_launches(g):
    """Kernel launches of one replay of graph ``g`` of a model's cache,
    derived from the code (None where this PR derives nothing: the
    serving calls of phases 6 and 6b). A Bernoulli draw is one
    ``philox_fill``, a softmax group's categorical draw one more; a
    mean-field or noisy chain one ``chain_run`` after its initial draw;
    CD-k through the half-step kernel 1 + 2k half-steps (groupless fp32),
    else 1 + k(2 + G) fills in plain torch."""
    st = g.statics
    G = len(st.get("groups") or ())
    sh, sv = int(st.get("sample_h", False)), int(st.get("sample_v", False))

    def cd(kw):
        if kw["groups"]:
            return {"philox_fill": 1 + kw["cd"] * (2 + len(kw["groups"]))}
        return {"half_step_sample": 1 + 2 * kw["cd"]}

    def clamped(kw):
        n = kw["cd"] * (int(kw["sample_h"])
                        + int(kw["sample_v"]) * (1 + len(kw["groups"])))
        return ({"chain_run": 1, "philox_fill": 1 + n}
                if kw["use_noisy_init"] else None)

    def add(*parts):
        out = {}
        for p in parts:
            for k, n in p.items():
                out[k] = out.get(k, 0) + n
        return out

    name = g.name.split(":", 1)[1].lstrip("_")
    if name in ("probe_chunk", "class_free_energies", "img2txt_chain",
                "joint_bias_stats", "hidden_probs", "visible_probs",
                "visible_logits", "free_energy", "dbn_represent",
                "dbn_decode", "dbn_reconstruct"):
        return {}
    if name in ("traj_chain", "mod2_to_mod1_body"):
        return {"philox_fill": st["steps"]}
    if name == "img2txt_panel_chain":
        return {"philox_fill": 1 + st["steps"] * (sh + sv * (1 + G))}
    if name == "txt2img_panel_chain":
        return {"philox_fill": st["steps"] * (sh + sv * (1 + G))}
    if name in ("sample_visible", "backward_sample"):
        return {"philox_fill": 1 + G}
    if name == "gibbs_step":
        return {"philox_fill": sh + sv * (1 + G)}
    if name == "conditional_gibbs":
        if not sh and not sv:
            return {"chain_run": 1, "philox_fill": 1}
        return {"philox_fill": 1 + st["n_steps"] * (sh + sv * (1 + G))}
    if name == "conditional_gibbs_annealed":
        n, e = st["n_steps"], st["sample_v_every"]
        hot = max(0, min(n, st["sample_h_until"]))
        v_draws = sum(1 for t in range(hot) if e > 0 and t % e == 0)
        return {"philox_fill": 1 + hot + v_draws * (1 + G)}
    if name == "noisy_meanfield_annealed":
        return {"chain_run": 1, "philox_fill": 1}
    if name == "cd_update":
        return cd(st)
    if name == "clamped_cd_update":
        return clamped(st)
    if name == "batch_step":
        return add(*(cd(kw) for kw in st["layers"]))
    if name == "joint_batch_step":
        clamp = clamped(dict(st["clamp"]))
        parts = [clamp, clamp] if st["warmup"] else (
            [cd(st["train"]), clamp] + [clamp] * int(st["zclamp"]))
        if st["metrics"]:      # the round trip: two mean-field chains
            parts.append({"chain_run": 2, "philox_fill": 2})
        return add(*parts)
    if name == "bimodal_batch_step":
        # the clamps' noisy inits; the fills are held to launch by launch
        return {"chain_run": 4 if st["warmup"] else 2, "philox_fill": None}
    return None


def check_derivations(tag: str, owners) -> dict:
    """Every graph of the owners' caches whose launches this PR derives:
    its launches per replay as derived. Returns {graph name: launches per
    replay} of the graphs checked."""
    seen = {}
    for owner in owners:
        cache = owner.__dict__.get("_serving")
        for g in (cache.graphs.values() if cache else ()):
            want = derived_replay_launches(g)
            if want is None:
                continue
            got = _port_launches(g.launches_per_replay)
            # a kernel left out of ``want`` launches 0 times; one given as
            # None is not derived (held to launch by launch by the caller)
            if any(want.get(k, 0) is not None and n != want.get(k, 0)
                   for k, n in dict(dict.fromkeys(want, 0), **got).items()):
                raise AssertionError(f"{tag}: {g.name} launches {got} per "
                                     f"replay, derived {want}")
            seen[g.name] = {k: n for k, n in got.items() if n}
    log(f"[{tag}] launches per replay as derived: {json.dumps(seen)}")
    return seen


def rbm_owners(model):
    """A model, its iDBNs and every RBM shell it holds: the owners of its
    graphs."""
    from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    parts = [model] + [getattr(model, a) for a in
                       ("image_idbn", "mod1_dbn", "mod2_dbn")
                       if hasattr(model, a)]
    return parts + list(_collect_rbms(model).values())


def stream_states(model):
    """The key streams of every RBM shell of a model, to restore."""
    from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    return {n: r._gen.get_state() for n, r in _collect_rbms(model).items()}


def restore_streams(model, states) -> None:
    from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    for n, r in _collect_rbms(model).items():
        r._gen.set_state(states[n])


@contextlib.contextmanager
def recorded_calls():
    """Inside the block the output of every call through ``graphs.serve``
    and ``graphs.update`` (replayed or launch by launch) is kept, cloned,
    in the list the block gets."""
    import torch
    from multimodal_idbn_tpu_torch.ops import graphs
    outs = []
    real_serve, real_update = graphs.serve, graphs.update

    def serve(*a, **k):
        out = real_serve(*a, **k)
        outs.append(graphs.map_tree(torch.clone, out))
        return out

    def update(*a, **k):
        out = real_update(*a, **k)
        outs.append(graphs.map_tree(torch.clone, out))
        return out

    graphs.serve, graphs.update = serve, update
    try:
        yield outs
    finally:
        graphs.serve, graphs.update = real_serve, real_update


def logged_numbers(run) -> dict:
    """{key: values} of every numeric key a run logged, timings aside."""
    return {k: run.values(k) for k in run.numeric_keys()
            if not k.startswith("perf/") and k != "epoch"}


def numbers_equal(a, b) -> bool:
    import numpy as np
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(numbers_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(numbers_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b or (a != a and b != b)


SHELL_WIDTHS = (("532x500", 532, 500, ((500, 532),), 500),
                ("2500x1500", 2500, 1500, (), 1500))
SHELL_B = 128
SHELL_SEED = 515


def shell_calls(r, Dz: int):
    """{entry: (call, derived launches of one call)} of every jitted entry
    of the shell ``r`` at ``SHELL_B`` rows: the clamp known on the first
    ``Dz`` coordinates (the image latent of the flagship joint, MOD1's of
    the bimodal one), each chain at its default steps, CD-1."""
    import torch
    g = torch.Generator().manual_seed(SHELL_SEED)
    V, H, G = r.num_visible, r.num_hidden, len(r.softmax_groups)
    dev = r.device
    v = torch.rand((SHELL_B, V), generator=g).to(dev)
    h = torch.rand((SHELL_B, H), generator=g).to(dev)
    km = torch.cat([torch.ones(SHELL_B, Dz), torch.zeros(SHELL_B, V - Dz)],
                   1).to(dev)
    fast = not G
    return {
        "forward": (lambda: r.forward(v), {}),
        "visible_probs": (lambda: r.visible_probs(h), {}),
        "backward": (lambda: r.backward(h, return_logits=True), {}),
        "free_energy": (lambda: r.free_energy(v), {}),
        "sample_visible": (lambda: r.sample_visible(v),
                           {"philox_fill": 1 + G}),
        "backward_sample": (lambda: r.backward_sample(h),
                            {"philox_fill": 1 + G}),
        "gibbs_step": (lambda: r.gibbs_step(v), {"philox_fill": 2 + G}),
        "conditional_gibbs": (lambda: r.conditional_gibbs(v, km),
                              {"chain_run": 1, "philox_fill": 1}),
        "conditional_gibbs_annealed": (
            lambda: r.conditional_gibbs_annealed(v, km),
            {"philox_fill": 1 + 20}),
        "noisy_meanfield_annealed": (
            lambda: r.noisy_meanfield_annealed(v, km),
            {"chain_run": 1, "philox_fill": 1}),
        "train_epoch": (lambda: r.train_epoch(v, 3, 10, CD=1),
                        {"half_step_sample": 3} if fast
                        else {"philox_fill": 1 + (2 + G)}),
        "train_epoch_clamped": (
            lambda: r.train_epoch_clamped(v, km, 3, 10, CD=1),
            {"chain_run": 1, "philox_fill": 2}),
    }


def check_public_batch_steps(dev) -> dict:
    """Phase 15 (b): the three per-batch steps the JAX package jits,
    called directly at full width (B = 128): ``dbn_train.idbn_batch_step``
    on the flagship image stack, ``imdbn_ops.joint_train_batch_step`` on
    the flagship joint with that stack's decode, and
    ``bimodal_ops.bimodal_batch_step`` on the bimodal joint DBN with both
    modality stacks. Each launch by launch, through its graph (a capture,
    then a replay) and replayed under the sync check, from the same
    inputs: outputs bit-equal, launches the same, one replay a call.
    Returns the launches of one replayed call of each."""
    import torch
    from multimodal_idbn_tpu_torch.ops import (bimodal_ops, dbn_train,
                                               graphs, imdbn_ops, rbm_ops,
                                               rng)
    g = torch.Generator().manual_seed(SHELL_SEED)

    def states(i, widths):
        return [rbm_ops.init_rbm_state(rng.fold_in(SHELL_SEED, 10 * i + j),
                                       v, h, device=dev)
                for j, (v, h) in enumerate(zip(widths, widths[1:]))]

    def rand(*shape, p=None):
        t = torch.rand(shape, generator=g)
        return (t < p).float().to(dev) if p else t.to(dev)

    B = SHELL_B
    img, mod1, mod2 = (states(1, [10000, 1500, 500]),
                       states(2, [10000, 1500, 1500]),
                       states(3, [1568, 500, 500, 1000]))
    joint, bjoint = states(4, [532, 500])[0], states(5, [2500, 1500, 500])
    x, v2 = rand(B, 10000, p=0.3), rand(B, 1568, p=0.3)
    y = torch.eye(32, device=dev)[torch.arange(B, device=dev) % 32]
    calls = {
        "idbn_batch_step": lambda: dbn_train.idbn_batch_step(
            img, 11, x, 0.1, 0.5, 2e-4, 0.05, cd=1,
            sparsity_flags=(False, False), fast_sampler=True),
        "joint_train_batch_step": lambda: imdbn_ops.joint_train_batch_step(
            joint, img, 12, rand(B, 500), y, x, 0, 0.04, 0.5, 2e-4, None,
            warmup=False, joint_cd=1, aux_cond_steps=10, Dz=500, steps=50,
            groups=((500, 532),)),
        "bimodal_batch_step": lambda: bimodal_ops.bimodal_batch_step(
            bjoint, mod1, mod2, 13, rand(B, 1500), rand(B, 1000), x, v2,
            0.04, 0.5, 2e-4, warmup=False, joint_cd=1, aux_cond_steps=10,
            Dz1=1500, steps=30),
    }
    out = {}
    for name, call in calls.items():
        runs = []
        for way in ("launch by launch", "first call", "replay"):
            g.manual_seed(SHELL_SEED + 1)
            reset_launches()
            with (graphs.launch_by_launch() if way == "launch by launch"
                  else replays_checked() if way == "replay"
                  else contextlib.nullcontext()):
                res = _clone_tree(call())
            torch.cuda.synchronize()
            runs.append((res, read_launches()))
        (eager, le), (first, lf), (again, lr) = runs
        if not (_trees_equal(first, eager) and _trees_equal(again, eager)):
            raise AssertionError(f"{name}: replayed is not bit-equal to "
                                 f"launch by launch")
        kernels = [{k: x.get(k, 0) for k in KERNEL_ENTRIES}
                   for x in (le, lf, lr)]
        if kernels[0] != kernels[1] or kernels[0] != kernels[2] or \
                lr["serving_replays"] != 1 or le["serving_replays"]:
            raise AssertionError(f"{name}: launches {le} launch by launch, "
                                 f"{lf} first, {lr} replayed")
        out[name] = {k: n for k, n in lr.items() if n}
    log(f"[phase15] the per-batch steps called directly, one replay each, "
        f"bit-equal to launch by launch: {json.dumps(out)}")
    return out


def run_phase15(dev):
    """Phase 15: the RBM shell's jitted entries at the joint widths of
    both families. Each entry three ways from the same key stream (and,
    for the training entries, the same state): launch by launch, its
    first call through the shell's graphs (a capture, then a replay) and
    a replay under ``replays_checked``; outputs (and new states)
    bit-equal, kernel launches the same three ways and as derived, one
    replay per call. Then one more ``train_epoch`` and every entry again:
    bit-equal to launch by launch, changed, no new capture. Each entry
    timed replayed and launch by launch (median wall of 5 calls). Returns
    {path: launches of one replayed call of every entry}."""
    import statistics
    import torch
    from multimodal_idbn_tpu_torch.models import RBM
    from multimodal_idbn_tpu_torch.ops import graphs
    t_phase = time.perf_counter()
    by_path = {}
    for tag, V, H, groups, Dz in SHELL_WIDTHS:
        r = RBM(V, H, 0.05, 2e-4, 0.5, dynamic_lr=True,
                softmax_groups=list(groups) or None, seed=SHELL_SEED,
                device=dev)
        calls = shell_calls(r, Dz)
        state0 = graphs.map_tree(torch.clone, r.state)
        total = dict.fromkeys(KERNEL_ENTRIES + ("serving_replays",
                                                "step_replays"), 0)
        before, timing, caps_all = {}, {}, []
        for entry, (call, want) in calls.items():
            train = entry.startswith("train")
            runs = []
            for way in ("launch by launch", "first call", "replay"):
                r.reseed(SHELL_SEED)
                if train:
                    r.state = graphs.map_tree(torch.clone, state0)
                reset_launches()
                with (graphs.launch_by_launch() if way == "launch by launch"
                      else replays_checked() if way == "replay"
                      else contextlib.nullcontext()):
                    out = call()
                    if train:
                        out = (out, graphs.map_tree(torch.clone, r.state))
                torch.cuda.synchronize()
                if way == "first call":
                    caps_all += graphs.STATS["captures"]
                runs.append((out, read_launches(),
                             len(graphs.STATS["captures"])))
            (eager, le, _), (first, lf, _), (again, lr, caps) = runs
            if not (_trees_equal(first, eager) and _trees_equal(again,
                                                                eager)):
                raise AssertionError(f"shell {tag} {entry}: replayed is not "
                                     f"bit-equal to launch by launch")
            kernels = {k: le.get(k, 0) for k in KERNEL_ENTRIES}
            derived = dict(dict.fromkeys(KERNEL_ENTRIES, 0), **want)
            replays = lr["serving_replays"] + lr["step_replays"]
            if any({k: x.get(k, 0) for k in KERNEL_ENTRIES} != kernels
                   for x in (lf, lr)) or kernels != derived or \
                    replays != 1 or caps or \
                    le["serving_replays"] + le["step_replays"]:
                raise AssertionError(
                    f"shell {tag} {entry}: launches {kernels} (first call "
                    f"{lf}, replay {lr}), derived {derived}; replays "
                    f"{replays}; captures in the replay run {caps}")
            for k in total:
                total[k] += lr.get(k, 0)
            if not train:
                before[entry] = eager
            times = {}
            for way in ("replayed", "launch by launch"):
                with (graphs.launch_by_launch() if way == "launch by launch"
                      else contextlib.nullcontext()):
                    times[way] = round(statistics.median(
                        timed_call(call)[1] for _ in range(5)), 4)
            timing[entry] = times
        r.state = graphs.map_tree(torch.clone, state0)
        r.reseed(SHELL_SEED)
        r.train_epoch(torch.rand((SHELL_B, V), generator=torch.Generator()
                                 .manual_seed(1)).to(dev), 4, 10, CD=1)
        graphs.reset_stats()
        for entry, (call, _) in calls.items():
            if entry not in before:
                continue
            outs = []
            for way in ("launch by launch", "replay"):
                r.reseed(SHELL_SEED)
                with (graphs.launch_by_launch() if way == "launch by launch"
                      else replays_checked()):
                    outs.append(call())
            if not _trees_equal(outs[1], outs[0]):
                raise AssertionError(f"shell {tag} {entry}: after one more "
                                     f"epoch, replayed is not bit-equal to "
                                     f"launch by launch")
            if entry != "sample_visible" and _trees_equal(outs[0],
                                                          before[entry]):
                raise AssertionError(f"shell {tag} {entry}: the output did "
                                     f"not change after one more epoch")
        if graphs.STATS["captures"]:
            raise AssertionError(f"shell {tag}: new captures after one more "
                                 f"epoch: {graphs.STATS['captures']}")
        check_derivations(f"phase15 {tag}", [r])
        log_captures(f"phase15 {tag}", caps_all)
        log(f"[phase15] shell {tag} (groups {list(groups)}, B={SHELL_B}): "
            f"every entry bit-equal three ways, one replay a call, launches "
            f"as derived; after one more train_epoch bit-equal, changed, no "
            f"capture; launches of one call of each {json.dumps(total)}; "
            f"median wall ms replayed / launch by launch "
            f"{json.dumps(timing)}")
        by_path[f"rbm-shell {tag}"] = total
        del r, calls
    steps = check_public_batch_steps(dev)
    by_path["batch-steps direct"] = {
        k: sum(row.get(k, 0) for row in steps.values())
        for k in KERNEL_ENTRIES + ("serving_replays", "step_replays")}
    log(f"[phase15] {time.perf_counter() - t_phase:.1f} s")
    return by_path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from multimodal_idbn_tpu_torch import resolve_device
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    try:
        dev = resolve_device("cuda")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        log(f"[device] {torch.cuda.get_device_name(0)}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}; {smi}")
        build_kernels()
        hs_main, hs_rows = check_half_step(dev)
        hs_big = check_half_step_big(dev)
        mdbn_rows = check_mdbn_kernels(dev)
        resident = check_resident(dev)
        ch_rows = check_chain(dev)
        check_determinism(dev)
        check_learns(dev)
        by_path = {}
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            by_path["flagship-cut"], flagship = run_path("flagship-cut", tmp)
            by_path["bimodal-cut"], summary = run_path("bimodal-cut", tmp)
            trained = {"flagship-cut": state_copy(flagship["model"]),
                       "bimodal-cut": state_copy(summary["model"])}
            phase4 = {name: (by_path[name], {
                k: s[k] for k in ("image_loss", "mod1_loss", "seconds")
                if k in s}, trained[name]) for name, s in (
                    ("flagship-cut", flagship), ("bimodal-cut", summary))}
            by_path["resident-drive"] = run_resident_drive(
                dev, summary["model"])
            by_path["bimodal-serving-drive"] = run_bimodal_serving(
                dev, summary["model"])
            del summary
            by_path["serving-drive"], pkl, mean_images = run_serving(
                dev, flagship["model"], tmp)
            run_generate(pkl, tmp, mean_images)
            del flagship, mean_images
            by_path["resume-drive flagship"], model = run_resume(
                "flagship-cut", (("image", 2), ("joint", 4), ("joint", 8),
                                 ("joint", 10)), tmp)
            time_checkpoint(model, tmp, "flagship-cut joint")
            by_path["resume-drive bimodal"], model = run_resume(
                "bimodal-cut", (("bimodal_joint", 4), ("bimodal_joint", 10)),
                tmp)
            time_checkpoint(model, tmp, "bimodal-cut joint")
            del model
            by_path["retry-finetune-drive"] = run_retry_finetune(dev, tmp)
            diag = run_diagnostics(dev, tmp, trained)
            for name, counts in diag.items():
                by_path[name if name.startswith("diagnostics-alone")
                        else f"diagnostics-drive {name}"] = counts
            variants, pcd_row = run_variants(dev, tmp)
            by_path.update(variants)
            phase12, offset_rows = run_phase12(dev, tmp, phase4)
            by_path.update(phase12)
            by_path["flagship-full"] = run_phase13(tmp)
            fill_row, phase14 = run_phase14(dev, tmp)
            by_path.update(phase14)
            by_path.update(run_phase15(dev))
            by_path["mdbn-cut"] = run_mdbn_path(tmp)
    except Exception:
        traceback.print_exc()
        return 1

    def launches(entry, path):
        return dict(launches=by_path[path][entry], launches_by_path={
            p: counts.get(entry, 0) for p, counts in by_path.items()},
            graph_replays_by_path={p: counts.get("graph_replays", 0)
                                   for p, counts in by_path.items()},
            serving_replays_by_path={p: counts.get("serving_replays", 0)
                                     for p, counts in by_path.items()},
            step_replays_by_path={p: counts.get("step_replays", 0)
                                  for p, counts in by_path.items()})

    kernels = [
        dict(name="half_step_sample", route="cuda",
             source="multimodal_idbn_tpu_torch/csrc/half_step.cu",
             replaces="multimodal_idbn_tpu/ops/pallas_kernels.py:255",
             **launches("half_step_sample", "bimodal-cut"), **hs_main,
             other_shapes=hs_rows[1:] + [pcd_row],
             row_offsets=[r for r in offset_rows
                          if r["shape"].startswith("half_step")]),
        dict(name="clamped_chain", route="cuda",
             source="multimodal_idbn_tpu_torch/csrc/chain.cu",
             replaces="multimodal_idbn_tpu/ops/pallas_chain.py:165",
             **launches("chain_run", "bimodal-cut"),
             **ch_rows["bimodal noisy 30 steps B=128"],
             other_shapes=[r for n, r in ch_rows.items()
                           if n != "bimodal noisy 30 steps B=128"],
             row_offsets=[r for r in offset_rows
                          if r["shape"].startswith("chain")]),
        dict(name="half_step_probs", route="cuda",
             source="multimodal_idbn_tpu_torch/csrc/half_step.cu",
             replaces="multimodal_idbn_tpu/ops/pallas_kernels.py:95",
             **launches("half_step_probs", "resident-drive"),
             **resident["half_step_probs"][-1],
             other_shapes=resident["half_step_probs"][:-1]),
        dict(name="half_step_sample_resident", route="cuda",
             source="multimodal_idbn_tpu_torch/csrc/half_step.cu",
             replaces="multimodal_idbn_tpu/ops/pallas_kernels.py:130",
             **launches("half_step_sample_resident", "resident-drive"),
             **resident["half_step_sample_resident"][-1],
             other_shapes=resident["half_step_sample_resident"][:-1]),
        # JAX's standalone wrapper of kernel 1: no path calls it by this
        # name, so its launches are those of the entry it wraps, counted
        # on the paths as in the first row
        dict(name="half_step_sample_big", route="cuda",
             source="multimodal_idbn_tpu_torch/csrc/half_step.cu",
             replaces="multimodal_idbn_tpu/ops/pallas_kernels.py:311",
             launches_entry="half_step_sample",
             **launches("half_step_sample", "flagship-cut"), **hs_big),
        # no TPU kernel: the JAX package draws these numbers with
        # jax.random (XLA); the fill replaces the torch.Generator draws
        # that a CUDA graph would replay with the captured seeds
        dict(name="philox_fill", route="cuda",
             source="multimodal_idbn_tpu_torch/csrc/philox_fill.cu",
             replaces="none: jax.random in multimodal_idbn_tpu/ops/"
                      "sampling.py:22 (XLA, no Pallas kernel)",
             **launches("philox_fill", "bimodal-cut"), **fill_row),
    ] + mdbn_kernel_rows(mdbn_rows, launches)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def mdbn_kernel_rows(rows, launches) -> list:
    """The kernels-line rows of the multimodal DBN's entries and sampler
    (no TPU kernel: the JAX package has no such units), launches from the
    mdbn-cut drive."""
    return [dict(name=entry, route="cuda",
                 source="multimodal_idbn_tpu_torch/csrc/" + (
                     "rsoftmax.cu" if entry == "rs_sample"
                     else "half_step.cu"),
                 replaces="none: the JAX package has no Gaussian or "
                          "replicated-softmax units",
                 **launches(entry, "mdbn-cut"), **rows[entry][0],
                 other_shapes=rows[entry][1:])
            for entry in ("half_step_gauss", "half_step_linear",
                          "half_step_scaled", "rs_sample")]


def mdbn_main() -> int:
    """``chip_smoke.py --mdbn``: the build, the multimodal DBN's entries
    and sampler against their plain versions, and the mdbn-cut drive;
    prints their kernels-line rows."""
    import torch
    from multimodal_idbn_tpu_torch import resolve_device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        dev = resolve_device("cuda")
        build_kernels()
        rows = check_mdbn_kernels(dev)
        with tempfile.TemporaryDirectory() as tmp:
            by_path = {"mdbn-cut": run_mdbn_path(Path(tmp))}
    except Exception:
        traceback.print_exc()
        return 1

    def launches(entry, path):
        return dict(launches=by_path[path][entry],
                    launches_by_body={k: n for k, n in by_path[path].items()
                                      if k.startswith("body:")})

    print(json.dumps({"kernels": mdbn_kernel_rows(rows, launches)}))
    return 0


def phase14_main() -> int:
    """``chip_smoke.py --phase-14``: the build and phase 14 alone (no
    result line)."""
    import torch
    from multimodal_idbn_tpu_torch import resolve_device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        build_kernels()
        with tempfile.TemporaryDirectory() as tmp:
            run_phase14(resolve_device("cuda"), Path(tmp))
    except Exception:
        traceback.print_exc()
        return 1
    return 0


def serving_main() -> int:
    """``chip_smoke.py --serving``: the build, both cuts (phase 4) and the
    serving phases 6, 6b and 7 alone (no result line)."""
    import torch
    from multimodal_idbn_tpu_torch import resolve_device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        dev = resolve_device("cuda")
        build_kernels()
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            _, flagship = run_path("flagship-cut", tmp)
            _, summary = run_path("bimodal-cut", tmp)
            run_bimodal_serving(dev, summary["model"])
            _, pkl, mean_images = run_serving(dev, flagship["model"], tmp)
            run_generate(pkl, tmp, mean_images)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


def replays_main() -> int:
    """``chip_smoke.py --replays``: the build, both cuts (phase 4), the
    diagnostics alone both ways (phase 10's, on the cuts trained with
    logging), the per-batch drive (phase 12 (a)) and phase 15 (no result
    line)."""
    import torch
    from multimodal_idbn_tpu_torch import cuts, resolve_device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        dev = resolve_device("cuda")
        build_kernels()
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            phase4 = {}
            for name in ("flagship-cut", "bimodal-cut"):
                launches, s = run_path(name, tmp)
                phase4[name] = (launches, {
                    k: s[k] for k in ("image_loss", "mod1_loss", "seconds")
                    if k in s}, state_copy(s["model"]))
                (tmp / f"{name}-logged").mkdir()
                model = cuts.run_logged(name, tmp / f"{name}-logged",
                                        "cuda")["model"]
                time_diagnostics(name, model)
                del model, s
            run_per_batch(tmp, phase4)
            run_phase15(dev)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--replays"]:
        sys.exit(replays_main())
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase-14"]:
        sys.exit(phase14_main())
    if sys.argv[1:2] == ["--serving"]:
        sys.exit(serving_main())
    if sys.argv[1:2] == ["--mdbn"]:
        sys.exit(mdbn_main())
    sys.exit(main())
