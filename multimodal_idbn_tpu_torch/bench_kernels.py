"""Tiling sweep of the two CUDA kernels on one NVIDIA GPU.

    python -m multimodal_idbn_tpu_torch.bench_kernels [--quick | --public]

For every half-step shape of the two training paths it holds the kernel
against its plain version, then times it under the tiling
``half_step.plan`` chooses and under a grid of other tilings (both
kernel bodies where the wgmma body takes the shape, block tile rows x
k-slices), beside ``addmm`` + ``sigmoid``. ``ms`` is device time
(the calls replayed from a CUDA graph), ``call_ms`` the time of
back-to-back calls through the Python wrapper, which the host bounds at
small shapes. For the chain it times the shapes of both joints under each
tile and each cap on the grid. One JSON line per measurement, then the
card's name and power limit. The choices in ``half_step.plan`` and
``csrc/chain.cu`` (``make_plan``) were made from this script's output;
``--quick`` checks and times the chosen tilings only. ``--public`` times
the public wrappers alone (device time, back-to-back calls, and the host's
time to enqueue one call), so the same file can time another checkout of
the package: ``PYTHONPATH=<checkout> python <this file> --public``.

No JAX counterpart: the TPU kernels' block sizes were fixed by VMEM.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import torch

from multimodal_idbn_tpu_torch import resolve_device
from multimodal_idbn_tpu_torch.ops import _cuda, chain, half_step, rbm_ops

HALF_STEP_SHAPES = {  # name: (B, K, N, transpose_w, input density)
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
    "joint L0 v->h": (128, 2500, 1500, False, 0.5),
    "flagship L1 v->h B=12": (12, 10000, 1500, False, 0.15),
}
CHAIN_SHAPES = {  # name: (B, V, H, n_steps, one 32-wide group, mu, final)
    "bimodal joint 30 noisy B=128": (128, 2500, 1500, 30, False, False, False),
    "bimodal joint 30 noisy B=12": (12, 2500, 1500, 30, False, False, False),
    "flagship joint 50 noisy + mu": (128, 532, 500, 50, True, True, False),
    "flagship joint 50 mean-field + final": (128, 532, 500, 50, True, False,
                                             True),
}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed, so no host time between launches is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=3, warmup=1) / iters


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def candidate_tilings(B: int, K: int, N: int):
    """``half_step.plan`` tuples to time: the mma_sync body at both row
    tiles and, where it takes the shape, the wgmma body, each over a range
    of k-slices of at most 1024 terms."""
    bodies = [("mma_sync", 16, rows) for rows in (32, 64)
              if not (rows > 32 and B <= 32)]
    if half_step.plan(B, K, N)[0] == "wgmma":
        bodies.append(("wgmma", 32, half_step.plan(B, K, N)[1]))
    for body, k_tile, rows in bodies:
        k_tiles = -(-K // k_tile)
        for slices in (1, 2, 3, 4, 6, 8, 11, 16, 24, 32, 48):
            per = -(-k_tiles // slices)
            if per * k_tile > 1024:
                continue
            if slices > k_tiles:
                break
            yield body, rows, -(-k_tiles // per), per * k_tile


def half_step_launch(x, w, b, transpose: bool, tiling=None):
    """(probs, sample) of ``half_step_sample(x, w, b, 7, transpose_w=
    transpose)`` under ``tiling`` (None: ``half_step.plan``'s), through
    the launch the public wrapper takes."""
    return half_step._sampled_launch(
        "half_step_sample", x, w, b, 7, 1.0, transpose, 0, 0, None,
        head=(int(transpose),), tiling=tiling)


def bench_half_step(dev, quick: bool) -> None:
    g = torch.Generator().manual_seed(0)
    for name, (B, K, N, transpose, density) in HALF_STEP_SHAPES.items():
        V, H = (N, K) if transpose else (K, N)
        w = (torch.randn((V, H), generator=g) / V ** 0.5).to(dev)
        b = (0.1 * torch.randn((N,), generator=g)).to(dev)
        x = (torch.rand((B, K), generator=g) < density).float().to(dev)
        p_p, _ = half_step.half_step_plain(x, w, b, 7, transpose_w=transpose)
        run = functools.partial(half_step_launch, x, w, b, transpose)
        wm = w.T if transpose else w
        lib_ms = graph_ms(lambda: torch.sigmoid(torch.addmm(b, x, wm)))
        chosen = half_step.plan(B, K, N)
        tilings = [chosen] if quick else sorted(
            {chosen, *candidate_tilings(B, K, N)})
        for tiling in tilings:
            probs = run(tiling)[0]
            torch.cuda.synchronize()
            err = float((probs - p_p).abs().max())
            emit(kernel="half_step", shape=name, tiling=list(tiling),
                 chosen=tiling == chosen, max_abs_err=err,
                 ms=graph_ms(lambda: run(tiling)),
                 call_ms=time_ms(lambda: run(tiling)), library_ms=lib_ms)


def chain_case(dev, B, V, H, n, group, mu, final):
    """(positional, keyword) arguments of ``clamped_chain`` for one row of
    CHAIN_SHAPES, the schedule already on the device."""
    g = torch.Generator().manual_seed(1)
    w = (torch.randn((V, H), generator=g) / V ** 0.5).to(dev)
    hb = (0.1 * torch.randn((H,), generator=g)).to(dev)
    vb = (0.1 * torch.randn((V,), generator=g)).to(dev)
    vk = torch.rand((B, V), generator=g).to(dev)
    km = torch.zeros((B, V), device=dev)
    km[:, :V - 32 if group else 1500] = 1.0
    v0 = vk * km + (1 - km) * torch.rand((B, V), generator=g).to(dev)
    sched = (torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1) if final else
             rbm_ops.annealed_schedule(n, 3.0, 1.0, 0.9, 2, 0.9, 0.15)
             ).to(dev)
    kw = dict(groups=((V - 32, V),) if group else (),
              mu=torch.rand((B, V - 32), generator=g).to(dev) if mu else None,
              seed=None if final else 0xFACE, final_unclamped=final)
    return (w, hb, vb, v0, vk, km, sched), kw


def bench_chain(dev, quick: bool) -> None:
    for name, (B, V, H, n, group, mu, final) in CHAIN_SHAPES.items():
        args, kw = chain_case(dev, B, V, H, n, group, mu, final)
        out_p = chain.chain_plain(*args, **kw)
        launch_args = (*args, kw["groups"], kw["mu"], kw["seed"], final)
        tilings = [(0, 0)] if quick else [(0, 0)] + [
            (rows, cap) for rows in (32, 64, 128)
            for cap in (33, 66, 132, 264, 396, 528)
            if not (rows > 32 and B <= 32)]
        for rows, cap in tilings:
            over = dict(tile_rows=rows, max_grid=cap)
            out_k = chain._launch(*launch_args, **over)
            torch.cuda.synchronize()
            emit(kernel="chain", shape=name, tile_rows=rows,
                 max_grid=cap, plan=chain.plan(B, V, H, n, final, **over),
                 max_abs_err=float((out_k - out_p).abs().max()),
                 ms=time_ms(lambda: chain._launch(*launch_args, **over),
                            iters=5, warmup=1))


def host_us(fn, iters: int = 300) -> float:
    """Host time to enqueue one call, in microseconds (the device's time
    instead, where the kernel is the slower of the two)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def bench_public(dev) -> None:
    """The public wrappers at the shapes of both paths."""
    g = torch.Generator().manual_seed(0)
    for name, (B, K, N, transpose, density) in HALF_STEP_SHAPES.items():
        V, H = (N, K) if transpose else (K, N)
        w = (torch.randn((V, H), generator=g) / V ** 0.5).to(dev)
        b = (0.1 * torch.randn((N,), generator=g)).to(dev)
        x = (torch.rand((B, K), generator=g) < density).float().to(dev)
        runs = {"half_step_sample": lambda: half_step.half_step_sample(
            x, w, b, 7, transpose_w=transpose)}
        if not transpose:
            runs["half_step_probs"] = lambda: half_step.half_step_probs(
                x, w, b)
            runs["half_step_sample_resident"] = lambda: \
                half_step.half_step_sample_resident(x, w, b, 7)
        wm = w.T if transpose else w
        runs["addmm+sigmoid"] = lambda: torch.sigmoid(torch.addmm(b, x, wm))
        for entry, run in runs.items():
            emit(kernel=entry, shape=name, ms=graph_ms(run),
                 call_ms=time_ms(run, iters=200), host_us=host_us(run))
    for name, (B, V, H, n, group, mu, final) in CHAIN_SHAPES.items():
        args, kw = chain_case(dev, B, V, H, n, group, mu, final)

        def run():
            return chain.clamped_chain(*args, **kw)

        emit(kernel="clamped_chain", shape=name,
             call_ms=time_ms(run, iters=10, warmup=2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the chosen tilings only")
    ap.add_argument("--public", action="store_true",
                    help="the public wrappers only")
    ap.add_argument("--only", choices=("half_step", "chain"), default=None)
    args = ap.parse_args()
    dev = resolve_device("cuda")
    libs = [half_step.KERNEL, chain.KERNEL]
    _cuda.build_all(libs)
    for lib in libs:
        for line in lib.log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {lib.source.name}: {line.strip()}")
    if args.public:
        bench_public(dev)
    else:
        if args.only != "chain":
            bench_half_step(dev, args.quick)
        if args.only != "half_step":
            bench_chain(dev, args.quick)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
