"""Readings that the limits of ``checks/<workload>.json`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 12 \
        [--bf16-seeds 3] [--out <file.jsonl>]

For each seed, drawn at random unless ``--seed`` lists them: set-up, the
first steps and a window of ``--window`` seconds of the program as a run
makes them (``program``); then, in the program's place, the reference
computed in TF32 (``tf32``, the control), the reference with each update
on half its rows (``half_batch``) or handing on its state unchanged
(``unchanged``), and for the first ``--bf16-seeds`` seeds the program's
own bfloat16 storage path (``bf16``); each compared with the reference as
a run compares it, and judged against the limits of
``checks/<workload>.json`` as a run judges it (``correct``). One JSON
line per reading, on standard output and in ``--out``."""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, run, trace  # noqa: E402
from portbench.reference.rbm import Arith  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--seed", type=int, nargs="*")
    ap.add_argument("--bf16-seeds", type=int, default=3)
    ap.add_argument("--extra-seeds", type=int, default=None,
                    help="read the controls and faults on the first this "
                         "many seeds only (default: all)")
    ap.add_argument("--kinds", default="tf32,half_batch,unchanged")
    ap.add_argument("--window", type=float, default=10.0,
                    help="seconds of the window before the outputs are "
                         "compared")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    print(f"[calibrate] card: {run.card()}", file=sys.stderr)
    kinds = args.kinds.split(",")
    seeds = args.seed or [random.SystemRandom().randrange(1 << 31, 1 << 32)
                          for _ in range(args.seeds)]
    bench, cell, cfg, traffic = run.cell_files(args.workload)
    drivers = run.load_module(ROOT / "portbench" / "drivers" /
                              f"{traffic['driver']}.py", "calib_driver")
    from multimodal_idbn_tpu_torch.ops import _cuda
    from multimodal_idbn_tpu_torch.ops import chain, half_step  # noqa
    from multimodal_idbn_tpu_torch.ops import philox_fill  # noqa
    _cuda.build_all(_cuda.LIBRARIES)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        d = drivers.Driver(cfg, traffic, seed, "cuda", trace.Spans())
        d.setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        d.window(args.window)
        d.free()
        readings = {"program": d.numbers()}
        if hasattr(d, "phase"):
            ph = d.phase
            ref = ph.fp32_reference()
            for part in ("grads", "change"):
                gaps = compare.leaf_gaps(ph.observed[part], ref[part],
                                         ref[part])
                readings["program"][f"worst_{part}_leaf"] = max(
                    gaps, key=gaps.get)
        extra = args.extra_seeds is None or i < args.extra_seeds
        for kind in kinds if extra else ():
            if kind == "tf32":
                readings[kind] = d.control_numbers(Arith("tf32"))
            elif kind in ("half_batch", "unchanged"):
                readings[kind] = d.control_numbers(Arith(fault=kind))
            elif kind == "bf16" and i < args.bf16_seeds:
                b = drivers.Driver(cfg, traffic, seed, "cuda", trace.Spans(),
                                   dtype="bfloat16")
                b.setup()
                b.free()
                b.phase._ref = d.phase.fp32_reference()
                readings[kind] = b.numbers()
        lims = compare.limits(args.workload)
        for kind, nums in readings.items():
            ok, _ = compare.judge({k: v for k, v in nums.items()
                                   if not isinstance(v, str)}, lims)
            emit(dict(workload=args.workload, seed=seed, kind=kind,
                      correct=ok, numbers=nums,
                      setup_s=setup_s if kind == "program" else None))
        del d, readings
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
