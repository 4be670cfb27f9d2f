"""Where the device time of the port's training paths goes.

Runs each cut of ``multimodal_idbn_tpu_torch.cuts`` (the ones
``chip_smoke.py`` drives: flagship-cut through ``train_multimodal``,
bimodal-cut through ``train_bimodal``; every width and step count kept,
only samples and epochs cut) under ``torch.profiler``, each after one
unprofiled warm-up run, and prints for each:

- device time by kernel name (top 15) and by group: the port's two
  kernel sources, matrix products (cuBLAS), memory copies, everything
  else;
- the device's busy and idle share between the first and the last kernel;
- the number of kernel launches of each group.

Every fused epoch of the cuts is one CUDA graph replay on the card
(``ops.graphs``), so the profile is of the replayed epochs.

    python -m multimodal_idbn_tpu_torch.profile_main_path

Needs a CUDA device; prints one JSON line per cut, the last line holding
all of them.
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

import torch

from multimodal_idbn_tpu_torch import cuts


def _group(name: str) -> str:
    if name.startswith(("Memcpy", "Memset")):
        return "memory copies"
    if "half_step_kernel" in name:
        return "half_step (port kernel)"
    if "chain_kernel" in name:
        return "chain (port kernel)"
    if "philox_fill_kernel" in name:
        return "philox_fill (port kernel)"
    if "gemm" in name.lower() or "gemv" in name.lower():
        return "matrix products (cuBLAS)"
    return "other torch kernels"


def _device_kernels(prof, skip: str = "\0"):
    """(device events, busy µs of their union, µs from first to last),
    leaving out the events whose name holds ``skip``."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.end > e.time_range.start
               and skip not in e.name]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    return kernels, busy, window


def profile_cut(name: str):
    """Profile the second of two runs of the cut ``name``; returns the
    result and the profiled run's summary."""
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as tmp:
        cuts.run_cut(name, Path(tmp))  # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            summary = cuts.run_cut(name, Path(tmp))
    kernels, busy, window = _device_kernels(prof)
    by_name, by_group, n_group = {}, {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        g = _group(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
        n_group[g] = n_group.get(g, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    for kname, us in top:
        print(f"[profile {name}] {us / 1e3:10.3f} ms  {kname[:100]}")
    result = {
        "cut": name,
        "device": torch.cuda.get_device_name(0),
        "phase_seconds": summary["seconds"],
        "kernel_window_ms": window / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / window if window else None,
        "device_ms_by_group": {g: us / 1e3 for g, us in by_group.items()},
        "launches_by_group": n_group,
    }
    print(json.dumps(result))
    return result, summary


def profile_cross_reconstruct(model, batch: int = 128) -> dict:
    """Host wall time against device busy time of one bimodal
    cross-reconstruction (two 50-step sampled conditional Gibbs chains in
    plain torch, then the decodes) of one batch of the trained model."""
    from torch.profiler import ProfilerActivity, profile
    m1, m2 = model.dataloader.materialize()
    z1, z2 = model._latents(m1[:batch], m2[:batch])

    def run():
        model._cross_reconstruct(z1, z2)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels, busy, _ = _device_kernels(prof)
    result = {"cross_reconstruct_wall_ms": wall_ms,
              "cross_reconstruct_device_busy_ms": busy / 1e3,
              "cross_reconstruct_launches": len(kernels),
              "steps": model.cross_steps, "batch": batch}
    print(json.dumps(result))
    return result


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_main_path needs a CUDA device")
    results, models = {}, {}
    for name in cuts.CUTS:
        results[name], summary = profile_cut(name)
        models[name] = summary["model"]
    results["bimodal-cut"].update(
        profile_cross_reconstruct(models["bimodal-cut"]))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
