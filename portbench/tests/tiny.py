"""Cells of ``BENCHMARK.json`` at tiny widths, for runs on the CPU."""

from __future__ import annotations

import copy

from portbench import run

TINY = {
    "flagship-image-train": dict(
        dataset=dict(n_samples=80, side=8, num_classes=4),
        model=dict(image_layers=[64, 32, 16]), training=dict(cd=3)),
    "flagship-serve": dict(
        dataset=dict(n_samples=80, side=8, num_classes=4),
        model=dict(image_layers=[64, 32, 16], joint_hidden=8,
                   num_labels=4),
        training=dict(cross_gibbs_steps=5), traffic=dict(batch=6)),
    "flagship-joint-train": dict(
        dataset=dict(n_samples=80, side=8, num_classes=4),
        model=dict(image_layers=[64, 32, 16], joint_hidden=8,
                   num_labels=4),
        training=dict(cross_gibbs_steps=4, JOINT_AUX_COND_STEPS=10,
                      joint_cd=2)),
    "bimodal-joint-train": dict(
        dataset=dict(n_samples=80, side=8, num_classes=4),
        model=dict(mod1_layers=[64, 24, 20], mod2_layers=[30, 16, 12],
                   joint_hidden=[16, 8], num_labels=4),
        training=dict(cross_gibbs_steps=4, JOINT_AUX_COND_STEPS=10,
                      joint_cd=2),
        traffic=dict(warmup_epochs=2)),
}


def files(workload: str):
    """(benchmark, cell, configuration, traffic) of ``workload`` with its
    widths and counts cut to ``TINY``'s."""
    bench, cell, cfg, traffic = copy.deepcopy(run.cell_files(workload))
    cut = TINY[workload]
    for part in ("dataset", "model", "training"):
        cfg[part].update(cut.get(part, {}))
    traffic.update(cut.get("traffic", {}), warm_seconds=0.05)
    return bench, cell, cfg, traffic


def run_cpu(workload: str, seed: int = 2 ** 32 + 7,
            seconds: float = 0.3) -> dict:
    return run.run(workload, seed, seconds, False, device="cpu",
                   files=files(workload))
