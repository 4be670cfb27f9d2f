"""Tracing and performance instrumentation.

Port of multimodal_idbn_tpu/utils/profiling.py:26-153:

- :func:`trace` — a ``torch.profiler`` context around any training or
  inference region that writes a Chrome trace (view in Perfetto or
  ``chrome://tracing``);
- :class:`StepTimer` — wall-clock step statistics with steps/sec and
  optional run-object logging under ``perf/*`` keys; given a CUDA device
  it synchronises before each clock read, so a step covers the device
  work it enqueued;
- :func:`measure_gibbs_steps_per_sec` — clamped mean-field chain steps per
  second at the flagship joint RBM's shape, through the port's
  ``conditional_gibbs`` (the chain kernel on the card), each timed call
  one replay of a graph captured by the untimed warm-up call, as JAX
  times its jitted chain (:134);
- :func:`span` — a named range of the host's work between the device's
  replays (the spans of ``SPAN_NAMES``), recorded only while a
  ``torch.profiler`` session runs, on the clock of its kernel records.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from multimodal_idbn_tpu_torch.device import (DeviceLike, resolve_device,
                                              synchronize)

# Every span the port opens, each on host code outside any captured body:
# the epoch runner's steps (ops/graphs.py:EpochRunner), the host reads of
# an epoch's outputs (the models' per-epoch entries), the preparation of a
# serving call's arguments (the models' serving methods) and the serving
# cache's steps (ops/graphs.py:ServingGraphs).
SPAN_NAMES = (
    "runner.permutation", "runner.keys", "runner.load", "runner.capture",
    "runner.replay", "epoch.read",
    "serve.inputs", "serve.load", "serve.keys", "serve.capture",
    "serve.replay",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming the host's work inside it ``name`` (one of
    ``SPAN_NAMES``) in a running ``torch.profiler`` session; nothing
    otherwise (one C call and a shared null context, about 1 µs).

    The range is an operator range of the profiler (``_RecordFunctionFast``
    scope ``FUNCTION``): it has the clock of the session's CUDA kernel
    records, so an idle gap of the device can be put down to the span the
    host was in, and it makes no device-side annotation, which
    ``record_function`` adds to the device's timeline and a reader that
    takes every device event for a kernel would count as device work. It
    also costs about 2 µs where ``record_function`` costs about 13 µs
    (H100 host, profiler on)."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str = "torch_trace", enabled: bool = True):
    """``torch.profiler`` over the body, its Chrome trace written to
    ``{log_dir}/trace-{pid}-{ns}.json`` (no-op when disabled). CUDA
    activity is recorded where a GPU is present.

    Only profiler start/stop failures are swallowed: an exception raised
    by the traced body propagates unchanged."""
    if not enabled:
        yield
        return
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
            except Exception:
                pass


class StepTimer:
    """Wall-clock step timing with steps/sec statistics.

    Usage::

        timer = StepTimer(device)
        for epoch in range(E):
            with timer.step():
                ... one epoch / step ...
        timer.log_to(wandb_run, prefix="perf/epoch")
    """

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.durations: list = []

    @contextlib.contextmanager
    def step(self, n: int = 1):
        """Time a region covering ``n`` logical steps; the elapsed time is
        recorded amortized (``n`` equal entries)."""
        n = max(1, int(n))
        synchronize(self.device)
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        dt = (time.perf_counter() - t0) / n
        self.durations.extend([dt] * n)

    @property
    def count(self) -> int:
        return len(self.durations)

    def mean(self) -> float:
        return float(np.mean(self.durations)) if self.durations else 0.0

    def p50(self) -> float:
        return (float(np.percentile(self.durations, 50))
                if self.durations else 0.0)

    def steps_per_sec(self) -> float:
        total = float(np.sum(self.durations))
        return self.count / total if total > 0 else 0.0

    def last(self) -> float:
        return self.durations[-1] if self.durations else 0.0

    def log_to(self, run, prefix: str = "perf/step",
               epoch: Optional[int] = None) -> None:
        if run is None or not self.durations:
            return
        payload = {
            f"{prefix}_seconds": self.last(),
            f"{prefix}_mean_seconds": self.mean(),
            f"{prefix}s_per_sec": self.steps_per_sec(),
        }
        if epoch is not None:
            payload["epoch"] = epoch
        run.log(payload)


def measure_gibbs_steps_per_sec(num_visible: int = 532,
                                num_hidden: int = 500,
                                batch_size: int = 128,
                                n_steps: int = 500,
                                groups=((500, 532),),
                                seed: int = 0,
                                warmup: bool = True,
                                device: DeviceLike = None) -> dict:
    """Clamped mean-field chain throughput with all state on the device
    (defaults = the flagship joint RBM: 500+32 visibles, softmax label
    group; the z block clamped). One ``conditional_gibbs`` call is one
    chain-kernel launch on the card, in one graph replay; the time is the
    median of three synchronised calls on the host clock.

    Returns {"chain_steps_per_sec", "cell_updates_per_sec", "elapsed_s"}
    where a chain step is one full v→h→v mean-field iteration over the
    whole batch.
    """
    from multimodal_idbn_tpu_torch.ops import rbm_ops, rng

    dev = resolve_device(device)
    state = rbm_ops.init_rbm_state(rng.fold_in(seed, 0), num_visible,
                                   num_hidden, device=dev)
    Dz = groups[0][0] if groups else num_visible
    v_known = torch.zeros((batch_size, num_visible), device=dev)
    km = torch.zeros((batch_size, num_visible), device=dev)
    km[:, :Dz] = 1.0
    groups = tuple(tuple(g) for g in groups)

    from multimodal_idbn_tpu_torch.ops import graphs
    owner = graphs.Owner()           # its graph goes with this call

    def run(key):
        return graphs.serve(owner, dev, rbm_ops.conditional_gibbs, key,
                            state, v_known=v_known, known_mask=km,
                            n_steps=n_steps, sample_h=False, sample_v=False,
                            groups=groups)

    if warmup:
        run(rng.fold_in(seed, 1))
        synchronize(dev)
    times = []
    for rep in range(2, 5):
        t0 = time.perf_counter()
        run(rng.fold_in(seed, rep))
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    elapsed = float(np.median(times))
    return {
        "chain_steps_per_sec": n_steps / elapsed,
        "cell_updates_per_sec": n_steps * batch_size * (num_visible
                                                        + num_hidden)
        / elapsed,
        "elapsed_s": elapsed,
    }
