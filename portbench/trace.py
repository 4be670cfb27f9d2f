"""Spans of the benchmark's own calls into the program, and the reduction
of a ``torch.profiler`` trace of a bounded stretch to device time.

The arithmetic of device-kernel intervals is copied from the port's
``profile_main_path._device_kernels``: busy time is the union of the
intervals of the device's kernels, idle the rest of the stretch."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


class Spans:
    """Host spans around the calls into the program. Kept in memory; in a
    traced stretch each span is also a ``record_function`` range, so the
    trace can say what the host was doing during an idle gap."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))


@dataclass
class Trace:
    """A profiled stretch: ``kernels`` (name, start µs, end µs), the
    stretch's own range in the trace's clock, the spans met in it, the
    kernel launches the program counted (entry → launches), the units of
    work it ran (epochs or requests) and its host seconds."""

    kernels: List[Tuple[str, float, float]]
    start_us: float
    end_us: float
    spans: List[Tuple[str, float, float]]
    launches: Dict[str, int]
    units: int
    wall_s: float
    extra: dict = field(default_factory=dict)

    @property
    def window_us(self) -> float:
        return self.end_us - self.start_us

    def merged(self) -> List[Tuple[float, float]]:
        """The union of the kernels' intervals inside the stretch."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.start_us), min(e, self.end_us)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.merged())

    def kernel_us(self, *needles: str, exclude: Tuple[str, ...] = ()
                  ) -> Tuple[float, int]:
        """(summed µs, count) of the kernels whose name holds one of
        ``needles`` (every kernel when none) and none of ``exclude``."""
        us, n = 0.0, 0
        for name, s, e in self.kernels:
            if needles and not any(x in name for x in needles):
                continue
            if any(x in name for x in exclude):
                continue
            us += e - s
            n += 1
        return us, n

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, us / 1e6] for name, us in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest idle gaps of the device in the stretch, each
        named by the innermost span the host was in when it began."""
        gaps, cur = [], self.start_us
        for s, e in self.merged():
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.end_us > cur:
            gaps.append((cur, self.end_us))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for g0, g1 in gaps[:k]:
            inner = [sp for sp in self.spans if sp[1] <= g0 < sp[2]]
            name = min(inner, key=lambda sp: sp[2] - sp[1])[0] \
                if inner else "harness"
            out.append([name, (g1 - g0) / 1e6])
        return out


def profile(stretch, span_names: Tuple[str, ...], spans: Spans,
            launch_counts) -> Trace:
    """Run ``stretch()`` (returns the units of work it ran) under the
    profiler and reduce it. ``launch_counts()`` reads the program's
    launch counters, entry → launches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile
    before = launch_counts()
    spans.traced = True
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("portbench.stretch"):
            t0 = time.perf_counter()
            units = stretch()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    spans.traced = False
    after = launch_counts()
    kernels, marks = [], []
    start = end = None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a record_function range also appears on the device's
            # timeline (an annotation, not an operation)
            if t > s and e.name not in span_names \
                    and e.name != "portbench.stretch":
                kernels.append((e.name, s, t))
        elif e.name == "portbench.stretch":
            start, end = s, t
        elif e.name in span_names:
            marks.append((e.name, s, t))
    if start is None:
        raise RuntimeError("the profiler recorded no stretch range")
    return Trace(kernels=kernels, start_us=start, end_us=end, spans=marks,
                 launches={k: after.get(k, 0) - before.get(k, 0)
                           for k in after},
                 units=units, wall_s=wall)
