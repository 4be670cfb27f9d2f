"""Benchmark of the PyTorch/CUDA port ``multimodal_idbn_tpu_torch``.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell (``workloads`` of
``BENCHMARK.json``) names a configuration (its file under
``portbench/configs/``) and a traffic mix (``portbench/workloads/
<traffic>.json``), whose ``driver`` names the module under
``portbench/drivers/`` that drives it. Set-up builds the program's model
from the seed's inputs and weights and runs its first steps; then
``--trace 0`` measures a window of ``--seconds`` and prints the cell's
end-to-end metrics, ``--trace 1`` profiles a bounded stretch and prints
its per-layer metrics, each read by ``portbench/metrics/<metric>.py``.
Once the window has closed the outputs are compared with the plain
reference under ``portbench/reference/``; the numbers compared and their
limits (``portbench/checks/<workload>.json``) are printed last on
standard error and under ``checks`` in the result, the last line of
standard output.

Exits 2, printing no result, without a CUDA device or with fewer than the
cell asks for, and 3 if JAX, flax or the JAX package was loaded."""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_idbn_tpu")
# caches of compilers a library may start, kept inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".portbench_cache" /
                                              "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / ".portbench_cache" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, trace  # noqa: E402


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(workload: str):
    """(benchmark, cell, configuration, traffic) of ``workload``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "workloads" /
                          f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def cell_metrics(bench: dict, workload: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    out = []
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or workload in e2e.get(
                m["moves"], {}).get("workloads", [workload]):
            out.append(m)
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace_on: bool, *,
        device: str = "cuda", files=None) -> dict:
    """One run of ``workload``; returns the result line as a dict.
    ``files`` (benchmark, cell, configuration, traffic) and ``device``
    let a test drive a small cell on the CPU."""
    bench, cell, cfg, traffic = files or cell_files(workload)
    spans = trace.Spans()
    drivers = load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                          f"portbench_driver_{traffic['driver']}")
    driver = drivers.Driver(cfg, traffic, seed, device, spans)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from multimodal_idbn_tpu_torch.ops import _cuda
        from multimodal_idbn_tpu_torch.ops import chain, half_step  # noqa
        from multimodal_idbn_tpu_torch.ops import philox_fill  # noqa
        _cuda.build_all(_cuda.LIBRARIES)
    driver.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - START
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
              "device": {}}
    metrics = {}
    if trace_on:
        from multimodal_idbn_tpu_torch.ops import graphs
        tr = trace.profile(driver.stretch, driver.span_names(), spans,
                           lambda: {e: n for (_, e), n in
                                    graphs.launch_counts().items()})
        for m in cell_metrics(bench, workload, "per_layer"):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"portbench_metric_{m['name']}")
            value = reader.read(tr, driver)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["attempted"] = tr.units * driver.attempts_per_unit()
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    else:
        out = driver.window(seconds)
        result["attempted"], result["failed"] = out["attempted"], \
            out["failed"]
        for m in cell_metrics(bench, workload, "end_to_end"):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in out["metrics"]:
                metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1 if on_card else 0,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if on_card else 0)}
    if trace_on:
        dev["busy_s"] = tr.busy_us / 1e6
        dev["window_s"] = tr.window_us / 1e6
    driver.free()
    numbers = driver.numbers()
    ok, checks = compare.judge(numbers, compare.limits(workload))
    result.update(correct=ok and result["failed"] == 0, metrics=metrics,
                  device=dev, checks=checks)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _ = cell_files(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"[portbench] {args.workload} needs {cell['chips']} CUDA "
            f"device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    # the host's side of a run on one CPU: runs landed on different
    # CPUs differ by several per cent in host-bound work
    cpu = max(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpu})
    # torch sized its thread pool to the machine's cores before the pin:
    # one CPU, one thread
    torch.set_num_threads(1)
    log(f"[portbench] card: {card()}; host CPU {cpu}")
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"[portbench] loaded in this process: {', '.join(found)}")
        return 3
    log(f"[portbench] {args.workload} seed {args.seed}: correct "
        f"{result['correct']}, attempted {result['attempted']}, failed "
        f"{result['failed']}, memory peak "
        f"{result['device']['memory_peak_bytes']} bytes")
    for name, c in result["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c.get('limit')!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
