"""Every cell of BENCHMARK.json finds its files by name, and the file
keeps to the benchmark's contract."""

import json
import re

import pytest

from portbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    bench, cell, cfg, traffic = run.cell_files(workload)
    assert (run.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (run.HERE / "checks" / f"{workload}.json").is_file()
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert conf["file"].startswith("portbench/")
    assert cfg["name"] == cell["config"]
    for m in run.cell_metrics(bench, workload, "per_layer"):
        assert (run.HERE / "metrics" / f"{m['name']}.py").is_file()
    e2e = [m["name"] for m in run.cell_metrics(bench, workload,
                                               "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(bench, workload, "per_layer")


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_no_card_no_result(capsys, monkeypatch):
    """Without a CUDA device a run exits 2 and prints no result."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
