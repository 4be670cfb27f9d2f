"""The output check at tiny widths on the CPU: the reference reproduces
the program's CPU path, and a run whose timed path is broken underneath
comes out not correct, for each fault the cell can have."""

import pytest
import torch

from portbench.reference.rbm import Arith
from portbench.tests import tiny

TRAIN = ("flagship-image-train", "bimodal-joint-train",
         "flagship-joint-train")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", sorted(tiny.TINY))
def test_reference_reproduces_the_program(workload):
    res = tiny.run_cpu(workload)
    assert res["correct"], res["checks"]
    # the same draws and, on the CPU, the same products: no gap beyond
    # the order of a sum of losses
    assert all(c["value"] <= 1e-6 for c in res["checks"].values())


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_its_state_unchanged(workload, monkeypatch):
    from multimodal_idbn_tpu_torch.ops import graphs
    step = graphs.EpochRunner.__call__

    def unchanged(self, state, *a, **kw):
        return state, step(self, state, *a, **kw)[1]

    monkeypatch.setattr(graphs.EpochRunner, "__call__", unchanged)
    assert not tiny.run_cpu(workload)["correct"]


def _halved(fn, *names):
    def half(state, key, *args, **kw):
        args = list(args)
        for i in range(len(names)):
            args[i] = args[i][: max(1, args[i].shape[0] // 2)]
        return fn(state, key, *args, **kw)
    return half


def test_half_the_batch_left_out_image(monkeypatch):
    from multimodal_idbn_tpu_torch.ops import fast_cd
    monkeypatch.setattr(fast_cd, "fast_sampled_cd_update",
                        _halved(fast_cd.fast_sampled_cd_update, "data"))
    assert not tiny.run_cpu("flagship-image-train")["correct"]


def test_half_the_batch_left_out_bimodal(monkeypatch):
    from multimodal_idbn_tpu_torch.ops import rbm_ops
    monkeypatch.setattr(rbm_ops, "cd_update",
                        _halved(rbm_ops.cd_update, "data"))
    assert not tiny.run_cpu("bimodal-joint-train")["correct"]


@pytest.mark.parametrize("call", ["cross_reconstruct", "sample_txt2img"])
def test_an_answer_altered_where_it_is_produced(call, monkeypatch):
    from multimodal_idbn_tpu_torch.ops import imdbn_ops
    fn = getattr(imdbn_ops, call)

    def altered(*a, **kw):
        out = list(fn(*a, **kw))
        i = 1 if out[0] is None else 0
        out[i] = out[i] + 0.01
        return tuple(out)

    monkeypatch.setattr(imdbn_ops, call, altered)
    assert not tiny.run_cpu("flagship-serve")["correct"]


@pytest.mark.parametrize("workload, fault", [
    ("flagship-image-train", "half_batch"),
    ("flagship-image-train", "unchanged"),
    ("bimodal-joint-train", "half_batch"),
    ("bimodal-joint-train", "unchanged"),
    ("flagship-joint-train", "unchanged")])
def test_faults_planted_in_the_reference(workload, fault):
    """The faults the calibration reads on the card, planted in the
    reference put in the program's place, fail the cell's limits."""
    from portbench import compare, run, trace
    bench, cell, cfg, traffic = tiny.files(workload)
    drivers = run.load_module(run.HERE / "drivers" / "train.py",
                              "test_train_driver")
    d = drivers.Driver(cfg, traffic, 11, "cpu", trace.Spans())
    d.setup()
    d.free()
    ok, _ = compare.judge(d.control_numbers(Arith(fault=fault)),
                          compare.limits(workload))
    assert not ok


def test_the_tf32_control_of_the_bimodal_joint():
    """The reference computed in TF32 in the program's place is not
    correct at the cell's limits: its one batch step from one state sees
    it at tiny widths too. (The image cell's control flips too few draws
    at widths the CPU holds to fail on every seed, and the flagship
    joint's fails its ``metric_gap`` at the cell's size only: both are
    read on the card, below.)"""
    from portbench import compare, run, trace
    bench, cell, cfg, traffic = tiny.files("bimodal-joint-train")
    drivers = run.load_module(run.HERE / "drivers" / "train.py",
                              "test_train_driver")
    d = drivers.Driver(cfg, traffic, 17, "cpu", trace.Spans())
    d.setup()
    d.free()
    ok, _ = compare.judge(d.control_numbers(Arith("tf32")),
                          compare.limits("bimodal-joint-train"))
    assert not ok


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAIN)
def test_the_tf32_control_at_the_cells_size(card, workload):
    """On the card at the cell's own size, on three seeds: the program is
    correct and the reference computed in TF32 in its place is not."""
    from portbench import compare, run, trace
    bench, cell, cfg, traffic = run.cell_files(workload)
    drivers = run.load_module(run.HERE / "drivers" / "train.py",
                              "test_card_driver")
    lims = compare.limits(workload)
    for seed in (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3):
        d = drivers.Driver(cfg, traffic, seed, card, trace.Spans())
        d.setup()
        d.window(1.0)
        d.free()
        assert compare.judge(d.numbers(), lims)[0]
        assert not compare.judge(d.control_numbers(Arith("tf32")), lims)[0]


def test_the_tf32_control_of_serving():
    """The reference computed in TF32 in the program's place is not
    correct at the cell's limits."""
    from portbench import compare, run, trace
    bench, cell, cfg, traffic = tiny.files("flagship-serve")
    drivers = run.load_module(run.HERE / "drivers" / "serve.py",
                              "test_serve_driver")
    d = drivers.Driver(cfg, traffic, 13, "cpu", trace.Spans())
    d.setup()
    d.window(0.3)
    d.free()
    ok, _ = compare.judge(d.numbers(), compare.limits("flagship-serve"))
    assert ok
    ok, _ = compare.judge(d.control_numbers(Arith("tf32")),
                          compare.limits("flagship-serve"))
    assert not ok
