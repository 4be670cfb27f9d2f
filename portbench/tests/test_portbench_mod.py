"""The modality cells at tiny widths on the CPU: the reference reproduces
the program's CPU path, the faults the calibration reads fail the cells'
limits, a fault planted in the bottom layer of one stack alone fails
them too, and the readers' schedules count what the program launches."""

import contextlib
import copy

import pytest
import torch

from portbench import compare, counts_mdbn, run, trace
from portbench.reference import keys as ref_keys
from portbench.reference import mdbn as ref_mdbn
from portbench.reference.rbm import Arith

TINY = {
    "bimodal-mod-train": dict(
        dataset=dict(n_samples=80, side=8, num_classes=4),
        model=dict(mod1_layers=[64, 24, 20], mod2_layers=[30, 16, 12],
                   joint_hidden=[16, 8]),
        training=dict(cd=3)),
    "mdbn-flickr-mod-train": dict(
        dataset=dict(n_samples=80, num_classes=4),
        model=dict(mod1_layers=[37, 24, 20], mod2_layers=[40, 16, 12],
                   joint_hidden=[16]),
        training=dict(cd=3)),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def files(workload):
    bench, cell, cfg, traffic = copy.deepcopy(run.cell_files(workload))
    for part in ("dataset", "model", "training"):
        cfg[part].update(TINY[workload][part])
    traffic.update(warm_seconds=0.05)
    return bench, cell, cfg, traffic


def driver(workload, seed=11):
    bench, cell, cfg, traffic = files(workload)
    mod = run.load_module(run.HERE / "drivers" / "mod_train.py",
                          "test_mod_driver")
    d = mod.Driver(cfg, traffic, seed, "cpu", trace.Spans())
    d.setup()
    d.free()
    return d


@pytest.mark.parametrize("workload", sorted(TINY))
def test_reference_reproduces_the_program(workload):
    res = run.run(workload, 2 ** 32 + 7, 0.3, False, device="cpu",
                  files=files(workload))
    assert res["correct"], res["checks"]
    assert all(c["value"] <= 1e-6 for c in res["checks"].values())
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_faults_planted_in_the_reference_fail(workload, fault):
    """(The TF32 control flips too few draws at the widths the CPU holds to
    move every leaf: it is read on the card, PERF.md section 2.)"""
    d = driver(workload)
    ok, _ = compare.judge(d.control_numbers(Arith(fault=fault)),
                          compare.limits(workload))
    assert not ok


class _NoiseTwice:
    """``keys`` with the Gaussian draws' σ doubled."""

    def __getattr__(self, name):
        return getattr(ref_keys, name)

    @staticmethod
    def normal_steps(*a, **kw):
        return 2.0 * ref_keys.normal_steps(*a, **kw)


@contextlib.contextmanager
def one_layer_fault(name: str, stack: str, sizes: dict):
    """A fault planted in the reference's layer 0 of ``stack`` alone:
    "noise_sigma_2" draws the Gaussian visible units with σ 2 (the image
    pathway); "word_shift" puts every drawn word on the next word of the
    vocabulary (the tag pathway); "visible_bias_shift" runs a Bernoulli
    layer's chain with its visible bias 2 too high."""
    mp = pytest.MonkeyPatch()
    if name == "noise_sigma_2":
        mp.setattr(ref_mdbn, "keys", _NoiseTwice())
    elif name == "word_shift":
        draw = ref_mdbn.rs_draw

        def shifted_words(logits, words, u):
            counts, mean = draw(logits, words, u)
            return torch.roll(counts, 1, dims=1), mean
        mp.setattr(ref_mdbn, "rs_draw", shifted_words)
    elif name == "visible_bias_shift":
        update, shape = ref_mdbn.cd_update, tuple(sizes[stack][:2])

        def shifted_bias(ar, st, key, data, **kw):
            if tuple(st["w"].shape) != shape:
                return update(ar, st, key, data, **kw)
            new, loss = update(ar, dict(st, vb=st["vb"] + 2.0), key, data,
                               **kw)
            return dict(new, vb=new["vb"] - 2.0), loss
        mp.setattr(ref_mdbn, "cd_update", shifted_bias)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        mp.undo()


ONE_LAYER_FAULTS = {
    "bimodal-mod-train": [("visible_bias_shift", "mod1"),
                          ("visible_bias_shift", "mod2")],
    "mdbn-flickr-mod-train": [("noise_sigma_2", "mod1"),
                              ("word_shift", "mod2")],
}


@pytest.mark.parametrize("workload,fault,stack", [
    (w, f, s) for w, faults in sorted(ONE_LAYER_FAULTS.items())
    for f, s in faults])
def test_a_fault_in_one_stacks_bottom_layer_fails(workload, fault, stack):
    """The quartiles over both stacks' leaves pass over a fault that moves
    a few leaves of one stack; that stack's layer-0 number reads it."""
    d = driver(workload)
    d.phase.fp32_reference()
    d.phase.fp32_step()
    with one_layer_fault(fault, stack, d.phase.sizes):
        nums = d.control_numbers(Arith())
    lims = compare.limits(workload)
    ok, _ = compare.judge(nums, lims)
    assert not ok
    key = f"step_layer0_diff.{stack}"
    assert nums[key] > lims[key]
    other = {"mod1": "mod2", "mod2": "mod1"}[stack]
    assert nums[f"step_layer0_diff.{other}"] == 0.0


@pytest.mark.parametrize("workload", sorted(TINY))
def test_schedule_counts_what_the_program_launches(workload, monkeypatch):
    """Every half-step and word draw of a step, by entry and body, as the
    program's wrappers would launch them on the card (counted here on the
    plain path by the wrappers' dispatch)."""
    from multimodal_idbn_tpu_torch.ops import half_step, rsoftmax
    seen = {}

    def count(entry, B, K, N):
        seen[entry] = seen.get(entry, 0) + 1
        body = f"body:{half_step.plan(B, K, N)[0]}"
        seen[body] = seen.get(body, 0) + 1

    def wrap(fn, entry, transpose):
        def inner(x, w, *a, **kw):
            N = w.shape[0] if transpose else w.shape[1]
            count(entry, x.shape[0], x.shape[1], N)
            return fn(x, w, *a, **kw)
        return inner

    from multimodal_idbn_tpu_torch.ops import fast_cd
    for name, entry, tr in (("half_step_gauss", "half_step_gauss", True),
                            ("half_step_linear", "half_step_linear", True),
                            ("half_step_scaled", "half_step_scaled", False)):
        monkeypatch.setattr(fast_cd, name,
                            wrap(getattr(fast_cd, name), entry, tr))
    plain = fast_cd.half_step_sample

    def sample(x, w, b, seed, T=1.0, *, transpose_w=False, **kw):
        N = w.shape[0] if transpose_w else w.shape[1]
        count("half_step_sample", x.shape[0], x.shape[1], N)
        return plain(x, w, b, seed, T, transpose_w=transpose_w, **kw)

    monkeypatch.setattr(fast_cd, "half_step_sample", sample)
    draw = rsoftmax.rs_sample

    def rs(logits, words, seed, **kw):
        seen["rs_sample"] = seen.get("rs_sample", 0) + 1
        return draw(logits, words, seed, **kw)

    monkeypatch.setattr(rsoftmax, "rs_sample", rs)
    bench, cell, cfg, traffic = files(workload)
    mod = run.load_module(run.HERE / "drivers" / "mod_train.py",
                          "test_mod_driver")
    d = mod.Driver(cfg, traffic, 3, "cpu", trace.Spans())
    d.phase.setup()
    seen.clear()
    d.phase.step(d.phase.next_step)
    half, words = d.phase.launch_schedule()
    want = counts_mdbn.expected_launches(half, words)
    assert {k: v for k, v in want.items() if v} == seen
