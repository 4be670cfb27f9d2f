"""The port's host spans (``utils.profiling.span``) and its key counter
(``graphs.STATS["keys"]``), on the CPU.

- (a) with the profiler off a span opens no range;
- (b) under ``torch.profiler`` (CPU activity) a graphed epoch runner and
  the serving cache, with the CUDA calls replaced by stand-ins, record
  their spans in order: per epoch ``runner.permutation``, ``runner.keys``,
  ``runner.load``, ``runner.replay`` (``runner.capture`` at the first),
  per call ``serve.load``, ``serve.replay`` and inside it ``serve.keys``
  (``serve.capture`` once per signature); the models' serving methods
  wrap their preparation in ``serve.inputs`` and their per-epoch entries
  the host reads in ``epoch.read``; no span opens while a body runs;
- (b2) a runner given the next epoch's key draws that epoch's permutation
  and key table after this epoch's replay, and loads each epoch's own
  keys whether or not the hint was right;
- (c) ``STATS["keys"]`` counts the key table's length at every replay;
- (d) outputs, states and launch counts are bit-equal with the profiler
  on and off;
- (e) every name the package passes to ``span`` is in ``SPAN_NAMES``.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import multimodal_idbn_tpu_torch
from multimodal_idbn_tpu_torch.ops import graphs, rng
from multimodal_idbn_tpu_torch.utils import profiling

from torch_parity import graph_stand_ins, small_bimodal, small_imdbn

SPANS = set(profiling.SPAN_NAMES)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stand_ins(monkeypatch):
    """The stand-in CUDA calls of ``torch_parity.graph_stand_ins``, with
    every body (a runner's, a serving call's, a capture block) counted
    while it runs and every span refused while one does."""
    lib, cache = graph_stand_ins(monkeypatch)
    inside = [0]

    @contextlib.contextmanager
    def body_block(*a, **k):
        inside[0] += 1
        try:
            yield
        finally:
            inside[0] -= 1

    def counted(real):
        def run(*a, **k):
            with body_block():
                return real(*a, **k)
        return run

    monkeypatch.setattr(torch.cuda, "graph", body_block)
    monkeypatch.setattr(graphs.EpochRunner, "_run_static",
                        counted(graphs.EpochRunner._run_static))
    monkeypatch.setattr(graphs.ServingGraphs, "_run",
                        counted(graphs.ServingGraphs._run))
    real_range = torch._C._profiler._RecordFunctionFast

    def checked_range(name, *a, **k):
        assert not inside[0], f"span {name} opened inside a captured body"
        return real_range(name, *a, **k)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        checked_range)
    graphs.reset_stats()
    yield lib, cache
    graphs.reset_stats()


def _profiled(fn):
    """(what ``fn()`` returns, the names of the spans recorded, in the
    order they opened)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e for e in prof.events() if e.name in SPANS),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    return out, [e.name for e in events], events


# -- the runner and the serving cache, at a small size ---------------------

def _runner(lib):
    def body(consts, state, perm, lr, mom):
        lib.launches_by_entry["k"] += 3
        u = rng.uniform(rng.fold_in(rng.Key(), 1), (2, 2), "cpu")
        b = (rng.uniform(rng.fold_in(rng.Key(), 2), (2, 2), "cpu")
             < u).float()
        return state + lr * u - mom * b, (state.sum(), perm.sum())

    runner = graphs.EpochRunner("fake", body, (), {}, n_rows=4,
                                device="cpu", graphed=False)
    runner.graphed = True
    return runner


def _epochs(lib, n=3, hint=None, runners=None):
    """``n`` epochs of the stand-in runner (appended to ``runners``);
    ``hint`` names the next key each call passes: None, "next" (the next
    epoch's) or "other" (a key no epoch runs). Returns (state, outputs)."""
    runner = _runner(lib)
    if runners is not None:
        runners.append(runner)
    state, outs = torch.zeros(2, 2), []
    for e in range(n):
        nxt = {None: None, "next": rng.fold_in(1, e + 1),
               "other": rng.fold_in(2, e)}[hint]
        state, out = runner(state, rng.fold_in(1, e), 0.1, 0.5, next_key=nxt)
        outs.append(out)
        assert torch.equal(runner._perm, rng.permutation(rng.fold_in(1, e),
                                                         4))
        assert runner._keys.tolist() == rng.key_values(rng.fold_in(1, e),
                                                       runner._paths)
    return state, outs


def _body(lib):
    def body(w, x, *, key, scale):
        lib.launches_by_entry["k"] += 2
        u = rng.uniform(rng.fold_in(key, 1), (len(x), w.shape[1]), "cpu")
        b = (rng.uniform(rng.fold_in(key, 2), u.shape, "cpu") < u).float()
        return (x @ w) * scale + u - b

    def step(state, x, *, key, scale):
        lib.launches_by_entry["k"] += 1
        u = rng.uniform(rng.fold_in(key, 1), state.shape, "cpu")
        b = (rng.uniform(rng.fold_in(key, 2), u.shape, "cpu") < u).float()
        return state + scale * u - b, (x.sum() + state.sum(),)
    return body, step


def _calls(lib, cache, kind):
    """Three calls: two at one signature, one at another."""
    body, step = _body(lib)
    w, state, outs = torch.ones(3, 2), torch.zeros(3, 2), []
    for i, rows in enumerate((4, 4, 2)):
        x = torch.ones(rows, 3)
        if kind == "call":
            outs.append(cache.call(body, rng.fold_in(5, i), w, x, scale=2.0))
        else:
            state, out = cache.update(step, rng.fold_in(5, i), state, x,
                                      scale=2.0)
            outs.append((state.clone(), out))
    return outs


def test_spans_are_off_without_the_profiler(monkeypatch, stand_ins):
    lib, cache = stand_ins

    def refuse(*a, **k):
        raise AssertionError("a profiler range opened")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    for name in profiling.SPAN_NAMES:
        with profiling.span(name) as s:
            assert s is None
    assert profiling.span("runner.keys") is profiling.span("serve.keys")
    _epochs(lib)
    _calls(lib, cache, "call")
    _calls(lib, cache, "update")
    _models()


def test_runner_spans_per_epoch(stand_ins):
    lib, _ = stand_ins
    _, names, _ = _profiled(lambda: _epochs(lib, 3))
    epoch = ["runner.permutation", "runner.keys", "runner.load",
             "runner.replay"]
    assert names == (["runner.permutation", "runner.capture"] + epoch[1:]
                     + epoch * 2)


def test_runner_draws_the_next_epoch_after_the_replay(stand_ins):
    lib, _ = stand_ins
    _, names, _ = _profiled(lambda: _epochs(lib, 3, hint="next"))
    ahead = ["runner.permutation", "runner.keys"]
    epoch = ["runner.load", "runner.replay"] + ahead
    assert names == (["runner.permutation", "runner.capture", "runner.keys"]
                     + epoch + epoch * 2)


@pytest.mark.parametrize("hint", ["next", "other"])
def test_runner_loads_each_epochs_own_keys_whatever_the_hint(stand_ins,
                                                            hint):
    lib, _ = stand_ins
    runners = []
    state, outs = _epochs(lib, 3, runners=runners)
    counts = (dict(graphs.STATS["replays"]), dict(graphs.STATS["keys"]))
    graphs.reset_stats()
    state2, outs2 = _epochs(lib, 3, hint=hint, runners=runners)
    runner, runner2 = runners
    assert (dict(graphs.STATS["replays"]),
            dict(graphs.STATS["keys"])) == counts
    assert torch.equal(state, state2)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(outs),
                                                 _leaves(outs2)))
    assert runner._ahead is None
    assert runner2._ahead[0] == {"next": rng.fold_in(1, 3),
                                 "other": rng.fold_in(2, 2)}[hint]


@pytest.mark.parametrize("kind", ["call", "update"])
def test_serving_spans_per_call(stand_ins, kind):
    lib, cache = stand_ins
    _, names, _ = _profiled(lambda: _calls(lib, cache, kind))
    first = ["serve.load", "serve.capture", "serve.replay", "serve.keys"]
    again = ["serve.load", "serve.replay", "serve.keys"]
    assert names == first + again + first


@pytest.mark.parametrize("kind", ["runner", "call", "update"])
def test_keys_count_the_key_table_at_every_replay(stand_ins, kind):
    lib, cache = stand_ins
    if kind == "runner":
        _epochs(lib, 3)
        replays = {"fake": 3}
        paths = {"fake": 2}
    else:
        _calls(lib, cache, kind)
        name = ("serve:body" if kind == "call" else "step:step")
        replays = {name: 3}
        paths = {name: 2}
        assert {len(g.paths) for g in cache.graphs.values()} == {2}
    assert dict(graphs.STATS["replays"]) == replays
    assert dict(graphs.STATS["keys"]) == {
        n: paths[n] * r for n, r in replays.items()}
    graphs.reset_stats()
    assert graphs.STATS["keys"] == {}


def _leaves(tree):
    return graphs.flatten(tree)[0]


def _models():
    """Both models' serving methods and per-epoch entries on the CPU
    (launch by launch), from fresh models; their outputs and states."""
    m, b = small_imdbn(), small_bimodal()
    img, _ = next(iter(m.val_loader))
    m1, m2 = next(iter(b.val_loader))
    labels = np.arange(5) % m.num_labels
    data = torch.as_tensor(m.dataloader.materialize()[0])
    idbn = m.image_idbn
    runner = idbn._epoch_runner(data.reshape(len(data), -1), 16)
    outs = [m.img2txt(img), m.txt2img(labels), m.sample_txt2img(labels),
            m.sample_txt2img(labels, seed=3), b.mod1_to_mod2(m1),
            b.mod2_to_mod1(m2), b.sample_mod1_to_mod2(m1),
            b.sample_mod2_to_mod1(m2, seed=4),
            idbn._train_epoch(0, runner, 16)]
    return outs, idbn.states()


@pytest.mark.parametrize("kind", ["runner", "call", "update", "models"])
def test_results_equal_with_the_profiler_on_and_off(monkeypatch, kind):
    runs = []
    for on in (False, True):
        with monkeypatch.context() as m:
            lib, cache = graph_stand_ins(m)
            graphs.reset_stats()
            fn = {"runner": lambda: _epochs(lib, 3),
                  "models": _models}.get(
                kind, lambda: _calls(lib, cache, kind))
            out = _profiled(fn)[0] if on else fn()
            runs.append((_leaves(out), dict(graphs.STATS["replays"]),
                         dict(graphs.STATS["keys"]),
                         lib.launches_by_entry["k"]))
    graphs.reset_stats()
    (off, *counts_off), (on, *counts_on) = runs
    assert counts_off == counts_on
    assert len(off) == len(on) and all(torch.equal(a, b)
                                       for a, b in zip(off, on))


# -- the models' entries ---------------------------------------------------

INPUTS_FIRST = ["serve.inputs", "serve.load", "serve.capture",
                "serve.replay", "serve.load", "serve.capture", "serve.replay",
                "serve.keys"]
LABELS_FIRST = ["serve.inputs", "serve.load", "serve.capture",
                "serve.replay", "serve.keys"]
METHODS = {
    "img2txt": INPUTS_FIRST, "txt2img": LABELS_FIRST,
    "sample_txt2img": LABELS_FIRST, "mod1_to_mod2": INPUTS_FIRST,
    "mod2_to_mod1": INPUTS_FIRST, "sample_mod1_to_mod2": INPUTS_FIRST,
    "sample_mod2_to_mod1": INPUTS_FIRST,
}


def _request(model, method):
    if method == "img2txt":
        img, _ = next(iter(model.val_loader))
        return lambda: model.img2txt(img)
    if method in ("txt2img", "sample_txt2img"):
        labels = np.arange(3) % model.num_labels
        return lambda: getattr(model, method)(labels)
    m1, m2 = next(iter(model.val_loader))
    x = m1 if "mod1_to" in method else m2
    return lambda: getattr(model, method)(x)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_serving_methods_wrap_their_inputs(monkeypatch, stand_ins, method):
    """Each public serving method of both models, through the stand-in
    cache: its preparation (for the image and modality calls a serving
    call of its own, the encoder's, keyless) inside ``serve.inputs``, then
    its own call; the second request makes no capture."""
    model = small_imdbn() if method in ("img2txt", "txt2img",
                                        "sample_txt2img") \
        else small_bimodal()
    _, cache = stand_ins
    caches = {}

    def fake_cache(owner, device):
        if id(owner) not in caches:
            c = graphs.ServingGraphs.__new__(graphs.ServingGraphs)
            c.device = cache.device
            c.graphs, c.buffers = {}, graphs._Buffers()
            caches[id(owner)] = c
        return caches[id(owner)]

    monkeypatch.setattr(graphs, "_cache", fake_cache)
    request = _request(model, method)
    _, names, events = _profiled(lambda: (request(), request()))
    first = METHODS[method]
    again = [n for n in first if n != "serve.capture"]
    assert names == first + again
    inputs = [e for e in events if e.name == "serve.inputs"]
    inner = [e for e in events if e.name != "serve.inputs"
             and any(i.time_range.start <= e.time_range.start
                     and e.time_range.end <= i.time_range.end
                     for i in inputs)]
    # the encoder's load, capture and replay, then its load and replay
    assert len(inner) == (5 if first is INPUTS_FIRST else 0)
    assert all(e.cpu_parent is not None and e.cpu_parent.name ==
               "serve.inputs" for e in inner)


@pytest.mark.parametrize("family", ["idbn", "joint", "bimodal"])
def test_epoch_entries_read_inside_epoch_read(family):
    """The per-epoch entries on the CPU (launch by launch: the runner's
    permutation only, then the host reads)."""
    if family == "bimodal":
        model = small_bimodal()
        run = lambda: model.train_joint(1)     # noqa: E731
    else:
        model = small_imdbn()
        if family == "idbn":
            idbn = model.image_idbn
            data = torch.as_tensor(model.dataloader.materialize()[0])
            runner = idbn._epoch_runner(data.reshape(len(data), -1), 16)
            run = lambda: idbn._train_epoch(0, runner, 16)  # noqa: E731
        else:
            X, Y, Z = model._materialized_train()
            model.init_joint_bias_from_data(n_batches=2, _cached=(X, Y, Z))
            args = (X, Y, Z, 16, model.image_idbn.states(), 2, 1, {})
            run = lambda: model._train_joint_epoch(8, *args)  # noqa: E731
    _, names, _ = _profiled(run)
    assert names == ["runner.permutation", "epoch.read"]


def test_span_names_are_declared():
    """Every name the package passes to ``span(...)`` is in
    ``SPAN_NAMES``, and every name there is opened somewhere."""
    root = Path(multimodal_idbn_tpu_torch.__file__).parent
    used = set()
    for path in root.rglob("*.py"):
        src = path.read_text()
        used |= set(re.findall(r"\bspan\(\s*\"([^\"]+)\"", src))
        assert not re.search(r"\bspan\(\s*[^\"\s)]", src.replace(
            "def span(name", "")), f"{path}: a span named by a variable"
    assert used == SPANS
