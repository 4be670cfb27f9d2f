"""Epochs run from device buffers, and replayed as CUDA graphs.

The JAX package runs an epoch as one ``lax.scan`` with the dataset on the
device, and a block of epochs as one dispatch whose permutation, schedule
values and keys are computed on the device (docs/DESIGN.md:15-25;
ops/dbn_train.py:63-228, ops/imdbn_ops.py:265-438,
ops/bimodal_ops.py:154-303). The port's counterpart is an epoch body
captured once as a CUDA graph and replayed once per epoch: capture plays
the part of trace and compile, replay the part of the dispatch.

An epoch body is a function ``body(consts, state, perm, lr, mom,
**statics) -> (state, outputs)``: ``consts`` the tensors every epoch reads
(the data, a frozen stack), ``state`` those it updates, ``perm`` the
epoch's permutation (int64 on the device), ``lr`` and ``mom`` 0-d float64
tensors holding the Python floats of the schedule (so every product with
them rounds as with the floats), ``statics`` what fixes its control flow.
Its key is ``rng.Key()``, and every draw takes its key through the
active ``rng.KeyTable``. A body reads nothing on the host and copies
nothing to the device.

``EpochRunner`` runs one body at one setting. Each epoch the host draws
the permutation (``rng.permutation`` of the epoch's key, on the CPU) and
copies it and the schedule values to the device, outside the body. Then:

- launch by launch (``graphed=False``: the CPU, a mesh, the per-epoch
  functions ``ops.*_epoch_block`` called as they are), the body runs with
  a key table by value: each key's value is computed on the host as the
  body draws it;
- graphed, the body is captured at the first epoch by the capture core
  (``_Graph``) and replayed at every epoch, this one included. The core
  runs the body once on a side stream with a key table by value, to warm
  up (libraries loaded, the chain kernel's grid size asked, cuBLAS's
  workspace made) and to record the paths of its keys; its results are
  dropped. It then captures it under ``torch.cuda.graph`` on static
  buffers, with a key table read from a static int64 buffer that nothing
  fills at capture. Before each replay the host fills the key buffer
  (``_Graph.key_values``: the values ``fold_in`` gives for the epoch, the
  one place the host computes a key table), the permutation and the
  schedule values. The captured body ends by copying the new state into
  the state buffers, so the state stays in them from replay to replay;
  the outputs are cloned after each replay. A capture that fails raises:
  nothing falls back to launch by launch.

Serving calls. The JAX package jits each serving call as one dispatch
(ops/imdbn_ops.py:462-507, ops/bimodal_ops.py:319-361,
ops/dbn_train.py:388-434). ``ServingGraphs`` is the port's counterpart:
one cache per model, which captures a call at its first use at a given
signature (the function, the structure, shapes, dtypes and devices of its
tensor arguments, and its other arguments, among them the ones JAX names
in ``static_argnames``) and replays it at every later call with that
signature, as ``jax.jit`` retraces per shape. Each graph is an instance
of the runner's capture core: the same warm-up, capture, key table
(filled per call from the call's key) and launch accounting.

A graph reads static buffers, never the caller's tensors. Before each
replay every tensor argument is held against the buffer it feeds: a
buffer is refreshed (``copy_``) unless the tensor it last copied is the
same object at the same ``_version``. So a new input is copied at every
call, and the model's weights only after they changed: a launch-by-launch
update, a ``load_model`` / ``from_payload``, a checkpoint restore or any
state assignment gives new tensors; an in-place update moves the version
counter, and so does an ``EpochRunner`` replay, which writes its state
buffers (the model's weights after a graphed epoch) behind torch's back.
Any other writer outside torch's view (``.data``, a raw pointer) must do
the same (``torch.autograd.graph.increment_version``).
A dtype or shape change is another signature, so another graph. The
graphs of one cache share the buffers of the tensors they were captured
on (a model's weights are held once, not once per graph), and a call
whose arguments would feed one buffer two different tensors raises.
Outputs are cloned after each replay, so two calls never share memory.

Calls that update a state in place. The JAX package also jits calls that
return a new state: the per-batch steps (ops/dbn_train.py:364,
ops/imdbn_ops.py:441, ops/bimodal_ops.py:304), the RBM shell's training
entries (models/rbm.py:144-150) and the probe's ``while_loop``
(utils/probe_utils.py:226). ``update`` (``ServingGraphs.update``) is the
runner's pattern in a cache: the graph writes the new state into the
buffers of the state it was given and returns those buffers as the state,
their version counters moved, so the caller holds its state in the graph's
buffers from call to call (nothing is copied when it hands them back, a
state from elsewhere is copied in) and the cache's other graphs (the same
model's serving calls) read the same buffers. Keys: a call may take one
key, or a tuple of keys (one per RBM shell it draws from, each from that
shell's stream): the body then gets ``rng.root_keys(n)`` and the table is
filled from the n values. Schedule values that change from call to call
(a learning rate, a momentum) reach a graph as a device tensor
(``hyper``), not as a constant of its capture. ``SHARED`` holds the
graphs of calls that belong to no model (the probes).

Launch counts stay counts of launches that ran on the device:
``CudaLibrary.launch`` counts host calls, so the launches of a capture
(which runs nothing) are taken back off the counts and added again at
every replay, and the warm-up's are moved to ``STATS["warmup_launches"]``
(work done once per capture, as a compile). ``STATS`` also holds the
replays of each runner and serving call, the key values the host computed
for them (``keys``: the length of the key table at each replay), and each
capture's seconds and graph memory.

Host spans (``utils.profiling.span``, recorded under ``torch.profiler``):
an epoch is ``runner.permutation``, ``runner.keys``, ``runner.load`` and
``runner.replay`` (the first one ``runner.capture`` too), a serving call
``serve.load`` and ``serve.replay``, inside which a keyed call's
``serve.keys`` (the first at a signature ``serve.capture`` too). None
opens inside a captured body. A caller that names the key of the epoch it
runs next (the iDBN's epoch blocks) has that epoch's ``runner.permutation``
and ``runner.keys`` drawn right after this epoch's ``runner.replay``, while
the device runs it, so that the key table's host time stays off the
device's path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd.graph import increment_version

from multimodal_idbn_tpu_torch.ops import _cuda, rng
from multimodal_idbn_tpu_torch.utils.profiling import span

STATS: Dict[str, Any] = {}


def reset_stats() -> None:
    """Zero the replay and key counts and forget the capture records."""
    STATS.clear()
    STATS.update(replays=Counter(), keys=Counter(), captures=[],
                 warmup_launches=Counter())


reset_stats()


# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------

def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """(tensor leaves, structure) of a tree of lists, tuples, named
    tuples, dicts and dataclasses; anything else is kept as a constant."""
    leaves: List[torch.Tensor] = []

    def go(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("T",)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return ("D", type(x), tuple(
                (f.name, go(getattr(x, f.name)))
                for f in dataclasses.fields(x)))
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("N", type(x), tuple(go(v) for v in x))
        if isinstance(x, (list, tuple)):
            return ("L" if isinstance(x, list) else "U",
                    tuple(go(v) for v in x))
        if isinstance(x, dict):
            return ("M", tuple((k, go(v)) for k, v in x.items()))
        return ("C", x)

    return leaves, go(tree)


def unflatten(spec, leaves: List[torch.Tensor]):
    """The tree of ``spec`` with ``leaves`` in the order ``flatten``
    gave them."""
    it = iter(leaves)

    def go(s):
        tag = s[0]
        if tag == "T":
            return next(it)
        if tag == "D":
            return s[1](**{name: go(v) for name, v in s[2]})
        if tag == "N":
            return s[1](*(go(v) for v in s[2]))
        if tag == "L":
            return [go(v) for v in s[1]]
        if tag == "U":
            return tuple(go(v) for v in s[1])
        if tag == "M":
            return {k: go(v) for k, v in s[1]}
        return s[1]

    return go(spec)


def map_tree(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """The tree with ``fn`` applied to each tensor leaf."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [fn(t) for t in leaves])


# ---------------------------------------------------------------------------
# Launch accounting
# ---------------------------------------------------------------------------

def launch_counts() -> Dict[Tuple[str, str], int]:
    """Launches of every entry of every kernel library, by (source,
    entry), and of every kernel body, by (source, ``body:<name>``)."""
    out = {}
    for lib in _cuda.LIBRARIES:
        src = lib.source.name
        out.update({(src, e): n for e, n in lib.launches_by_entry.items()})
        out.update({(src, f"body:{b}"): n for b, n
                    in getattr(lib, "launches_by_body", {}).items()})
    return out


def add_launches(delta: Dict[Tuple[str, str], int], sign: int = 1) -> None:
    """Add ``sign`` × ``delta`` to the libraries' counts."""
    for lib in _cuda.LIBRARIES:
        src = lib.source.name
        for e in lib.launches_by_entry:
            lib.launches_by_entry[e] += sign * delta.get((src, e), 0)
        for b in getattr(lib, "launches_by_body", {}):
            lib.launches_by_body[b] += sign * delta.get(
                (src, f"body:{b}"), 0)


def launches_since(before: Dict[Tuple[str, str], int]
                   ) -> Dict[Tuple[str, str], int]:
    now = launch_counts()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


# ---------------------------------------------------------------------------
# The capture core
# ---------------------------------------------------------------------------

def _write_state(name: str, bufs: List[torch.Tensor], spec, state) -> None:
    """Copy the leaves of ``state``, which must have the structure
    ``spec``, into ``bufs`` (a leaf that is its buffer already stays)."""
    leaves, got = flatten(state)
    if got != spec:
        raise RuntimeError(f"{name}: a state of another structure")
    for buf, t in zip(bufs, leaves):
        if t is not buf:
            buf.copy_(t, non_blocking=True)


def _moved(bufs: List[torch.Tensor]) -> None:
    """Move the version counters of buffers a replay wrote behind torch's
    back, as an in-place update would, so that a serving graph holding a
    copy of one refreshes it."""
    for buf in bufs:
        increment_version(buf)


class _Graph:
    """One call on static buffers, captured once and replayed: the
    warm-up, the capture, the key table and the launch accounting of
    every epoch and serving graph (module docstring)."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self.graph = None

    def capture(self, run: Callable, root, **record) -> None:
        """Capture ``run(table, write)``: the call on the static buffers
        with the key table ``table`` (None for a call without a key),
        which writes its new state into its buffers if ``write`` and
        returns its outputs (kept as ``outs``). ``root``: the warm-up's
        key (None: no key); ``record``: fields of the capture's
        ``STATS`` record beside its name, time, memory and launches."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = launch_counts()
        warm = None if root is None else rng.KeyTable(root=root)
        with torch.cuda.stream(side):
            run(warm, False)           # the warm-up; its results dropped
        torch.cuda.current_stream(dev).wait_stream(side)
        warm_launches = launches_since(before)
        add_launches(warm_launches, -1)
        STATS["warmup_launches"].update(
            {f"{s}:{e}": n for (s, e), n in warm_launches.items()})
        self.paths = [] if warm is None else warm.paths
        # filled before every replay and read by index on the device only
        # then; zeros, not garbage, for a capture stand-in on the CPU that
        # runs the body
        self.keys = torch.zeros(len(self.paths), dtype=torch.int64,
                                device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()      # what stays reserved is the graph's
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        table = None if root is None else rng.KeyTable(self.keys, self.paths)
        with torch.cuda.graph(graph, stream=side):
            self.outs = run(table, True)
        self.launches_per_replay = launches_since(before)
        add_launches(self.launches_per_replay, -1)
        self.graph = graph
        STATS["captures"].append(dict(
            name=self.name, seconds=time.perf_counter() - t0,
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved, **record,
            launches={f"{s}:{e}": n for (s, e), n
                      in self.launches_per_replay.items()}))

    def key_values(self, root) -> torch.Tensor:
        """The key table's values for the key ``root``, on the host: the
        one place where they are computed."""
        return torch.tensor(rng.key_values(root, self.paths),
                            dtype=torch.int64)

    def replay(self, values: Optional[torch.Tensor]) -> None:
        """Copy the key table's ``values`` in (None: the call draws no
        key) and replay."""
        if values is not None:
            self.keys.copy_(values, non_blocking=True)
            STATS["keys"][self.name] += len(self.paths)
        self.graph.replay()
        add_launches(self.launches_per_replay)
        STATS["replays"][self.name] += 1


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

class EpochRunner:
    """``body`` at one setting (``consts``, ``statics``, the shapes of the
    state), over ``n_rows`` rows permuted each epoch. ``graphed``: capture
    the body at its first epoch and replay it every epoch (CUDA only)."""

    def __init__(self, name: str, body: Callable, consts, statics: dict, *,
                 n_rows: int, device, graphed: bool):
        self.name = name
        self.body = body
        self.consts = consts
        self.statics = dict(statics)
        self.n_rows = int(n_rows)
        self.device = torch.device(device)
        if graphed and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        self.graphed = bool(graphed)
        self.replays = 0
        self._core = _Graph(name, self.device)
        self._ahead = None      # (next key, its permutation, key table)

    # the core's graph, key paths, key buffer and launches, under the
    # runner's names
    _graph = property(lambda self: self._core.graph)
    _paths = property(lambda self: self._core.paths)
    _keys = property(lambda self: self._core.keys)
    launches_per_replay = property(
        lambda self: self._core.launches_per_replay)

    # -- one epoch -----------------------------------------------------------

    def __call__(self, state, key: int, lr: float, mom: float,
                 next_key: Optional[int] = None):
        """(new state, outputs) of the epoch whose key is ``key``
        (``fold_in(block key, epoch)``), at learning rate ``lr`` and
        momentum ``mom``. ``next_key``: the key of the epoch the caller
        expects to run next; a graphed runner draws that epoch's
        permutation and key table on the host while the device runs this
        one, and uses them if the next call's key is that key."""
        hyper = torch.tensor([float(lr), float(mom)], dtype=torch.float64)
        if self.graphed:
            return self._replay(state, key, hyper, next_key)
        perm = self._permutation(key)
        perm, hyper = (t.to(self.device, non_blocking=True)
                       for t in (perm, hyper))
        with rng.key_table(rng.KeyTable(root=key)):
            return self.body(self.consts, state, perm, hyper[0], hyper[1],
                             **self.statics)

    # -- the graph -----------------------------------------------------------

    def _run_static(self, table: rng.KeyTable, write: bool):
        """The body on the static buffers with the key table ``table``;
        the new state copied into the state buffers if ``write``. Returns
        the outputs."""
        state = unflatten(self._spec, self._bufs)
        with rng.key_table(table):
            new, outs = self.body(self.consts, state, self._perm,
                                  self._hyper[0], self._hyper[1],
                                  **self.statics)
        if write:
            _write_state(self.name, self._bufs, self._spec, new)
        return outs

    def _permutation(self, key: int) -> torch.Tensor:
        """The permutation of the epoch whose key is ``key``, on the
        host."""
        with span("runner.permutation"):
            return rng.permutation(key, self.n_rows)

    def _key_values(self, key: int) -> torch.Tensor:
        """The key table of the epoch whose key is ``key``, on the
        host."""
        with span("runner.keys"):
            return self._core.key_values(key)

    def _replay(self, state, key: int, hyper, next_key: Optional[int]):
        ahead, self._ahead = self._ahead, None
        if ahead is not None and ahead[0] == key:
            perm, values = ahead[1:]
        else:
            perm, values = self._permutation(key), None
        if self._graph is None:
            with span("runner.capture"):
                # the static buffers, holding this epoch's inputs, then the
                # core's warm-up and capture
                leaves, self._spec = flatten(state)
                self._bufs = [t.clone() for t in leaves]
                self._perm, self._hyper = (t.to(self.device, copy=True)
                                           for t in (perm, hyper))
                self._core.capture(self._run_static, key)
        if values is None:
            values = self._key_values(key)
        with span("runner.load"):
            # the state (unless it is the buffers already), permutation and
            # schedule values into the static buffers
            _write_state(self.name, self._bufs, self._spec, state)
            self._perm.copy_(perm, non_blocking=True)
            self._hyper.copy_(hyper, non_blocking=True)
        with span("runner.replay"):
            self._core.replay(values)
            _moved(self._bufs)
            self.replays += 1
            out = (unflatten(self._spec, self._bufs),
                   map_tree(torch.clone, self._core.outs))
        if next_key is not None:
            # the next epoch's host inputs, while the device runs this one
            self._ahead = (next_key, self._permutation(next_key),
                           self._key_values(next_key))
        return out


# ---------------------------------------------------------------------------
# Serving calls
# ---------------------------------------------------------------------------

def _signature(fn, leaves, spec) -> tuple:
    return (fn, spec, tuple((tuple(t.shape), t.dtype, t.device)
                            for t in leaves))


def _version(t: torch.Tensor) -> Optional[int]:
    """The version counter of ``t``; None for an inference tensor, which
    has none (it is copied at every call)."""
    return None if t.is_inference() else t._version


class _Buffers:
    """Static buffers shared by the graphs of one cache, each with the
    tensor (a weak reference) and version it last copied."""

    def __init__(self):
        self.bufs: List[torch.Tensor] = []
        self.src: List[Tuple[Any, Optional[int]]] = []

    def _same(self, i: int, t: torch.Tensor) -> bool:
        ref, version = self.src[i]
        return ref() is t and version is not None and \
            _version(t) == version

    def slot(self, t: torch.Tensor, taken=()) -> int:
        """The buffer of ``t``: one already holding ``t`` as it is (and
        not in ``taken``), or a new copy of it."""
        for i in range(len(self.bufs)):
            if i not in taken and self._same(i, t):
                return i
        self.bufs.append(t.clone())
        self.src.append((weakref.ref(t), _version(t)))
        return len(self.bufs) - 1

    def written(self, i: int) -> torch.Tensor:
        """Buffer ``i`` after a replay wrote it: its version moved
        (``_moved``), and it is recorded as its own source, so that it is
        not copied into itself when it feeds the next call."""
        buf = self.bufs[i]
        _moved([buf])
        self.src[i] = (weakref.ref(buf), _version(buf))
        return buf

    def load(self, slots: List[int], leaves: List[torch.Tensor]) -> None:
        """Copy into each slot the tensor that now feeds it, unless it
        holds it already."""
        fed: Dict[int, torch.Tensor] = {}
        for i, t in zip(slots, leaves):
            if fed.setdefault(i, t) is not t:
                raise ValueError("two different tensors feed one buffer of "
                                 "a serving graph")
            if not self._same(i, t):
                self.bufs[i].copy_(t, non_blocking=True)
                self.src[i] = (weakref.ref(t), _version(t))


class _CallGraph(_Graph):
    """One call at one signature: the core's graph, with the call's
    buffer slots (the state's first, for an update), the structure of its
    arguments and the number of its keys."""

    def __init__(self, name: str, device: torch.device, slots: List[int],
                 spec, n_keys, n_state: Optional[int] = None,
                 state_spec=None):
        super().__init__(name, device)
        self.slots = slots
        self.spec = spec
        self.n_keys = n_keys
        self.n_state = n_state       # None: a pure call
        self.state_spec = state_spec


def _n_keys(key) -> Optional[int]:
    """None (no key), 0 (one key) or the number of a tuple's roots."""
    if key is None:
        return None
    return len(key) if isinstance(key, (tuple, list)) else 0


class ServingGraphs:
    """The serving calls of one model on one CUDA device, each captured
    at its first call with a signature and replayed at every later one
    (module docstring). ``call(fn, key, *args, **kwargs)`` returns what
    ``fn(*args, key=key, **kwargs)`` returns (no ``key`` given when it is
    None), bit for bit as launch by launch."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device; on the CPU "
                             "a serving call runs launch by launch")
        self.graphs: Dict[tuple, _CallGraph] = {}
        self.buffers = _Buffers()

    def _run(self, g: _CallGraph, fn, table: Optional[rng.KeyTable],
             write: bool):
        """``fn`` on the buffers of ``g`` with the key table ``table``; an
        update's new state written into its buffers if ``write``. Returns
        the outputs."""
        args, kwargs = unflatten(g.spec,
                                 [self.buffers.bufs[i] for i in g.slots])
        if table is None:
            out = fn(*args, **kwargs)
        else:
            with rng.key_table(table):
                out = fn(*args, key=rng.Key() if g.n_keys == 0
                         else rng.root_keys(g.n_keys), **kwargs)
        if g.n_state is None:
            return out
        new, outs = out
        if write:
            _write_state(g.name, [self.buffers.bufs[i]
                                  for i in g.slots[:g.n_state]],
                         g.state_spec, new)
        return outs

    def _capture(self, fn, key, leaves, spec, kwargs, state=None
                 ) -> _CallGraph:
        """The graph of a call whose tensors are ``leaves``; ``state``:
        the (leaves, structure) of an update's state, None for a pure
        call."""
        n_state, state_spec = (None, None) if state is None else (
            len(state[0]), state[1])
        slots: List[int] = []
        for j, t in enumerate(leaves):
            # every state leaf gets a buffer of its own: the graph writes
            # each one (the state's leaves come first)
            slots.append(self.buffers.slot(
                t, slots if j < (n_state or 0) else ()))
        g = _CallGraph(f"{'serve' if state is None else 'step'}:"
                       f"{fn.__name__}", self.device, slots, spec,
                       _n_keys(key), n_state, state_spec)
        # the keyword arguments that hold no tensor: what fixes the graph
        # beside the shapes (steps, flags)
        g.statics = {k: v for k, v in kwargs.items() if not flatten(v)[0]}
        self.buffers.load(g.slots, leaves)
        g.capture(lambda table, write: self._run(g, fn, table, write), key,
                  shapes=[tuple(t.shape) for t in leaves])
        return g

    def _replay(self, g: _CallGraph, key) -> None:
        """Fill the key table of ``g`` from the call's ``key`` and replay
        it."""
        if _n_keys(key) != g.n_keys:
            raise ValueError(f"{g.name}: called with keys {key!r}, captured "
                             f"with {g.n_keys} (None: no key, 0: one)")
        values = None
        if g.paths:
            with span("serve.keys"):
                values = g.key_values(key)
        g.replay(values)

    @staticmethod
    def signature(fn, args, kwargs, state=None, update: bool = False
                  ) -> tuple:
        """The key of a call's graph: ``fn``, the structure, shapes,
        dtypes and devices of its tensors and its other arguments; an
        update's is another than a pure call's."""
        tree = (state, args, kwargs) if update else (args, kwargs)
        sig = _signature(fn, *flatten(tree))
        return ("update",) + sig if update else sig

    def _lookup(self, fn, key, args, kwargs, state=None, update=False
                ) -> _CallGraph:
        """The graph of a call's signature with the call's tensors loaded
        into its buffers, captured if the signature is new."""
        with span("serve.load"):
            leaves, spec = flatten(((state, *args), kwargs) if update
                                   else (args, kwargs))
            sig = self.signature(fn, args, kwargs, state, update)
            g = self.graphs.get(sig)
            if g is not None:
                self.buffers.load(g.slots, leaves)
        if g is None:
            with span("serve.capture"):
                g = self.graphs[sig] = self._capture(
                    fn, key, leaves, spec, kwargs,
                    flatten(state) if update else None)
        return g

    def call(self, fn, key, *args, **kwargs):
        """``fn(*args, key=key, **kwargs)``, replayed."""
        g = self._lookup(fn, key, args, kwargs)
        with span("serve.replay"):
            self._replay(g, key)
            return map_tree(torch.clone, g.outs)

    def update(self, fn, key, state, *args, **kwargs):
        """``fn(state, *args, key=key, **kwargs)``, which returns (new
        state, outputs), replayed with the state updated in place: the
        graph writes the new state into the state's buffers and returns
        them as the state, their versions moved (``_Buffers.written``).
        A caller that hands them back at its next call has nothing
        copied; one that hands other tensors has them copied in."""
        g = self._lookup(fn, key, args, kwargs, state, update=True)
        with span("serve.replay"):
            self._replay(g, key)
            new = [self.buffers.written(i) for i in g.slots[:g.n_state]]
            return (unflatten(g.state_spec, new),
                    map_tree(torch.clone, g.outs))


class _Eager:
    on = False


_EAGER = _Eager()


@contextlib.contextmanager
def launch_by_launch():
    """Run the serving calls inside the block launch by launch on the
    card too: the reference a replay is held against (``chip_smoke.py``,
    tests/test_torch_cuda.py). Nothing switches to it on its own: a
    capture or replay that fails raises."""
    prev = _EAGER.on
    _EAGER.on = True
    try:
        yield
    finally:
        _EAGER.on = prev


def _cache(owner, device) -> Optional[ServingGraphs]:
    """The owner's ``ServingGraphs`` on a CUDA device (made at first use,
    kept as ``owner._serving``); None on the CPU and inside
    ``launch_by_launch``."""
    device = torch.device(device)
    if device.type != "cuda" or _EAGER.on:
        return None
    if device.index is None:      # "cuda" and "cuda:0" are one cache
        device = torch.device("cuda", torch.cuda.current_device())
    cache = owner.__dict__.get("_serving")
    if cache is None or cache.device != device:
        cache = owner._serving = ServingGraphs(device)
    return cache


def serve(owner, device, fn, key, *args, **kwargs):
    """``fn(*args, key=key, **kwargs)`` (no ``key`` when None; a tuple of
    keys reaches ``fn`` as a tuple) for a model ``owner`` on ``device``:
    launch by launch on the CPU (and inside ``launch_by_launch``), one
    replay of the owner's graph of this signature on a CUDA device."""
    cache = _cache(owner, device)
    if cache is not None:
        return cache.call(fn, key, *args, **kwargs)
    if key is None:
        return fn(*args, **kwargs)
    return fn(*args, key=key, **kwargs)


def update(owner, device, fn, key, state, *args, **kwargs):
    """(new state, outputs) of ``fn(state, *args, key=key, **kwargs)``
    for ``owner`` on ``device``: launch by launch on the CPU (and inside
    ``launch_by_launch``); on a CUDA device one replay that updates the
    state in its buffers (``ServingGraphs.update``)."""
    cache = _cache(owner, device)
    if cache is not None:
        return cache.update(fn, key, state, *args, **kwargs)
    if key is None:
        return fn(state, *args, **kwargs)
    return fn(state, *args, key=key, **kwargs)


class Owner:
    """Holds the graphs of calls that belong to no model (``SHARED``:
    the probes, a bare state's diagnostics), as a model holds its own."""


SHARED = Owner()

_HYPER: Dict[tuple, torch.Tensor] = {}


def hyper(device, *values: float):
    """Schedule values (learning rates, momenta) for a replayed call: on
    a CUDA device one float64 tensor, made once per (device, values) and
    kept, so a graph reads them from its buffer (a float would be a
    constant of the capture, and a new signature at every new value) and
    a call with the values of the last one copies nothing; on the CPU the
    floats themselves. A 0-d float64 operand rounds as the float does
    (the epoch runners' ``lr`` and ``mom``)."""
    device = torch.device(device)
    values = tuple(float(v) for v in values)
    if device.type != "cuda":
        return values
    k = (device, values)
    t = _HYPER.get(k)
    if t is None:
        if len(_HYPER) >= 256:
            _HYPER.pop(next(iter(_HYPER)))
        t = _HYPER[k] = torch.tensor(values, dtype=torch.float64).to(device)
    return t
