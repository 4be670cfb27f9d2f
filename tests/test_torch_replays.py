"""The calls the card replays beyond the epochs and the serving calls, on
the CPU.

The JAX package jits more than its epochs and serving calls: the probe's
``lax.while_loop`` (utils/probe_utils.py:174-237), the diagnostic chains
(energy_utils.py:39, :115; conditional_steps.py:56, :88;
imdbn_logging.py:79; the bimodal trajectory's scan,
models/imdbn_bimodal.py:130-160), ``joint_bias_stats``
(ops/imdbn_ops.py:46), ``measure_gibbs_steps_per_sec`` (profiling.py:134),
the per-batch steps (dbn_train.py:364, imdbn_ops.py:441,
bimodal_ops.py:304) and the RBM shell's entries (models/rbm.py:136-157).
The port replays each as one CUDA graph per call on the card
(``graphs.serve`` for pure calls, ``graphs.update`` for the calls that
update a state in place). Here, where no graph can run:

- (a) every body runs with the host reads raising: it reads nothing on
  the host;
- (b) a body reading its keys from an int64 table (a replay) gives the
  bits of the same call with its keys by value (launch by launch), one
  key or one key per shell;
- (c) the probe in chunks of any length gives the bits of the probe step
  by step, and JAX's probe from JAX's initial weights;
- (d) an update graph, with the CUDA calls replaced by stand-ins: one
  capture per signature, the state written into its buffers and handed
  back as the state with its versions moved, nothing copied when the
  caller hands them back, new tensors copied in, a pure graph of the
  same cache reading the same buffers;
- (e) the models' per-batch steps and the shell's training entries move
  the version counters of the state they write;
- (f) the shell's key stream advances call for call as the entries draw,
  and each entry equals the ``rbm_ops`` function it wraps;
- (g) the shell's entries and the bimodal trajectory equal the JAX
  package's under the deterministic sampler modes (``torch_parity``);
- (h) on the CPU nothing makes a graph.

Tolerances: bit-equality within the port (the same arithmetic on the same
inputs); 1e-5 against the JAX package, as the other parity tests.
"""

import contextlib

import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.models.imdbn_bimodal import \
    _mod2_to_mod1_chain as jax_mod2_to_mod1_chain
from multimodal_idbn_tpu.models.rbm import RBM as JRBM
from multimodal_idbn_tpu_torch.models import idbn as tidbn
from multimodal_idbn_tpu_torch.models import imdbn as timdbn
from multimodal_idbn_tpu_torch.models import imdbn_bimodal as tbim
from multimodal_idbn_tpu_torch.models import rbm as trbm
from multimodal_idbn_tpu_torch.ops import (_cuda, bimodal_ops, dbn_train,
                                           graphs, imdbn_ops, rbm_ops, rng,
                                           schedules)
from multimodal_idbn_tpu_torch.utils import conditional_steps as tcs
from multimodal_idbn_tpu_torch.utils import energy_utils as teu
from multimodal_idbn_tpu_torch.utils import imdbn_logging as til
from multimodal_idbn_tpu_torch.utils import probe_utils as tpu

from torch_parity import (both_deterministic, close, jax_state, np_state,
                          small_bimodal, small_imdbn, small_loaders,
                          torch_state)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

DZ, K, HJ, D, B = 12, 4, 10, 40, 6
GROUPS = ((DZ, DZ + K),)


def _w(rs, v, h, momentum=False):
    return torch_state(np_state(rs, v, h, momentum=momentum))


def _x(rs, *shape):
    return torch.as_tensor(rs.rand(*shape).astype(np.float32))


def _probe_problem():
    rs = np.random.RandomState(11)
    X = rs.randn(60, 8).astype(np.float32)
    y = (X @ rs.randn(8, 3)).argmax(1)
    W0 = (0.3 * rs.randn(8, 3)).astype(np.float32)
    b0 = (0.1 * rs.randn(3)).astype(np.float32)
    return X[:45], y[:45], X[45:], y[45:], W0, b0


def _probe_state():
    Xtr, ytr, Xva, yva, W0, b0 = _probe_problem()
    W, b = torch.tensor(W0), torch.tensor(b0)
    state = dict(W=W, b=b, mW=torch.zeros_like(W), vW=torch.zeros_like(W),
                 mb=torch.zeros_like(b), vb=torch.zeros_like(b),
                 best_W=W.clone(), best_b=b.clone(),
                 best_loss=torch.tensor(float("inf")),
                 no_improve=torch.zeros((), dtype=torch.int64),
                 step=torch.zeros((), dtype=torch.int64))
    ytr_t = torch.as_tensor(ytr.astype(np.int64))
    bc = torch.stack([1 - torch.tensor(0.9) ** torch.arange(1.0, 9.0),
                      1 - torch.tensor(0.999) ** torch.arange(1.0, 9.0)])
    return (state, torch.as_tensor(Xtr),
            torch.nn.functional.one_hot(ytr_t, 3).float(),
            torch.as_tensor(Xva), torch.as_tensor(yva.astype(np.int64)), bc)


def _case(name):
    """(fn, args, kwargs, n_keys, is_update) of a replayed body at a small
    size, as its caller passes them (the keys added by the caller):
    n_keys None (no key), 0 (one key) or the number of shell keys."""
    rs = np.random.RandomState(sum(map(ord, name)))
    joint = _w(rs, DZ + K, HJ, momentum=True)
    jw = rbm_ops.weights_only(joint)
    img = [_w(rs, D, 16), _w(rs, 16, DZ)]
    imgw = [rbm_ops.weights_only(s) for s in img]
    x = (_x(rs, B, D) > 0.6).float()
    z = _x(rs, B, DZ)
    y = torch.as_tensor(np.eye(K, dtype=np.float32)[rs.randint(0, K, B)])
    v = torch.cat([z, y], 1)
    km = torch.cat([torch.ones(B, DZ), torch.zeros(B, K)], 1)
    zcm = _x(rs, K, DZ)
    hyper = (0.1, 0.5)
    train = dict(groups=GROUPS, sr=None, weight_decay=1e-4, cd=2,
                 sparsity=False, sparsity_factor=0.05)
    clamp = dict(weight_decay=1e-4, cd=1, cond_init_steps=3, sample_h=False,
                 sample_v=False, aux_lr_mult=0.3, use_noisy_init=True,
                 eta0=0.15, groups=GROUPS, sr=None)
    cross = dict(steps=3, Dz=DZ, groups=GROUPS, use_free_energy=False,
                 direction="both")
    if name.startswith("joint_batch"):
        warmup, zclamp, metrics = (name == "joint_batch_warmup",
                                   name == "joint_batch_zclamp", True)
        n = 2 + int(zclamp) + int(metrics)
        return (timdbn._joint_batch_step,
                (joint, imgw, x, y, hyper, zcm, None, None),
                dict(warmup=warmup, zclamp=zclamp, metrics=metrics, Dz=DZ,
                     K=K, train=train, clamp=clamp, cross=cross), n, True)
    if name.startswith("bimodal_batch"):
        m1, m2 = [_w(rs, D, 8)], [_w(rs, 30, 6)]
        layers = [_w(rs, 14, 10, momentum=True), _w(rs, 10, 5)]
        v1 = (_x(rs, B, D) > 0.5).float()
        v2 = (_x(rs, B, 30) > 0.5).float()
        return (tbim._bimodal_batch_step,
                (layers, [rbm_ops.weights_only(s) for s in m1],
                 [rbm_ops.weights_only(s) for s in m2], v1, v2, hyper),
                dict(weight_decay=1e-4, warmup=name.endswith("warmup"),
                     joint_cd=1, aux_cond_steps=2, Dz1=8, steps=2,
                     compute_metrics=True, sr=None), 0, True)
    if name == "public_idbn_batch_step":
        return (dbn_train._idbn_step_at,
                (img, x, hyper, 1e-4, 0.05),
                dict(cd=2, sparsity_flags=(False, True), compute_dtype=None,
                     sr=None, fast_sampler=True), 0, False)
    if name == "public_joint_train_batch_step":
        return (imdbn_ops._joint_step_at,
                (joint, imgw, z, y, x, hyper, 1e-4, zcm),
                dict(b_idx=0, warmup=False, joint_cd=1, aux_cond_steps=2,
                     Dz=DZ, steps=3, groups=GROUPS, use_free_energy=False,
                     zclamp_every=50, compute_metrics=True, sr=None), 0,
                False)
    if name == "public_bimodal_batch_step":
        layers = [_w(rs, 14, 10, momentum=True), _w(rs, 10, 5)]
        return (bimodal_ops._bimodal_step_at,
                (layers, [_w(rs, D, 8)], [_w(rs, 30, 6)], _x(rs, B, 8),
                 _x(rs, B, 6), (_x(rs, B, D) > 0.5).float(),
                 (_x(rs, B, 30) > 0.5).float(), hyper, 1e-4),
                dict(warmup=False, joint_cd=1, aux_cond_steps=2, Dz1=8,
                     steps=2, compute_metrics=True, sr=None), 0, False)
    table = {
        "probe_chunk": (tpu._probe_chunk, _probe_state(), dict(
            steps=5, max_steps=8, lr=5e-2, weight_decay=0.0, patience=2,
            min_delta=0.0, b1=0.9, b2=0.999, eps=1e-8), None, True),
        "idbn_batch": (tidbn._batch_step, (img, x, (0.1, 0.5, 0.1, 0.5)),
                       dict(layers=(dict(train, groups=()),
                                    dict(train, groups=(), sparsity=True))),
                       2, True),
        "shell_cd_update": (trbm._cd_update, (joint, v, hyper), train, 0,
                            True),
        "shell_clamped_cd_update": (
            trbm._clamped_cd_update, (joint, v, km, hyper, z[:, :DZ]),
            dict(clamp, reclamp_negative=True), 0, True),
        "shell_hidden_probs": (rbm_ops.hidden_probs, (jw, v, 1.0), {},
                               None, False),
        "shell_visible_probs": (rbm_ops.visible_probs, (jw, _x(rs, B, HJ),
                                                        1.5),
                                dict(groups=GROUPS), None, False),
        "shell_visible_logits": (rbm_ops.visible_logits,
                                 (jw, _x(rs, B, HJ)), {}, None, False),
        "shell_free_energy": (rbm_ops.free_energy, (jw, v), {}, None,
                              False),
        "shell_sample_visible": (trbm._sample_visible, (v,),
                                 dict(groups=GROUPS), 0, False),
        "shell_backward_sample": (trbm._backward_sample,
                                  (jw, _x(rs, B, HJ)), dict(groups=GROUPS),
                                  0, False),
        "shell_gibbs_step": (trbm._gibbs_step, (jw, v),
                             dict(sample_h=True, sample_v=True,
                                  groups=GROUPS), 0, False),
        "shell_conditional_gibbs": (
            trbm._conditional_gibbs, (jw, v, km),
            dict(n_steps=3, sample_h=True, sample_v=True, groups=GROUPS), 0,
            False),
        "shell_conditional_gibbs_meanfield": (
            trbm._conditional_gibbs, (jw, v, km),
            dict(n_steps=3, sample_h=False, sample_v=False, groups=GROUPS),
            0, False),
        "shell_conditional_gibbs_annealed": (
            trbm._conditional_gibbs_annealed, (jw, v, km),
            dict(n_steps=5, T0=2.5, T1=1.0, sample_h_until=2,
                 sample_v_every=2, final_meanfield=True, groups=GROUPS), 0,
            False),
        "shell_noisy_meanfield_annealed": (
            trbm._noisy_meanfield_annealed, (jw, v, 1.0 - km),
            dict(n_steps=6, T0=3.0, T1=1.0, sigma0=0.9, hot_frac=0.7,
                 sharpen_last=2, T_cold_plus=0.9, mu_k=zcm[y.argmax(1)],
                 eta0=0.15, groups=GROUPS), 0, False),
        "class_free_energies": (teu._class_free_energies, (jw, z),
                                dict(K=K, Dz=DZ), None, False),
        "img2txt_chain": (teu._img2txt_chain, (jw, z),
                          dict(Dz=DZ, K=K, steps=4), None, False),
        "img2txt_panel_chain": (tcs._img2txt_panel_chain, (jw,),
                                dict(z=z, steps=4, groups=GROUPS,
                                     sample_h=True, sample_v=True, Dz=DZ),
                                0, False),
        "txt2img_panel_chain": (tcs._txt2img_panel_chain, (jw, imgw),
                                dict(y_onehot=y, img_gt=x, z_init=z,
                                     steps=4, groups=GROUPS, sample_h=True,
                                     sample_v=False, Dz=DZ, ema_beta=0.3),
                                0, False),
        "traj_chain": (til._traj_chain, (jw,),
                       dict(v_cur=v, v_known=v, km=1.0 - km, steps=4,
                            groups=GROUPS, Dz=DZ), 0, False),
        "mod2_to_mod1_body": (tbim._mod2_to_mod1_body,
                              (rbm_ops.weights_only(_w(rs, 14, 10)),
                               _x(rs, B, 6)), dict(steps=4, Dz1=8), 0,
                              False),
        "joint_bias_stats": (imdbn_ops.joint_bias_stats, (z, y),
                             dict(num_classes=K), None, False),
    }
    return table[name]


CASES = ["probe_chunk", "idbn_batch", "joint_batch_warmup", "joint_batch",
         "joint_batch_zclamp", "bimodal_batch", "bimodal_batch_warmup",
         "shell_cd_update", "shell_clamped_cd_update", "shell_hidden_probs",
         "shell_visible_probs", "shell_visible_logits", "shell_free_energy",
         "shell_sample_visible", "shell_backward_sample", "shell_gibbs_step",
         "shell_conditional_gibbs", "shell_conditional_gibbs_meanfield",
         "shell_conditional_gibbs_annealed",
         "shell_noisy_meanfield_annealed", "class_free_energies",
         "img2txt_chain", "img2txt_panel_chain", "txt2img_panel_chain",
         "traj_chain", "mod2_to_mod1_body", "joint_bias_stats",
         "public_idbn_batch_step", "public_joint_train_batch_step",
         "public_bimodal_batch_step"]
KEYED = [c for c in CASES if _case(c)[3] is not None]


def _keys(n_keys, seed):
    if n_keys == 0:
        return rng.fold_in(seed, 1)
    return tuple(rng.fold_in(seed, 10 + i) for i in range(n_keys))


def _body_key(n_keys):
    return rng.Key() if n_keys == 0 else rng.root_keys(n_keys)


def _run(case, key, table=None):
    fn, args, kwargs, n_keys, _ = _case(case)
    if n_keys is None:
        return fn(*args, **kwargs)
    if table is None:
        return fn(*args, key=key, **kwargs)
    with rng.key_table(table):
        return fn(*args, key=_body_key(n_keys), **kwargs)


def _leaves_equal(a, b):
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    assert sa == sb and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Host reads raise, except of the schedules that ``ops.schedules``
    computes on the host from Python numbers (a CPU tensor on the card
    too, read without a device synchronisation)."""
    names = ("item", "tolist", "__bool__", "__float__", "__int__", "numpy")
    real = {n: getattr(torch.Tensor, n) for n in names}

    def guard(name):
        def read(self, *a, **k):
            if getattr(self, "_host_schedule", False):
                return real[name](self, *a, **k)
            raise AssertionError("a replayed body read a tensor on the host")
        return read

    def marked(fn):
        def call(*a, **k):
            t = fn(*a, **k)
            t._host_schedule = True
            return t
        return call

    with monkeypatch.context() as m:
        for fname in ("lin_schedule", "steps_iota", "annealed_temperature",
                      "gibbs_annealed_temperature", "noise_sigma",
                      "mu_pull_eta"):
            m.setattr(schedules, fname, marked(getattr(schedules, fname)))
        for name in names:
            m.setattr(torch.Tensor, name, guard(name))
        yield


# (a) ----------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_replayed_body_reads_nothing_on_the_host(monkeypatch, case):
    n_keys = _case(case)[3]
    key = None if n_keys is None else _keys(n_keys, 3)
    with _no_host_reads(monkeypatch):
        out = _run(case, key, None if key is None
                   else rng.KeyTable(root=key))
    leaves, _ = graphs.flatten(out)
    assert leaves and all(torch.isfinite(t.float()).all() for t in leaves)


# (b) ----------------------------------------------------------------------

@pytest.mark.parametrize("case", KEYED)
def test_replayed_key_table_gives_the_bits_of_keys_by_value(case):
    n_keys = _case(case)[3]
    key = _keys(n_keys, 17)
    want = _run(case, key)
    by_value = rng.KeyTable(root=key)
    _leaves_equal(_run(case, key, by_value), want)
    assert by_value.paths
    if n_keys:
        assert {p[0] for p in by_value.paths} == set(range(n_keys))
    table = rng.KeyTable(torch.tensor(rng.key_values(key, by_value.paths)),
                         by_value.paths)
    _leaves_equal(_run(case, key, table), want)
    other = _run(case, _keys(n_keys, 18))
    assert not all(torch.equal(a, b) for a, b in zip(
        graphs.flatten(other)[0], graphs.flatten(want)[0]))


# (c) ----------------------------------------------------------------------

@pytest.mark.parametrize("check_every", [7, 25, 300])
def test_probe_chunks_give_the_step_by_step_bits(check_every):
    """Chunks of 7, 25 and all 300 steps (and one host read each) end in
    the (W, b) and accuracy of one step at a time; JAX's probe from the
    same initial weights is held by
    tests/test_torch_diagnostics.py::test_linear_probe_matches_jax."""
    Xtr, ytr, Xva, yva, W0, b0 = _probe_problem()

    def fit(ce):
        return tpu.train_linear_classifier(
            Xtr, ytr, Xva, yva, n_classes=3, max_steps=300, lr=5e-2,
            patience=20, init=(W0, b0), check_every=ce)

    def best(ce):
        return tpu.fit_linear_probe(
            *(torch.as_tensor(a) for a in (Xtr, ytr.astype(np.int64), Xva,
                                           yva.astype(np.int64))),
            torch.tensor(W0), torch.tensor(b0), max_steps=300, lr=5e-2,
            patience=20, check_every=ce)

    assert fit(check_every) == fit(1)
    for a, b in zip(best(check_every), best(1)):
        assert torch.equal(a, b)


def test_probe_reads_the_condition_once_a_chunk(monkeypatch):
    calls = []
    real = graphs.update

    def counting(owner, device, fn, key, state, *a, **kw):
        calls.append(kw["steps"])
        return real(owner, device, fn, key, state, *a, **kw)

    monkeypatch.setattr(graphs, "update", counting)
    Xtr, ytr, Xva, yva, W0, b0 = _probe_problem()
    tpu.train_linear_classifier(Xtr, ytr, Xva, yva, n_classes=3,
                                max_steps=60, lr=5e-2, patience=1000,
                                init=(W0, b0), check_every=25)
    assert calls == [25, 25, 25]        # the last chunk masked past 60
    calls.clear()
    tpu.train_linear_classifier(Xtr, ytr, Xva, yva, n_classes=3,
                                max_steps=300, lr=5e-2, patience=0,
                                init=(W0, b0), check_every=25)
    assert calls == []                  # inactive before the first step


# (d) ----------------------------------------------------------------------

class _FakeGraph:
    def replay(self):
        pass


@pytest.fixture
def stand_ins(monkeypatch):
    """A launch counter and the CUDA calls of a capture replaced by
    stand-ins that run on the CPU (a stand-in replay runs nothing), and a
    cache on the CPU that every routed call of a test takes."""
    lib = _cuda.CudaLibrary.__new__(_cuda.CudaLibrary)
    lib.source = _cuda.CSRC / "fake.cu"
    lib.functions = {"k": []}
    lib.launches_by_entry = {"k": 0}
    monkeypatch.setattr(_cuda, "LIBRARIES", [lib])

    class Stream:
        def wait_stream(self, other):
            pass

    for name, fn in (("Stream", lambda *a: Stream()),
                     ("current_stream", lambda *a: Stream()),
                     ("stream", lambda s: contextlib.nullcontext()),
                     ("graph", lambda g, **k: contextlib.nullcontext()),
                     ("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("memory_reserved", lambda *a: 0),
                     ("CUDAGraph", _FakeGraph)):
        monkeypatch.setattr(torch.cuda, name, fn)
    caches = {}

    def cache_of(owner, device):
        c = caches.get(id(owner))
        if c is None:
            c = caches[id(owner)] = graphs.ServingGraphs.__new__(
                graphs.ServingGraphs)
            c.device = torch.device("cpu")
            c.graphs, c.buffers = {}, graphs._Buffers()
        return c

    monkeypatch.setattr(graphs, "_cache", cache_of)
    graphs.reset_stats()
    yield lib, cache_of
    graphs.reset_stats()


def test_update_graph_writes_the_state_in_place(stand_ins):
    lib, cache_of = stand_ins
    owner = graphs.Owner()

    def step(state, x, *, key, scale):
        lib.launches_by_entry["k"] += 1
        u = rng.uniform(rng.fold_in(key[1], 2), x.shape, "cpu")
        return ({"w": state["w"] + scale * x.sum() + u.sum(),
                 "n": state["n"] + 1}, (x.sum(),))

    state = {"w": torch.zeros(2, 2), "n": torch.zeros(())}
    first = dict(state)
    x = torch.ones(3)
    seen = []
    for i in range(3):
        state, outs = graphs.update(owner, "cuda", step, (5, 6 + i), state,
                                    x, scale=2.0)
        seen.append((id(state["w"]), state["w"]._version))
    cache = cache_of(owner, "cuda")
    assert len(cache.graphs) == 1
    assert graphs.STATS["replays"]["step:step"] == 3
    assert lib.launches_by_entry["k"] == 3
    assert graphs.STATS["warmup_launches"] == {"fake.cu:k": 1}
    g = next(iter(cache.graphs.values()))
    assert g.n_keys == 2 and g.paths == [(1, 2)]
    assert g.keys.tolist() == rng.key_values((5, 8), [(1, 2)])
    # the caller's tensors untouched; the state is the buffers, written by
    # the capture (a stand-in replay writes nothing) with versions moved
    assert torch.equal(first["w"], torch.zeros(2, 2))
    assert len({i for i, _ in seen}) == 1
    assert seen[0][1] < seen[1][1] < seen[2][1]
    assert state["w"] is cache.buffers.bufs[g.slots[0]]
    assert float(state["n"]) == 1.0
    # handed back, nothing is copied (each buffer is its own source at
    # its version); other tensors are copied in
    for i, t in zip(g.slots[:2], graphs.flatten(state)[0]):
        ref, version = cache.buffers.src[i]
        assert ref() is t and version == t._version
        assert cache.buffers._same(i, t)
    new = {"w": torch.full((2, 2), 3.0), "n": torch.zeros(())}
    out, _ = graphs.update(owner, "cuda", step, (5, 6), new, x, scale=2.0)
    assert out["w"] is state["w"] and (out["w"] == 3.0).all()
    # a pure graph of the same cache reads the state's buffer
    graphs.serve(owner, "cuda", lambda w: w * 2, None, out["w"])
    assert sum(b.shape == (2, 2) for b in cache.buffers.bufs) == 1
    # another static is another graph; a missing key raises
    graphs.update(owner, "cuda", step, (5, 6), out, x, scale=1.0)
    assert len(cache.graphs) == 3
    with pytest.raises(ValueError, match="called with keys"):
        graphs.update(owner, "cuda", step, 5, out, x, scale=1.0)


def test_a_state_leaf_fed_twice_gets_two_buffers(stand_ins):
    _, cache_of = stand_ins
    owner = graphs.Owner()
    z = torch.zeros(3)
    state, _ = graphs.update(owner, "cuda",
                             lambda s, *, key: ((s[0] + 1, s[1] + 2), ()),
                             1, (z, z))
    assert state[0] is not state[1]
    assert state[0].tolist() == [1.0] * 3 and state[1].tolist() == [2.0] * 3


# (e) ----------------------------------------------------------------------

def _written_twice(get_state, call):
    """Two calls; the state the second hands back is the first's objects
    with their versions moved, and a buffer holding a copy of them is
    refreshed."""
    call()
    leaves = graphs.flatten(get_state())[0]
    before = [(id(t), t._version) for t in leaves]
    bufs = graphs._Buffers()
    slots = [bufs.slot(t) for t in leaves]
    for i in slots:
        bufs.bufs[i].fill_(-7.0)
    call()
    after = graphs.flatten(get_state())[0]
    assert [id(t) for t in after] == [i for i, _ in before]
    assert all(t._version > v for t, (_, v) in zip(after, before))
    bufs.load(slots, after)
    assert all(not (bufs.bufs[i] == -7.0).all() for i in slots)


def test_routed_steps_move_the_state_versions(stand_ins):
    """The counterpart of tests/test_torch_serving.py::
    test_epoch_replays_move_the_state_versions for the per-batch steps of
    the three families and the shell's training entries."""
    m = small_imdbn()
    r = m.joint_rbm
    v = torch.rand(16, r.num_visible)
    _written_twice(lambda: r.state,
                   lambda: r.train_epoch(v, 0, 2, CD=1))
    km = torch.cat([torch.zeros(16, m.Dz_img), torch.ones(16, 4)], 1)
    _written_twice(lambda: r.state,
                   lambda: r.train_epoch_clamped(v, km, 0, 2, CD=1,
                                                 cond_init_steps=2))
    _written_twice(m.image_idbn.states,
                   lambda: m.image_idbn.train(1, fused=False))
    _written_twice(lambda: m.joint_rbm.state,
                   lambda: m.train_joint(1, fused=False))
    b = small_bimodal()
    _written_twice(b._joint_states, lambda: b.train_joint(1, fused=False))
    assert graphs.STATS["replays"]["step:_batch_step"] == 2 * 3
    assert graphs.STATS["replays"]["step:_joint_batch_step"] == 2 * 3
    assert graphs.STATS["replays"]["step:_bimodal_batch_step"] == 2 * 3


# (f) ----------------------------------------------------------------------

def _shell(groups=True, seed=3):
    r = trbm.RBM(DZ + K, HJ, 0.1, 1e-4, 0.5, dynamic_lr=True,
                 softmax_groups=[GROUPS[0]] if groups else None, seed=seed,
                 device="cpu")
    r.state = _w(np.random.RandomState(seed), DZ + K, HJ, momentum=True)
    return r


def _entries(r):
    """(entry name, call on the shell, keys it draws, the rbm_ops
    function of its key (None: it draws none)) for every jitted entry."""
    rs = np.random.RandomState(9)
    v = torch.as_tensor(rs.rand(B, DZ + K).astype(np.float32))
    h = torch.as_tensor(rs.rand(B, HJ).astype(np.float32))
    km = torch.cat([torch.ones(B, DZ), torch.zeros(B, K)], 1)
    g = r._groups()
    st = r.state
    return [
        ("forward", lambda: r.forward(v), None,
         lambda k: rbm_ops.hidden_probs(st, v)),
        ("visible_probs", lambda: r.visible_probs(h, 2.0), None,
         lambda k: rbm_ops.visible_probs(st, h, 2.0, groups=g)),
        ("backward_logits", lambda: r.backward(h, return_logits=True), None,
         lambda k: rbm_ops.visible_logits(st, h)),
        ("free_energy", lambda: r.free_energy(v), None,
         lambda k: rbm_ops.free_energy(st, v)),
        ("sample_visible", lambda: r.sample_visible(v), 1,
         lambda k: trbm.sampling.sample_visible(k, v, g)),
        ("backward_sample", lambda: r.backward_sample(h), 1,
         lambda k: trbm.sampling.sample_visible(
             k, rbm_ops.visible_probs(st, h, groups=g), g)),
        ("gibbs_step", lambda: r.gibbs_step(v), 1,
         lambda k: rbm_ops.gibbs_step(st, k, v, groups=g)),
        ("conditional_gibbs", lambda: r.conditional_gibbs(v, km, 4), 1,
         lambda k: rbm_ops.conditional_gibbs(st, k, v, km, n_steps=4,
                                             groups=g)),
        ("conditional_gibbs_annealed",
         lambda: r.conditional_gibbs_annealed(v, km, 6, sample_h_until=3),
         1, lambda k: rbm_ops.conditional_gibbs_annealed(
             st, k, v, km, n_steps=6, sample_h_until=3, groups=g)),
        ("noisy_meanfield_annealed",
         lambda: r.noisy_meanfield_annealed(v, 1.0 - km, 8), 1,
         lambda k: rbm_ops.noisy_meanfield_annealed(
             st, k, v, 1.0 - km, n_steps=8, groups=g)),
        ("train_epoch", lambda: r.train_epoch(v, 3, 10, CD=2), 1,
         lambda k: trbm.fast_cd.cd_update(
             st, k, v, groups=g, sr=None,
             lr=trbm.effective_lr(r.lr, 3, True),
             mom=trbm.effective_momentum(0.5, 0.97, 3), weight_decay=1e-4,
             cd=2, sparsity=False, sparsity_factor=0.05)[1]),
        ("train_epoch_clamped",
         lambda: r.train_epoch_clamped(v, km, 3, 10, cond_init_steps=3), 1,
         lambda k: rbm_ops.clamped_cd_update(
             st, k, v, km, lr=trbm.effective_lr(r.lr, 3, True),
             mom=trbm.effective_momentum(0.5, 0.97, 3), weight_decay=1e-4,
             cond_init_steps=3, groups=g)[1]),
    ]


ENTRIES = [e[0] for e in _entries(_shell())]


@pytest.mark.parametrize("entry", ENTRIES)
def test_shell_key_stream_advances_as_before(entry):
    r = _shell()
    _, call, draws, direct = next(e for e in _entries(r) if e[0] == entry)
    start = r._gen.get_state()
    got = call()
    after = r._gen.get_state()
    twin = torch.Generator()
    twin.set_state(start)
    key = rng.next_key(twin) if draws else None
    assert torch.equal(twin.get_state(), after)   # exactly ``draws`` keys
    _leaves_equal(got, direct(key))


# (g) ----------------------------------------------------------------------

def _jax_shell(r):
    j = JRBM(r.num_visible, r.num_hidden, r.lr, r.weight_decay, r.momentum,
             dynamic_lr=r.dynamic_lr, softmax_groups=r.softmax_groups,
             seed=0)
    j.state = jax_state({f: getattr(r.state, f).numpy()
                         for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m")})
    return j


@pytest.mark.parametrize("entry", ENTRIES)
def test_shell_entries_match_jax(monkeypatch, entry):
    r = _shell()
    j = _jax_shell(r)
    jr_entries = _entries(j)
    with both_deterministic(monkeypatch):
        got = next(e for e in _entries(r) if e[0] == entry)[1]()
        want = next(e for e in jr_entries if e[0] == entry)[1]()
    la, _ = graphs.flatten(got)
    lb = want if isinstance(want, tuple) else (want,)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        close(a, np.asarray(b), 1e-5)
    if entry.startswith("train"):
        for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m"):
            close(getattr(r.state, f), np.asarray(getattr(j.state, f)),
                  1e-5)


def test_bimodal_trajectory_chain_matches_jax(monkeypatch):
    from multimodal_idbn_tpu.models import iMDBN_BiModal as JBiModal
    tm = small_bimodal()
    train, val, _ = small_loaders(bimodal=True)
    jm = JBiModal([256, 32], [1568, 32], [16], dict(tm.params), train, val,
                  seed=0)
    f = {k: getattr(tm.joint_rbm.state, k).numpy()
         for k in ("w", "hb", "vb", "w_m", "hb_m", "vb_m")}
    jm.joint_rbm.state = jax_state(f)
    # one sample, as the trajectory loggers pass it
    z2 = np.random.RandomState(2).rand(1, tm.Dz_mod2).astype(np.float32)
    with both_deterministic(monkeypatch):
        got = tbim._mod2_to_mod1_chain(tm, torch.as_tensor(z2), 5)
        want = jax_mod2_to_mod1_chain(jm, z2, 5)
    for a, b in zip(got, want):
        close(a, np.asarray(b), 1e-5)
    assert got[0].shape == (6, 16) and got[1].shape == (6, tm.Dz_mod1)


@pytest.mark.parametrize("case", ["public_idbn_batch_step",
                                  "public_joint_train_batch_step",
                                  "public_bimodal_batch_step"])
def test_public_batch_steps_are_their_bodies_on_the_cpu(case):
    """The jitted per-batch steps JAX exports, called directly on the CPU,
    give the bits of their bodies (the epochs' ``_idbn_batch_step``,
    ``_joint_train_batch`` and ``_bimodal_train_batch``) and make no
    graph."""
    fn, args, kw, _, _ = _case(case)
    key = rng.fold_in(4, 2)
    if case == "public_idbn_batch_step":
        states, x, (lr, mom), wd, sf = args
        got = dbn_train.idbn_batch_step(states, key, x, lr, mom, wd, sf,
                                        **kw)
        want = dbn_train._idbn_batch_step(states, key, x, lr, mom, wd, sf,
                                          **kw)
    elif case == "public_joint_train_batch_step":
        joint, imgw, z, y, x, (lr, mom), wd, zcm = args
        got = imdbn_ops.joint_train_batch_step(
            joint, imgw, key, z, y, x, 50, lr, mom, wd, zcm,
            **{k: v for k, v in kw.items() if k != "b_idx"})
        want = imdbn_ops._joint_train_batch(joint, imgw, key, z, y, x, 50,
                                            lr, mom, wd, zcm,
                                            **{k: v for k, v in kw.items()
                                               if k != "b_idx"})
    else:
        j, m1, m2, z1, z2, v1, v2, (lr, mom), wd = args
        got = bimodal_ops.bimodal_batch_step(j, m1, m2, key, z1, z2, v1, v2,
                                             lr, mom, wd, **kw)
        want = bimodal_ops._bimodal_train_batch(j, m1, m2, key, z1, z2, v1,
                                                v2, lr, mom, wd, **kw)
    _leaves_equal(got, want)
    assert "_serving" not in graphs.SHARED.__dict__


# (h) ----------------------------------------------------------------------

def test_cpu_makes_no_graph():
    m = small_imdbn()
    m.image_idbn.train(1, fused=False)
    m.train_joint(1, fused=False)
    r = m.joint_rbm
    r.forward(torch.rand(2, r.num_visible))
    r.train_epoch(torch.rand(2, r.num_visible), 0, 1)
    tpu.fit_linear_probe(torch.rand(8, 3), torch.arange(8) % 2,
                         torch.rand(4, 3), torch.arange(4) % 2,
                         torch.zeros(3, 2), torch.zeros(2), max_steps=5)
    for owner in (m, m.image_idbn, r, graphs.SHARED,
                  *m.image_idbn.layers):
        assert "_serving" not in owner.__dict__
