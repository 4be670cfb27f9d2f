"""The serving calls that the card replays as CUDA graphs, on the CPU.

The JAX package jits each serving call (``imdbn_ops.cross_reconstruct``
and ``sample_txt2img``, ``bimodal_ops.bimodal_cross_reconstruct`` and
``sample_cross``, ``dbn_train.dbn_represent``, ``dbn_decode``,
``dbn_decode_sampled`` and ``dbn_reconstruct``); the port replays each as
one graph on a CUDA device (``graphs.ServingGraphs``). Here, where no
graph can run:

- (a) every serving body runs with ``Tensor.item``, ``tolist``,
  ``__bool__``, ``__float__``, ``__int__`` and ``numpy`` raising: it reads
  nothing on the host;
- (b) a body reading its keys from an int64 table (as a replay does)
  gives the bits of the same call with its key by value (as launch by
  launch), under real draws;
- (c) the buffers a graph reads are refreshed exactly when the tensor
  feeding them changed (another object, or the same one written in
  place), shared between the graphs of one model, and never fed two
  tensors at once;
- (d) the cache with the CUDA calls replaced by stand-ins: one capture per
  signature (function, shapes, static arguments), the capture's launches
  counted once per replay, the key table filled from the call's key, and
  a capture record with the fields of an epoch runner's, plus the shapes;
- (e) on the CPU the models' serving methods run launch by launch and
  equal the ops they wrap with the same keys; a graph on the CPU raises.

Tolerances: bit-equality throughout (the same arithmetic on the same
inputs).
"""

import contextlib

import numpy as np
import pytest
import torch

from multimodal_idbn_tpu_torch.ops import (bimodal_ops, dbn_train, graphs,
                                           imdbn_ops, rbm_ops, rng)

from torch_parity import (graph_stand_ins, np_state, small_bimodal,
                          small_imdbn, torch_state)

DZ, K, HJ, D, B = 12, 4, 10, 40, 6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(rs, v, h):
    return rbm_ops.weights_only(torch_state(np_state(rs, v, h)))


def _flagship():
    rs = np.random.RandomState(5)
    img = [_weights(rs, D, 16), _weights(rs, 16, DZ)]
    joint = _weights(rs, DZ + K, HJ)
    z = torch.as_tensor(rs.rand(B, DZ).astype(np.float32))
    y = torch.as_tensor(np.eye(K, dtype=np.float32)[rs.randint(0, K, B)])
    zcm = torch.as_tensor(rs.rand(K, DZ).astype(np.float32))
    return joint, img, z, y, zcm


def _bimodal():
    rs = np.random.RandomState(6)
    m1, m2 = [_weights(rs, D, 8)], [_weights(rs, 30, 6)]
    joint = _weights(rs, 14, 10)
    z1 = torch.as_tensor(rs.rand(B, 8).astype(np.float32))
    z2 = torch.as_tensor(rs.rand(B, 6).astype(np.float32))
    return joint, m1, m2, z1, z2


def _call(case):
    """(fn, args, kwargs, keyed) of a serving call at a small size, as the
    models pass them (the key added by the caller)."""
    if case.startswith("cross") or case == "sample_txt2img":
        joint, img, z, y, zcm = _flagship()
        groups = ((DZ, DZ + K),)
        if case == "sample_txt2img":
            return (imdbn_ops.sample_txt2img, (joint, img),
                    dict(y_onehot=y, steps=3, Dz=DZ, groups=groups,
                         z_affine=(torch.full((DZ,), 2.0),
                                   torch.full((DZ,), 0.1))), True)
        direction = case.split("_")[1]
        return (imdbn_ops.cross_reconstruct, (joint, img),
                dict(z_img=z, y_onehot=y, steps=3, Dz=DZ, groups=groups,
                     z_class_mean=zcm, z_affine=None,
                     use_free_energy=direction == "fe",
                     direction="both" if direction == "fe" else direction),
                True)
    if case.startswith("bimodal") or case.startswith("sample_cross"):
        joint, m1, m2, z1, z2 = _bimodal()
        direction = case.split("_")[-1]
        fn = (bimodal_ops.bimodal_cross_reconstruct
              if case.startswith("bimodal") else bimodal_ops.sample_cross)
        return (fn, (joint, m1, m2),
                dict(z1=z1, z2=z2, steps=3, Dz1=8, direction=direction),
                True)
    joint, img, z, y, zcm = _flagship()
    x = torch.as_tensor((np.random.RandomState(7).rand(B, D) > 0.6)
                        .astype(np.float32))
    return {
        "dbn_represent": (dbn_train.dbn_represent, (img, x), dict(upto=2),
                          False),
        "dbn_decode": (dbn_train.dbn_decode, (img, z), {}, False),
        "dbn_reconstruct": (dbn_train.dbn_reconstruct, (img, x), {}, False),
        "dbn_decode_sampled": (dbn_train.dbn_decode_sampled, (img, z), {},
                               True),
    }[case]


CASES = ["cross_both", "cross_img2txt", "cross_txt2img", "cross_fe",
         "sample_txt2img", "bimodal_both", "bimodal_1to2", "bimodal_2to1",
         "sample_cross_1to2", "sample_cross_2to1", "dbn_represent",
         "dbn_decode", "dbn_reconstruct", "dbn_decode_sampled"]
KEYED = [c for c in CASES if _call(c)[3]]


def _run(fn, args, kwargs, keyed, key, table=None):
    if not keyed:
        return fn(*args, **kwargs)
    if table is None:
        return fn(*args, key=key, **kwargs)
    with rng.key_table(table):
        return fn(*args, key=rng.Key(), **kwargs)


def _leaves_equal(a, b):
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    assert sa == sb and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a serving body read a tensor on the host")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "__float__", "__int__",
                     "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        yield


# (a) ----------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_serving_body_reads_nothing_on_the_host(monkeypatch, case):
    fn, args, kwargs, keyed = _call(case)
    key = rng.fold_in(3, 1)
    with _no_host_reads(monkeypatch):
        out = _run(fn, args, kwargs, keyed, key,
                   rng.KeyTable(root=key) if keyed else None)
    leaves, _ = graphs.flatten(out)
    assert leaves and all(torch.isfinite(t).all() for t in leaves)


# (b) ----------------------------------------------------------------------

@pytest.mark.parametrize("case", KEYED)
def test_serving_key_table_gives_the_bits_of_keys_by_value(case):
    fn, args, kwargs, keyed = _call(case)
    key = rng.fold_in(17, 4)
    want = _run(fn, args, kwargs, keyed, key)
    by_value = rng.KeyTable(root=key)
    _leaves_equal(_run(fn, args, kwargs, keyed, key, by_value), want)
    assert by_value.paths
    table = rng.KeyTable(torch.tensor(rng.key_values(key, by_value.paths)),
                         by_value.paths)
    _leaves_equal(_run(fn, args, kwargs, keyed, key, table), want)
    other = _run(fn, args, kwargs, keyed, rng.fold_in(17, 5))
    assert not all(torch.equal(a, b) for a, b in zip(
        graphs.flatten(other)[0], graphs.flatten(want)[0]))


# (c) ----------------------------------------------------------------------

def test_buffers_refresh_exactly_what_changed():
    bufs = graphs._Buffers()
    w = torch.arange(6.0).reshape(2, 3)
    x = torch.ones(4)
    slots = [bufs.slot(w), bufs.slot(x)]
    assert bufs.slot(w) == slots[0] and len(bufs.bufs) == 2  # shared
    bufs.bufs[0].fill_(-1.0)           # would show any refresh
    bufs.load(slots, [w, x])           # nothing changed: no copy
    assert (bufs.bufs[0] == -1).all()
    w.add_(1.0)                        # in place: the version moves
    bufs.load(slots, [w, x])
    assert torch.equal(bufs.bufs[0], w)
    w2 = w.clone() * 3                 # a new object (training, a load)
    x2 = torch.full((4,), 7.0)
    bufs.load(slots, [w2, x2])
    assert torch.equal(bufs.bufs[0], w2) and torch.equal(bufs.bufs[1], x2)
    with pytest.raises(ValueError, match="two different tensors"):
        bufs.load([slots[0], slots[0]], [w2, w2.clone()])


# (d) ----------------------------------------------------------------------

@pytest.fixture
def stand_ins(monkeypatch):
    """A launch counter and the CUDA calls of a capture replaced by
    stand-ins that run on the CPU (a stand-in replay runs nothing)."""
    lib_cache = graph_stand_ins(monkeypatch)
    graphs.reset_stats()
    yield lib_cache
    graphs.reset_stats()


def test_one_capture_per_signature_launches_per_replay(stand_ins):
    lib, cache = stand_ins

    def body(w, x, *, key, scale):
        lib.launches_by_entry["k"] += 2
        u = rng.uniform(rng.fold_in(key, 1), x.shape, "cpu")
        return (x @ w) * scale + u.sum()

    w = torch.ones(3, 2)
    for rows in (128, 3, 1, 128, 3, 128):
        cache.call(body, rng.fold_in(5, rows), w, torch.ones(rows, 3),
                   scale=2.0)
    cache.call(body, 9, w, torch.ones(3, 3), scale=1.0)   # another static
    assert len(cache.graphs) == 4
    assert graphs.STATS["replays"]["serve:body"] == 7
    assert lib.launches_by_entry["k"] == 2 * 7
    assert graphs.STATS["warmup_launches"] == {"fake.cu:k": 2 * 4}
    assert [c["shapes"] for c in graphs.STATS["captures"]][:3] == [
        [(3, 2), (128, 3)], [(3, 2), (3, 3)], [(3, 2), (1, 3)]]
    g = cache.graphs[graphs._signature(
        body, *graphs.flatten(((w, torch.ones(3, 3)), dict(scale=1.0))))]
    assert g.paths == [(1,)] and g.keys.tolist() == rng.key_values(9, [(1,)])
    assert g.launches_per_replay == {("fake.cu", "k"): 2}
    # the weights are held once; new weights refresh that buffer
    assert sum(b.shape == (3, 2) for b in cache.buffers.bufs) == 1
    w2 = torch.full((3, 2), 4.0)
    cache.call(body, 1, w2, torch.ones(3, 3), scale=1.0)
    assert torch.equal(cache.buffers.bufs[g.slots[0]], w2)


@pytest.mark.parametrize("kind", ["call", "update"])
def test_capture_records_are_the_runners_plus_shapes(stand_ins, kind):
    """The epoch runner and the serving cache capture through one core:
    their ``STATS["captures"]`` records have the same fields, the cache's
    with the shapes of the call's tensors beside them."""
    lib, cache = stand_ins

    def body(consts, state, perm, lr, mom):
        lib.launches_by_entry["k"] += 1
        return state + lr, (state.sum(),)

    runner = graphs.EpochRunner("fake", body, (), {}, n_rows=4,
                                device="cpu", graphed=False)
    runner.graphed = True
    runner(torch.zeros(2, 2), rng.fold_in(1, 0), 0.1, 0.5)
    x = torch.ones(3, 2)
    if kind == "call":
        cache.call(lambda x, *, key: x * 2, 5, x)
    else:
        cache.update(lambda s, x, *, key: (s + x, (x.sum(),)), 5,
                     torch.zeros(3, 2), x)
    ran, served = graphs.STATS["captures"]
    assert list(ran) == ["name", "seconds", "pool_bytes", "launches"]
    assert list(served) == ["name", "seconds", "pool_bytes", "shapes",
                            "launches"]
    assert ran["name"] == "fake" and ran["launches"] == {"fake.cu:k": 1}
    assert served["shapes"] == [(3, 2)] * (1 if kind == "call" else 2)
    assert served["name"] == {"call": "serve:<lambda>",
                              "update": "step:<lambda>"}[kind]


# (e) ----------------------------------------------------------------------

def test_cpu_models_serve_launch_by_launch():
    """The models' serving methods on the CPU are the ops they wrap, with
    the keys the JAX models derive (a seed: ``fold_in(seed, 0)``; none:
    the joint RBM's stream), and make no graph; a graph on the CPU
    raises."""
    m = small_imdbn()
    img, y = next(iter(m.val_loader))
    labels = np.arange(5) % 4
    y1 = torch.as_tensor(np.eye(4, dtype=np.float32)[labels])
    want = imdbn_ops.sample_txt2img(
        m.joint_rbm.state, m.image_idbn.states(), rng.fold_in(3, 0), y1,
        steps=m.cross_steps, Dz=m.Dz_img, groups=m._joint_groups())[0]
    assert torch.equal(m.sample_txt2img(labels, seed=3), want)
    gen = m.joint_rbm._gen.get_state()
    got = m.txt2img(labels)
    m.joint_rbm._gen.set_state(gen)
    want = imdbn_ops.cross_reconstruct(
        m.joint_rbm.state, m.image_idbn.states(), m.joint_rbm._next_key(),
        torch.zeros(5, m.Dz_img), y1, steps=m.cross_steps, Dz=m.Dz_img,
        groups=m._joint_groups(), z_class_mean=m.z_class_mean,
        direction="txt2img")[0]
    assert torch.equal(got, want)
    assert torch.equal(m.represent((img, y)), m.joint_rbm.forward(
        torch.cat([dbn_train.dbn_represent(
            m.image_idbn.states(), torch.as_tensor(img).reshape(
                len(img), -1).float(), 2), torch.as_tensor(y)], 1)))
    b = small_bimodal()
    m1, m2 = next(iter(b.val_loader))
    z1 = b.mod1_dbn.represent(m1)
    want = bimodal_ops.sample_cross(
        b.joint_rbm.state, b.mod1_dbn.states(), b.mod2_dbn.states(),
        rng.fold_in(4, 0), z1, torch.zeros(len(z1), b.Dz_mod2),
        steps=b.cross_steps, Dz1=b.Dz_mod1, direction="1to2")
    assert torch.equal(b.sample_mod1_to_mod2(m1, seed=4), want)
    for model in (m, m.image_idbn, b, b.mod1_dbn, b.mod2_dbn):
        assert "_serving" not in model.__dict__
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphs.ServingGraphs("cpu")


def test_epoch_replays_move_the_state_versions(stand_ins):
    """A graphed epoch writes its state buffers in place, so the model's
    weights stay the same objects from epoch to epoch: each replay must
    move their version counters, or a serving graph would keep serving the
    weights it copied before the epoch."""
    lib, _ = stand_ins

    def body(consts, state, perm, lr, mom):
        lib.launches_by_entry["k"] += 1
        return state + lr, (state.sum(),)

    runner = graphs.EpochRunner("fake", body, (), {}, n_rows=4,
                                device="cpu", graphed=False)
    runner.graphed = True
    state = torch.zeros(2, 2)
    seen = []
    for e in range(3):
        state, _ = runner(state, rng.fold_in(1, e), 0.1, 0.5)
        seen.append((id(state), state._version))
    assert len({i for i, _ in seen}) == 1          # the same buffer
    assert seen[0][1] < seen[1][1] < seen[2][1]    # written each epoch
    bufs = graphs._Buffers()
    slot = bufs.slot(state)
    bufs.bufs[slot].fill_(-1.0)
    runner(state, rng.fold_in(1, 3), 0.1, 0.5)
    bufs.load([slot], [state])
    assert not (bufs.bufs[slot] == -1).any()
