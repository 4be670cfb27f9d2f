"""The epoch bodies that the card replays as CUDA graphs, on the CPU.

- (a) every epoch body (the image iDBN under CD, PCD, bf16 storage with
  stochastic rounding and mixed precision; the iMDBN joint and the
  bimodal joint, warm-up and main) runs with ``Tensor.item``, ``tolist``,
  ``__bool__``, ``__float__``, ``__int__`` and ``numpy`` raising: it reads
  nothing on the host;
- (b) the bodies fed from buffers (the key table, lr and momentum as 0-d
  tensors, the permutation as an index tensor) give the bits of the same
  functions called with integer keys and Python floats, by value and
  from a key table alike, and the epoch functions stay equal to the JAX
  package's under the deterministic sampler;
- (c) the draws' plain versions equal ``rng.philox_uniform`` bit for bit
  and have the distributions they should;
- (d) the launch accounting of a graphed runner: the launches of the
  capture, times the replays; a capture computes no key table, so the
  first epoch of a runner and the first call of a serving graph compute
  one each.

Tolerances: bit-equality where the same arithmetic runs on the same
inputs; 1e-5 against JAX, as the other parity tests at small widths.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.ops import dbn_train as jdt
from multimodal_idbn_tpu_torch.ops import (bimodal_ops, dbn_train, graphs,
                                           imdbn_ops, philox_fill, rbm_ops,
                                           rng)

from torch_parity import (both_deterministic, close, graph_stand_ins,
                          jax_state, np_state, state_np, torch_state)

V, H1, H2, N, BS = 40, 24, 12, 44, 16     # two batches of 16 and 12 rows
DZ, K, HJ = 12, 4, 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(rows, cols, seed=0):
    rs = np.random.RandomState(seed)
    return torch.as_tensor((rs.rand(rows, cols) > 0.6).astype(np.float32))


def _stack(dtype=torch.float32, seed=1):
    rs = np.random.RandomState(seed)
    out = []
    for v, h in ((V, H1), (H1, H2)):
        st = torch_state(np_state(rs, v, h, momentum=True))
        out.append(rbm_ops.RBMState(*(getattr(st, f).to(dtype) for f in (
            "w", "hb", "vb", "w_m", "hb_m", "vb_m"))))
    return out


IDBN_KW = dict(weight_decay=1e-4, sparsity_factor=0.05, cd=2,
               sparsity_flags=(False, True), batch_size=BS)
IDBN_SETTINGS = {
    "cd": dict(dtype=torch.float32, fast_sampler=True),
    "pcd": dict(dtype=torch.float32, pcd=True, fast_sampler=True),
    "bf16-sr": dict(dtype=torch.bfloat16, fast_sampler=False),
    "bf16-sr-off": dict(dtype=torch.bfloat16, fast_sampler=False, sr=False),
    "mixed": dict(dtype=torch.float32, fast_sampler=False,
                  compute_dtype=torch.bfloat16),
}


def _idbn_case(name):
    s = dict(IDBN_SETTINGS[name])
    dtype = s.pop("dtype")
    states = _stack(dtype)
    chains = ([(_data(BS, v, 5 + v) > 0).to(dtype) for v in (V, H1)]
              if s.get("pcd") else None)
    runner = dbn_train.idbn_epoch_runner(_data(N, V), **IDBN_KW, **s)
    return runner, dict(states=states, chains=chains)


def _joint_case(warmup):
    rs = np.random.RandomState(3)
    Z = torch.as_tensor(rs.rand(N, DZ).astype(np.float32))
    Y = torch.as_tensor(np.eye(K, dtype=np.float32)[rs.randint(0, K, N)])
    img_states = [torch_state(np_state(rs, V, DZ))]
    X = torch.as_tensor((rs.rand(N, V) > 0.6).astype(np.float32))
    joint = torch_state(np_state(rs, DZ + K, HJ, momentum=True))
    runner = imdbn_ops.joint_epoch_runner(
        Z, Y, X, img_states, Z[:K].clone(), 1e-4, warmup=warmup,
        joint_cd=2, aux_cond_steps=3, Dz=DZ, steps=3,
        groups=((DZ, DZ + K),), zclamp_every=2, batch_size=BS)
    return runner, joint


def _bimodal_case(warmup):
    rs = np.random.RandomState(4)
    Z1 = torch.as_tensor(rs.rand(N, 8).astype(np.float32))
    Z2 = torch.as_tensor(rs.rand(N, 6).astype(np.float32))
    V1 = torch.as_tensor((rs.rand(N, V) > 0.6).astype(np.float32))
    V2 = torch.as_tensor((rs.rand(N, 30) > 0.6).astype(np.float32))
    m1 = [torch_state(np_state(rs, V, 8))]
    m2 = [torch_state(np_state(rs, 30, 6))]
    joint = [torch_state(np_state(rs, 14, 10, momentum=True)),
             torch_state(np_state(rs, 10, 5, momentum=True))]
    runner = bimodal_ops.bimodal_epoch_runner(
        Z1, Z2, V1, V2, m1, m2, 1e-4, warmup=warmup, joint_cd=2,
        aux_cond_steps=3, Dz1=8, steps=3, batch_size=BS)
    return runner, joint


CASES = ([("idbn", n) for n in IDBN_SETTINGS]
         + [("joint", w) for w in (True, False)]
         + [("bimodal", w) for w in (True, False)])


def _case(kind, arg):
    return {"idbn": _idbn_case, "joint": _joint_case,
            "bimodal": _bimodal_case}[kind](arg)


def _leaves_equal(a, b):
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an epoch body read a tensor on the host")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "__float__", "__int__",
                     "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        yield


# (a) ----------------------------------------------------------------------

@pytest.mark.parametrize("kind,arg", CASES)
def test_epoch_body_reads_nothing_on_the_host(monkeypatch, kind, arg):
    runner, state = _case(kind, arg)
    with _no_host_reads(monkeypatch):
        new, outs = runner(state, rng.fold_in(9, 3), 0.05, 0.5)
    leaves, _ = graphs.flatten((new, outs))
    assert leaves and all(torch.isfinite(t.float()).all() for t in leaves)


# (b) ----------------------------------------------------------------------

@pytest.mark.parametrize("kind,arg", CASES)
def test_key_table_gives_the_bits_of_keys_by_value(kind, arg):
    """The body reading its keys from an int64 table (as a captured graph
    does) gives the bits of the body taking them by value (as a launch by
    launch epoch does), under real draws."""
    runner, state = _case(kind, arg)
    key = rng.fold_in(11, 2)
    perm = rng.permutation(key, runner.n_rows)
    lr, mom = torch.tensor([0.05, 0.5], dtype=torch.float64)

    def run(table):
        with rng.key_table(table):
            return runner.body(runner.consts, state, perm, lr, mom,
                               **runner.statics)

    by_value = rng.KeyTable(root=key)
    want = run(by_value)
    assert by_value.paths
    keys = torch.tensor(rng.key_values(key, by_value.paths))
    table = rng.KeyTable(keys, by_value.paths)
    _leaves_equal(run(table), want)
    assert table.paths == by_value.paths
    _leaves_equal(runner(state, key, 0.05, 0.5), want)


def test_key_table_refuses_another_order():
    table = rng.KeyTable(torch.zeros(2, dtype=torch.int64), [(1,), (2,)])
    with rng.key_table(table):
        rng.uniform(rng.Key((1,)), (2, 3), "cpu")
        with pytest.raises(RuntimeError, match="recorded one"):
            rng.uniform(rng.Key((3,)), (2, 3), "cpu")
    with pytest.raises(RuntimeError, match="outside an epoch body"):
        rng.uniform(rng.Key((1,)), (2, 3), "cpu")


def test_key_values_are_fold_in():
    paths = [(), (3,), (3, 7), (987, 1, 2), (5,)]
    got = rng.key_values(123, paths)
    for p, v in zip(paths, got):
        want = 123
        for d in p:
            want = rng.fold_in(want, d)
        assert v & ((1 << 64) - 1) == want and -(1 << 63) <= v < 1 << 63


@pytest.mark.parametrize("name", ["cd", "pcd", "bf16-sr", "bf16-sr-off"])
def test_idbn_block_is_the_integer_keyed_loop(name):
    """``idbn_epoch_block`` / ``_pcd`` (keys from the epoch's key, lr and
    momentum as tensors, the data gathered by index) against the epoch's
    parts called with integer keys and Python floats: bit for bit, over
    two epochs across the momentum switch."""
    s = dict(IDBN_SETTINGS[name])
    dtype, pcd = s.pop("dtype"), s.pop("pcd", False)
    data = _data(N, V)
    kw = dict(IDBN_KW, **s)
    lrs, moms = [0.1 / 1.05, 0.1 / 1.06], [0.5, 0.9]
    states = _stack(dtype)
    chains = [(_data(BS, v, 5 + v) > 0).to(dtype) for v in (V, H1)]
    if pcd:
        got = dbn_train.idbn_epoch_block_pcd(states, chains, 7, data, [5, 6],
                                             lrs, moms, **kw)
    else:
        got = dbn_train.idbn_epoch_block(states, 7, data, [5, 6], lrs, moms,
                                         **kw)
    st, ch, sums = list(states), list(chains), []
    step_kw = {k: v for k, v in kw.items() if k != "batch_size"}
    for e, lr, mom in zip([5, 6], lrs, moms):
        key = rng.fold_in(7, e)
        d = data[rng.permutation(key, N)]
        if pcd:
            st, ch, losses = dbn_train.idbn_epoch_pcd(
                st, ch, key, d, lr=lr, mom=mom, batch_size=BS, **step_kw)
        else:
            st, losses = dbn_train.idbn_epoch(st, key, d, lr=lr, mom=mom,
                                              batch_size=BS, **step_kw)
        st, rl = dbn_train.idbn_batch_step(st, rng.fold_in(key, 987),
                                           d[N - N % BS:], lr=lr, mom=mom,
                                           **step_kw)
        sums.append(losses.sum() + rl.sum())
    want = (st, ch, sums) if pcd else (st, sums)
    _leaves_equal(got[:-1], want)
    assert got[-1] == [3 * 2] * 2


def test_idbn_block_matches_jax(monkeypatch):
    """``idbn_epoch_block`` equals JAX's under the deterministic sampler
    and the identity order, over two epochs."""
    rs = np.random.RandomState(2)
    f = [np_state(rs, V, H1), np_state(rs, H1, H2)]
    data = (rs.rand(N, V) > 0.6).astype(np.float32)
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n, *a, **k: jnp.arange(n))
    monkeypatch.setattr(rng, "permutation", lambda key, n: torch.arange(n))
    lrs, moms = [0.1, 0.09], [0.5, 0.5]
    with both_deterministic(monkeypatch):
        js, jsums, jcounts = jdt.idbn_epoch_block(
            tuple(jax_state(x) for x in f), jax.random.key(0),
            jnp.asarray(data), jnp.arange(2), jnp.asarray(lrs),
            jnp.asarray(moms), 1e-4, 0.05, cd=2,
            sparsity_flags=(False, True), batch_size=BS, n_epochs=2)
        ts, tsums, tcounts = dbn_train.idbn_epoch_block(
            [torch_state(x) for x in f], 0, torch.as_tensor(data), [0, 1],
            lrs, moms, 1e-4, 0.05, cd=2, sparsity_flags=(False, True),
            batch_size=BS, fast_sampler=True)
    for a, b in zip(ts, js):
        for k, v in state_np(b).items():
            close(state_np(a)[k], v, 1e-5)
    close(torch.stack(tsums) / torch.tensor(tcounts, dtype=torch.float32),
          np.asarray(jsums) / np.asarray(jcounts), 1e-5)


# (c) ----------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,row0", [(16, 40, 0), (1, 1, 0),
                                            (12, 2500, 116)])
def test_fill_plain_is_philox_uniform(rows, cols, row0):
    u = philox_fill.fill(5, rows, cols, device="cpu", row0=row0)
    want = rng.philox_uniform(5, rows, cols, stream=rng.STREAM_UNIFORM,
                              row0=row0)
    assert u.dtype == torch.float32 and torch.equal(u, want)
    bits = philox_fill.fill(5, rows, cols, device="cpu", row0=row0,
                            bits16=True)
    x0 = rng.philox_bits(5, rows, cols, stream=rng.STREAM_BITS, row0=row0)
    assert bits.dtype == torch.int32 and torch.equal(bits.long(), x0 >> 16)
    table = rng.KeyTable(torch.tensor([5]), [(4,)])
    with rng.key_table(table):
        assert torch.equal(philox_fill.fill(rng.Key((4,)), rows, cols,
                                            row0=row0), u)


def test_weak_bf16_scalar_rounds_as_torch():
    rs = np.random.RandomState(0)
    for x in list(rs.randn(2000) * 10.0 ** rs.randint(-6, 3, 2000)) + [
            0.0, 1e-4, 0.05, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, -0.0377]:
        assert rbm_ops._round_bf16(float(x)) == float(
            torch.tensor(float(x), dtype=torch.bfloat16))


def test_draws_have_their_distributions():
    u = rng.uniform(1, (400, 500), "cpu")
    assert 0 <= float(u.min()) and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 3e-3
    assert abs(float(u.var()) - 1 / 12) < 2e-3
    hist = torch.histc(u, bins=10, min=0, max=1) / u.numel()
    assert float((hist - 0.1).abs().max()) < 3e-3
    g = rng.gumbel(2, (400, 500), "cpu")
    assert abs(float(g.mean()) - 0.5772) < 1e-2
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 3e-2
    b = rng.random_bits16(3, (400, 500), "cpu")
    assert int(b.min()) >= 0 and int(b.max()) < 1 << 16
    assert abs(float(b.double().mean()) / (1 << 16) - 0.5) < 3e-3
    # different keys and streams are independent draws
    assert abs(float(torch.corrcoef(torch.stack([
        u.flatten(), rng.uniform(4, (400, 500), "cpu").flatten()]))[0, 1])) \
        < 1e-2
    x = torch.full((200_000,), 1.0 + 2 ** -9)       # halfway between bf16s
    r = rbm_ops.stochastic_round(7, x, torch.bfloat16).float()
    assert abs(float(r.mean()) - float(x[0])) < 2e-5


# (d) ----------------------------------------------------------------------

def test_graphed_runner_counts_capture_launches_per_replay(monkeypatch):
    """A graphed runner (the CUDA calls replaced by stand-ins that run the
    body on the CPU): the warm-up's launches leave the counts, the
    capture's are taken off and added once per replay, one replay per
    epoch."""
    lib, _ = graph_stand_ins(monkeypatch)

    def body(consts, state, perm, lr, mom):
        lib.launches_by_entry["k"] += 3
        u = rng.uniform(rng.fold_in(rng.Key(), 1), (2, 2), "cpu")
        return state + lr * u, (state.sum(),)

    runner = graphs.EpochRunner("fake", body, (), {}, n_rows=4,
                                device="cpu", graphed=False)
    runner.graphed = True
    graphs.reset_stats()
    state = torch.zeros(2, 2)
    for e in range(4):
        state, _ = runner(state, rng.fold_in(1, e), 0.1, 0.5)
    assert lib.launches_by_entry["k"] == 3 * 4
    assert runner.launches_per_replay == {("fake.cu", "k"): 3}
    assert runner.replays == 4 and graphs.STATS["replays"]["fake"] == 4
    assert graphs.STATS["warmup_launches"] == {"fake.cu:k": 3}
    (cap,) = graphs.STATS["captures"]
    assert cap["name"] == "fake" and cap["launches"] == {"fake.cu:k": 3}
    assert runner._paths == [(1,)] and runner._keys.tolist() == \
        rng.key_values(rng.fold_in(1, 3), [(1,)])
    graphs.reset_stats()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphs.EpochRunner("x", body, (), {}, n_rows=4, device="cpu",
                           graphed=True)


@pytest.mark.parametrize("kind", ["runner", "call", "update"])
def test_first_replay_computes_one_key_table(monkeypatch, kind):
    """The capture core fills the key buffer at each replay and never at
    capture: the first epoch of a graphed runner, and the first call of a
    keyed serving graph (a pure call or an update), compute the key
    table's values on the host once, for that replay."""
    lib, cache = graph_stand_ins(monkeypatch)
    roots = []
    real = rng.key_values

    def counted(root, paths):
        roots.append(root)
        return real(root, paths)

    monkeypatch.setattr(rng, "key_values", counted)

    def draw(key, like):
        lib.launches_by_entry["k"] += 1
        return rng.uniform(rng.fold_in(key, 1), like.shape, "cpu")

    graphs.reset_stats()
    state, x = torch.zeros(2, 2), torch.ones(2, 2)
    if kind == "runner":
        runner = graphs.EpochRunner(
            "fake", lambda c, s, p, lr, mom: (s + lr * draw(rng.Key(), s),
                                              (s.sum(),)),
            (), {}, n_rows=4, device="cpu", graphed=False)
        runner.graphed = True
        runner(state, 11, 0.1, 0.5)
    elif kind == "call":
        cache.call(lambda x, *, key: x * draw(key, x), 11, x)
    else:
        cache.update(lambda s, x, *, key: (s + draw(key, x), (x.sum(),)),
                     11, state, x)
    assert roots == [11]
    (cap,) = graphs.STATS["captures"]
    assert dict(graphs.STATS["keys"]) == {cap["name"]: 1}
    assert dict(graphs.STATS["replays"]) == {cap["name"]: 1}
    graphs.reset_stats()


def test_trees_round_trip():
    st = rbm_ops.init_rbm_state(0, 3, 2)
    tree = (dict(states=[st, st], chains=None),
            (torch.ones(()), imdbn_ops.zeros_metrics()), 4)
    leaves, spec = graphs.flatten(tree)
    assert len(leaves) == 6 * 2 + 1 + 5
    _leaves_equal(graphs.unflatten(spec, leaves), tree)
