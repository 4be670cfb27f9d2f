"""The opt-in training variants of the port held against the JAX package:
persistent CD (the plain update, the half-step trainer and the epoch
carry), bf16 storage with and without stochastic rounding, mixed
precision, the parsing of the precision keys, the routes the models choose
from them, checkpoints that carry bf16 states and PCD chains across the
two packages, a bit-identical PCD resume, the matmul-precision setter, and
the two faults this slice repaired (params the models did not read;
unseeded shells that all started from seed 0).

Tolerances, stated before measuring:
- fp32 (PCD): 1e-5 elementwise under the deterministic sampler modes
  (JAX at "highest", tests/conftest.py; the port in true fp32);
- bf16 storage or ``compute_dtype``: the stored dtypes equal and the
  values within 2e-2 absolute after one update (products and elementwise
  operations are rounded to bf16 as XLA rounds them; the stochastic
  rounding bits of the two packages differ, one bf16 ulp); with
  stochastic rounding off, one update is also held to one bf16 ulp of
  JAX's, relative (an epoch is not: XLA may keep a fused reduction's
  operands at fp32);
- ``stochastic_round``: bit-equal to JAX's on the same 16 random bits.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import multimodal_idbn_tpu.checkpoint as jck
import multimodal_idbn_tpu.models.rbm as jrbm_mod
from multimodal_idbn_tpu.models import iDBN as JiDBN
from multimodal_idbn_tpu.ops import dbn_train as jdt
from multimodal_idbn_tpu.ops import rbm_ops as jr

import multimodal_idbn_tpu_torch as port
import multimodal_idbn_tpu_torch.checkpoint as tck
import multimodal_idbn_tpu_torch.models.rbm as trbm_mod
from multimodal_idbn_tpu_torch import device as tdevice
from multimodal_idbn_tpu_torch import train_multimodal
from multimodal_idbn_tpu_torch.models import RBM, iDBN, iMDBN, iMDBN_BiModal
from multimodal_idbn_tpu_torch.ops import dbn_train as tdt
from multimodal_idbn_tpu_torch.ops import fast_cd
from multimodal_idbn_tpu_torch.ops import rbm_ops as tr

from torch_parity import (FIELDS, IMG_LAYERS, SMALL_PARAMS,
                          assert_models_equal, assert_states_close,
                          both_deterministic, close, jax_state, np_state,
                          small_bimodal, small_imdbn, small_loaders,
                          state_np, t, torch_state)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

V, H, B = 24, 16, 8
GROUPS = ((18, 24),)
KW = dict(lr=0.1, mom=0.5, weight_decay=1e-4)
SMOKE_YAML = "configs/smoke_multimodal.yaml"


def _data(rs, groups=()):
    x = (rs.rand(B, V) > 0.5).astype(np.float32)
    for s, e in groups:
        x[:, s:e] = 0.0
        x[np.arange(B), s + rs.randint(0, e - s, B)] = 1.0
    return x


def _bf16_pair(fields):
    return (jr.RBMState(*(jnp.asarray(fields[f]).astype(jnp.bfloat16)
                          for f in FIELDS)),
            tr.RBMState(*(torch.as_tensor(fields[f]).to(torch.bfloat16)
                          for f in FIELDS)))


def _assert_within_bf16_ulps(js, ts, n=1):
    """Every field within ``n`` bf16 ulps of JAX's, relative to the larger
    magnitude of the pair: what a precision slip (a product or scalar kept
    at fp32 where JAX rounds it to bf16, or rounding where JAX has none)
    breaks and 2e-2 absolute lets through."""
    a, b = state_np(js), state_np(ts)
    for f in FIELDS:
        x, y = a[f].astype(np.float64), b[f].astype(np.float64)
        m = np.maximum(np.abs(x), np.abs(y))
        ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
        assert np.all(np.abs(x - y) <= n * ulp), f


def _assert_dtypes_equal(js, ts):
    for f in FIELDS:
        jd = str(getattr(js, f).dtype)
        td = str(getattr(ts, f).dtype).replace("torch.", "")
        assert jd == td, (f, jd, td)


# ---------------------------------------------------------------------------
# The two faults (models read every variant key; unseeded shells differ)
# ---------------------------------------------------------------------------

def test_models_read_every_variant_key():
    """The models read PCD, DTYPE, COMPUTE_DTYPE and SR and refuse a bad
    value with JAX's ValueError. Until the variants slice they read none of
    them and trained plain fp32 CD. DP_DEVICES=2 without a process group
    of two raises JAX's ValueError when the mesh is made; DP_DEVICES=1 is
    a mesh of this process."""
    m = iDBN([20, 10, 5], dict(SMALL_PARAMS, PCD=True, DTYPE="bfloat16",
                                COMPUTE_DTYPE="bf16", SR="false"), None,
             device="cpu", seed=0)
    assert m.use_pcd and m.sr is False
    assert m.compute_dtype == torch.bfloat16
    assert all(r.state.w.dtype == torch.bfloat16 and r.sr is False
               for r in m.layers)
    for key, bad in (("DTYPE", "float16"), ("COMPUTE_DTYPE", "int8"),
                     ("SR", "maybe")):
        with pytest.raises(ValueError) as theirs:
            JiDBN([20, 10, 5], dict(SMALL_PARAMS, **{key: bad}), None,
                  None, seed=0)
        with pytest.raises(ValueError) as ours:
            iDBN([20, 10, 5], dict(SMALL_PARAMS, **{key: bad}), None,
                 device="cpu", seed=0)
        assert str(ours.value) == str(theirs.value)
    for build in (lambda p: iDBN([20, 10], p, None, device="cpu"),
                  lambda p: small_imdbn(**p), lambda p: small_bimodal(**p)):
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            build(dict(SMALL_PARAMS, DP_DEVICES=2))._resolve_mesh()
        assert build(dict(SMALL_PARAMS,
                          DP_DEVICES=1))._resolve_mesh().size == 1


def test_unseeded_shells_differ_and_global_seed_is_exported(monkeypatch):
    """Two shells built without a seed get different weights and key
    streams (_GLOBAL_SEED + instance number, as JAX's); the base seed is
    set with set_global_seed, exported from the package's top. Until this
    slice every unseeded shell started from seed 0."""
    assert port.set_global_seed is trbm_mod.set_global_seed
    a, b = (RBM(12, 6, 0.1, 1e-4, 0.5, device="cpu") for _ in range(2))
    assert not torch.equal(a.W, b.W)
    assert a._next_key() != b._next_key()
    monkeypatch.setattr(trbm_mod, "_instance_counter", itertools.count())
    monkeypatch.setattr(trbm_mod, "_GLOBAL_SEED", 0)
    port.set_global_seed(40)
    first, second = (RBM(12, 6, 0.1, 1e-4, 0.5, device="cpu")
                     for _ in range(2))
    for shell, seed in ((first, 40), (second, 41)):
        assert torch.equal(shell.W,
                           RBM(12, 6, 0.1, 1e-4, 0.5, device="cpu",
                               seed=seed).W)


# ---------------------------------------------------------------------------
# Params parsing: accepts and refuses what JAX's does
# ---------------------------------------------------------------------------

_VALUES = {
    "DTYPE": ["float32", "f32", "FP32", "bfloat16", "bf16", "BF16",
              "float16", "int8", None, 7],
    "COMPUTE_DTYPE": [None, "float32", "fp32", "none", "None", "bfloat16",
                      "BF16", "float16", 3],
    "SR": [None, "auto", "AUTO", "", "none", True, False, "true", "On",
           "1", "yes", "false", "off", "0", "No", "maybe", 1, 0, 2.5],
}


@pytest.mark.parametrize("key,value", [(k, v) for k, vs in _VALUES.items()
                                       for v in vs])
def test_params_parsing_matches_jax(key, value):
    fn = {"DTYPE": "param_dtype", "COMPUTE_DTYPE": "param_compute_dtype",
          "SR": "param_sr"}[key]
    params = {} if value is None and key == "DTYPE" else {key: value}
    try:
        theirs = getattr(jrbm_mod, fn)(params)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            getattr(trbm_mod, fn)(params)
        assert str(ours.value) == str(e)
        return
    ours = getattr(trbm_mod, fn)(params)
    if key == "SR":
        assert ours is theirs
    else:
        assert (None if theirs is None else jnp.dtype(theirs).name) == (
            None if ours is None else str(ours).replace("torch.", ""))


def test_warn_compute_dtype_joint_prints_jax_line(capsys):
    for p in ({"COMPUTE_DTYPE": "bf16"},
              {"COMPUTE_DTYPE": "bf16", "DTYPE": "bfloat16"}, {}):
        jrbm_mod._warn_compute_dtype_joint(p, "iMDBN")
        theirs = capsys.readouterr().out
        trbm_mod._warn_compute_dtype_joint(p, "iMDBN")
        assert capsys.readouterr().out == theirs


# ---------------------------------------------------------------------------
# stochastic_round and compute_cast
# ---------------------------------------------------------------------------

def test_stochastic_round_bit_equal_on_the_same_bits(monkeypatch):
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(4000).astype(np.float32) * 3,
                        np.float32([0.0, -0.0, 1e-30, -1e-30, 65504.0,
                                    3.3895314e38, -3.3895314e38, np.inf,
                                    -np.inf])])
    r = rs.randint(0, 1 << 16, x.shape).astype(np.uint32)
    monkeypatch.setattr(jax.random, "bits",
                        lambda key, shape, dtype: jnp.asarray(r, dtype))
    theirs = jr.stochastic_round(jax.random.key(0), jnp.asarray(x),
                                 jnp.bfloat16)
    ours = tr.stochastic_round_bits(torch.as_tensor(x),
                                    torch.as_tensor(r.astype(np.int64)))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ours.view(torch.int16).numpy().view(np.uint16),
        np.asarray(theirs).view(np.uint16))


def test_stochastic_round_unbiased_and_adjacent():
    """One of the two bf16 neighbours of x, with the sample mean converging
    to x (tests/test_bf16.py:146-205)."""
    x = torch.full((4096,), 0.1003)
    out = tr.stochastic_round(0, x, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    vals = np.unique(out.float().numpy())
    assert len(vals) == 2
    assert abs(float(out.float().mean()) - 0.1003) < 2e-4
    exact = torch.as_tensor(vals)
    np.testing.assert_array_equal(
        tr.stochastic_round(1, exact, torch.bfloat16).float().numpy(), vals)
    np.testing.assert_array_equal(tr.stochastic_round(2, x, torch.float32),
                                  x)
    neg = tr.stochastic_round(3, torch.full((8192,), -0.0377),
                              torch.bfloat16).float()
    assert bool((neg < 0).all()) and abs(float(neg.mean()) + 0.0377) < 1e-4
    with pytest.raises(ValueError, match="bfloat16/float32"):
        tr.stochastic_round(0, x, torch.float16)


def test_compute_cast_matches_jax():
    f = np_state(np.random.RandomState(1), V, H, momentum=True)
    js = jr.compute_cast(jax_state(f), jnp.bfloat16)
    ts = tr.compute_cast(torch_state(f), torch.bfloat16)
    _assert_dtypes_equal(js, ts)
    for k, a in state_np(js).items():
        np.testing.assert_array_equal(state_np(ts)[k], a, err_msg=k)
    st = torch_state(f)
    assert tr.compute_cast(st, None) is st
    assert tr.compute_cast(st, torch.float32) is st


# ---------------------------------------------------------------------------
# bf16 storage and mixed precision, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["bf16-sr-auto", "bf16-sr-off",
                                  "bf16-sr-on-groups", "mixed",
                                  "mixed-groups"])
def test_cd_update_bf16_and_mixed_match_jax(monkeypatch, case):
    rs = np.random.RandomState(2)
    groups = GROUPS if case.endswith("groups") else ()
    f = np_state(rs, V, H, momentum=True)
    x = _data(rs, groups)
    kw = dict(KW, cd=2, groups=groups)
    with both_deterministic(monkeypatch):
        if case.startswith("bf16"):
            sr = {"auto": None, "off": False, "on": True}[case.split("-")[2]]
            js0, ts0 = _bf16_pair(f)
            js, jl = jr.cd_update(js0, jax.random.key(0), jnp.asarray(x),
                                  sr=sr, **kw)
            ts, tl = tr.cd_update(ts0, 5, t(x), sr=sr, **kw)
        else:
            js, jl = jr.cd_update(jax_state(f), jax.random.key(0),
                                  jnp.asarray(x), compute_dtype=jnp.bfloat16,
                                  **kw)
            ts, tl = tr.cd_update(torch_state(f), 5, t(x),
                                  compute_dtype=torch.bfloat16, **kw)
    _assert_dtypes_equal(js, ts)
    assert tl.dtype == torch.float32
    assert_states_close(js, ts, 2e-2)
    close(tl, jl, 2e-2)
    if "sr-auto" not in case and "sr-on" not in case:
        _assert_within_bf16_ulps(js, ts)


@pytest.mark.parametrize("sr", [None, False])
def test_clamped_cd_update_bf16_matches_jax(monkeypatch, sr):
    rs = np.random.RandomState(3)
    f = np_state(rs, V, H, momentum=True)
    x = _data(rs, GROUPS)
    km = np.zeros((B, V), np.float32)
    km[:, 18:] = 1.0
    vk = x * km
    kw = dict(KW, cd=1, cond_init_steps=4, sample_h=False, sample_v=False,
              reclamp_negative=False, use_noisy_init=True, groups=GROUPS,
              sr=sr)
    with both_deterministic(monkeypatch):
        js0, ts0 = _bf16_pair(f)
        js, jl = jr.clamped_cd_update(js0, jax.random.key(1),
                                      jnp.asarray(vk), jnp.asarray(km), **kw)
        ts, tl = tr.clamped_cd_update(ts0, 7, t(vk), t(km), **kw)
    _assert_dtypes_equal(js, ts)
    assert_states_close(js, ts, 2e-2)
    close(tl, jl, 2e-2)
    if sr is False:
        _assert_within_bf16_ulps(js, ts)


def test_bf16_sr_accumulates_tiny_updates():
    """Increments far below a bf16 ulp of the weights vanish under nearest
    rounding (sr=False) but accumulate under SR, the default for bf16
    storage (tests/test_bf16.py:180-205)."""
    state = tr.init_rbm_state(0, 64, 32, dtype=torch.bfloat16)
    data = (torch.rand((32, 64), generator=torch.Generator().manual_seed(0))
            > 0.5).float()

    def drift(sr):
        s = state
        for step in range(50):
            s, _ = tr.cd_update(s, 100 + step, data, lr=1e-4, mom=0.0,
                                weight_decay=0.0, cd=1, sr=sr)
        return float((s.w.float() - state.w.float()).abs().mean())

    assert drift(None) > 5 * max(drift(False), 1e-9)


# ---------------------------------------------------------------------------
# Persistent CD (fp32), against JAX
# ---------------------------------------------------------------------------

def test_pcd_update_and_half_step_trainer_match_jax(monkeypatch):
    rs = np.random.RandomState(4)
    f = np_state(rs, V, H, momentum=True)
    x, ch = _data(rs), _data(rs)
    kw = dict(KW, cd=3, sparsity=True, sparsity_factor=0.1)
    with both_deterministic(monkeypatch):
        js, jc, jl = jr.pcd_update(jax_state(f), jnp.asarray(ch),
                                   jax.random.key(0), jnp.asarray(x), **kw)
        ts, tc, tl = tr.pcd_update(torch_state(f), t(ch), 5, t(x), **kw)
        fs, fc, fl = fast_cd.fast_sampled_pcd_update(torch_state(f), t(ch),
                                                      5, t(x), **kw)
    for s, c, loss in ((ts, tc, tl), (fs, fc, fl)):
        assert_states_close(js, s, 1e-5)
        close(c, jc, 1e-5)
        close(loss, jl, 1e-5)
    chains = tr.init_pcd_chains(3, 5, 7)
    assert chains.shape == (5, 7) and set(chains.unique().tolist()) <= {0.,
                                                                         1.}
    with both_deterministic(monkeypatch):
        close(tr.init_pcd_chains(3, 5, 7),
              jr.init_pcd_chains(jax.random.key(3), 5, 7), 0)


def test_pcd_epoch_carries_chains_like_jax(monkeypatch):
    """Two full batches of a two-layer stack: states, chains and losses of
    the port's PCD epoch, on the half-step route and on the plain route,
    equal JAX's ``idbn_epoch_pcd``."""
    rs = np.random.RandomState(5)
    fields = [np_state(rs, 24, 12, momentum=True),
              np_state(rs, 12, 6, momentum=True)]
    data = (rs.rand(2 * B, 24) > 0.5).astype(np.float32)
    chains = [_data(rs), (rs.rand(B, 12) > 0.5).astype(np.float32)]
    kw = dict(cd=2, sparsity_flags=(False, True), batch_size=B)
    with both_deterministic(monkeypatch):
        js, jc, jl = jdt.idbn_epoch_pcd(
            tuple(jax_state(f) for f in fields),
            tuple(jnp.asarray(c) for c in chains), jax.random.key(0),
            jnp.asarray(data), 0.1, 0.5, 1e-4, 0.1, **kw)
        runs = [tdt.idbn_epoch_pcd(
            [torch_state(f) for f in fields], [t(c) for c in chains], 9,
            t(data), lr=0.1, mom=0.5, weight_decay=1e-4, sparsity_factor=0.1,
            fast_sampler=fast, **kw) for fast in (True, False)]
    for ts, tc, tl in runs:
        assert tl.shape == (2, 2)
        for a, b in zip(js, ts):
            assert_states_close(a, b, 1e-5)
        for a, b in zip(jc, tc):
            close(b, a, 1e-5)
        close(tl, jl, 1e-5)


# ---------------------------------------------------------------------------
# Routes chosen from the config
# ---------------------------------------------------------------------------

def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counting(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counting)
    return calls


@pytest.mark.parametrize("params,route", [
    ({}, "fast_sampled_cd_update"),
    ({"PCD": True}, "fast_sampled_pcd_update"),
    ({"DTYPE": "bfloat16"}, "cd_update"),
    ({"DTYPE": "bfloat16", "PCD": True}, "pcd_update"),
    ({"COMPUTE_DTYPE": "bfloat16"}, "cd_update"),
    ({"COMPUTE_DTYPE": "bfloat16", "PCD": True}, "pcd_update")])
def test_idbn_route_follows_the_config(monkeypatch, capsys, params, route):
    """fp32 CD and PCD take the half-step trainers (the kernel on the
    card), bf16 storage and mixed precision the plain torch updates; each
    plain route is printed. Under PCD the remainder batch trains by CD, on
    the same route. The stored dtype and the chains follow the config."""
    calls = {name: _count(monkeypatch, mod, name) for mod, name in (
        (fast_cd, "fast_sampled_cd_update"),
        (fast_cd, "fast_sampled_pcd_update"), (tr, "cd_update"),
        (tr, "pcd_update"))}
    dbn = small_imdbn(**params).image_idbn  # 44 rows: 2 batches + 12
    dbn.train(1)
    fast = route.startswith("fast")
    counts = {k: len(v) for k, v in calls.items()}
    pcd = bool(params.get("PCD"))
    want = {k: 0 for k in counts}
    want[route] += 2 * 2 if pcd else 3 * 2
    if pcd:
        want["fast_sampled_cd_update" if fast else "cd_update"] += 2
    assert counts == want
    dt = torch.bfloat16 if params.get("DTYPE") else torch.float32
    assert all(r.state.w.dtype == dt for r in dbn.layers)
    out = capsys.readouterr().out
    assert ("half-step kernel disabled for bfloat16" in out) == (
        params.get("DTYPE") is not None)
    assert ("half-step kernel disabled for COMPUTE_DTYPE" in out) == (
        params.get("COMPUTE_DTYPE") is not None)
    if pcd:
        assert [tuple(c.shape) for c in dbn._pcd_chains] == [(16, 256),
                                                            (16, 64)]
        assert all(c.dtype == dt for c in dbn._pcd_chains)
    for r in dbn.layers:
        for f in FIELDS:
            assert bool(torch.isfinite(getattr(r.state, f).float()).all())


def test_bf16_joints_route_their_chains_to_plain_torch(monkeypatch, capsys):
    """A bf16-stored joint RBM runs its mean-field chains through the chain
    kernel's wrapper (its plain torch version on the CPU) on weights
    widened exactly to fp32, with no route line; every state keeps its
    dtype through training, bimodal joint layers included."""
    from multimodal_idbn_tpu_torch.ops import chain
    seen = []
    real = chain.clamped_chain

    def spy(w, hb, vb, *a, **kw):
        seen.append((w.dtype, hb.dtype, vb.dtype))
        return real(w, hb, vb, *a, **kw)

    monkeypatch.setattr(chain, "clamped_chain", spy)
    m = small_imdbn(DTYPE="bfloat16")
    assert "chain kernel" not in capsys.readouterr().out
    m.image_idbn.train(1)
    m.train_joint(1)
    flagship = len(seen)
    b = small_bimodal(DTYPE="bfloat16", SR=False)
    assert b.joint_rbm.sr is False
    b.train_joint(1)
    assert 0 < flagship < len(seen)
    assert set(seen) == {(torch.float32,) * 3}
    for model in (m, b):
        for name, a in tck._collect_rbms(model).items():
            assert a.state.w.dtype == torch.bfloat16, name
            assert bool(torch.isfinite(a.state.w.float()).all()), name


@pytest.mark.parametrize("chain_fn", ["conditional_gibbs",
                                      "noisy_meanfield_annealed"])
def test_bf16_chains_match_jax(monkeypatch, chain_fn):
    """The mean-field chains of a bf16-stored state against JAX's jnp
    chains on the same bf16 weights: JAX promotes them to meet the fp32
    chain state, the port widens them for the kernel. 1e-4, as the fp32
    chains of tests/test_torch_ops.py; the same chain run in bf16 is
    2.5e-3 off."""
    rs = np.random.RandomState(8)
    js, ts = _bf16_pair(np_state(rs, V, H))
    x = _data(rs, GROUPS)
    km = np.zeros((B, V), np.float32)
    if chain_fn == "conditional_gibbs":
        km[:, :18] = 1.0
        kw = dict(n_steps=6, groups=GROUPS)
    else:
        km[:, 18:] = 1.0
        kw = dict(n_steps=9, T0=3.0, T1=1.0, sigma0=0.9, hot_frac=0.7,
                  sharpen_last=3, T_cold_plus=0.9, eta0=0.15, groups=GROUPS)
    vk = x * km
    with both_deterministic(monkeypatch):
        jout = getattr(jr, chain_fn)(js, jax.random.key(0), jnp.asarray(vk),
                                     jnp.asarray(km), **kw)
        tout = getattr(tr, chain_fn)(ts, 0, t(vk), t(km), **kw)
    assert str(jout.dtype) == "float32" and tout.dtype == torch.float32
    close(tout, jout, 1e-4)


@pytest.mark.parametrize("case", ["bf16", "mixed"])
def test_epoch_bf16_and_mixed_match_jax(monkeypatch, case):
    """Two full batches of a two-layer stack through the plain route of
    the port's epoch and JAX's ``idbn_epoch``: bf16 storage (stochastic
    rounding off, so both round to nearest) or fp32 with a bf16 chain;
    layer 2 is fed the post-update activations of layer 1 in the compute
    dtype."""
    rs = np.random.RandomState(6)
    fields = [np_state(rs, 24, 12, momentum=True),
              np_state(rs, 12, 6, momentum=True)]
    data = (rs.rand(2 * B, 24) > 0.5).astype(np.float32)
    bf16 = case == "bf16"
    kw = dict(cd=2, sparsity_flags=(False, True), batch_size=B,
              sr=False if bf16 else None)
    with both_deterministic(monkeypatch):
        pairs = [_bf16_pair(f) if bf16 else (jax_state(f), torch_state(f))
                 for f in fields]
        js, jl = jdt.idbn_epoch(
            tuple(p[0] for p in pairs), jax.random.key(0), jnp.asarray(data),
            0.1, 0.5, 1e-4, 0.1,
            compute_dtype=None if bf16 else jnp.bfloat16, **kw)
        ts, tl = tdt.idbn_epoch(
            [p[1] for p in pairs], 9, t(data), lr=0.1, mom=0.5,
            weight_decay=1e-4, sparsity_factor=0.1, fast_sampler=False,
            compute_dtype=None if bf16 else torch.bfloat16, **kw)
    for a, b in zip(js, ts):
        _assert_dtypes_equal(a, b)
        assert_states_close(a, b, 2e-2)
    close(tl, jl, 2e-2)


# ---------------------------------------------------------------------------
# Checkpoints across packages; PCD resume
# ---------------------------------------------------------------------------

def _pcd_pair(dtype):
    params = dict(SMALL_PARAMS, PCD=True, DTYPE=dtype)
    ours = iDBN(IMG_LAYERS, params, small_loaders()[0], device="cpu",
                seed=0)
    theirs = JiDBN(IMG_LAYERS, params, small_loaders()[0], None, seed=0)
    return ours, theirs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_with_bf16_and_pcd_chains_cross_packages(tmp_path,
                                                             dtype):
    ours, theirs = _pcd_pair(dtype)
    ours.train(1)
    theirs._ensure_pcd_chains(16)
    theirs.train(1)
    # port -> JAX
    tck.save_train_checkpoint(ours, str(tmp_path / "p"), "image", 1)
    _, jtarget = _pcd_pair(dtype)
    assert jck.load_train_checkpoint(jtarget, str(tmp_path / "p.npz")) == (
        "image", 1)
    for a, b in zip(ours.layers, jtarget.layers):
        _assert_dtypes_equal(b.state, a.state)
        for k, v in state_np(a.state).items():
            np.testing.assert_array_equal(state_np(b.state)[k], v)
    for a, b in zip(ours._pcd_chains, jtarget._pcd_chains):
        assert str(b.dtype) == dtype
        np.testing.assert_array_equal(np.asarray(b, np.float32),
                                      a.float().numpy())
    # JAX -> port
    jck.save_train_checkpoint(theirs, str(tmp_path / "j"), "image", 1)
    target, _ = _pcd_pair(dtype)
    assert tck.load_train_checkpoint(target, str(tmp_path / "j.npz")) == (
        "image", 1)
    for a, b in zip(theirs.layers, target.layers):
        _assert_dtypes_equal(a.state, b.state)
        for k, v in state_np(a.state).items():
            np.testing.assert_array_equal(state_np(b.state)[k], v)
    for a, b in zip(theirs._pcd_chains, target._pcd_chains):
        assert str(b.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pcd_resume_bit_identical(tmp_path, dtype):
    """A tiny PCD stack stopped after its image checkpoint and resumed ends
    bit-equal to the uninterrupted run, chains included; so does a bf16
    stack (stochastic rounding on)."""
    params = dict(SMALL_PARAMS, PCD=True, DTYPE=dtype)
    straight = small_imdbn(**params).image_idbn
    straight.train(4)
    ck = str(tmp_path / "image.ckpt.npz")
    first = small_imdbn(**params).image_idbn
    first.train(2, checkpoint_every=2, checkpoint_path=ck)
    tck.save_train_checkpoint(first, ck, "image", 2,
                              loss_history=first.loss_history)
    resumed = small_imdbn(seed=9, **params).image_idbn
    assert tck.load_train_checkpoint(resumed, ck) == ("image", 2)
    resumed.train(4, start_epoch=2)
    assert_models_equal(resumed, straight)
    for a, b in zip(resumed._pcd_chains, straight._pcd_chains):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert resumed.loss_history == straight.loss_history


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pcd_chains_survive_pickling_and_moves(dtype):
    """The chains pickle as fp32 numpy arrays (no tensor reaches a
    pickle) and come back fp32, as the layers do."""
    import pickle
    dbn = small_imdbn(PCD=True, DTYPE=dtype).image_idbn
    dbn.train(1)
    blob = pickle.dumps(dbn)
    assert b"torch._utils" not in blob
    back = pickle.loads(blob)
    for a, b in zip(dbn._pcd_chains, back._pcd_chains):
        assert b.dtype == torch.float32 and torch.equal(a.float(), b)
    back.to("cpu")
    assert all(c.device.type == "cpu" for c in back._pcd_chains)


# ---------------------------------------------------------------------------
# Entry points and the matmul-precision setter
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_precision():
    before = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(before)


def test_matmul_precision_setter(restore_precision):
    for name, want in (("high", "high"), ("default", "medium"),
                       ("highest", "highest")):
        tdevice.set_matmul_precision(name)
        assert torch.get_float32_matmul_precision() == want
    with pytest.raises(ValueError, match="unknown matmul precision"):
        tdevice.set_matmul_precision("bf16")


def test_entry_point_runs_bf16_zipfian_high_precision(tmp_path, capsys,
                                                      restore_precision):
    """The settings the entry point refused until this slice run together:
    bf16 storage with stochastic rounding left to auto, mixed precision,
    matmul_precision high and zipfian data."""
    cfg = yaml.safe_load(open(SMOKE_YAML))
    cfg["training"].update(dtype="bfloat16", compute_dtype="bfloat16",
                           matmul_precision="high", epochs_image=1,
                           epochs_joint=1)
    cfg["dataset"]["distribution"] = "zipfian"
    cfg["paths"]["save_dir"] = str(tmp_path)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    summary = train_multimodal.main(["--config", str(path), "--device",
                                     "cpu"])
    out = capsys.readouterr().out
    assert "[train_multimodal] zipfian class distribution" in out
    assert "warn/compute_dtype_joint" in out
    assert torch.get_float32_matmul_precision() == "high"
    m = summary["model"]
    assert isinstance(m, iMDBN)
    for name, r in tck._collect_rbms(m).items():
        assert r.state.w.dtype == torch.bfloat16, name
    assert all(np.isfinite(summary["image_loss"]))


def test_bimodal_bf16_state_dtypes():
    m = small_bimodal(DTYPE="bfloat16")
    assert isinstance(m, iMDBN_BiModal)
    for r in m.mod1_dbn.layers + m.mod2_dbn.layers + m.joint_layers:
        assert r.state.w.dtype == torch.bfloat16 and r.sr is None


@pytest.mark.parametrize("precision,want", [("high", "high"),
                                            ("default", "medium"),
                                            ("highest", "highest")])
def test_generate_applies_matmul_precision(tmp_path, restore_precision,
                                           precision, want):
    """``generate --matmul-precision`` sets the precision of the plain
    products, as the JAX script's flag does (it refused all but
    "highest" until this slice)."""
    from multimodal_idbn_tpu_torch import generate
    m = small_imdbn()
    m.save_model(str(tmp_path / "m.pkl"))
    imgs = generate.main(["--model", str(tmp_path / "m.pkl"), "--device",
                          "cpu", "--out", str(tmp_path / "d.npz"),
                          "--labels", "1", "2", "--mean",
                          "--matmul-precision", precision])
    assert torch.get_float32_matmul_precision() == want
    assert imgs.shape == (2, 256) and np.isfinite(imgs).all()
