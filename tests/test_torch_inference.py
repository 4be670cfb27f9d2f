"""The port's inference path, held against the JAX package on seeded numpy
inputs at small widths (joint 36x24 over a [256, 64, 32] image stack, 4
labels), both sides in their deterministic sampler mode
(``torch_parity.both_deterministic``): the schedules, ``gibbs_step``,
``conditional_gibbs_annealed``, ``dbn_reconstruct``, ``cross_reconstruct``
in every direction with and without μ-pull and the affine map, the real
best-of-K, ``sample_txt2img``, and the model-level ``img2txt`` /
``txt2img`` / ``sample_txt2img`` / ``represent`` on weights carried across
with ``convert``.

Tolerance: 1e-5 absolute for chains and decodes; exact for integers,
index sets and, inside the port, for the halves of a one-direction call
against the same halves of "both".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.models import iMDBN as JiMDBN
from multimodal_idbn_tpu.ops import dbn_train as jdbn
from multimodal_idbn_tpu.ops import imdbn_ops as jimdbn
from multimodal_idbn_tpu.ops import rbm_ops as jrbm
from multimodal_idbn_tpu.ops import schedules as jsched
from multimodal_idbn_tpu_torch import convert
from multimodal_idbn_tpu_torch.ops import dbn_train as tdbn
from multimodal_idbn_tpu_torch.ops import imdbn_ops as timdbn
from multimodal_idbn_tpu_torch.ops import rbm_ops as trbm
from multimodal_idbn_tpu_torch.ops import schedules as tsched

from torch_parity import (IMG_LAYERS, JOINT_HIDDEN, K, SMALL_PARAMS,
                          both_deterministic, close, jax_state, np_state,
                          randomize, small_imdbn, state_np, t, torch_state)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
Dz, H, D, B = 32, 24, 64, 6
V = Dz + K
GROUPS = ((Dz, V),)
KEY = jax.random.key(0)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    return dict(
        joint=np_state(rs, V, H), image=np_state(rs, D, Dz),
        z=rs.rand(B, Dz).astype(np.float32),
        y=np.eye(K, dtype=np.float32)[rs.randint(0, K, B)],
        zcm=rs.rand(K, Dz).astype(np.float32),
        scale=(0.5 + rs.rand(Dz)).astype(np.float32),
        bias=(0.1 * rs.randn(Dz)).astype(np.float32))


@pytest.mark.parametrize("n,frac,T0,T1", [(40, 0.7, 2.5, 1.0),
                                          (5, 0.5, 3.0, 0.5), (1, 0.0, 2, 1),
                                          (0, 1.0, 2.0, 1.0)])
def test_schedules(n, frac, T0, T1):
    assert tsched.hot_steps(n, frac) == jsched.hot_steps(n, frac)
    got = tsched.gibbs_annealed_temperature(n, T0, T1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsched.gibbs_annealed_temperature(n, T0, T1)))


@pytest.mark.parametrize("sample_h,sample_v", [(True, True), (False, True),
                                               (True, False)])
def test_gibbs_step(monkeypatch, sample_h, sample_v):
    x = _inputs(0)
    v = np.concatenate([x["z"], x["y"]], axis=1)
    with both_deterministic(monkeypatch):
        want = jrbm.gibbs_step(jax_state(x["joint"]), KEY, jnp.asarray(v),
                               sample_h, sample_v, GROUPS)
        got = trbm.gibbs_step(torch_state(x["joint"]), 0, t(v), sample_h,
                              sample_v, GROUPS)
    for a, b in zip(got, want):
        close(a, b, TOL)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_steps=7, sample_h_until=3, sample_v_every=2),
    dict(n_steps=4, T0=3.0, T1=0.5, final_meanfield=False),
    dict(n_steps=0)])
def test_conditional_gibbs_annealed(monkeypatch, kw):
    x = _inputs(1)
    vk = np.concatenate([np.zeros_like(x["z"]), x["y"]], axis=1)
    km = np.concatenate([np.zeros((B, Dz)), np.ones((B, K))],
                        axis=1).astype(np.float32)
    with both_deterministic(monkeypatch):
        want = jrbm.conditional_gibbs_annealed(
            jax_state(x["joint"]), KEY, jnp.asarray(vk), jnp.asarray(km),
            groups=GROUPS, **kw)
        got = trbm.conditional_gibbs_annealed(
            torch_state(x["joint"]), 0, t(vk), t(km), groups=GROUPS, **kw)
    close(got, want, TOL)
    np.testing.assert_array_equal(got[:, Dz:].numpy(), x["y"])


def test_dbn_reconstruct():
    rs = np.random.RandomState(2)
    fs = [np_state(rs, 30, 16), np_state(rs, 16, 8)]
    v = (rs.rand(B, 30) > 0.6).astype(np.float32)
    close(tdbn.dbn_reconstruct([torch_state(f) for f in fs], t(v)),
          jdbn.dbn_reconstruct(tuple(jax_state(f) for f in fs),
                               jnp.asarray(v)), TOL)


@pytest.mark.parametrize("direction", ["both", "img2txt", "txt2img"])
@pytest.mark.parametrize("zcm,affine", [(False, False), (True, False),
                                        (True, True)])
def test_cross_reconstruct_directions(monkeypatch, direction, zcm, affine):
    x = _inputs(3)
    kw = dict(steps=6, Dz=Dz, groups=GROUPS, direction=direction)
    with both_deterministic(monkeypatch):
        jimg, jpy = jimdbn.cross_reconstruct(
            jax_state(x["joint"]), (jax_state(x["image"]),), KEY,
            jnp.asarray(x["z"]), jnp.asarray(x["y"]),
            z_class_mean=jnp.asarray(x["zcm"]) if zcm else None,
            z_affine=((jnp.asarray(x["scale"]), jnp.asarray(x["bias"]))
                      if affine else None), **kw)
        timg, tpy = timdbn.cross_reconstruct(
            torch_state(x["joint"]), [torch_state(x["image"])], 0,
            t(x["z"]), t(x["y"]), z_class_mean=t(x["zcm"]) if zcm else None,
            z_affine=(t(x["scale"]), t(x["bias"])) if affine else None, **kw)
    for got, want, kept in ((timg, jimg, direction != "img2txt"),
                            (tpy, jpy, direction != "txt2img")):
        assert (got is None) == (want is None) == (not kept)
        if kept:
            close(got, want, TOL)
    if tpy is not None:
        np.testing.assert_allclose(tpy.sum(dim=1).numpy(), 1.0, atol=1e-5)


def test_one_direction_halves_are_bit_equal_to_both():
    """Real draws: the key of each half does not depend on the direction."""
    x = _inputs(4)
    args = (torch_state(x["joint"]), [torch_state(x["image"])], 12345,
            t(x["z"]), t(x["y"]))
    kw = dict(steps=5, Dz=Dz, groups=GROUPS, z_class_mean=t(x["zcm"]))
    img, py = timdbn.cross_reconstruct(*args, **kw)
    assert torch.equal(
        timdbn.cross_reconstruct(*args, direction="img2txt", **kw)[1], py)
    assert torch.equal(
        timdbn.cross_reconstruct(*args, direction="txt2img", **kw)[0], img)
    other = timdbn.cross_reconstruct(args[0], args[1], 54321, *args[3:],
                                     **kw)[0]
    assert not torch.equal(other, img)
    with pytest.raises(ValueError, match="unknown direction 'txt'"):
        timdbn.cross_reconstruct(*args, direction="txt", **kw)
    with pytest.raises(ValueError, match="unknown direction 'txt'"):
        jimdbn.cross_reconstruct(
            jax_state(x["joint"]), (jax_state(x["image"]),), KEY,
            jnp.asarray(x["z"]), jnp.asarray(x["y"]), steps=5, Dz=Dz,
            groups=GROUPS, direction="txt")


@pytest.mark.parametrize("best_of_k", [5, 2, 1])
def test_free_energy_best_of_k(monkeypatch, best_of_k):
    """The real best-of-K picks the same candidate for every sample and
    returns the same image; which samples keep candidate 0 is exact.

    The class means of the even classes lie along the z biases and those
    of the odd classes against them, so the refinement (pulled towards
    its class mean, where candidate 0's last step is not) has the lower
    free energy for the even classes only."""
    x = _inputs(5)
    x["joint"]["vb"][:Dz] = 1.5 * np.random.RandomState(6).randn(Dz)
    along = (x["joint"]["vb"][:Dz] > 0).astype(np.float32)
    zcm = np.stack([along, 1 - along, along, 1 - along])
    labels = np.array([0, 1, 2, 3, 1, 0])
    y = np.eye(K, dtype=np.float32)[labels]
    kw = dict(steps=4, Dz=Dz, groups=GROUPS, direction="txt2img")
    with both_deterministic(monkeypatch):
        jargs = (jax_state(x["joint"]), (jax_state(x["image"]),), KEY,
                 jnp.asarray(x["z"]), jnp.asarray(y))
        targs = (torch_state(x["joint"]), [torch_state(x["image"])], 0,
                 t(x["z"]), t(y))
        j0 = jimdbn.cross_reconstruct(*jargs, z_class_mean=jnp.asarray(zcm),
                                      **kw)[0]
        t0 = timdbn.cross_reconstruct(*targs, z_class_mean=t(zcm), **kw)[0]
        jf = jimdbn.cross_reconstruct(
            *jargs, z_class_mean=jnp.asarray(zcm), use_free_energy=True,
            best_of_k=best_of_k, **kw)[0]
        tf = timdbn.cross_reconstruct(
            *targs, z_class_mean=t(zcm), use_free_energy=True,
            best_of_k=best_of_k, **kw)[0]
    close(t0, j0, TOL)
    close(tf, jf, TOL)
    kept_j = np.all(np.asarray(jf) == np.asarray(j0), axis=1)
    kept_t = torch.all(tf == t0, dim=1).numpy()
    np.testing.assert_array_equal(kept_t, kept_j)
    np.testing.assert_array_equal(
        kept_t, np.ones(B, bool) if best_of_k == 1 else labels % 2 == 1)


@pytest.mark.parametrize("affine", [False, True])
def test_sample_txt2img(monkeypatch, affine):
    x = _inputs(6)
    rs = np.random.RandomState(7)
    stack = [np_state(rs, D, 48), np_state(rs, 48, Dz)]
    with both_deterministic(monkeypatch):
        jimgs, jz = jimdbn.sample_txt2img(
            jax_state(x["joint"]), tuple(jax_state(f) for f in stack), KEY,
            jnp.asarray(x["y"]), steps=4, Dz=Dz, groups=GROUPS,
            z_affine=((jnp.asarray(x["scale"]), jnp.asarray(x["bias"]))
                      if affine else None))
        timgs, tz = timdbn.sample_txt2img(
            torch_state(x["joint"]), [torch_state(f) for f in stack], 0,
            t(x["y"]), steps=4, Dz=Dz, groups=GROUPS,
            z_affine=(t(x["scale"]), t(x["bias"])) if affine else None)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert set(np.unique(tz.numpy())) <= {0.0, 1.0}
    close(timgs, jimgs, TOL)


def test_labels_to_onehot_errors():
    m = small_imdbn()
    np.testing.assert_array_equal(m._labels_to_onehot([0, 3]),
                                  np.eye(K, dtype=np.float32)[[0, 3]])
    np.testing.assert_array_equal(
        m._labels_to_onehot(torch.eye(K)[[1, 2]]),
        np.eye(K, dtype=np.float32)[[1, 2]])
    assert m._labels_to_onehot(np.zeros((0,), np.int64)).shape == (0, K)
    for bad in ([0, K], [-1], np.array([7])):
        with pytest.raises(ValueError, match=r"label ids must be in \[0, 4\)"):
            m._labels_to_onehot(bad)
    with pytest.raises(ValueError, match="one-hot labels must have width 4"):
        m._labels_to_onehot(np.zeros((2, K + 1)))


@pytest.fixture
def twin_models():
    """The same iMDBN in both packages: seeded weights in the port's,
    carried into the JAX package's through the ``convert`` layout."""
    tm = randomize(small_imdbn(), np.random.RandomState(8))
    tm.z_class_mean = t(np.random.RandomState(9).rand(K, Dz))
    layout = convert.to_numpy(tm.image_idbn.states(), tm.joint_rbm.state,
                              tm.z_class_mean)
    jm = JiMDBN(IMG_LAYERS, JOINT_HIDDEN, params=dict(SMALL_PARAMS),
                dataloader=None, val_loader=None, num_labels=K, seed=0)
    parts = convert.from_jax_numpy(layout, device="cpu")
    jm.image_idbn._set_states(tuple(
        jax_state(state_np(s)) for s in parts["image"]))
    jm.joint_rbm.state = jax_state(state_np(parts["joint"]))
    jm.z_class_mean = jnp.asarray(layout["z_class_mean"])
    return tm, jm


@pytest.mark.parametrize("bug", [True, False])
def test_model_inference_matches_jax(monkeypatch, twin_models, bug):
    tm, jm = twin_models
    tm.reference_best_of_k_bug = jm.reference_best_of_k_bug = bug
    imgs = tm.dataloader.materialize()[0][:5]
    y = np.eye(K, dtype=np.float32)[[0, 1, 2, 3, 1]]
    close(tm.represent((imgs, y)), jm.represent((imgs.reshape(5, -1), y)),
          TOL)
    with both_deterministic(monkeypatch):
        p_t, p_j = tm.img2txt(imgs), jm.img2txt(imgs)
        close(p_t, p_j, TOL)
        np.testing.assert_array_equal(p_t.argmax(dim=1).numpy(),
                                      np.asarray(p_j).argmax(axis=1))
        for labels in ([2, 0, 3], y):
            close(tm.txt2img(labels), jm.txt2img(labels), TOL)
        close(tm.sample_txt2img([1, 3], gibbs_steps=3, seed=5),
              jm.sample_txt2img([1, 3], gibbs_steps=3, seed=5), TOL)
        tm.z_affine_scale = jm.z_affine_scale = np.full(Dz, 1.5, np.float32)
        tm.z_affine_bias = jm.z_affine_bias = np.full(Dz, 0.05, np.float32)
        close(tm.txt2img([1]), jm.txt2img([1]), TOL)
        for got, want in zip(tm._cross_reconstruct(np.zeros((2, Dz)), y[:2],
                                                   steps=2),
                             jm._cross_reconstruct(np.zeros((2, Dz)), y[:2],
                                                   steps=2)):
            close(got, want, TOL)
    assert tuple(p_t.shape) == (5, K)


def test_model_sampling_is_seeded():
    tm = randomize(small_imdbn(), np.random.RandomState(10))
    a = tm.sample_txt2img([0, 1, 2], seed=3)
    assert tuple(a.shape) == (3, 256)
    assert torch.equal(a, tm.sample_txt2img([0, 1, 2], seed=3))
    assert not torch.equal(a, tm.sample_txt2img([0, 1, 2], seed=4))
    tm.joint_rbm.reseed(11)
    b = tm.txt2img([0, 1])
    tm.joint_rbm.reseed(11)
    assert torch.equal(b, tm.txt2img([0, 1]))
    assert not torch.equal(b, tm.txt2img([0, 1]))
