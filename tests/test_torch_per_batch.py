"""The port's per-batch training loops (loaders without ``materialize()``)
held against the JAX package's same calls at small widths: the image iDBN
(``iDBN.train(fused=False)``), the iMDBN joint and the bimodal joint
(``train_joint(fused=False)``), on the same numpy inputs and weights, both
sides in their deterministic sampler modes (tests/torch_parity.py,
``both_deterministic``). Tolerance atol 1e-5 on every state and metric.

Also: the iterate branch of ``_materialized_train``, the choice of
``fused=None`` by the loader, and bit-identical per-batch resume, port
against port (the pattern of tests/test_resume.py:260-280, :395-420).
"""

import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.data import loaders as jloaders
from multimodal_idbn_tpu.models import iDBN as JiDBN
from multimodal_idbn_tpu.models import iMDBN as JiMDBN
from multimodal_idbn_tpu.models import iMDBN_BiModal as JBiModal
import multimodal_idbn_tpu_torch.checkpoint as tck
from multimodal_idbn_tpu_torch.data import loaders as tloaders
from multimodal_idbn_tpu_torch.models import iDBN, iMDBN, iMDBN_BiModal

from torch_parity import (SMALL_PARAMS, assert_models_equal,
                          both_deterministic, close, jax_state, np_state,
                          rbm_arrays, torch_state)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
N, D, D2, K, BS = 44, 64, 48, 4, 16   # two batches of 16 and 12 rows
PARAMS = dict(SMALL_PARAMS, CD=2)


def _dataset(mod, bimodal=False):
    rs = np.random.RandomState(0)
    imgs = (rs.rand(N, D) > 0.7).astype(np.float32)
    labels = rs.randint(0, K, N)
    extra = {}
    if bimodal:
        extra = dict(mod2_images=(rs.rand(N, D2) > 0.6).astype(np.float32),
                     mode="bimodal")
    return mod.NumerosityDataset(imgs, labels.astype(np.float32),
                                 np.eye(K, dtype=np.float32)[labels],
                                 rs.rand(N), rs.rand(N), **extra)


class PerBatch:
    """A loader without ``materialize()``: batches, ``batch_size`` and
    the shuffle counter of the loader it wraps."""

    def __init__(self, inner):
        self.inner = inner

    def __iter__(self):
        return iter(self.inner)

    @property
    def batch_size(self):
        return self.inner.batch_size

    @property
    def _epoch(self):
        return self.inner._epoch

    @_epoch.setter
    def _epoch(self, v):
        self.inner._epoch = v


def _loader(mod, shuffle=True, bimodal=False, per_batch=True):
    ld = mod.DataLoader(_dataset(mod, bimodal), batch_size=BS,
                        shuffle=shuffle, seed=3)
    return PerBatch(ld) if per_batch else ld


def _copy_weights(jrbms, trbms, rs):
    for jr, tr in zip(jrbms, trbms):
        f = np_state(rs, jr.num_visible, jr.num_hidden)
        jr.state, tr.state = jax_state(f), torch_state(f)


def _assert_close_models(tm, jm):
    want = rbm_arrays(jm)
    got = rbm_arrays(tm)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], ATOL)


def _idbns():
    jm = JiDBN([D, 24, 12], dict(PARAMS), _loader(jloaders), None, seed=0)
    tm = iDBN([D, 24, 12], dict(PARAMS), _loader(tloaders), device="cpu",
              seed=0)
    _copy_weights(jm.layers, tm.layers, np.random.RandomState(1))
    return jm, tm


def _imdbns(per_batch=True, shuffle=True):
    kw = dict(params=dict(PARAMS), num_labels=K, seed=0)
    jm = JiMDBN([D, 24, 12], joint_layer_size=10,
                dataloader=_loader(jloaders, shuffle, per_batch=per_batch),
                **kw)
    tm = iMDBN([D, 24, 12], 10,
               dataloader=_loader(tloaders, shuffle, per_batch=per_batch),
               device="cpu", **kw)
    rs = np.random.RandomState(2)
    _copy_weights(list(jm.image_idbn.layers) + [jm.joint_rbm],
                  list(tm.image_idbn.layers) + [tm.joint_rbm], rs)
    return jm, tm


def _bimodals():
    layers = ([D, 12], [D2, 10], [9, 5])
    jm = JBiModal(*layers, params=dict(PARAMS),
                  dataloader=_loader(jloaders, bimodal=True), seed=0)
    tm = iMDBN_BiModal(*layers, params=dict(PARAMS),
                       dataloader=_loader(tloaders, bimodal=True),
                       device="cpu", seed=0)
    rs = np.random.RandomState(3)
    _copy_weights([*jm.mod1_dbn.layers, *jm.mod2_dbn.layers,
                   *jm.joint_layers],
                  [*tm.mod1_dbn.layers, *tm.mod2_dbn.layers,
                   *tm.joint_layers], rs)
    return jm, tm


def test_idbn_per_batch_matches_jax(monkeypatch):
    jm, tm = _idbns()
    with both_deterministic(monkeypatch):
        jm.train(3, fused=False)
        tm.train(3, fused=False)
    _assert_close_models(tm, jm)
    np.testing.assert_allclose(tm.loss_history, jm.loss_history, rtol=0,
                               atol=ATOL)
    assert tm.dataloader._epoch == jm.dataloader._epoch == 3


def test_imdbn_per_batch_joint_matches_jax(monkeypatch):
    """The bias init iterating the loader, then joint epochs 7-9: the
    last warm-up epoch and two main ones (every batch kind of both)."""
    jm, tm = _imdbns()
    jm.init_joint_bias_from_data()
    tm.init_joint_bias_from_data()
    close(tm.z_class_mean, jm.z_class_mean, ATOL)
    close(tm.joint_rbm.vis_bias, jm.joint_rbm.vis_bias, ATOL)
    assert tm.dataloader._epoch == jm.dataloader._epoch == 1
    with both_deterministic(monkeypatch):
        jm.train_joint(10, fused=False, start_epoch=7)
        tm.train_joint(10, fused=False, start_epoch=7)
    _assert_close_models(tm, jm)
    assert tm.last_metrics.keys() == jm.last_metrics.keys()
    for k, v in jm.last_metrics.items():
        np.testing.assert_allclose(tm.last_metrics[k], v, rtol=0,
                                   atol=ATOL, err_msg=k)
    # a resumed loop's counter is one per epoch trained
    assert tm.dataloader._epoch == jm.dataloader._epoch == 10


def test_bimodal_per_batch_joint_matches_jax(monkeypatch):
    jm, tm = _bimodals()
    jm.init_joint_bias_from_data()
    tm.init_joint_bias_from_data()
    with both_deterministic(monkeypatch):
        jm.train_joint(9, fused=False, start_epoch=7)
        tm.train_joint(9, fused=False, start_epoch=7)
    _assert_close_models(tm, jm)
    for k, v in jm.last_metrics.items():
        np.testing.assert_allclose(tm.last_metrics[k], v, rtol=0,
                                   atol=ATOL, err_msg=k)


def test_iterate_branch_equals_materialize_rows():
    """Over an unshuffled loader, the iterate branch of
    ``_materialized_train(limit)`` returns the materialize branch's first
    ``limit`` rows; so does the JAX package's."""
    _, whole = _imdbns(per_batch=False, shuffle=False)
    _, part = _imdbns(per_batch=True, shuffle=False)
    X, Y, Z = whole._materialized_train()
    for limit in (10, 16, 30, None):
        got = part._materialized_train(limit)
        n = N if limit is None else limit
        for a, b in zip(got, (X, Y, Z)):
            assert a.shape[0] == n
            torch.testing.assert_close(a, b[:n], rtol=0, atol=1e-6)
    jm, _ = _imdbns(per_batch=True, shuffle=False)
    for a, b in zip(part._materialized_train(30), jm._materialized_train(30)):
        close(a, b, ATOL)


def test_fused_none_picks_the_path_by_loader():
    _, a = _idbns()
    a.train(2)                       # no materialize(): the per-batch loop
    _, b = _idbns()
    b.train(2, fused=False)
    assert_models_equal(a, b)
    assert a.dataloader._epoch == 2
    c = iDBN([D, 24, 12], dict(PARAMS),
             _loader(tloaders, per_batch=False), device="cpu", seed=0)
    d = iDBN([D, 24, 12], dict(PARAMS),
             _loader(tloaders, per_batch=False), device="cpu", seed=0)
    c.train(2)                       # materialize(): the fused epochs
    d.train(2, fused=True)
    assert_models_equal(c, d)
    assert c.dataloader._epoch == 0  # the fused epochs draw no shuffle
    with pytest.raises(AttributeError):
        iDBN([D, 24, 12], dict(PARAMS), _loader(tloaders), device="cpu",
             seed=0).train(1, fused=True)


def test_idbn_per_batch_resume_bit_identical(tmp_path):
    ck = str(tmp_path / "idbn_pb.ckpt")
    _, a = _idbns()
    a.train(4, fused=False)
    _, b = _idbns()
    b.train(4, fused=False, checkpoint_every=2, checkpoint_path=ck)
    assert_models_equal(a, b)
    # a fresh model and loader: the restored counter sets the shuffle
    _, c = _idbns()
    phase, nxt = tck.load_train_checkpoint(c, ck)
    assert (phase, nxt) == ("image", 2)
    c.train(4, fused=False, start_epoch=2)
    assert_models_equal(a, c)
    assert c.loss_history == a.loss_history


def test_imdbn_joint_per_batch_resume_bit_identical(tmp_path):
    """The counter of a loader iterated by the bias init runs one ahead of
    the epochs trained; the resume restores it rather than guessing."""
    ck = str(tmp_path / "joint_pb.ckpt")
    _, a = _imdbns()
    a.train_joint(9, fused=False)
    _, b = _imdbns()
    b.train_joint(9, fused=False, checkpoint_every=4, checkpoint_path=ck)
    assert_models_equal(a, b)
    _, c = _imdbns()
    phase, nxt = tck.load_train_checkpoint(c, ck)
    assert (phase, nxt) == ("joint", 8)
    assert c.dataloader._epoch == nxt + 1
    c.train_joint(9, fused=False, start_epoch=nxt)
    assert_models_equal(a, c)
    assert c.joint_metrics_history == a.joint_metrics_history


def test_bimodal_joint_per_batch_resume_bit_identical(tmp_path):
    ck = str(tmp_path / "bimodal_pb.ckpt")
    _, a = _bimodals()
    a.train_joint(9, fused=False)
    _, b = _bimodals()
    b.train_joint(9, fused=False, checkpoint_every=4, checkpoint_path=ck)
    assert_models_equal(a, b)
    _, c = _bimodals()
    phase, nxt = tck.load_train_checkpoint(c, ck)
    assert (phase, nxt) == ("bimodal_joint", 8)
    c.train_joint(9, fused=False, start_epoch=nxt)
    assert_models_equal(a, c)
