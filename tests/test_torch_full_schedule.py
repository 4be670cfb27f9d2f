"""The shape of the shipped schedules, held against the JAX package at
small widths: the port's and JAX's models trained side by side through
the fused epochs (``iDBN.train``, ``train_joint``) for 7 modality epochs
and 17 joint epochs, with ``JOINT_AUX_EVERY_K`` set as the YAMLs set it.
That reaches the parts of the schedule the chip's cut runs never reach:
the switch to the final momentum after epoch 5 (ops/schedules.py:78-80),
the learning-rate decay over many epochs (:71-75), the end of the
8-epoch warm-up and nine main joint epochs after it.

Both sides run in their deterministic sampler modes
(tests/torch_parity.py, ``both_deterministic``), and both epoch
permutations are the identity (the port's Philox order and JAX's
threefry order differ by design), so the two trajectories are the same
arithmetic. Tolerance: atol 1e-4 on every state, loss and metric after
the whole schedule (1e-5 per short run elsewhere, grown over 24 epochs
of updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_idbn_tpu.data import loaders as jloaders
from multimodal_idbn_tpu.models import iMDBN as JiMDBN
from multimodal_idbn_tpu.models import iMDBN_BiModal as JBiModal
from multimodal_idbn_tpu_torch.data import loaders as tloaders
from multimodal_idbn_tpu_torch.models import iMDBN, iMDBN_BiModal
from multimodal_idbn_tpu_torch.ops import rng as trng

from torch_parity import (SMALL_PARAMS, both_deterministic, close,
                          jax_state, np_state, rbm_arrays, torch_state)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several workers at once, and
    torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4
N, D, D2, K, BS = 44, 64, 48, 4, 16   # two batches of 16 and 12 rows
EPOCHS_IMG, EPOCHS_JOINT = 7, 17
PARAMS = dict(SMALL_PARAMS, CD=2, JOINT_CD=2, FINAL_MOMENTUM=0.95,
              JOINT_AUX_EVERY_K=15, JOINT_AUX_COND_STEPS=3)


def _dataset(mod, mode="multimodal"):
    rs = np.random.RandomState(0)
    imgs = (rs.rand(N, D) > 0.7).astype(np.float32)
    labels = rs.randint(0, K, N)
    mod2 = (rs.rand(N, D2) > 0.6).astype(np.float32)
    return mod.NumerosityDataset(imgs, labels.astype(np.float32),
                                 np.eye(K, dtype=np.float32)[labels],
                                 rs.rand(N), rs.rand(N), mod2_images=mod2,
                                 mode=mode)


def _loader(mod, mode="multimodal"):
    return mod.DataLoader(_dataset(mod, mode), batch_size=BS, shuffle=True,
                          seed=3)


def _copy_weights(jrbms, trbms, seed):
    rs = np.random.RandomState(seed)
    for jr, tr in zip(jrbms, trbms):
        f = np_state(rs, jr.num_visible, jr.num_hidden)
        jr.state, tr.state = jax_state(f), torch_state(f)


@pytest.fixture
def identity_order(monkeypatch):
    """Both packages' epoch permutations replaced by the identity."""
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n, *a, **k: jnp.arange(n))
    monkeypatch.setattr(trng, "permutation", lambda key, n: torch.arange(n))


def _assert_close_models(tm, jm):
    want, got = rbm_arrays(jm), rbm_arrays(tm)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], ATOL)


def test_imdbn_full_schedule_shape_matches_jax(monkeypatch, identity_order):
    kw = dict(params=dict(PARAMS), num_labels=K, seed=0)
    jm = JiMDBN([D, 24, 12], joint_layer_size=10,
                dataloader=_loader(jloaders), **kw)
    tm = iMDBN([D, 24, 12], 10, dataloader=_loader(tloaders), device="cpu",
               **kw)
    _copy_weights(list(jm.image_idbn.layers) + [jm.joint_rbm],
                  list(tm.image_idbn.layers) + [tm.joint_rbm], 2)
    with both_deterministic(monkeypatch):
        jm.image_idbn.train(EPOCHS_IMG)
        tm.image_idbn.train(EPOCHS_IMG)
        close(torch.as_tensor(tm.image_idbn.loss_history),
              jm.image_idbn.loss_history, ATOL)
        jm.train_joint(EPOCHS_JOINT)
        tm.train_joint(EPOCHS_JOINT)
    _assert_close_models(tm, jm)
    close(tm.z_class_mean, jm.z_class_mean, ATOL)
    assert len(tm.image_idbn.loss_history) == EPOCHS_IMG
    # the last epoch's cross-modal metrics and the history of every epoch
    assert tm.last_metrics.keys() == jm.last_metrics.keys()
    for k, v in jm.last_metrics.items():
        np.testing.assert_allclose(tm.last_metrics[k], v, rtol=0, atol=ATOL,
                                   err_msg=k)
    assert len(tm.joint_metrics_history) == len(jm.joint_metrics_history) \
        == EPOCHS_JOINT
    for a, b in zip(tm.joint_metrics_history, jm.joint_metrics_history):
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, rtol=0, atol=ATOL,
                                       err_msg=f"epoch {b['epoch']} {k}")


def test_bimodal_full_schedule_shape_matches_jax(monkeypatch,
                                                 identity_order):
    layers = ([D, 12], [D2, 10], [9, 5])
    jm = JBiModal(*layers, params=dict(PARAMS),
                  dataloader=_loader(jloaders, "bimodal"), seed=0)
    tm = iMDBN_BiModal(*layers, params=dict(PARAMS),
                       dataloader=_loader(tloaders, "bimodal"),
                       device="cpu", seed=0)
    for m, mod in ((jm, jloaders), (tm, tloaders)):
        m.mod1_dbn.dataloader = _loader(mod, "multimodal")
        m.mod2_dbn.dataloader = _loader(mod, "mod2")
    _copy_weights([*jm.mod1_dbn.layers, *jm.mod2_dbn.layers,
                   *jm.joint_layers],
                  [*tm.mod1_dbn.layers, *tm.mod2_dbn.layers,
                   *tm.joint_layers], 3)
    with both_deterministic(monkeypatch):
        for m in (jm, tm):
            m.mod1_dbn.train(EPOCHS_IMG)
            m.mod2_dbn.train(EPOCHS_IMG)
            m.train_joint(EPOCHS_JOINT)
    _assert_close_models(tm, jm)
    for a, b in ((tm.mod1_dbn, jm.mod1_dbn), (tm.mod2_dbn, jm.mod2_dbn)):
        close(torch.as_tensor(a.loss_history), b.loss_history, ATOL)
    assert tm.last_metrics.keys() == jm.last_metrics.keys()
    for k, v in jm.last_metrics.items():
        np.testing.assert_allclose(tm.last_metrics[k], v, rtol=0, atol=ATOL,
                                   err_msg=k)
