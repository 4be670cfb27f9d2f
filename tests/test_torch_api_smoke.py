"""The JAX package's API smoke test (tests/test_api_parity.py, the
reference's test_extraction.py) run against the port: the same imports,
constructors, shapes and attributes, with the package renamed and
``device="cpu"`` added where a model is built, since the port's entry
points run on ``cuda`` unless the CPU is asked for."""

import numpy as np
import pytest

PARAMS = {
    "LEARNING_RATE": 0.1, "WEIGHT_PENALTY": 1e-4, "INIT_MOMENTUM": 0.5,
    "FINAL_MOMENTUM": 0.9, "LEARNING_RATE_DYNAMIC": True, "CD": 1,
}


def test_imports():
    """Reference test_extraction.py:13-41."""
    from multimodal_idbn_tpu_torch import RBM, iDBN, iMDBN, iMDBN_BiModal  # noqa
    from multimodal_idbn_tpu_torch.models import RBM as RBM2  # noqa
    from multimodal_idbn_tpu_torch.data import (  # noqa
        create_dataloaders_uniform,
        create_dataloaders_zipfian,
    )
    from multimodal_idbn_tpu_torch.utils import (  # noqa
        compute_val_embeddings_and_features,
        log_linear_probe,
        plot_2d_embedding_and_correlations,
    )
    from multimodal_idbn_tpu_torch.checkpoint import (  # noqa
        export_reference_pickle,
        import_reference_pickle,
    )
    from multimodal_idbn_tpu_torch.parallel import make_mesh  # noqa


def test_rbm_instantiation_and_forward():
    """Reference test_extraction.py:44-79."""
    from multimodal_idbn_tpu_torch import RBM

    rbm = RBM(num_visible=784, num_hidden=500, learning_rate=0.1,
              weight_decay=1e-4, momentum=0.5, device="cpu")
    assert rbm.num_visible == 784
    assert rbm.num_hidden == 500
    assert np.asarray(rbm.W).shape == (784, 500)
    assert np.asarray(rbm.hid_bias).shape == (500,)
    assert np.asarray(rbm.vis_bias).shape == (784,)
    x = np.random.RandomState(0).rand(16, 784).astype(np.float32)
    h = rbm.forward(x)
    assert np.asarray(h).shape == (16, 500)
    v = rbm.backward(h)
    assert np.asarray(v).shape == (16, 784)
    logits = rbm.backward(h, return_logits=True)
    assert np.asarray(logits).shape == (16, 784)
    v_next, v_prob, hh, h_prob = rbm.gibbs_step(x)
    assert np.asarray(v_next).shape == (16, 784)
    assert np.asarray(h_prob).shape == (16, 500)


def test_rbm_init_statistics():
    """W ~ N(0,1)/sqrt(V), biases zero (reference rbm.py:70-79)."""
    from multimodal_idbn_tpu_torch import RBM

    rbm = RBM(1000, 300, 0.1, 1e-4, 0.5, seed=0, device="cpu")
    W = np.asarray(rbm.W)
    assert abs(W.std() - 1 / np.sqrt(1000)) < 0.005
    assert abs(W.mean()) < 0.005
    assert np.all(np.asarray(rbm.hid_bias) == 0)
    assert np.all(np.asarray(rbm.W_m) == 0)


def test_idbn_instantiation_with_plain_loader():
    """Reference test_extraction.py:82-131: loaders without the Subset
    metadata protocol exercise the features=None fallback (idbn.py:146)."""
    from multimodal_idbn_tpu_torch import iDBN

    class PlainLoader:
        def __init__(self, x, y, bs=16):
            self.x, self.y, self.bs = x, y, bs
            self.dataset = list(zip(x, y))

        def __iter__(self):
            for i in range(0, len(self.x), self.bs):
                yield self.x[i:i + self.bs], self.y[i:i + self.bs]

    rng = np.random.RandomState(0)
    x = (rng.rand(48, 64) > 0.5).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 48)]
    loader = PlainLoader(x, y)
    dbn = iDBN([64, 32, 16], {
        "LEARNING_RATE": 0.1, "WEIGHT_PENALTY": 1e-4, "INIT_MOMENTUM": 0.5,
        "FINAL_MOMENTUM": 0.9, "LEARNING_RATE_DYNAMIC": False, "CD": 1,
    }, loader, loader, device="cpu")
    assert dbn.features is None  # fallback path
    assert len(dbn.layers) == 2
    # per-batch training path works on the plain loader
    dbn.train(epochs=1, fused=False)
    z = dbn.represent(x[:4])
    assert np.asarray(z).shape == (4, 16)


def _imdbn(num_labels, hidden, **params):
    from multimodal_idbn_tpu_torch import iMDBN
    from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform

    train, val, _ = create_dataloaders_uniform(batch_size=8, n_samples=40,
                                               num_classes=num_labels,
                                               side=10, seed=0)
    m = iMDBN([100, hidden], {6: 20, 4: 16}[num_labels],
              params=dict(PARAMS, **params), dataloader=train,
              val_loader=val, num_labels=num_labels, device="cpu")
    return m, val


@pytest.mark.parametrize("case", ["instantiation_dims", "methods_shapes"])
def test_imdbn(case):
    """Reference test_extraction.py:134-192 (``instantiation_dims``) and
    :195-252 (``methods_shapes``: represent / reconstruct / decode)."""
    if case == "instantiation_dims":
        m, _ = _imdbn(6, 32)
        assert m.joint_rbm.num_visible == 32 + 6
        assert m.joint_rbm.num_hidden == 20
        assert m.Dz_img == 32
        assert m.num_labels == 6
        # unused-but-parsed params kept as attributes (SURVEY.md §2.2)
        assert hasattr(m, "aux_every_k")
        assert hasattr(m, "aux_cond_steps")
        return
    m, val = _imdbn(4, 24, CROSS_GIBBS_STEPS=3)
    img, y = next(iter(val))
    z = m.image_idbn.represent(img)
    assert np.asarray(z).shape == (len(img), 24)
    rec = m.image_idbn.reconstruct(img)
    assert np.asarray(rec).shape == (len(img), 100)
    dec = m.image_idbn.decode(z)
    assert np.asarray(dec).shape == (len(img), 100)
    h = m.represent((img, y))
    assert np.asarray(h).shape == (len(img), 16)
    imgs_rec, p_y = m._cross_reconstruct(z, y)
    assert np.asarray(p_y).shape == (len(img), 4)


def test_conditional_sampler_api_kept():
    """conditional_gibbs_annealed is defined-but-unused in the reference
    models (SURVEY.md §2.1(5)) — kept in the API."""
    from multimodal_idbn_tpu_torch import RBM

    rbm = RBM(20, 10, 0.1, 1e-4, 0.5, seed=0, device="cpu")
    vk = np.zeros((4, 20), np.float32)
    km = np.zeros((4, 20), np.float32)
    km[:, :10] = 1.0
    out = rbm.conditional_gibbs_annealed(vk, km, n_steps=4, T0=2.5, T1=1.0,
                                         sample_h_until=2, sample_v_every=2)
    assert np.asarray(out).shape == (4, 20)
    np.testing.assert_allclose(np.asarray(out)[:, :10], 0.0)


def test_version():
    import multimodal_idbn_tpu_torch

    assert multimodal_idbn_tpu_torch.__version__
