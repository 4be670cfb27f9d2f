"""The half-step entries of visible units that are not Bernoulli
(``half_step_gauss``, ``half_step_linear``, ``half_step_scaled``) and the
replicated-softmax sampler (``rsoftmax.rs_sample``) on the card: each on
both kernel bodies against its plain version, at ragged shapes and at the
multimodal DBN's ([128, 3857]·[3857, 1024] and its 2000-word pathway),
bit-equal repeats, the launch counters by entry and body, and an epoch of
each pathway replayed as a CUDA graph against launch by launch.

Needs an NVIDIA GPU (marker ``cuda``); without one every test skips. This
file imports no JAX; run it on the card with

    python -m pytest tests/test_torch_cuda_mdbn.py -m cuda --noconftest -q

Tolerances as in ``test_torch_cuda.py``: 1e-5 on probabilities and means
(fp32, another summation order; 1e-4 against the largest mean where the
contraction is 3857 real-valued terms); a Bernoulli sample may differ only
where |p - u| <= 1e-5, a Gaussian sample by its mean's difference.
"""

import pytest
import torch

from multimodal_idbn_tpu_torch.ops import half_step, rng, rsoftmax

pytestmark = pytest.mark.cuda
TOL = 1e-5

# (B, K, N) of each body: ragged (mma_sync), aligned (wgmma), the 26-row
# remainder batch, and the multimodal DBN's bottom layers
SHAPES = [(37, 77, 130), (128, 1024, 2000), (26, 1024, 2000),
          (128, 1024, 3857), (128, 2000, 1024), (128, 3857, 1024),
          (26, 3857, 1024), (1, 5, 3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _operands(B, K, N, transpose, dev, real=True):
    g = torch.Generator().manual_seed(B * 7 + K + N)
    w = (torch.randn((N, K) if transpose else (K, N), generator=g)
         * K ** -0.5).to(dev)
    b = (0.1 * torch.randn(N, generator=g)).to(dev)
    x = torch.randn((B, K), generator=g) if real else \
        (torch.rand((B, K), generator=g) < 0.4).float()
    return x.to(dev), w, b


def _counts(entry):
    return half_step.KERNEL.launches_by_entry[entry], dict(
        half_step.KERNEL.launches_by_body)


@pytest.mark.parametrize("B,K,N", SHAPES)
def test_gauss_entry_vs_plain(dev, B, K, N):
    h, w, b = _operands(B, K, N, True, dev, real=False)
    n0, bodies = _counts("half_step_gauss")
    mean, sample = half_step.half_step_gauss(h, w, b, 91)
    body = half_step.plan(B, K, N)[0]
    assert half_step.KERNEL.launches_by_entry["half_step_gauss"] == n0 + 1
    assert half_step.KERNEL.launches_by_body[body] == bodies[body] + 1
    m_p, s_p = half_step.half_step_gauss_plain(h.cpu(), w.cpu(), b.cpu(), 91)
    assert float((mean.cpu() - m_p).abs().max()) <= TOL
    noise = rng.philox_normal(91, B, N)
    assert float(((sample.cpu() - mean.cpu()) - noise).abs().max()) <= TOL
    again = half_step.half_step_gauss(h, w, b, 91)
    assert torch.equal(again[0], mean) and torch.equal(again[1], sample)


@pytest.mark.parametrize("B,K,N", SHAPES)
def test_linear_entry_vs_plain(dev, B, K, N):
    h, w, b = _operands(B, K, N, True, dev, real=False)
    n0, _ = _counts("half_step_linear")
    out = half_step.half_step_linear(h, w, b, 0.7)
    assert half_step.KERNEL.launches_by_entry["half_step_linear"] == n0 + 1
    ref = half_step.half_step_linear_plain(h.cpu(), w.cpu(), b.cpu(), 0.7)
    assert float((out.cpu() - ref).abs().max()) <= TOL
    assert torch.equal(half_step.half_step_linear(h, w, b, 0.7), out)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("B,K,N", SHAPES)
def test_scaled_entry_vs_plain(dev, B, K, N, real):
    x, w, b = _operands(B, K, N, False, dev, real=real)
    scale = torch.randint(1, 11, (B,)).float().to(dev)
    n0, _ = _counts("half_step_scaled")
    p, s = half_step.half_step_scaled(x, w, b, scale, 17)
    assert half_step.KERNEL.launches_by_entry["half_step_scaled"] == n0 + 1
    p_p, s_p = half_step.half_step_scaled_plain(x.cpu(), w.cpu(), b.cpu(),
                                                scale.cpu(), 17)
    tol = TOL if not real else 1e-4
    assert float((p.cpu() - p_p).abs().max()) <= tol
    u = rng.philox_uniform(17, B, N)
    assert not bool(((s.cpu() != s_p) & ((p_p - u).abs() > tol)).any())
    again = half_step.half_step_scaled(x, w, b, scale, 17)
    assert torch.equal(again[0], p) and torch.equal(again[1], s)


@pytest.mark.parametrize("B,K,N", [(128, 3857, 1024), (26, 3857, 1024)])
def test_real_valued_x_keeps_fp32_accuracy_on_mma_sync(dev, B, K, N):
    """The Gaussian layer's up pass (real-valued x, ragged K): the
    Bernoulli entry on the mma_sync body at fp32 accuracy."""
    x, w, b = _operands(B, K, N, False, dev, real=True)
    assert half_step.plan(B, K, N)[0] == "mma_sync"
    p, _ = half_step.half_step_sample(x, w, b, 5)
    ref = torch.sigmoid(x.double() @ w.double() + b.double())
    assert float((p.double() - ref).abs().max()) <= 1e-5


def test_scaled_entry_refuses_a_scale_of_other_rows(dev):
    x, w, b = _operands(8, 16, 12, False, dev)
    with pytest.raises(ValueError):
        half_step.half_step_scaled(x, w, b, torch.ones(3, device=dev), 1)


@pytest.mark.parametrize("B,V", [(128, 2000), (26, 2000), (5, 3), (7, 300)])
def test_rs_sample_kernel_vs_plain(dev, B, V):
    g = torch.Generator().manual_seed(B + V)
    logits = (2.0 * torch.randn((B, V), generator=g)).to(dev)
    words = torch.randint(1, 11, (B,), generator=g).float().to(dev)
    n0 = rsoftmax.KERNEL.launches
    counts, mean = rsoftmax.rs_sample(logits, words, 33)
    assert rsoftmax.KERNEL.launches == n0 + 1
    assert torch.equal(counts.sum(1), words)
    c_p, m_p = rsoftmax.rs_sample_plain(logits.cpu(), words.cpu(), 33)
    assert float((mean.cpu() - m_p).abs().max()) <= TOL
    # the same words wherever the two exp agree: every row, bar a draw on
    # a boundary of the cumulative weights
    differ = (counts.cpu() != c_p).any(1).float().mean()
    assert float(differ) <= 0.02
    again = rsoftmax.rs_sample(logits, words, 33)
    assert torch.equal(again[0], counts) and torch.equal(again[1], mean)


@pytest.mark.parametrize("visible", ["gaussian", "replicated_softmax"])
def test_pathway_epoch_replayed_equal_launch_by_launch(dev, visible):
    """An epoch of a pathway at its published widths as one CUDA graph
    replay (new keys from the key table) against the same epoch launch by
    launch: bit-equal states and loss."""
    from multimodal_idbn_tpu_torch.ops import dbn_train
    from multimodal_idbn_tpu_torch.ops.rbm_ops import init_rbm_state
    g = torch.Generator().manual_seed(3)
    sizes = [3857, 1024, 1024] if visible == "gaussian" else [2000, 1024,
                                                              1024]
    n = 300
    if visible == "gaussian":
        data = torch.randn((n, sizes[0]), generator=g)
    else:
        data = torch.zeros((n, sizes[0]))
        idx = torch.randint(0, sizes[0], (n, 10), generator=g)
        take = (torch.arange(10)[None] < torch.randint(1, 11, (n, 1),
                                                        generator=g)).float()
        data.scatter_add_(1, idx, take)
    data = data.to(dev)
    states = [init_rbm_state(i, v, h, device=dev)
              for i, (v, h) in enumerate(zip(sizes[:-1], sizes[1:]))]
    kw = dict(weight_decay=1e-4, sparsity_factor=0.1, cd=3,
              sparsity_flags=[False, False], batch_size=128,
              fast_sampler=True, visible=visible, visible_lr_scale=0.01)
    outs = []
    for graphed in (True, False):
        run = dbn_train.idbn_epoch_runner(data, graphed=graphed, **kw)
        st, sums, counts = dbn_train.idbn_epoch_block(
            states, 7, data, [0, 1], [0.1, 0.099], [0.5, 0.5], runner=run,
            **kw)
        outs.append((st, [float(s) for s in sums]))
    (a, la), (b, lb) = outs
    assert la == lb
    for x, y in zip(a, b):
        assert all(torch.equal(getattr(x, f), getattr(y, f))
                   for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m"))
