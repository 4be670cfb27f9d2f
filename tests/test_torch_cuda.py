"""The port's CUDA kernels against their plain versions on the card, at
ragged small shapes the flagship run does not reach (batch not a multiple
of the tiles, contraction lengths around the k-tiles and k-slices,
several softmax groups and groups across tile boundaries, zero-step
chains), and their run-to-run bit equality; ``half_step_sample_big``;
the diagnostics on the card: the same keys as on the CPU, training
unchanged by logging, the probe's predictions the same on both devices.

Needs an NVIDIA GPU (marker ``cuda``); without one every test skips. This
file imports no JAX, so it runs on a machine without it; tests/conftest.py
does import JAX, so run it there with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: 1e-5 on probabilities and chains (fp32, other summation
order); a Bernoulli sample may differ only where |p - u| <= 1e-5.
"""

import collections
import contextlib

import pytest
import torch

from multimodal_idbn_tpu_torch.ops import chain, fast_cd, half_step, rbm_ops
from multimodal_idbn_tpu_torch.ops import rng

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from multimodal_idbn_tpu_torch import resolve_device
    return resolve_device("cuda")


def _rand(g, *shape, dev, scale=1.0):
    return (scale * torch.randn(shape, generator=g)).to(dev)


@pytest.mark.parametrize("B,K,N,transpose,T", [
    (37, 77, 130, False, 1.0), (37, 77, 130, True, 1.0),
    (1, 1, 1, False, 1.0), (129, 513, 65, True, 0.7)])
def test_half_step_kernel_vs_plain(dev, B, K, N, transpose, T):
    g = torch.Generator().manual_seed(B + K)
    w = _rand(g, *((N, K) if transpose else (K, N)), dev=dev,
              scale=K ** -0.5)
    b = _rand(g, N, dev=dev, scale=0.1)
    x = (torch.rand((B, K), generator=g) < 0.4).float().to(dev)
    before = half_step.KERNEL.launches
    p_k, s_k = half_step.half_step_sample(x, w, b, 77, T,
                                          transpose_w=transpose)
    assert half_step.KERNEL.launches == before + 1
    p_p, s_p = half_step.half_step_plain(x, w, b, 77, T,
                                         transpose_w=transpose)
    torch.cuda.synchronize()
    assert float((p_k - p_p).abs().max()) <= TOL
    u = rng.philox_uniform(77, B, N, device=dev)
    assert not bool(((s_k != s_p) & ((p_p - u).abs() > TOL)).any())


@pytest.mark.parametrize("n_steps,noisy,final,mu", [
    (0, False, True, False), (5, False, True, False), (6, True, False, True),
    (0, True, False, True), (9, True, True, True)])
def test_chain_kernel_vs_plain(dev, n_steps, noisy, final, mu):
    g = torch.Generator().manual_seed(n_steps)
    B, V, H, Dz = 7, 29, 13, 10
    groups = ((10, 15), (20, 29))
    w = _rand(g, V, H, dev=dev, scale=V ** -0.5)
    hb, vb = _rand(g, H, dev=dev, scale=0.1), _rand(g, V, dev=dev, scale=0.1)
    vk = torch.rand((B, V), generator=g).to(dev)
    km = (torch.rand((B, V), generator=g) < 0.3).float().to(dev)
    v0 = vk * km + (1 - km) * torch.rand((B, V), generator=g).to(dev)
    sched = rbm_ops.annealed_schedule(n_steps, 3.0, 1.0, 0.9, 3, 0.9, 0.15)
    kw = dict(groups=groups, final_unclamped=final,
              seed=123 if noisy else None,
              mu=torch.rand((B, Dz), generator=g).to(dev) if mu else None)
    out_k = chain.clamped_chain(w, hb, vb, v0, vk, km, sched, **kw)
    out_p = chain.chain_plain(w, hb, vb, v0, vk, km, sched, **kw)
    torch.cuda.synchronize()
    assert float((out_k - out_p).abs().max()) <= TOL


def test_rbm_ops_route_to_kernels(dev):
    st = rbm_ops.init_rbm_state(1, 20, 8, device=dev)
    x = (torch.rand(6, 20, device=dev) < 0.5).float()
    km = torch.zeros(6, 20, device=dev)
    km[:, :15] = 1.0
    c0, h0 = chain.KERNEL.launches, half_step.KERNEL.launches
    rbm_ops.conditional_gibbs(st, 1, x, km, n_steps=3, groups=((15, 20),))
    rbm_ops.noisy_meanfield_annealed(st, 2, x, km, n_steps=4,
                                     groups=((15, 20),))
    new, _ = fast_cd.fast_sampled_cd_update(st, 3, x, lr=0.1, mom=0.5,
                                            weight_decay=1e-4, cd=2)
    again, _ = fast_cd.fast_sampled_cd_update(st, 3, x, lr=0.1, mom=0.5,
                                              weight_decay=1e-4, cd=2)
    assert chain.KERNEL.launches == c0 + 2
    assert half_step.KERNEL.launches == h0 + 10
    assert torch.equal(new.w, again.w)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, w, b = (torch.zeros(4, 5, device=dev), torch.zeros(5, 3, device=dev),
               torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        half_step.half_step_sample(x, w.cpu(), b, 0)
    with pytest.raises(TypeError):
        half_step.half_step_sample(x.double(), w.double(), b.double(), 0)
    with rng.deterministic(), pytest.raises(RuntimeError):
        half_step.half_step_sample(x, w, b, 0)


@pytest.mark.parametrize("B,V,H,T", [(37, 77, 130, 1.0), (1, 1, 1, 1.0),
                                     (129, 1568, 65, 0.7),
                                     (12, 2500, 1500, 1.0)])
def test_probs_and_resident_kernels_vs_plain(dev, B, V, H, T):
    g = torch.Generator().manual_seed(B + V)
    w = _rand(g, V, H, dev=dev, scale=V ** -0.5)
    b = _rand(g, H, dev=dev, scale=0.1)
    v = (torch.rand((B, V), generator=g) < 0.4).float().to(dev)
    before = dict(half_step.KERNEL.launches_by_entry)
    p_k = half_step.half_step_probs(v, w, b, T)
    p_r, s_r = half_step.half_step_sample_resident(v, w, b, -77, T)
    after = half_step.KERNEL.launches_by_entry
    assert after["half_step_probs"] == before["half_step_probs"] + 1
    assert (after["half_step_sample_resident"]
            == before["half_step_sample_resident"] + 1)
    assert after["half_step_sample"] == before["half_step_sample"]
    p_p = half_step.half_step_probs_plain(v, w, b, T)
    _, s_p = half_step.half_step_sample_resident_plain(v, w, b, -77, T)
    torch.cuda.synchronize()
    assert float((p_k - p_p).abs().max()) <= TOL
    assert torch.equal(p_r, p_k)
    u = rng.philox_uniform(-77 & 0xFFFFFFFF, B, H, device=dev)
    assert not bool(((s_r != s_p) & ((p_p - u).abs() > TOL)).any())


def test_hidden_probs_kernel_matches_rbm_ops(dev):
    st = rbm_ops.init_rbm_state(4, 1568, 500, device=dev)
    v = (torch.rand(12, 1568, device=dev) < 0.3).float()
    got = half_step.hidden_probs_kernel(st, v, 1.3)
    torch.cuda.synchronize()
    assert float((got - rbm_ops.hidden_probs(st, v, 1.3)).abs().max()) <= TOL


@pytest.mark.parametrize("B", [12, 5])
def test_chain_kernel_more_columns_than_threads(dev, B):
    """V = 2500 > 1024 threads: each thread loops over several columns
    in both halves, the re-clamp and the μ-pull (bimodal joint layer 0)."""
    g = torch.Generator().manual_seed(B)
    V, H, Dz = 2500, 1500, 1500
    w = _rand(g, V, H, dev=dev, scale=V ** -0.5)
    hb, vb = _rand(g, H, dev=dev, scale=0.1), _rand(g, V, dev=dev, scale=0.1)
    vk = torch.rand((B, V), generator=g).to(dev)
    km = torch.zeros((B, V), device=dev)
    km[:, :Dz] = 1.0
    v0 = vk * km + (1 - km) * torch.rand((B, V), generator=g).to(dev)
    sched = rbm_ops.annealed_schedule(7, 3.0, 1.0, 0.9, 2, 0.9, 0.15)
    kw = dict(seed=5, mu=torch.rand((B, 40), generator=g).to(dev))
    out_k = chain.clamped_chain(w, hb, vb, v0, vk, km, sched, **kw)
    out_p = chain.chain_plain(w, hb, vb, v0, vk, km, sched, **kw)
    torch.cuda.synchronize()
    assert float((out_k - out_p).abs().max()) <= TOL


def test_resident_seed_must_be_int32(dev):
    x, w, b = (torch.zeros(4, 5, device=dev), torch.zeros(5, 3, device=dev),
               torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        half_step.half_step_sample_resident(x, w, b, 1 << 31)
    with pytest.raises(ValueError):
        half_step.half_step_probs(x, w[:4], b)
    with rng.deterministic(), pytest.raises(RuntimeError):
        half_step.half_step_sample_resident(x, w, b, 0)


# ---------------------------------------------------------------------------
# Edges of the split-K tensor-core tile and of the cooperative chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B", [1, 12, 129])
@pytest.mark.parametrize("K", [1, 77, 513, 10000])
def test_half_step_tile_edges(dev, B, K, transpose):
    """K below one k-tile, not a multiple of 4 (4-byte copies), ragged
    across k-slices, and the first-layer length; batches below, at and
    above the row tiles."""
    g = torch.Generator().manual_seed(1000 * B + K)
    N = 131
    w = _rand(g, *((N, K) if transpose else (K, N)), dev=dev,
              scale=K ** -0.5)
    b = _rand(g, N, dev=dev, scale=0.1)
    x = (torch.rand((B, K), generator=g) < 0.4).float().to(dev)
    p_k, s_k = half_step.half_step_sample(x, w, b, 5, transpose_w=transpose)
    p_p, s_p = half_step.half_step_plain(x, w, b, 5, transpose_w=transpose)
    torch.cuda.synchronize()
    assert float((p_k - p_p).abs().max()) <= TOL
    u = rng.philox_uniform(5, B, N, device=dev)
    assert not bool(((s_k != s_p) & ((p_p - u).abs() > TOL)).any())


def test_half_step_refuses_non_contiguous(dev):
    x = torch.zeros(4, 10, device=dev)[:, ::2]
    w, b = torch.zeros(5, 3, device=dev), torch.zeros(3, device=dev)
    with pytest.raises(ValueError):
        half_step.half_step_sample(x, w, b, 0)
    with pytest.raises(ValueError):
        half_step.half_step_probs(x.contiguous(), w.T.contiguous().T, b)


@pytest.mark.parametrize("B,K,N", [(128, 10000, 1500), (26, 2500, 1500),
                                   (37, 1501, 499)])
def test_half_step_entries_are_deterministic(dev, B, K, N):
    """Two launches on the same inputs give the same bits, for every
    entry, and the entries agree with each other; under the wgmma body
    (the first two shapes) and the mma_sync body (the last)."""
    g = torch.Generator().manual_seed(K)
    w = _rand(g, K, N, dev=dev, scale=K ** -0.5)
    b = _rand(g, N, dev=dev, scale=0.1)
    x = (torch.rand((B, K), generator=g) < 0.4).float().to(dev)
    xt = (torch.rand((B, N), generator=g) < 0.4).float().to(dev)
    bt = _rand(g, K, dev=dev, scale=0.1)
    runs = [lambda: half_step.half_step_sample(x, w, b, 9),
            lambda: half_step.half_step_sample(xt, w, bt, 9,
                                               transpose_w=True),
            lambda: (half_step.half_step_probs(x, w, b),),
            lambda: half_step.half_step_sample_resident(x, w, b, 9)]
    body = half_step.plan(B, K, N)[0]
    assert half_step.plan(B, N, K)[0] == body
    before = half_step.KERNEL.launches_by_body[body]
    outs = []
    for run in runs:
        first, second = run(), run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(first, second))
        outs.append(first)
    assert torch.equal(outs[0][0], outs[2][0])
    assert torch.equal(outs[2][0], outs[3][0])
    assert half_step.KERNEL.launches_by_body[body] == before + 2 * len(runs)


# Every layer of both families (tests/test_torch_chain_wrapper.py _LAYERS).
_LAYERS = [(10000, 1500), (1500, 500), (1500, 1500), (1568, 500),
           (500, 500), (500, 1000), (2500, 1500)]


@pytest.mark.parametrize("states", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("V,H", _LAYERS)
@pytest.mark.parametrize("B", [128, 26, 12])
def test_half_step_wgmma_body_at_the_shipped_shapes(dev, B, V, H, transpose,
                                                    states):
    """The wgmma body against the plain version at every layer of both
    families, in both directions, at the full batch and both remainder
    batches, on 0/1 states (x's TF32 tail zero) and on probabilities;
    each launch counted under its body."""
    g = torch.Generator().manual_seed(B + V + H)
    K, N = (H, V) if transpose else (V, H)
    w = _rand(g, V, H, dev=dev, scale=V ** -0.5)
    b = _rand(g, N, dev=dev, scale=0.1)
    x = torch.rand((B, K), generator=g)
    x = ((x < 0.3).float() if states else x).to(dev)
    assert half_step.plan(B, K, N)[0] == "wgmma"
    before = dict(half_step.KERNEL.launches_by_body)
    p_k, s_k = half_step.half_step_sample(x, w, b, 31, transpose_w=transpose)
    after = half_step.KERNEL.launches_by_body
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["mma_sync"] == before["mma_sync"]
    p_p, s_p = half_step.half_step_plain(x, w, b, 31, transpose_w=transpose)
    torch.cuda.synchronize()
    assert float((p_k - p_p).abs().max()) <= TOL
    u = rng.philox_uniform(31, B, N, device=dev)
    assert not bool(((s_k != s_p) & ((p_p - u).abs() > TOL)).any())


@pytest.mark.parametrize("B,K,N,body", [(37, 77, 130, "mma_sync"),
                                        (129, 512, 64, "mma_sync"),
                                        (128, 1500, 500, "wgmma"),
                                        (12, 40, 8, "wgmma")])
def test_half_step_body_counter(dev, B, K, N, body):
    """The body a launch runs, by the plan: wgmma where the rows are
    16-byte aligned and B <= 128, mma_sync at unaligned or taller shapes;
    counted on the wrapper and in the graphs' launch accounting."""
    from multimodal_idbn_tpu_torch.ops import graphs
    g = torch.Generator().manual_seed(K)
    x = (torch.rand((B, K), generator=g) < 0.4).float().to(dev)
    w = _rand(g, K, N, dev=dev, scale=K ** -0.5)
    b = _rand(g, N, dev=dev, scale=0.1)
    before = graphs.launch_counts()
    p_k, _ = half_step.half_step_sample(x, w, b, 3)
    assert graphs.launches_since(before) == {
        ("half_step.cu", "half_step_sample"): 1,
        ("half_step.cu", f"body:{body}"): 1}
    torch.cuda.synchronize()
    assert float((p_k - half_step.half_step_plain(x, w, b, 3)[0]).abs().max()
                 ) <= TOL


@pytest.mark.parametrize("transpose", [False, True])
def test_half_step_rank_parts_bit_equal_to_the_whole(dev, transpose):
    """A data-parallel rank's rows (row0) and a model-parallel rank's
    columns (col0; 750 columns, whose rows are not 16-byte aligned, and
    768, whose rows are), launched with the whole operand's plan, are the
    whole launch's rows and columns bit for bit. The first 64 rows of x
    are not TF32 numbers and the rest are 0/1, so the rank of rows 64..
    leaves out the hi.lo pass that the whole launch makes: its zeros do
    not move a bit."""
    g = torch.Generator().manual_seed(8)
    K, N = (1500, 10000) if transpose else (10000, 1500)
    w = _rand(g, *((N, K) if transpose else (K, N)), dev=dev,
              scale=K ** -0.5)
    b = _rand(g, N, dev=dev, scale=0.1)
    x = (torch.rand((128, K), generator=g) < 0.2).float()
    x[:64] *= torch.rand((64, K), generator=g)
    x = x.to(dev)
    seed = 0xC0FFEE
    assert half_step.plan(128, K, N)[0] == "wgmma"
    p_all, s_all = half_step.half_step_sample(x, w, b, seed,
                                              transpose_w=transpose)
    parts = [(x[64:], w, b, dict(row0=64), (slice(64, None), slice(None))),
             (x[:26], w, b, dict(row0=0), (slice(0, 26), slice(None)))]
    for c0 in (() if transpose else (750, 768)):
        parts.append((x, w[:, c0:].contiguous(), b[c0:], dict(col0=c0),
                      (slice(None), slice(c0, None))))
    for xp, wp, bp, off, (rs, cs) in parts:
        p_k, s_k = half_step.half_step_sample(
            xp, wp, bp, seed, transpose_w=transpose, plan_shape=(128, N),
            **off)
        torch.cuda.synchronize()
        assert torch.equal(p_k, p_all[rs, cs]), off
        assert torch.equal(s_k, s_all[rs, cs]), off


def test_half_step_replayed_in_a_graph_with_new_keys(dev):
    """One launch captured in a CUDA graph with its seed read from a key
    table, replayed after the table was refilled: equal to a launch
    outside the graph with that key by value."""
    g = torch.Generator().manual_seed(9)
    x = (torch.rand((128, 1500), generator=g) < 0.4).float().to(dev)
    w = _rand(g, 1500, 500, dev=dev, scale=1500 ** -0.5)
    b = _rand(g, 500, dev=dev, scale=0.1)
    path = (2, 5)
    keys = torch.tensor(rng.key_values(1, [path]), device=dev)

    def body():
        with rng.key_table(rng.KeyTable(keys, [path])):
            return half_step.half_step_sample(x, w, b, rng.Key(path))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        p_g, s_g = body()
    for root in (2, 3):
        value = rng.key_values(root, [path])
        keys.copy_(torch.tensor(value, device=dev))
        graph.replay()
        p_e, s_e = half_step.half_step_sample(x, w, b, value[0])
        torch.cuda.synchronize()
        assert torch.equal(p_g, p_e) and torch.equal(s_g, s_e)


def _chain_case(dev, B, V, H, groups, n_steps, seed):
    g = torch.Generator().manual_seed(seed)
    w = _rand(g, V, H, dev=dev, scale=V ** -0.5)
    hb, vb = _rand(g, H, dev=dev, scale=0.1), _rand(g, V, dev=dev, scale=0.1)
    vk = torch.rand((B, V), generator=g).to(dev)
    km = (torch.rand((B, V), generator=g) < 0.3).float().to(dev)
    v0 = vk * km + (1 - km) * torch.rand((B, V), generator=g).to(dev)
    sched = rbm_ops.annealed_schedule(n_steps, 3.0, 1.0, 0.9, 2, 0.9, 0.15)
    mu = torch.rand((B, min(V, 40)), generator=g).to(dev)
    return (w, hb, vb, v0, vk, km, sched), dict(groups=groups, mu=mu)


def _forced(args, kw, extra, body_name):
    """One launch of the chain kernel on the given body."""
    w, hb, vb, v0, vk, km, sched = args
    return chain._launch(w, hb, vb, v0, vk, km, sched, kw["groups"],
                         kw["mu"], extra.get("seed"),
                         extra.get("final_unclamped", False),
                         body_name=body_name)


@pytest.mark.parametrize("body", chain.BODIES)
@pytest.mark.parametrize("B,V,H,groups", [
    (37, 200, 90, ((56, 72), (120, 200))),       # groups across tile edges
    (9, 300, 70, tuple((30 * i, 30 * i + 17) for i in range(8))),  # 8 groups
    (1, 77, 33, ((3, 9),)), (129, 77, 130, ((60, 70),)),
    (128, 532, 500, ((500, 532),))])
def test_chain_tiles_and_groups(dev, B, V, H, groups, body):
    """Both bodies, forced, at ragged shapes: the cluster body's slices
    (groups moved inside one block's columns, blocks with no columns,
    a 129-row batch over clusters of 16 rows) and the grid body's tiles."""
    args, kw = _chain_case(dev, B, V, H, groups, 6, B + V)
    for extra in (dict(seed=3), dict(seed=None, final_unclamped=True)):
        before = chain.KERNEL.launches_by_body[body]
        out_k = _forced(args, kw, extra, body)
        assert chain.KERNEL.launches_by_body[body] == before + 1
        out_p = chain.chain_plain(*args, **kw, **extra)
        torch.cuda.synchronize()
        assert float((out_k - out_p).abs().max()) <= TOL


@pytest.mark.parametrize("final", [False, True])
def test_chain_zero_steps(dev, final):
    args, kw = _chain_case(dev, 37, 200, 90, ((56, 72),), 0, 1)
    out_k = chain.clamped_chain(*args, **kw, final_unclamped=final)
    out_p = chain.chain_plain(*args, **kw, final_unclamped=final)
    torch.cuda.synchronize()
    assert float((out_k - out_p).abs().max()) <= TOL
    if not final:
        assert torch.equal(out_k, args[3])


@pytest.mark.parametrize("B,V,H,groups", [
    (128, 2500, 1500, ()), (37, 131, 77, ((60, 70), (100, 131)))])
def test_chain_is_deterministic_and_launches_cooperatively(dev, B, V, H,
                                                           groups):
    """The grid body: the cooperative launch is taken at the bimodal joint
    (by the body rule; every block of the planned grid resident) and at a
    ragged shape with two groups (forced), and two launches give the same
    bits."""
    args, kw = _chain_case(dev, B, V, H, groups, 8, V)
    forced = None if chain.body(V, H, groups) == "grid" else "grid"
    assert forced is None or (V, H) != (2500, 1500)
    plan = chain.plan(B, V, H, 8, False, groups=groups, body_name=forced)
    assert plan["body"] == "grid" and plan["cluster"] == 0
    assert plan["grid"] >= 1 and plan["barriers"] == 1 + 4 * 8
    before = chain.KERNEL.launches
    grid_before = chain.KERNEL.launches_by_body["grid"]
    first = _forced(args, kw, dict(seed=4), forced)
    second = _forced(args, kw, dict(seed=4), forced)
    torch.cuda.synchronize()
    assert chain.KERNEL.launches == before + 2
    assert chain.KERNEL.launches_by_body["grid"] == grid_before + 2
    assert torch.equal(first, second)
    assert float((first - chain.chain_plain(*args, **kw, seed=4)).abs().max()
                 ) <= TOL


def _request_case(dev, B, family, steps=50):
    args, kw = _chain_case(dev, B, 532, 500, ((500, 532),), steps, B)
    if family == "noisy + mu":
        extra = dict(seed=B + 1)
    else:
        args = args[:6] + (torch.tensor([[1.0, 0.0, 0.0]]).repeat(steps, 1),)
        kw = dict(kw, mu=None)
        extra = dict(seed=None, final_unclamped=True)
    return args, kw, extra


@pytest.mark.parametrize("B", [1, 3, 26, 96, 128, 200])
@pytest.mark.parametrize("family", ["noisy + mu", "mean-field + final pass"])
def test_chain_at_request_sized_batches(dev, B, family):
    """The flagship joint (532x500, the 32-wide label group) at the batch
    sizes a serving request and a training epoch bring, 200 rows being more
    than the clusters the card holds at once: 50 steps as ``txt2img`` and
    ``img2txt`` run them, on the cluster body by the body rule, one launch
    each, counted as the cluster body's."""
    args, kw, extra = _request_case(dev, B, family)
    assert chain.body(532, 500, kw["groups"]) == "cluster"
    plan = chain.plan(B, 532, 500, 50, family != "noisy + mu",
                      groups=kw["groups"])
    assert (plan["body"], plan["cluster"], plan["barriers"]) == (
        "cluster", chain.CLUSTER_BLOCKS, 0)
    hw, bounds = chain.cluster_layout(532, 500, kw["groups"])
    tiles = -(-plan["tile_rows"] // 8)
    assert plan["smem_bytes"] == chain.cluster_smem_bytes(532, hw, bounds,
                                                          tiles)
    assert 1 <= plan["tile_rows"] <= 24
    assert plan["grid"] == chain.CLUSTER_BLOCKS * -(-B // plan["tile_rows"])
    before = chain.KERNEL.launches
    bodies = dict(chain.KERNEL.launches_by_body)
    out_k = chain.clamped_chain(*args, **kw, **extra)
    assert chain.KERNEL.launches == before + 1
    assert chain.KERNEL.launches_by_body == dict(
        bodies, cluster=bodies["cluster"] + 1)
    out_p = chain.chain_plain(*args, **kw, **extra)
    torch.cuda.synchronize()
    assert tuple(out_k.shape) == (B, 532)
    assert float((out_k - out_p).abs().max()) <= TOL
    assert torch.equal(out_k, chain.clamped_chain(*args, **kw, **extra))


@pytest.mark.parametrize("family", ["noisy + mu", "mean-field + final pass"])
def test_chain_cluster_skips_clamped_slices(dev, family):
    """Where a cluster's rows clamp every coordinate of a slice (as the
    IMG→TXT chain clamps the 500 latents), the cluster body computes and
    moves only the slices with a free coordinate from the second step on.
    The output matches the plain version, the clamped coordinates come
    back as their clamp values, and the rows are bit-equal to the same
    rows of a launch in which one more row of their cluster leaves every
    coordinate free, so that no slice is skipped there."""
    args, kw, extra = _request_case(dev, 128, family)
    w, hb, vb, v0, vk, km, sched = args
    km = torch.zeros_like(km)
    km[:, :500] = 1.0
    args = (w, hb, vb, v0, vk, km, sched)
    out_k = chain.clamped_chain(*args, **kw, **extra)
    out_p = chain.chain_plain(*args, **kw, **extra)
    km_free = km.clone()
    km_free[0] = 0.0
    out_free = chain.clamped_chain(*args[:5], km_free, sched, **kw, **extra)
    torch.cuda.synchronize()
    assert float((out_k - out_p).abs().max()) <= TOL
    if family == "noisy + mu":
        assert torch.equal(out_k[:, :500], vk[:, :500])
    rows = chain.plan(128, 532, 500, 50, family != "noisy + mu",
                      groups=kw["groups"])["tile_rows"]
    assert rows > 1
    assert torch.equal(out_free[1:rows], out_k[1:rows])


@pytest.mark.parametrize("family", ["noisy + mu", "mean-field + final pass"])
def test_chain_cluster_rows_are_the_whole_batch_rows(dev, family):
    """On the cluster body each row's sums are fixed by the shape alone:
    a B = 26 launch, and a rank's launch of rows 40..65 at ``row0`` 40 of
    a ``plan_rows`` 128 batch, are bit-equal to the same rows of the
    B = 128 launch, though their rows fall to other clusters."""
    args, kw, extra = _request_case(dev, 128, family)
    whole = chain.clamped_chain(*args, **kw, **extra)

    def rows(a, b):
        part = tuple(x[a:b] for x in args[3:6])
        pkw = dict(kw, mu=None if kw["mu"] is None else kw["mu"][a:b])
        return args[:3] + part + args[6:], pkw

    head_args, head_kw = rows(0, 26)
    head = chain.clamped_chain(*head_args, **head_kw, **extra)
    rank_args, rank_kw = rows(40, 66)
    rank = chain.clamped_chain(*rank_args, **rank_kw, **extra, row0=40,
                               plan_rows=128)
    torch.cuda.synchronize()
    assert torch.equal(head, whole[:26])
    assert torch.equal(rank, whole[40:66])
    if family == "noisy + mu":    # the rank's own noise rows matter
        other = chain.clamped_chain(*rank_args, **rank_kw, **extra)
        assert not torch.equal(other, rank)


@pytest.mark.parametrize("B,V,H", [(37, 1501, 499), (1, 1, 1),
                                   (129, 513, 65)])
def test_half_step_sample_big_vs_plain(dev, B, V, H):
    """JAX's standalone wrapper of the sampled half-step (one launch of
    the ``half_step_sample`` entry, unpadded) against its plain version."""
    g = torch.Generator().manual_seed(V)
    w = _rand(g, V, H, dev=dev, scale=V ** -0.5)
    b = _rand(g, H, dev=dev, scale=0.1)
    v = (torch.rand((B, V), generator=g) < 0.4).float().to(dev)
    before = half_step.KERNEL.launches_by_entry["half_step_sample"]
    p_k, s_k = half_step.half_step_sample_big(v, w, b, 21)
    assert half_step.KERNEL.launches_by_entry["half_step_sample"] == \
        before + 1
    p_p, s_p = half_step.half_step_sample_big_plain(v, w, b, 21)
    torch.cuda.synchronize()
    assert p_k.shape == s_k.shape == (B, H)
    assert float((p_k - p_p).abs().max()) <= TOL
    u = rng.philox_uniform(21, B, H, device=dev)
    assert not bool(((s_k != s_p) & ((p_p - u).abs() > TOL)).any())


def _small_imdbn(device, seed=0, **kw):
    from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform
    from multimodal_idbn_tpu_torch.models import iMDBN
    params = {"LEARNING_RATE": 0.1, "WEIGHT_PENALTY": 1e-4,
              "INIT_MOMENTUM": 0.5, "FINAL_MOMENTUM": 0.9,
              "LEARNING_RATE_DYNAMIC": True, "CD": 1, "JOINT_CD": 1,
              "JOINT_LEARNING_RATE": 0.04, "CROSS_GIBBS_STEPS": 5,
              "JOINT_AUX_COND_STEPS": 2, "SEED": 0}
    train, val, _ = create_dataloaders_uniform(
        batch_size=16, n_samples=64, num_classes=4, side=16, seed=0)
    return iMDBN([256, 64, 32], 24, params=params, dataloader=train,
                 val_loader=val, device=device, num_labels=4, seed=seed,
                 **kw)


def _states(model):
    return [getattr(r.state, f).cpu() for r in
            model.image_idbn.layers + [model.joint_rbm]
            for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m")]


def test_model_saved_on_the_card_loads_on_the_cpu_and_back(dev, tmp_path):
    """Train on the card, save; the pickle holds no device tensor, loads
    on the CPU with equal states and serves there within the kernels'
    tolerance; saved again from the CPU it loads back onto the card
    bit-equal, and serves through one chain launch per call."""
    from multimodal_idbn_tpu_torch.models import iMDBN
    m = _small_imdbn(dev)
    m.image_idbn.train(1)
    m.train_joint(1)
    p = str(tmp_path / "card.pkl")
    m.save_model(p)
    on_cpu = iMDBN.from_payload(iMDBN.load_model(p, device="cpu"))
    assert on_cpu.device == torch.device("cpu")
    assert all(not t.is_cuda for t in _states(on_cpu))
    assert all(torch.equal(a, b) for a, b in zip(_states(m), _states(on_cpu)))
    imgs = m.dataloader.materialize()[0][:5]
    for model in (m, on_cpu):
        model.joint_rbm.reseed(1)
    assert float((m.img2txt(imgs).cpu() - on_cpu.img2txt(imgs)).abs().max()
                 ) <= TOL
    p2 = str(tmp_path / "cpu.pkl")
    on_cpu.save_model(p2)
    back = iMDBN.from_payload(iMDBN.load_model(p2))
    assert back.device.type == "cuda" and back.joint_rbm.W.is_cuda
    assert back.z_class_mean.is_cuda
    assert all(torch.equal(a, b) for a, b in zip(_states(m), _states(back)))
    for model in (m, back):
        model.joint_rbm.reseed(2)
    c0, h0 = chain.KERNEL.launches, half_step.KERNEL.launches
    a = m.txt2img([0, 1, 2])
    assert (chain.KERNEL.launches, half_step.KERNEL.launches) == (c0 + 1, h0)
    assert torch.equal(a, back.txt2img([0, 1, 2]))
    assert torch.equal(m.img2txt(imgs), back.img2txt(imgs))
    assert chain.KERNEL.launches == c0 + 4
    assert torch.equal(m.sample_txt2img([3, 3], seed=5),
                       back.sample_txt2img([3, 3], seed=5))
    assert (chain.KERNEL.launches, half_step.KERNEL.launches) == (c0 + 4, h0)


def test_resume_on_the_card_is_bit_identical(dev, tmp_path):
    from multimodal_idbn_tpu_torch import checkpoint
    straight = _small_imdbn(dev)
    straight.image_idbn.train(3)
    straight.train_joint(10)
    ck_i, ck_j = str(tmp_path / "i.npz"), str(tmp_path / "j.npz")
    first = _small_imdbn(dev)
    first.image_idbn.train(3, checkpoint_every=2, checkpoint_path=ck_i)
    first.train_joint(10, checkpoint_every=9, checkpoint_path=ck_j)
    resumed = _small_imdbn(dev, seed=3)
    assert checkpoint.load_train_checkpoint(resumed.image_idbn, ck_i) == (
        "image", 2)
    resumed.image_idbn.train(3, start_epoch=2)
    assert checkpoint.load_train_checkpoint(resumed, ck_j) == ("joint", 9)
    resumed.train_joint(10, start_epoch=9)
    for other in (first, resumed):
        assert all(torch.equal(a, b)
                   for a, b in zip(_states(straight), _states(other)))
        assert other.joint_metrics_history == straight.joint_metrics_history


LOGGING = {s: {"enable": True} for s in ("energy", "trajectory", "neighbors",
                                         "convergence")}
LOGGING["convergence"]["num_steps"] = 6
LOGGING["trajectory"]["num_samples"] = 1


def _logged(device, arch_dir, run=None):
    m = _small_imdbn(device, wandb_run=run, logging_cfg=LOGGING)
    m.image_idbn.arch_dir = arch_dir
    m.image_idbn.train(2, log_every_pca=1, log_every_probe=1)
    m.train_joint(9, log_every_pca=8, log_every_probe=8, log_every=8)
    return m


def test_diagnostics_log_the_cpu_keys_on_the_card(dev, tmp_path):
    """The same small run with every diagnostic on, on the card and on the
    CPU: the same keys are logged, every number is finite and the probe
    accuracies lie in [0, 1]; a chain kernel ran for the snapshots."""
    from multimodal_idbn_tpu_torch.utils.wandb_compat import (RecorderRun,
                                                              all_finite)
    runs = {d: RecorderRun() for d in ("card", "cpu")}
    c0 = chain.KERNEL.launches
    _logged(dev, str(tmp_path), runs["card"])
    assert chain.KERNEL.launches > c0
    _logged("cpu", str(tmp_path), runs["cpu"])
    blank = {"warn/idbn_blank_recon"}   # a verdict on the weights
    assert runs["card"].keys() - blank == runs["cpu"].keys() - blank
    run = runs["card"]
    for k in run.numeric_keys():
        assert all(all_finite(v) for v in run.values(k)), k
        if k.endswith("/acc"):
            assert all(0.0 <= a <= 1.0 for a in run.values(k)), k
    assert not [k for k in run.keys() if k.startswith("warn/")
                and k not in blank and not k.endswith("_figure_skipped")]


def test_logging_leaves_training_unchanged_on_the_card(dev, tmp_path):
    from multimodal_idbn_tpu_torch.utils.wandb_compat import RecorderRun
    on = _logged(dev, str(tmp_path), RecorderRun())
    off = _logged(dev, str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(_states(on), _states(off)))
    assert on.joint_metrics_history == off.joint_metrics_history


def test_probe_predicts_the_same_on_both_devices(dev):
    """Given the same embeddings and initial weights, the probe's
    predictions agree on the card and on the CPU."""
    from multimodal_idbn_tpu_torch.utils import probe_utils
    g = torch.Generator().manual_seed(7)
    X = torch.randn((150, 40), generator=g)
    y = (X @ torch.randn((40, 5), generator=g)).argmax(dim=1).numpy()
    init = probe_utils.default_probe_init(40, 5)
    out = {d: probe_utils.train_linear_classifier(
        X[:110].to(d), y[:110], X[110:].to(d), y[110:], n_classes=5,
        init=init) for d in (dev, torch.device("cpu"))}
    assert out[dev] == out[torch.device("cpu")]
    assert out[dev][0] > 0.5


# ---------------------------------------------------------------------------
# The opt-in variants and the native generator on the card
# ---------------------------------------------------------------------------

def _pcd_inputs(g, dev, B=37, V=301, H=67):
    st = rbm_ops.init_rbm_state(3, V, H, device=dev)
    st = st.replace(hb=_rand(g, H, dev=dev, scale=0.1),
                    vb=_rand(g, V, dev=dev, scale=0.1))
    data = (torch.rand((B, V), generator=g) < 0.3).float().to(dev)
    chain_v = (torch.rand((B, V), generator=g) < 0.5).float().to(dev)
    return st, data, chain_v


def test_fp32_pcd_update_kernel_vs_plain(dev):
    """The fp32 PCD update through the half-step kernel (3 + 2·cd launches)
    against the same trainer on CPU copies (the plain half-steps, the
    same Philox draws): no sample flipped, states within 1e-5, and a
    second launch bit-equal."""
    g = torch.Generator().manual_seed(11)
    st, data, chain_v = _pcd_inputs(g, dev)
    kw = dict(lr=0.1, mom=0.5, weight_decay=1e-4, cd=3)
    half_step.KERNEL.reset_launches()
    s_k, c_k, l_k = fast_cd.fast_sampled_pcd_update(st, chain_v, 99, data,
                                                    **kw)
    assert half_step.KERNEL.launches_by_entry["half_step_sample"] == 3 + 2 * 3
    cpu = rbm_ops.RBMState(*(getattr(st, f).cpu() for f in (
        "w", "hb", "vb", "w_m", "hb_m", "vb_m")))
    s_p, c_p, l_p = fast_cd.fast_sampled_pcd_update(cpu, chain_v.cpu(), 99,
                                                    data.cpu(), **kw)
    assert torch.equal(c_k.cpu(), c_p)  # no sample flipped
    for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m"):
        assert float((getattr(s_k, f).cpu() - getattr(s_p, f))
                     .abs().max()) <= TOL
    assert abs(float(l_k) - float(l_p)) <= TOL
    again = fast_cd.fast_sampled_pcd_update(st, chain_v, 99, data, **kw)
    assert torch.equal(again[1], c_k) and torch.equal(again[0].w, s_k.w)


def test_bf16_route_launches_no_kernel(dev):
    """A bf16 image stack trains in plain torch on the card: no half-step
    launch; its states stay bf16 and finite."""
    from multimodal_idbn_tpu_torch.models import iDBN
    params = {"LEARNING_RATE": 0.1, "WEIGHT_PENALTY": 1e-4,
              "INIT_MOMENTUM": 0.5, "FINAL_MOMENTUM": 0.9,
              "LEARNING_RATE_DYNAMIC": True, "CD": 2, "DTYPE": "bfloat16"}

    class Loader:
        batch_size = 16

        def materialize(self):
            g = torch.Generator().manual_seed(0)
            return (torch.rand((40, 64), generator=g) < 0.3).float().numpy(),

    dbn = iDBN([64, 32, 16], params, Loader(), device=dev, seed=0)
    half_step.KERNEL.reset_launches()
    chain.KERNEL.reset_launches()
    dbn.train(2)
    torch.cuda.synchronize()
    assert half_step.KERNEL.launches == 0 and chain.KERNEL.launches == 0
    for r in dbn.layers:
        assert r.state.w.dtype == torch.bfloat16
        assert bool(torch.isfinite(r.state.w.float()).all())
    fp32 = iDBN([64, 32, 16], dict(params, DTYPE="float32", PCD=True),
                Loader(), device=dev, seed=0)
    fp32.train(1)
    # 2 full batches x 2 layers x (3 + 2 x CD-2), remainder by CD
    assert half_step.KERNEL.launches == 2 * 2 * 7 + 2 * 5


def test_bf16_joint_chains_run_the_kernel(dev):
    """A bf16-stored state's mean-field chains launch the chain kernel on
    its weights widened to fp32: bit-equal to the chains of an fp32 state
    that holds those widened weights (the kernel against its plain version
    is held by the tests above)."""
    st = rbm_ops.init_rbm_state(1, 20, 8, device=dev, dtype=torch.bfloat16)
    wide = rbm_ops.RBMState(**{f: getattr(st, f).float() for f in (
        "w", "hb", "vb", "w_m", "hb_m", "vb_m")})
    x = (torch.rand(6, 20, device=dev) < 0.5).float()
    km = torch.zeros(6, 20, device=dev)
    km[:, :15] = 1.0
    c0 = chain.KERNEL.launches
    outs = [(rbm_ops.conditional_gibbs(s, 1, x, km, n_steps=3,
                                       groups=((15, 20),)),
             rbm_ops.noisy_meanfield_annealed(s, 2, x, km, n_steps=4,
                                              groups=((15, 20),)))
            for s in (st, wide)]
    torch.cuda.synchronize()
    assert chain.KERNEL.launches == c0 + 4
    for a, b in zip(*outs):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_wrappers_still_raise_on_bf16(dev):
    x = torch.ones((4, 8), device=dev, dtype=torch.bfloat16)
    w = torch.ones((8, 5), device=dev, dtype=torch.bfloat16)
    b = torch.zeros((5,), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="expected float32"):
        half_step.half_step_sample(x, w, b, 1)
    sched = rbm_ops.annealed_schedule(3, 3.0, 1.0, 0.9, 3, 0.9, 0.15)
    v = torch.zeros((4, 8), device=dev)
    with pytest.raises(TypeError, match="expected float32"):
        chain.clamped_chain(w, b, torch.zeros(8, device=dev,
                                              dtype=torch.bfloat16),
                            v, v, v, sched)


def test_native_generator_builds_and_is_deterministic():
    import numpy as np
    from multimodal_idbn_tpu_torch.data import native
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert native.native_available()
    nums = np.arange(1, 33, dtype=np.int32)
    a = native.generate_dot_dataset_native(0, nums, side=100)
    b = native.generate_dot_dataset_native(0, nums, side=100)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[4], nums)


# ---------------------------------------------------------------------------
# Epochs replayed as CUDA graphs (ops.graphs) and the Philox fill
# ---------------------------------------------------------------------------

def _tree_equal(a, b):
    from multimodal_idbn_tpu_torch.ops import graphs
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    return sa == sb and all(x.dtype == y.dtype and torch.equal(x, y)
                            for x, y in zip(la, lb))


@pytest.mark.parametrize("rows,cols,row0,bits16", [
    (128, 1500, 0, False), (12, 2500, 116, False), (1, 1, 0, False),
    (500, 532, 0, True), (3, 70001, 5, True)])
def test_philox_fill_vs_plain(dev, rows, cols, row0, bits16):
    """Bit for bit against its plain version and a repeat, keyed by value
    and from a key table on the card."""
    from multimodal_idbn_tpu_torch.ops import philox_fill
    key = rng.fold_in(rng.fold_in(3, 1), 2)
    want = philox_fill.fill_plain(key, rows, cols, device=dev, row0=row0,
                                  bits16=bits16)
    got = philox_fill.fill(key, rows, cols, device=dev, row0=row0,
                           bits16=bits16)
    assert torch.equal(got, want)
    assert torch.equal(philox_fill.fill(key, rows, cols, device=dev,
                                        row0=row0, bits16=bits16), got)
    keys = torch.tensor(rng.key_values(3, [(1, 2)]), device=dev)
    with rng.key_table(rng.KeyTable(keys, [(1, 2)])):
        assert torch.equal(philox_fill.fill(rng.Key((1, 2)), rows, cols,
                                            device=dev, row0=row0,
                                            bits16=bits16), want)


def _joint_inputs(dev, bimodal):
    g = torch.Generator().manual_seed(7)
    N = 70                                   # two batches of 32 and 6 rows
    V = 48
    img = (torch.rand((N, V), generator=g) < 0.4).float().to(dev)
    if bimodal:
        Z1 = torch.rand((N, 20), generator=g).to(dev)
        Z2 = torch.rand((N, 12), generator=g).to(dev)
        V2 = (torch.rand((N, 30), generator=g) < 0.4).float().to(dev)
        m1 = [rbm_ops.init_rbm_state(1, V, 20, device=dev)]
        m2 = [rbm_ops.init_rbm_state(2, 30, 12, device=dev)]
        joint = [rbm_ops.init_rbm_state(3, 32, 24, device=dev),
                 rbm_ops.init_rbm_state(4, 24, 16, device=dev)]
        return (Z1, Z2, img, V2, m1, m2), joint
    K = 4
    Z = torch.rand((N, 20), generator=g).to(dev)
    Y = torch.eye(K)[torch.randint(0, K, (N,), generator=g)].to(dev)
    img_states = [rbm_ops.init_rbm_state(1, V, 20, device=dev)]
    joint = rbm_ops.init_rbm_state(3, 20 + K, 24, device=dev)
    return (Z, Y, img, img_states, Z[:K].clone()), joint


@pytest.mark.parametrize("bimodal", [False, True])
@pytest.mark.parametrize("warmup", [True, False])
def test_joint_epochs_replayed_equal_launch_by_launch(dev, bimodal, warmup):
    """Three joint epochs through a graphed runner (one capture, three
    replays) are bit-equal to the same epoch function run launch by
    launch, with the same kernel launches."""
    from multimodal_idbn_tpu_torch.ops import bimodal_ops, graphs, imdbn_ops
    consts, joint = _joint_inputs(dev, bimodal)
    if bimodal:
        kw = dict(warmup=warmup, joint_cd=2, aux_cond_steps=5, Dz1=20,
                  steps=6, batch_size=32)
        runner = bimodal_ops.bimodal_epoch_runner(*consts, 1e-4,
                                                  graphed=True, **kw)

        def block(**extra):
            return bimodal_ops.bimodal_epoch_block(
                joint, consts[4], consts[5], 9, *consts[:4], [0, 6, 7],
                [0.05, 0.04, 0.03], [0.5, 0.5, 0.9], 1e-4, **kw, **extra)
    else:
        kw = dict(warmup=warmup, joint_cd=2, aux_cond_steps=5, Dz=20,
                  steps=6, groups=((20, 24),), zclamp_every=2,
                  batch_size=32)
        Z, Y, img, img_states, zcm = consts
        runner = imdbn_ops.joint_epoch_runner(Z, Y, img, img_states, zcm,
                                              1e-4, graphed=True, **kw)

        def block(**extra):
            return imdbn_ops.joint_epoch_block(
                joint, img_states, 9, Z, Y, img, [0, 6, 7],
                [0.05, 0.04, 0.03], [0.5, 0.5, 0.9], 1e-4, zcm, **kw,
                **extra)
    before = graphs.launch_counts()
    eager = block()
    eager_launches = graphs.launches_since(before)
    before = graphs.launch_counts()
    replayed = block(runner=runner)
    torch.cuda.synchronize()
    assert graphs.launches_since(before) == eager_launches
    assert runner.replays == 3
    assert _tree_equal(replayed, eager)


@pytest.mark.parametrize("pcd", [False, True])
def test_image_epochs_replayed_equal_launch_by_launch(dev, pcd):
    from multimodal_idbn_tpu_torch.ops import dbn_train
    g = torch.Generator().manual_seed(3)
    data = (torch.rand((70, 300), generator=g) < 0.3).float().to(dev)
    states = [rbm_ops.init_rbm_state(1, 300, 64, device=dev),
              rbm_ops.init_rbm_state(2, 64, 32, device=dev)]
    chains = [(torch.rand((32, v), generator=g) < 0.5).float().to(dev)
              for v in (300, 64)]
    kw = dict(weight_decay=1e-4, sparsity_factor=0.05, cd=2,
              sparsity_flags=(False, True), batch_size=32, fast_sampler=True)
    args = ([0, 1, 6], [0.1, 0.09, 0.08], [0.5, 0.5, 0.9])
    if pcd:
        runner = dbn_train.idbn_epoch_runner(data, pcd=True, graphed=True,
                                             **kw)
        eager = dbn_train.idbn_epoch_block_pcd(states, chains, 5, data,
                                               *args, **kw)
        replayed = dbn_train.idbn_epoch_block_pcd(states, chains, 5, data,
                                                  *args, runner=runner, **kw)
    else:
        runner = dbn_train.idbn_epoch_runner(data, graphed=True, **kw)
        eager = dbn_train.idbn_epoch_block(states, 5, data, *args, **kw)
        replayed = dbn_train.idbn_epoch_block(states, 5, data, *args,
                                              runner=runner, **kw)
    assert runner.replays == 3 and _tree_equal(replayed, eager)


def test_image_epoch_graph_runs_every_half_step_on_the_wgmma_body(dev):
    """An image-iDBN epoch graph at the flagship widths [10000, 1500, 500]
    over 1434 rows in batches of 128 (11 full and one of 26), CD-10: each
    replay launches 12 x 2 x (1 + 2 x 10) = 504 half-steps, all of them on
    the wgmma body, and the replay advances the counter by body as it
    advances the counter by entry."""
    from multimodal_idbn_tpu_torch.ops import dbn_train, graphs
    g = torch.Generator().manual_seed(4)
    data = (torch.rand((1434, 10000), generator=g) < 0.15).float().to(dev)
    states = [rbm_ops.init_rbm_state(1, 10000, 1500, device=dev),
              rbm_ops.init_rbm_state(2, 1500, 500, device=dev)]
    kw = dict(weight_decay=1e-4, sparsity_factor=0.05, cd=10,
              sparsity_flags=(False, False), batch_size=128,
              fast_sampler=True)
    runner = dbn_train.idbn_epoch_runner(data, graphed=True, **kw)
    dbn_train.idbn_epoch_block(states, 5, data, [0], [0.1], [0.5], **kw,
                               runner=runner)
    per_replay = runner.launches_per_replay
    assert per_replay[("half_step.cu", "half_step_sample")] == 504
    assert per_replay[("half_step.cu", "body:wgmma")] == 504
    assert ("half_step.cu", "body:mma_sync") not in per_replay
    before = graphs.launch_counts()
    dbn_train.idbn_epoch_block(states, 5, data, [1], [0.1], [0.5], **kw,
                               runner=runner)
    torch.cuda.synchronize()
    after = graphs.launches_since(before)
    assert after[("half_step.cu", "body:wgmma")] == 504
    assert after[("half_step.cu", "half_step_sample")] == 504
    assert ("half_step.cu", "body:mma_sync") not in after


# -- serving calls as graph replays --------------------------------------------

def _small_bimodal(device):
    from multimodal_idbn_tpu_torch.data import create_dataloaders_uniform
    from multimodal_idbn_tpu_torch.models import iMDBN_BiModal
    params = {"LEARNING_RATE": 0.1, "WEIGHT_PENALTY": 1e-4,
              "INIT_MOMENTUM": 0.5, "FINAL_MOMENTUM": 0.9,
              "LEARNING_RATE_DYNAMIC": True, "CD": 1, "JOINT_CD": 1,
              "CROSS_GIBBS_STEPS": 4, "JOINT_AUX_COND_STEPS": 2, "SEED": 0}
    train, val, _ = create_dataloaders_uniform(
        batch_size=16, n_samples=64, num_classes=4, side=16, seed=0,
        second_modality="mnist100")
    return iMDBN_BiModal([256, 32], [1568, 32], [16], params=params,
                         dataloader=train, val_loader=val, device=device,
                         seed=0)


def _serving_calls(m, bimodal):
    """name -> call of every serving method of a small model, at two
    batch sizes."""
    import numpy as np
    if bimodal:
        v1, v2 = (torch.as_tensor(np.asarray(a[:8]), dtype=torch.float32)
                  for a in m.dataloader.materialize())
        z1, z2 = m._latents(v1, v2)
        calls = {}
        for b in (8, 3):
            calls.update({
                f"mod1_to_mod2 {b}": lambda m, b=b: m.mod1_to_mod2(v1[:b]),
                f"mod2_to_mod1 {b}": lambda m, b=b: m.mod2_to_mod1(v2[:b]),
                f"cross {b}": lambda m, b=b: m._cross_reconstruct(z1[:b],
                                                                  z2[:b]),
                f"sample 1to2 {b}": lambda m, b=b: m.sample_mod1_to_mod2(
                    v1[:b], seed=5),
                f"sample 2to1 {b}": lambda m, b=b: m.sample_mod2_to_mod1(
                    v2[:b]),
                f"represent {b}": lambda m, b=b: m.represent((v1[:b],
                                                              v2[:b])),
            })
        return calls
    img, y = next(iter(m.val_loader))
    img, y = np.asarray(img), np.asarray(y)
    calls = {}
    for b in (8, 1):
        calls.update({
            f"txt2img {b}": lambda m, b=b: m.txt2img(np.arange(b) % 4),
            f"img2txt {b}": lambda m, b=b: m.img2txt(img[:b]),
            f"sample_txt2img {b}": lambda m, b=b: m.sample_txt2img(
                np.arange(b) % 4, seed=3),
            f"sample_txt2img unseeded {b}": lambda m, b=b: m.sample_txt2img(
                np.arange(b) % 4),
            f"represent {b}": lambda m, b=b: m.represent((img[:b], y[:b])),
            f"reconstruct {b}": lambda m, b=b: m.image_idbn.reconstruct(
                img[:b]),
            f"decode {b}": lambda m, b=b: m.image_idbn.decode(
                m.image_idbn.represent(img[:b])),
        })
    return calls


def _three_ways(m, call):
    """``call(m)`` launch by launch, then through the graph cache twice,
    from the same key stream: the three outputs."""
    from multimodal_idbn_tpu_torch.ops import graphs
    outs = []
    for eager in (True, False, False):
        m.joint_rbm.reseed(11)
        with (graphs.launch_by_launch() if eager else
              contextlib.nullcontext()):
            outs.append(call(m))
    torch.cuda.synchronize()
    return outs


def _tree_equal(a, b):
    from multimodal_idbn_tpu_torch.ops import graphs
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


@contextlib.contextmanager
def _counted_replays(monkeypatch):
    """The replays of each serving graph inside the block, by the graph's
    ``id``."""
    from multimodal_idbn_tpu_torch.ops import graphs
    counts = collections.Counter()
    real = graphs.ServingGraphs._replay

    def counted(self, g, key):
        counts[id(g)] += 1
        return real(self, g, key)

    with monkeypatch.context() as mp:
        mp.setattr(graphs.ServingGraphs, "_replay", counted)
        yield counts


@contextlib.contextmanager
def _replays_without_sync(monkeypatch):
    """Every serving call inside the block (its buffers' refresh, key
    table, replay and clones; the inputs' copies to the card come before)
    under ``set_sync_debug_mode("error")``."""
    from multimodal_idbn_tpu_torch.ops import graphs
    real = graphs.ServingGraphs.call

    def checked(self, *a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    with monkeypatch.context() as mp:
        mp.setattr(graphs.ServingGraphs, "call", checked)
        yield


@pytest.mark.parametrize("bimodal", [False, True])
def test_serving_calls_replayed_equal_launch_by_launch(dev, monkeypatch,
                                                       bimodal):
    """Every serving method of both families: the first call through the
    cache (capture, replay) and a second (replay) bit-equal to launch by
    launch from the same key; one graph per call and shape; a replay
    launches what launch by launch launches and reads nothing on the
    host."""
    from multimodal_idbn_tpu_torch.ops import graphs
    with _counted_replays(monkeypatch) as replays:
        m = _small_bimodal(dev) if bimodal else _small_imdbn(dev)
        m.train_joint(2)
        for name, call in _serving_calls(m, bimodal).items():
            eager, first, again = _three_ways(m, call)
            assert _tree_equal(first, eager) and _tree_equal(again, eager), \
                name
            m.joint_rbm.reseed(11)
            before = graphs.launch_counts()
            with _replays_without_sync(monkeypatch):
                call(m)
            replayed = graphs.launches_since(before)
            m.joint_rbm.reseed(11)
            before = graphs.launch_counts()
            with graphs.launch_by_launch():
                call(m)
            assert replayed == graphs.launches_since(before), name
    # one graph per call and shape, replayed at every call after its
    # capture (the first call's, the second's and the checked one); the
    # cache also holds the bias statistics that training ran once
    serving = [g for g in m._serving.graphs.values()
               if g.name != "serve:joint_bias_stats"]
    assert serving and all(replays[id(g)] >= 3 for g in serving)


@pytest.mark.parametrize("how", ["train", "from_payload"])
def test_serving_graphs_follow_new_weights(dev, tmp_path, how):
    """A graph never serves old weights: after more training the same
    graphs serve the new weights (bit-equal to launch by launch, the
    output changed, no new capture); a model rebuilt from a payload
    serves what the saved model served."""
    from multimodal_idbn_tpu_torch.models import iMDBN
    from multimodal_idbn_tpu_torch.ops import graphs
    m = _small_imdbn(dev)
    m.image_idbn.train(1)
    m.train_joint(9)
    calls = _serving_calls(m, False)
    before = {name: _three_ways(m, call)[0] for name, call in calls.items()}
    if how == "train":
        m.image_idbn.train(2, start_epoch=1)
        m.train_joint(10, start_epoch=9)
        target = m
    else:
        path = str(tmp_path / "m.pkl")
        m.save_model(path)
        target = iMDBN.from_payload(iMDBN.load_model(path, device=dev))
        assert "_serving" not in target.__dict__
    graphs.reset_stats()
    for name, call in calls.items():
        eager, first, again = _three_ways(target, call)
        assert _tree_equal(first, eager) and _tree_equal(again, eager), name
        if how == "train":
            assert not _tree_equal(eager, before[name]), name
        else:
            assert _tree_equal(eager, before[name]), name
    if how == "train":     # the same graphs, refreshed
        assert not graphs.STATS["captures"]


# -- the rest of what the JAX package jits, as graph replays --------------------

@contextlib.contextmanager
def _updates_without_sync(monkeypatch):
    """Every serving call and in-place update inside the block that
    replays a graph captured before it under
    ``set_sync_debug_mode("error")``."""
    from multimodal_idbn_tpu_torch.ops import graphs
    real = graphs.ServingGraphs._replay

    def checked(self, g, key):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, g, key)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    with monkeypatch.context() as mp:
        mp.setattr(graphs.ServingGraphs, "_replay", checked)
        yield


def _shell(dev, groups):
    from multimodal_idbn_tpu_torch.models import RBM
    return RBM(40 + 8, 24, 0.1, 1e-4, 0.5, dynamic_lr=True,
               softmax_groups=[(40, 48)] if groups else None, seed=3,
               device=dev)


def _shell_calls(r):
    """name -> call of every jitted entry of the shell."""
    g = torch.Generator().manual_seed(4)
    v = torch.rand((6, 48), generator=g).to(r.device)
    h = torch.rand((6, 24), generator=g).to(r.device)
    km = torch.cat([torch.ones(6, 40), torch.zeros(6, 8)], 1).to(r.device)
    return {
        "forward": lambda: r.forward(v),
        "visible_probs": lambda: r.visible_probs(h),
        "backward logits": lambda: r.backward(h, return_logits=True),
        "sample_visible": lambda: r.sample_visible(v),
        "backward_sample": lambda: r.backward_sample(h),
        "gibbs_step": lambda: r.gibbs_step(v),
        "free_energy": lambda: r.free_energy(v),
        "conditional_gibbs mean-field": lambda: r.conditional_gibbs(v, km,
                                                                    5),
        "conditional_gibbs sampled": lambda: r.conditional_gibbs(
            v, km, 5, sample_h=True, sample_v=True),
        "conditional_gibbs_annealed": lambda: r.conditional_gibbs_annealed(
            v, km, 6, sample_h_until=3, sample_v_every=2),
        "noisy_meanfield_annealed": lambda: r.noisy_meanfield_annealed(
            v, 1.0 - km, 8),
    }


@pytest.mark.parametrize("groups", [True, False])
def test_rbm_shell_entries_replayed_equal_launch_by_launch(dev, monkeypatch,
                                                           groups):
    """Each jitted entry of the shell: launch by launch, its first call
    through the shell's graphs and a replay under the sync check, from
    the same key stream, bit-equal; one replay per call; after one more
    ``train_epoch`` (itself one replay) the same graphs serve the new
    weights: bit-equal to launch by launch, changed, no new capture."""
    from multimodal_idbn_tpu_torch.ops import graphs

    def three_ways(call):
        outs = []
        for way in ("eager", "first", "replay"):
            r.reseed(11)
            with (graphs.launch_by_launch() if way == "eager" else
                  _updates_without_sync(monkeypatch) if way == "replay"
                  else contextlib.nullcontext()):
                outs.append(call())
        return outs

    with _counted_replays(monkeypatch) as replays:
        r = _shell(dev, groups)
        calls = _shell_calls(r)
        before = {}
        for name, call in calls.items():
            eager, first, again = three_ways(call)
            assert _tree_equal(first, eager) and _tree_equal(again, eager), \
                name
            before[name] = eager
    assert all(replays[id(g)] == 2 for g in r._serving.graphs.values())
    data = torch.rand((6, 48), generator=torch.Generator().manual_seed(5))
    twin = _shell(dev, groups)
    twin.state = r.state
    r.reseed(12)
    twin.reseed(12)
    loss = r.train_epoch(data.to(dev), 0, 2, CD=2)
    with graphs.launch_by_launch():
        loss_eager = twin.train_epoch(data.to(dev), 0, 2, CD=2)
    assert torch.equal(loss, loss_eager)
    for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m"):
        assert torch.equal(getattr(r.state, f), getattr(twin.state, f)), f
    graphs.reset_stats()
    for name, call in calls.items():
        eager, first, again = three_ways(call)
        assert _tree_equal(first, eager) and _tree_equal(again, eager), name
        if name != "sample_visible":         # reads no weight
            assert not _tree_equal(eager, before[name]), name
    assert not graphs.STATS["captures"]


def test_probe_replays_one_graph_per_chunk(dev, monkeypatch):
    """The probe on the card: one replay per chunk of ``check_every``
    steps, bit-equal (W, b) to launch by launch and to chunks of another
    length, the chunk replays free of host synchronisation."""
    from multimodal_idbn_tpu_torch.ops import graphs
    from multimodal_idbn_tpu_torch.utils import probe_utils as tpu
    g = torch.Generator().manual_seed(1)
    X = torch.randn((120, 32), generator=g)
    y = (X @ torch.randn((32, 5), generator=g)).argmax(1)
    args = [t.to(dev) for t in (X[:90], y[:90], X[90:], y[90:])] + [
        0.1 * torch.randn((32, 5), generator=g), torch.zeros(5)]
    calls = []
    real = graphs.update

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(graphs, "update", counting)
    graphs.reset_stats()
    with _updates_without_sync(monkeypatch):
        W, b = tpu.fit_linear_probe(*args, max_steps=400, lr=5e-2,
                                    patience=20, check_every=25)
    assert graphs.STATS["replays"]["step:_probe_chunk"] == len(calls) >= 2
    with graphs.launch_by_launch():
        W1, b1 = tpu.fit_linear_probe(*args, max_steps=400, lr=5e-2,
                                      patience=20, check_every=1)
    assert torch.equal(W, W1) and torch.equal(b, b1)
    W7, b7 = tpu.fit_linear_probe(*args, max_steps=400, lr=5e-2,
                                  patience=20, check_every=7)
    assert torch.equal(W, W7) and torch.equal(b, b7)


@pytest.mark.parametrize("family", ["image", "joint", "bimodal"])
def test_per_batch_steps_replayed_equal_launch_by_launch(dev, monkeypatch,
                                                         family):
    """The per-batch loops (a loader iterated batch by batch): one replay
    per batch, the model bit-equal to the same loop launch by launch; the
    serving graphs captured before serve the weights the batches wrote
    in place (bit-equal to launch by launch, changed, no new capture)."""
    from multimodal_idbn_tpu_torch.ops import graphs
    make = _small_bimodal if family == "bimodal" else _small_imdbn
    models = []
    for eager in (False, True):
        m = make(dev)
        if family == "joint":
            m.image_idbn.train(1)
        with (graphs.launch_by_launch() if eager
              else contextlib.nullcontext()):
            serve = _serving_calls(m, family == "bimodal")
            before = {n: c(m) for n, c in serve.items()}
            graphs.reset_stats()
            if family == "image":
                m.image_idbn.train(2, fused=False)
            else:
                m.train_joint(9, fused=False)
            replays = dict(graphs.STATS["replays"])
            after = {n: c(m) for n, c in serve.items()}
        models.append((m, replays, before, after))
    (m, replays, before, after), (e, eager_replays, _, eager_after) = models
    assert not any(k.startswith("step:") for k in eager_replays)
    nb = len(m.dataloader)
    step = {"image": "step:_batch_step", "joint": "step:_joint_batch_step",
            "bimodal": "step:_bimodal_batch_step"}[family]
    assert replays[step] == nb * (2 if family == "image" else 9)
    if family == "image":
        assert m.image_idbn.loss_history == e.image_idbn.loss_history
    else:
        assert m.joint_metrics_history == e.joint_metrics_history
    parts = ([*m.image_idbn.layers, m.joint_rbm] if family != "bimodal"
             else list(m.joint_layers))
    twins = ([*e.image_idbn.layers, e.joint_rbm] if family != "bimodal"
             else list(e.joint_layers))
    for a, b in zip(parts, twins):
        for f in ("w", "hb", "vb", "w_m", "hb_m", "vb_m"):
            assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    for name in after:
        assert _tree_equal(after[name], eager_after[name]), name
        if family == "joint" and name.startswith(("reconstruct", "decode")):
            continue                   # the image iDBN alone: not trained
        assert not _tree_equal(after[name], before[name]), name


def _deep_equal(a, b) -> bool:
    """Equality of nested dicts, lists and tuples of tensors, arrays and
    numbers, bit for bit."""
    import numpy as np
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_deep_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_deep_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def test_diagnostic_chains_replayed_equal_launch_by_launch(dev):
    """The energy trace (class free energies and the IMG→TXT chain), both
    panel chains, the trajectory chain, the bimodal trajectory, the bias
    statistics and the chain throughput probe: each replayed from the
    same key stream bit-equal to launch by launch, each one replay."""
    import numpy as np
    from multimodal_idbn_tpu_torch.models import imdbn_bimodal
    from multimodal_idbn_tpu_torch.ops import graphs
    from multimodal_idbn_tpu_torch.utils import conditional_steps as tcs
    from multimodal_idbn_tpu_torch.utils import energy_utils as teu
    from multimodal_idbn_tpu_torch.utils import imdbn_logging as til
    from multimodal_idbn_tpu_torch.utils import profiling
    m = _small_imdbn(dev)
    m.train_joint(2)
    b = _small_bimodal(dev)
    b.train_joint(1)
    img, lbl = teu.pick_fixed_val_case(m)
    imgs, lbls = tcs.build_or_get_fixed_val_panel(m, per_class=2)
    y = np.eye(4, dtype=np.float32)[[1]]
    z2 = b.mod2_dbn.represent(next(iter(b.val_loader))[1][:1])
    X, Y, Z = m._materialized_train()
    calls = {
        "energy trace": (lambda: teu.trace_single_img2txt(m, img, lbl,
                                                          steps=12),
                         ("serve:_class_free_energies",
                          "serve:_img2txt_chain")),
        "img2txt panel": (lambda: tcs.trace_img2txt_cross_batch(
            m, imgs, lbls, max_steps=12), ("serve:_img2txt_panel_chain",)),
        "txt2img panel": (lambda: tcs.trace_txt2img_cross_batch(
            m, imgs, lbls, max_steps=9)[1], ("serve:_txt2img_panel_chain",)),
        "trajectory": (lambda: til._run_traj(m, y, 6),
                       ("serve:_traj_chain",)),
        "bimodal trajectory": (lambda: imdbn_bimodal._mod2_to_mod1_chain(
            b, z2, 6), ("serve:_mod2_to_mod1_body",)),
        "bias stats": (lambda: m.init_joint_bias_from_data(
            _cached=(X, Y, Z)) or (m.z_class_mean, m.joint_rbm.vis_bias),
            ("serve:joint_bias_stats",)),
    }
    for name, (call, graphs_used) in calls.items():
        outs = []
        for eager in (True, False, False):
            for model in (m, b):
                model.joint_rbm.reseed(7)
            graphs.reset_stats()
            with (graphs.launch_by_launch() if eager
                  else contextlib.nullcontext()):
                outs.append(call())
            if not eager:
                for gname in graphs_used:
                    assert graphs.STATS["replays"][gname] == 1, (name, gname)
        for out in outs[1:]:
            assert _deep_equal(out, outs[0]), name
    fast = profiling.measure_gibbs_steps_per_sec(
        num_visible=48, num_hidden=24, batch_size=16, n_steps=20,
        groups=((40, 48),), device=dev)
    with graphs.launch_by_launch():
        slow = profiling.measure_gibbs_steps_per_sec(
            num_visible=48, num_hidden=24, batch_size=16, n_steps=20,
            groups=((40, 48),), device=dev)
    assert fast["chain_steps_per_sec"] > 0 and slow["chain_steps_per_sec"] > 0


@pytest.mark.parametrize("step", ["idbn", "joint", "bimodal"])
def test_public_batch_steps_replayed_equal_launch_by_launch(dev, step):
    """The per-batch steps JAX jits, called directly on the card: each call
    one replay of a graph of ``graphs.SHARED`` (a new lr another input,
    not another graph), bit-equal to launch by launch."""
    from multimodal_idbn_tpu_torch.ops import (bimodal_ops, dbn_train,
                                               graphs, imdbn_ops, rbm_ops)
    g = torch.Generator().manual_seed(9)

    def states(widths, seed):
        return [rbm_ops.init_rbm_state(seed + i, v, h, device=dev)
                for i, (v, h) in enumerate(zip(widths, widths[1:]))]

    def rand(*shape):
        return torch.rand(shape, generator=g).to(dev)

    img = states([60, 24, 12], 1)
    x = (rand(9, 60) < 0.4).float()
    y = torch.eye(4, device=dev)[torch.arange(9, device=dev) % 4]
    if step == "idbn":
        def call(lr):
            return dbn_train.idbn_batch_step(
                img, 5, x, lr, 0.5, 1e-4, 0.05, cd=2,
                sparsity_flags=(False, True), fast_sampler=True)
    elif step == "joint":
        joint = states([16, 10], 3)[0]
        z = rand(9, 12)

        def call(lr):
            return imdbn_ops.joint_train_batch_step(
                joint, img, 6, z, y, x, 3, lr, 0.5, 1e-4, None,
                warmup=False, joint_cd=1, aux_cond_steps=2, Dz=12, steps=4,
                groups=((12, 16),))
    else:
        bj, m2 = states([20, 10, 6], 4), states([30, 8], 6)
        z1, z2, v2 = rand(9, 12), rand(9, 8), (rand(9, 30) < 0.4).float()

        def call(lr):
            return bimodal_ops.bimodal_batch_step(
                bj, img, m2, 7, z1, z2, x, v2, lr, 0.5, 1e-4, warmup=False,
                joint_cd=1, aux_cond_steps=2, Dz1=12, steps=3)
    graphs.reset_stats()
    outs = [call(0.1), call(0.1), call(0.05)]
    assert sum(graphs.STATS["replays"].values()) == 3
    assert len(graphs.STATS["captures"]) == 1
    with graphs.launch_by_launch():
        eager = [call(0.1), call(0.05)]
    assert _tree_equal(outs[0], eager[0]) and _tree_equal(outs[1], eager[0])
    assert _tree_equal(outs[2], eager[1])
