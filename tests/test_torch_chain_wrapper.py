"""CPU tests of what surrounds the two CUDA kernels in Python: the split-K
plan of the half-step (``half_step.plan``) and the device caches of the
chain's schedules and softmax groups (``rbm_ops``, ``chain``).

The kernels themselves run only on the card (tests/test_torch_cuda.py);
here the wrappers run their plain versions, whose values must not depend
on the caches.
"""

import pytest
import torch

from multimodal_idbn_tpu_torch.ops import chain, half_step, rbm_ops

CPU = torch.device("cpu")

# (B, K, N) of every half-step on the flagship and the bimodal paths, at
# the full batch and at the cuts' 12-row remainder, and some ragged ones.
_LAYERS = [(10000, 1500), (1500, 500), (1500, 1500), (1568, 500),
           (500, 500), (500, 1000), (2500, 1500), (1500, 500)]
_SHAPES = sorted({(B, *kn) for B in (128, 12) for v, h in _LAYERS
                  for kn in ((v, h), (h, v))}
                 | {(1, 1, 1), (37, 77, 130), (129, 513, 65),
                    (128, 40, 1500), (12, 1501, 499), (128, 100000, 64)})


@pytest.mark.parametrize("B,K,N", _SHAPES)
def test_half_step_plan_covers_the_contraction(B, K, N):
    body, tile_rows, slices, k_per_slice = half_step.plan(B, K, N)
    # the body by alignment: wgmma where x's and W's rows are 16-byte
    # aligned and the batch fits one block, mma_sync elsewhere
    aligned = B <= 128 and K % 4 == 0 and N % 4 == 0
    assert body == ("wgmma" if aligned else "mma_sync")
    if body == "wgmma":        # the whole batch, rounded up, in one tile
        assert tile_rows == (32 if B <= 32 else (64 if B <= 64 else 128))
        k_tile = 32
    else:
        assert tile_rows in (32, 64)
        if B <= 32:
            assert tile_rows == 32
        k_tile = 16
    assert slices >= 1
    assert k_per_slice % k_tile == 0 and k_tile <= k_per_slice <= 1024
    assert slices * k_per_slice >= K          # the slices cover K ...
    assert (slices - 1) * k_per_slice < K     # ... and none is empty
    # a pure function of the shape: the same answer again, whatever the
    # default device
    assert half_step.plan(B, K, N) == (body, tile_rows, slices, k_per_slice)


def test_half_step_plan_splits_the_first_layer_over_the_card():
    body, tile_rows, slices, _ = half_step.plan(128, 10000, 1500)
    assert (body, tile_rows) == ("wgmma", 128)
    blocks = -(-1500 // 128) * slices     # slabs of 128 columns x slices
    assert blocks >= 132


def test_body_counter_in_the_launch_accounting():
    """The half-step's launches by body are part of the graphs' launch
    accounting (``body:<name>``), as its launches by entry are, so that
    a graph replay advances both."""
    from multimodal_idbn_tpu_torch.ops import graphs
    held = dict(half_step.KERNEL.launches_by_body)
    before = graphs.launch_counts()
    assert {("half_step.cu", "body:wgmma"),
            ("half_step.cu", "body:mma_sync")} <= set(before)
    half_step.KERNEL.launches_by_body["wgmma"] += 3
    delta = graphs.launches_since(before)
    assert delta == {("half_step.cu", "body:wgmma"): 3}
    graphs.add_launches(delta, 2)
    assert half_step.KERNEL.launches_by_body["wgmma"] == held["wgmma"] + 9
    graphs.add_launches(delta, -3)
    assert half_step.KERNEL.launches_by_body == held


def test_annealed_schedule_is_cached_per_device():
    args = (30, 3.0, 1.0, 0.9, 2, 0.9, 0.15)
    first = rbm_ops._annealed_schedule_on(CPU, *args)
    second = rbm_ops._annealed_schedule_on(CPU, *args)
    assert first is second
    assert torch.equal(first, rbm_ops.annealed_schedule(*args))
    other = rbm_ops._annealed_schedule_on(CPU, 31, *args[1:])
    assert other is not first and other.shape == (31, 3)


def test_meanfield_schedule_is_cached_per_device():
    first = rbm_ops._meanfield_schedule_on(CPU, 5)
    assert first is rbm_ops._meanfield_schedule_on(CPU, 5)
    assert torch.equal(first, torch.tensor([[1.0, 0.0, 0.0]]).repeat(5, 1))
    assert rbm_ops._meanfield_schedule_on(CPU, 0).shape == (0, 3)


def test_groups_are_cached_per_device():
    groups = ((10, 15), (20, 29))
    first = chain._groups_on(CPU, groups)
    assert first is chain._groups_on(CPU, groups)
    assert first.dtype == torch.int32
    assert first.tolist() == [10, 15, 20, 29]


@pytest.mark.parametrize("noisy", [False, True])
def test_cached_schedules_leave_the_plain_chain_unchanged(noisy):
    st = rbm_ops.init_rbm_state(1, 20, 8, device="cpu")
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((6, 20), generator=g) < 0.5).float()
    km = torch.zeros(6, 20)
    km[:, :15] = 1.0
    groups = ((15, 20),)
    if noisy:
        def run():
            return rbm_ops.noisy_meanfield_annealed(
                st, 2, x, km, n_steps=4, groups=groups)
        sched = rbm_ops.annealed_schedule(4, 3.0, 1.0, 0.9, 3, 0.9, 0.15)
        kw = dict(seed=rbm_ops.rng.fold_in(2, 1), final_unclamped=False)
        key0 = rbm_ops.rng.fold_in(2, 0)
    else:
        def run():
            return rbm_ops.conditional_gibbs(st, 1, x, km, n_steps=3,
                                             groups=groups)
        sched = torch.tensor([[1.0, 0.0, 0.0]]).repeat(3, 1)
        kw = dict(seed=None, final_unclamped=True)
        key0 = rbm_ops.rng.fold_in(1, 0)
    first, second = run(), run()
    assert torch.equal(first, second)
    v0 = rbm_ops._chain_init(key0, x, km)
    direct = chain.chain_plain(st.w, st.hb, st.vb, v0, x, km, sched,
                               groups=groups, **kw)
    assert torch.equal(first, direct)
