"""CPU tests of what surrounds the two CUDA kernels in Python: the split-K
plan of the half-step (``half_step.plan``), the C arguments of its
sampled launch as the wrapper and ``bench_kernels`` pass them, the
chain's body rule and cluster layout (``chain.body``,
``chain.cluster_layout``) and the device caches of the chain's schedules
and softmax groups (``rbm_ops``, ``chain``).

The kernels themselves run only on the card (tests/test_torch_cuda.py);
here the wrappers run their plain versions, whose values must not depend
on the caches.
"""

import ctypes
import inspect

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


class _OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for a CUDA one."""
    is_cuda = True


# positions in the C arguments of ``half_step_sample``: the two outputs,
# the scratch and tickets, the body flag and tiling, and the tail (1/T,
# key table, index, seed value, row0, col0)
_OUTS, _WORK, _TILING, _TAIL = (slice(3, 5), slice(5, 7), slice(11, 15),
                                slice(15, 21))


@pytest.mark.parametrize("transpose", [False, True])
def test_bench_half_step_launch_is_the_wrappers(monkeypatch, transpose):
    """``bench_kernels`` times the launch that ``half_step_sample`` makes:
    at the same shape and seed it passes the same C arguments (the
    outputs' addresses aside), under the plan's tiling and under another
    (the tiling and its scratch aside). The operand check, the stream and
    the kernel call are stand-ins."""
    from multimodal_idbn_tpu_torch import bench_kernels
    from multimodal_idbn_tpu_torch.ops import _cuda
    calls = []

    def launch(entry, *args, body=None):
        calls.append((entry, body, [a.value if isinstance(a, ctypes.c_void_p)
                                    else a for a in args]))

    monkeypatch.setattr(half_step.KERNEL, "launch", launch)
    monkeypatch.setattr(half_step, "_WORKSPACES", {})
    monkeypatch.setattr(_cuda, "check_cuda_operands", lambda *t: None)
    monkeypatch.setattr(_cuda, "stream_handle",
                        lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    B, K, N = 12, 40, 24
    g = torch.Generator().manual_seed(0)
    w = torch.randn((N, K) if transpose else (K, N), generator=g)
    b = torch.randn((N,), generator=g)
    x = torch.rand((B, K), generator=g).as_subclass(_OnCard)
    chosen = half_step.plan(B, K, N)
    other = ("mma_sync", 32, 1, 48)
    half_step.half_step_sample(x, w, b, 7, transpose_w=transpose)
    bench_kernels.half_step_launch(x, w, b, transpose, chosen)
    bench_kernels.half_step_launch(x, w, b, transpose, other)
    (entry, body, want), same, (_, other_body, diff) = calls
    assert entry == "half_step_sample" and body == chosen[0] == "wgmma"
    assert len(want) == 22
    assert want[7:11] == [B, K, N, int(transpose)]
    assert want[_TILING] == [1, *chosen[1:]]
    assert want[_TAIL] == [1.0, None, 0, 7, 0, 0]
    for args in (want, same[2], diff):
        args[_OUTS] = [None, None]
    assert same == (entry, body, want)
    assert other_body == "mma_sync" and diff[_TILING] == [0, *other[1:]]
    for args in (want, diff):
        args[_WORK], args[_TILING] = [None] * 2, [None] * 4
    assert diff == want


def _no_group_cut(bounds, groups):
    return not any(gs < b < ge for b in bounds for gs, ge in groups)


def _rule_flagship():
    groups = ((500, 532),)
    assert chain.body(532, 500, groups) == "cluster"
    hw, bounds = chain.cluster_layout(532, 500, groups)
    assert hw == 32 and hw * chain.CLUSTER_BLOCKS >= 500
    assert bounds[0] == 0 and bounds[-1] == 532
    assert len(bounds) == chain.CLUSTER_BLOCKS + 1
    assert list(bounds) == sorted(bounds) and _no_group_cut(bounds, groups)
    assert chain.cluster_smem_bytes(532, hw, bounds, 2) <= chain.SMEM_BYTES


def _rule_bimodal():
    assert chain.body(2500, 1500) == "grid"
    hw, bounds = chain.cluster_layout(2500, 1500)
    # W's slice alone (2 500 rows x 96 columns) is over a block's budget
    assert 4 * 2500 * hw > chain.SMEM_BYTES


def _rule_budget_edge():
    # at H = 500 the state grows with V: 700 columns fit, 800 do not
    inside, outside = (chain.cluster_smem_bytes(V, *chain.cluster_layout(
        V, 500), 2) for V in (700, 800))
    assert inside <= chain.SMEM_BYTES < outside
    assert (chain.body(700, 500), chain.body(800, 500)) == ("cluster", "grid")
    # the hidden width moves the budget too
    assert chain.body(532, 1500, ((500, 532),)) == "grid"


def _rule_group_straddles():
    # nominal slices of 36 columns would cut (30, 50) at 36: the boundary
    # moves to the group's start
    groups = ((30, 50), (500, 532))
    hw, bounds = chain.cluster_layout(532, 500, groups)
    assert 30 in bounds and 36 not in bounds
    assert _no_group_cut(bounds, groups) and bounds[-1] == 532
    assert chain.body(532, 500, groups) == "cluster"


def _rule_eight_groups():
    groups = tuple((30 * i, 30 * i + 17) for i in range(8))
    hw, bounds = chain.cluster_layout(300, 70, groups)
    assert _no_group_cut(bounds, groups) and bounds[-1] == 300
    assert chain.body(300, 70, groups) == "cluster"


def _rule_overlapping_groups():
    assert chain.cluster_layout(100, 50, ((10, 30), (20, 40))) is None
    assert chain.body(100, 50, ((10, 30), (20, 40))) == "grid"


def _rule_takes_no_batch():
    # a data-parallel rank and the whole batch ask the same question
    assert list(inspect.signature(chain.body).parameters) == ["V", "H",
                                                              "groups"]
    assert list(inspect.signature(chain.cluster_layout).parameters) == [
        "V", "H", "groups"]
    assert chain.body(532, 500, [[500, 532]]) == chain.body(
        532, 500, ((500, 532),))


_RULE_CASES = {
    "flagship joint": _rule_flagship,
    "bimodal joint": _rule_bimodal,
    "either side of the budget": _rule_budget_edge,
    "a group across a slice boundary": _rule_group_straddles,
    "eight groups": _rule_eight_groups,
    "overlapping groups": _rule_overlapping_groups,
    "no batch": _rule_takes_no_batch,
}


@pytest.mark.parametrize("case", list(_RULE_CASES))
def test_chain_body_rule(case):
    """``chain.body``: the cluster body where W's slices and the state of
    16 rows a cluster fit a block's shared memory with every softmax group
    inside one block's columns, the grid body elsewhere; a pure function
    of (V, H, groups)."""
    _RULE_CASES[case]()


def test_chain_body_counter_in_the_launch_accounting():
    """The chain's launches by body are part of the graphs' launch
    accounting, as the half-step's are."""
    from multimodal_idbn_tpu_torch.ops import graphs
    assert chain.KERNEL.launches_by_body.keys() == {"cluster", "grid"}
    held = dict(chain.KERNEL.launches_by_body)
    before = graphs.launch_counts()
    assert {("chain.cu", "body:cluster"),
            ("chain.cu", "body:grid")} <= set(before)
    chain.KERNEL.launches_by_body["cluster"] += 2
    delta = graphs.launches_since(before)
    assert delta == {("chain.cu", "body:cluster"): 2}
    graphs.add_launches(delta, -1)
    assert chain.KERNEL.launches_by_body == held


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
