"""The port's parallel/ package on the CPU: gloo process groups of two
ranks, spawned with a FileStore under tmp_path (no TCP port), against the
single-device run of the same code.

Tolerances, stated before the runs, as JAX's own tests state them
(tests/test_parallel_shell.py:59-80, tests/test_mesh2d.py:76-89): states
atol 1e-5, losses rtol 1e-4. The replicas of a data-parallel run are
bit-equal across ranks, and so are a rank's draws and the single-device
draws of its rows; a rank's plain half-step and chain rows agree with the
single-device rows to 1e-6 (the CPU's matrix product may block a product
of fewer rows differently; on the card the kernels take the whole batch's
plan and are bit-equal, which chip_smoke.py checks). Two spawned jobs run
every multi-rank check; their results are written by each rank and
compared here.
"""

import pathlib
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multimodal_idbn_tpu_torch import parallel
from multimodal_idbn_tpu_torch.ops import (chain, dbn_train, fast_cd,
                                           half_step, rbm_ops, rng, shard)
from multimodal_idbn_tpu_torch.parallel import data_parallel as tdp
from multimodal_idbn_tpu_torch.parallel import mesh2d as tmesh

from torch_parity import (SMALL_PARAMS, rbm_arrays, small_bimodal,
                          small_imdbn)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-5, 1e-4
CD_KW = dict(lr=0.1, mom=0.5, weight_decay=1e-4, cd=2)
V, H, Dz, K = 30, 16, 16, 4


def _data(rows, cols, seed=0):
    return (np.random.RandomState(seed).rand(rows, cols) > 0.6).astype(
        np.float32)


def _joint_data(rows, seed=1):
    rs = np.random.RandomState(seed)
    return np.concatenate([(rs.rand(rows, Dz) > 0.5).astype(np.float32),
                           np.eye(K, dtype=np.float32)[rs.randint(0, K,
                                                                  rows)]], 1)


def _arrays(state):
    return {f: getattr(state, f).detach().clone() for f in
            ("w", "hb", "vb", "w_m", "hb_m", "vb_m")}


def _train_models(params):
    """(iMDBN, bimodal) trained at small widths under ``params``: 2 image
    epochs, the joint biases from the data, then joint epochs 7-9 (the
    last warm-up epoch and two main ones) and bimodal joint epochs 7-8."""
    im = small_imdbn(**params)
    im.image_idbn.train(2)
    im.init_joint_bias_from_data()
    im.train_joint(10, start_epoch=7)
    bi = small_bimodal(**params)
    bi.init_joint_bias_from_data()
    bi.train_joint(9, start_epoch=7)
    return im, bi


def _model_results(im, bi):
    return {"imdbn": rbm_arrays(im),
            "image_loss": list(im.image_idbn.loss_history),
            "joint_metrics": dict(im.last_metrics),
            "bimodal": rbm_arrays(bi), "bimodal_metrics":
                dict(bi.last_metrics)}


# ---------------------------------------------------------------------------
# The spawned jobs (module-level, so that the spawned ranks import them)
# ---------------------------------------------------------------------------

def _init(rank, world, store):
    torch.set_num_threads(1)     # as the test workers run
    parallel.initialize_distributed(f"file://{store}", world, rank,
                                    backend="gloo")


def _dp_job(rank, world, store, out):
    _init(rank, world, store)
    try:
        mesh = parallel.make_mesh(2, device="cpu")
        res = {"backend": mesh.backend, "size": mesh.size}
        st = rbm_ops.init_rbm_state(3, V, H)
        # 13 rows: an uneven split, 6 and 7
        res["cd"] = parallel.dp_cd_update(mesh, st, 5, _data(13, V), **CD_KW)
        jst = rbm_ops.init_rbm_state(4, Dz + K, 12)
        res["cd_groups"] = parallel.dp_cd_update(
            mesh, jst, 6, _joint_data(12), groups=((Dz, Dz + K),), **CD_KW)
        res["cd_bf16"] = parallel.dp_cd_update(
            mesh, rbm_ops.init_rbm_state(3, V, H, dtype=torch.bfloat16), 5,
            _data(12, V), **CD_KW)
        im, bi = _train_models({"DP_DEVICES": 2})
        res.update(_model_results(im, bi))
        # a pickle carries no process group: it loads as a model without
        # a mesh (save_model pickles the model)
        res["unpickled_mesh"] = [pickle.loads(pickle.dumps(m)).mesh
                                 for m in (im, im.image_idbn, bi)]
        # set_mesh accepts counts, "all", a mesh and None
        m = small_imdbn()
        sizes = []
        for spec in (2, "all", parallel.make_mesh(2, device="cpu")):
            m.set_mesh(spec)
            sizes.append(m.mesh.size)
        m.set_mesh(None)
        res["set_mesh"] = (sizes, m.mesh, m.image_idbn.mesh)
        try:
            parallel.make_mesh(3, device="cpu")
        except ValueError as e:
            res["make_mesh_3"] = str(e)
        # a group of one rank gives the single-device bits
        one = dist.new_group([0])
        if rank == 0:
            sub = tdp.Mesh(one, 1, 0, torch.device("cpu"), "gloo")
            a = small_imdbn()
            a.set_mesh(sub)
            a.image_idbn.train(2)
            res["one_rank"] = rbm_arrays(a.image_idbn)
        torch.save(res, pathlib.Path(out) / f"dp{rank}.pt")
    finally:
        dist.destroy_process_group()


def _tp_job(rank, world, store, out):
    _init(rank, world, store)
    try:
        res = {}
        st = rbm_ops.init_rbm_state(3, V, H)
        data = _data(12, V)
        for dp, mp in ((1, 2), (2, 1)):
            mesh = parallel.make_mesh_2d(dp=dp, mp=mp, device="cpu")
            res[f"shape{dp}{mp}"] = mesh.shape
            s, loss = parallel.tp_cd_update(mesh, st, 5, data, **CD_KW)
            res[f"cd{dp}{mp}"] = (_arrays(parallel.gather_state(s)), loss)
            jst = rbm_ops.init_rbm_state(4, Dz + K, 12)
            s, loss = parallel.tp_cd_update(mesh, jst, 6, _joint_data(12),
                                            groups=((Dz, Dz + K),), **CD_KW)
            res[f"groups{dp}{mp}"] = (_arrays(parallel.gather_state(s)),
                                      loss)
        mesh = parallel.make_mesh_2d(mp=2, device="cpu")
        sh = parallel.shard_state(mesh, st)
        res["local_w"] = tuple(sh.w.shape)
        res["local_vb"] = tuple(sh.vb.shape)
        states = [rbm_ops.init_rbm_state(1, V, H),
                  rbm_ops.init_rbm_state(2, H, 8)]
        out_states, losses = parallel.tp_idbn_epoch(
            mesh, states, 9, _data(32, V, 2), 0.1, 0.5, 1e-4, 0.05, cd=2,
            sparsity_flags=(False, True), batch_size=16)
        res["epoch"] = ([_arrays(parallel.gather_state(s))
                         for s in out_states], losses)
        for kw in (dict(mp=3), dict(dp=2, mp=2)):
            try:
                parallel.make_mesh_2d(**kw, device="cpu")
            except ValueError as e:
                res[f"err{sorted(kw.items())}"] = str(e)
        torch.save(res, pathlib.Path(out) / f"tp{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(job, tmp_path):
    import torch.multiprocessing as tmp
    store = tmp_path / f"{job.__name__}.store"
    tmp.spawn(job, args=(2, str(store), str(tmp_path)), nprocs=2,
              join=True, start_method="spawn")
    name = "dp" if job is _dp_job else "tp"
    return [torch.load(tmp_path / f"{name}{r}.pt", weights_only=False)
            for r in (0, 1)]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    return _spawn(_dp_job, tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    return _spawn(_tp_job, tmp_path_factory.mktemp("tp"))


def _equal(a, b):
    """Bit-equal nested results of two ranks."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        _equal(_arrays(a), _arrays(b))
    else:
        assert a == b


def _close_states(got, want, atol=ATOL):
    got = got if isinstance(got, dict) else _arrays(got)
    want = want if isinstance(want, dict) else _arrays(want)
    for f in want:
        np.testing.assert_allclose(got[f].float().numpy(),
                                   want[f].float().numpy(), rtol=0,
                                   atol=atol, err_msg=f)


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------

def test_dp_replicas_are_bit_equal(dp_runs):
    a, b = dp_runs
    _equal({k: v for k, v in a.items() if k != "one_rank"}, b)
    assert a["backend"] == "gloo" and a["size"] == 2


@pytest.mark.parametrize("case", ["cd", "cd_groups", "cd_bf16"])
def test_dp_cd_update_matches_one_device(dp_runs, case):
    data, groups, st = {
        "cd": (_data(13, V), (), rbm_ops.init_rbm_state(3, V, H)),
        "cd_groups": (_joint_data(12), ((Dz, Dz + K),),
                      rbm_ops.init_rbm_state(4, Dz + K, 12)),
        "cd_bf16": (_data(12, V), (),
                    rbm_ops.init_rbm_state(3, V, H, dtype=torch.bfloat16)),
    }[case]
    key = 6 if groups else 5
    want, want_loss = fast_cd.cd_update(st, key, torch.as_tensor(data),
                                        groups=groups, **CD_KW)
    got, loss = dp_runs[0][case]
    # bf16 storage rounds stochastically: a sum in another order may land
    # on the neighbouring bf16 value, one bf16 ulp of the weights
    _close_states(got, want, 2 ** -8 if case == "cd_bf16" else ATOL)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)


def test_dp_models_match_one_device(dp_runs):
    want = _model_results(*_train_models({}))
    got = dp_runs[0]
    for part in ("imdbn", "bimodal"):
        for k, a in want[part].items():
            np.testing.assert_allclose(got[part][k], a, rtol=0, atol=ATOL,
                                       err_msg=f"{part} {k}")
    np.testing.assert_allclose(got["image_loss"], want["image_loss"],
                               rtol=RTOL)
    for part in ("joint_metrics", "bimodal_metrics"):
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k], v, rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def test_one_rank_group_is_bit_equal_to_one_device(dp_runs):
    want = small_imdbn()
    want.image_idbn.train(2)
    _equal(dp_runs[0]["one_rank"], rbm_arrays(want.image_idbn))


def test_models_with_a_mesh_pickle_without_it(dp_runs):
    assert dp_runs[0]["unpickled_mesh"] == [None, None, None]


def test_set_mesh_specs(dp_runs):
    sizes, mesh, image_mesh = dp_runs[0]["set_mesh"]
    assert sizes == [2, 2, 2] and mesh is None and image_mesh is None
    assert "requested 3 devices, have 2" in dp_runs[0]["make_mesh_3"]


def test_kernel_rows_are_the_single_device_rows():
    """A rank's half-step and chain outputs, through the plain versions
    with ``row0`` (and ``col0``), are the single-device rows and columns:
    the draws bit for bit, the samples equal, the probabilities to 1e-6.
    The draws of plain torch inside a batch shard are bit-equal too."""
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(24, 40, generator=g) > 0.5).float()
    w = torch.randn(40, 20, generator=g) * 0.1
    b = torch.randn(20, generator=g) * 0.1
    p, s = half_step.half_step_plain(x, w, b, 77)
    u = rng.philox_uniform(77, 24, 20)
    for r0, r1 in ((0, 12), (12, 24), (5, 19)):
        assert torch.equal(rng.philox_uniform(77, r1 - r0, 20, row0=r0),
                           u[r0:r1])
        pp, ss = half_step.half_step_plain(x[r0:r1], w, b, 77, row0=r0)
        torch.testing.assert_close(pp, p[r0:r1], rtol=0, atol=1e-6)
        assert torch.equal(ss, s[r0:r1])
    assert torch.equal(rng.philox_uniform(77, 24, 13, col0=7), u[:, 7:])
    pp, ss = half_step.half_step_plain(x, w[:, 7:], b[7:], 77, col0=7)
    torch.testing.assert_close(pp, p[:, 7:], rtol=0, atol=1e-6)
    assert torch.equal(ss, s[:, 7:])
    assert torch.equal(rng.philox_normal(9, 12, 40, step=2, stream=1,
                                         row0=12),
                       rng.philox_normal(9, 24, 40, step=2, stream=1)[12:])
    vk = torch.rand(24, 40, generator=g)
    km = (torch.rand(24, 40, generator=g) > 0.5).float()
    sched = torch.tensor([[1.0, 0.4, 0.1]]).repeat(3, 1)
    mu = torch.rand(24, 10, generator=g)
    args = (w, torch.zeros(20), torch.zeros(40), vk, vk, km, sched)
    full = chain.chain_plain(*args, mu=mu, seed=9, groups=((30, 40),))
    part = chain.chain_plain(*(a[12:] if a.ndim == 2 and a.shape[0] == 24
                               else a for a in args), mu=mu[12:], seed=9,
                             groups=((30, 40),), row0=12)
    torch.testing.assert_close(part, full[12:], rtol=0, atol=1e-6)
    u_full, g_full = rng.uniform(3, (24, 5), "cpu"), rng.gumbel(3, (24, 5),
                                                                 "cpu")
    with shard.batch_rows(24, 1, 2):
        assert torch.equal(rng.uniform(3, (12, 5), "cpu"), u_full[12:])
        assert torch.equal(rng.gumbel(3, (12, 5), "cpu"), g_full[12:])
        with pytest.raises(ValueError, match="batch shard"):
            rng.uniform(3, (5, 5), "cpu")


def test_rejections_raise_as_jax():
    """Without a process group: more devices than processes, and a mesh
    with the per-batch loop, PCD or COMPUTE_DTYPE raise ValueError, as the
    JAX package's (models/idbn.py:196-206, :332-335)."""
    m = small_imdbn(DP_DEVICES=2)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        m.image_idbn.train(1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        m.train_joint(1)
    one = small_imdbn(DP_DEVICES=1).image_idbn
    with pytest.raises(ValueError, match="fused epoch path"):
        one.train(1, fused=False)
    for extra in ({"PCD": True}, {"COMPUTE_DTYPE": "bfloat16"}):
        with pytest.raises(ValueError, match="default f32 CD path"):
            small_imdbn(DP_DEVICES=1, **extra).image_idbn.train(1)
    bi = small_bimodal(DP_DEVICES=1)
    with pytest.raises(ValueError, match="fused epoch path"):
        bi.train_joint(1, fused=False)


def test_set_mesh_none_overrides_dp_devices():
    m = small_imdbn(DP_DEVICES=2)
    m.set_mesh(None)
    assert m._resolve_mesh() is None and m.image_idbn._resolve_mesh() is None
    m.image_idbn.train(1)
    assert m.image_idbn.mesh is None


def test_one_process_mesh_is_bit_equal_to_one_device():
    """DP_DEVICES=1 without a process group: the mesh of this process
    alone trains the single-device bits."""
    want = small_imdbn()
    want.image_idbn.train(2)
    got = small_imdbn(DP_DEVICES=1)
    got.image_idbn.train(2)
    assert got.image_idbn.mesh.size == 1
    _equal(rbm_arrays(got.image_idbn), rbm_arrays(want.image_idbn))


def test_helpers_match_jax():
    from multimodal_idbn_tpu.parallel import data_parallel as jdp
    from multimodal_idbn_tpu.parallel import distributed as jdist
    x = np.arange(21, dtype=np.float32).reshape(7, 3)
    for mult in (1, 2, 4, 7, 8):
        got, n = parallel.pad_to_multiple(x, mult)
        want, wn = jdp.pad_to_multiple(x, mult)
        np.testing.assert_array_equal(got, want)
        assert n == wn
        t, tn = parallel.pad_to_multiple(torch.as_tensor(x), mult)
        np.testing.assert_array_equal(t.numpy(), want)
    for n in (8, 12, 128):
        assert parallel.local_batch_slice(n) == jdist.local_batch_slice(n)
    assert not parallel.is_multi_process() and parallel.is_main_process()
    assert parallel.initialize_distributed() is False
    mesh = parallel.make_mesh(device="cpu")
    assert parallel.batch_sharding(mesh, 3) == ("data", None, None)
    assert parallel.resolve_mesh(None) is None
    assert parallel.resolve_mesh(mesh) is mesh
    assert parallel.shard_batch(mesh, x).shape == (7, 3)
    _equal(parallel.replicate(mesh, [rbm_ops.init_rbm_state(0, 4, 3)]),
           [rbm_ops.init_rbm_state(0, 4, 3)])
    with pytest.raises(ValueError, match="explicit coordinator_address"):
        parallel.initialize_distributed("localhost:1")


def test_dp_epochs_without_group_are_the_epoch_functions():
    """Every dp_* function on a mesh of this process alone returns what
    its epoch function returns without one."""
    mesh = parallel.make_mesh(1, device="cpu")
    states = [rbm_ops.init_rbm_state(1, V, H), rbm_ops.init_rbm_state(2, H, 8)]
    data = torch.as_tensor(_data(40, V, 3))
    kw = dict(cd=1, sparsity_flags=(False, True), batch_size=16)
    a = parallel.dp_idbn_epoch(mesh, states, 4, data, 0.1, 0.5, 1e-4, 0.05,
                               shuffle=True, **kw)
    b = dbn_train.idbn_epoch(states, 4, data, lr=0.1, mom=0.5,
                             weight_decay=1e-4, sparsity_factor=0.05,
                             shuffle=True, fast_sampler=True, **kw)
    _equal(a, b)
    a = parallel.dp_idbn_epoch_block(mesh, states, 4, data, [0, 1],
                                     [0.1, 0.1], [0.5, 0.5], 1e-4, 0.05,
                                     n_epochs=2, **kw)
    b = dbn_train.idbn_epoch_block(states, 4, data, [0, 1], [0.1, 0.1],
                                   [0.5, 0.5], 1e-4, 0.05, n_epochs=2,
                                   fast_sampler=True, **kw)
    _equal(a, b)


def test_shuffle_permutes_by_the_epoch_key():
    """``shuffle=True`` of the epoch functions (JAX's static) is the
    epoch on the rows permuted by ``rng.permutation(key, n)``."""
    from multimodal_idbn_tpu_torch.ops import imdbn_ops
    n, key = 40, 11
    perm = rng.permutation(key, n)
    states = [rbm_ops.init_rbm_state(1, V, H)]
    data = torch.as_tensor(_data(n, V, 4))
    chains = [rbm_ops.init_pcd_chains(2, 16, V)]
    kw = dict(lr=0.1, mom=0.5, weight_decay=1e-4, sparsity_factor=0.05,
              cd=1, sparsity_flags=(False,), batch_size=16)
    _equal(dbn_train.idbn_epoch_pcd(states, chains, key, data, shuffle=True,
                                    **kw),
           dbn_train.idbn_epoch_pcd(states, chains, key, data[perm], **kw))
    z = torch.rand(n, Dz, generator=torch.Generator().manual_seed(1))
    y = torch.as_tensor(np.eye(K, dtype=np.float32)[np.arange(n) % K])
    img = torch.as_tensor(_data(n, 20, 5))
    jkw = dict(warmup=False, joint_cd=1, aux_cond_steps=2, Dz=Dz, steps=2,
               groups=((Dz, Dz + K),), batch_size=16)
    joint = rbm_ops.init_rbm_state(3, Dz + K, 12)
    idbn = [rbm_ops.init_rbm_state(4, 20, Dz)]
    _equal(imdbn_ops.joint_epoch(joint, idbn, key, z, y, img, 0.05, 0.5,
                                 1e-4, None, shuffle=True, **jkw),
           imdbn_ops.joint_epoch(joint, idbn, key, z[perm], y[perm],
                                 img[perm], 0.05, 0.5, 1e-4, None, **jkw))
    from multimodal_idbn_tpu_torch.ops import bimodal_ops
    mods = ([rbm_ops.init_rbm_state(5, 20, 6)],
            [rbm_ops.init_rbm_state(6, 24, 4)])
    z1, z2 = z[:, :6], z[:, 6:10]
    v1, v2 = img, torch.as_tensor(_data(n, 24, 6))
    bkw = dict(warmup=False, joint_cd=1, aux_cond_steps=2, Dz1=6, steps=2,
               batch_size=16)
    j = [rbm_ops.init_rbm_state(7, 10, 5)]
    _equal(bimodal_ops.bimodal_joint_epoch(j, *mods, key, z1, z2, v1, v2,
                                           0.05, 0.5, 1e-4, shuffle=True,
                                           **bkw),
           bimodal_ops.bimodal_joint_epoch(j, *mods, key, z1[perm],
                                           z2[perm], v1[perm], v2[perm],
                                           0.05, 0.5, 1e-4, **bkw))


# ---------------------------------------------------------------------------
# The 2-D mesh
# ---------------------------------------------------------------------------

def test_tp_mesh_shapes_and_errors(tp_runs):
    r = tp_runs[0]
    assert r["shape12"] == {"data": 1, "model": 2}
    assert r["shape21"] == {"data": 2, "model": 1}
    assert r["local_w"] == (V, H // 2) and r["local_vb"] == (V,)
    assert "not divisible by mp=3" in r["err[('mp', 3)]"]
    assert "requested dp*mp=4 devices, have 2" in \
        r["err[('dp', 2), ('mp', 2)]"]
    assert parallel.state_pspecs().w == (None, "model")


@pytest.mark.parametrize("grid", ["12", "21"])
def test_tp_cd_update_matches_one_device(tp_runs, grid):
    """Groupless: against the single-device kernel update
    (``fast_sampled_cd_update``). With softmax groups: against the same
    update on a 1 × 1 mesh. Both ranks hold the same gathered state."""
    st = rbm_ops.init_rbm_state(3, V, H)
    want, want_loss = fast_cd.fast_sampled_cd_update(
        st, 5, torch.as_tensor(_data(12, V)), **CD_KW)
    one = parallel.make_mesh_2d(dp=1, mp=1, device="cpu")
    gwant, gloss = parallel.tp_cd_update(
        one, rbm_ops.init_rbm_state(4, Dz + K, 12), 6, _joint_data(12),
        groups=((Dz, Dz + K),), **CD_KW)
    for r in tp_runs:
        got, loss = r[f"cd{grid}"]
        _close_states(got, want)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
        got, loss = r[f"groups{grid}"]
        _close_states(got, parallel.gather_state(gwant))
        np.testing.assert_allclose(float(loss), float(gloss), rtol=RTOL)


def test_tp_idbn_epoch_matches_one_device(tp_runs):
    states = [rbm_ops.init_rbm_state(1, V, H), rbm_ops.init_rbm_state(2, H, 8)]
    want, want_losses = dbn_train.idbn_epoch(
        states, 9, torch.as_tensor(_data(32, V, 2)), lr=0.1, mom=0.5,
        weight_decay=1e-4, sparsity_factor=0.05, cd=2,
        sparsity_flags=(False, True), batch_size=16, fast_sampler=True)
    got, losses = tp_runs[0]["epoch"]
    for g, w in zip(got, want):
        _close_states(g, w)
    np.testing.assert_allclose(losses.numpy(), want_losses.numpy(),
                               rtol=RTOL)
    _equal(tp_runs[0]["epoch"], tp_runs[1]["epoch"])


def test_parallel_exports_every_jax_name():
    import multimodal_idbn_tpu.parallel as jpar
    names = [n for n in dir(jpar) if not n.startswith("_")
             and callable(getattr(jpar, n))]
    assert names and all(hasattr(parallel, n) for n in names)
    assert all(hasattr(tmesh, n) for n in ("gather_state", "shard_batch_2d",
                                           "state_pspecs"))


def test_mesh_takes_its_device_from_the_caller():
    """A mesh lies on the device its caller names (the model's, or an
    explicit one): on the CPU only when the CPU was asked for; a CUDA
    request without a card raises, as the entry points do, and never
    turns into a CPU mesh."""
    assert parallel.make_mesh(device="cpu").device == torch.device("cpu")
    assert small_imdbn(DP_DEVICES=1)._resolve_mesh().device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh_2d(dp=1, mp=1)
