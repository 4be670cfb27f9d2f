"""Bimodal joint-DBN training and cross-modal inference (iMDBN_BiModal).

Port of multimodal_idbn_tpu/ops/bimodal_ops.py. The joint is a stack of
RBMs over [z_mod1 ⊕ z_mod2] with no softmax groups. Warm-up batches run
2 × (mod1-clamp, mod2-clamp) clamped CD-3 with stochastic h on layer 0;
main batches run free CD down the joint stack (layer i+1 fed the
``hidden_probs`` of the updated layer i), then the two clamps without the
negative re-clamp. Cross-modal reconstruction is conditional Gibbs with
stochastic h through joint layer 0, then a decode through each modality
DBN.

The JAX epoch is a ``lax.scan`` (``bimodal_joint_epoch``) and, to cut TPU
dispatches, a nested scan over epochs (``bimodal_epoch_block``); here one
Python loop, ``bimodal_epoch``, trains the full batches of
already-permuted data, then the remainder batch; ``bimodal_joint_epoch``
is its full batches alone. ``bimodal_epoch_body`` is one epoch from device
buffers (the permutation gathered from an index buffer, keys read from the
epoch's key table, lr and momentum from 0-d tensors; ``ops.graphs``), and
``bimodal_epoch_block`` runs it for each epoch through an ``EpochRunner``
(``bimodal_epoch_runner``): launch by launch as it is called, or replayed
as one CUDA graph per epoch when the caller hands it a graphed runner, as
``iMDBN_BiModal.train_joint`` does on the card.

With a ``mesh`` (``parallel.make_mesh``) each process trains its rows of
every full batch inside ``shard.rows_of``: every joint update sums over
the mesh and the metric sums of the full batches are summed once an
epoch; the remainder batch runs whole on every process (JAX
models/imdbn_bimodal.py:760-775). Every clamped CD's
30-step noisy init runs on the chain kernel on the card (``ops.chain``);
the sampled conditional Gibbs of the cross metrics and the joint CD stay
plain torch, as they are jnp in the JAX package.

``visibles``, where given, names the unit types of the two modality
stacks' visible layers (``fast_cd.VISIBLE_TYPES``; None: both Bernoulli):
the cross-reconstructions decode to them (``dbn_train.dbn_decode``), and
the sampled cross calls refuse a type that is not Bernoulli.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from multimodal_idbn_tpu_torch.ops import (dbn_train, graphs, rbm_ops, rng,
                                           shard)
from multimodal_idbn_tpu_torch.ops.fast_cd import BERNOULLI

States = List[rbm_ops.RBMState]


def _visible_kw(visibles: Optional[Tuple[str, str]]) -> dict:
    """``visibles`` as a keyword of the calls below, where given."""
    return {} if visibles is None else {"visibles": tuple(visibles)}


class BimodalMetrics(NamedTuple):
    """Per-batch sums of the cross-reconstruction metrics
    (bimodal_ops.py:29-32)."""

    n: torch.Tensor
    mse_mod1: torch.Tensor
    mse_mod2: torch.Tensor


def zeros_metrics(device=None) -> BimodalMetrics:
    z = torch.zeros((), device=device)
    return BimodalMetrics(z, z, z)


def add_metrics(a: BimodalMetrics, b: BimodalMetrics) -> BimodalMetrics:
    return BimodalMetrics(*(x + y for x, y in zip(a, b)))


def _clamps(z1: torch.Tensor, z2: torch.Tensor):
    """(km1, vk1, vk2): the mod1 mask over [z1 ⊕ z2] and the two known
    vectors, each modality clamped with the other zeroed."""
    B, Dz1, Dz2 = z1.shape[0], z1.shape[1], z2.shape[1]
    dev = z1.device
    km1 = torch.cat([torch.ones((B, Dz1), device=dev),
                     torch.zeros((B, Dz2), device=dev)], dim=1)
    vk1 = torch.cat([z1, torch.zeros((B, Dz2), device=dev)], dim=1)
    vk2 = torch.cat([torch.zeros((B, Dz1), device=dev), z2], dim=1)
    return km1, vk1, vk2


def bimodal_cross_reconstruct(joint0: rbm_ops.RBMState,
                              mod1_states: Sequence[rbm_ops.RBMState],
                              mod2_states: Sequence[rbm_ops.RBMState],
                              key: int, z1: torch.Tensor, z2: torch.Tensor,
                              *, steps: int, Dz1: int,
                              direction: str = "both",
                              visibles: Optional[Tuple[str, str]] = None):
    """MOD1→MOD2 and MOD2→MOD1 through joint layer 0
    (bimodal_ops.py:40-77); returns (mod1_from_mod2, mod2_from_mod1), the
    output of a skipped ``direction`` ("1to2" | "2to1") being None. Each
    direction keeps its own key, so a kept direction equals "both"."""
    if direction not in ("both", "1to2", "2to1"):
        raise ValueError(f"unknown direction {direction!r}")
    if z1.shape[1] != Dz1:
        raise ValueError(f"z1 has {z1.shape[1]} columns, Dz1 is {Dz1}")
    km1, vk1, vk2 = _clamps(z1, z2)
    vis1, vis2 = visibles or (BERNOULLI, BERNOULLI)
    mod2_from_mod1 = mod1_from_mod2 = None
    if direction in ("both", "1to2"):
        v = rbm_ops.conditional_gibbs(joint0, rng.fold_in(key, 0), vk1, km1,
                                      n_steps=steps, sample_h=True,
                                      sample_v=False)
        mod2_from_mod1 = dbn_train.dbn_decode(mod2_states, v[:, Dz1:], vis2)
    if direction in ("both", "2to1"):
        v = rbm_ops.conditional_gibbs(joint0, rng.fold_in(key, 1), vk2,
                                      1.0 - km1, n_steps=steps,
                                      sample_h=True, sample_v=False)
        mod1_from_mod2 = dbn_train.dbn_decode(mod1_states, v[:, :Dz1], vis1)
    return mod1_from_mod2, mod2_from_mod1


def bimodal_batch_step(joint: Sequence[rbm_ops.RBMState],
                       mod1_states: Sequence[rbm_ops.RBMState],
                       mod2_states: Sequence[rbm_ops.RBMState], key: int,
                       z1: torch.Tensor, z2: torch.Tensor, v1: torch.Tensor,
                       v2: torch.Tensor, lr, mom, weight_decay, *,
                       warmup: bool, joint_cd: int, aux_cond_steps: int,
                       Dz1: int, steps: int, compute_metrics: bool = True,
                       sr: Optional[bool] = None,
                       visibles: Optional[Tuple[str, str]] = None
                       ) -> Tuple[States, torch.Tensor, BimodalMetrics]:
    """``_bimodal_train_batch`` as its jitted twin (bimodal_ops.py:307-316):
    on a CUDA device one graph replay (``graphs.serve``, the graphs of
    ``graphs.SHARED``; lr and momentum read from ``graphs.hyper``),
    launch by launch elsewhere."""
    dev = z1.device
    return graphs.serve(
        graphs.SHARED, dev, _bimodal_step_at, key, joint, mod1_states,
        mod2_states, z1, z2, v1, v2, graphs.hyper(dev, lr, mom),
        weight_decay, warmup=warmup, joint_cd=joint_cd,
        aux_cond_steps=aux_cond_steps, Dz1=Dz1, steps=steps,
        compute_metrics=compute_metrics, sr=sr, **_visible_kw(visibles))


def _bimodal_step_at(joint, mod1_states, mod2_states, z1, z2, v1, v2, hyper,
                     weight_decay, *, key, **statics):
    return _bimodal_train_batch(joint, mod1_states, mod2_states, key, z1,
                                z2, v1, v2, hyper[0], hyper[1], weight_decay,
                                **statics)


def _bimodal_train_batch(joint: Sequence[rbm_ops.RBMState],
                         mod1_states: Sequence[rbm_ops.RBMState],
                         mod2_states: Sequence[rbm_ops.RBMState], key,
                         z1: torch.Tensor, z2: torch.Tensor,
                         v1: torch.Tensor, v2: torch.Tensor, lr, mom,
                         weight_decay, *, warmup: bool, joint_cd: int,
                         aux_cond_steps: int, Dz1: int, steps: int,
                         compute_metrics: bool = True,
                         sr: Optional[bool] = None,
                         visibles: Optional[Tuple[str, str]] = None
                         ) -> Tuple[States, torch.Tensor, BimodalMetrics]:
    """One bimodal joint batch (bimodal_ops.py:80-146). Returns (joint
    states, layer-0 CD loss (0 in warm-up), metric sums). ``sr`` reaches
    every joint update, free and clamped (:105-134)."""
    km1, vk1, vk2 = _clamps(z1, z2)
    keys = [rng.fold_in(key, i) for i in range(8)]
    layers = list(joint)
    aux = dict(lr=lr, mom=mom, weight_decay=weight_decay, cd=3,
               cond_init_steps=aux_cond_steps, sample_h=True, sample_v=False,
               aux_lr_mult=0.3, use_noisy_init=True, sr=sr)

    cd_loss = torch.zeros((), device=z1.device)
    if warmup:
        for i in range(2):
            layers[0], _ = rbm_ops.clamped_cd_update(
                layers[0], keys[2 * i], vk1, km1, reclamp_negative=True,
                **aux)
            layers[0], _ = rbm_ops.clamped_cd_update(
                layers[0], keys[2 * i + 1], vk2, 1.0 - km1,
                reclamp_negative=True, **aux)
    else:
        current = torch.cat([z1, z2], dim=1)
        for li in range(len(layers)):
            layers[li], loss = rbm_ops.cd_update(
                layers[li], rng.fold_in(keys[4], li), current, lr=lr,
                mom=mom, weight_decay=weight_decay, cd=joint_cd, sr=sr)
            if li == 0:
                cd_loss = loss
            current = rbm_ops.hidden_probs(layers[li], current)
        layers[0], _ = rbm_ops.clamped_cd_update(
            layers[0], keys[5], vk1, km1, reclamp_negative=False, **aux)
        layers[0], _ = rbm_ops.clamped_cd_update(
            layers[0], keys[6], vk2, 1.0 - km1, reclamp_negative=False,
            **aux)

    metrics = zeros_metrics(z1.device)
    if compute_metrics:
        rec1, rec2 = bimodal_cross_reconstruct(
            layers[0], mod1_states, mod2_states, keys[7], z1, z2,
            steps=steps, Dz1=Dz1, visibles=visibles)
        metrics = BimodalMetrics(
            torch.full((), float(z1.shape[0]), device=z1.device),
            ((rec1 - v1) ** 2).sum(), ((rec2 - v2) ** 2).sum())
    return layers, cd_loss, metrics


def bimodal_epoch(joint: Sequence[rbm_ops.RBMState],
                  mod1_states: Sequence[rbm_ops.RBMState],
                  mod2_states: Sequence[rbm_ops.RBMState], key: int,
                  Z1: torch.Tensor, Z2: torch.Tensor, V1: torch.Tensor,
                  V2: torch.Tensor, lr, mom, weight_decay, *, warmup: bool,
                  joint_cd: int, aux_cond_steps: int, Dz1: int, steps: int,
                  batch_size: int, metrics_every: int = 1,
                  sr: Optional[bool] = None, mesh=None,
                  visibles: Optional[Tuple[str, str]] = None):
    """One joint epoch over already-permuted latents Z and images V: the
    ``n // batch_size`` full batches in order, batch b keyed
    ``fold_in(fold_in(key, 0), b)``, then the remainder keyed
    ``fold_in(key, 1)`` (``bimodal_joint_epoch`` + the caller's remainder,
    and ``bimodal_epoch_block``, bimodal_ops.py:154-301).

    Metrics run on every ``metrics_every``-th full batch, and on the
    remainder only when ``metrics_every == 1``, as there. Returns
    (joint, CD-loss sum, number of CD batches, metric sums). With a
    ``mesh``, this process's rows of each full batch (module docstring).
    """
    n = Z1.shape[0]
    nb = n // batch_size
    every = max(1, int(metrics_every))
    statics = dict(warmup=warmup, joint_cd=joint_cd,
                   aux_cond_steps=aux_cond_steps, Dz1=Dz1, steps=steps,
                   sr=sr, **_visible_kw(visibles))
    joint = list(joint)
    totals = zeros_metrics(Z1.device)
    cd_sum = torch.zeros((), device=Z1.device)
    for b in range(nb):
        sl = slice(b * batch_size, (b + 1) * batch_size)
        with shard.rows_of(mesh, batch_size) as rows:
            joint, cd_loss, m = _bimodal_train_batch(
                joint, mod1_states, mod2_states,
                rng.fold_in(rng.fold_in(key, 0), b), Z1[sl][rows],
                Z2[sl][rows], V1[sl][rows], V2[sl][rows], lr, mom,
                weight_decay, compute_metrics=b % every == 0, **statics)
        totals = add_metrics(totals, m)
        cd_sum = cd_sum + cd_loss
    if mesh is not None:
        totals = BimodalMetrics(*shard.all_reduce_sum(totals,
                                                      mesh.data_group))
    n_batches = nb
    if n > nb * batch_size:
        sl = slice(nb * batch_size, n)
        joint, cd_loss, m = _bimodal_train_batch(
            joint, mod1_states, mod2_states, rng.fold_in(key, 1), Z1[sl],
            Z2[sl], V1[sl], V2[sl], lr, mom, weight_decay,
            compute_metrics=every == 1, **statics)
        totals = add_metrics(totals, m)
        cd_sum = cd_sum + cd_loss
        n_batches += 1
    return joint, cd_sum, (0 if warmup else n_batches), totals


def bimodal_joint_epoch(joint: Sequence[rbm_ops.RBMState],
                        mod1_states: Sequence[rbm_ops.RBMState],
                        mod2_states: Sequence[rbm_ops.RBMState], key: int,
                        Z1: torch.Tensor, Z2: torch.Tensor,
                        V1: torch.Tensor, V2: torch.Tensor, lr, mom,
                        weight_decay, *, warmup: bool, joint_cd: int,
                        aux_cond_steps: int, Dz1: int, steps: int,
                        batch_size: int, metrics_every: int = 1,
                        shuffle: bool = False, sr: Optional[bool] = None,
                        mesh=None,
                        visibles: Optional[Tuple[str, str]] = None):
    """The full batches of one joint epoch (bimodal_ops.py:154-249): the
    rows beyond ``n // batch_size`` batches are left to the caller.
    ``shuffle`` permutes the data by ``rng.permutation(key, n)`` first.
    Returns (joint, mean free-CD loss, metric sums)."""
    if shuffle:
        perm = rng.permutation(key, Z1.shape[0]).to(Z1.device)
        Z1, Z2, V1, V2 = (a[perm] for a in (Z1, Z2, V1, V2))
    m = (Z1.shape[0] // batch_size) * batch_size
    joint, cd_sum, count, totals = bimodal_epoch(
        joint, mod1_states, mod2_states, key, Z1[:m], Z2[:m], V1[:m],
        V2[:m], lr, mom, weight_decay, warmup=warmup, joint_cd=joint_cd,
        aux_cond_steps=aux_cond_steps, Dz1=Dz1, steps=steps,
        batch_size=batch_size, metrics_every=metrics_every, sr=sr,
        mesh=mesh, visibles=visibles)
    return joint, cd_sum / max(1, count), totals


def bimodal_epoch_body(consts, joint, perm, lr, mom, *, weight_decay,
                       **statics):
    """One joint epoch from device buffers (``ops.graphs``): ``consts`` is
    (Z1, Z2, V1, V2, mod1_states, mod2_states); the data permuted by
    ``perm``, then ``bimodal_epoch``. Returns (joint, (CD-loss sum,
    metric sums))."""
    Z1, Z2, V1, V2, mod1_states, mod2_states = consts
    Z1, Z2, V1, V2 = (a.index_select(0, perm) for a in (Z1, Z2, V1, V2))
    joint, cd_sum, _, totals = bimodal_epoch(
        joint, mod1_states, mod2_states, rng.Key(), Z1, Z2, V1, V2, lr, mom,
        weight_decay, **statics)
    return joint, (cd_sum, totals)


def bimodal_epoch_runner(Z1: torch.Tensor, Z2: torch.Tensor,
                         V1: torch.Tensor, V2: torch.Tensor,
                         mod1_states: Sequence[rbm_ops.RBMState],
                         mod2_states: Sequence[rbm_ops.RBMState],
                         weight_decay, *, warmup: bool, joint_cd: int,
                         aux_cond_steps: int, Dz1: int, steps: int,
                         batch_size: int, metrics_every: int = 1,
                         sr: Optional[bool] = None, mesh=None,
                         graphed: bool = False,
                         visibles: Optional[Tuple[str, str]] = None
                         ) -> graphs.EpochRunner:
    """The runner of ``bimodal_epoch_body`` at one setting (warm-up or
    main); ``graphed`` replays it as a CUDA graph (no ``mesh``)."""
    if graphed and mesh is not None:
        raise ValueError("a data-parallel epoch runs launch by launch")
    statics = dict(weight_decay=weight_decay, warmup=bool(warmup),
                   joint_cd=int(joint_cd),
                   aux_cond_steps=int(aux_cond_steps), Dz1=int(Dz1),
                   steps=int(steps), batch_size=int(batch_size),
                   metrics_every=int(metrics_every), sr=sr, mesh=mesh,
                   **_visible_kw(visibles))
    return graphs.EpochRunner(
        "bimodal_epoch_warmup" if warmup else "bimodal_epoch",
        bimodal_epoch_body,
        (Z1, Z2, V1, V2, list(mod1_states), list(mod2_states)), statics,
        n_rows=Z1.shape[0], device=Z1.device, graphed=graphed)


def bimodal_epoch_block(joint: Sequence[rbm_ops.RBMState],
                        mod1_states: Sequence[rbm_ops.RBMState],
                        mod2_states: Sequence[rbm_ops.RBMState],
                        epoch_key: int, Z1: torch.Tensor, Z2: torch.Tensor,
                        V1: torch.Tensor, V2: torch.Tensor,
                        epoch_idx: Sequence[int], lr_arr, mom_arr,
                        weight_decay, *, warmup: bool, joint_cd: int,
                        aux_cond_steps: int, Dz1: int, steps: int,
                        batch_size: int, metrics_every: int = 1,
                        n_epochs: Optional[int] = None,
                        sr: Optional[bool] = None, mesh=None,
                        runner: Optional[graphs.EpochRunner] = None,
                        visibles: Optional[Tuple[str, str]] = None):
    """The joint epochs ``epoch_idx`` (all warm-up or all main, as
    ``warmup`` says): epoch e is ``bimodal_epoch_body`` under the key
    ``fold_in(epoch_key, e)`` (its permutation ``rng.permutation`` of that
    key), launch by launch, or through ``runner`` (a
    ``bimodal_epoch_runner`` at this setting, which may be graphed).
    Returns (joint, CD-loss sums[E], CD batch counts[E], metric sums[E])
    (bimodal_ops.py:252-301)."""
    if n_epochs is not None and int(n_epochs) != len(epoch_idx):
        raise ValueError(f"n_epochs {n_epochs} but {len(epoch_idx)} "
                         f"epoch indices")
    run = runner or bimodal_epoch_runner(
        Z1, Z2, V1, V2, mod1_states, mod2_states, weight_decay,
        warmup=warmup, joint_cd=joint_cd, aux_cond_steps=aux_cond_steps,
        Dz1=Dz1, steps=steps, batch_size=batch_size,
        metrics_every=metrics_every, sr=sr, mesh=mesh, visibles=visibles)
    count = 0 if warmup else -(-Z1.shape[0] // batch_size)
    joint = list(joint)
    sums, counts, totals = [], [], []
    for e, lr, mom in zip(epoch_idx, lr_arr, mom_arr):
        joint, (cd_sum, tot) = run(joint, rng.fold_in(epoch_key, int(e)),
                                   lr, mom)
        sums.append(cd_sum)
        counts.append(count)
        totals.append(tot)
    return joint, sums, counts, totals


def sample_cross(joint0: rbm_ops.RBMState,
                 mod1_states: Sequence[rbm_ops.RBMState],
                 mod2_states: Sequence[rbm_ops.RBMState], key: int,
                 z1: torch.Tensor, z2: torch.Tensor, *, steps: int, Dz1: int,
                 direction: str,
                 visibles: Optional[Tuple[str, str]] = None) -> torch.Tensor:
    """Draw the other modality from p(x_other | x_known)
    (bimodal_ops.py:328-361): the fully sampled conditional chain on joint
    layer 0, then the ancestral-sampled decode through the target
    modality's DBN. ``direction`` "1to2" returns mod2 images, "2to1" mod1.
    """
    if direction not in ("1to2", "2to1"):
        raise ValueError(f"unknown direction {direction!r}")
    B, Dz2 = z1.shape[0], z2.shape[1]
    dev = z1.device
    km1 = torch.cat([torch.ones((Dz1,), device=dev),
                     torch.zeros((Dz2,), device=dev)])
    if direction == "1to2":
        v_known = torch.cat([z1, torch.zeros((B, Dz2), device=dev)], 1)
        km = km1
    else:
        v_known = torch.cat([torch.zeros((B, Dz1), device=dev), z2], 1)
        km = 1.0 - km1
    v = rbm_ops.sampled_conditional_chain(joint0, rng.fold_in(key, 0),
                                          v_known, km, n_steps=steps)
    kdec = rng.fold_in(key, 1)
    vis1, vis2 = visibles or (BERNOULLI, BERNOULLI)
    if direction == "1to2":
        return dbn_train.dbn_decode_sampled(mod2_states, v[:, Dz1:], kdec,
                                            vis2)
    return dbn_train.dbn_decode_sampled(mod1_states, v[:, :Dz1], kdec, vis1)
