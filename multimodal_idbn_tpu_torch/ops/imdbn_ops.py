"""Joint-RBM training and cross-modal inference of the iMDBN.

Port of multimodal_idbn_tpu/ops/imdbn_ops.py:27-337 (``joint_bias_stats``,
``cross_reconstruct``, ``cross_metrics_batch``, ``_joint_train_batch``,
``joint_epoch``), :340-438 (``joint_epoch_block``) and :473-507
(``sample_txt2img``). ``joint_epoch`` is a Python loop over static batch
slices of already-permuted data, the remainder left to the caller. Every
chain of a batch (the 30-step noisy init of each auxiliary clamped CD,
the 50-step IMG→TXT mean-field chain and the 50-step noisy TXT→IMG chain)
goes through ``ops.chain``'s kernel on the card.

The JAX epoch is one ``lax.scan``. Here one epoch is ``joint_epoch_body``:
the permutation gathered from a device buffer, the full batches, then the
remainder batch keyed ``fold_in(key, 991)``, with its keys read from the
epoch's key table and lr and momentum from 0-d tensors (``ops.graphs``).
``joint_epoch_block`` runs it for each epoch through an ``EpochRunner``
(``joint_epoch_runner``): launch by launch as it is called, or replayed
as one CUDA graph per epoch when the caller hands it a graphed runner, as
``iMDBN.train_joint`` does on the card.

With a ``mesh`` (``parallel.make_mesh``) each process trains its rows of
every full batch inside ``shard.rows_of``: every joint update sums over
the mesh and the cross-metric sums are summed once an epoch, so the
replicas stay equal; the remainder batch runs whole on every process
(JAX models/imdbn.py:576-597).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from multimodal_idbn_tpu_torch.ops import (dbn_train, graphs, rbm_ops, rng,
                                           shard)
from multimodal_idbn_tpu_torch.ops.sampling import SoftmaxGroups, one_hot


class CrossMetrics(NamedTuple):
    """Per-batch sums of the reference's epoch metrics
    (imdbn_ops.py:27-34)."""

    n: torch.Tensor
    top1: torch.Tensor
    top3: torch.Tensor
    ce_sum: torch.Tensor
    mse_sum: torch.Tensor


def zeros_metrics(device=None) -> CrossMetrics:
    z = torch.zeros((), device=device)
    return CrossMetrics(z, z, z, z, z)


def add_metrics(a: CrossMetrics, b: CrossMetrics) -> CrossMetrics:
    return CrossMetrics(*(x + y for x, y in zip(a, b)))


def joint_bias_stats(Z: torch.Tensor, Y: torch.Tensor, *, num_classes: int):
    """(z_bias, y_bias, z_class_mean) from latents and one-hot labels
    (imdbn_ops.py:46-71): logit of the clipped mean latent, log of the
    smoothed label priors, per-class latent means with the global mean
    for empty classes."""
    K = num_classes
    mean_z = torch.clamp(Z.mean(0), 1e-4, 1 - 1e-4)
    class_counts = Y.sum(0)
    priors = class_counts / torch.clamp(class_counts.sum(), min=1.0)
    priors = (priors + 1e-6) / (priors.sum() + 1e-6 * K)
    onehot = torch.nn.functional.one_hot(Y.argmax(dim=1), K).to(Z.dtype)
    sums = onehot.T @ Z
    counts = onehot.sum(0)
    z_class_mean = torch.where(
        (counts > 0)[:, None],
        sums / torch.clamp(counts, min=1.0)[:, None], mean_z[None, :])
    z_bias = torch.log(mean_z) - torch.log1p(-mean_z)
    y_bias = torch.log(priors)
    return z_bias, y_bias, z_class_mean


def cross_reconstruct(joint: rbm_ops.RBMState,
                      idbn_states: Sequence[rbm_ops.RBMState], key: int,
                      z_img: torch.Tensor, y_onehot: torch.Tensor, *,
                      steps: int, Dz: int, groups: SoftmaxGroups,
                      z_class_mean: Optional[torch.Tensor] = None,
                      z_affine: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None,
                      use_free_energy: bool = False, best_of_k: int = 5,
                      direction: str = "both"):
    """IMG→TXT then TXT→IMG through the joint RBM; returns
    (decoded image [B, D], p(y|img) [B, K]) (imdbn_ops.py:78-171).

    ``direction`` ("both" | "img2txt" | "txt2img") skips the unused half,
    whose output is then ``None``; the keys of the two halves are
    ``fold_in(key, 0)`` and ``fold_in(key, 1)`` whatever the direction, so
    the kept half is bit-identical to the same half of "both".

    Best-of-K: with ``use_free_energy=False`` (the default) it is the
    reference's no-op: its free-energy guard never fires, so candidate 0,
    the full annealed chain, is always chosen (imdbn_ops.py:94-101), and
    the dead candidates are skipped. With ``use_free_energy=True``,
    candidate i+1 is a 1-step cold refinement (T=0.9, σ=0) of candidate i,
    keyed ``fold_in(fold_in(key, 2), i)``, and each sample takes the
    candidate of least ``rbm_ops.free_energy`` (imdbn_ops.py:144-161).
    """
    if direction not in ("both", "img2txt", "txt2img"):
        raise ValueError(f"unknown direction {direction!r}")
    B, K = y_onehot.shape
    dev = z_img.device
    k_i2t, k_t2i, k_ref = (rng.fold_in(key, i) for i in range(3))
    zeros_k = torch.zeros((B, K), device=dev)
    km = torch.cat([torch.ones((B, Dz), device=dev), zeros_k], dim=1)

    p_y_given_img = None
    if direction in ("both", "img2txt"):
        # IMG→TXT: z clamped, mean-field conditional Gibbs (:116-125)
        v_img2txt = rbm_ops.conditional_gibbs(
            joint, k_i2t, torch.cat([z_img, zeros_k], dim=1), km,
            n_steps=steps, sample_h=False, sample_v=False, groups=groups)
        p_y_given_img = v_img2txt[:, Dz:]
    if direction == "img2txt":
        return None, p_y_given_img

    # TXT→IMG: y clamped, μ-pull, noisy annealing (imdbn_ops.py:129-142)
    v_known2 = torch.cat([torch.zeros((B, Dz), device=dev), y_onehot], dim=1)
    km2 = 1.0 - km
    mu_k = None
    if z_class_mean is not None:
        mu_k = z_class_mean[y_onehot.argmax(dim=1)]
    v_pick = rbm_ops.noisy_meanfield_annealed(
        joint, k_t2i, v_known2, km2, n_steps=steps, T0=3.0, T1=1.0,
        sigma0=0.9, hot_frac=0.7, sharpen_last=3, T_cold_plus=0.9,
        mu_k=mu_k, eta0=0.15, groups=groups)

    if use_free_energy and best_of_k > 1:
        cands = [v_pick]
        for i in range(best_of_k - 1):
            # the chain re-draws the unknown block each time (:145-147)
            cands.append(rbm_ops.noisy_meanfield_annealed(
                joint, rng.fold_in(k_ref, i), cands[-1], km2, n_steps=1,
                T0=0.9, T1=0.9, sigma0=0.0, hot_frac=0.0, sharpen_last=0,
                T_cold_plus=0.9, mu_k=mu_k, eta0=0.15, groups=groups))
        cands = torch.stack(cands)                             # [Kb, B, V]
        best = torch.stack([rbm_ops.free_energy(joint, v)
                            for v in cands]).argmin(dim=0)     # [B]
        v_pick = cands[best, torch.arange(B, device=dev)]

    z_from_y = v_pick[:, :Dz]
    if z_affine is not None:
        scale, bias = z_affine
        z_from_y = (z_from_y - bias) / (scale + 1e-6)
    return dbn_train.dbn_decode(idbn_states, z_from_y), p_y_given_img


def cross_metrics_batch(img_from_txt: torch.Tensor, p_y: torch.Tensor,
                        img_flat: torch.Tensor,
                        y_onehot: torch.Tensor) -> CrossMetrics:
    """Per-batch metric sums (imdbn_ops.py:174-188)."""
    gt = y_onehot.argmax(dim=1)
    pred = p_y.argmax(dim=1)
    topk_idx = torch.topk(p_y, min(3, p_y.shape[1]), dim=1).indices
    top3 = (topk_idx == gt[:, None]).any(dim=1)
    p = torch.clamp(p_y, 1e-6, 1 - 1e-6)
    t = one_hot(gt, p_y.shape[1], p.dtype)
    ce = -(t * torch.log(p) + (1 - t) * torch.log1p(-p)).sum()
    mse = ((img_from_txt - img_flat) ** 2).sum()
    n = torch.full((), float(img_flat.shape[0]), device=p.device)
    return CrossMetrics(n, (pred == gt).sum().float(), top3.sum().float(),
                        ce, mse)


def _joint_train_batch(joint: rbm_ops.RBMState,
                       idbn_states: Sequence[rbm_ops.RBMState], key: int,
                       zb: torch.Tensor, yb: torch.Tensor,
                       imgb: torch.Tensor, b_idx: int, lr, mom,
                       weight_decay, z_class_mean, *, warmup: bool,
                       joint_cd: int, aux_cond_steps: int, Dz: int,
                       steps: int, groups: SoftmaxGroups,
                       zclamp_every: int, compute_metrics: bool,
                       use_free_energy: bool = False,
                       sr: Optional[bool] = None):
    """One joint-training batch (imdbn_ops.py:195-262).

    Warm-up: 2× y-clamped aux CD. Main: free CD + y-clamp aux every batch
    + z-clamp aux when ``b_idx % zclamp_every == 0``. Then the cross-modal
    round trip and its metrics. ``sr`` reaches every joint update
    (:201-259). Returns (joint, cd_loss, CrossMetrics).
    """
    B, K = yb.shape
    dev = zb.device
    v_plus = torch.cat([zb, yb], dim=1)
    km_y = torch.cat([torch.zeros((B, Dz), device=dev),
                      torch.ones((B, K), device=dev)], dim=1)
    v_known_y = torch.cat([torch.zeros((B, Dz), device=dev), yb], dim=1)
    keys = [rng.fold_in(key, i) for i in range(4)]
    aux = dict(lr=lr, mom=mom, weight_decay=weight_decay, cd=1,
               cond_init_steps=aux_cond_steps, sample_h=False,
               sample_v=False, aux_lr_mult=0.3, use_noisy_init=True,
               groups=groups, sr=sr)

    cd_loss = torch.zeros((), device=dev)
    if warmup:
        for i in range(2):
            joint, _ = rbm_ops.clamped_cd_update(
                joint, keys[i], v_known_y, km_y, reclamp_negative=True,
                **aux)
    else:
        joint, cd_loss = rbm_ops.cd_update(
            joint, keys[0], v_plus, lr=lr, mom=mom,
            weight_decay=weight_decay, cd=joint_cd, groups=groups, sr=sr)
        joint, _ = rbm_ops.clamped_cd_update(
            joint, keys[1], v_known_y, km_y, reclamp_negative=False, **aux)
        if b_idx % zclamp_every == 0:
            v_known_z = torch.cat([zb, torch.zeros((B, K), device=dev)],
                                  dim=1)
            joint, _ = rbm_ops.clamped_cd_update(
                joint, keys[2], v_known_z, 1.0 - km_y,
                reclamp_negative=False, **aux)

    metrics = zeros_metrics(dev)
    if compute_metrics:
        img_from_txt, p_y = cross_reconstruct(
            joint, idbn_states, keys[3], zb, yb, steps=steps, Dz=Dz,
            groups=groups, z_class_mean=z_class_mean,
            use_free_energy=use_free_energy)
        metrics = cross_metrics_batch(img_from_txt, p_y, imgb, yb)
    return joint, cd_loss, metrics


def joint_train_batch_step(joint: rbm_ops.RBMState,
                           idbn_states: Sequence[rbm_ops.RBMState], key: int,
                           zb: torch.Tensor, yb: torch.Tensor,
                           imgb: torch.Tensor, b_idx: int, lr, mom,
                           weight_decay, z_class_mean, *, warmup: bool,
                           joint_cd: int, aux_cond_steps: int, Dz: int,
                           steps: int, groups: SoftmaxGroups,
                           use_free_energy: bool = False,
                           zclamp_every: int = 50,
                           compute_metrics: bool = True,
                           sr: Optional[bool] = None):
    """``_joint_train_batch`` with JAX's defaults: the single-batch jitted
    variant (imdbn_ops.py:440-459). On a CUDA device one graph replay
    (``graphs.serve``, the graphs of ``graphs.SHARED``; lr and momentum
    read from ``graphs.hyper``; the batch index reaches the graph only as
    whether the z-clamp runs), launch by launch elsewhere."""
    dev = zb.device
    zclamp_every = int(zclamp_every)
    return graphs.serve(
        graphs.SHARED, dev, _joint_step_at, key, joint, idbn_states, zb, yb,
        imgb, graphs.hyper(dev, lr, mom), weight_decay, z_class_mean,
        b_idx=0 if int(b_idx) % zclamp_every == 0 else 1, warmup=warmup,
        joint_cd=joint_cd, aux_cond_steps=aux_cond_steps, Dz=Dz,
        steps=steps, groups=groups, use_free_energy=use_free_energy,
        zclamp_every=zclamp_every, compute_metrics=compute_metrics, sr=sr)


def _joint_step_at(joint, idbn_states, zb, yb, imgb, hyper, weight_decay,
                   z_class_mean, *, key, b_idx, **statics):
    return _joint_train_batch(joint, idbn_states, key, zb, yb, imgb, b_idx,
                              hyper[0], hyper[1], weight_decay, z_class_mean,
                              **statics)


def joint_epoch(joint: rbm_ops.RBMState,
                idbn_states: Sequence[rbm_ops.RBMState], key: int,
                Z: torch.Tensor, Y: torch.Tensor, IMG: torch.Tensor, lr,
                mom, weight_decay, z_class_mean, *, warmup: bool,
                joint_cd: int, aux_cond_steps: int, Dz: int, steps: int,
                groups: SoftmaxGroups, use_free_energy: bool = False,
                zclamp_every: int = 50, batch_size: int = 128,
                metrics_every: int = 1, sr: Optional[bool] = None,
                shuffle: bool = False, mesh=None):
    """One joint epoch over the full batches of already-permuted data
    (imdbn_ops.py:265-337; ``shuffle`` permutes them by
    ``rng.permutation(key, n)`` first). Returns (joint, mean_cd_loss,
    CrossMetrics sums). With ``metrics_every > 1`` the round trip runs on
    every Nth batch only (the config's ``cross_metrics_every``). With a
    ``mesh``, this process's rows of each batch (module docstring)."""
    if shuffle:
        perm = rng.permutation(key, Z.shape[0]).to(Z.device)
        Z, Y, IMG = Z[perm], Y[perm], IMG[perm]
    nb = Z.shape[0] // batch_size
    totals = zeros_metrics(Z.device)
    loss_sum = torch.zeros((), device=Z.device)
    for b in range(nb):
        sl = slice(b * batch_size, (b + 1) * batch_size)
        with shard.rows_of(mesh, batch_size) as rows:
            joint, cd_loss, m = _joint_train_batch(
                joint, idbn_states, rng.fold_in(key, b), Z[sl][rows],
                Y[sl][rows], IMG[sl][rows], b, lr, mom, weight_decay,
                z_class_mean, warmup=warmup, joint_cd=joint_cd,
                aux_cond_steps=aux_cond_steps, Dz=Dz, steps=steps,
                groups=groups, zclamp_every=zclamp_every,
                compute_metrics=(b % max(1, metrics_every) == 0),
                use_free_energy=use_free_energy, sr=sr)
        totals = add_metrics(totals, m)
        loss_sum = loss_sum + cd_loss
    if mesh is not None:
        totals = CrossMetrics(*shard.all_reduce_sum(totals, mesh.data_group))
    return joint, loss_sum / max(1, nb), totals


def joint_epoch_body(consts, joint, perm, lr, mom, *, weight_decay,
                     batch_size: int, metrics_every: int, mesh=None,
                     **statics):
    """One joint epoch from device buffers (``ops.graphs``): ``consts`` is
    (Z, Y, IMG, idbn_states, z_class_mean). The data permuted by ``perm``,
    its full batches (``joint_epoch``, over ``mesh``), then the remainder
    batch keyed ``fold_in(key, 991)``, run whole on every process and with
    metrics only at the every-batch cadence (JAX ops/imdbn_ops.py:430,
    models/imdbn.py:592). Returns (joint, (mean free-CD loss of the full
    batches, the remainder's free-CD loss or None, CrossMetrics sums))."""
    Z, Y, IMG, idbn_states, z_class_mean = consts
    n = Z.shape[0]
    nb = n // batch_size
    key = rng.Key()
    Zp, Yp, Xp = (a.index_select(0, perm) for a in (Z, Y, IMG))
    joint, mean_cd, totals = joint_epoch(
        joint, idbn_states, key, Zp, Yp, Xp, lr, mom, weight_decay,
        z_class_mean, batch_size=batch_size, metrics_every=metrics_every,
        mesh=mesh, **statics)
    cd_rem = None
    if n - nb * batch_size:
        tail = slice(nb * batch_size, n)
        joint, cd_rem, m_rem = _joint_train_batch(
            joint, idbn_states, rng.fold_in(key, 991), Zp[tail], Yp[tail],
            Xp[tail], nb, lr, mom, weight_decay, z_class_mean,
            compute_metrics=(max(1, metrics_every) == 1), **statics)
        totals = add_metrics(totals, m_rem)
    return joint, (mean_cd, cd_rem, totals)


def joint_epoch_runner(Z: torch.Tensor, Y: torch.Tensor, IMG: torch.Tensor,
                       idbn_states: Sequence[rbm_ops.RBMState],
                       z_class_mean, weight_decay, *, warmup: bool,
                       joint_cd: int, aux_cond_steps: int, Dz: int,
                       steps: int, groups: SoftmaxGroups,
                       use_free_energy: bool = False, zclamp_every: int = 50,
                       batch_size: int = 128, metrics_every: int = 1,
                       sr: Optional[bool] = None, mesh=None,
                       graphed: bool = False) -> graphs.EpochRunner:
    """The runner of ``joint_epoch_body`` at one setting (warm-up or
    main); ``graphed`` replays it as a CUDA graph (no ``mesh``)."""
    if graphed and mesh is not None:
        raise ValueError("a data-parallel epoch runs launch by launch")
    statics = dict(
        weight_decay=weight_decay, warmup=bool(warmup),
        joint_cd=int(joint_cd), aux_cond_steps=int(aux_cond_steps),
        Dz=int(Dz), steps=int(steps),
        groups=tuple((int(a), int(b)) for a, b in groups),
        use_free_energy=bool(use_free_energy),
        zclamp_every=int(zclamp_every), sr=sr, batch_size=int(batch_size),
        metrics_every=int(metrics_every), mesh=mesh)
    return graphs.EpochRunner(
        "joint_epoch_warmup" if warmup else "joint_epoch", joint_epoch_body,
        (Z, Y, IMG, list(idbn_states), z_class_mean), statics,
        n_rows=Z.shape[0], device=Z.device, graphed=graphed)


def joint_epoch_block(joint: rbm_ops.RBMState,
                      idbn_states: Sequence[rbm_ops.RBMState],
                      epoch_key: int, Z: torch.Tensor, Y: torch.Tensor,
                      IMG: torch.Tensor, epoch_idx: Sequence[int], lr_arr,
                      mom_arr, weight_decay, z_class_mean, *, warmup: bool,
                      joint_cd: int, aux_cond_steps: int, Dz: int,
                      steps: int, groups: SoftmaxGroups,
                      use_free_energy: bool = False, zclamp_every: int = 50,
                      batch_size: int = 128, metrics_every: int = 1,
                      n_epochs: Optional[int] = None,
                      sr: Optional[bool] = None, mesh=None,
                      runner: Optional[graphs.EpochRunner] = None):
    """The joint epochs ``epoch_idx`` (all warm-up or all main, as
    ``warmup`` says): epoch e is ``joint_epoch_body`` under the key
    ``fold_in(epoch_key, e)`` (its permutation ``rng.permutation`` of that
    key), launch by launch, or through ``runner`` (a ``joint_epoch_runner``
    at this setting, which may be graphed). Returns (joint, the free-CD
    losses of each epoch, one per batch and none in the warm-up,
    CrossMetrics sums of each epoch)."""
    if n_epochs is not None and int(n_epochs) != len(epoch_idx):
        raise ValueError(f"n_epochs {n_epochs} but {len(epoch_idx)} "
                         f"epoch indices")
    run = runner or joint_epoch_runner(
        Z, Y, IMG, idbn_states, z_class_mean, weight_decay, warmup=warmup,
        joint_cd=joint_cd, aux_cond_steps=aux_cond_steps, Dz=Dz,
        steps=steps, groups=groups, use_free_energy=use_free_energy,
        zclamp_every=zclamp_every, batch_size=batch_size,
        metrics_every=metrics_every, sr=sr, mesh=mesh)
    nb = Z.shape[0] // batch_size
    cd_losses, totals_e = [], []
    for e, lr, mom in zip(epoch_idx, lr_arr, mom_arr):
        joint, (mean_cd, cd_rem, totals) = run(
            joint, rng.fold_in(epoch_key, int(e)), lr, mom)
        losses = [] if warmup else [mean_cd] * nb
        if cd_rem is not None and not warmup:
            losses.append(cd_rem)
        cd_losses.append(losses)
        totals_e.append(totals)
    return joint, cd_losses, totals_e


def sample_txt2img(joint: rbm_ops.RBMState,
                   idbn_states: Sequence[rbm_ops.RBMState], key: int,
                   y_onehot: torch.Tensor, *, steps: int, Dz: int,
                   groups: SoftmaxGroups,
                   z_affine: Optional[Tuple[torch.Tensor,
                                            torch.Tensor]] = None):
    """Draw images from p(img | y) (imdbn_ops.py:473-507): the fully
    sampled conditional chain on the joint RBM with the label block
    clamped (``rbm_ops.sampled_conditional_chain``, keyed
    ``fold_in(key, 0)``), then the ancestral-sampled decode through the
    image iDBN (``dbn_train.dbn_decode_sampled``, ``fold_in(key, 1)``).
    Plain torch, as both are plain XLA in the JAX package. Returns
    (images [B, D], pixel probabilities of the sampled configuration;
    z_sample [B, Dz], the binary top-layer sample)."""
    B, K = y_onehot.shape
    dev = y_onehot.device
    v_known = torch.cat([torch.zeros((B, Dz), device=dev),
                         y_onehot.to(torch.float32)], dim=1)
    km = torch.cat([torch.zeros((Dz,), device=dev),
                    torch.ones((K,), device=dev)])
    v = rbm_ops.sampled_conditional_chain(joint, rng.fold_in(key, 0),
                                          v_known, km, n_steps=steps,
                                          groups=groups)
    z_sample = v[:, :Dz]
    z_dec = z_sample
    if z_affine is not None:
        scale, bias = z_affine
        z_dec = (z_dec - bias) / (scale + 1e-6)
    return dbn_train.dbn_decode_sampled(idbn_states, z_dec,
                                        rng.fold_in(key, 1)), z_sample
