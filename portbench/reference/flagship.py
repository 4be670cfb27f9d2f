"""Reference of the flagship iMDBN's joint RBM training epoch.

The joint's visible layer is [z ⊕ y], y a softmax group of K labels, z
the image stack's top latents (the stack frozen). A warm-up batch runs
two y-clamped updates (the negative chain re-clamped); a main batch runs
sampled CD-k, a y-clamped update without re-clamping and, on batch 0 of
every ``zclamp_every``, a z-clamped one. A clamped update starts from 30
steps of noisy mean-field annealing, runs one mean-field negative step
and takes a third of the learning rate. Every batch then runs the
cross-modal round trip (labels from z by the mean-field chain, z from
the labels by noisy annealing pulled to the class means, decoded through
the image stack) and sums its metrics. Batch b of an epoch keyed ``key``
is keyed ``fold_in(key, b)``, the remainder ``fold_in(key, 991)``."""

from __future__ import annotations

from typing import List, Tuple

import torch

from portbench.reference import joint as ref_joint
from portbench.reference import keys
from portbench.reference.bimodal import cd_update, clamped_update
from portbench.reference.rbm import Arith, State

REMAINDER_TAG = 991
ZCLAMP_EVERY = 50


def metric_sums(img_from_txt, p_y, img, y) -> List[float]:
    """(rows, top-1 hits, top-3 hits, cross-entropy, image squared
    error) of one batch."""
    gt = y.argmax(1)
    top3 = (torch.topk(p_y, min(3, p_y.shape[1]), dim=1).indices
            == gt[:, None]).any(1)
    p = torch.clamp(p_y, 1e-6, 1 - 1e-6)
    t = torch.nn.functional.one_hot(gt, p_y.shape[1]).float()
    ce = -(t * torch.log(p) + (1 - t) * torch.log1p(-p)).sum()
    return [float(img.shape[0]), float((p_y.argmax(1) == gt).sum()),
            float(top3.sum()), float(ce),
            float(((img_from_txt - img) ** 2).sum())]


def batch_step(ar: Arith, joint: State, image: List[State], key: int, z, y,
               img, b_idx: int, z_class_mean, *, lr, mom, wd, warmup: bool,
               joint_cd: int, init_steps: int, steps: int
               ) -> Tuple[State, float, List[float]]:
    B, K = y.shape
    Dz = z.shape[1]
    dev = z.device
    km_y = torch.cat([torch.zeros((B, Dz), device=dev),
                      torch.ones((B, K), device=dev)], 1)
    vk_y = torch.cat([torch.zeros((B, Dz), device=dev), y], 1)
    ks = [keys.fold_in(key, i) for i in range(4)]
    aux = dict(lr=lr, mom=mom, wd=wd, cd=1, init_steps=init_steps,
               sample_h=False, Dz=Dz, K=K)
    loss = 0.0
    if warmup:
        for i in range(2):
            joint = clamped_update(ar, joint, ks[i], vk_y, km_y,
                                   reclamp=True, **aux)
    else:
        joint, l = cd_update(ar, joint, ks[0], torch.cat([z, y], 1), lr=lr,
                             mom=mom, wd=wd, cd=joint_cd, Dz=Dz, K=K)
        loss = float(l)
        joint = clamped_update(ar, joint, ks[1], vk_y, km_y, reclamp=False,
                               **aux)
        if b_idx % ZCLAMP_EVERY == 0:
            vk_z = torch.cat([z, torch.zeros((B, K), device=dev)], 1)
            joint = clamped_update(ar, joint, ks[2], vk_z, 1.0 - km_y,
                                   reclamp=False, **aux)
    kw = dict(Dz=Dz, K=K, steps=steps)
    p_y = ref_joint.z2txt(ar, joint, z, ks[3], **kw)
    img_from_txt = ref_joint.txt2img(ar, image, joint, y, z_class_mean,
                                     ks[3], **kw)
    return joint, loss, metric_sums(img_from_txt, p_y, img, y)


def epoch(ar: Arith, joint: State, image: List[State], Z, Y, X,
          z_class_mean, epoch_key: int, *, batch: int, **kw):
    """One joint epoch; returns (joint, the free-CD losses, one per
    batch as the model reports them (none in the warm-up), the metric
    sums)."""
    n = Z.shape[0]
    perm = keys.permutation(epoch_key, n).to(Z.device)
    Z, Y, X = (a.index_select(0, perm) for a in (Z, Y, X))
    nb = n // batch
    losses, full, sums = [], [], [0.0] * 5
    spans = [(keys.fold_in(epoch_key, b), b, slice(b * batch, (b + 1) *
                                                   batch))
             for b in range(nb)]
    if n > nb * batch:
        spans.append((keys.fold_in(epoch_key, REMAINDER_TAG), nb,
                      slice(nb * batch, n)))
    for k, b, sl in spans:
        joint, loss, m = batch_step(ar, joint, image, k, Z[sl], Y[sl],
                                    X[sl], b, z_class_mean, **kw)
        (full if b < nb else losses).append(loss)
        sums = [a + c for a, c in zip(sums, m)]
    if not kw["warmup"]:
        # the model reports the full batches' mean once for each of them
        mean = sum(full) / max(1, len(full))
        losses = [mean] * len(full) + losses
    else:
        losses = []
    return joint, losses, sums
