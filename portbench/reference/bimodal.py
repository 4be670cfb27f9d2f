"""Reference of the bimodal iMDBN's joint DBN training epoch.

The joint is a stack of RBMs over [z1 ⊕ z2] (the top latents of the two
modality stacks), with no softmax group. A warm-up batch runs twice the
pair of clamped CD-3 updates of layer 0 (mod1 known, then mod2 known,
the negative chain re-clamped); a main batch runs sampled CD-k down the
stack (layer i + 1 fed the hidden probabilities of the updated layer i),
then the two clamped updates without re-clamping. A clamped update
starts its positive state from 30 steps of noisy mean-field annealing
and takes a third of the learning rate. Every batch then reconstructs
each modality from the other (50 sampled conditional Gibbs steps through
layer 0, decoded through the target modality's stack) and sums the
squared errors. Batch b of an epoch keyed ``key`` is keyed
``fold_in(fold_in(key, 0), b)``, the remainder ``fold_in(key, 1)``."""

from __future__ import annotations

from typing import List, Tuple

import torch

from portbench.reference import joint as ref_joint
from portbench.reference import keys
from portbench.reference.rbm import (Arith, State, apply_update,
                                     hidden_probs, visible_probs)


def uniforms(key_list, rows: int, cols: int, device) -> torch.Tensor:
    """The plain code's uniforms of each key, [n, rows, cols]."""
    return keys.uniform_stack(key_list, rows, cols,
                              stream=keys.STREAM_UNIFORM, device=device)


def cd_update(ar: Arith, st: State, key: int, data, *, lr, mom, wd, cd,
              Dz: int = None, K: int = 0):
    """Sampled CD-k through plain products: h0 sampled from the data's
    probabilities, then per step v sampled (columns ``Dz .. Dz + K`` a
    softmax group drawn as one category) and h sampled."""
    data = ar.rows(data)
    (V, H), B, dev = st["w"].shape, data.shape[0], data.device
    Dz = V if Dz is None else Dz
    k_pos, k_neg = keys.fold_in(key, 0), keys.fold_in(key, 1)
    ks = [keys.fold_in(k_neg, s) for s in range(cd)]
    kv = [keys.fold_in(k, 0) for k in ks]
    uh = uniforms([k_pos] + [keys.fold_in(k, 1) for k in ks], B, H, dev)
    uv = uniforms(kv, B, V, dev)
    ug = uniforms([keys.fold_in(k, 1) for k in kv], B, K, dev) if K \
        else None
    pos_h = hidden_probs(ar, st, data)
    h = (pos_h > uh[0]).float()
    for s in range(cd):
        v_prob = ref_joint.joint_visible(ar, st, h, Dz, K)
        v = (v_prob > uv[s]).float()
        if K:
            v[:, Dz:Dz + K] = ref_joint.categorical(v_prob[:, Dz:Dz + K],
                                                    ug[s])
        h_prob = hidden_probs(ar, st, v)
        h = (h_prob > uh[s + 1]).float()
    new = apply_update(st, ar.mm(data.T, pos_h), ar.mm(v.T, h_prob),
                       pos_h.sum(0), h_prob.sum(0), data.sum(0), v.sum(0),
                       lr=lr, mom=mom, wd=wd, bsz=data.shape[0])
    return ar.updated(st, new), torch.mean(torch.square(data - v_prob))


def clamped_update(ar: Arith, st: State, key: int, v_known, km, *, lr,
                   mom, wd, cd: int, init_steps: int, reclamp: bool,
                   sample_h: bool = True, Dz: int = None, K: int = 0):
    """Auxiliary clamped CD: the positive state from noisy mean-field
    annealing of the unknown block, ``cd`` steps of h (sampled with
    ``sample_h``) and v probabilities from it, a third of the learning
    rate."""
    v_known, km = ar.rows(v_known), ar.rows(km)
    V = v_known.shape[1]
    Dz = V if Dz is None else Dz
    k_init, k_neg = keys.fold_in(key, 0), keys.fold_in(key, 1)
    v = ref_joint.chain_init(keys.fold_in(k_init, 0), v_known, km)
    sched = ref_joint.annealed_schedule(init_steps, 3.0, 1.0, 0.9, 2, 0.9,
                                        0.15)
    v_plus = ref_joint.clamped_chain(ar, st, v, v_known, km, sched, Dz, K,
                                     seed=keys.fold_in(k_init, 1))
    h_plus = hidden_probs(ar, st, v_plus)
    v_neg = v_plus
    if sample_h:
        uh = uniforms([keys.fold_in(keys.fold_in(k_neg, t), 0)
                       for t in range(cd)], v_known.shape[0],
                      st["w"].shape[1], v_known.device)
    for t in range(cd):
        h = hidden_probs(ar, st, v_neg)
        if sample_h:
            h = (h > uh[t]).float()
        v_neg = ref_joint.joint_visible(ar, st, h, Dz, K)
        if reclamp:
            v_neg = v_neg * (1.0 - km) + v_known * km
    h_neg = hidden_probs(ar, st, v_neg)
    return ar.updated(st, apply_update(
        st, ar.mm(v_plus.T, h_plus), ar.mm(v_neg.T, h_neg), h_plus.sum(0),
        h_neg.sum(0), v_plus.sum(0), v_neg.sum(0), lr=0.3 * lr, mom=mom,
        wd=wd, bsz=v_known.shape[0]))


def cross_sampled(ar: Arith, st: State, key: int, v_known, km, steps: int):
    """Conditional Gibbs with h sampled and v probabilities, the known
    coordinates re-clamped each step, then one mean-field pass that is
    not re-clamped."""
    v = ref_joint.chain_init(keys.fold_in(key, 0), v_known, km)
    kloop = keys.fold_in(key, 1)
    uh = uniforms([keys.fold_in(keys.fold_in(kloop, t), 0)
                   for t in range(steps)], v.shape[0], st["w"].shape[1],
                  v.device)
    for t in range(steps):
        h = (hidden_probs(ar, st, v) > uh[t]).float()
        v = visible_probs(ar, st, h) * (1.0 - km) + v_known * km
    return visible_probs(ar, st, hidden_probs(ar, st, v))


def batch_step(ar: Arith, joint: List[State], mod1: List[State],
               mod2: List[State], key: int, z1, z2, v1, v2, *, lr, mom, wd,
               warmup: bool, joint_cd: int, init_steps: int, steps: int
               ) -> Tuple[List[State], float, Tuple[float, float, float]]:
    """One batch; returns (joint, layer-0 CD loss (0 in the warm-up),
    (rows, mod1 squared-error sum, mod2 squared-error sum))."""
    B, Dz1 = z1.shape
    dev = z1.device
    km1 = torch.cat([torch.ones((B, Dz1), device=dev),
                     torch.zeros((B, z2.shape[1]), device=dev)], 1)
    vk1 = torch.cat([z1, torch.zeros_like(z2)], 1)
    vk2 = torch.cat([torch.zeros_like(z1), z2], 1)
    ks = [keys.fold_in(key, i) for i in range(8)]
    joint = list(joint)
    aux = dict(lr=lr, mom=mom, wd=wd, cd=3, init_steps=init_steps)
    loss = 0.0
    if warmup:
        for i in range(2):
            joint[0] = clamped_update(ar, joint[0], ks[2 * i], vk1, km1,
                                      reclamp=True, **aux)
            joint[0] = clamped_update(ar, joint[0], ks[2 * i + 1], vk2,
                                      1.0 - km1, reclamp=True, **aux)
    else:
        cur = torch.cat([z1, z2], 1)
        for li in range(len(joint)):
            joint[li], l = cd_update(ar, joint[li], keys.fold_in(ks[4], li),
                                     cur, lr=lr, mom=mom, wd=wd, cd=joint_cd)
            if li == 0:
                loss = float(l)
            cur = hidden_probs(ar, joint[li], cur)
        joint[0] = clamped_update(ar, joint[0], ks[5], vk1, km1,
                                  reclamp=False, **aux)
        joint[0] = clamped_update(ar, joint[0], ks[6], vk2, 1.0 - km1,
                                  reclamp=False, **aux)
    v = cross_sampled(ar, joint[0], keys.fold_in(ks[7], 0), vk1, km1, steps)
    rec2 = ref_joint.decode(ar, mod2, v[:, Dz1:])
    v = cross_sampled(ar, joint[0], keys.fold_in(ks[7], 1), vk2, 1.0 - km1,
                      steps)
    rec1 = ref_joint.decode(ar, mod1, v[:, :Dz1])
    return joint, loss, (float(B), float(((rec1 - v1) ** 2).sum()),
                         float(((rec2 - v2) ** 2).sum()))


def epoch(ar: Arith, joint, mod1, mod2, Z1, Z2, V1, V2, epoch_key: int, *,
          batch: int, **kw):
    """One joint epoch; returns (joint, CD-loss sum, metric sums)."""
    n = Z1.shape[0]
    perm = keys.permutation(epoch_key, n).to(Z1.device)
    Z1, Z2, V1, V2 = (a.index_select(0, perm) for a in (Z1, Z2, V1, V2))
    nb = n // batch
    bkey = keys.fold_in(epoch_key, 0)
    loss_sum, sums = 0.0, [0.0, 0.0, 0.0]
    spans = [(keys.fold_in(bkey, b), slice(b * batch, (b + 1) * batch))
             for b in range(nb)]
    if n > nb * batch:
        spans.append((keys.fold_in(epoch_key, 1), slice(nb * batch, n)))
    for k, sl in spans:
        joint, loss, m = batch_step(ar, joint, mod1, mod2, k, Z1[sl],
                                    Z2[sl], V1[sl], V2[sl], **kw)
        loss_sum += loss
        sums = [a + b for a, b in zip(sums, m)]
    return joint, loss_sum, sums
