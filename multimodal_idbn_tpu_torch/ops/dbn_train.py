"""iDBN training epochs and the DBN encode/decode passes.

Port of multimodal_idbn_tpu/ops/dbn_train.py:31-139 (``idbn_epoch``),
:235-330 (``idbn_epoch_pcd``; the per-epoch body of
``idbn_epoch_block_pcd`` is the model's epoch loop, as for
``idbn_epoch_block``), :366-385 (``idbn_batch_step``) and :388-434
(``dbn_represent``, ``dbn_decode``, ``dbn_decode_sampled``,
``dbn_reconstruct``). The JAX epoch is one ``lax.scan``; here it is a
Python loop over static batch slices of already-permuted data
(``shuffle=False``), with the same iterative schedule: every layer updates
on every batch, and layer i+1 is fed the post-update ``hidden_probs`` of
layer i (dbn_train.py:117-136), taken on ``compute_cast(state,
compute_dtype)``. Keys: batch b, layer i gets
``fold_in(fold_in(key, b), i)``. ``idbn_epoch_block`` runs epochs one
after another with the permutation and remainder batch of the model's
epoch (the body of JAX's nested scan, :139-232).

With a ``mesh`` (``parallel.make_mesh``) each process trains its rows of
every full batch inside ``shard.rows_of`` and every update sums over the
mesh (``ops.shard``), so the replicas stay equal; the remainder batch runs
whole on every process, as JAX's models run it (models/idbn.py:265-269).

The route of a layer update is the caller's ``fast_sampler`` flag, which
the model sets from its config before any launch (JAX
models/idbn.py:164-180), False by default as in JAX (dbn_train.py:71,
:151): ``True`` (fp32 storage, no mixed precision) runs
``fast_cd`` (the fused half-step kernel on the card), ``False`` runs
``rbm_ops.cd_update`` / ``pcd_update`` in plain torch, the route of bf16
storage and of ``compute_dtype``. ``sr`` is the stochastic-rounding
override of ``rbm_ops.cd_update``.

``visible`` names the unit type of layer 0's visible units
(``fast_cd.VISIBLE_TYPES``): "bernoulli", every shipped stack; "gaussian"
or "replicated_softmax" train layer 0 by ``fast_cd``'s update of that
type, on one device and in fp32 CD only (any other route raises
``NotImplementedError``). ``visible_lr_scale`` scales layer 0's learning
rate (a Gaussian visible layer learns at a rate orders of magnitude below
a Bernoulli one's). Layer 1 is fed layer 0's p(h|v)
(replicated softmax: ``fast_cd.rsm_hidden_probs``). ``dbn_represent`` and
``dbn_decode`` take the same type: the bottom layer decodes to the
Gaussian's mean or the word distribution ``softmax(b + h·Wᵀ)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from multimodal_idbn_tpu_torch.ops import fast_cd, graphs, rbm_ops, rng, shard
from multimodal_idbn_tpu_torch.ops.sampling import sample_bernoulli

States = List[rbm_ops.RBMState]
Chains = List[torch.Tensor]


def _layer_update(st, key, v, *, fast_sampler: bool, compute_dtype, sr,
                  visible: str = fast_cd.BERNOULLI, **kw):
    """One groupless CD update through the route ``fast_sampler`` names
    (dbn_train.py:31-52), of a layer whose visible units are of type
    ``visible``."""
    if visible != fast_cd.BERNOULLI:
        check_visible_route(visible, fast_sampler=fast_sampler)
        return fast_cd.visible_update(visible)(st, key, v, **kw)
    if fast_sampler:
        return fast_cd.fast_sampled_cd_update(st, key, v, **kw)
    return rbm_ops.cd_update(st, key, v, compute_dtype=compute_dtype,
                             sr=sr, **kw)


def check_visible_route(visible: str, *, fast_sampler: bool = True,
                        pcd: bool = False, mesh=None, groups=()) -> None:
    """Raise ``NotImplementedError`` for a route a visible layer of type
    ``visible`` cannot take: the plain torch route (bf16 storage, mixed
    precision), persistent CD, a mesh and softmax groups. Bernoulli takes
    them all."""
    if fast_cd.check_visible(visible) == fast_cd.BERNOULLI:
        return
    why = ("bf16 storage or mixed precision (the plain torch route)"
           if not fast_sampler else "persistent CD" if pcd
           else "a data-parallel mesh" if mesh is not None
           else "softmax groups" if groups else None)
    if why is not None:
        raise NotImplementedError(f"{visible} visible units train by fp32 "
                                  f"CD on one device; {why} is not "
                                  f"supported")


def _hidden_probs(st, v, visible: str, compute_dtype):
    """p(h|v) of an updated layer whose visible units are of type
    ``visible``, fed to the layer above."""
    if visible == fast_cd.REPLICATED_SOFTMAX:
        return fast_cd.rsm_hidden_probs(st, v)
    return rbm_ops.hidden_probs(rbm_ops.compute_cast(st, compute_dtype), v)


def _layer_pcd(st, chain, key, v, *, fast_sampler: bool, compute_dtype,
               sr, **kw):
    """One groupless persistent-CD update through the route
    ``fast_sampler`` names."""
    if fast_sampler:
        return fast_cd.fast_sampled_pcd_update(st, chain, key, v, **kw)
    return rbm_ops.pcd_update(st, chain, key, v, compute_dtype=compute_dtype,
                              sr=sr, **kw)


def idbn_batch_step(states: Sequence[rbm_ops.RBMState], key: int,
                    batch: torch.Tensor, lr, mom, weight_decay,
                    sparsity_factor, *, cd: int,
                    sparsity_flags: Sequence[bool],
                    compute_dtype: Optional[torch.dtype] = None,
                    sr: Optional[bool] = None, fast_sampler: bool = False,
                    **visible_kw) -> Tuple[States, torch.Tensor]:
    """All-layers CD update on one batch, as JAX jits it
    (dbn_train.py:364-385): on a CUDA device one graph replay
    (``graphs.serve``, the graphs of ``graphs.SHARED``; lr and momentum
    read from ``graphs.hyper``), launch by launch elsewhere. Returns
    (states, losses[L]). The epochs run its body, ``_idbn_batch_step``.
    ``visible_kw``: ``visible`` and ``visible_lr_scale`` of layer 0
    (module docstring)."""
    dev = batch.device
    return graphs.serve(
        graphs.SHARED, dev, _idbn_step_at, key, states, batch,
        graphs.hyper(dev, lr, mom), weight_decay, sparsity_factor, cd=cd,
        sparsity_flags=tuple(sparsity_flags), compute_dtype=compute_dtype,
        sr=sr, fast_sampler=fast_sampler, **visible_kw)


def _idbn_step_at(states, batch, hyper, weight_decay, sparsity_factor, *,
                  key, **statics):
    return _idbn_batch_step(states, key, batch, hyper[0], hyper[1],
                            weight_decay, sparsity_factor, **statics)


def _idbn_batch_step(states: Sequence[rbm_ops.RBMState], key,
                     batch: torch.Tensor, lr, mom, weight_decay,
                     sparsity_factor, *, cd: int,
                     sparsity_flags: Sequence[bool],
                     compute_dtype: Optional[torch.dtype] = None,
                     sr: Optional[bool] = None, fast_sampler: bool = False,
                     visible: str = fast_cd.BERNOULLI,
                     visible_lr_scale: float = 1.0
                     ) -> Tuple[States, torch.Tensor]:
    """All-layers CD update on one batch (dbn_train.py:366-385); returns
    (states, losses[L])."""
    v = batch.to(compute_dtype or states[0].w.dtype)
    new_states, losses = [], []
    for i, st in enumerate(states):
        kind = visible if i == 0 else fast_cd.BERNOULLI
        st, loss = _layer_update(
            st, rng.fold_in(key, i), v, fast_sampler=fast_sampler,
            compute_dtype=compute_dtype, sr=sr, visible=kind,
            lr=lr * visible_lr_scale if i == 0 and visible_lr_scale != 1.0
            else lr, mom=mom, weight_decay=weight_decay, cd=cd,
            sparsity=sparsity_flags[i], sparsity_factor=sparsity_factor)
        v = _hidden_probs(st, v, kind, compute_dtype)
        new_states.append(st)
        losses.append(loss)
    return new_states, torch.stack(losses)


def idbn_epoch(states: Sequence[rbm_ops.RBMState], key: int,
               data: torch.Tensor, lr, mom, weight_decay, sparsity_factor, *,
               cd: int, sparsity_flags: Sequence[bool], batch_size: int,
               compute_dtype: Optional[torch.dtype] = None,
               sr: Optional[bool] = None, fast_sampler: bool = False,
               shuffle: bool = False, mesh=None, **visible_kw
               ) -> Tuple[States, torch.Tensor]:
    """One iDBN epoch over the ``n // batch_size`` full batches of ``data``
    in order (first permuted by ``rng.permutation(key, n)`` with
    ``shuffle``); returns (states, losses[nb, L]). Rows beyond
    ``nb * batch_size`` are left to the caller (dbn_train.py:82-90). With
    a ``mesh``, this process's rows of each batch (module docstring).
    ``visible_kw``: layer 0's ``visible`` and ``visible_lr_scale``."""
    check_visible_route(visible_kw.get("visible", fast_cd.BERNOULLI),
                        fast_sampler=fast_sampler, mesh=mesh)
    if shuffle:
        data = data[rng.permutation(key, data.shape[0]).to(data.device)]
    nb = data.shape[0] // batch_size
    states = list(states)
    losses = []
    for b in range(nb):
        batch = data[b * batch_size:(b + 1) * batch_size]
        with shard.rows_of(mesh, batch_size) as rows:
            states, lb = _idbn_batch_step(
                states, rng.fold_in(key, b), batch[rows], lr=lr, mom=mom,
                weight_decay=weight_decay, sparsity_factor=sparsity_factor,
                cd=cd, sparsity_flags=sparsity_flags,
                compute_dtype=compute_dtype, sr=sr,
                fast_sampler=fast_sampler, **visible_kw)
        losses.append(lb)
    if not losses:
        return states, torch.zeros((0, len(states)), device=data.device)
    return states, torch.stack(losses)


def idbn_epoch_body(consts, state, perm, lr, mom, *, batch_size: int,
                    pcd: bool = False, mesh=None, **kw):
    """One epoch of the image iDBN from device buffers (``ops.graphs``):
    ``consts`` is (data,), ``state`` {"states": the layers, "chains": the
    fantasy particles or None}. The data permuted by ``perm``, its full
    batches (``idbn_epoch`` over ``mesh``, or ``idbn_epoch_pcd`` under
    ``pcd``), then the remainder batch by CD, keyed ``fold_in(key, 987)``
    and run whole on every process, so every sample trains once an epoch.
    Returns (state, (loss sum over the (batch, layer) entries,))."""
    (data,) = consts
    n = data.shape[0]
    key = rng.Key()
    data_p = data.index_select(0, perm)
    kw = dict(kw, lr=lr, mom=mom)
    chains = state["chains"]
    if pcd:
        states, chains, losses = idbn_epoch_pcd(
            state["states"], chains, key, data_p, batch_size=batch_size,
            **kw)
    else:
        states, losses = idbn_epoch(state["states"], key, data_p,
                                    batch_size=batch_size, mesh=mesh, **kw)
    loss_sum = losses.sum()
    rem = n - (n // batch_size) * batch_size
    if rem:
        states, rl = _idbn_batch_step(states, rng.fold_in(key, 987),
                                     data_p[n - rem:], **kw)
        loss_sum = loss_sum + rl.sum()
    return dict(states=states, chains=chains), (loss_sum,)


def idbn_epoch_runner(data: torch.Tensor, *, weight_decay, sparsity_factor,
                      cd: int, sparsity_flags: Sequence[bool],
                      batch_size: int,
                      compute_dtype: Optional[torch.dtype] = None,
                      sr: Optional[bool] = None, fast_sampler: bool = True,
                      pcd: bool = False, mesh=None, graphed: bool = False,
                      **visible_kw) -> graphs.EpochRunner:
    """The runner of ``idbn_epoch_body`` over ``data`` at one setting;
    ``graphed`` replays it as a CUDA graph (no ``mesh``). ``visible_kw``:
    layer 0's ``visible`` and ``visible_lr_scale``, where given."""
    if graphed and mesh is not None:
        raise ValueError("a data-parallel epoch runs launch by launch")
    check_visible_route(visible_kw.get("visible", fast_cd.BERNOULLI),
                        fast_sampler=fast_sampler, pcd=pcd, mesh=mesh)
    return graphs.EpochRunner(
        "idbn_epoch_pcd" if pcd else "idbn_epoch", idbn_epoch_body, (data,),
        dict(batch_size=int(batch_size), pcd=bool(pcd), mesh=mesh,
             weight_decay=weight_decay, sparsity_factor=sparsity_factor,
             cd=int(cd), sparsity_flags=tuple(bool(f)
                                              for f in sparsity_flags),
             compute_dtype=compute_dtype, sr=sr,
             fast_sampler=bool(fast_sampler), **visible_kw),
        n_rows=data.shape[0], device=data.device, graphed=graphed)


def _loss_entries(n: int, batch_size: int, layers: int) -> int:
    """(batch, layer) entries of an epoch: full batches and remainder."""
    return -(-n // batch_size) * layers


def idbn_epoch_block(states: Sequence[rbm_ops.RBMState], epoch_key: int,
                     data: torch.Tensor, epoch_idx: Sequence[int], lr_arr,
                     mom_arr, weight_decay, sparsity_factor, *, cd: int,
                     sparsity_flags: Sequence[bool], batch_size: int,
                     n_epochs: Optional[int] = None,
                     compute_dtype: Optional[torch.dtype] = None,
                     sr: Optional[bool] = None, fast_sampler: bool = False,
                     mesh=None, runner: Optional[graphs.EpochRunner] = None,
                     **visible_kw):
    """The epochs ``epoch_idx`` of the image iDBN, with learning rates
    ``lr_arr`` and momenta ``mom_arr``: epoch e is ``idbn_epoch_body``
    under the key ``fold_in(epoch_key, e)`` (its permutation
    ``rng.permutation`` of that key), launch by launch, or through
    ``runner`` (an ``idbn_epoch_runner`` over ``data`` at this setting,
    which may be graphed). Returns (states, loss sums[E], loss counts[E])
    over the (batch, layer) entries."""
    if n_epochs is not None and int(n_epochs) != len(epoch_idx):
        raise ValueError(f"n_epochs {n_epochs} but {len(epoch_idx)} "
                         f"epoch indices")
    run = runner or idbn_epoch_runner(
        data, weight_decay=weight_decay, sparsity_factor=sparsity_factor,
        cd=cd, sparsity_flags=sparsity_flags, batch_size=batch_size,
        compute_dtype=compute_dtype, sr=sr, fast_sampler=fast_sampler,
        mesh=mesh, **visible_kw)
    count = _loss_entries(data.shape[0], batch_size, len(states))
    state = dict(states=list(states), chains=None)
    sums, counts = [], []
    for e, lr, mom in zip(epoch_idx, lr_arr, mom_arr):
        state, (loss_sum,) = run(state, rng.fold_in(epoch_key, int(e)),
                                 lr, mom,
                                 next_key=rng.fold_in(epoch_key, int(e) + 1))
        sums.append(loss_sum)
        counts.append(count)
    return state["states"], sums, counts


def idbn_epoch_block_pcd(states: Sequence[rbm_ops.RBMState],
                         chains: Sequence[torch.Tensor], epoch_key: int,
                         data: torch.Tensor, epoch_idx: Sequence[int],
                         lr_arr, mom_arr, weight_decay, sparsity_factor, *,
                         cd: int, sparsity_flags: Sequence[bool],
                         batch_size: int, n_epochs: Optional[int] = None,
                         compute_dtype: Optional[torch.dtype] = None,
                         sr: Optional[bool] = None,
                         fast_sampler: bool = True,
                         runner: Optional[graphs.EpochRunner] = None):
    """Persistent-CD epochs (dbn_train.py:285-330): as
    ``idbn_epoch_block``, the fantasy particles carried across epochs and
    the remainder rows trained by plain CD. Returns (states, chains, loss
    sums[E], loss counts[E])."""
    if n_epochs is not None and int(n_epochs) != len(epoch_idx):
        raise ValueError(f"n_epochs {n_epochs} but {len(epoch_idx)} "
                         f"epoch indices")
    run = runner or idbn_epoch_runner(
        data, weight_decay=weight_decay, sparsity_factor=sparsity_factor,
        cd=cd, sparsity_flags=sparsity_flags, batch_size=batch_size,
        compute_dtype=compute_dtype, sr=sr, fast_sampler=fast_sampler,
        pcd=True)
    count = _loss_entries(data.shape[0], batch_size, len(states))
    state = dict(states=list(states), chains=list(chains))
    sums, counts = [], []
    for e, lr, mom in zip(epoch_idx, lr_arr, mom_arr):
        state, (loss_sum,) = run(state, rng.fold_in(epoch_key, int(e)),
                                 lr, mom,
                                 next_key=rng.fold_in(epoch_key, int(e) + 1))
        sums.append(loss_sum)
        counts.append(count)
    return state["states"], state["chains"], sums, counts


def idbn_epoch_pcd(states: Sequence[rbm_ops.RBMState],
                   chains: Sequence[torch.Tensor], key: int,
                   data: torch.Tensor, lr, mom, weight_decay,
                   sparsity_factor, *, cd: int,
                   sparsity_flags: Sequence[bool],
                   batch_size: int,
                   compute_dtype: Optional[torch.dtype] = None,
                   sr: Optional[bool] = None, fast_sampler: bool = True,
                   shuffle: bool = False
                   ) -> Tuple[States, Chains, torch.Tensor]:
    """Persistent-CD epoch over the full batches of ``data``
    (dbn_train.py:235-282): like ``idbn_epoch``, but each layer carries
    its fantasy particles [batch_size, V_i] from batch to batch. Returns
    (states, chains, losses[nb, L]). The caller keeps the chains across
    epochs and trains the remainder rows with plain CD
    (``idbn_batch_step``), as ``idbn_epoch_block_pcd`` does (:317-327):
    the particles are pinned to ``batch_size`` rows. ``shuffle`` permutes
    the rows by ``rng.permutation(key, n)`` first."""
    if shuffle:
        data = data[rng.permutation(key, data.shape[0]).to(data.device)]
    nb = data.shape[0] // batch_size
    states, chains = list(states), list(chains)
    losses = []
    for b in range(nb):
        bkey = rng.fold_in(key, b)
        v = data[b * batch_size:(b + 1) * batch_size].to(
            compute_dtype or states[0].w.dtype)
        lb = []
        for i in range(len(states)):
            states[i], chains[i], loss = _layer_pcd(
                states[i], chains[i], rng.fold_in(bkey, i), v,
                fast_sampler=fast_sampler, compute_dtype=compute_dtype,
                sr=sr, lr=lr, mom=mom, weight_decay=weight_decay, cd=cd,
                sparsity=sparsity_flags[i], sparsity_factor=sparsity_factor)
            v = rbm_ops.hidden_probs(
                rbm_ops.compute_cast(states[i], compute_dtype), v)
            lb.append(loss)
        losses.append(torch.stack(lb))
    if not losses:
        return states, chains, torch.zeros((0, len(states)),
                                           device=data.device)
    return states, chains, torch.stack(losses)


def dbn_represent(states: Sequence[rbm_ops.RBMState], v: torch.Tensor,
                  upto: int, visible: str = fast_cd.BERNOULLI
                  ) -> torch.Tensor:
    """Mean-field encode through the first ``upto`` layers
    (dbn_train.py:388-394); layer 0 by its ``visible`` type."""
    for i, st in enumerate(states[:upto]):
        v = _hidden_probs(st, v, visible if i == 0 else fast_cd.BERNOULLI,
                          None)
    return v


def dbn_decode(states: Sequence[rbm_ops.RBMState],
               top: torch.Tensor, visible: str = fast_cd.BERNOULLI
               ) -> torch.Tensor:
    """Decode top activations back to input space (dbn_train.py:397-404):
    the bottom layer's probabilities, or by its ``visible`` type the
    Gaussian's mean or the word distribution ``softmax(b + h·Wᵀ)``."""
    states = list(states)
    cur = top
    for i, st in enumerate(reversed(states)):
        if i == len(states) - 1 and visible != fast_cd.BERNOULLI:
            cur = rbm_ops.visible_logits(st, cur)
            if fast_cd.check_visible(visible) == \
                    fast_cd.REPLICATED_SOFTMAX:
                cur = torch.softmax(cur, dim=1)
        else:
            cur = rbm_ops.visible_probs(st, cur)
    return cur


def dbn_decode_sampled(states: Sequence[rbm_ops.RBMState],
                       top: torch.Tensor, key: int,
                       visible: str = fast_cd.BERNOULLI) -> torch.Tensor:
    """Ancestral-sampled decode (dbn_train.py:407-424): every layer above
    the bottom is Bernoulli-sampled on the way down (layer i from the top
    with ``fold_in(key, i)``); the bottom layer's probabilities are
    returned. Bernoulli visible units only: a replicated-softmax layer's
    words are unknown when its text is generated."""
    if fast_cd.check_visible(visible) != fast_cd.BERNOULLI:
        raise NotImplementedError(
            f"sampled decoding to {visible} visible units is not supported "
            f"(the number of words of generated text is unknown); use the "
            f"deterministic decode")
    states = list(states)
    cur = top
    for i, st in enumerate(reversed(states)):
        cur = rbm_ops.visible_probs(st, cur)
        if i < len(states) - 1:
            cur = sample_bernoulli(rng.fold_in(key, i), cur)
    return cur


def dbn_reconstruct(states: Sequence[rbm_ops.RBMState],
                    v: torch.Tensor, visible: str = fast_cd.BERNOULLI
                    ) -> torch.Tensor:
    """Encode through all layers, then decode back (dbn_train.py:427-434)."""
    return dbn_decode(states, dbn_represent(states, v, len(states), visible),
                      visible)
