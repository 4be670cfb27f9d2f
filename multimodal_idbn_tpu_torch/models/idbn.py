"""iDBN: iterative Deep Belief Network (stack of RBMs).

Port of multimodal_idbn_tpu/models/idbn.py:30-674: the constructor,
``train`` with crash-safe resume (``start_epoch``, ``checkpoint_every``,
``checkpoint_path``, :307-455), the collapse check and the retry rescue
(``reinit_layers``, ``_recon_collapse_ratio``, ``_warn_if_collapsed``,
``train_with_retry``, :457-565), ``represent`` / ``reconstruct`` /
``decode`` (:645-658), ``save_model`` and pickling (:660-674), and the
diagnostics hooks: the validation batch and ``features`` (:79-108), the
epoch timer and per-epoch logging to a run object (:351, :429-453,
``_log_epoch``, ``_layers_to_monitor``, ``_layer_tag``, :225-240,
:567-641) and the collapse warnings sent to the run (:502-503, :562-564).
Every layer is updated on every batch, layer i+1 fed the post-update
mean-field activations of layer i (``ops.dbn_train``), each update through
the fused half-step kernel on the card. The diagnostics draw nothing from
the training keys, so a run with a run object ends in the same
parameters as one without.

The params keys of the JAX model's variants are read as there
(:110-125): ``DTYPE`` (bf16 storage), ``COMPUTE_DTYPE`` (mixed
precision), ``SR`` (stochastic rounding) and ``PCD`` (persistent CD, its
fantasy particles kept across batches, epochs and ``train`` calls,
``_ensure_pcd_chains``, :208-223). The route of every layer update is
chosen from them before any launch (``_fast_sampler``, the counterpart of
:164-180): fp32 CD and fp32 PCD run the half-step kernel (``fast_cd``),
bf16 storage and mixed precision run ``rbm_ops.cd_update`` /
``pcd_update`` in plain torch, and the bf16 route says so once.

``train(fused=None)`` picks the epoch path by the loader (:307-345,
:425-445): one that offers ``materialize()`` trains epochs permuted by
(seed, epoch) on the device; any other is iterated batch by batch, every
layer through ``RBM.train_epoch`` (the half-step kernel for fp32), its
shuffle counter re-aligned on a resumed run (``align_loader_for_resume``).

How a fused epoch runs (``ops.graphs``): on a CUDA device without a mesh
each epoch is one replay of a CUDA graph of ``dbn_train.idbn_epoch_body``,
captured at the first epoch of each ``train`` call, CD and PCD, every
storage and precision setting alike, the counterpart of JAX's jitted,
scanned epoch. It runs launch by launch where the configuration asks for
it: the per-batch loop (``fused=False``, or a loader without
``materialize()``), which is the reference's altitude; a mesh, whose gloo
or NCCL collectives are not captured; and the CPU.
Data parallelism (``DP_DEVICES`` or ``set_mesh``, :126-130, :183-206):
the fused epochs run over ``parallel.make_mesh``'s process group, each
process on its rows of every batch (``dbn_train.idbn_epoch_block`` with
the mesh); it takes the default fp32 CD path and bf16 storage, not PCD,
``COMPUTE_DTYPE`` or the per-batch loop, as in JAX.

``visible`` names the unit type of layer 0's visible units: "bernoulli"
(the default, every shipped stack), "gaussian" (unit variance over
standardised real data) or "replicated_softmax" (word counts), the
multimodal DBN's image and text pathways (Srivastava & Salakhutdinov,
JMLR 15, 2014); ``visible_lr_scale`` scales layer 0's learning rate.
Layer 0 then trains by ``fast_cd``'s update of that type on the fused
epochs, in fp32 CD on one device (``dbn_train.check_visible_route``); the
per-batch loop, PCD, bf16 storage, mixed precision and a mesh raise
``NotImplementedError``.

``represent``, ``reconstruct`` and ``decode`` are JAX's jitted
``dbn_represent``, ``dbn_reconstruct`` and ``dbn_decode``
(ops/dbn_train.py:388-434): on a CUDA device each call is one replay of
a graph captured at its first call with that shape (``graphs.serve``,
which refreshes the graph's copy of the weights whenever they changed);
on the CPU they run launch by launch.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from multimodal_idbn_tpu_torch.checkpoint import (align_loader_for_resume,
                                                  checkpoint_epochs,
                                                  maybe_save_train_checkpoint,
                                                  save_train_checkpoint)
from multimodal_idbn_tpu_torch.device import (DeviceLike, as_tensor,
                                              resolve_device)
from multimodal_idbn_tpu_torch.models.rbm import (RBM, param_compute_dtype,
                                                  param_dtype, param_sr)
from multimodal_idbn_tpu_torch.ops import (dbn_train, fast_cd, graphs, rbm_ops,
                                           rng)
from multimodal_idbn_tpu_torch.ops.schedules import (effective_lr,
                                                     effective_momentum)
from multimodal_idbn_tpu_torch.utils.profiling import StepTimer, span


def val_features(val_loader, plain_dataset: bool = False) -> Optional[dict]:
    """The validation features the probes and the PCA read (cumulative
    area, convex hull, numeric labels and, where the dataset has them,
    densities) through the Subset metadata protocol, in the loader's
    order, or None for a loader without that metadata
    (JAX models/idbn.py:85-108). ``plain_dataset`` also reads a loader
    over the dataset itself (models/imdbn_bimodal.py:375-399)."""
    try:
        ds = val_loader.dataset
        if plain_dataset and not hasattr(ds, "indices"):
            base, indices = ds, range(len(ds))
        else:
            base, indices = ds.dataset, ds.indices
        feats = {
            "Cumulative Area": np.asarray(
                [base.cumArea_list[i] for i in indices], np.float32),
            "Convex Hull": np.asarray([base.CH_list[i] for i in indices],
                                      np.float32),
            "Labels": np.asarray([base.labels[i] for i in indices],
                                 np.float32),
        }
        density = getattr(base, "density_list", None)
        if density is not None:
            feats["Density"] = np.asarray([density[i] for i in indices],
                                          np.float32)
        return feats
    except (AttributeError, TypeError, IndexError, KeyError):
        return None


def feature_map(feats: dict) -> dict:
    """Probe feature names -> the figure names of the PCA panels."""
    return {dst: np.asarray(feats[src]) for src, dst in (
        ("cum_area", "Cumulative Area"), ("convex_hull", "Convex Hull"),
        ("labels", "Labels"), ("density", "Density")) if src in feats}


def load_logging_cfg(path: Optional[str]) -> dict:
    """The logging YAML at ``path`` (default
    ``configs/logging_config.yaml``), or {} where there is none
    (JAX models/idbn.py:53-67)."""
    from pathlib import Path
    import yaml
    cfg_path = Path(path) if path else Path("configs/logging_config.yaml")
    if not cfg_path.exists():
        return {}
    with cfg_path.open("r") as f:
        cfg = yaml.safe_load(f)
    return cfg if isinstance(cfg, dict) else {}


def check_train_args(start_epoch: int, epochs: int, checkpoint_every: int,
                     checkpoint_path) -> None:
    """The validation every resumable train loop shares
    (JAX models/idbn.py:336-342)."""
    if not 0 <= start_epoch <= epochs:
        raise ValueError(f"start_epoch {start_epoch} outside [0, {epochs}]")
    if checkpoint_every and not checkpoint_path:
        raise ValueError("checkpoint_every needs a checkpoint_path")


def _batch_step(states, v, hyper, *, key, layers):
    """Every layer's ``RBM.train_epoch`` on one batch, in order, each fed
    the post-update p(h|v) of the layer below (``RBM.forward``): layer
    i's update takes ``key[i]`` (drawn from its shell's stream),
    ``hyper[2i]`` / ``hyper[2i + 1]`` (lr, momentum) and ``layers[i]``.
    Returns (states, losses[L])."""
    new, losses = [], []
    for i, (st, kw) in enumerate(zip(states, layers)):
        st, loss = fast_cd.cd_update(st, key[i], v, lr=hyper[2 * i],
                                     mom=hyper[2 * i + 1], **kw)
        v = rbm_ops.hidden_probs(st, v)
        new.append(st)
        losses.append(loss)
    return new, torch.stack(losses)


class iDBN:
    """Stack of RBMs with iterative layer-wise training.

    ``dataloader`` yields (images, labels) batches and offers
    ``batch_size``; with ``materialize()`` (the whole split as arrays)
    ``train`` runs the fused epochs. ``params`` is the UPPERCASE dict of
    ``train_multimodal.build_params``. One validation batch is cached for
    the collapse check and the reconstruction snapshots
    (JAX models/idbn.py:79-83). ``wandb_run``: any object with
    ``.log(dict)``; when given, ``train`` logs the loss, timings, snapshots,
    PCA correlations and linear probes per epoch.
    """

    def __init__(self, layer_sizes: List[int], params: dict, dataloader,
                 val_loader=None, device: DeviceLike = None, wandb_run=None,
                 logging_config_path: Optional[str] = None,
                 seed: Optional[int] = None, visible: str = "bernoulli",
                 visible_lr_scale: float = 1.0):
        self.params = params
        self.visible = fast_cd.check_visible(visible)
        self.visible_lr_scale = float(visible_lr_scale)
        self.dataloader = dataloader
        self.val_loader = val_loader
        self.device = resolve_device(device)
        self.wandb_run = wandb_run
        self.logging_cfg = load_logging_cfg(logging_config_path)
        self.text_flag = False
        self.arch_str = "-".join(map(str, layer_sizes))
        self.arch_dir = os.path.join("logs-idbn",
                                     f"architecture_{self.arch_str}")
        self.cd_k = int(params.get("CD", 1))
        self.sparsity_last = bool(params.get("SPARSITY", False))
        self.sparsity_factor = float(params.get("SPARSITY_FACTOR", 0.1))
        self.val_batch = self.val_labels = None
        if val_loader is not None:
            self.val_batch, self.val_labels = next(iter(val_loader),
                                                   (None, None))[:2]
        self.features = val_features(val_loader)
        self._init_seed = seed
        # params["DP_DEVICES"] = N | "all": data parallelism, the mesh made
        # at train time (set_mesh)
        self.mesh = None
        self._dp_devices = params.get("DP_DEVICES")
        self.dtype = param_dtype(params)
        self.compute_dtype = param_compute_dtype(params)
        self.sr = param_sr(params)
        self.use_pcd = bool(params.get("PCD", False))
        self._pcd_chains = None
        self._route_said = False
        self.layers: List[RBM] = [
            RBM(num_visible=layer_sizes[i], num_hidden=layer_sizes[i + 1],
                learning_rate=params["LEARNING_RATE"],
                weight_decay=params["WEIGHT_PENALTY"],
                momentum=params["INIT_MOMENTUM"],
                dynamic_lr=params["LEARNING_RATE_DYNAMIC"],
                final_momentum=params["FINAL_MOMENTUM"],
                sparsity=self.sparsity_last and i == len(layer_sizes) - 2,
                sparsity_factor=self.sparsity_factor,
                seed=None if seed is None else seed + i,
                device=self.device, dtype=self.dtype, sr=self.sr)
            for i in range(len(layer_sizes) - 1)]
        self.loss_history: List[float] = []

    def states(self):
        return [r.state for r in self.layers]

    def _set_states(self, states) -> None:
        for r, s in zip(self.layers, states):
            r.state = s

    def to(self, device: DeviceLike = None) -> "iDBN":
        """Move every layer to ``device`` (``cuda`` unless ``"cpu"``)."""
        self.device = resolve_device(device)
        for r in self.layers:
            r.to(self.device)
        if self._pcd_chains is not None:
            self._pcd_chains = [c.to(self.device) for c in self._pcd_chains]
        return self

    # -- training (JAX models/idbn.py:164-223, :244-455) ----------------------

    def _fast_sampler(self) -> bool:
        """The route of every layer update, chosen from the config before
        any launch (JAX models/idbn.py:164-180): True, the half-step
        kernel, for fp32 storage without mixed precision (CD and PCD
        alike); False, plain torch, for bf16 storage or ``COMPUTE_DTYPE``,
        since the kernel takes fp32 operands only and has no
        stochastic-rounding epilogue. A plain route is printed once."""
        if self.compute_dtype is not None:
            why = ("COMPUTE_DTYPE=bfloat16 (mixed precision: bf16 chain "
                   "operands)")
        elif any(r.state.w.dtype == torch.bfloat16 for r in self.layers):
            why = ("bfloat16 storage (fp32 operands only, no "
                   "stochastic-rounding epilogue)")
        else:
            return True
        if not self._route_said:
            print(f"[iDBN] half-step kernel disabled for {why}; using the "
                  f"plain torch CD path")
            self._route_said = True
        return False

    def set_mesh(self, mesh) -> None:
        """Train data-parallel over ``mesh``: a ``parallel.Mesh``, a
        device count, ``"all"``, or None to train on this device alone
        (JAX models/idbn.py:183-194). An explicit call, None included,
        overrides ``DP_DEVICES``."""
        from multimodal_idbn_tpu_torch.parallel import resolve_mesh
        self.mesh = resolve_mesh(mesh, self.device)
        self._dp_devices = None

    def _resolve_mesh(self):
        """The mesh, made from ``DP_DEVICES`` at first use; refuses PCD
        and ``COMPUTE_DTYPE`` under a mesh (JAX models/idbn.py:196-206)."""
        if self.mesh is None and self._dp_devices:
            self.set_mesh(self._dp_devices)
        if self.mesh is not None and (self.use_pcd
                                      or self.compute_dtype is not None):
            raise ValueError(
                "data-parallel training (DP_DEVICES/set_mesh) supports "
                "the default f32 CD path only — not PCD or COMPUTE_DTYPE")
        return self.mesh

    def _ensure_pcd_chains(self, batch_size: int):
        """Per-layer fantasy particles [batch_size, V_i] in the layer's
        storage dtype, created once from ``SEED + 12345`` and kept across
        ``train`` calls, PCD's defining property
        (JAX models/idbn.py:208-223)."""
        if (self._pcd_chains is None
                or self._pcd_chains[0].shape[0] != batch_size):
            ck = int(self.params.get("SEED", 0)) + 12345
            self._pcd_chains = [
                rbm_ops.init_pcd_chains(rng.fold_in(ck, i), batch_size,
                                        r.num_visible,
                                        dtype=r.state.w.dtype,
                                        device=self.device)
                for i, r in enumerate(self.layers)]
        return self._pcd_chains

    def _visible_kw(self) -> dict:
        """Layer 0's unit type and rate factor as keywords of the ops,
        where it is not Bernoulli (a Bernoulli stack calls them as it
        always has)."""
        if self.visible == fast_cd.BERNOULLI:
            return {}
        return dict(visible=self.visible,
                    visible_lr_scale=self.visible_lr_scale)

    def _epoch_kw(self, bs: int) -> dict:
        """The setting of this model's fused epochs."""
        r0 = self.layers[0]
        return dict(weight_decay=r0.weight_decay,
                    sparsity_factor=self.sparsity_factor, cd=self.cd_k,
                    sparsity_flags=[r.sparsity for r in self.layers],
                    batch_size=bs, compute_dtype=self.compute_dtype,
                    sr=self.sr, fast_sampler=self._fast_sampler(),
                    **self._visible_kw())

    def _epoch_runner(self, data: torch.Tensor, bs: int):
        """The runner of this train call's fused epochs
        (``dbn_train.idbn_epoch_runner``): graphed on a CUDA device without
        a mesh, launch by launch on the CPU and over a mesh (module
        docstring)."""
        return dbn_train.idbn_epoch_runner(
            data, pcd=self.use_pcd, mesh=self.mesh,
            graphed=self.device.type == "cuda" and self.mesh is None,
            **self._epoch_kw(bs))

    def _train_epoch(self, epoch: int, runner, bs: int) -> float:
        """One epoch: the split permuted by this epoch's key, its full
        batches in order, then the remainder batch by CD, so every sample
        trains exactly once (``dbn_train.idbn_epoch_block`` through
        ``runner``; under PCD ``idbn_epoch_block_pcd`` with the fantasy
        particles). Returns the mean loss over the (batch, layer) entries
        (reference idbn.py:204-208), the one host read of the epoch."""
        r0 = self.layers[0]
        args = (int(self.params.get("SEED", 0)), runner.consts[0], [epoch],
                [effective_lr(r0.lr, epoch, r0.dynamic_lr)],
                [effective_momentum(r0.momentum, r0.final_momentum, epoch)])
        kw = dict(self._epoch_kw(bs), runner=runner)
        if self.use_pcd:
            states, self._pcd_chains, sums, counts = \
                dbn_train.idbn_epoch_block_pcd(
                    self.states(), self._ensure_pcd_chains(bs), *args, **kw)
        else:
            states, sums, counts = dbn_train.idbn_epoch_block(
                self.states(), *args, mesh=self.mesh, **kw)
        self._set_states(states)
        with span("epoch.read"):
            return float(sums[0]) / max(1, counts[0])

    def _train_epoch_batched(self, epoch: int, epochs: int) -> float:
        """One epoch over the loader's batches, every layer updated on
        every batch as ``RBM.train_epoch`` updates it (its own key stream
        and schedule) and fed the post-update activations of the layer
        below; returns the mean of all (batch, layer) losses (JAX
        models/idbn.py:433-442). A batch is one call of ``_batch_step``,
        one graph replay on the card; the losses stay on the device until
        the epoch's one host read."""
        if self.visible != fast_cd.BERNOULLI:
            raise NotImplementedError(
                f"{self.visible} visible units train on the fused epochs "
                f"only: give the loader materialize()")
        hyper = graphs.hyper(self.device, *(
            x for r in self.layers for x in (
                effective_lr(r.lr, epoch, r.dynamic_lr),
                effective_momentum(r.momentum, r.final_momentum, epoch))))
        layers = tuple(dict(groups=r._groups(), sr=r.sr,
                            weight_decay=r.weight_decay, cd=int(self.cd_k),
                            sparsity=r.sparsity,
                            sparsity_factor=r.sparsity_factor)
                       for r in self.layers)
        losses = []
        for img, _ in self.dataloader:
            v = as_tensor(img, self.device)
            v = v.reshape(v.shape[0], -1)
            states, loss = graphs.update(
                self, self.device, _batch_step,
                tuple(r._next_key() for r in self.layers), self.states(), v,
                hyper, layers=layers)
            self._set_states(states)
            losses.append(loss)
        if not losses:
            return 0.0
        return float(np.mean(torch.cat(losses).tolist()))

    def _save_train_checkpoint(self, path, next_epoch: int,
                               phase: str = "image") -> None:
        save_train_checkpoint(self, path, phase=phase,
                              next_epoch=next_epoch,
                              loss_history=self.loss_history)

    def train(self, epochs: int, log_every_pca: int = 25,
              log_every_probe: int = 10, fused: Optional[bool] = None,
              start_epoch: int = 0, checkpoint_every: int = 0,
              checkpoint_path: Optional[str] = None,
              checkpoint_phase: str = "image") -> None:
        """Train epochs ``start_epoch .. epochs - 1``
        (JAX models/idbn.py:307-455). Each epoch is timed
        (``epoch_timer``); with a run object it is logged
        (``_log_epoch``: PCA every ``log_every_pca`` epochs, probes every
        ``log_every_probe``).

        ``fused=None`` runs the fused epochs when the loader offers
        ``materialize()`` and the per-batch loop otherwise; ``False``
        forces the loop. Data parallelism needs the fused epochs.

        Crash-safe resume: with ``checkpoint_every=N`` and
        ``checkpoint_path`` a resumable checkpoint (weights, momentum, loss
        history) is written every N epochs; ``start_epoch=k`` continues a
        run restored by ``checkpoint.load_train_checkpoint``. Epoch e draws
        from ``fold_in(SEED, e)`` alone, so the resumed run is bit-identical
        to an uninterrupted one (tests/test_torch_resume.py); the per-batch
        loop draws from the shells' streams and the loader's shuffle
        counter, both restored with the checkpoint.
        ``checkpoint_phase`` tags the files ("image", "mod1", "mod2").
        """
        if fused is None:
            fused = hasattr(self.dataloader, "materialize")
        if self._resolve_mesh() is not None and not fused:
            raise ValueError("data-parallel training needs the fused "
                             "epoch path (a dataloader with "
                             ".materialize(), or fused=True)")
        epochs, start_epoch = int(epochs), int(start_epoch)
        check_train_args(start_epoch, epochs, checkpoint_every,
                         checkpoint_path)
        bs = int(getattr(self.dataloader, "batch_size", 128))
        if fused:
            data = as_tensor(self.dataloader.materialize()[0], self.device)
            runner = self._epoch_runner(data.reshape(data.shape[0], -1),
                                        bs)
        else:
            align_loader_for_resume(self, start_epoch)
        timer = StepTimer(self.device)
        for b_start, b_end in checkpoint_epochs(
                start_epoch, epochs,
                checkpoint_every if checkpoint_path else 0):
            for epoch in range(b_start, b_end):
                with timer.step():
                    mean_loss = (self._train_epoch(epoch, runner, bs)
                                 if fused
                                 else self._train_epoch_batched(epoch,
                                                                epochs))
                self.loss_history.append(mean_loss)
                if self.wandb_run is not None:
                    timer.log_to(self.wandb_run, prefix="perf/idbn_epoch",
                                 epoch=epoch)
                    self._log_epoch(epoch, mean_loss, log_every_pca,
                                    log_every_probe)
            maybe_save_train_checkpoint(
                self, checkpoint_path, checkpoint_every, checkpoint_phase,
                b_end, epochs, loss_history=self.loss_history)
        self.epoch_timer = timer
        if epochs > start_epoch:
            self._warn_if_collapsed()

    def reinit_layers(self, seed_offset: int = 0) -> None:
        """Re-draw all layer parameters (fresh W, zero biases and momentum)
        with a derived seed; the loss history is kept
        (JAX models/idbn.py:457-471)."""
        base = self._init_seed
        for i, rbm in enumerate(self.layers):
            self.layers[i] = RBM(
                num_visible=rbm.num_visible, num_hidden=rbm.num_hidden,
                learning_rate=rbm.lr, weight_decay=rbm.weight_decay,
                momentum=rbm.momentum, dynamic_lr=rbm.dynamic_lr,
                final_momentum=rbm.final_momentum, sparsity=rbm.sparsity,
                sparsity_factor=rbm.sparsity_factor,
                softmax_groups=rbm.softmax_groups,
                seed=None if base is None else base + i + seed_offset,
                device=self.device, dtype=self.dtype, sr=self.sr)

    def _recon_collapse_ratio(self) -> Optional[float]:
        """Auto-reconstruction MSE of the cached validation batch over the
        blank-reconstruction baseline mean(x²), or None without a batch.
        Collapsed stacks sit near 1 (JAX models/idbn.py:473-484)."""
        if self.val_batch is None:
            return None
        vb = as_tensor(self.val_batch, self.device)
        rec = self.reconstruct(vb)
        if self.visible == fast_cd.BERNOULLI:
            rec = torch.clamp(rec, 0, 1)
        mse = float(torch.mean((vb - rec) ** 2))
        blank = float(torch.mean(vb * vb))
        return mse / max(blank, 1e-12)

    def _warn_if_collapsed(self, recon_margin: float = 0.9) -> bool:
        """Log-only end-of-phase collapse signal
        (JAX models/idbn.py:486-504)."""
        if getattr(self, "_suppress_collapse_warn", False):
            return False
        ratio = self._recon_collapse_ratio()
        if ratio is None or ratio < recon_margin:
            return False
        print(f"[iDBN] warn/idbn_blank_recon: end-of-phase auto-recon is "
              f"at {ratio:.2f}x the blank baseline (>= {recon_margin}) — "
              f"the stack likely collapsed at initialization. Retrain "
              f"with another seed, or enable the retry rescue "
              f"(iDBN.train_with_retry / the entry points' "
              f"training.init_retry).")
        if self.wandb_run is not None:
            self.wandb_run.log({"warn/idbn_blank_recon": ratio})
        return True

    def train_with_retry(self, epochs: int, max_retries: int = 2,
                         recon_margin: float = 0.9, start_epoch: int = 0,
                         **train_kw) -> int:
        """Opt-in rescue from CD initialization collapse
        (JAX models/idbn.py:506-565): train; while the validation batch's
        auto-reconstruction MSE is not below ``recon_margin`` × the blank
        baseline, re-initialize with a derived seed and retrain from epoch
        0, at most ``max_retries`` times. Returns the retries used. With
        ``start_epoch`` the first attempt continues a restored run, and the
        collapse check still runs at its end."""
        def collapsed() -> bool:
            ratio = self._recon_collapse_ratio()
            return ratio is not None and ratio >= recon_margin

        # This path handles collapse itself: no end-of-train() warning
        # telling the user to enable the rescue they enabled.
        self._suppress_collapse_warn = True
        try:
            self.train(epochs, start_epoch=start_epoch, **train_kw)
            retries = 0
            still_collapsed = collapsed()
            while retries < int(max_retries) and still_collapsed:
                retries += 1
                print(f"[iDBN] recon at blank level — reinit (retry "
                      f"{retries}/{max_retries})")
                # Set the collapsed attempt's checkpoint aside before the
                # reinit: a crash before the retry's first checkpoint
                # would otherwise resume the collapsed weights.
                ckpt = train_kw.get("checkpoint_path")
                if ckpt is not None and os.path.exists(ckpt):
                    os.replace(ckpt, str(ckpt) + f".collapsed{retries}")
                self.reinit_layers(seed_offset=7919 * retries)
                self.train(epochs, **train_kw)
                still_collapsed = collapsed()
        finally:
            self._suppress_collapse_warn = False
        if still_collapsed:
            print(f"[iDBN] warn/idbn_blank_recon: still at blank-level "
                  f"reconstruction after {retries} reinit "
                  f"retr{'y' if retries == 1 else 'ies'} — this dataset/"
                  f"schedule/seed combination may need a different "
                  f"learning rate or architecture.")
            if self.wandb_run is not None:
                self.wandb_run.log(
                    {"warn/idbn_blank_recon": self._recon_collapse_ratio()})
        return retries

    # -- per-epoch logging (JAX models/idbn.py:225-240, :567-641) -------------

    def _layers_to_monitor(self) -> List[int]:
        """Top layer plus layer 1 when deeper (reference idbn.py:163-173)."""
        layers = {len(self.layers)}
        if len(self.layers) > 1:
            layers.add(1)
        return sorted(layers)

    def _layer_tag(self, idx: int) -> str:
        return f"layer{idx}"

    def _log_epoch(self, epoch: int, mean_loss: float, log_every_pca: int,
                   log_every_probe: int) -> None:
        """The reference's logging cadences (idbn.py:207-305): loss every
        epoch, the auto-reconstruction every 5, PCA correlations and
        linear probes of the monitored layers at their cadences. A
        diagnostic that fails logs ``warn/idbn_*_error`` and training goes
        on."""
        from multimodal_idbn_tpu_torch.utils.probe_utils import (
            compute_val_embeddings_and_features, log_linear_probe)
        from multimodal_idbn_tpu_torch.utils.wandb_utils import (
            log_pca_embeddings, log_reconstruction_grid)
        run = self.wandb_run
        if run is None:
            return
        run.log({"idbn/loss": mean_loss, "epoch": epoch})

        if self.val_batch is not None and epoch % 5 == 0:
            try:
                vb = as_tensor(self.val_batch, self.device)[:8]
                rec = self.reconstruct(vb)
                mse = float(torch.mean((vb - torch.clamp(rec, 0, 1)) ** 2))
                run.log({"idbn/auto_recon_mse": mse, "epoch": epoch})
                log_reconstruction_grid(run, vb, rec, epoch,
                                        key="idbn/auto_recon_grid")
            except Exception as e:  # a diagnostic must not stop training
                run.log({"warn/idbn_auto_recon_error": str(e)})

        if self.val_loader is None or self.features is None:
            return
        if epoch % log_every_pca == 0:
            for layer_idx in self._layers_to_monitor():
                tag = self._layer_tag(layer_idx)
                try:
                    E, feats = compute_val_embeddings_and_features(
                        self, upto_layer=layer_idx)
                    if E.numel():
                        log_pca_embeddings(run, E, feature_map(feats),
                                           f"iDBN_{tag}")
                except Exception as e:
                    run.log({f"warn/idbn_pca_error_{tag}": str(e)})
        if epoch % log_every_probe == 0:
            for layer_idx in self._layers_to_monitor():
                tag = self._layer_tag(layer_idx)
                try:
                    log_linear_probe(self, epoch=epoch, n_bins=5,
                                     test_size=0.2, steps=1000, lr=1e-2,
                                     patience=20, min_delta=0.0,
                                     upto_layer=layer_idx, layer_tag=tag)
                except Exception as e:
                    run.log({f"warn/idbn_probe_error_{tag}": str(e)})

    # -- inference (JAX models/idbn.py:645-658) -------------------------------

    def _weights(self):
        return [rbm_ops.weights_only(s) for s in self.states()]

    def represent(self, x, upto_layer: Optional[int] = None) -> torch.Tensor:
        """Mean-field encode to a layer."""
        L = (len(self.layers) if upto_layer is None
             else max(0, min(len(self.layers), int(upto_layer))))
        return graphs.serve(self, self.device, dbn_train.dbn_represent,
                            None, self._weights(), as_tensor(x, self.device),
                            upto=L, **self._unit_kw())

    def reconstruct(self, x) -> torch.Tensor:
        """Encode all the way up, then decode back."""
        return graphs.serve(self, self.device, dbn_train.dbn_reconstruct,
                            None, self._weights(),
                            as_tensor(x, self.device), **self._unit_kw())

    def decode(self, top) -> torch.Tensor:
        """Decode top activations to input space: probabilities, or the
        Gaussian's mean, or the word distribution."""
        return graphs.serve(self, self.device, dbn_train.dbn_decode, None,
                            self._weights(), as_tensor(top, self.device),
                            **self._unit_kw())

    def _unit_kw(self) -> dict:
        """Layer 0's unit type as a keyword of the inference ops, where it
        is not Bernoulli."""
        return {} if self.visible == fast_cd.BERNOULLI \
            else {"visible": self.visible}

    # -- persistence (JAX models/idbn.py:660-674) -----------------------------

    def save_model(self, path: str) -> None:
        """Pickle ``{"layers", "params"}`` (reference idbn.py:361-373)."""
        with open(path, "wb") as f:
            pickle.dump({"layers": self.layers, "params": self.params}, f)
        print(f"[iDBN] Model saved to {path}")

    # Loaders and run objects are runtime attachments, not model state; an
    # unpickled iDBN lies on the CPU until ``to`` moves it.
    def __getstate__(self):
        d = dict(self.__dict__)
        d["wandb_run"] = None
        d["dataloader"] = None
        d["val_loader"] = None
        d["device"] = "cpu"
        d["mesh"] = None  # a process group lives with its job, not a file
        d.pop("_serving", None)  # graphs live with their process
        for k in ("val_batch", "val_labels"):
            if d.get(k) is not None:
                d[k] = np.asarray(d[k])
        if d.get("_pcd_chains") is not None:  # fp32, as the layers unpickle
            d["_pcd_chains"] = [c.detach().float().cpu().numpy()
                                for c in d["_pcd_chains"]]
        return d

    def __setstate__(self, d):
        # pickles written before the diagnostics hooks lack their fields
        for k, v in (("wandb_run", None), ("features", None),
                     ("text_flag", False), ("dtype", torch.float32),
                     ("compute_dtype", None), ("sr", None),
                     ("use_pcd", False), ("_pcd_chains", None),
                     ("_route_said", False), ("mesh", None),
                     ("_dp_devices", None), ("val_labels", None),
                     ("logging_cfg", {}), ("visible", "bernoulli"),
                     ("visible_lr_scale", 1.0)):
            d.setdefault(k, v)
        d.setdefault("sparsity_last",
                     bool((d.get("params") or {}).get("SPARSITY", False)))
        d.setdefault("arch_dir", os.path.join(
            "logs-idbn", f"architecture_{d.get('arch_str', 'loaded')}"))
        self.__dict__.update(d)
        self.device = torch.device("cpu")
        if self._pcd_chains is not None:
            self._pcd_chains = [torch.from_numpy(np.asarray(c, np.float32))
                                for c in self._pcd_chains]
