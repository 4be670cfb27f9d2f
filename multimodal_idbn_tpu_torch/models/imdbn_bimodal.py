"""iMDBN_BiModal: two modality iDBNs joined by a multi-layer joint DBN.

Port of multimodal_idbn_tpu/models/imdbn_bimodal.py:324-828 and
:1013-1056: the constructor (seed offsets +100 for MOD2, +2000+i for joint
layer i), pretrained modality DBNs and the last-layer fine-tunes
(:447-516), ``init_joint_bias_from_data``, the cross-modal inference
(``_cross_reconstruct``, ``mod1_to_mod2``, ``mod2_to_mod1``, the sampled
``sample_mod1_to_mod2`` / ``sample_mod2_to_mod1``, ``represent``),
``train_joint`` with crash-safe resume (8 warm-up epochs, then free CD
down the joint stack plus the aux clamps; ``ops.bimodal_ops``), and the
pickle ``save_model`` / ``load_model``. ``train_joint(fused=None)`` runs
the fused epochs over a loader with ``materialize()`` and the per-batch
loop (``_train_joint_epoch_batched``, JAX :828-861) over any other; data
parallelism (``DP_DEVICES`` or ``set_mesh``, :364, :629-644) runs the
fused epochs over the mesh (``bimodal_ops.bimodal_epoch_block``) and
reaches both modality iDBNs. How a fused joint epoch runs
(``ops.graphs``): on a CUDA device without a mesh each epoch is one
replay of a CUDA graph of ``bimodal_ops.bimodal_epoch_body``, one graph
for the warm-up epochs and one for the main ones, captured at the first
epoch of each in a ``train_joint`` call (the modality iDBNs' epochs
likewise, ``iDBN``); launch by launch for the per-batch loop
(``fused=False``, or a loader without ``materialize()``, the reference's
altitude), over a mesh (its collectives are not captured) and on the CPU.
Modality latents are computed once per joint run, as the modality iDBNs
are frozen there. The diagnostics are ported too: the module functions
(:37-320: joint embeddings and features, the joint probe, the MOD2→MOD1
chain and the latent trajectories 2-D / 3-D) and the per-epoch logging to
a run object (``_log_joint_epoch``, ``_log_snapshots``, :863-1011); they
draw from joint layer 0's own stream, never from the training keys.

The params keys ``MOD1_VISIBLE`` and ``MOD2_VISIBLE`` name the unit type
of each modality stack's visible layer (``iDBN``'s ``visible``: the
default "bernoulli", "gaussian" or "replicated_softmax"), and
``MOD1_VISIBLE_LR_SCALE`` / ``MOD2_VISIBLE_LR_SCALE`` the factor on its
learning rate: the multimodal DBN of Srivastava & Salakhutdinov (JMLR 15,
2014), a Gaussian image-feature pathway and a replicated-softmax tag
pathway. The joint's latents come through each stack's own up pass, and
the deterministic cross calls decode to the Gaussian's mean and the word
distribution; the sampled cross calls raise ``NotImplementedError`` for a
stack that is not Bernoulli (a generated text's number of words is
unknown).

How a serving call runs: the calls JAX jits,
``bimodal_ops.bimodal_cross_reconstruct`` (``_cross_reconstruct``,
``mod1_to_mod2``, ``mod2_to_mod1``), ``bimodal_ops.sample_cross``
(``sample_mod1_to_mod2``, ``sample_mod2_to_mod1``) and the joint encode
of ``represent``, are each one graph replay on a CUDA device after their
first call at a shape (``graphs.serve``: the model's cache, refreshed
whenever the weights changed); the modality encodes are the iDBNs',
likewise. On the CPU they run launch by launch.
"""

from __future__ import annotations

import datetime
import functools
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_idbn_tpu_torch import convert
from multimodal_idbn_tpu_torch.checkpoint import (align_loader_for_resume,
                                                  checkpoint_epochs,
                                                  maybe_save_train_checkpoint)
from multimodal_idbn_tpu_torch.device import (DeviceLike, as_tensor,
                                              resolve_device, to_numpy)
from multimodal_idbn_tpu_torch.models.idbn import (iDBN, check_train_args,
                                                   feature_map, val_features)
from multimodal_idbn_tpu_torch.models.imdbn import (finetune_last_layer,
                                                    load_pretrained_layers)
from multimodal_idbn_tpu_torch.models.rbm import (RBM,
                                                  _warn_compute_dtype_joint,
                                                  param_dtype, param_sr)
from multimodal_idbn_tpu_torch.ops import (bimodal_ops, dbn_train, graphs,
                                           rbm_ops, rng)
from multimodal_idbn_tpu_torch.ops.sampling import (clamp_mask,
                                                    sample_bernoulli)
from multimodal_idbn_tpu_torch.ops.schedules import (effective_lr,
                                                     effective_momentum)
from multimodal_idbn_tpu_torch.utils.profiling import span
from multimodal_idbn_tpu_torch.utils.wandb_compat import pyplot, wandb

# Hard-coded in the reference (JAX models/imdbn_bimodal.py:30).
WARMUP_EPOCHS = 8


def visible_args(params: dict, mod: str) -> dict:
    """``iDBN``'s ``visible`` and ``visible_lr_scale`` of stack ``mod``
    ("MOD1", "MOD2") from the params, where they are set."""
    out = {}
    if params.get(f"{mod}_VISIBLE") is not None:
        out["visible"] = str(params[f"{mod}_VISIBLE"])
    if params.get(f"{mod}_VISIBLE_LR_SCALE") is not None:
        out["visible_lr_scale"] = float(params[f"{mod}_VISIBLE_LR_SCALE"])
    return out


# ---------------------------------------------------------------------------
# Module-level diagnostics (JAX models/imdbn_bimodal.py:37-320)
# ---------------------------------------------------------------------------

def compute_bimodal_joint_embeddings_and_features(model):
    """Joint-top embeddings over the val set on the model's device + the
    feature dict (JAX imdbn_bimodal.py:37-54)."""
    embeds = [model.represent((mod1, mod2))
              for mod1, mod2 in model.val_loader]
    E = (torch.cat(embeds, dim=0) if embeds
         else torch.zeros((0, 0), device=model.device))
    feats = {}
    if model.features is not None:
        mapping = {"Cumulative Area": "cum_area", "Convex Hull":
                   "convex_hull", "Labels": "labels", "Density": "density"}
        for src, dst in mapping.items():
            if src in model.features:
                feats[dst] = np.asarray(model.features[src])
    return E, feats


def log_bimodal_joint_linear_probe(model, epoch, n_bins=5, test_size=0.2,
                                   steps=1000, lr=1e-2, patience=20,
                                   min_delta=0.0, metric_prefix="joint",
                                   save_csv=False):
    """Linear probes on the bimodal joint representation, on the device
    (JAX imdbn_bimodal.py:57-127). ``save_csv`` is accepted and unused, as
    there."""
    from multimodal_idbn_tpu_torch.utils.probe_utils import (
        _confusion_counts, _format_bin_names, _log_accuracy_wandb,
        _log_confusion_table_wandb, log_probe_summary, make_bin_labels,
        stratified_split, train_linear_classifier)
    del save_csv
    E, feats = compute_bimodal_joint_embeddings_and_features(model)
    if E.numel() == 0:
        return {}
    run = model.wandb_run
    probe_targets = ["cum_area", "convex_hull", "labels"]
    if "density" in feats:
        probe_targets.append("density")

    summary_rows = []
    results = {}
    for mkey in probe_targets:
        if mkey not in feats:
            continue
        y, edges = make_bin_labels(np.asarray(feats[mkey], np.float32),
                                   n_bins=n_bins)
        bin_names = _format_bin_names(edges, precision=4)
        metric_name = f"{metric_prefix}/{mkey}"
        train_idx, test_idx = stratified_split(y, test_size=test_size,
                                               rng_seed=42)
        if len(train_idx) == 0 or len(test_idx) == 0:
            if run:
                run.log({f"{metric_name}/warn_empty_split": 0.0,
                         "epoch": epoch})
            continue
        tr = torch.as_tensor(train_idx, device=E.device)
        te = torch.as_tensor(test_idx, device=E.device)
        acc, y_true, y_pred = train_linear_classifier(
            E[tr], y[train_idx], E[te], y[test_idx], n_classes=n_bins,
            max_steps=steps, lr=lr, weight_decay=0.0, patience=patience,
            min_delta=min_delta)
        summary_rows.append((metric_name, acc))
        results[metric_name] = acc
        _log_accuracy_wandb(run, metric_name, acc, epoch)
        _log_confusion_table_wandb(
            run, _confusion_counts(y_true, y_pred, n_bins), bin_names,
            metric_name, epoch)
    log_probe_summary(run, summary_rows, epoch,
                      f"probe/{metric_prefix}/summary", "indianred",
                      f"Joint probe summary @ epoch {epoch}",
                      f"probe_{metric_prefix}_summary", with_epoch=True)
    return results


def _bimodal_batch_step(joint, mod1_weights, mod2_weights, v1, v2, hyper, *,
                        key, weight_decay, **statics):
    """One batch of the per-batch loop: the latents of both modalities
    (``represent``), then ``bimodal_ops.bimodal_batch_step``'s body at
    ``hyper`` = (lr, momentum). Returns (joint, (CD loss, metric
    sums))."""
    vis1, vis2 = statics.get("visibles") or ("bernoulli", "bernoulli")
    z1 = dbn_train.dbn_represent(mod1_weights, v1, len(mod1_weights), vis1)
    z2 = dbn_train.dbn_represent(mod2_weights, v2, len(mod2_weights), vis2)
    joint, cd_loss, m = bimodal_ops._bimodal_train_batch(
        joint, mod1_weights, mod2_weights, key, z1, z2, v1, v2, hyper[0],
        hyper[1], weight_decay, **statics)
    return joint, (cd_loss, m)


def _mod2_to_mod1_chain(model, z2: torch.Tensor, steps: int):
    """MOD2→MOD1 chain with sampled h on joint layer 0; returns the
    per-step (h_prob, z1) trajectories [steps+1, ·] as host numpy, the
    init included (JAX imdbn_bimodal.py:130-160). A plain torch loop on
    the model's device (``_mod2_to_mod1_body``; one graph replay on the
    card, as JAX runs its scan as one loop), its draws keyed by joint
    layer 0's stream."""
    hs, zs = graphs.serve(model, z2.device, _mod2_to_mod1_body,
                          model.joint_rbm._next_key(),
                          rbm_ops.weights_only(model.joint_rbm.state), z2,
                          steps=int(steps), Dz1=model.Dz_mod1)
    return to_numpy(hs), to_numpy(zs)


def _mod2_to_mod1_body(joint, z2: torch.Tensor, *, key, steps: int,
                       Dz1: int):
    """(h_prob [steps+1, H], z1 [steps+1, Dz1]) of sample 0 of the
    MOD2→MOD1 chain from ``z2``, the init included."""
    B, dev = z2.shape[0], z2.device
    v_known = torch.cat([torch.zeros((B, Dz1), device=dev), z2], dim=1)
    km = torch.cat([torch.zeros((B, Dz1), device=dev),
                    torch.ones_like(z2)], dim=1)
    h0 = rbm_ops.hidden_probs(joint, v_known)
    v = clamp_mask(rbm_ops.visible_probs(joint, h0), v_known, km)
    hs, zs = [h0[0]], [v[0, :Dz1]]
    for t in range(int(steps)):
        h_prob = rbm_ops.hidden_probs(joint, v)
        h = sample_bernoulli(rng.fold_in(key, t), h_prob)
        v = clamp_mask(torch.sigmoid(rbm_ops.visible_logits(joint, h)),
                       v_known, km)
        hs.append(h_prob[0])
        zs.append(v[0, :Dz1])
    return torch.stack(hs), torch.stack(zs)


def _fetch_bimodal_sample(model, sample_idx: int):
    seen = 0
    for mod1, mod2 in model.val_loader:
        b = len(mod1)
        if seen + b <= sample_idx:
            seen += b
            continue
        pos = sample_idx - seen
        return (as_tensor(mod1, model.device)[pos:pos + 1],
                as_tensor(mod2, model.device)[pos:pos + 1])
    return None, None


def log_bimodal_latent_trajectory(model, sample_idx: int = 0,
                                  steps: int = 50, tag: str = "trajectory",
                                  n_frames: int = 8):
    """MOD2→MOD1 trajectory in joint-hidden PCA space with recon panel
    (JAX imdbn_bimodal.py:163-268)."""
    import math
    if model.val_loader is None or model.wandb_run is None:
        return
    # PCA background: h_joint (layer-0 hidden) for all val samples
    H_all = np.concatenate([to_numpy(model.joint_rbm.forward(
        torch.cat(model._latents(mod1, mod2), dim=1)))
        for mod1, mod2 in model.val_loader], axis=0)
    try:
        base = model.val_loader.dataset.dataset
        indices = model.val_loader.dataset.indices
        all_labels = [base.labels[i] for i in indices]
    except AttributeError:  # a loader without the Subset protocol
        all_labels = [0.0] * H_all.shape[0]
    color_vec = np.asarray(all_labels, float)
    sample_idx = min(sample_idx, H_all.shape[0] - 1)

    mod1_s, mod2_s = _fetch_bimodal_sample(model, sample_idx)
    if mod1_s is None:
        return
    z1_true, z2_true = model._latents(mod1_s, mod2_s)
    h_traj, z_traj = _mod2_to_mod1_chain(model, z2_true, steps)
    recs = to_numpy(model.mod1_dbn.decode(z_traj))       # [steps+1, D1]

    mean = H_all.mean(0, keepdims=True)
    _, _, Vt = np.linalg.svd(H_all - mean, full_matrices=False)
    proj = Vt[:2].T
    H2d = (H_all - mean) @ proj
    traj_2d = (h_traj - mean) @ proj
    h_true = to_numpy(model.joint_rbm.forward(
        torch.cat([z1_true, z2_true], dim=1)))
    h_true_2d = (h_true - mean) @ proj

    sel_idx = np.unique(np.linspace(0, len(recs) - 1, n_frames,
                                    dtype=int)).tolist()
    side = int(round(mod1_s.shape[1] ** 0.5))

    def _to_img(t):
        return np.clip(to_numpy(t).reshape(-1), 0, 1).reshape(side, side)

    plt = pyplot(model.wandb_run, f"{tag}_mod2_to_mod1".replace("/", "_"))
    if plt is None:
        return
    n_tiles = len(sel_idx) + 1
    rows = 2
    cols = math.ceil(n_tiles / rows)
    fig = plt.figure(figsize=(8 + cols * 2.2, max(6, rows * 2.2)))
    gs = fig.add_gridspec(nrows=rows, ncols=cols + 4)
    ax0 = fig.add_subplot(gs[:, :4])
    sc = ax0.scatter(H2d[:, 0], H2d[:, 1], c=color_vec, cmap="viridis",
                     s=12, alpha=0.35)
    ax0.scatter(h_true_2d[0, 0], h_true_2d[0, 1], s=80, marker="*", c="k",
                edgecolor="w", linewidths=0.8, label="GT", zorder=3)
    ax0.scatter(traj_2d[0, 0], traj_2d[0, 1], s=50, marker="D", c="red",
                edgecolor="k", linewidths=0.5, label="start", zorder=3)
    ax0.plot(traj_2d[:, 0], traj_2d[:, 1], linewidth=1.6, marker="o",
             markersize=3, c="red", label="trajectory", zorder=2)
    ax0.set_title(f"PCA h_joint - sample {sample_idx} - steps={steps}")
    ax0.set_xlabel("PC1")
    ax0.set_ylabel("PC2")
    fig.colorbar(sc, ax=ax0, fraction=0.046, pad=0.02, label="Numerosity")
    ax0.legend(loc="best")

    right_gs = gs[:, 4:].subgridspec(nrows=rows, ncols=cols)
    ax = fig.add_subplot(right_gs[0, 0])
    ax.imshow(_to_img(mod1_s), cmap="gray", vmin=0, vmax=1)
    ax.set_title("GT", fontsize=9)
    ax.axis("off")
    for k, si in enumerate(sel_idx):
        r, c = divmod(k + 1, cols)
        ax = fig.add_subplot(right_gs[r, c])
        ax.imshow(_to_img(recs[si]), cmap="gray", vmin=0, vmax=1)
        ax.set_title(f"step {si}", fontsize=9)
        ax.axis("off")
    plt.tight_layout()
    model.wandb_run.log({f"{tag}/mod2_to_mod1": wandb.Image(fig)})
    plt.close(fig)


def log_bimodal_latent_trajectory_3d(model, sample_idx: int = 0,
                                     steps: int = 50,
                                     tag: str = "trajectory"):
    """3D PCA trajectory in mod1 latent space (JAX :271-317)."""
    if model.val_loader is None or model.wandb_run is None:
        return
    Z1_all = np.concatenate([to_numpy(model.mod1_dbn.represent(mod1))
                             for mod1, _ in model.val_loader], axis=0)
    sample_idx = min(sample_idx, Z1_all.shape[0] - 1)
    _, mod2_s = _fetch_bimodal_sample(model, sample_idx)
    if mod2_s is None:
        return
    _, z_traj = _mod2_to_mod1_chain(model, model.mod2_dbn.represent(mod2_s),
                                    steps)
    mean = Z1_all.mean(0, keepdims=True)
    _, _, Vt = np.linalg.svd(Z1_all - mean, full_matrices=False)
    proj = Vt[:3].T
    Z3 = (Z1_all - mean) @ proj
    T3 = (z_traj - mean) @ proj

    plt = pyplot(model.wandb_run, f"{tag}_mod2_to_mod1_3d".replace("/", "_"))
    if plt is None:
        return
    fig = plt.figure(figsize=(6.5, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(Z3[:, 0], Z3[:, 1], Z3[:, 2], s=6, alpha=0.15)
    ax.plot(T3[:, 0], T3[:, 1], T3[:, 2], c="r", linewidth=1.2)
    ax.set_title(f"PCA-3 trajectory sample {sample_idx}")
    fig.tight_layout()
    model.wandb_run.log({f"{tag}/mod2_to_mod1_3d": wandb.Image(fig)})
    plt.close(fig)


class iMDBN_BiModal:
    """Bimodal DBN: two modality iDBNs + a joint DBN stack over
    [z_mod1 ⊕ z_mod2] with no softmax groups; ``joint_rbm`` is joint
    layer 0 (JAX models/imdbn_bimodal.py:324-443).

    ``dataloader`` yields (mod1, mod2) batches, and may offer
    ``materialize()`` for the fused epochs; the modality iDBNs are trained on their own loaders
    (``train_bimodal``). ``wandb_run``: any object with ``.log(dict)``;
    ``logging_cfg``: the YAML's ``logging:`` tree (the trajectory gate).
    """

    def __init__(self, layer_sizes_mod1: List[int],
                 layer_sizes_mod2: List[int],
                 joint_layer_sizes: Union[int, Sequence[int]],
                 params: Optional[dict] = None, dataloader=None,
                 val_loader=None, device: DeviceLike = None, wandb_run=None,
                 logging_cfg: Optional[dict] = None,
                 seed: Optional[int] = None):
        self.params = params or {}
        # params["DP_DEVICES"]: data parallelism of all three phases
        self.mesh = None
        self._dp_devices = self.params.get("DP_DEVICES")
        self.device = resolve_device(device)
        self.dataloader = dataloader
        self.val_loader = val_loader
        self.wandb_run = wandb_run
        self.logging_cfg = logging_cfg or {}
        self.mod1_dbn = iDBN(layer_sizes_mod1, self.params, None,
                             device=self.device, seed=seed,
                             wandb_run=wandb_run, **visible_args(
                                 self.params, "MOD1"))
        self.mod2_dbn = iDBN(layer_sizes_mod2, self.params, None,
                             device=self.device,
                             seed=None if seed is None else seed + 100,
                             wandb_run=wandb_run, **visible_args(
                                 self.params, "MOD2"))
        self.Dz_mod1 = int(self.mod1_dbn.layers[-1].num_hidden)
        self.Dz_mod2 = int(self.mod2_dbn.layers[-1].num_hidden)
        if isinstance(joint_layer_sizes, int):
            joint_layer_sizes = [joint_layer_sizes]
        self.joint_layers: List[RBM] = []
        visible = self.Dz_mod1 + self.Dz_mod2
        for i, hidden in enumerate(joint_layer_sizes):
            self.joint_layers.append(RBM(
                num_visible=visible, num_hidden=int(hidden),
                learning_rate=self.params.get(
                    "JOINT_LEARNING_RATE",
                    self.params.get("LEARNING_RATE", 0.1)),
                weight_decay=self.params.get("WEIGHT_PENALTY", 0.0001),
                momentum=self.params.get("INIT_MOMENTUM", 0.5),
                dynamic_lr=self.params.get("LEARNING_RATE_DYNAMIC", True),
                final_momentum=self.params.get("FINAL_MOMENTUM", 0.95),
                seed=None if seed is None else seed + 2000 + i,
                device=self.device, dtype=param_dtype(self.params),
                sr=param_sr(self.params)))
            visible = int(hidden)
        self.joint_rbm = self.joint_layers[0]
        _warn_compute_dtype_joint(self.params, "iMDBN_BiModal")
        self.num_joint_layers = len(self.joint_layers)
        self.joint_cd = int(self.params.get("JOINT_CD",
                                            self.params.get("CD", 1)))
        self.cross_steps = int(self.params.get("CROSS_GIBBS_STEPS", 50))
        # the first validation batch, for the snapshots (JAX :367-373)
        self.validation_mod1 = self.validation_mod2 = None
        first = next(iter(val_loader), None) if val_loader is not None \
            else None
        if first is not None:
            n = min(8, len(first[0]))
            self.validation_mod1 = np.asarray(first[0], np.float32)[
                :8].reshape(n, -1)
            self.validation_mod2 = np.asarray(first[1], np.float32)[
                :8].reshape(n, -1)
        self.features = val_features(val_loader, plain_dataset=True)
        if self.features is not None:
            print(f"[iMDBN_BiModal] Extracted features: "
                  f"{list(self.features.keys())}")
        else:
            print("[iMDBN_BiModal] Warning: Could not extract features for "
                  "probes")
        self.last_metrics: Optional[Dict[str, float]] = None
        self.joint_metrics_history: List[Dict[str, float]] = []
        self.arch_str = (
            f"MOD1{'-'.join(map(str, layer_sizes_mod1))}"
            f"_MOD2{'-'.join(map(str, layer_sizes_mod2))}"
            f"_JOINT{'-'.join(map(str, joint_layer_sizes))}")

    def set_mesh(self, mesh) -> None:
        """Train data-parallel over ``mesh`` (a ``parallel.Mesh``, a
        device count, ``"all"``, or None): the joint DBN and both modality
        iDBNs (JAX models/imdbn_bimodal.py:629-638). An explicit call, None
        included, overrides ``DP_DEVICES``."""
        from multimodal_idbn_tpu_torch.parallel import resolve_mesh
        self.mesh = resolve_mesh(mesh, self.device)
        self._dp_devices = None
        self.mod1_dbn.set_mesh(self.mesh)
        self.mod2_dbn.set_mesh(self.mesh)

    def _resolve_mesh(self):
        if self.mesh is None and self._dp_devices:
            self.set_mesh(self._dp_devices)
        return self.mesh

    @property
    def visibles(self) -> Tuple[str, str]:
        """The unit types of the two stacks' visible layers."""
        return self.mod1_dbn.visible, self.mod2_dbn.visible

    def _visible_kw(self) -> dict:
        """``visibles`` as a keyword of ``bimodal_ops``, where a stack is
        not Bernoulli."""
        vis = self.visibles
        return {} if vis == ("bernoulli", "bernoulli") else {"visibles": vis}

    def _joint_states(self):
        return [r.state for r in self.joint_layers]

    def _set_joint_states(self, states) -> None:
        for r, s in zip(self.joint_layers, states):
            r.state = s

    def _latents(self, mod1, mod2) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.mod1_dbn.represent(as_tensor(mod1, self.device)),
                self.mod2_dbn.represent(as_tensor(mod2, self.device)))

    def to(self, device: DeviceLike = None) -> "iMDBN_BiModal":
        """Move the whole model to ``device`` (``cuda`` unless ``"cpu"``)."""
        self.device = resolve_device(device)
        for part in (self.mod1_dbn, self.mod2_dbn, *self.joint_layers):
            part.to(self.device)
        return self

    # -- pretrained loading and fine-tuning (JAX :447-516) -------------------

    def load_pretrained_mod1_dbn(self, path: str) -> bool:
        return self._load_pretrained_dbn(self.mod1_dbn, path, "mod1")

    def load_pretrained_mod2_dbn(self, path: str) -> bool:
        return self._load_pretrained_dbn(self.mod2_dbn, path, "mod2")

    def _load_pretrained_dbn(self, dbn: iDBN, path: str, name: str) -> bool:
        layers = load_pretrained_layers(
            path, f"load_pretrained_{name}_dbn", self.device)
        if layers is None:
            return False
        dbn.layers = layers
        return True

    def _finetune(self, dbn: iDBN, modality_idx: int, epochs: int,
                  lr_scale: float, cd_k: Optional[int]) -> None:
        loader, batch_index = getattr(dbn, "dataloader", None), 0
        if loader is None:
            # the bimodal loader yields (mod1, mod2): pick this modality
            loader, batch_index = self.dataloader, modality_idx
        finetune_last_layer(dbn, loader, epochs, lr_scale, cd_k,
                            batch_index=batch_index)

    def finetune_mod1_last_layer(self, epochs: int = 0,
                                 lr_scale: float = 0.3,
                                 cd_k: Optional[int] = None) -> None:
        self._finetune(self.mod1_dbn, 0, epochs, lr_scale, cd_k)

    def finetune_mod2_last_layer(self, epochs: int = 0,
                                 lr_scale: float = 0.3,
                                 cd_k: Optional[int] = None) -> None:
        self._finetune(self.mod2_dbn, 1, epochs, lr_scale, cd_k)

    # -- bias init (JAX :520-544) -------------------------------------------

    def init_joint_bias_from_data(self, n_batches: int = 10) -> None:
        """Logit-mean visible biases of both halves of joint layer 0 from
        the first ``n_batches`` batches the loader yields
        (JAX models/imdbn_bimodal.py:520-544)."""
        sum_z1 = sum_z2 = None
        n = 0
        for b, (mod1, mod2) in enumerate(self.dataloader):
            if b >= n_batches:
                break
            z1, z2 = self._latents(mod1, mod2)
            sum_z1 = z1.sum(0) if sum_z1 is None else sum_z1 + z1.sum(0)
            sum_z2 = z2.sum(0) if sum_z2 is None else sum_z2 + z2.sum(0)
            n += z1.shape[0]
        if n == 0:
            return
        mean_z1 = torch.clamp(sum_z1 / n, 1e-4, 1 - 1e-4)
        mean_z2 = torch.clamp(sum_z2 / n, 1e-4, 1 - 1e-4)
        self.joint_rbm.vis_bias = torch.cat([
            torch.log(mean_z1) - torch.log1p(-mean_z1),
            torch.log(mean_z2) - torch.log1p(-mean_z2)])

    # -- inference (JAX :548-625) -------------------------------------------

    def _cross_reconstruct(self, z_mod1, z_mod2,
                           steps: Optional[int] = None,
                           direction: str = "both"):
        """Cross-reconstruction through joint layer 0; returns
        (mod1_from_mod2, mod2_from_mod1) (JAX :548-560)."""
        return self._cross_call(z_mod1, z_mod2, steps, direction)()

    def _cross_call(self, z_mod1, z_mod2, steps: Optional[int] = None,
                    direction: str = "both"):
        """The serving call of ``_cross_reconstruct`` with its arguments
        made (the inputs on the device, the key drawn, the weights
        gathered), to be called."""
        return functools.partial(
            graphs.serve, self, self.device,
            bimodal_ops.bimodal_cross_reconstruct,
            self.joint_rbm._next_key(),
            rbm_ops.weights_only(self.joint_rbm.state),
            self.mod1_dbn._weights(), self.mod2_dbn._weights(),
            z1=as_tensor(z_mod1, self.device),
            z2=as_tensor(z_mod2, self.device),
            steps=int(self.cross_steps if steps is None else steps),
            Dz1=self.Dz_mod1, direction=direction, **self._visible_kw())

    def mod1_to_mod2(self, mod1_images) -> torch.Tensor:
        """Decoded modality-2 images from raw modality-1 images."""
        with span("serve.inputs"):
            z1 = self.mod1_dbn.represent(mod1_images)
            z2 = torch.zeros((z1.shape[0], self.Dz_mod2),
                             device=self.device)
            call = self._cross_call(z1, z2, direction="1to2")
        return call()[1]

    def mod2_to_mod1(self, mod2_images) -> torch.Tensor:
        """Decoded modality-1 images from raw modality-2 images."""
        with span("serve.inputs"):
            z2 = self.mod2_dbn.represent(mod2_images)
            z1 = torch.zeros((z2.shape[0], self.Dz_mod1),
                             device=self.device)
            call = self._cross_call(z1, z2, direction="2to1")
        return call()[0]

    def sample_mod1_to_mod2(self, mod1_images,
                            gibbs_steps: Optional[int] = None,
                            seed: Optional[int] = None) -> torch.Tensor:
        """Generate modality-2 images from modality-1 images: the fully
        sampled chain on joint layer 0 and an ancestral-sampled decode
        (``bimodal_ops.sample_cross``). ``seed`` fixes the draw."""
        return self._sample_cross(mod1_images, "1to2", gibbs_steps, seed)

    def sample_mod2_to_mod1(self, mod2_images,
                            gibbs_steps: Optional[int] = None,
                            seed: Optional[int] = None) -> torch.Tensor:
        """Generate modality-1 images from modality-2 images."""
        return self._sample_cross(mod2_images, "2to1", gibbs_steps, seed)

    def _sample_cross(self, images, direction, gibbs_steps, seed):
        target = self.visibles[1 if direction == "1to2" else 0]
        if target != "bernoulli":
            raise NotImplementedError(
                f"sampled cross-modal generation to {target} visible units "
                f"is not supported (the number of words of generated text "
                f"is unknown); use the deterministic mod1_to_mod2 / "
                f"mod2_to_mod1")
        with span("serve.inputs"):
            if direction == "1to2":
                z1 = self.mod1_dbn.represent(images)
                z2 = torch.zeros((z1.shape[0], self.Dz_mod2),
                                 device=self.device)
            else:
                z2 = self.mod2_dbn.represent(images)
                z1 = torch.zeros((z2.shape[0], self.Dz_mod1),
                                 device=self.device)
            steps = int(self.cross_steps if gibbs_steps is None
                        else gibbs_steps)
            key = rng.fold_in(seed, 0) if seed is not None \
                else self.joint_rbm._next_key()
            call = functools.partial(
                graphs.serve, self, self.device, bimodal_ops.sample_cross,
                key, rbm_ops.weights_only(self.joint_rbm.state),
                self.mod1_dbn._weights(), self.mod2_dbn._weights(), z1=z1,
                z2=z2, steps=steps, Dz1=self.Dz_mod1, direction=direction)
        return call()

    def represent(self, batch) -> torch.Tensor:
        """Joint representation through all joint layers (JAX :616-625)."""
        z1, z2 = self._latents(*batch)
        return graphs.serve(
            self, self.device, dbn_train.dbn_represent, None,
            [rbm_ops.weights_only(s) for s in self._joint_states()],
            torch.cat([z1, z2], dim=1), upto=self.num_joint_layers)

    # -- joint training (JAX :653-828) --------------------------------------

    def train_joint(self, epochs: int, log_every: int = 5,
                    log_every_pca: int = 25, log_every_probe: int = 10,
                    log_every_trajectory: int = 50,
                    fused: Optional[bool] = None, start_epoch: int = 0,
                    checkpoint_every: int = 0,
                    checkpoint_path: Optional[str] = None) -> None:
        """Alternating-modality warm-up for the first ``WARMUP_EPOCHS``
        epochs, then free CD down the joint stack + the aux clamps, with
        the cross-reconstruction metrics on every ``CROSS_METRICS_EVERY``-th
        batch (JAX models/imdbn_bimodal.py:653-828). Epoch e permutes the
        split and keys its batches from ``fold_in(SEED + 11, e)`` alone
        and trains its full batches and then the remainder
        (``bimodal_ops.bimodal_epoch``). With a run object each epoch is
        logged (``_log_joint_epoch``, at the ``log_every*`` cadences).

        ``start_epoch`` / ``checkpoint_every`` / ``checkpoint_path``:
        crash-safe resume under the contract of ``iMDBN.train_joint``
        (phase tag "bimodal_joint"; bit-identical,
        tests/test_torch_resume.py).

        ``fused=None`` runs the fused epochs when the loader offers
        ``materialize()`` and the per-batch loop otherwise; ``False``
        forces the loop. Data parallelism needs the fused epochs.
        """
        epochs, start_epoch = int(epochs), int(start_epoch)
        check_train_args(start_epoch, epochs, checkpoint_every,
                         checkpoint_path)
        print(f"[iMDBN_BiModal] joint training: {self.num_joint_layers} "
              f"layers, {epochs} epochs total")
        if start_epoch == 0:
            self.init_joint_bias_from_data(n_batches=10)
            self.joint_metrics_history = []
        if fused is None:
            fused = hasattr(self.dataloader, "materialize")
        mesh = self._resolve_mesh()
        if mesh is not None and not fused:
            raise ValueError("data-parallel joint training needs the "
                             "fused epoch path (a dataloader with "
                             ".materialize(), or fused=True)")
        aux_cond_steps = int(self.params.get("JOINT_AUX_COND_STEPS", 30))
        metrics_every = int(self.params.get("CROSS_METRICS_EVERY", 1))
        npix1 = self.mod1_dbn.layers[0].num_visible
        npix2 = self.mod2_dbn.layers[0].num_visible
        if fused:
            m1, m2 = self.dataloader.materialize()
            V1, V2 = as_tensor(m1, self.device), as_tensor(m2, self.device)
            Z1, Z2 = self._latents(V1, V2)
            mod1_states = self.mod1_dbn.states()
            mod2_states = self.mod2_dbn.states()
        else:
            align_loader_for_resume(self, start_epoch)
        bs = int(getattr(self.dataloader, "batch_size", 128))
        jr = self.joint_rbm
        seed = int(self.params.get("SEED", 0)) + 11
        runners: dict = {}
        for b_start, b_end in checkpoint_epochs(
                start_epoch, epochs,
                checkpoint_every if checkpoint_path else 0,
                min(WARMUP_EPOCHS, epochs)):
            for epoch in range(b_start, b_end):
                warmup = epoch < WARMUP_EPOCHS
                lr = effective_lr(jr.lr, epoch, jr.dynamic_lr)
                mom = effective_momentum(jr.momentum, jr.final_momentum,
                                         epoch)
                statics = dict(warmup=warmup, joint_cd=self.joint_cd,
                               aux_cond_steps=aux_cond_steps,
                               Dz1=self.Dz_mod1, steps=self.cross_steps,
                               sr=jr.sr, **self._visible_kw())
                if fused:
                    if warmup not in runners:
                        runners[warmup] = bimodal_ops.bimodal_epoch_runner(
                            Z1, Z2, V1, V2, mod1_states, mod2_states,
                            jr.weight_decay, batch_size=bs,
                            metrics_every=metrics_every, mesh=mesh,
                            graphed=(self.device.type == "cuda"
                                     and mesh is None), **statics)
                    joint, sums, counts, totals = \
                        bimodal_ops.bimodal_epoch_block(
                            self._joint_states(), mod1_states, mod2_states,
                            seed, Z1, Z2, V1, V2, [epoch], [lr], [mom],
                            jr.weight_decay, batch_size=bs,
                            metrics_every=metrics_every, mesh=mesh,
                            runner=runners[warmup], **statics)
                    self._set_joint_states(joint)
                    cd_sum, cd_count = sums[0], counts[0]
                    with span("epoch.read"):
                        tot = {k: float(v)
                               for k, v in totals[0]._asdict().items()}
                else:
                    cd_sum, cd_count, tot = self._train_joint_epoch_batched(
                        lr, mom, metrics_every, statics)
                self.last_metrics = None
                if tot["n"] > 0:
                    self.last_metrics = {
                        "cross_modality/mod1_mse":
                            tot["mse_mod1"] / (tot["n"] * npix1),
                        "cross_modality/mod2_mse":
                            tot["mse_mod2"] / (tot["n"] * npix2),
                    }
                    self.joint_metrics_history.append(
                        dict(self.last_metrics, epoch=epoch))
                if self.wandb_run is not None:
                    cd_mean = (float(cd_sum) / cd_count if cd_count
                               else None)
                    self._log_joint_epoch(epoch, cd_mean, log_every,
                                          log_every_pca, log_every_probe,
                                          log_every_trajectory)
            maybe_save_train_checkpoint(self, checkpoint_path,
                                        checkpoint_every, "bimodal_joint",
                                        b_end, epochs)
        print("[iMDBN_BiModal] joint training finished.")

    def _train_joint_epoch_batched(self, lr, mom, metrics_every: int,
                                   statics: dict):
        """The per-batch loop for loaders that cannot materialize (JAX
        models/imdbn_bimodal.py:828-861): each (mod1, mod2) batch's
        latents, then ``bimodal_ops.bimodal_batch_step`` keyed from joint
        layer 0's stream. A batch is one call of ``_bimodal_batch_step``,
        one graph replay on the card; its loss and metric sums stay on the
        device until the epoch's one host read. Returns (CD-loss sum, CD
        batches, metric sums)."""
        jr = self.joint_rbm
        hyper = graphs.hyper(self.device, lr, mom)
        outs = []
        for b_idx, (mod1, mod2) in enumerate(self.dataloader):
            v1, v2 = (as_tensor(m, self.device) for m in (mod1, mod2))
            v1, v2 = v1.reshape(v1.shape[0], -1), v2.reshape(v2.shape[0], -1)
            joint, out = graphs.update(
                self, self.device, _bimodal_batch_step, jr._next_key(),
                self._joint_states(), self.mod1_dbn._weights(),
                self.mod2_dbn._weights(), v1, v2, hyper,
                weight_decay=jr.weight_decay,
                compute_metrics=(metrics_every <= 1
                                 or b_idx % metrics_every == 0), **statics)
            self._set_joint_states(joint)
            outs.append(out)
        leaves, spec = graphs.flatten(outs)
        outs = graphs.unflatten(spec, torch.stack(leaves).tolist()
                                if leaves else [])
        cd_sum, count = 0.0, 0
        tot = {"n": 0.0, "mse_mod1": 0.0, "mse_mod2": 0.0}
        for cd_loss, m in outs:
            if not statics["warmup"]:
                cd_sum += float(cd_loss)
                count += 1
            for k, v in m._asdict().items():
                tot[k] += float(v)
        return cd_sum, count, tot

    def _log_joint_epoch(self, epoch, cd_mean, log_every, log_every_pca,
                         log_every_probe, log_every_trajectory) -> None:
        """Epoch-tail logging (JAX imdbn_bimodal.py:863-965): the CD loss
        and cross-reconstruction MSEs, the joint and MOD2 PCA, the joint
        probes, the trajectories when the config enables them, then the
        snapshots. A diagnostic that fails logs ``warn/*_error`` and
        training goes on."""
        from multimodal_idbn_tpu_torch.utils.wandb_utils import (
            log_pca_embeddings)
        run = self.wandb_run
        if run is None:
            return
        if cd_mean is not None:
            run.log({"joint/cd_loss": cd_mean, "epoch": epoch})
        if self.last_metrics is not None:
            run.log(dict(self.last_metrics, epoch=epoch))

        if self.val_loader is not None:
            if epoch % log_every_pca == 0:
                try:
                    E, feats = (
                        compute_bimodal_joint_embeddings_and_features(self))
                    if E.numel():
                        log_pca_embeddings(run, E, feature_map(feats),
                                           "Joint_bimodal")
                    # MOD2 latent PCA, Labels coloring only (:915-934)
                    Z2_all = torch.cat([self.mod2_dbn.represent(m2)
                                        for _m1, m2 in self.val_loader])
                    log_pca_embeddings(
                        run, Z2_all,
                        {"Labels": feats["labels"]} if "labels" in feats
                        else {}, "MOD2_MNIST100")
                except Exception as e:  # a diagnostic must not stop training
                    run.log({"warn/joint_pca_error": str(e)})
            if epoch % log_every_probe == 0:
                try:
                    log_bimodal_joint_linear_probe(
                        self, epoch=epoch, n_bins=5, test_size=0.2,
                        steps=1000, lr=1e-2, patience=20, min_delta=0.0,
                        metric_prefix="joint")
                except Exception as e:
                    run.log({"warn/joint_probe_error": str(e)})
            if epoch % log_every_trajectory == 0:
                traj_cfg = self.logging_cfg.get("trajectory", {})
                if traj_cfg.get("enable", False):
                    try:
                        for s_idx in range(traj_cfg.get("num_samples", 4)):
                            log_bimodal_latent_trajectory(
                                self, sample_idx=s_idx,
                                steps=self.cross_steps,
                                tag=f"trajectory/sample{s_idx}", n_frames=8)
                        if traj_cfg.get("plot_3d", True):
                            log_bimodal_latent_trajectory_3d(
                                self, sample_idx=0, steps=self.cross_steps,
                                tag="trajectory")
                    except Exception as e:
                        run.log({"warn/trajectory_error": str(e)})

        if epoch % max(1, int(log_every)) == 0:
            self._log_snapshots(epoch)

    def _log_snapshots(self, epoch: int, num: int = 8) -> None:
        """Cross-reconstruction grids and MSEs of the first validation
        pairs (JAX imdbn_bimodal.py:967-1009)."""
        from multimodal_idbn_tpu_torch.utils.wandb_utils import make_grid
        if self.wandb_run is None or self.validation_mod1 is None:
            return
        try:
            m1 = self.validation_mod1[:num]
            m2 = self.validation_mod2[:num]
            z1, z2 = self._latents(m1, m2)
            rec1, rec2 = self._cross_reconstruct(z1, z2,
                                                 steps=self.cross_steps)
            B = m1.shape[0]
            r1 = np.clip(to_numpy(rec1), 0, 1)
            r2 = np.clip(to_numpy(rec2), 0, 1)
            mse1 = float(np.mean((r1 - m1) ** 2))
            mse2 = float(np.mean((r2 - m2) ** 2))
            self.wandb_run.log({"snap/mod1_mse": mse1, "snap/mod2_mse": mse2,
                                "epoch": epoch})

            side1 = int(round(m1.shape[1] ** 0.5))
            pair1 = np.stack([m1.reshape(B, side1, side1),
                              r1.reshape(B, side1, side1)],
                             axis=1).reshape(-1, side1, side1)
            self.wandb_run.log({"snap/mod1_from_mod2":
                                wandb.Image(make_grid(pair1, nrow=2)),
                                "epoch": epoch})
            if m2.shape[1] == 1568:  # 28x56 MNIST-100
                h2, w2 = 28, 56
            else:
                h2 = w2 = int(round(m2.shape[1] ** 0.5))
            pair2 = np.stack([m2.reshape(B, h2, w2), r2.reshape(B, h2, w2)],
                             axis=1).reshape(-1, h2, w2)
            self.wandb_run.log({"snap/mod2_from_mod1":
                                wandb.Image(make_grid(pair2, nrow=2)),
                                "epoch": epoch})
        except Exception as e:
            self.wandb_run.log({"warn/snap_error": str(e), "epoch": epoch})

    # -- persistence (JAX :1013-1056) ----------------------------------------

    def save_model(self, path: str) -> None:
        """Pickle payload of the reference (imdbn_bimodal.py:1017-1042):
        both modality iDBNs, the joint layers and the architecture.
        Parameters are pickled as numpy arrays."""
        payload = {
            "mod1_dbn": self.mod1_dbn,
            "mod2_dbn": self.mod2_dbn,
            "joint_layers": self.joint_layers,
            "num_joint_layers": self.num_joint_layers,
            "Dz_mod1": self.Dz_mod1,
            "Dz_mod2": self.Dz_mod2,
            "params": self.params,
            "arch_str": self.arch_str,
            "features": self.features,
            "metadata": {
                "saved_at": datetime.datetime.now().isoformat(),
                "model_type": "iMDBN_BiModal",
                "architecture": self.arch_str,
            },
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        print(f"[iMDBN_BiModal] Model saved to {path}")
        print(f"[iMDBN_BiModal] Architecture: {self.arch_str}")

    def export_npz(self, path: str) -> None:
        """Write every state as ``.npz`` in the ``convert`` bimodal layout
        (``convert.bimodal_from_numpy`` reads it)."""
        np.savez(path, **convert.bimodal_to_numpy(
            self.mod1_dbn.states(), self.mod2_dbn.states(),
            self._joint_states()))

    @staticmethod
    def load_model(path: str, device: DeviceLike = None) -> Dict[str, Any]:
        """Load a ``save_model`` payload with its parts moved to ``device``
        (``cuda`` unless ``"cpu"`` is asked for); old single-``joint_rbm``
        payloads are upgraded to ``joint_layers``
        (JAX models/imdbn_bimodal.py:1036-1049)."""
        device = resolve_device(device)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if "joint_layers" not in payload and "joint_rbm" in payload:
            payload["joint_layers"] = [payload["joint_rbm"]]
            payload["num_joint_layers"] = 1
        for part in (payload["mod1_dbn"], payload["mod2_dbn"],
                     *payload["joint_layers"]):
            part.to(device)
        print(f"[iMDBN_BiModal] Model loaded from {path}")
        if "arch_str" in payload:
            print(f"[iMDBN_BiModal] Architecture: {payload['arch_str']}")
        return payload

    def __getstate__(self):
        d = dict(self.__dict__)
        d["wandb_run"] = None
        d["dataloader"] = None
        d["val_loader"] = None
        d["device"] = "cpu"
        d["mesh"] = None  # a process group lives with its job, not a file
        d.pop("_serving", None)  # graphs live with their process
        return d

    def __setstate__(self, d):
        # pickles written before the diagnostics hooks lack their fields
        for k in ("wandb_run", "validation_mod1", "validation_mod2", "mesh",
                  "_dp_devices"):
            d.setdefault(k, None)
        d.setdefault("logging_cfg", {})
        self.__dict__.update(d)
        self.device = torch.device("cpu")
