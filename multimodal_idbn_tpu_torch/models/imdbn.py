"""iMDBN: image iDBN + joint RBM over [z_img ⊕ y].

Port of multimodal_idbn_tpu/models/imdbn.py:34-1071: the constructor,
``init_joint_bias_from_data``, pretrained loading and the last-layer
fine-tune (:272-338), cross-modal inference (``_cross_reconstruct``,
``img2txt``, ``txt2img``, ``sample_txt2img``, ``represent``, :342-449),
``train_joint`` with crash-safe resume (8 warm-up y-clamp epochs, then
free CD + auxiliary clamps, cross-modal metrics per batch, :453-700) and
persistence (``save_model`` as the dual-format pickle payload,
``load_model``, ``from_payload``, pickling, :941-1071), and the
diagnostics hooks: the validation images, labels and ``features``
(:95-156), the joint epoch timer (:509-510, :605-606) and the per-epoch
logging to a run object (``_log_joint_epoch``, ``_get_log_cfg``,
``_log_cadence``, ``_log_config_gated``, ``_log_snapshots``, :759-937).
Image latents are computed once per joint run, as the image iDBN is frozen
there. The diagnostics draw from the joint RBM's own stream, never from
the training keys, so logging leaves the trained parameters unchanged.

``train_joint(fused=None)`` picks the epoch path by the loader, as the JAX
model does (:464-484, :600-604): the fused epochs over a loader with
``materialize()``, else the per-batch loop (``_train_joint_epoch_batched``,
:700-760) through the joint RBM's own updates, its bias init iterating
the loader (``_materialized_train(limit)``, :207-236). Data parallelism
(``DP_DEVICES`` or ``set_mesh``, :129-134, :189-203) reaches both phases:
the image iDBN's epochs and the joint epochs run over the mesh
(``imdbn_ops.joint_epoch_block``); it needs the fused epochs.

How a fused joint epoch runs (``ops.graphs``): on a CUDA device without
a mesh each epoch is one replay of a CUDA graph of
``imdbn_ops.joint_epoch_body``, one graph for the warm-up epochs and one
for the main ones, captured at the first epoch of each in a
``train_joint`` call, the counterpart of JAX's jitted, scanned epoch; the
image iDBN's epochs likewise (``iDBN``). It runs launch by launch where
the configuration asks for it: the per-batch loop (``fused=False``, or a
loader without ``materialize()``), which is the reference's altitude; a
mesh, whose collectives are not captured; and the CPU.

How a serving call runs: the calls JAX jits, ``imdbn_ops.cross_reconstruct``
(``_cross_reconstruct``, ``img2txt``, ``txt2img``) and
``imdbn_ops.sample_txt2img``, are each one graph replay on a CUDA device
after their first call at a shape (``graphs.serve``: the model's cache,
refreshed whenever the weights changed); the image encode of ``img2txt``
and ``represent`` is the iDBN's, likewise. On the CPU they run launch by
launch.
"""

from __future__ import annotations

import datetime
import functools
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from multimodal_idbn_tpu_torch import convert
from multimodal_idbn_tpu_torch.checkpoint import (align_loader_for_resume,
                                                  checkpoint_epochs,
                                                  maybe_save_train_checkpoint)
from multimodal_idbn_tpu_torch.device import (DeviceLike, as_tensor,
                                              resolve_device)
from multimodal_idbn_tpu_torch.models.idbn import (iDBN, check_train_args,
                                                   feature_map,
                                                   load_logging_cfg,
                                                   val_features)
from multimodal_idbn_tpu_torch.models.rbm import (RBM,
                                                  _warn_compute_dtype_joint,
                                                  param_dtype, param_sr)
from multimodal_idbn_tpu_torch.ops import (dbn_train, fast_cd, graphs,
                                           imdbn_ops, rbm_ops, rng)
from multimodal_idbn_tpu_torch.ops.schedules import (effective_lr,
                                                     effective_momentum)
from multimodal_idbn_tpu_torch.utils.profiling import StepTimer, span

# Hard-coded in the reference (JAX models/imdbn.py:30-31).
WARMUP_Y_EPOCHS = 8
ZCLAMP_EVERY = 50


def load_pretrained_layers(path: str, tag: str, device) -> Optional[list]:
    """The RBM layers of a pickled iDBN (a ``{"layers": [...]}`` dict or an
    object with ``.layers``), moved to ``device`` with their momentum
    re-zeroed, or None when the file cannot be read or has another shape
    (JAX models/imdbn.py:272-300, models/imdbn_bimodal.py:453-473)."""
    try:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    except Exception as e:  # any unreadable file means "train instead"
        print(f"[{tag}] error: {e}")
        return None
    if isinstance(obj, dict) and "layers" in obj:
        layers = list(obj["layers"])
    elif hasattr(obj, "layers"):
        layers = list(obj.layers)
    else:
        print(f"[{tag}] unrecognized format")
        return None
    for rbm in layers:
        if hasattr(rbm, "to"):
            rbm.to(device)
        if hasattr(rbm, "reset_momentum"):
            rbm.reset_momentum()
        if not hasattr(rbm, "softmax_groups"):
            rbm.softmax_groups = []
    print(f"[{tag}] loaded from {path}")
    return layers


def finetune_last_layer(dbn: iDBN, loader, epochs: int, lr_scale: float,
                        cd_k: Optional[int], batch_index: int = 0) -> None:
    """Fine-tune the top RBM of ``dbn`` at a reduced learning rate on the
    batches ``loader`` yields, the lower layers frozen; the learning rate
    is restored afterwards (JAX models/imdbn.py:312-338,
    models/imdbn_bimodal.py:479-494)."""
    if epochs <= 0 or loader is None:
        return
    last = dbn.layers[-1]
    old_lr = float(last.lr)
    last.lr = max(1e-8, old_lr * float(lr_scale))
    use_cd = int(cd_k) if cd_k is not None else int(dbn.cd_k)
    try:
        for ep in range(int(epochs)):
            for batch in loader:
                v = as_tensor(batch[batch_index], dbn.device)
                for rbm in dbn.layers[:-1]:
                    v = rbm.forward(v)
                last.train_epoch(v, ep, epochs, CD=use_cd)
    finally:
        last.lr = old_lr


def _joint_batch_step(joint, idbn_weights, img, y, hyper, z_class_mean,
                      z_affine, mu_k, *, key, warmup: bool, zclamp: bool,
                      metrics: bool, Dz: int, K: int, train: dict,
                      clamp: dict, cross: dict):
    """One batch of the per-batch joint loop, as the shell calls run it:
    the image latents (``represent``); in warm-up two y-clamped
    ``train_epoch_clamped``, else ``train_epoch`` (its free-CD loss), one
    y-clamped and, with ``zclamp``, one z-clamped ``train_epoch_clamped``;
    then with ``metrics`` the round trip (``_cross_reconstruct``) and its
    metric sums. The keys of ``key`` are taken in that order, as the
    shell calls draw them from the joint RBM's stream. Returns (joint,
    (free-CD loss or None, CrossMetrics or None))."""
    keys = iter(key)
    z_img = dbn_train.dbn_represent(idbn_weights, img, len(idbn_weights))
    B, dev = z_img.shape[0], z_img.device
    zeros_z = torch.zeros((B, Dz), device=dev)
    zeros_k = torch.zeros((B, K), device=dev)
    v_known = torch.cat([zeros_z, y], dim=1)
    km = torch.cat([zeros_z, torch.ones((B, K), device=dev)], dim=1)
    lr, mom = hyper[0], hyper[1]

    def clamped(st, vk, mask, reclamp):
        return rbm_ops.clamped_cd_update(
            st, next(keys), vk, mask, lr=lr, mom=mom, mu_k=mu_k,
            reclamp_negative=reclamp, **clamp)[0]

    cd_loss = None
    if warmup:
        for _ in range(2):
            joint = clamped(joint, v_known, km, True)
    else:
        joint, cd_loss = fast_cd.cd_update(
            joint, next(keys), torch.cat([z_img, y], dim=1), lr=lr, mom=mom,
            **train)
        joint = clamped(joint, v_known, km, False)
        if zclamp:
            joint = clamped(joint, torch.cat([z_img, zeros_k], dim=1),
                            1.0 - km, False)
    m = None
    if metrics:
        img_from_txt, p_y = imdbn_ops.cross_reconstruct(
            rbm_ops.weights_only(joint), idbn_weights, key=next(keys),
            z_img=z_img, y_onehot=y, z_class_mean=z_class_mean,
            z_affine=z_affine, **cross)
        m = imdbn_ops.cross_metrics_batch(img_from_txt, p_y, img, y)
    return joint, (cd_loss, m)


class iMDBN:
    """Image iDBN + joint RBM whose visible layer is [z_img ⊕ y], the
    label block a softmax group (JAX models/imdbn.py:34-187).

    ``reference_best_of_k_bug`` (default True): the reference's best-of-K
    candidate selection is a no-op; set it False for the real free-energy
    selection (``imdbn_ops.cross_reconstruct``).

    ``wandb_run``: any object with ``.log(dict)``; when given, both training
    phases log per epoch. ``logging_cfg`` is the YAML's ``logging:`` tree
    (which extras run, and how often); without it the file at
    ``logging_config_path`` is read (JAX models/imdbn.py:76-92).

    The parameters are JAX's, in its order (models/imdbn.py:49-56): the
    short form ``iMDBN(image_layers, joint_hidden, ...)`` and the
    reference's long form ``iMDBN(image_layers, text_layers,
    joint_layer_size=joint_hidden, ...)``, whose text layers, like
    ``text_posenc_dim`` and ``embedding_dim``, are accepted and unused.
    """

    def __init__(self, layer_sizes_img: List[int],
                 layer_sizes_txt_or_joint=None,
                 joint_layer_size: Optional[int] = None,
                 params: Optional[dict] = None, dataloader=None,
                 val_loader=None, device: DeviceLike = None,
                 text_posenc_dim: int = 0, num_labels: int = 32,
                 embedding_dim: int = 64, wandb_run=None,
                 logging_config_path: Optional[str] = None,
                 logging_cfg: Optional[dict] = None,
                 seed: Optional[int] = None):
        # the two constructor forms (JAX models/imdbn.py:57-65)
        if isinstance(layer_sizes_txt_or_joint, (list, tuple)):
            if joint_layer_size is None:
                raise ValueError("joint_layer_size required with legacy "
                                 "constructor signature")
        elif joint_layer_size is None:
            joint_layer_size = int(layer_sizes_txt_or_joint)
        del text_posenc_dim, embedding_dim
        params = params or {}
        self.params = params
        self.dataloader = dataloader
        self.val_loader = val_loader
        self.device = resolve_device(device)
        self.wandb_run = wandb_run
        self.logging_cfg = (dict(logging_cfg) if logging_cfg
                            else load_logging_cfg(logging_config_path))
        self.num_labels = int(num_labels)
        self._seed = seed
        # params["DP_DEVICES"]: data parallelism of both phases (set_mesh)
        self.mesh = None
        self._dp_devices = params.get("DP_DEVICES")
        # the first validation batch, for the snapshots (JAX :96-105)
        self.validation_images = self.validation_labels = None
        first = next(iter(val_loader), None) if val_loader is not None \
            else None
        self.val_batch = None if first is None else tuple(first[:2])
        if first is not None:
            n = min(8, len(first[0]))
            self.validation_images = np.asarray(
                first[0], np.float32)[:n].reshape(n, -1)
            self.validation_labels = np.asarray(first[1], np.float32)[:n]
        self.image_idbn = iDBN(layer_sizes_img, params, dataloader,
                               val_loader, device=self.device,
                               wandb_run=wandb_run,
                               logging_config_path=logging_config_path,
                               seed=seed)
        self._build_joint(int(self.image_idbn.layers[-1].num_hidden),
                          int(joint_layer_size))
        self.joint_cd = int(params.get("JOINT_CD", params.get("CD", 1)))
        self.cross_steps = int(params.get("CROSS_GIBBS_STEPS", 50))
        # Parsed and unread by training, as in JAX (models/imdbn.py:121-124;
        # ``train_joint`` reads JOINT_AUX_COND_STEPS with a default of 10).
        self.aux_every_k = int(params.get("JOINT_AUX_EVERY_K", 0))
        self.aux_cond_steps = int(params.get("JOINT_AUX_COND_STEPS", 50))
        self.reference_best_of_k_bug = True
        self.z_class_mean: Optional[torch.Tensor] = None
        self.features = val_features(val_loader)
        self.joint_metrics_history: List[Dict[str, float]] = []
        self.last_metrics: Optional[Dict[str, float]] = None
        self.arch_str = (f"IMG{'-'.join(map(str, layer_sizes_img))}"
                         f"_JOINT{joint_layer_size}")

    def _build_joint(self, Dz_img: int, joint_hidden: int) -> None:
        """Joint RBM over [z_img ⊕ y] (JAX models/imdbn.py:165-184), stored
        in the params' ``DTYPE`` with their ``SR``; ``COMPUTE_DTYPE`` does
        not reach it (the printed ``warn/compute_dtype_joint``)."""
        self.Dz_img = int(Dz_img)
        K = self.num_labels
        p = self.params
        self.joint_rbm = RBM(
            num_visible=self.Dz_img + K, num_hidden=int(joint_hidden),
            learning_rate=p.get("JOINT_LEARNING_RATE",
                                p.get("LEARNING_RATE", 0.1)),
            weight_decay=p.get("WEIGHT_PENALTY", 0.0001),
            momentum=p.get("INIT_MOMENTUM", 0.5),
            dynamic_lr=p.get("LEARNING_RATE_DYNAMIC", True),
            final_momentum=p.get("FINAL_MOMENTUM", 0.95),
            softmax_groups=[(self.Dz_img, self.Dz_img + K)],
            seed=None if self._seed is None else self._seed + 1000,
            device=self.device, dtype=param_dtype(p), sr=param_sr(p))
        _warn_compute_dtype_joint(p, "iMDBN")

    def _joint_groups(self):
        return ((self.Dz_img, self.Dz_img + self.num_labels),)

    def set_mesh(self, mesh) -> None:
        """Train both phases data-parallel over ``mesh`` (a
        ``parallel.Mesh``, a device count, ``"all"``, or None), the image
        iDBN included (JAX models/imdbn.py:189-196). An explicit call,
        None included, overrides ``DP_DEVICES``."""
        from multimodal_idbn_tpu_torch.parallel import resolve_mesh
        self.mesh = resolve_mesh(mesh, self.device)
        self._dp_devices = None
        self.image_idbn.set_mesh(self.mesh)

    def _resolve_mesh(self):
        if self.mesh is None and self._dp_devices:
            self.set_mesh(self._dp_devices)
        return self.mesh

    def to(self, device: DeviceLike = None) -> "iMDBN":
        """Move the whole model to ``device`` (``cuda`` unless ``"cpu"``)."""
        self.device = resolve_device(device)
        self.image_idbn.to(self.device)
        self.joint_rbm.to(self.device)
        if self.z_class_mean is not None:
            self.z_class_mean = self.z_class_mean.to(self.device)
        return self

    def _materialized_train(self, limit: Optional[int] = None):
        """(images [N, D], one-hot [N, K], z_img [N, Dz]) on the device:
        ``materialize()`` where the loader has it, else its batches
        (JAX models/imdbn.py:207-236). ``limit`` caps the rows before
        they are encoded."""
        if hasattr(self.dataloader, "materialize"):
            imgs, y = self.dataloader.materialize()
            imgs, y = np.asarray(imgs), np.asarray(y, np.float32)
        else:
            im_list, y_list, n = [], [], 0
            for bi, bl in self.dataloader:
                im_list.append(np.asarray(bi))
                y_list.append(np.asarray(bl, np.float32))
                n += len(im_list[-1])
                if limit is not None and n >= limit:
                    break
            if not im_list:
                raise RuntimeError("empty dataloader")
            imgs, y = np.concatenate(im_list), np.concatenate(y_list)
        if limit is not None:
            imgs, y = imgs[:limit], y[:limit]
        X = as_tensor(imgs.reshape(len(imgs), -1), self.device)
        Y = as_tensor(y, self.device)
        return X, Y, self.image_idbn.represent(X)

    def init_joint_bias_from_data(self, n_batches: int = 10,
                                  _cached=None) -> None:
        """Joint visible biases and per-class latent means from the first
        ``n_batches`` batches' worth of samples (JAX models/imdbn.py:239-268).
        """
        limit = int(n_batches) * int(getattr(self.dataloader, "batch_size",
                                             128))
        _, Y, Z = _cached if _cached is not None \
            else self._materialized_train(limit)
        Z, Y = Z[:limit], Y[:limit]
        if Z.shape[0] == 0:
            return
        z_bias, y_bias, self.z_class_mean = graphs.serve(
            self, self.device, imdbn_ops.joint_bias_stats, None, Z, Y,
            num_classes=self.num_labels)
        vb = self.joint_rbm.vis_bias.clone()
        vb[:self.Dz_img] = z_bias
        vb[self.Dz_img:self.Dz_img + self.num_labels] = y_bias
        self.joint_rbm.vis_bias = vb

    # -- pretrained iDBN loading and fine-tuning (JAX :272-338) --------------

    def load_pretrained_image_idbn(self, path: str) -> bool:
        """Adopt the layers of a pickled iDBN on this model's device, with
        their momentum re-zeroed; the joint RBM is rebuilt if the top
        width changed. False when the file cannot be used."""
        layers = load_pretrained_layers(path, "load_pretrained_image_idbn",
                                        self.device)
        if layers is None:
            return False
        self.image_idbn.layers = layers
        dz_pre = int(layers[-1].num_hidden)
        if dz_pre != self.Dz_img:
            print(f"[load_pretrained_image_idbn] rebuilding joint: "
                  f"Dz_img -> {dz_pre}")
            self._build_joint(dz_pre, self.joint_rbm.num_hidden)
        return True

    def finetune_image_last_layer(self, epochs: int = 0,
                                  lr_scale: float = 0.3,
                                  cd_k: Optional[int] = None) -> None:
        """Fine-tune the top image RBM at a reduced learning rate on the
        training loader's batches (JAX models/imdbn.py:312-338)."""
        if epochs <= 0:
            return
        print(f"[finetune_image_last_layer] epochs={epochs}, "
              f"lr_scale={lr_scale:.4g}")
        finetune_last_layer(self.image_idbn, self.dataloader, epochs,
                            lr_scale, cd_k)
        print("[finetune_image_last_layer] done")

    # -- cross-modal inference (JAX :342-449) ---------------------------------

    def _z_affine(self):
        scale = getattr(self, "z_affine_scale", None)
        bias = getattr(self, "z_affine_bias", None)
        if scale is None or bias is None:
            return None
        return (torch.as_tensor(scale, dtype=torch.float32).to(self.device),
                torch.as_tensor(bias, dtype=torch.float32).to(self.device))

    def _cross_reconstruct(self, z_img, y_onehot,
                           steps: Optional[int] = None,
                           direction: str = "both"):
        """IMG→TXT + TXT→IMG round trip; returns (decoded images,
        p(y|img)), the half ``direction`` skips being None
        (JAX models/imdbn.py:342-366)."""
        return self._cross_call(z_img, y_onehot, steps, direction)()

    def _cross_call(self, z_img, y_onehot, steps: Optional[int] = None,
                    direction: str = "both"):
        """The serving call of ``_cross_reconstruct`` with its arguments
        made (the inputs on the device, the key drawn, the weights
        gathered), to be called."""
        return functools.partial(
            graphs.serve, self, self.device, imdbn_ops.cross_reconstruct,
            self.joint_rbm._next_key(),
            rbm_ops.weights_only(self.joint_rbm.state),
            self.image_idbn._weights(),
            z_img=as_tensor(z_img, self.device),
            y_onehot=as_tensor(y_onehot, self.device),
            steps=int(self.cross_steps if steps is None else steps),
            Dz=self.Dz_img, groups=self._joint_groups(),
            z_class_mean=self.z_class_mean, z_affine=self._z_affine(),
            use_free_energy=not self.reference_best_of_k_bug,
            direction=direction)

    def img2txt(self, images) -> torch.Tensor:
        """Label posterior p(y|img) [B, K] for raw images [B, D] or
        [B, H, W]: the IMG→TXT half (mean-field conditional Gibbs with the
        z block clamped; one chain-kernel launch on the card)."""
        with span("serve.inputs"):
            z = self.image_idbn.represent(images)
            y0 = torch.zeros((z.shape[0], self.num_labels),
                             device=self.device)
            call = self._cross_call(z, y0, direction="img2txt")
        return call()[1]

    def _labels_to_onehot(self, labels) -> np.ndarray:
        """Integer class ids [B] or one-hot [B, K] -> validated one-hot
        float32 (JAX models/imdbn.py:383-398)."""
        if isinstance(labels, torch.Tensor):
            labels = labels.detach().cpu().numpy()
        y = np.asarray(labels)
        if y.ndim == 1:
            ids = y.astype(np.int64)
            if ids.size and (ids.min() < 0 or ids.max() >= self.num_labels):
                raise ValueError(
                    f"label ids must be in [0, {self.num_labels}); got "
                    f"range [{ids.min()}, {ids.max()}]")
            y = np.eye(self.num_labels, dtype=np.float32)[ids]
        elif y.shape[-1] != self.num_labels:
            raise ValueError(
                f"one-hot labels must have width {self.num_labels}; got "
                f"{y.shape}")
        return y.astype(np.float32)

    def txt2img(self, labels) -> torch.Tensor:
        """Decoded images [B, D] from integer class ids [B] or one-hot
        labels [B, K]: the TXT→IMG half (noisy mean-field annealing with
        μ-pull, one chain-kernel launch, decoded through the image iDBN)."""
        with span("serve.inputs"):
            y = self._labels_to_onehot(labels)
            z0 = torch.zeros((y.shape[0], self.Dz_img), device=self.device)
            call = self._cross_call(z0, y, direction="txt2img")
        return call()[0]

    def sample_txt2img(self, labels, gibbs_steps: Optional[int] = None,
                       seed: Optional[int] = None) -> torch.Tensor:
        """Generate images from labels: sampled conditional Gibbs on the
        joint RBM (y clamped, h and v sampled each step), then the
        ancestral-sampled decode (``imdbn_ops.sample_txt2img``). Returns
        pixel probabilities [B, D] of the sampled configuration; ``seed``
        fixes the draw (JAX models/imdbn.py:411-439)."""
        with span("serve.inputs"):
            y = as_tensor(self._labels_to_onehot(labels), self.device)
            steps = int(self.cross_steps if gibbs_steps is None
                        else gibbs_steps)
            key = rng.fold_in(seed, 0) if seed is not None \
                else self.joint_rbm._next_key()
            call = functools.partial(
                graphs.serve, self, self.device, imdbn_ops.sample_txt2img,
                key, rbm_ops.weights_only(self.joint_rbm.state),
                self.image_idbn._weights(), y_onehot=y, steps=steps,
                Dz=self.Dz_img, groups=self._joint_groups(),
                z_affine=self._z_affine())
        return call()[0]

    def represent(self, batch) -> torch.Tensor:
        """Joint hidden activations for (images, one-hot labels)
        (JAX models/imdbn.py:441-449)."""
        img, y = batch
        z = self.image_idbn.represent(img)
        return self.joint_rbm.forward(
            torch.cat([z, as_tensor(y, self.device)], dim=1))

    # -- joint training (JAX :453-700) ------------------------------------------

    def _train_joint_epoch(self, epoch, X, Y, Z, bs, idbn_states,
                           aux_cond_steps, metrics_every,
                           runners: dict) -> List[float]:
        """One fused joint epoch: the split permuted by this epoch's key,
        its full batches, then the remainder
        (``imdbn_ops.joint_epoch_body``), through the runner of its
        setting in ``runners`` (warm-up or main, made at first use: graphed
        on a CUDA device without a mesh, class docstring); sets
        ``last_metrics``. Returns the free-CD losses, one per batch (none
        in the warm-up), as JAX models/imdbn.py:576-597 collects them."""
        jr = self.joint_rbm
        warmup = epoch < WARMUP_Y_EPOCHS
        statics = dict(
            warmup=warmup, joint_cd=self.joint_cd,
            aux_cond_steps=aux_cond_steps, Dz=self.Dz_img,
            steps=self.cross_steps, groups=self._joint_groups(),
            use_free_energy=not self.reference_best_of_k_bug,
            zclamp_every=ZCLAMP_EVERY, batch_size=bs,
            metrics_every=metrics_every, sr=jr.sr, mesh=self.mesh)
        if warmup not in runners:
            runners[warmup] = imdbn_ops.joint_epoch_runner(
                Z, Y, X, idbn_states, self.z_class_mean, jr.weight_decay,
                graphed=self.device.type == "cuda" and self.mesh is None,
                **statics)
        joint, cd_losses, totals = imdbn_ops.joint_epoch_block(
            jr.state, idbn_states, int(self.params.get("SEED", 0)) + 7, Z,
            Y, X, [epoch], [effective_lr(jr.lr, epoch, jr.dynamic_lr)],
            [effective_momentum(jr.momentum, jr.final_momentum, epoch)],
            jr.weight_decay, self.z_class_mean, runner=runners[warmup],
            **statics)
        jr.state = joint
        with span("epoch.read"):
            tot = {k: float(v) for k, v in totals[0]._asdict().items()}
            losses = [float(c) for c in cd_losses[0]]
        self._set_last_metrics(epoch, tot, X.shape[1])
        return losses

    def _set_last_metrics(self, epoch: int, tot: dict, npix: int) -> None:
        """``last_metrics`` from an epoch's metric sums, appended to
        ``joint_metrics_history``; None for an epoch without metrics."""
        self.last_metrics = None
        if tot["n"] > 0:
            self.last_metrics = {
                "cross_modality/text_top1": tot["top1"] / tot["n"],
                "cross_modality/text_top3": tot["top3"] / tot["n"],
                "cross_modality/text_ce": tot["ce_sum"] / tot["n"],
                "cross_modality/image_mse":
                    tot["mse_sum"] / max(1.0, tot["n"] * npix),
            }
            self.joint_metrics_history.append(
                dict(self.last_metrics, epoch=epoch))

    def _train_joint_epoch_batched(self, epoch, epochs, warmup,
                                   aux_cond_steps, metrics_every: int = 1):
        """The reference's per-batch loop for loaders that cannot
        materialize (JAX models/imdbn.py:700-760): each batch's latents,
        then the joint RBM's own updates (``train_epoch``, and
        ``train_epoch_clamped`` with its noisy init on the chain kernel)
        and the cross-modal round trip, keyed from its stream, in the
        order the shell calls draw them. A batch is one call of
        ``_joint_batch_step``, one graph replay on the card; its losses
        and metric sums stay on the device until the epoch's one host
        read. Returns (free-CD losses, metric sums, pixels per image)."""
        jr = self.joint_rbm
        mu_k, eta0 = jr._mu_pull_args()
        statics = dict(
            warmup=bool(warmup), Dz=self.Dz_img, K=self.num_labels,
            train=dict(groups=jr._groups(), sr=jr.sr,
                       weight_decay=jr.weight_decay, cd=int(self.joint_cd),
                       sparsity=jr.sparsity,
                       sparsity_factor=jr.sparsity_factor),
            clamp=dict(weight_decay=jr.weight_decay, cd=1,
                       cond_init_steps=int(aux_cond_steps), sample_h=False,
                       sample_v=False, aux_lr_mult=0.3, use_noisy_init=True,
                       eta0=eta0, groups=jr._groups(), sr=jr.sr),
            cross=dict(steps=int(self.cross_steps), Dz=self.Dz_img,
                       groups=self._joint_groups(),
                       use_free_energy=not self.reference_best_of_k_bug,
                       direction="both"))
        hyper = graphs.hyper(
            self.device, effective_lr(jr.lr, epoch, jr.dynamic_lr),
            effective_momentum(jr.momentum, jr.final_momentum, epoch))
        outs = []
        npix = None
        for b_idx, (img, y) in enumerate(self.dataloader):
            img = as_tensor(img, self.device)
            img = img.reshape(img.shape[0], -1)
            y = as_tensor(y, self.device)
            zclamp = not warmup and b_idx % ZCLAMP_EVERY == 0
            metrics = metrics_every <= 1 or b_idx % metrics_every == 0
            n_keys = 2 + int(zclamp) + int(metrics)
            jr.state, out = graphs.update(
                self, self.device, _joint_batch_step,
                tuple(jr._next_key() for _ in range(n_keys)), jr.state,
                self.image_idbn._weights(), img, y, hyper,
                self.z_class_mean, self._z_affine(), mu_k, zclamp=zclamp,
                metrics=metrics, **statics)
            outs.append(out)
            npix = img.shape[1]
        leaves, spec = graphs.flatten(outs)
        outs = graphs.unflatten(spec, torch.stack(leaves).tolist()
                                if leaves else [])
        cd_losses = []
        tot = {"n": 0.0, "top1": 0.0, "top3": 0.0, "ce_sum": 0.0,
               "mse_sum": 0.0}
        for cd_loss, m in outs:
            if cd_loss is not None:
                cd_losses.append(float(cd_loss))
            if m is not None:
                for k, v in m._asdict().items():
                    tot[k] += float(v)
        return cd_losses, tot, npix

    def train_joint(self, epochs: int, log_every_pca: int = 25,
                    log_every_probe: int = 10, log_every: int = 5,
                    w_rec: float = 1.0, w_sup: float = 0.0,
                    fused: Optional[bool] = None, start_epoch: int = 0,
                    checkpoint_every: int = 0,
                    checkpoint_path: Optional[str] = None) -> None:
        """Joint training (JAX models/imdbn.py:453-700): the first 8 epochs
        are y-clamped warm-up, then free CD-k + auxiliary clamped CD, with
        the cross-modal round trip and its metrics on every batch (every
        ``CROSS_METRICS_EVERY``-th with that setting). Each epoch is timed
        (``epoch_timer``); with a run object it is logged
        (``_log_joint_epoch``: PCA every ``log_every_pca`` epochs, probes
        every ``log_every_probe``, snapshots every ``log_every``, and the
        extras the logging config enables).

        Crash-safe resume: ``checkpoint_every=N`` + ``checkpoint_path``
        write a resumable checkpoint (joint and image states, momentum,
        ``z_class_mean``, the metrics history) every N epochs and at the
        warm-up boundary; ``start_epoch=k`` continues a restored run, with
        the data-derived bias init skipped, since the restored state holds
        the trained biases. Epoch e draws from ``fold_in(SEED + 7, e)``
        alone, so the resumed run is bit-identical
        (tests/test_torch_resume.py); the per-batch loop draws from the
        joint RBM's stream and the loader's shuffle counter, both restored
        with the checkpoint.

        ``fused=None`` runs the fused epochs when the loader offers
        ``materialize()`` and the per-batch loop otherwise; ``False``
        forces the loop. ``w_rec`` / ``w_sup`` are accepted and unused, as
        in the reference (imdbn.py:534-535).
        """
        del w_rec, w_sup
        print("[iMDBN] joint training (with warmup y-clamp)")
        if fused is None:
            fused = hasattr(self.dataloader, "materialize")
        if self._resolve_mesh() is not None and not fused:
            raise ValueError("data-parallel joint training needs the "
                             "fused epoch path (a dataloader with "
                             ".materialize(), or fused=True)")
        epochs, start_epoch = int(epochs), int(start_epoch)
        check_train_args(start_epoch, epochs, checkpoint_every,
                         checkpoint_path)
        if fused:
            X, Y, Z = self._materialized_train()
        if start_epoch == 0:
            self.init_joint_bias_from_data(
                n_batches=10, _cached=(X, Y, Z) if fused else None)
            self.joint_metrics_history = []
        if not fused:
            align_loader_for_resume(self, start_epoch)
        bs = int(getattr(self.dataloader, "batch_size", 128))
        aux_cond_steps = int(self.params.get("JOINT_AUX_COND_STEPS", 10))
        metrics_every = int(self.params.get("CROSS_METRICS_EVERY", 1))
        idbn_states = self.image_idbn.states()
        runners: dict = {}
        timer = StepTimer(self.device)
        for b_start, b_end in checkpoint_epochs(
                start_epoch, epochs,
                checkpoint_every if checkpoint_path else 0,
                min(WARMUP_Y_EPOCHS, epochs)):
            for epoch in range(b_start, b_end):
                with timer.step():
                    if fused:
                        cd_losses = self._train_joint_epoch(
                            epoch, X, Y, Z, bs, idbn_states,
                            aux_cond_steps, metrics_every, runners)
                    else:
                        cd_losses, tot, npix = \
                            self._train_joint_epoch_batched(
                                epoch, epochs, epoch < WARMUP_Y_EPOCHS,
                                aux_cond_steps, metrics_every)
                        self._set_last_metrics(epoch, tot, npix or 1)
                if self.wandb_run is not None:
                    timer.log_to(self.wandb_run, prefix="perf/joint_epoch",
                                 epoch=epoch)
                    self._log_joint_epoch(epoch, cd_losses, log_every_pca,
                                          log_every_probe, log_every)
            maybe_save_train_checkpoint(self, checkpoint_path,
                                        checkpoint_every, "joint", b_end,
                                        epochs)
        self.epoch_timer = timer
        print("[iMDBN] joint training finished.")

    # -- per-epoch logging (JAX :759-937) --------------------------------------

    def _log_joint_epoch(self, epoch, cd_losses, log_every_pca,
                         log_every_probe, log_every) -> None:
        """Epoch-tail logging (reference imdbn.py:641-710): the CD loss and
        cross-modal metrics, then the joint PCA and probes at their
        cadences, the config-gated extras and the snapshots. A diagnostic
        that fails logs ``warn/*_error`` and training goes on."""
        from multimodal_idbn_tpu_torch.utils.probe_utils import (
            compute_joint_embeddings_and_features, log_joint_linear_probe)
        from multimodal_idbn_tpu_torch.utils.wandb_utils import (
            log_pca_embeddings)
        run = self.wandb_run
        if run is None:
            return
        if cd_losses:
            run.log({"joint/cd_loss": float(np.mean(cd_losses)),
                     "epoch": epoch})
        if self.last_metrics is not None:
            run.log(dict(self.last_metrics, epoch=epoch))

        if self.val_loader is not None and self.features is not None:
            if epoch % log_every_pca == 0:
                try:
                    E, feats = compute_joint_embeddings_and_features(self)
                    if E.numel():
                        log_pca_embeddings(run, E, feature_map(feats),
                                           "Joint_top")
                except Exception as e:  # a diagnostic must not stop training
                    run.log({"warn/joint_pca_error": str(e)})
            if epoch % log_every_probe == 0:
                try:
                    log_joint_linear_probe(self, epoch=epoch, n_bins=5,
                                           test_size=0.2, steps=1000,
                                           lr=1e-2, patience=20,
                                           min_delta=0.0,
                                           metric_prefix="joint")
                except Exception as e:
                    run.log({"warn/joint_probe_error": str(e)})

        self._log_config_gated(epoch)
        if epoch % max(1, int(log_every)) == 0:
            self._log_snapshots(epoch)

    def _get_log_cfg(self, section: str) -> dict:
        """Section of the YAML ``logging:`` tree (reference monolith
        gdbn_model_complete.py:691)."""
        cfg = self.logging_cfg or {}
        if "logging" in cfg and isinstance(cfg["logging"], dict):
            cfg = cfg["logging"]
        sec = cfg.get(section, {})
        return sec if isinstance(sec, dict) else {}

    def _log_cadence(self, name: str, default: int) -> int:
        cfg = self.logging_cfg or {}
        if "logging" in cfg and isinstance(cfg["logging"], dict):
            cfg = cfg["logging"]
        return max(1, int(cfg.get(name, default)))

    def _log_config_gated(self, epoch: int) -> None:
        """The config-gated extras (JAX models/imdbn.py:845-915): energy
        trace, cross-modal convergence panel and z-mismatch check,
        vector-DB neighbours, trajectories and the joint auto-recon. Each
        gate defaults off like the shipped YAML."""
        from multimodal_idbn_tpu_torch.utils import (conditional_steps,
                                                     energy_utils,
                                                     imdbn_logging)
        run = self.wandb_run
        if run is None:
            return
        energy_cfg = self._get_log_cfg("energy")
        if (energy_cfg.get("enable", False)
                and epoch % self._log_cadence("log_every_energy", 50) == 0):
            try:
                energy_utils.run_and_log_fixed_case(self, epoch=epoch)
            except Exception as e:
                run.log({"warn/energy_error": str(e)})

        conv_cfg = self._get_log_cfg("convergence")
        if (conv_cfg.get("enable", False)
                and epoch % self._log_cadence("log_every_convergence",
                                              25) == 0):
            try:
                if conv_cfg.get("panel_analysis", True):
                    conditional_steps.run_and_log_cross_panel(
                        self, epoch=epoch,
                        max_steps=int(conv_cfg.get("num_steps", 50)))
                if conv_cfg.get("z_mismatch_check", True):
                    conditional_steps.run_and_log_z_mismatch_check(
                        self, epoch=epoch)
            except Exception as e:
                run.log({"warn/convergence_error": str(e)})

        nb_cfg = self._get_log_cfg("neighbors")
        if (nb_cfg.get("enable", False)
                and epoch % self._log_cadence("log_every_neighbors",
                                              50) == 0):
            try:
                imdbn_logging.log_vecdb_neighbors_for_traj(
                    self, k=int(nb_cfg.get("k", 5)),
                    metric=nb_cfg.get("similarity_metric", "cosine"),
                    dedup=("image" if nb_cfg.get("deduplicate", True)
                           else "index"))
            except Exception as e:
                run.log({"warn/neighbors_error": str(e)})

        traj_cfg = self._get_log_cfg("trajectory")
        if (traj_cfg.get("enable", False)
                and epoch % self._log_cadence("log_every_trajectory",
                                              50) == 0):
            try:
                for s_idx in range(int(traj_cfg.get("num_samples", 4))):
                    if traj_cfg.get("plot_2d", True):
                        imdbn_logging.log_latent_trajectory_with_recon_panel(
                            self, sample_idx=s_idx, steps=self.cross_steps,
                            tag=f"pca_traj_with_recon/sample{s_idx}")
                if traj_cfg.get("plot_3d", True):
                    imdbn_logging.log_pca3_trajectory_with_recon_panel(
                        self, sample_idx=0, steps=self.cross_steps)
                imdbn_logging.log_joint_auto_recon(self, epoch=epoch)
            except Exception as e:
                run.log({"warn/trajectory_error": str(e)})

    def _log_snapshots(self, epoch: int, num: int = 8) -> None:
        """Reconstruction grid, confusion, image MSE and top-k table of the
        cross-modal round trip on the first validation images (reference
        imdbn.py:715-813): two chain-kernel launches on the card."""
        from multimodal_idbn_tpu_torch.utils.wandb_utils import (
            log_snapshot_panels)
        if (self.wandb_run is None or self.validation_images is None
                or self.validation_labels is None):
            return
        try:
            imgs = as_tensor(self.validation_images[:num], self.device)
            lbls = as_tensor(self.validation_labels[:num], self.device)
            img_from_txt, p_y = self._cross_reconstruct(
                self.image_idbn.represent(imgs), lbls,
                steps=self.cross_steps)
            log_snapshot_panels(
                self.wandb_run, epoch, imgs,
                torch.clamp(img_from_txt, 0, 1), p_y, lbls,
                class_names=getattr(self, "class_names", None))
        except Exception as e:
            self.wandb_run.log({"warn/snap_error": str(e), "epoch": epoch})

    # -- persistence (JAX :941-1071) ---------------------------------------------

    def save_model(self, path: str) -> None:
        """Dual-format pickle payload (reference imdbn.py:815-883): both
        the DBN-compatible ``{"layers", "params"}`` shape and the extended
        iMDBN fields. Parameters are pickled as numpy arrays, so the file
        loads on a machine without a GPU."""
        all_layers = list(self.image_idbn.layers) + [self.joint_rbm]
        payload: Dict[str, Any] = {
            "layers": all_layers,
            "params": self.params,
            "image_idbn": self.image_idbn,
            "joint_rbm": self.joint_rbm,
            "num_labels": self.num_labels,
            "Dz_img": self.Dz_img,
            "arch_str": self.arch_str,
            "features": self.features,
            "metadata": {
                "saved_at": datetime.datetime.now().isoformat(),
                "model_type": "iMDBN",
                "architecture": self.arch_str,
            },
        }
        if self.z_class_mean is not None:
            payload["z_class_mean"] = self.z_class_mean.detach().cpu().numpy()
        for attr in ("z_affine_scale", "z_affine_bias"):
            if getattr(self, attr, None) is not None:
                payload[attr] = np.asarray(
                    torch.as_tensor(getattr(self, attr)).detach().cpu())
        if getattr(self, "class_names", None) is not None:
            payload["class_names"] = self.class_names
        payload["reference_best_of_k_bug"] = bool(
            self.reference_best_of_k_bug)
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        print(f"[iMDBN] Model saved to {path}")
        print(f"[iMDBN] Architecture: {self.arch_str}")
        print(f"[iMDBN] Total layers: {len(all_layers)} "
              f"(image: {len(self.image_idbn.layers)}, joint: 1)")

    def export_npz(self, path: str) -> None:
        """Write the parameters as ``.npz`` in the ``convert`` layout."""
        np.savez(path, **convert.to_numpy(self.image_idbn.states(),
                                          self.joint_rbm.state,
                                          self.z_class_mean,
                                          self._z_affine()))

    @staticmethod
    def load_model(path: str, device: DeviceLike = None) -> Dict[str, Any]:
        """Load a ``save_model`` payload with its RBMs moved to ``device``
        (``cuda`` unless ``"cpu"`` is asked for). Returns the raw dict
        (reference imdbn.py:885-934); ``from_payload`` rebuilds a model."""
        device = resolve_device(device)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        payload["image_idbn"].to(device)
        payload["joint_rbm"].to(device)
        print(f"[iMDBN] Model loaded from {path}")
        if "arch_str" in payload:
            print(f"[iMDBN] Architecture: {payload['arch_str']}")
        if "metadata" in payload:
            print(f"[iMDBN] Saved at: "
                  f"{payload['metadata'].get('saved_at', 'unknown')}")
        return payload

    @classmethod
    def from_payload(cls, payload: Dict[str, Any], dataloader=None,
                     val_loader=None, wandb_run=None) -> "iMDBN":
        """Rebuild a working iMDBN from a ``load_model`` payload, on the
        device its RBMs lie on (JAX models/imdbn.py:1004-1056). The loaded
        ``image_idbn`` / ``joint_rbm`` objects are adopted as they are, so
        all inference paths work at once; training needs a dataloader. A
        payload holds no run object: ``wandb_run`` attaches one."""
        m = cls.__new__(cls)
        # The payload's params object as it is: pickle keeps the identity
        # it shares with image_idbn.params, which a copy would break.
        m.params = payload.get("params") if payload.get("params") \
            is not None else {}
        m.dataloader = dataloader
        m.val_loader = val_loader
        m.wandb_run = wandb_run
        m.logging_cfg = {}
        m.validation_images = m.validation_labels = m.val_batch = None
        m._seed = m.params.get("SEED")
        m.mesh = None
        m._dp_devices = m.params.get("DP_DEVICES")
        m.num_labels = int(payload["num_labels"])
        m.Dz_img = int(payload["Dz_img"])
        m.image_idbn = payload["image_idbn"]
        m.joint_rbm = payload["joint_rbm"]
        m.device = m.joint_rbm.device
        # pickling strips the loaders and the run of the embedded iDBN
        m.image_idbn.dataloader = dataloader
        m.image_idbn.val_loader = val_loader
        m.image_idbn.wandb_run = wandb_run
        m.arch_str = payload.get("arch_str",
                                 f"IMG?_JOINT{m.joint_rbm.num_hidden}")
        m.features = payload.get("features")
        m.joint_cd = int(m.params.get("JOINT_CD", m.params.get("CD", 1)))
        m.cross_steps = int(m.params.get("CROSS_GIBBS_STEPS", 50))
        m.aux_every_k = int(m.params.get("JOINT_AUX_EVERY_K", 0))
        m.aux_cond_steps = int(m.params.get("JOINT_AUX_COND_STEPS", 50))
        m.reference_best_of_k_bug = bool(
            payload.get("reference_best_of_k_bug", True))
        m.joint_metrics_history = []
        m.last_metrics = None
        zcm = payload.get("z_class_mean")
        m.z_class_mean = None if zcm is None else torch.as_tensor(
            np.asarray(zcm, np.float32)).to(m.device)
        for attr in ("z_affine_scale", "z_affine_bias", "class_names"):
            if attr in payload:
                setattr(m, attr, payload[attr])
        return m

    # Loaders and run objects are runtime attachments; device tensors
    # pickle as numpy.
    def __getstate__(self):
        d = dict(self.__dict__)
        d["wandb_run"] = None
        d["dataloader"] = None
        d["val_loader"] = None
        d["device"] = "cpu"
        d["mesh"] = None  # a process group lives with its job, not a file
        d.pop("_serving", None)  # graphs live with their process
        d["val_batch"] = None if self.val_batch is None else tuple(
            np.asarray(x) for x in self.val_batch)
        d["z_class_mean"] = (None if self.z_class_mean is None else
                             self.z_class_mean.detach().cpu().numpy())
        return d

    def __setstate__(self, d):
        # pickles written before the diagnostics hooks lack their fields
        for k in ("wandb_run", "validation_images", "validation_labels",
                  "features", "mesh", "_dp_devices", "val_batch"):
            d.setdefault(k, None)
        d.setdefault("logging_cfg", {})
        params = d.get("params") or {}
        d.setdefault("aux_every_k", int(params.get("JOINT_AUX_EVERY_K", 0)))
        d.setdefault("aux_cond_steps",
                     int(params.get("JOINT_AUX_COND_STEPS", 50)))
        self.__dict__.update(d)
        self.device = torch.device("cpu")
        if d.get("z_class_mean") is not None:
            self.z_class_mean = torch.from_numpy(
                np.array(d["z_class_mean"], np.float32))
