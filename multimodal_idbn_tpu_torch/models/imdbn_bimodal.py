"""iMDBN_BiModal: two modality iDBNs joined by a multi-layer joint DBN.

Port of multimodal_idbn_tpu/models/imdbn_bimodal.py:324-828 and
:1013-1056: the constructor (seed offsets +100 for MOD2, +2000+i for joint
layer i), pretrained modality DBNs and the last-layer fine-tunes
(:447-516), ``init_joint_bias_from_data``, the cross-modal inference
(``_cross_reconstruct``, ``mod1_to_mod2``, ``mod2_to_mod1``, the sampled
``sample_mod1_to_mod2`` / ``sample_mod2_to_mod1``, ``represent``),
``train_joint`` over materialized loaders with crash-safe resume (8
warm-up epochs, then free CD down the joint stack plus the aux clamps;
``ops.bimodal_ops``), and the pickle ``save_model`` / ``load_model``.
Modality latents are computed once per joint run, as the modality iDBNs
are frozen there. W&B, probe, PCA and trajectory logging, the per-batch
loop over loaders that cannot materialize and data parallelism are not
ported.
"""

from __future__ import annotations

import datetime
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_idbn_tpu_torch import convert
from multimodal_idbn_tpu_torch.checkpoint import (checkpoint_epochs,
                                                  maybe_save_train_checkpoint)
from multimodal_idbn_tpu_torch.device import (DeviceLike, as_tensor,
                                              resolve_device)
from multimodal_idbn_tpu_torch.models.idbn import iDBN, check_train_args
from multimodal_idbn_tpu_torch.models.imdbn import (finetune_last_layer,
                                                    load_pretrained_layers)
from multimodal_idbn_tpu_torch.models.rbm import RBM
from multimodal_idbn_tpu_torch.ops import bimodal_ops, dbn_train, rng
from multimodal_idbn_tpu_torch.ops.schedules import (effective_lr,
                                                     effective_momentum)

# Hard-coded in the reference (JAX models/imdbn_bimodal.py:30).
WARMUP_EPOCHS = 8


class iMDBN_BiModal:
    """Bimodal DBN: two modality iDBNs + a joint DBN stack over
    [z_mod1 ⊕ z_mod2] with no softmax groups; ``joint_rbm`` is joint
    layer 0 (JAX models/imdbn_bimodal.py:324-443).

    ``dataloader`` yields (mod1, mod2) batches and offers
    ``materialize()``; the modality iDBNs are trained on their own loaders
    (``train_bimodal``).
    """

    def __init__(self, layer_sizes_mod1: List[int],
                 layer_sizes_mod2: List[int],
                 joint_layer_sizes: Union[int, Sequence[int]],
                 params: Optional[dict] = None, dataloader=None,
                 val_loader=None, device: DeviceLike = None,
                 seed: Optional[int] = None):
        self.params = params or {}
        self.device = resolve_device(device)
        self.dataloader = dataloader
        self.val_loader = val_loader
        self.mod1_dbn = iDBN(layer_sizes_mod1, self.params, None,
                             device=self.device, seed=seed)
        self.mod2_dbn = iDBN(layer_sizes_mod2, self.params, None,
                             device=self.device,
                             seed=None if seed is None else seed + 100)
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
                device=self.device))
            visible = int(hidden)
        self.joint_rbm = self.joint_layers[0]
        self.num_joint_layers = len(self.joint_layers)
        self.joint_cd = int(self.params.get("JOINT_CD",
                                            self.params.get("CD", 1)))
        self.cross_steps = int(self.params.get("CROSS_GIBBS_STEPS", 50))
        self.features = None
        self.last_metrics: Optional[Dict[str, float]] = None
        self.joint_metrics_history: List[Dict[str, float]] = []
        self.arch_str = (
            f"MOD1{'-'.join(map(str, layer_sizes_mod1))}"
            f"_MOD2{'-'.join(map(str, layer_sizes_mod2))}"
            f"_JOINT{'-'.join(map(str, joint_layer_sizes))}")

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
        return bimodal_ops.bimodal_cross_reconstruct(
            self.joint_rbm.state, self.mod1_dbn.states(),
            self.mod2_dbn.states(), self.joint_rbm._next_key(),
            as_tensor(z_mod1, self.device), as_tensor(z_mod2, self.device),
            steps=int(self.cross_steps if steps is None else steps),
            Dz1=self.Dz_mod1, direction=direction)

    def mod1_to_mod2(self, mod1_images) -> torch.Tensor:
        """Decoded modality-2 images from raw modality-1 images."""
        z1 = self.mod1_dbn.represent(mod1_images)
        z2 = torch.zeros((z1.shape[0], self.Dz_mod2), device=self.device)
        return self._cross_reconstruct(z1, z2, direction="1to2")[1]

    def mod2_to_mod1(self, mod2_images) -> torch.Tensor:
        """Decoded modality-1 images from raw modality-2 images."""
        z2 = self.mod2_dbn.represent(mod2_images)
        z1 = torch.zeros((z2.shape[0], self.Dz_mod1), device=self.device)
        return self._cross_reconstruct(z1, z2, direction="2to1")[0]

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
        if direction == "1to2":
            z1 = self.mod1_dbn.represent(images)
            z2 = torch.zeros((z1.shape[0], self.Dz_mod2), device=self.device)
        else:
            z2 = self.mod2_dbn.represent(images)
            z1 = torch.zeros((z2.shape[0], self.Dz_mod1), device=self.device)
        steps = int(self.cross_steps if gibbs_steps is None else gibbs_steps)
        key = rng.fold_in(seed, 0) if seed is not None \
            else self.joint_rbm._next_key()
        return bimodal_ops.sample_cross(
            self.joint_rbm.state, self.mod1_dbn.states(),
            self.mod2_dbn.states(), key, z1, z2, steps=steps,
            Dz1=self.Dz_mod1, direction=direction)

    def represent(self, batch) -> torch.Tensor:
        """Joint representation through all joint layers (JAX :616-625)."""
        z1, z2 = self._latents(*batch)
        return dbn_train.dbn_represent(self._joint_states(),
                                       torch.cat([z1, z2], dim=1),
                                       upto=self.num_joint_layers)

    # -- joint training (JAX :653-828) --------------------------------------

    def train_joint(self, epochs: int, start_epoch: int = 0,
                    checkpoint_every: int = 0,
                    checkpoint_path: Optional[str] = None) -> None:
        """Alternating-modality warm-up for the first ``WARMUP_EPOCHS``
        epochs, then free CD down the joint stack + the aux clamps, with
        the cross-reconstruction metrics on every ``CROSS_METRICS_EVERY``-th
        batch (JAX models/imdbn_bimodal.py:653-828). Epoch e permutes the
        split and keys its batches from ``fold_in(SEED + 11, e)`` alone
        and trains its full batches and then the remainder
        (``bimodal_ops.bimodal_epoch``).

        ``start_epoch`` / ``checkpoint_every`` / ``checkpoint_path``:
        crash-safe resume under the contract of ``iMDBN.train_joint``
        (phase tag "bimodal_joint"; bit-identical,
        tests/test_torch_resume.py).
        """
        epochs, start_epoch = int(epochs), int(start_epoch)
        check_train_args(start_epoch, epochs, checkpoint_every,
                         checkpoint_path)
        print(f"[iMDBN_BiModal] joint training: {self.num_joint_layers} "
              f"layers, {epochs} epochs total")
        if start_epoch == 0:
            self.init_joint_bias_from_data(n_batches=10)
            self.joint_metrics_history = []
        m1, m2 = self.dataloader.materialize()
        V1, V2 = as_tensor(m1, self.device), as_tensor(m2, self.device)
        Z1, Z2 = self._latents(V1, V2)
        bs = int(getattr(self.dataloader, "batch_size", 128))
        n = Z1.shape[0]
        aux_cond_steps = int(self.params.get("JOINT_AUX_COND_STEPS", 30))
        metrics_every = int(self.params.get("CROSS_METRICS_EVERY", 1))
        mod1_states = self.mod1_dbn.states()
        mod2_states = self.mod2_dbn.states()
        npix1, npix2 = V1.shape[1], V2.shape[1]
        jr = self.joint_rbm
        seed = int(self.params.get("SEED", 0)) + 11
        for b_start, b_end in checkpoint_epochs(
                start_epoch, epochs,
                checkpoint_every if checkpoint_path else 0,
                min(WARMUP_EPOCHS, epochs)):
            for epoch in range(b_start, b_end):
                key = rng.fold_in(seed, epoch)
                perm = rng.permutation(key, n).to(self.device)
                joint, _, _, totals = bimodal_ops.bimodal_epoch(
                    self._joint_states(), mod1_states, mod2_states, key,
                    Z1[perm], Z2[perm], V1[perm], V2[perm],
                    effective_lr(jr.lr, epoch, jr.dynamic_lr),
                    effective_momentum(jr.momentum, jr.final_momentum,
                                       epoch),
                    jr.weight_decay, warmup=epoch < WARMUP_EPOCHS,
                    joint_cd=self.joint_cd, aux_cond_steps=aux_cond_steps,
                    Dz1=self.Dz_mod1, steps=self.cross_steps, batch_size=bs,
                    metrics_every=metrics_every)
                self._set_joint_states(joint)
                tot = {k: float(v) for k, v in totals._asdict().items()}
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
            maybe_save_train_checkpoint(self, checkpoint_path,
                                        checkpoint_every, "bimodal_joint",
                                        b_end, epochs)
        print("[iMDBN_BiModal] joint training finished.")

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
        d["dataloader"] = None
        d["val_loader"] = None
        d["device"] = "cpu"
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.device = torch.device("cpu")
