"""Carry parameters between the JAX package and the port as numpy arrays.

Each layout is a flat mapping of names to arrays, written as ``.npz`` by a
model's ``save_model``. The iMDBN layout (``models.imdbn.iMDBN``):

- ``image.{i}.{field}`` for image layer i,
- ``joint.{field}`` for the joint RBM,
- optional ``z_class_mean``, ``z_affine_scale``, ``z_affine_bias``.

The bimodal layout (``models.imdbn_bimodal.iMDBN_BiModal``):
``mod1.{i}.{field}``, ``mod2.{i}.{field}`` and ``joint.{i}.{field}`` for
layer i of each modality iDBN and of the joint stack.

``field`` runs over ``w, hb, vb, w_m, hb_m, vb_m``, the fields of the JAX
package's ``RBMState`` (multimodal_idbn_tpu/ops/rbm_ops.py:36-44). From
JAX: ``{f"image.{i}.{k}": np.asarray(v) for k, v in st._asdict().items()}``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_idbn_tpu_torch.ops.rbm_ops import RBMState

FIELDS = ("w", "hb", "vb", "w_m", "hb_m", "vb_m")


def state_from_numpy(arrays: Mapping[str, np.ndarray], prefix: str,
                     device=None) -> RBMState:
    return RBMState(*(torch.as_tensor(np.asarray(arrays[f"{prefix}{f}"],
                                                 np.float32)).to(device)
                      for f in FIELDS))


def state_to_numpy(state: RBMState, prefix: str) -> Dict[str, np.ndarray]:
    return {f"{prefix}{f}": getattr(state, f).detach().cpu().numpy()
            for f in FIELDS}


def _stack_from_numpy(arrays: Mapping[str, np.ndarray], name: str,
                      device=None) -> List[RBMState]:
    states = []
    while f"{name}.{len(states)}.w" in arrays:
        states.append(state_from_numpy(arrays, f"{name}.{len(states)}.",
                                       device))
    return states


def from_jax_numpy(arrays: Mapping[str, np.ndarray], device=None) -> dict:
    """Flat numpy layout -> {"image": [RBMState], "joint": RBMState | None,
    "z_class_mean": tensor | None, "z_affine": (scale, bias) | None}."""
    out = {
        "image": _stack_from_numpy(arrays, "image", device),
        "joint": (state_from_numpy(arrays, "joint.", device)
                  if "joint.w" in arrays else None),
        "z_class_mean": None,
        "z_affine": None,
    }
    if "z_class_mean" in arrays:
        out["z_class_mean"] = torch.as_tensor(
            np.asarray(arrays["z_class_mean"], np.float32)).to(device)
    if "z_affine_scale" in arrays and "z_affine_bias" in arrays:
        out["z_affine"] = tuple(
            torch.as_tensor(np.asarray(arrays[k], np.float32)).to(device)
            for k in ("z_affine_scale", "z_affine_bias"))
    return out


def to_numpy(image: Sequence[RBMState], joint: Optional[RBMState] = None,
             z_class_mean: Optional[torch.Tensor] = None,
             z_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Dict[str, np.ndarray]:
    """The port's states -> the flat numpy layout of ``from_jax_numpy``."""
    out: Dict[str, np.ndarray] = {}
    for i, st in enumerate(image):
        out.update(state_to_numpy(st, f"image.{i}."))
    if joint is not None:
        out.update(state_to_numpy(joint, "joint."))
    if z_class_mean is not None:
        out["z_class_mean"] = z_class_mean.detach().cpu().numpy()
    if z_affine is not None:
        out["z_affine_scale"], out["z_affine_bias"] = (
            t.detach().cpu().numpy() for t in z_affine)
    return out


def bimodal_from_numpy(arrays: Mapping[str, np.ndarray], device=None
                       ) -> Dict[str, List[RBMState]]:
    """Flat numpy bimodal layout -> {"mod1": [RBMState], "mod2": [...],
    "joint": [...]}."""
    return {name: _stack_from_numpy(arrays, name, device)
            for name in ("mod1", "mod2", "joint")}


def bimodal_to_numpy(mod1: Sequence[RBMState], mod2: Sequence[RBMState],
                     joint: Sequence[RBMState]) -> Dict[str, np.ndarray]:
    """The port's bimodal states -> the flat numpy bimodal layout."""
    out: Dict[str, np.ndarray] = {}
    for name, states in (("mod1", mod1), ("mod2", mod2), ("joint", joint)):
        for i, st in enumerate(states):
            out.update(state_to_numpy(st, f"{name}.{i}."))
    return out
