"""Carry parameters between the JAX package and the port as numpy arrays.

Each layout is a flat mapping of names to arrays, written as ``.npz`` by a
model's ``export_npz``. The iMDBN layout (``models.imdbn.iMDBN``):

- ``image.{i}.{field}`` for image layer i,
- ``joint.{field}`` for the joint RBM,
- optional ``z_class_mean``, ``z_affine_scale``, ``z_affine_bias``.

The bimodal layout (``models.imdbn_bimodal.iMDBN_BiModal``):
``mod1.{i}.{field}``, ``mod2.{i}.{field}`` and ``joint.{i}.{field}`` for
layer i of each modality iDBN and of the joint stack.

``field`` runs over ``w, hb, vb, w_m, hb_m, vb_m``, the fields of the JAX
package's ``RBMState`` (multimodal_idbn_tpu/ops/rbm_ops.py:36-44). From
JAX: ``{f"image.{i}.{k}": np.asarray(v) for k, v in st._asdict().items()}``.

``layout_from_checkpoint`` and ``checkpoint_from_layout`` rename between
these layouts and the array names of the npz checkpoints that both
packages' ``checkpoint.save_checkpoint`` write
(``image_idbn/layer{i}/{field}``, ``joint_rbm/{field}``,
``mod1_dbn/layer{i}/{field}``, ``mod2_dbn/layer{i}/{field}``,
``joint/layer{i}/{field}``), so a checkpoint of either package can be read
as a layout and a layout written as a checkpoint the other package's
``load_checkpoint`` takes.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import re

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
    """fp32 numpy fields of a state (a bf16 state widened exactly)."""
    return {f"{prefix}{f}": getattr(state, f).detach().cpu().float().numpy()
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


# (checkpoint prefix, layout prefix) of each RBM family; {i} is the layer
_PREFIXES = (("image_idbn/layer{i}/", "image.{i}."),
             ("joint_rbm/", "joint."),
             ("mod1_dbn/layer{i}/", "mod1.{i}."),
             ("mod2_dbn/layer{i}/", "mod2.{i}."),
             ("joint/layer{i}/", "joint.{i}."))
_SHARED = ("z_class_mean", "z_affine_scale", "z_affine_bias")


def _rename(arrays: Mapping[str, np.ndarray], src: int
            ) -> Dict[str, np.ndarray]:
    """``arrays`` renamed from column ``src`` of ``_PREFIXES`` to the other
    column; names of neither an RBM field nor ``_SHARED`` are dropped."""
    rules = [(re.compile("^" + re.escape(pair[src]).replace(
        re.escape("{i}"), r"(\d+)") + "(" + "|".join(FIELDS) + ")$"),
        pair[1 - src]) for pair in _PREFIXES]
    out = {}
    for name, arr in arrays.items():
        if name in _SHARED:
            out[name] = np.asarray(arr)
            continue
        for pattern, template in rules:
            m = pattern.match(name)
            if m:
                *layer, field = m.groups()
                out[template.format(i=layer[0] if layer else "")
                    + field] = np.asarray(arr)
                break
    return out


def layout_from_checkpoint(arrays: Mapping[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
    """The arrays of an npz checkpoint (of an iMDBN or an iMDBN_BiModal,
    written by either package) under this module's layout names. Stream
    positions, extras and the meta record are left out."""
    return _rename(arrays, 0)


def checkpoint_from_layout(arrays: Mapping[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
    """A layout's arrays under the checkpoint names; ``np.savez`` of the
    result is a file both packages' ``load_checkpoint`` take."""
    return _rename(arrays, 1)
