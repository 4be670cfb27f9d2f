"""Reference-compatible pickle export / import.

Copy of multimodal_idbn_tpu/checkpoint/reference_pickle.py:1-322 (numpy
only, but for ``_shim_rbm_to_framework``, :238-265, which builds the
port's ``RBM`` here), so the port imports nothing of the JAX package. The
same weights exported by either package give equal arrays and equal
``NumpyDBN.represent`` / ``decode`` (tests/test_torch_checkpoint.py).

The reference's save format is a pickle of live torch ``RBM`` objects in a
dual-format dict (SURVEY.md §2.1(13)); downstream adapters unpickle it and
poke ``W / hid_bias / vis_bias / num_hidden`` and call
``forward / backward`` on the layers (reference
INTEGRATION_PROMPT.md:90-247).

Export: we emit the same dict shape with :class:`NumpyRBM` /
:class:`NumpyDBN` shims — plain numpy-backed objects with working
``forward``/``backward``/``visible_probs``/``sample_visible`` — so
DBNAdapter-style consumers work without torch OR jax.

Import: unpickles reference payloads (including old Groundeep pickles that
reference ``src.classes.*`` module paths, reference
imdbn/models/__init__.py:12-35) by installing tolerant class shims, then
converts every torch-tensor-bearing RBM into the port's ``RBM`` on the
asked-for device (``cuda`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import numpy as np


def _np(x) -> np.ndarray:
    """torch tensor / numpy → numpy float32 (a bf16 state widened
    exactly: the reference is fp32, as the JAX export writes it)."""
    if hasattr(x, "detach"):  # torch
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class NumpyRBM:
    """Torch-free RBM shim with the adapter attribute/method contract
    (INTEGRATION_PROMPT.md:136-147, :220-231)."""

    def __init__(self, W, hid_bias, vis_bias, softmax_groups=None,
                 lr=0.1, weight_decay=1e-4, momentum=0.5,
                 final_momentum=0.97):
        self.W = _np(W)
        self.hid_bias = _np(hid_bias)
        self.vis_bias = _np(vis_bias)
        self.num_visible = int(self.W.shape[0])
        self.num_hidden = int(self.W.shape[1])
        self.softmax_groups = [tuple(g) for g in (softmax_groups or [])]
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.momentum = float(momentum)
        self.final_momentum = float(final_momentum)
        self.W_m = np.zeros_like(self.W)
        self.hb_m = np.zeros_like(self.hid_bias)
        self.vb_m = np.zeros_like(self.vis_bias)

    def to(self, device=None):
        return self

    def forward(self, v, T: float = 1.0) -> np.ndarray:
        v = _np(v).reshape(len(v), -1)
        return _sigmoid((v @ self.W + self.hid_bias) / max(1e-6, T))

    def _visible_logits(self, h, T: float = 1.0) -> np.ndarray:
        h = _np(h)
        return (h @ self.W.T + self.vis_bias) / max(1e-6, T)

    def visible_probs(self, h, T: float = 1.0) -> np.ndarray:
        logits = self._visible_logits(h, T)
        p = _sigmoid(logits)
        for s, e in self.softmax_groups:
            x = logits[:, s:e] - logits[:, s:e].max(axis=1, keepdims=True)
            ex = np.exp(x)
            p[:, s:e] = ex / ex.sum(axis=1, keepdims=True)
        return p

    def backward(self, h, return_logits: bool = False) -> np.ndarray:
        if return_logits:
            return self._visible_logits(h)
        return self.visible_probs(h)

    def sample_visible(self, v_prob, rng: Optional[np.random.RandomState] = None
                       ) -> np.ndarray:
        rng = rng or np.random
        v_prob = _np(v_prob)
        v = (v_prob > rng.rand(*v_prob.shape)).astype(np.float32)
        for s, e in self.softmax_groups:
            probs = np.clip(v_prob[:, s:e], 1e-8, 1)
            probs = probs / probs.sum(axis=1, keepdims=True)
            idx = np.array([rng.choice(e - s, p=p) for p in probs])
            v[:, s:e] = 0.0
            v[np.arange(len(v)), s + idx] = 1.0
        return v

    def __repr__(self):
        return (f"NumpyRBM({self.num_visible}x{self.num_hidden}, "
                f"groups={self.softmax_groups})")


class NumpyDBN:
    """Torch-free iDBN shim: ``layers`` + represent/decode/reconstruct."""

    def __init__(self, layers: List[NumpyRBM], params: Optional[dict] = None):
        self.layers = list(layers)
        self.params = params or {}
        self.text_flag = False

    def to(self, device=None):
        return self

    def represent(self, x, upto_layer: Optional[int] = None) -> np.ndarray:
        v = _np(x).reshape(len(x), -1)
        L = (len(self.layers) if upto_layer is None
             else max(0, min(len(self.layers), int(upto_layer))))
        for i in range(L):
            v = self.layers[i].forward(v)
        return v

    def decode(self, top) -> np.ndarray:
        cur = _np(top)
        for rbm in reversed(self.layers):
            cur = rbm.backward(cur)
        return cur

    def reconstruct(self, x) -> np.ndarray:
        return self.decode(self.represent(x))


def _rbm_to_shim(rbm) -> NumpyRBM:
    """Framework RBM (or anything with W/hid_bias/vis_bias) → NumpyRBM."""
    return NumpyRBM(
        W=rbm.W, hid_bias=rbm.hid_bias, vis_bias=rbm.vis_bias,
        softmax_groups=getattr(rbm, "softmax_groups", []),
        lr=getattr(rbm, "lr", 0.1),
        weight_decay=getattr(rbm, "weight_decay", 1e-4),
        momentum=getattr(rbm, "momentum", 0.5),
        final_momentum=getattr(rbm, "final_momentum", 0.97))


def export_reference_pickle(model, path: str) -> Dict[str, Any]:
    """Write the reference's dual-format iMDBN payload (SURVEY.md §2.1(13))
    with numpy shims; returns the payload dict. Accepts an ``iMDBN``."""
    import datetime

    img_layers = [_rbm_to_shim(r) for r in model.image_idbn.layers]
    joint = _rbm_to_shim(model.joint_rbm)
    image_idbn = NumpyDBN(img_layers, params=model.params)

    payload: Dict[str, Any] = {
        "layers": img_layers + [joint],
        "params": model.params,
        "image_idbn": image_idbn,
        "joint_rbm": joint,
        "num_labels": model.num_labels,
        "Dz_img": model.Dz_img,
        "arch_str": model.arch_str,
        "features": ({k: np.asarray(v) for k, v in model.features.items()}
                     if getattr(model, "features", None) is not None
                     else None),
        "metadata": {
            "saved_at": datetime.datetime.now().isoformat(),
            "model_type": "iMDBN",
            "architecture": model.arch_str,
            "exporter": "multimodal_idbn_tpu_torch",
        },
    }
    if getattr(model, "z_class_mean", None) is not None:
        payload["z_class_mean"] = _np(model.z_class_mean)
    if getattr(model, "z_affine_scale", None) is not None:
        payload["z_affine_scale"] = _np(model.z_affine_scale)
    if getattr(model, "z_affine_bias", None) is not None:
        payload["z_affine_bias"] = _np(model.z_affine_bias)
    if getattr(model, "class_names", None) is not None:
        payload["class_names"] = model.class_names

    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return payload


# ---------------------------------------------------------------------------
# Import of reference (torch) pickles
# ---------------------------------------------------------------------------

class _ShimObject:
    """Tolerant unpickle target: accepts any pickled state."""

    def __init__(self, *a, **kw):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2:
            # nn.Module-style (dict, slots) states
            if isinstance(state[0], dict):
                self.__dict__.update(state[0])
            if isinstance(state[1], dict):
                self.__dict__.update(state[1])
        else:
            self.__dict__["_raw_state"] = state


# Module paths old pickles may reference (reference models/__init__.py:12-35
# installs the src.classes.* aliases for Groundeep pickles).
_SHIM_MODULES = (
    "imdbn", "imdbn.models", "imdbn.models.rbm", "imdbn.models.idbn",
    "imdbn.models.imdbn", "imdbn.models.imdbn_bimodal",
    "imdbn.models.gdbn_model_complete",
    "src", "src.classes", "src.classes.rbm_model", "src.classes.dbn_model",
    "src.classes.gdbn_model",
)
_SHIM_CLASSES = ("RBM", "iDBN", "iMDBN", "iMDBN_BiModal", "DBN", "gDBN")


class _ShimUnpickler(pickle.Unpickler):
    """Resolves reference/Groundeep class paths to tolerant shims without
    polluting sys.modules (unlike reference models/__init__.py:12-35)."""

    def find_class(self, module, name):
        if module in _SHIM_MODULES:
            cls = type(name, (_ShimObject,), {"__module__": module})
            return cls
        return super().find_class(module, name)


def _looks_like_rbm(obj) -> bool:
    d = getattr(obj, "__dict__", {})
    params = d.get("_parameters", {})
    return (("W" in d or "W" in params)
            and ("hid_bias" in d or "hid_bias" in params))


def _shim_rbm_to_framework(obj, device=None):
    """Shim/torch RBM → the port's RBM on ``device`` (momentum re-zeroed
    like the reference's loader, imdbn.py:329-331)."""
    # imported here: models.rbm's package imports the checkpoint package
    from multimodal_idbn_tpu_torch.models.rbm import RBM

    d = dict(getattr(obj, "__dict__", {}))
    params = d.get("_parameters", {}) or {}

    def get(name, default=None):
        if name in params and params[name] is not None:
            return params[name]
        return d.get(name, default)

    W = _np(get("W"))
    rbm = RBM(
        num_visible=W.shape[0], num_hidden=W.shape[1],
        learning_rate=float(d.get("lr", 0.1)),
        weight_decay=float(d.get("weight_decay", 1e-4)),
        momentum=float(d.get("momentum", 0.5)),
        dynamic_lr=bool(d.get("dynamic_lr", False)),
        final_momentum=float(d.get("final_momentum", 0.97)),
        sparsity=bool(d.get("sparsity", False)),
        sparsity_factor=float(d.get("sparsity_factor", 0.05)),
        softmax_groups=[tuple(g) for g in d.get("softmax_groups", []) or []],
        device=device)
    rbm.W = W
    rbm.hid_bias = _np(get("hid_bias"))
    rbm.vis_bias = _np(get("vis_bias"))
    return rbm


def _convert(obj, device=None):
    """Recursively convert shim objects / torch tensors in a payload."""
    if hasattr(obj, "detach"):  # torch tensor
        return _np(obj)
    if isinstance(obj, _ShimObject):
        if _looks_like_rbm(obj):
            return _shim_rbm_to_framework(obj, device)
        d = getattr(obj, "__dict__", {})
        if "layers" in d:  # an iDBN-like object
            layers = [_convert(r, device) for r in d["layers"]]
            return NumpyishDBNHolder(layers, d.get("params", {}))
        return {k: _convert(v, device) for k, v in d.items()}
    if isinstance(obj, dict):
        return {k: _convert(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_convert(v, device) for v in obj]
        return out if isinstance(obj, list) else tuple(out)
    return obj


class NumpyishDBNHolder:
    """Converted stand-in for unpickled iDBN objects: exposes ``layers``
    (framework RBMs) + represent/decode like the original."""

    def __init__(self, layers, params):
        self.layers = layers
        self.params = params
        self.text_flag = False

    def represent(self, x, upto_layer=None):
        v = x
        L = (len(self.layers) if upto_layer is None
             else max(0, min(len(self.layers), int(upto_layer))))
        for i in range(L):
            v = self.layers[i].forward(v)
        return v

    def decode(self, top):
        cur = top
        for rbm in reversed(self.layers):
            cur = rbm.backward(cur)
        return cur


def import_reference_pickle(path: str, device=None) -> Dict[str, Any]:
    """Load a reference/Groundeep pickle and convert all RBMs to the port's
    RBMs on ``device`` (``cuda`` unless ``"cpu"`` is asked for). Returns
    the converted payload dict (``{"layers": ...}`` formats included)."""
    from multimodal_idbn_tpu_torch.device import resolve_device
    device = resolve_device(device)
    with open(path, "rb") as f:
        obj = _ShimUnpickler(f).load()
    converted = _convert(obj, device)
    if not isinstance(converted, dict):
        converted = {"model": converted}
    return converted
