"""Checkpointing: portable npz checkpoints, mid-training checkpoints with
bit-identical resume, and the reference pickle import/export.

Port of multimodal_idbn_tpu/checkpoint/__init__.py:41-463, every public
function under the same name, with the same file format: one ``.npz``
holding ``{name}/{w,hb,vb,w_m,hb_m,vb_m}`` for every RBM of the model
(``rbm``, ``layer{i}``, ``image_idbn/layer{i}``, ``joint_rbm``,
``mod1_dbn/layer{i}``, ``mod2_dbn/layer{i}``, ``joint/layer{i}``),
``z_class_mean``, ``extra/*`` and a JSON ``__meta__``; written to a
temporary file and renamed, so a crash mid-save never harms the previous
checkpoint. A checkpoint written by either package loads into the other's
model.

What differs from the JAX module:

- Random streams. Every training epoch derives its key and permutation
  from (``SEED``, absolute epoch) alone, as in the JAX package, so
  (states, next epoch) resume a run bit for bit. Each RBM shell's own
  stream (``RBM._next_key``) is a ``torch.Generator``; its state is stored
  as ``{name}/gen_state`` (uint8), where the JAX package stores its
  threefry key as ``{name}/key``. Neither package reads the other's
  array: loading the other package's checkpoint restores the states and
  leaves the streams as constructed.
- ``save_checkpoint_orbax`` / ``load_checkpoint_orbax`` (:122-157) need the
  orbax package. Their counterparts here are ``save_checkpoint_torch`` /
  ``load_checkpoint_torch``: the same tree of arrays written with
  ``torch.save`` and read with ``torch.load(weights_only=True)``.
- bfloat16 arrays are stored as uint16 bit-views and their dtype recorded
  under ``meta["dtypes"]``, as the JAX package stores them (:90-108,
  :174-177); both packages read either's. A bf16 state loads as bf16, any
  other as fp32. PCD fantasy particles travel as ``extra/pcd_chain{i}``
  and are restored in numeric order (:276-279, :313-318).
- Visible unit types. An iDBN whose layer 0 is not Bernoulli
  (``iDBN.visible``: "gaussian", "replicated_softmax") records its type
  under ``meta["visible"]`` by the stack's name (``""`` for a bare iDBN,
  ``mod1_dbn``, ``mod2_dbn``, ``image_idbn``); loading refuses a model of
  another type. A file without the record, as every older checkpoint and
  the JAX package's, holds Bernoulli stacks.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from multimodal_idbn_tpu_torch.checkpoint.reference_pickle import (  # noqa: F401
    NumpyDBN,
    NumpyRBM,
    export_reference_pickle,
    import_reference_pickle,
)
from multimodal_idbn_tpu_torch.convert import FIELDS as _STATE_FIELDS
from multimodal_idbn_tpu_torch.ops.rbm_ops import RBMState

FORMAT = "multimodal_idbn_tpu.ckpt.v1"


def _collect_rbms(model) -> Dict[str, "object"]:
    """Name every RBM in a model with a stable flat key."""
    # imported here: the models import this module for their train loops
    from multimodal_idbn_tpu_torch.models.rbm import RBM

    if isinstance(model, RBM):
        return {"rbm": model}
    out = {}
    if hasattr(model, "image_idbn"):  # iMDBN
        for i, r in enumerate(model.image_idbn.layers):
            out[f"image_idbn/layer{i}"] = r
        out["joint_rbm"] = model.joint_rbm
    elif hasattr(model, "mod1_dbn"):  # iMDBN_BiModal
        for i, r in enumerate(model.mod1_dbn.layers):
            out[f"mod1_dbn/layer{i}"] = r
        for i, r in enumerate(model.mod2_dbn.layers):
            out[f"mod2_dbn/layer{i}"] = r
        for i, r in enumerate(model.joint_layers):
            out[f"joint/layer{i}"] = r
    elif hasattr(model, "layers"):  # iDBN
        for i, r in enumerate(model.layers):
            out[f"layer{i}"] = r
    else:
        raise TypeError(f"don't know how to checkpoint {type(model)}")
    return out


def _visible_types(model) -> Dict[str, str]:
    """The visible unit type of every iDBN of ``model``, by stack name."""
    out = {}
    for name in ("", "image_idbn", "mod1_dbn", "mod2_dbn"):
        dbn = getattr(model, name, None) if name else model
        if dbn is not None and hasattr(dbn, "layers") \
                and hasattr(dbn, "visible"):
            out[name] = dbn.visible
    return out


def _npz_path(path) -> str:
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16, which numpy lacks, as its
    uint16 bit-view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    """An array read from a checkpoint as a tensor on ``device``: a
    bit-viewed bf16 array as bf16, anything else as fp32."""
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def save_checkpoint(model, path: str, extra: Optional[Dict] = None) -> None:
    """Save all RBM states (momentum buffers included), each RBM's stream
    position and optional extras (e.g. ``z_class_mean``) to one npz file,
    atomically."""
    arrays = {}
    dtypes = {}
    meta = {"format": FORMAT, "rbms": {}}

    def put(k, v):
        if isinstance(v, torch.Tensor):
            if v.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(
                    f"checkpoint tensor {k!r} has unsupported dtype "
                    f"{v.dtype}: only float32 and bfloat16 states "
                    f"round-trip through the npz format")
            if v.dtype == torch.bfloat16:
                dtypes[k] = "bfloat16"
            v = _to_numpy(v)
        arrays[k] = np.asarray(v)

    for name, rbm in _collect_rbms(model).items():
        for field in _STATE_FIELDS:
            put(f"{name}/{field}", getattr(rbm.state, field))
        arrays[f"{name}/gen_state"] = rbm._gen.get_state().numpy()
        meta["rbms"][name] = {
            "softmax_groups": [list(g) for g in rbm.softmax_groups]}
    if getattr(model, "z_class_mean", None) is not None:
        put("z_class_mean", model.z_class_mean)
    for k, v in (extra or {}).items():
        put(f"extra/{k}", v)
    for k, arr in arrays.items():
        if arr.dtype.kind == "V" or arr.dtype.names is not None:
            raise TypeError(
                f"checkpoint array {k!r} has unsupported dtype "
                f"{arr.dtype!r}: only numeric numpy dtypes and bfloat16 "
                f"round-trip through the npz format")
    if dtypes:
        meta["dtypes"] = dtypes
    visible = {k: v for k, v in _visible_types(model).items()
               if v != "bernoulli"}
    if visible:
        meta["visible"] = visible
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    # Atomic: a crash mid-write must never clobber the previous checkpoint
    # (np.savez appends .npz, so the temporary name ends in it too).
    p = _npz_path(path)
    tmp = p + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, p)


def _state_tree(model) -> Dict:
    tree: Dict = {}
    for name, rbm in _collect_rbms(model).items():
        tree[name.replace("/", ".")] = {
            f: getattr(rbm.state, f).detach().cpu() for f in _STATE_FIELDS}
    if getattr(model, "z_class_mean", None) is not None:
        tree["z_class_mean"] = model.z_class_mean.detach().cpu()
    return tree


def save_checkpoint_torch(model, path: str) -> None:
    """The counterpart of ``save_checkpoint_orbax``: the same tree (every
    RBM state under its dotted name, plus ``z_class_mean``) written with
    ``torch.save``, atomically."""
    tmp = str(path) + ".tmp"
    torch.save(_state_tree(model), tmp)
    os.replace(tmp, str(path))


def load_checkpoint_torch(model, path: str) -> None:
    """Restore a file ``save_checkpoint_torch`` wrote
    (``torch.load(weights_only=True)``: tensors and containers only)."""
    tree = torch.load(str(path), map_location="cpu", weights_only=True)
    for name, rbm in _collect_rbms(model).items():
        sub = tree[name.replace("/", ".")]
        rbm.state = RBMState(*(sub[f].to(rbm.device) for f in _STATE_FIELDS))
    if "z_class_mean" in tree and hasattr(model, "z_class_mean"):
        model.z_class_mean = tree["z_class_mean"].to(model.device)


def load_checkpoint(model, path: str) -> Dict[str, np.ndarray]:
    """Restore RBM states into ``model`` (on its device) from an npz
    checkpoint; returns any ``extra/*`` arrays."""
    p = _npz_path(path)
    with np.load(p, allow_pickle=False) as f:
        files = dict(f)
    bf16 = set()
    saved_visible = {}
    if "__meta__" in files:
        meta = json.loads(bytes(files["__meta__"]).decode())
        for k, dt in (meta.get("dtypes") or {}).items():
            if dt != "bfloat16":
                raise TypeError(f"checkpoint array {k!r} is bit-viewed "
                                f"{dt}; only bfloat16 is supported")
            bf16.add(k)
        saved_visible = meta.get("visible") or {}
    for name, vis in _visible_types(model).items():
        if saved_visible.get(name, "bernoulli") != vis:
            raise ValueError(
                f"checkpoint {p!r} holds {saved_visible.get(name, 'bernoulli')}"
                f" visible units in {name or 'the iDBN'}, this model "
                f"{vis}")
    rbms = _collect_rbms(model)
    missing = [name for name in rbms if f"{name}/w" not in files]
    if missing:
        have = sorted({k.split("/w")[0] for k in files if k.endswith("/w")})
        raise ValueError(
            f"checkpoint {p!r} does not match this model: no saved state "
            f"for {missing} (checkpoint contains {have}). Wrong "
            f"checkpoint_dir, or a checkpoint from a different model "
            f"family/architecture?")
    for name, rbm in rbms.items():
        rbm.state = RBMState(*(
            _from_numpy(files[f"{name}/{field}"],
                        f"{name}/{field}" in bf16, rbm.device)
            for field in _STATE_FIELDS))
        if f"{name}/gen_state" in files:  # absent in the JAX package's files
            rbm._gen.set_state(torch.from_numpy(
                np.ascontiguousarray(files[f"{name}/gen_state"], np.uint8)))
    if "z_class_mean" in files and hasattr(model, "z_class_mean"):
        model.z_class_mean = _from_numpy(files["z_class_mean"],
                                         "z_class_mean" in bf16,
                                         model.device)
    # bit-viewed bf16 extras (PCD chains) come back as bf16 tensors
    return {k[len("extra/"):]: (_from_numpy(v, True, "cpu") if k in bf16
                                else v)
            for k, v in files.items() if k.startswith("extra/")}


# ---------------------------------------------------------------------------
# Mid-training checkpoints (:203-463). A checkpoint records every RBM state
# (weights + momentum), z_class_mean when present, the phase name and the
# next epoch to run. Every epoch's key and permutation derive from
# (SEED, absolute epoch), so resuming from (states, next_epoch) reproduces
# the uninterrupted run bit for bit (tests/test_torch_resume.py).
# ---------------------------------------------------------------------------

def config_fingerprint(params: Dict, **extra_fields) -> str:
    """Canonical JSON of the training-relevant configuration (:213-232).

    Stored in mid-training checkpoints and compared at resume, so that
    editing hyperparameters and rerunning with the same ``save_dir``
    refuses to resume the old run under the new schedule. Cadence and
    placement knobs that do not change the trained result are left out;
    ``extra_fields`` carries the architecture."""
    skip = {"CHECKPOINT_EVERY", "CROSS_METRICS_EVERY", "DP_DEVICES"}
    payload = {k: v for k, v in params.items() if k not in skip}
    payload.update(extra_fields)
    return json.dumps(payload, sort_keys=True, default=str)


def _fingerprint_mismatch_keys(loaded: str, current: str):
    """Human-readable list of the fields that differ between two
    fingerprints."""
    try:
        a, b = json.loads(loaded), json.loads(current)
    except ValueError:
        return ["<fingerprints differ>"]
    keys = sorted(k for k in set(a) | set(b)
                  if a.get(k, "<absent>") != b.get(k, "<absent>"))
    return [f"{k}: checkpoint={a.get(k, '<absent>')!r} "
            f"run={b.get(k, '<absent>')!r}" for k in keys]


def _text(s) -> np.ndarray:
    return np.frombuffer(str(s).encode(), dtype=np.uint8)


def save_train_checkpoint(model, path: str, phase: str, next_epoch: int,
                          loss_history=None) -> None:
    """Checkpoint ``model`` mid-training, resumable at ``next_epoch``
    (:248-284). ``phase`` is the tag ("image", "joint", "mod1", ...) the
    caller routes the resume by; ``loss_history`` and the model's
    ``joint_metrics_history`` travel with it. In a process group only
    rank 0 writes: the replicas of a data-parallel run are equal."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        return
    extra = {"phase": _text(phase),
             "next_epoch": np.asarray(int(next_epoch), np.int64)}
    fp = getattr(model, "_ckpt_fingerprint", None)
    if fp:  # set by the entry points (config_fingerprint)
        extra["config_fingerprint"] = _text(fp)
    # Loops that iterate a loader draw batch order from its shuffle
    # counter, which does not equal the epochs trained in general.
    for attr in ("dataloader", "val_loader"):
        ld = getattr(model, attr, None)
        if ld is not None and hasattr(ld, "_epoch"):
            extra[f"loader_epoch/{attr}"] = np.asarray(int(ld._epoch),
                                                       np.int64)
    if loss_history is not None:
        extra["loss_history"] = np.asarray(loss_history, np.float64)
    for i, c in enumerate(getattr(model, "_pcd_chains", None) or ()):
        extra[f"pcd_chain{i}"] = c
    metrics = getattr(model, "joint_metrics_history", None)
    if metrics is not None:
        extra["joint_metrics_history"] = _text(json.dumps(metrics))
    save_checkpoint(model, path, extra=extra)


def load_train_checkpoint(model, path: str):
    """Restore a ``save_train_checkpoint`` file into ``model``; returns
    ``(phase, next_epoch)`` (:287-337). Also restores ``loss_history`` onto
    a model that keeps one, ``joint_metrics_history``, PCD fantasy
    particles onto a model that keeps them, and the loaders' shuffle
    counters."""
    extras = load_checkpoint(model, path)
    phase = bytes(extras["phase"]).decode()
    next_epoch = int(extras["next_epoch"])
    # Drop a stale stash first: an earlier load whose consumer raised
    # would otherwise leak its fingerprint into this load.
    model.__dict__.pop("_ckpt_loaded_fingerprint", None)
    if "config_fingerprint" in extras:
        # one-shot stash consumed by load_train_checkpoint_expecting
        model._ckpt_loaded_fingerprint = bytes(
            extras["config_fingerprint"]).decode()
    if "loss_history" in extras and hasattr(model, "loss_history"):
        model.loss_history = [float(x) for x in extras["loss_history"]]
    if "joint_metrics_history" in extras:
        model.joint_metrics_history = json.loads(
            bytes(extras["joint_metrics_history"]).decode())
    # numeric order: "pcd_chain10" comes after "pcd_chain2"
    chain_keys = sorted((k for k in extras if k.startswith("pcd_chain")),
                        key=lambda k: int(k[len("pcd_chain"):]))
    if chain_keys and hasattr(model, "_pcd_chains"):
        model._pcd_chains = [
            torch.as_tensor(extras[k]).to(model.device) for k in chain_keys]
    # The counter values are stashed on the model too, because a caller may
    # attach the training loader after loading the checkpoint
    # (train_bimodal attaches the modality loaders later).
    restored = {}
    for attr in ("dataloader", "val_loader"):
        k = f"loader_epoch/{attr}"
        if k in extras:
            restored[attr] = int(extras[k])
            ld = getattr(model, attr, None)
            if ld is not None and hasattr(ld, "_epoch"):
                ld._epoch = restored[attr]
    if restored:
        model._restored_loader_epochs = restored
    return phase, next_epoch


def align_loader_for_resume(model, start_epoch: int) -> None:
    """Align the DataLoader shuffle counter of a resumed loop that iterates
    its loader (:340-363): the counters ``load_train_checkpoint`` stashed
    win, applied to whichever loaders are attached now; without a stash,
    one iteration per epoch trained is assumed. The per-batch loops of
    ``iDBN.train``, ``iMDBN.train_joint`` and ``iMDBN_BiModal.train_joint``
    call it before a run; the fused epochs draw their order from
    (seed, epoch) and need none."""
    restored = model.__dict__.pop("_restored_loader_epochs", None)
    if restored is not None:
        for attr, val in restored.items():
            ld = getattr(model, attr, None)
            if ld is not None and hasattr(ld, "_epoch"):
                ld._epoch = int(val)
        return
    ld = getattr(model, "dataloader", None)
    if start_epoch and ld is not None and hasattr(ld, "_epoch"):
        ld._epoch = int(start_epoch)


def maybe_save_train_checkpoint(model, path, every: int, phase: str,
                                next_epoch: int, total_epochs: int,
                                loss_history=None,
                                cadence_only: bool = False) -> bool:
    """Periodic mid-training save of every trainer's epoch loop (:366-386).

    Does nothing (returns False) unless checkpointing is configured
    (``path`` and ``every`` truthy) and the run is not finished
    (``next_epoch < total_epochs``). ``cadence_only=True`` also requires
    ``next_epoch`` to be a multiple of ``every``; loops that run in the
    blocks of ``checkpoint_epochs`` save at every block edge."""
    if not (path and every and int(next_epoch) < int(total_epochs)):
        return False
    if cadence_only and int(next_epoch) % int(every) != 0:
        return False
    save_train_checkpoint(model, path, phase=phase,
                          next_epoch=int(next_epoch),
                          loss_history=loss_history)
    return True


def cli_checkpoint_paths(cfg: Dict, names):
    """The crash-recovery checkpoint paths of an entry-point run
    (:389-404): ``paths.checkpoint_dir`` (default
    ``<paths.save_dir>/checkpoints``) is created and
    ``{name: <dir>/<name>.ckpt.npz}`` returned."""
    paths_cfg = cfg.get("paths", {}) or {}
    ckpt_dir = Path(paths_cfg.get(
        "checkpoint_dir",
        str(Path(paths_cfg.get("save_dir", "./networks"))
            / "checkpoints"))).expanduser()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    return {n: ckpt_dir / f"{n}.ckpt.npz" for n in names}


def remove_checkpoints(paths) -> None:
    """Delete crash-recovery checkpoints after a completed run, so that a
    later fresh run with the same config trains (:407-412)."""
    for p in paths:
        if p is not None and p.exists():
            p.unlink()


def load_train_checkpoint_expecting(model, path, expected_phase: str,
                                    ignore_config: bool = False):
    """``load_train_checkpoint`` plus a clear error when the file's phase
    tag is not the one being resumed, or when its config fingerprint
    differs from the current run's (:415-445). ``ignore_config=True``
    (YAML ``training.resume_ignore_config``) skips the fingerprint check
    for deliberate schedule changes. Returns the next epoch."""
    phase, next_epoch = load_train_checkpoint(model, str(path))
    # Pop the one-shot stash before the phase check, so a phase-mismatch
    # raise cannot leave it behind for a later load.
    loaded_fp = model.__dict__.pop("_ckpt_loaded_fingerprint", None)
    if phase != expected_phase:
        raise ValueError(
            f"checkpoint {str(path)!r} is a {phase!r}-phase checkpoint "
            f"but this run expected {expected_phase!r} — wrong "
            f"checkpoint_dir, or leftovers from a different config?")
    current_fp = getattr(model, "_ckpt_fingerprint", None)
    if (not ignore_config and loaded_fp and current_fp
            and loaded_fp != current_fp):
        diffs = _fingerprint_mismatch_keys(loaded_fp, current_fp)
        raise ValueError(
            f"checkpoint {str(path)!r} was written by a run with "
            f"different training configuration ({'; '.join(diffs)}). "
            f"Resuming it under the new config would produce a model "
            f"that follows neither schedule. Delete the checkpoint "
            f"directory to start fresh, or set "
            f"training.resume_ignore_config: true to resume anyway.")
    return next_epoch


def checkpoint_epochs(start_epoch: int, end_epoch: int,
                      checkpoint_every: int, *extra_edges: int):
    """Split ``[start_epoch, end_epoch)`` into contiguous blocks whose
    edges land on multiples of ``checkpoint_every`` plus any
    ``extra_edges`` (e.g. a warm-up boundary); ``checkpoint_every <= 0``
    splits at ``extra_edges`` only (:448-463). Returns a list of
    ``(block_start, block_end)`` tuples."""
    edges = {start_epoch, end_epoch}
    edges.update(e for e in extra_edges if start_epoch < e < end_epoch)
    if checkpoint_every and checkpoint_every > 0:
        e = (start_epoch // checkpoint_every + 1) * checkpoint_every
        while e < end_epoch:
            edges.add(e)
            e += checkpoint_every
    seq = sorted(edges)
    return list(zip(seq[:-1], seq[1:]))
