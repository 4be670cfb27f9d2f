"""Seed-pool quality protocol of the port, held against the JAX package's
recorded pools.

Port of the protocols the JAX package keeps outside its package:
- flagship: benchmarks/reference_head_to_head.py — ``make_params``
  (:62-72), the ``FLAGSHIP`` schedule (:52-55, and ``SCHEDULE`` / ``QUICK``,
  :42-47), ``build_dataset`` (:75-97), ``probe_metrics`` (:101-127),
  ``eval_metrics_numpy`` (:130-152) and the training and evaluation of
  ``run_ours`` (:245-376): an iMDBN on the same loaders and seeds,
  ``image_idbn.train``, ``train_joint``, then the metrics on the validation
  set (with the four probes) and on the training set (without);
- bimodal: benchmarks/quality_bimodal.py (:36-178), the schedule of
  configs/bimodal_training_config.yaml (modality iDBNs [10000, 1500, 1500]
  and [1568, 500, 500, 1000] CD-10 × 100 epochs, joint [1500, 500] CD-5 ×
  150 epochs, 50 cross steps, 30 aux steps), the cross MSEs, the
  auto-reconstruction MSEs and the blank baselines;
- the comparison: ``summarize`` and ``compare`` of
  benchmarks/merge_h2h.py (:34-60), Mann-Whitney U and the bootstrap 95%
  CI of Δmedian (10 000 resamples, seed 0), with Holm's correction over
  the metrics of a pool at a family α of 0.05.

The port imports neither JAX nor the JAX package nor ``benchmarks``; it
only reads the recorded pools' JSON files there
(``RECORDED_FLAGSHIP``, ``RECORDED_BIMODAL``). Run it as

    python -m multimodal_idbn_tpu_torch.quality flagship --seeds 0 1 \\
        --out multimodal_idbn_tpu_torch/records/<file>.json
    python -m multimodal_idbn_tpu_torch.quality bimodal --seeds 0 1 \\
        --out multimodal_idbn_tpu_torch/records/<file>.json
    python -m multimodal_idbn_tpu_torch.quality pools --flagship 0 1 \\
        --bimodal 0 1 --jobs 4 --outdir <dir>
    python -m multimodal_idbn_tpu_torch.quality compare flagship <files>

``pools`` runs one process per seed, ``--jobs`` at a time on the one
card, then the first seed of each pool once more alone, which must end
bit-equal. Each runs on ``cuda`` unless ``--device cpu`` is given (and
``flagship --quick`` runs the protocol's QUICK schedule). A flagship file
has the layout of benchmarks/head_to_head_r5_ours_ext.json (``schedule``,
``seeds``, ``matmul_precision``, ``"ref": {}``, ``"ours": {seed: the 14
metrics and "train_s"}``), so ``python benchmarks/merge_h2h.py
benchmarks/head_to_head_r5_pooled.json:ref <file>`` reads it unchanged. A
bimodal file has the layout of benchmarks/quality_bimodal_r5.json (one
record per seed under ``seeds``, the collapse verdict beside). Both also
carry, per seed, the kernel launches of the training against their
derivation (``launches``), a digest of every trained parameter
(``digests``) and one of each stack (``stack_digests``), and a flagship
seed's image-phase seconds (``phase_s``): a seed run twice
on the card ends bit-equal (on the CPU the number of threads changes the
order of the sums). The file is rewritten after every seed. This file run
as a script trains with whichever package ``PYTHONPATH`` holds, so the
same seeds' stacks under another checkout of the port come from
``cd <checkout> && PYTHONPATH=. python <this file> flagship --seeds 0
--out f.json``.

Settings of the recorded arms, and the port's: the JAX arm of the
flagship pool ran at the TPU's default matmul precision (bf16 operands)
and its reference arm in true fp32 (benchmarks/RESULTS.md, "Round 5:
flagship quality parity"); the bimodal pool's later seeds at the TPU
default too. The port cannot run the TPU's bf16 passes: it runs
fp32-accurate (``matmul_precision`` "highest"; its kernels are 3×TF32 at
fp32 accuracy whatever the setting). ``init_retry`` is 0, as in both
arms, and the seeds are the pools' own numbers.

The probe's initial weights: JAX's ``train_linear_classifier`` starts
from ``jax.random.key(0)`` uniforms (multimodal_idbn_tpu/utils/
probe_utils.py:192-197), which the port cannot draw. The protocol's
embeddings are D = 500 wide (``top`` and ``joint``; 128 in the ``QUICK``
and ``SCHEDULE`` schedules), with 5 classes, so the port keeps JAX's
(W0, b0) for those widths as data (``records/jax_probe_init.npz``),
written once from ``jax.random`` and checked against it by
tests/test_torch_quality.py. Another width raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodal_idbn_tpu_torch.device import (DeviceLike, resolve_device,
                                              set_matmul_precision,
                                              synchronize, to_numpy)

ROOT = Path(__file__).resolve().parent.parent
RECORDS = Path(__file__).resolve().parent / "records"
RECORDED_FLAGSHIP = ROOT / "benchmarks" / "head_to_head_r5_pooled.json"
RECORDED_BIMODAL = ROOT / "benchmarks" / "quality_bimodal_r5.json"
PROBE_INIT = RECORDS / "jax_probe_init.npz"

# Schedules (reference_head_to_head.py:42-55).
SCHEDULE = dict(side=40, num_classes=16, n_samples=1024, batch=128,
                layers=(1600, 400, 128), joint_hidden=128,
                epochs_img=30, epochs_joint=30, cd=3, joint_cd=3,
                cross_steps=20, aux_cond_steps=10)
QUICK = dict(SCHEDULE, n_samples=256, epochs_img=4, epochs_joint=10,
             cross_steps=5, aux_cond_steps=3)
FLAGSHIP = dict(side=100, num_classes=32, n_samples=2048, batch=128,
                layers=(10000, 1500, 500), joint_hidden=500,
                epochs_img=100, epochs_joint=150, cd=10, joint_cd=5,
                cross_steps=50, aux_cond_steps=30, joint_lr=0.04)

# quality_bimodal.py:73-93 (configs/bimodal_training_config.yaml)
BIMODAL = dict(side=100, num_classes=32, n_samples=2048, batch=128,
               mod1_layers=(10000, 1500, 1500),
               mod2_layers=(1568, 500, 500, 1000), joint_layers=(1500, 500),
               epochs_mod=100, epochs_joint=150, cd=10, joint_cd=5,
               cross_steps=50, aux_cond_steps=30, joint_lr=0.04)

FLAGSHIP_METRICS = ("top1", "top3", "ce", "image_mse", "recon_mse",
                    "train_top1", "train_top3", "train_ce",
                    "train_image_mse", "train_recon_mse",
                    "probe_top_labels", "probe_top_area",
                    "probe_joint_labels", "probe_joint_area")
BIMODAL_METRICS = ("mod1_mse", "mod2_mse", "mod1_auto_mse",
                   "mod2_auto_mse")
# The recorded pool's collapse criterion (quality_bimodal_r5.json).
BIMODAL_COLLAPSE = "cross mod2<-mod1 MSE >= 0.9 * blank baseline"
ALPHA = 0.05
# fp32-accurate products (see the module's docstring)
MATMUL_PRECISION = "highest"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def make_params(s: dict, seed: int) -> dict:
    """The UPPERCASE params of one seed (reference_head_to_head.py:62-72)."""
    return {
        "LEARNING_RATE": 0.1, "WEIGHT_PENALTY": 1e-4,
        "INIT_MOMENTUM": 0.5, "FINAL_MOMENTUM": 0.95,
        "LEARNING_RATE_DYNAMIC": True, "CD": s["cd"],
        "JOINT_LEARNING_RATE": s.get("joint_lr", 0.1),
        "JOINT_CD": s["joint_cd"], "CROSS_GIBBS_STEPS": s["cross_steps"],
        "JOINT_AUX_COND_STEPS": s["aux_cond_steps"], "SEED": seed,
    }


def build_dataset(s: dict) -> Dict[str, np.ndarray]:
    """The one dataset of every run (data seed 0, split seed 42;
    reference_head_to_head.py:75-97): flattened float32 images and one-hot
    labels of the training and validation splits."""
    from multimodal_idbn_tpu_torch.data import (generate_numerosity_dataset,
                                                train_val_test_split)
    d = generate_numerosity_dataset(n_samples=s["n_samples"],
                                    num_classes=s["num_classes"],
                                    side=s["side"], seed=0)
    tr, va, _ = train_val_test_split(s["n_samples"], val_size=0.15,
                                     test_size=0.15, seed=42)
    img = d["images"].reshape(len(d["images"]), -1).astype(np.float32)
    y = d["onehot"].astype(np.float32)
    return {"train_img": img[tr], "train_y": y[tr], "val_img": img[va],
            "val_y": y[va]}


# --------------------------------------------------------------------------
# Evaluation (reference_head_to_head.py:101-152)
# --------------------------------------------------------------------------

def jax_probe_init(D: int, n_classes: int = 5):
    """JAX's initial probe weights (W0 [D, n_classes], b0 [n_classes]) for
    a width the protocol uses (see the module's docstring)."""
    with np.load(PROBE_INIT) as f:
        if f"W_{D}" not in f.files or f[f"W_{D}"].shape[1] != n_classes:
            raise ValueError(f"no JAX probe init for D={D}, "
                             f"{n_classes} classes in {PROBE_INIT.name}")
        return (torch.from_numpy(f[f"W_{D}"].copy()),
                torch.from_numpy(f[f"b_{D}"].copy()))


def probe_metrics(z, h_joint, y: np.ndarray, img: np.ndarray) -> dict:
    """Linear-probe accuracies on the ``top`` (z) and ``joint`` embeddings
    for the labels and the area, each binned in 5 quantiles, split
    stratified with seed 42 and probed from JAX's initial weights
    (reference_head_to_head.py:101-127). ``z`` and ``h_joint`` may be
    tensors: the probe trains on their device."""
    from multimodal_idbn_tpu_torch.utils.probe_utils import (
        make_bin_labels, stratified_split, train_linear_classifier)
    feats = {"labels": y.argmax(1).astype(np.float32) + 1,
             "area": img.sum(1)}
    out = {}
    for emb_name, E in (("top", z), ("joint", h_joint)):
        if E is None:
            continue
        E = torch.as_tensor(E, dtype=torch.float32)
        for feat_name, vals in feats.items():
            yb, _ = make_bin_labels(vals, n_bins=5)
            tr, te = stratified_split(yb, test_size=0.2, rng_seed=42)
            tr_i, te_i = (torch.as_tensor(np.asarray(i, np.int64),
                                          device=E.device) for i in (tr, te))
            acc, _, _ = train_linear_classifier(
                E[tr_i], yb[tr], E[te_i], yb[te], n_classes=5,
                init=jax_probe_init(int(E.shape[1])))
            out[f"probe_{emb_name}_{feat_name}"] = round(float(acc), 4)
    return out


def eval_metrics_numpy(z, y, p_y, img_from_txt, img, rec) -> dict:
    """Top-1 / top-3 / CE of p(y|img), the TXT→IMG image MSE and the
    image auto-reconstruction MSE (reference_head_to_head.py:130-152)."""
    n, npix = img.shape
    gt = y.argmax(1)
    pred = p_y.argmax(1)
    top1 = float((pred == gt).mean())
    k = min(3, p_y.shape[1])
    topk = np.argsort(-p_y, axis=1)[:, :k]
    top3 = float((topk == gt[:, None]).any(1).mean())
    p = np.clip(p_y, 1e-6, 1 - 1e-6)
    onehot = np.eye(p_y.shape[1], dtype=np.float32)[gt]
    ce = float(-(onehot * np.log(p)
                 + (1 - onehot) * np.log(1 - p)).sum() / n)
    image_mse = float(((img_from_txt - img) ** 2).sum() / (n * npix))
    recon_mse = float(((np.clip(rec, 0, 1) - img) ** 2).mean())
    return {"top1": round(top1, 4), "top3": round(top3, 4),
            "ce": round(ce, 4), "image_mse": round(image_mse, 6),
            "recon_mse": round(recon_mse, 6)}


def evaluate_imdbn(model, loader, probes: bool) -> dict:
    """The metrics of a trained iMDBN over ``loader``'s batches, in its
    order (``run_ours.evaluate``, reference_head_to_head.py:316-339): per
    batch the image latents, the cross-modal round trip (drawing from the
    joint RBM's stream), the auto-reconstruction and the joint hidden
    probabilities."""
    from multimodal_idbn_tpu_torch.device import as_tensor
    from multimodal_idbn_tpu_torch.ops import rbm_ops
    zs, ys, ps, ifs, imgs, recs, hs = [], [], [], [], [], [], []
    for img, y in loader:
        img = np.asarray(img, np.float32).reshape(len(img), -1)
        y = np.asarray(y, np.float32)
        z = model.image_idbn.represent(img)
        img_ft, p_y = model._cross_reconstruct(z, y)
        rec = model.image_idbn.reconstruct(img)
        h = rbm_ops.hidden_probs(model.joint_rbm.state, torch.cat(
            [z, as_tensor(y, model.device)], dim=1))
        zs.append(z); hs.append(h)
        ys.append(y); imgs.append(img)
        ps.append(to_numpy(p_y)); ifs.append(to_numpy(img_ft))
        recs.append(to_numpy(rec))
    Y, IMG = np.concatenate(ys), np.concatenate(imgs)
    Z, H = torch.cat(zs), torch.cat(hs)
    out = eval_metrics_numpy(to_numpy(Z), Y, np.concatenate(ps),
                             np.concatenate(ifs), IMG, np.concatenate(recs))
    if probes:
        out.update(probe_metrics(Z, H, Y, IMG))
    return out


# --------------------------------------------------------------------------
# Launch derivations and digests
# --------------------------------------------------------------------------

def _batches(n_train: int, batch: int) -> int:
    return -(-n_train // batch)


def derived_launches(kind: str, s: dict, n_train: int) -> dict:
    """Kernel launches of one seed's training (the evaluation not
    included), derived from the schedule: the sampled half-step (kernel
    1) 1 + 2·CD times per image layer and batch; the chain (kernel 2)
    once per clamped update's noisy init and once per direction of the
    flagship's cross-modal round trip, per batch:
    - flagship warm-up (8 epochs): 2 clamped + 2 round trip = 4; main: 1
      clamped + 2 round trip = 3, and the z-clamped update on batch 0 of
      every 50 (batch 0 here);
    - bimodal warm-up (8 epochs): 4 clamped; main: 2 clamped (its cross
      metrics are sampled chains, in plain torch)."""
    nb = _batches(n_train, s["batch"])
    warm = min(8, s["epochs_joint"])
    main = s["epochs_joint"] - warm
    if kind == "flagship":
        layers = len(s["layers"]) - 1
        half = nb * s["epochs_img"] * layers * (1 + 2 * s["cd"])
        chain = warm * nb * 4 + main * (nb * 3 + _batches(nb, 50))
    else:
        layers = len(s["mod1_layers"]) + len(s["mod2_layers"]) - 2
        half = nb * s["epochs_mod"] * layers * (1 + 2 * s["cd"])
        chain = warm * nb * 4 + main * nb * 2
    return {"half_step_sample": half, "chain_run": chain}


def reset_launches() -> None:
    from multimodal_idbn_tpu_torch.ops import chain, half_step
    half_step.KERNEL.reset_launches()
    chain.KERNEL.reset_launches()


def read_launches() -> dict:
    """Launches of kernels 1 and 2 since the last reset."""
    from multimodal_idbn_tpu_torch.ops import chain, half_step
    return {"half_step_sample":
            half_step.KERNEL.launches_by_entry["half_step_sample"],
            "chain_run": chain.KERNEL.launches}


def stack_digests(model) -> Dict[str, str]:
    """sha256 of each stack of ``model`` (``image_idbn``, ``mod1_dbn``,
    ``mod2_dbn``, the joint), over the bytes of its RBMs' states in the
    checkpoint's order of names and fields: the modality stacks' digests
    can be held against another run's alone."""
    from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    from multimodal_idbn_tpu_torch.convert import FIELDS
    hashes: Dict[str, "hashlib._Hash"] = {}
    for name, rbm in sorted(_collect_rbms(model).items()):
        h = hashes.setdefault(name.split("/")[0], hashlib.sha256())
        for f in FIELDS:
            h.update(name.encode() + f.encode())
            h.update(to_numpy(getattr(rbm.state, f)).tobytes())
    return {k: h.hexdigest() for k, h in hashes.items()}


def state_digest(model) -> str:
    """sha256 over the bytes of every RBM state of ``model``, in the
    checkpoint's order of names and fields."""
    from multimodal_idbn_tpu_torch.checkpoint import _collect_rbms
    from multimodal_idbn_tpu_torch.convert import FIELDS
    h = hashlib.sha256()
    for name, rbm in sorted(_collect_rbms(model).items()):
        for f in FIELDS:
            h.update(name.encode() + f.encode())
            h.update(to_numpy(getattr(rbm.state, f)).tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# One seed of each protocol
# --------------------------------------------------------------------------

def _numerosity_ds(img: np.ndarray, y: np.ndarray):
    from multimodal_idbn_tpu_torch.data import NumerosityDataset
    n, npix = img.shape
    side = int(round(npix ** 0.5))
    labels = y.argmax(1).astype(np.float32) + 1
    return NumerosityDataset(img.reshape(n, side, side), labels, y,
                             img.sum(1), np.maximum(img.sum(1), 1.0))


def run_flagship_seed(s: dict, seed: int, data: Dict[str, np.ndarray],
                      device: DeviceLike = None):
    """Train and evaluate one seed of the iMDBN protocol
    (reference_head_to_head.py:245-376); returns (the per-seed record:
    the validation metrics with the probes, the ``train_*`` metrics of the
    training set, ``train_s`` and ``image_s``, the seconds of the whole
    training and of its image phase; the training's kernel launches; the
    trained model)."""
    from multimodal_idbn_tpu_torch.data import DataLoader, Subset
    from multimodal_idbn_tpu_torch.models import iMDBN
    dev = resolve_device(device)
    tr = _numerosity_ds(data["train_img"], data["train_y"])
    va = _numerosity_ds(data["val_img"], data["val_y"])
    train_loader = DataLoader(Subset(tr, np.arange(len(tr.labels))),
                              batch_size=s["batch"], shuffle=True, seed=seed)
    val_loader = DataLoader(Subset(va, np.arange(len(va.labels))),
                            batch_size=s["batch"])
    model = iMDBN(list(s["layers"]), s["joint_hidden"],
                  params=make_params(s, seed), dataloader=train_loader,
                  val_loader=val_loader, num_labels=data["train_y"].shape[1],
                  seed=seed, device=dev)
    reset_launches()
    synchronize(dev)
    t0 = time.perf_counter()
    model.image_idbn.train(epochs=s["epochs_img"])
    synchronize(dev)
    t_img = time.perf_counter() - t0
    model.train_joint(epochs=s["epochs_joint"])
    synchronize(dev)
    t_all = time.perf_counter() - t0
    launches = read_launches()
    log(f"[quality flagship seed {seed}] trained in {t_all:.1f} s (image "
        f"{t_img:.1f} s); launches {launches}")
    out = evaluate_imdbn(model, val_loader, probes=True)
    train_eval = DataLoader(Subset(tr, np.arange(len(tr.labels))),
                            batch_size=s["batch"])
    out.update({f"train_{k}": v for k, v in
                evaluate_imdbn(model, train_eval, probes=False).items()})
    out["train_s"] = round(t_all, 1)
    out["image_s"] = round(t_img, 1)
    return out, launches, model


def build_bimodal_dataset(s: dict) -> dict:
    """Both modalities of the bimodal protocol (quality_bimodal.py:95-115):
    numerosity images of side 100 (data seed 0), their MNIST-100 renders
    (seed 0), and the split of seed 42."""
    from multimodal_idbn_tpu_torch.data import (generate_mnist100_images,
                                                generate_numerosity_dataset,
                                                train_val_test_split)
    d = generate_numerosity_dataset(n_samples=s["n_samples"],
                                    num_classes=s["num_classes"],
                                    side=s["side"], seed=0)
    labels = d["labels"].astype(np.int64)
    mod2 = generate_mnist100_images(labels, seed=0)
    tr_i, va_i, _ = train_val_test_split(s["n_samples"], val_size=0.15,
                                         test_size=0.15, seed=42)
    return {"d": d, "labels": labels, "mod2": mod2, "train": tr_i,
            "val": va_i}


def bimodal_metrics(v1, v2, c1, c2, r1, r2) -> dict:
    """The cross MSEs (mod1 from mod2, mod2 from mod1), the clipped
    auto-reconstruction MSEs and the blank baselines
    (quality_bimodal.py:158-172)."""
    r1, r2 = np.clip(r1, 0, 1), np.clip(r2, 0, 1)
    n = v1.shape[0]
    return {
        "mod1_mse": round(float(((c1 - v1) ** 2).sum()
                                / (n * v1.shape[1])), 6),
        "mod2_mse": round(float(((c2 - v2) ** 2).sum()
                                / (n * v2.shape[1])), 6),
        "mod1_auto_mse": round(float(((r1 - v1) ** 2).mean()), 6),
        "mod2_auto_mse": round(float(((r2 - v2) ** 2).mean()), 6),
        "mod1_blank": round(float((v1 ** 2).mean()), 6),
        "mod2_blank": round(float((v2 ** 2).mean()), 6),
    }


def run_bimodal_seed(s: dict, seed: int, data: dict,
                     device: DeviceLike = None):
    """Train and evaluate one seed of the bimodal protocol
    (quality_bimodal.py:95-178); returns (the per-seed record, the
    training's kernel launches, the trained model)."""
    from multimodal_idbn_tpu_torch.data import (DataLoader,
                                                NumerosityDataset, Subset)
    from multimodal_idbn_tpu_torch.models import iMDBN_BiModal
    dev = resolve_device(device)
    d, labels, mod2 = data["d"], data["labels"], data["mod2"]

    def to_ds(idx, mode="bimodal"):
        return NumerosityDataset(
            d["images"][idx], labels[idx].astype(np.float32),
            d["onehot"][idx], d["images"][idx].sum((1, 2)),
            np.maximum(d["images"][idx].sum((1, 2)), 1.0),
            mod2_images=mod2[idx], mode=mode)

    tr_i, va_i = data["train"], data["val"]
    train_loader = DataLoader(Subset(to_ds(tr_i), np.arange(len(tr_i))),
                              batch_size=s["batch"], shuffle=True, seed=seed)
    val_loader = DataLoader(Subset(to_ds(va_i), np.arange(len(va_i))),
                            batch_size=s["batch"])
    params = make_params(s, seed)
    model = iMDBN_BiModal(list(s["mod1_layers"]), list(s["mod2_layers"]),
                          list(s["joint_layers"]), params=params,
                          dataloader=train_loader, val_loader=val_loader,
                          seed=seed, device=dev)
    model.mod1_dbn.dataloader = DataLoader(
        to_ds(tr_i, mode="multimodal"), batch_size=s["batch"], shuffle=True,
        seed=seed)
    model.mod2_dbn.dataloader = DataLoader(
        to_ds(tr_i, mode="mod2"), batch_size=s["batch"], shuffle=True,
        seed=seed + 1)
    never = 10 ** 9
    reset_launches()
    synchronize(dev)
    t0 = time.perf_counter()
    model.mod1_dbn.train(epochs=s["epochs_mod"], log_every_pca=never,
                         log_every_probe=never)
    model.mod2_dbn.train(epochs=s["epochs_mod"], log_every_pca=never,
                         log_every_probe=never)
    synchronize(dev)
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.train_joint(epochs=s["epochs_joint"], log_every=never,
                      log_every_pca=never, log_every_probe=never,
                      log_every_trajectory=never)
    synchronize(dev)
    t_joint = time.perf_counter() - t0
    launches = read_launches()
    log(f"[quality bimodal seed {seed}] pretraining {t_pre:.1f} s, joint "
        f"{t_joint:.1f} s; launches {launches}")
    parts = {k: [] for k in ("v1", "v2", "c1", "c2", "r1", "r2")}
    for m1, m2 in val_loader:
        v1 = np.asarray(m1, np.float32).reshape(len(m1), -1)
        v2 = np.asarray(m2, np.float32).reshape(len(m2), -1)
        z1 = model.mod1_dbn.represent(v1)
        z2 = model.mod2_dbn.represent(v2)
        c1, c2 = model._cross_reconstruct(z1, z2, steps=s["cross_steps"])
        for k, v in (("v1", v1), ("v2", v2),
                     ("c1", to_numpy(c1).reshape(v1.shape)),
                     ("c2", to_numpy(c2).reshape(v2.shape)),
                     ("r1", to_numpy(model.mod1_dbn.reconstruct(v1))),
                     ("r2", to_numpy(model.mod2_dbn.reconstruct(v2)))):
            parts[k].append(v)
    out = {"seed": seed}
    out.update(bimodal_metrics(*(np.concatenate(parts[k]) for k in
                                 ("v1", "v2", "c1", "c2", "r1", "r2"))))
    out["pretrain_s"] = round(t_pre, 1)
    out["joint_s"] = round(t_joint, 1)
    return out, launches, model


# --------------------------------------------------------------------------
# Statistics (benchmarks/merge_h2h.py:34-60) and Holm's correction
# --------------------------------------------------------------------------

def summarize(vals) -> str:
    v = np.asarray(vals, np.float64)
    return f"{np.median(v):.3f} [{v.min():.3f}-{v.max():.3f}]"


def compare(ref_vals, ours_vals, n_boot: int = 10_000, seed: int = 0):
    """Mann-Whitney U p-value and the bootstrap 95% CI of the median
    difference (ours - ref); deterministic (merge_h2h.py:40-60)."""
    from scipy.stats import mannwhitneyu

    a = np.asarray(ref_vals, np.float64)
    b = np.asarray(ours_vals, np.float64)
    try:
        p = float(mannwhitneyu(a, b, alternative="two-sided").pvalue)
    except ValueError:  # all values identical on both sides
        p = 1.0
    rng = np.random.default_rng(seed)
    diffs = (np.median(b[rng.integers(0, len(b), (n_boot, len(b)))],
                       axis=1)
             - np.median(a[rng.integers(0, len(a), (n_boot, len(a)))],
                         axis=1))
    lo, hi = np.percentile(diffs, [2.5, 97.5])
    return {"mwu_p": round(p, 4),
            "median_diff": round(float(np.median(b) - np.median(a)), 4),
            "diff_ci95": [round(float(lo), 4), round(float(hi), 4)],
            "n_ref": len(a), "n_ours": len(b)}


def holm(pvalues: Dict[str, float], alpha: float = ALPHA) -> Dict[str, bool]:
    """Holm's step-down rejections at family level ``alpha``: the i-th
    smallest of m p-values is rejected while p ≤ α / (m − i + 1)."""
    m = len(pvalues)
    out = dict.fromkeys(pvalues, False)
    for i, (name, p) in enumerate(sorted(pvalues.items(),
                                         key=lambda kv: kv[1])):
        if p > alpha / (m - i):
            break
        out[name] = True
    return out


def compare_pools(ours: Dict[str, dict], arm: Dict[str, dict],
                  metrics: Sequence[str], alpha: float = ALPHA) -> dict:
    """{metric: compare(arm, ours) with both summaries and Holm's verdict
    over ``metrics``}; seeds with a null record are left out."""
    out = {}
    for m in metrics:
        a = [r[m] for r in arm.values() if r and m in r]
        b = [r[m] for r in ours.values() if r and m in r]
        out[m] = dict(compare(a, b), arm=summarize(a), ours=summarize(b))
    for m, rejected in holm({m: v["mwu_p"] for m, v in out.items()},
                            alpha).items():
        out[m]["holm_reject"] = rejected
    return out


def recorded_arms(kind: str) -> Dict[str, Dict[str, dict]]:
    """The recorded pools the port is held against: flagship, the JAX arm
    (n = 26) and the reference arm (n = 13) of head_to_head_r5_pooled.json;
    bimodal, the JAX arm (n = 11) of quality_bimodal_r5.json."""
    if kind == "flagship":
        d = json.loads(RECORDED_FLAGSHIP.read_text())
        return {"jax": d["ours"], "reference": d["ref"]}
    return {"jax": json.loads(RECORDED_BIMODAL.read_text())["seeds"]}


def collapsed(kind: str, pool: Dict[str, dict], blank: float = None):
    """Collapsed seeds: bimodal by the recorded pool's criterion
    (``BIMODAL_COLLAPSE``); flagship by the image stack's retry criterion,
    validation auto-reconstruction at or above 0.9 × the blank baseline
    (models/idbn.py ``_warn_if_collapsed``), with ``blank`` the validation
    images' mean square."""
    if kind == "bimodal":
        return sorted((s for s, r in pool.items()
                       if r["mod2_mse"] >= 0.9 * r["mod2_blank"]), key=int)
    return sorted((s for s, r in pool.items()
                   if r["recon_mse"] >= 0.9 * blank), key=int)


def comparison(kind: str, paths: Sequence[str]) -> dict:
    """The port's pool from ``paths`` against each recorded arm."""
    merged = merge_files(kind, paths)
    pool = merged["ours" if kind == "flagship" else "seeds"]
    metrics = FLAGSHIP_METRICS if kind == "flagship" else BIMODAL_METRICS
    want = json.loads(json.dumps(FLAGSHIP if kind == "flagship"
                                 else BIMODAL))
    out = {"kind": kind, "files": [str(p) for p in paths],
           "n_ours": len(pool), "seeds": sorted(pool, key=int), "arms": {},
           "schedule_matches": all(
               json.loads(Path(p).read_text()).get("schedule") == want
               for p in paths)}
    for arm, recs in recorded_arms(kind).items():
        out["arms"][arm] = {"n": len(recs), "stats": compare_pools(
            pool, recs, metrics)}
        if kind == "bimodal":
            out["arms"][arm]["collapsed"] = collapsed(kind, recs)
    out["collapsed"] = collapsed(kind, pool, merged.get("blank", {})
                                 .get("val"))
    return out


def comparison_table(cmp: dict) -> str:
    """Markdown: one row per metric and arm."""
    lines = ["| metric | arm | arm median [range] | port median [range] | "
             "MWU p | Δmedian [95% CI] | Holm |", "|---|---|---|---|---|---|"
             "---|"]
    for arm, a in cmp["arms"].items():
        for m, st in a["stats"].items():
            lines.append(
                f"| {m} | {arm} (n={st['n_ref']}) | {st['arm']} | "
                f"{st['ours']} (n={st['n_ours']}) | {st['mwu_p']:.4f} | "
                f"{st['median_diff']:+.4f} [{st['diff_ci95'][0]:+.4f}, "
                f"{st['diff_ci95'][1]:+.4f}] | "
                f"{'rejected' if st['holm_reject'] else '-'} |")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# Command line
# --------------------------------------------------------------------------

def _nvidia_smi() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _write(path: Optional[str], obj: dict) -> None:
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(obj, indent=1))


def run_pool(kind: str, seeds: Sequence[int], out: Optional[str],
             device: DeviceLike = None, quick: bool = False) -> dict:
    """Run ``seeds`` one after another in this process and write the
    pool's file after every seed; returns its content. ``quick``: the
    flagship protocol's QUICK schedule."""
    dev = resolve_device(device)
    set_matmul_precision(MATMUL_PRECISION)
    meta = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"), "nvidia_smi": (
                           _nvidia_smi() if dev.type == "cuda" else None),
            "torch": torch.__version__}
    launches, digests, stacks, phase_s = {}, {}, {}, {}
    if kind == "flagship":
        s = QUICK if quick else FLAGSHIP
        data = build_dataset(s)
        n_train = len(data["train_y"])
        res = {"schedule": s, "seeds": list(seeds),
               "matmul_precision": MATMUL_PRECISION, "init_retry": 0,
               "ref": {}, "ours": {},
               "blank": {k: round(float((data[f"{k}_img"] ** 2).mean()), 6)
                         for k in ("val", "train")}}
    else:
        s = BIMODAL
        data = build_bimodal_dataset(s)
        n_train = len(data["train"])
        res = {"benchmark": "quality_bimodal (the port), "
               f"N={s['n_samples']} K={s['num_classes']}",
               "command": "python -m multimodal_idbn_tpu_torch.quality "
               f"bimodal --seeds {' '.join(map(str, seeds))}",
               "schedule": s, "matmul_precision": MATMUL_PRECISION,
               "collapse_criterion": BIMODAL_COLLAPSE, "seeds": {}}
    res.update(meta, derived_launches=derived_launches(kind, s, n_train),
               launches=launches, digests=digests, stack_digests=stacks,
               phase_s=phase_s)
    for seed in seeds:
        if kind == "flagship":
            rec, launches[str(seed)], model = run_flagship_seed(
                s, seed, data, dev)
            phase_s[str(seed)] = {"image_s": rec.pop("image_s")}
            res["ours"][str(seed)] = rec
        else:
            rec, launches[str(seed)], model = run_bimodal_seed(
                s, seed, data, dev)
            res["seeds"][str(seed)] = rec
            bad = collapsed("bimodal", res["seeds"])
            res.update(collapsed_seeds=bad,
                       collapse_rate=f"{len(bad)}/{len(res['seeds'])}")
        digests[str(seed)] = state_digest(model)
        stacks[str(seed)] = stack_digests(model)
        del model
        log(f"[quality {kind} seed {seed}] {json.dumps(rec)}")
        _write(out, res)
    recs = res["ours"] if kind == "flagship" else res["seeds"]
    metrics = FLAGSHIP_METRICS if kind == "flagship" else BIMODAL_METRICS
    res["summary"] = {m: summarize([r[m] for r in recs.values()])
                      for m in metrics}
    _write(out, res)
    return res


def merge_files(kind: str, paths: Sequence[Path]) -> dict:
    """One pool file from pool files of ``run_pool`` (records, launches
    and digests united; the first file's settings). A seed must not be in
    two files."""
    key = "ours" if kind == "flagship" else "seeds"
    files = [json.loads(Path(p).read_text()) for p in paths]
    res = dict(files[0])
    for k in (key, "launches", "digests", "stack_digests", "phase_s"):
        res[k] = {}
        for p, f in zip(paths, files):
            if k not in f:
                continue
            if k == key and set(res[k]) & set(f[k]):
                raise ValueError(f"{p} repeats seeds "
                                 f"{sorted(set(res[k]) & set(f[k]))}")
            res[k].update(f[k])
    order = sorted(res[key], key=int)
    res[key] = {s: res[key][s] for s in order}
    metrics = FLAGSHIP_METRICS if kind == "flagship" else BIMODAL_METRICS
    res["summary"] = {m: summarize([r[m] for r in res[key].values()])
                      for m in metrics}
    if kind == "flagship":
        res["seeds"] = [int(s) for s in order]
    else:
        bad = collapsed("bimodal", res[key])
        res.update(collapsed_seeds=bad,
                   collapse_rate=f"{len(bad)}/{len(order)}",
                   command="python -m multimodal_idbn_tpu_torch.quality "
                   f"bimodal --seeds {' '.join(order)}")
    return res


def run_pools(flagship: Sequence[int], bimodal: Sequence[int], outdir: str,
              jobs: int) -> dict:
    """Both pools on the card: one process per seed (``python -m
    multimodal_idbn_tpu_torch.quality <kind> --seeds N``), ``jobs`` at a
    time, the bimodal seeds (the longer) first, the kernels built before
    any starts; then the first seed of each pool once more alone on the
    card, its digest held against its pool run's (``repeat``). Writes
    ``{outdir}/{kind}.json`` and returns {kind: that file's content}."""
    from multimodal_idbn_tpu_torch.ops import (_cuda, chain, half_step,
                                               philox_fill)
    out = Path(outdir)
    (out / "seeds").mkdir(parents=True, exist_ok=True)
    _cuda.build_all([half_step.KERNEL, chain.KERNEL, philox_fill.KERNEL])
    # the host's cores shared out: torch's CPU threads would otherwise
    # oversubscribe them jobs times over
    env = dict(os.environ, OMP_NUM_THREADS=str(max(
        1, (os.cpu_count() or 1) // max(1, jobs))))

    def start(kind, seed, tag):
        path = out / "seeds" / f"{kind}-{seed}{tag}.json"
        logf = open(path.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "multimodal_idbn_tpu_torch.quality",
             kind, "--seeds", str(seed), "--out", str(path)],
            stdout=logf, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
        logf.close()
        return proc, path

    queue = [("bimodal", s) for s in bimodal] + [("flagship", s)
                                                  for s in flagship]
    done: Dict[str, List[Path]] = {"flagship": [], "bimodal": []}
    running, failed = [], []
    t0 = time.perf_counter()
    try:
        while queue or running:
            while queue and len(running) < jobs:
                kind, seed = queue.pop(0)
                running.append((kind, seed, *start(kind, seed, "")))
            time.sleep(2)
            for item in running[:]:
                kind, seed, proc, path = item
                if proc.poll() is None:
                    continue
                running.remove(item)
                (done[kind] if proc.returncode == 0 else failed).append(
                    path)
                log(f"[pools] {kind} seed {seed}: exit {proc.returncode} "
                    f"at {time.perf_counter() - t0:.0f} s")
    finally:
        for _, _, proc, _ in running:
            proc.kill()
            proc.wait()
    if failed:
        raise RuntimeError(f"seeds failed: {[str(p) for p in failed]}")
    pools = {}
    for kind in ("flagship", "bimodal"):
        if not done[kind]:
            continue
        res = merge_files(kind, done[kind])
        res["pool_wall_s"] = round(time.perf_counter() - t0, 1)
        res["jobs"] = jobs
        seed = (flagship if kind == "flagship" else bimodal)[0]
        proc, path = start(kind, seed, "-alone")
        if proc.wait() != 0:
            raise RuntimeError(f"{kind} seed {seed} alone failed")
        alone = json.loads(path.read_text())["digests"][str(seed)]
        res["repeat"] = {"seed": seed, "alone_digest": alone,
                         "bit_equal": alone == res["digests"][str(seed)]}
        log(f"[pools] {kind} seed {seed} alone: bit-equal to its pool "
            f"run: {res['repeat']['bit_equal']}")
        _write(str(out / f"{kind}.json"), res)
        pools[kind] = res
    return pools


def same_seeds(files: Sequence[str]) -> dict:
    """{seed: verdict} of the seeds two pool files share: the digest of
    every trained state and every metric equal (the seconds aside), and
    the launches. ``equal`` is True when every shared seed is."""
    a, b = (json.loads(Path(f).read_text()) for f in files)
    recs = [d.get("ours") or d.get("seeds") for d in (a, b)]
    out = {}
    for seed in sorted(set(recs[0]) & set(recs[1]), key=int):
        ra, rb = ({k: v for k, v in r[seed].items() if not k.endswith("_s")}
                  for r in recs)
        out[seed] = {
            "digest": a["digests"][seed] == b["digests"][seed],
            "metrics": ra == rb,
            "launches": a["launches"][seed] == b["launches"][seed],
            "differing": sorted(k for k in set(ra) | set(rb)
                                if ra.get(k) != rb.get(k))}
    return {"seeds": out, "equal": bool(out) and all(
        v["digest"] and v["metrics"] and v["launches"]
        for v in out.values())}


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        prog="python -m multimodal_idbn_tpu_torch.quality",
        description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for kind in ("flagship", "bimodal"):
        p = sub.add_parser(kind, help=f"run a {kind} seed pool")
        p.add_argument("--seeds", type=int, nargs="+", required=True)
        p.add_argument("--out", default=None)
        p.add_argument("--device", default=None, help="cuda (default) | cpu")
        if kind == "flagship":
            p.add_argument("--quick", action="store_true",
                           help="the protocol's QUICK schedule")
    p = sub.add_parser("pools", help="run both pools on the card, "
                                     "--jobs seeds at a time")
    p.add_argument("--flagship", type=int, nargs="*", default=[])
    p.add_argument("--bimodal", type=int, nargs="*", default=[])
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--outdir", required=True)
    p = sub.add_parser("compare", help="hold port pool files against the "
                                       "recorded arms")
    p.add_argument("kind", choices=["flagship", "bimodal"])
    p.add_argument("files", nargs="+")
    p.add_argument("--out", default=None)
    p = sub.add_parser("same", help="are the seeds two pool files share "
                                    "bit-equal (digests, metrics, "
                                    "launches)?")
    p.add_argument("files", nargs=2)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    if args.cmd == "pools":
        return run_pools(args.flagship, args.bimodal, args.outdir, args.jobs)
    if args.cmd == "same":
        res = same_seeds(args.files)
        print(json.dumps(res))
        if not res["equal"]:
            raise SystemExit(1)
        return res
    if args.cmd == "compare":
        cmp = comparison(args.kind, args.files)
        print(comparison_table(cmp))
        if not cmp["schedule_matches"]:
            print("warning: a file's schedule is not the recorded pool's")
        print(f"collapsed seeds of the port: {cmp['collapsed']} of "
              f"{cmp['n_ours']}")
        _write(args.out, cmp)
        return cmp
    return run_pool(args.cmd, args.seeds, args.out, args.device,
                    quick=getattr(args, "quick", False))


if __name__ == "__main__":
    main()
