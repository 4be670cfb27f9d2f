"""Train the bimodal DBN (numerosity + MNIST-100).

Port of scripts/train_bimodal.py: it reads the same YAML configs, maps
them to the same UPPERCASE params (:44-83) and runs the same flow
(:225-359): the MOD1 iDBN and then the MOD2 iDBN (each pretrained, or
trained on a loader of its own modality, :116-160, with ``init_retry``
through ``train_with_retry``, then the optional last-layer fine-tune), the
joint DBN, the save. Run it as

    python -m multimodal_idbn_tpu_torch.train_bimodal \
        --config configs/bimodal_training_config.yaml [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU. ``training.checkpoint_every`` makes every phase resumable as in
``train_multimodal`` (phases "mod1", "mod2", "bimodal_joint"; a
phase-complete marker keeps a crash in a later phase from retraining an
earlier one). ``wandb.enable: true`` logs the diagnostics as in
``train_multimodal`` (scripts/train_bimodal.py:86-114, :180-221,
:342-345). The opt-in variants run as in ``train_multimodal``:
``training.dtype``, ``compute_dtype``, ``stochastic_rounding`` (:76-81),
``matmul_precision`` (:170-175) and ``dataset.distribution: zipfian``
(which the JAX script leaves unread; the port does not ignore a
setting). ``model.mod1_visible`` / ``mod2_visible`` ("bernoulli", the
default, "gaussian" or "replicated_softmax") and ``mod1_visible_lr_scale``
/ ``mod2_visible_lr_scale`` set each modality stack's visible units and
their rate (``iMDBN_BiModal``), as the multimodal DBN of
``configs/mdbn_flickr_training_config.yaml`` does; with
``dataset.second_modality: tags`` its data are the synthetic image
features and tag counts of ``data.create_dataloaders_features_tags``. Data parallelism (``training.dp_devices: N``, :68) runs as in
``train_multimodal``: one process per device under ``torchrun
--nproc-per-node N -m multimodal_idbn_tpu_torch.train_bimodal``, all three
phases over the mesh, rank 0 alone printing and writing files.
The model is saved as ``{save_dir}/{save_name}.pkl``
(``iMDBN_BiModal.save_model``).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from multimodal_idbn_tpu_torch.checkpoint import (
    cli_checkpoint_paths, config_fingerprint,
    load_train_checkpoint_expecting, remove_checkpoints,
    save_train_checkpoint)
from multimodal_idbn_tpu_torch.data import (DataLoader, NumerosityDataset,
                                            create_dataloaders_features_tags)
from multimodal_idbn_tpu_torch.device import (resolve_device,
                                              set_matmul_precision,
                                              synchronize)
from multimodal_idbn_tpu_torch.models.imdbn_bimodal import iMDBN_BiModal
from multimodal_idbn_tpu_torch.ops.fast_cd import VISIBLE_TYPES
from multimodal_idbn_tpu_torch.parallel.distributed import is_main_process
from multimodal_idbn_tpu_torch.train_multimodal import (build_logging_params,
                                                        check_common,
                                                        join_process_group,
                                                        load_config,
                                                        make_loaders,
                                                        matmul_precision,
                                                        maybe_wandb,
                                                        train_dbn)

DEFAULT_CONFIG_PATH = (Path(__file__).resolve().parent.parent / "configs"
                       / "bimodal_training_config.yaml")


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        "Train bimodal DBN (Numerosity + MNIST-100) (PyTorch/CUDA port)")
    ap.add_argument("--config", type=Path, default=DEFAULT_CONFIG_PATH)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def check_supported(cfg: dict) -> None:
    """Raise ``ValueError`` for a setting this entry point cannot run:
    more ``dp_devices`` than processes, or a dataset without a second
    modality (as scripts/train_bimodal.py:196-204)."""
    check_common(cfg)
    model = cfg.get("model", {}) or {}
    for mod in ("mod1", "mod2"):
        vis = model.get(f"{mod}_visible")
        if vis is not None and vis not in VISIBLE_TYPES:
            raise ValueError(f"model.{mod}_visible: {vis!r} is not one of "
                             f"{VISIBLE_TYPES}")
    if not (cfg.get("dataset", {}) or {}).get("second_modality"):
        raise ValueError(
            "bimodal training needs a second modality but the dataset has "
            "none — set dataset.second_modality (e.g. 'mnist100') in the "
            "config")


def build_params(cfg: dict) -> dict:
    """YAML → UPPERCASE params (scripts/train_bimodal.py:44-83)."""
    t = cfg.get("training", {}) or {}
    return {
        "LEARNING_RATE": t.get("learning_rate", 0.1),
        "WEIGHT_PENALTY": t.get("weight_penalty", 1e-4),
        "INIT_MOMENTUM": t.get("init_momentum", 0.5),
        "FINAL_MOMENTUM": t.get("final_momentum", 0.95),
        "LEARNING_RATE_DYNAMIC": t.get("learning_rate_dynamic", True),
        "CD": t.get("cd", 1),
        "EPOCHS_MOD1": t.get("epochs_mod1", 100),
        "EPOCHS_MOD2": t.get("epochs_mod2", 100),
        "EPOCHS_JOINT": t.get("epochs_joint", 200),
        "JOINT_LEARNING_RATE": t.get("joint_learning_rate",
                                     t.get("learning_rate", 0.1)),
        "JOINT_CD": t.get("joint_cd", t.get("cd", 1)),
        "CROSS_GIBBS_STEPS": t.get("cross_gibbs_steps", 50),
        "USE_AUX": t.get("use_aux", True),
        "JOINT_AUX_COND_STEPS": t.get("JOINT_AUX_COND_STEPS",
                                      t.get("aux_cond_steps", 50)),
        "JOINT_AUX_EVERY_K": t.get("JOINT_AUX_EVERY_K", 10),
        "CROSS_METRICS_EVERY": t.get("cross_metrics_every", 1),
        "DP_DEVICES": t.get("dp_devices"),
        "INIT_RETRY": t.get("init_retry", 0),
        "CHECKPOINT_EVERY": t.get("checkpoint_every", 0),
        "DTYPE": t.get("dtype", "float32"),
        "COMPUTE_DTYPE": t.get("compute_dtype"),
        "SR": t.get("stochastic_rounding"),
        "SEED": t.get("seed", 0),
        **visible_params(cfg.get("model", {}) or {}),
    }


def visible_params(model: dict) -> dict:
    """The modality stacks' visible types and rate factors as params
    (``MOD1_VISIBLE``, ...), only where the YAML sets them: a YAML without
    them builds, and fingerprints, the Bernoulli model as before."""
    out = {}
    for mod in ("mod1", "mod2"):
        for key in ("visible", "visible_lr_scale"):
            if model.get(f"{mod}_{key}") is not None:
                out[f"{mod.upper()}_{key.upper()}"] = model[f"{mod}_{key}"]
    return out


def modality_loader(train_loader, modality_idx: int) -> DataLoader:
    """One modality of the bimodal training split (+ its labels) as a
    loader of its own, for that modality's iDBN
    (scripts/train_bimodal.py:116-139)."""
    base, idx = train_loader.dataset.dataset, np.asarray(
        train_loader.dataset.indices)
    source = base.images if modality_idx == 0 else base.mod2_images
    ds = NumerosityDataset(
        images=source[idx], labels=np.asarray(base.labels)[idx],
        onehot=base.onehot[idx], cumArea=np.asarray(base.cumArea_list)[idx],
        CH=np.asarray(base.CH_list)[idx])
    return DataLoader(ds, batch_size=train_loader.batch_size, shuffle=True)


def main(argv: Optional[List[str]] = None,
         params: Optional[dict] = None) -> dict:
    """Run the flow; returns a summary: per-phase wall seconds, both
    modality CD loss histories, the last cross-reconstruction MSEs and the
    save path.
    ``params`` is laid over the params built from the YAML: keys the YAML
    does not express, such as ``PCD``, which the JAX package too reaches
    only through the params dict. No command-line option sets it."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    join_process_group(cfg)
    device = resolve_device(args.device)
    check_supported(cfg)
    main_rank = is_main_process()
    set_matmul_precision(matmul_precision(cfg))
    dataset = cfg.get("dataset", {}) or {}
    model = cfg.get("model", {}) or {}
    params = dict(build_params(cfg), **(params or {}))
    log_params = build_logging_params(cfg)

    t0 = time.perf_counter()
    if dataset.get("second_modality") == "tags":
        train_loader, val_loader, _ = create_dataloaders_features_tags(
            n_features=model["mod1_layers"][0],
            vocab=model["mod2_layers"][0],
            batch_size=dataset.get("batch_size", 128),
            num_classes=model.get("num_labels", 32),
            n_samples=dataset.get("n_samples", 512),
            max_words=dataset.get("max_words", 10))
    else:
        train_loader, val_loader, _ = make_loaders(dataset, "train_bimodal")(
            data_path=dataset.get("path"), data_name=dataset.get("name"),
            batch_size=dataset.get("batch_size", 128),
            second_modality=dataset.get("second_modality"),
            mnist100_path=dataset.get("mnist100_path"),
            num_classes=model.get("num_labels", 32),
            n_samples=dataset.get("n_samples", 512),
            side=dataset.get("side", 100))
    joint_hidden = model.get("joint_hidden", 500)
    wandb_run = (maybe_wandb(cfg, params, project="bimodal-idbn-tpu")
                 if main_rank else None)
    bimodal = iMDBN_BiModal(
        layer_sizes_mod1=model.get("mod1_layers", [10000, 1500, 500]),
        layer_sizes_mod2=model.get("mod2_layers", [1568, 500, 500]),
        joint_layer_sizes=joint_hidden, params=params,
        dataloader=train_loader, val_loader=val_loader, device=device,
        seed=params.get("SEED"), wandb_run=wandb_run,
        logging_cfg=cfg.get("logging", {}) or {})
    synchronize(device)
    seconds = {"setup": time.perf_counter() - t0}

    # Crash-safe resume (scripts/train_bimodal.py:225-283): a joint
    # checkpoint restores every RBM of the model, so both modality phases
    # are skipped; else each modality resumes from its own checkpoint.
    t_cfg = cfg.get("training", {}) or {}
    paths = cfg.get("paths", {}) or {}
    ckpt_every = int(params.get("CHECKPOINT_EVERY", 0) or 0)
    ckpts = {"mod1": None, "mod2": None, "bimodal_joint": None}
    start = {"mod1": 0, "mod2": 0, "bimodal_joint": 0}
    done = {"mod1": False, "mod2": False}
    dbns = {"mod1": bimodal.mod1_dbn, "mod2": bimodal.mod2_dbn}
    fp = config_fingerprint(
        params,
        mod1_layers=model.get("mod1_layers", [10000, 1500, 500]),
        mod2_layers=model.get("mod2_layers", [1568, 500, 500]),
        joint_layers=([joint_hidden] if isinstance(joint_hidden, int)
                      else joint_hidden),
        matmul_precision=matmul_precision(cfg))
    for m in (bimodal, *dbns.values()):
        m._ckpt_fingerprint = fp
    ignore_cfg = bool(t_cfg.get("resume_ignore_config", False))
    if ckpt_every > 0:
        ckpts = cli_checkpoint_paths(cfg, tuple(ckpts))
        if ckpts["bimodal_joint"].exists():
            start["bimodal_joint"] = load_train_checkpoint_expecting(
                bimodal, ckpts["bimodal_joint"], "bimodal_joint",
                ignore_config=ignore_cfg)
            done = {"mod1": True, "mod2": True}
            print(f"[train_bimodal] resuming joint training at epoch "
                  f"{start['bimodal_joint']}/{params['EPOCHS_JOINT']}")
        else:
            for name, dbn in dbns.items():
                if not ckpts[name].exists():
                    continue
                epochs = int(params[f"EPOCHS_{name.upper()}"])
                start[name] = load_train_checkpoint_expecting(
                    dbn, ckpts[name], name, ignore_config=ignore_cfg)
                done[name] = start[name] >= epochs
                print(f"[train_bimodal] resuming {name.upper()} training "
                      f"at epoch {start[name]}/{epochs}")

    # 1), 2) the modality DBNs: load if available, otherwise train
    for i, (name, dbn) in enumerate(dbns.items()):
        epochs = params[f"EPOCHS_{name.upper()}"]
        t = time.perf_counter()
        pre = paths.get(f"{name}_pretrained")
        loader = getattr(bimodal, f"load_pretrained_{name}_dbn")
        if not (done[name] or (pre and loader(pre))):
            print(f"Training {name.upper()} iDBN for {epochs} epochs..."
                  if not pre else f"[main] fallback: training "
                  f"{name.upper()} iDBN from scratch...")
            dbn.dataloader = modality_loader(train_loader, i)
            train_dbn(dbn, epochs, int(params.get("INIT_RETRY", 0) or 0),
                      start[name],
                      dict({"checkpoint_every": ckpt_every,
                            "checkpoint_path": str(ckpts[name]),
                            "checkpoint_phase": name} if ckpt_every else {},
                           log_every_pca=log_params["LOG_EVERY_PCA"],
                           log_every_probe=log_params["LOG_EVERY_PROBE"]),
                      f"train_bimodal {name.upper()}")
        ft = int(paths.get(f"{name}_finetune_last_epochs", 0) or 0)
        if ft > 0 and not done[name]:
            getattr(bimodal, f"finetune_{name}_last_layer")(epochs=ft,
                                                            lr_scale=0.3)
        if ckpt_every and not done[name]:
            # phase-complete marker, after the fine-tune hook
            save_train_checkpoint(dbn, str(ckpts[name]), phase=name,
                                  next_epoch=int(epochs),
                                  loss_history=dbn.loss_history)
        synchronize(device)
        seconds[name] = time.perf_counter() - t

    # 3) joint training
    print("Training joint RBM...")
    t = time.perf_counter()
    bimodal.train_joint(
        params["EPOCHS_JOINT"], log_every=log_params["LOG_EVERY"],
        log_every_pca=log_params["LOG_EVERY_PCA"],
        log_every_probe=log_params["LOG_EVERY_PROBE"],
        log_every_trajectory=log_params["LOG_EVERY_TRAJECTORY"],
        **({"checkpoint_every": ckpt_every,
            "checkpoint_path": str(ckpts["bimodal_joint"]),
            "start_epoch": start["bimodal_joint"]} if ckpt_every else {}))
    synchronize(device)
    seconds["joint"] = time.perf_counter() - t

    save_dir = Path(paths.get("save_dir", "./networks")).expanduser()
    save_dir.mkdir(parents=True, exist_ok=True)
    save_path = save_dir / f"{paths.get('save_name', 'bimodal_trained')}.pkl"
    if main_rank:
        bimodal.save_model(str(save_path))
        print(f"Saved bimodal model to {save_path}")
        if ckpt_every:  # the run completed and the model is saved
            remove_checkpoints(ckpts.values())
    if wandb_run:
        wandb_run.finish()

    m = bimodal.last_metrics or {}
    summary = {
        "device": str(device),
        "seconds": seconds,
        "mod1_loss": list(bimodal.mod1_dbn.loss_history),
        "mod2_loss": list(bimodal.mod2_dbn.loss_history),
        "cross_metrics": bimodal.last_metrics,
        "mse_mod1": m.get("cross_modality/mod1_mse"),
        "mse_mod2": m.get("cross_modality/mod2_mse"),
        "save_path": str(save_path),
        "model": bimodal,
    }
    if main_rank:
        print("[train_bimodal] phases (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
              + f"; last cross metrics {bimodal.last_metrics}")
    return summary


if __name__ == "__main__":
    main()
