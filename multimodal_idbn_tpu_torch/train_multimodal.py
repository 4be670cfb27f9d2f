"""Train the multimodal iDBN (image) + joint RBM with a label softmax group.

Port of scripts/train_multimodal.py: it reads the same YAML configs,
maps them to the same UPPERCASE params (:42-84) and runs the same flow
(:184-292): image iDBN (pretrained, or trained, with ``init_retry`` through
``train_with_retry``), the optional last-layer fine-tune, joint training,
save. Run it as

    python -m multimodal_idbn_tpu_torch.train_multimodal \
        --config configs/multimodal_training_config.yaml [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU. With ``training.checkpoint_every: N`` a resumable checkpoint is
written every N epochs under ``paths.checkpoint_dir`` (default
``{save_dir}/checkpoints``); running the same command again continues
bit-identically from the last one, refuses if the training configuration
changed (unless ``training.resume_ignore_config``), and the checkpoints
are removed after the final save. With ``wandb.enable: true`` the run
object of ``wandb.init`` (``utils.wandb_compat``: the wandb package where
it is installed; else replace ``wandb_compat.wandb.init`` to hand in a run
object of one's own) receives the diagnostics at the ``logging:``
cadences (:87-119, :165-178, :246-279, :294-295): losses, timings, PCA
correlations, linear probes, snapshots and the extras the ``logging:``
sections enable.

The opt-in variants of the JAX script run too (:78-82, :133-153):
``training.dtype`` (bf16 storage), ``compute_dtype`` (mixed precision),
``stochastic_rounding``, ``matmul_precision``
(``device.set_matmul_precision``) and ``dataset.distribution: zipfian``
(``create_dataloaders_zipfian``); PCD is reached through ``params["PCD"]``,
as in the JAX package. No setting is ignored. The model is saved as
``{save_dir}/{save_name}.pkl`` (``iMDBN.save_model``; ``python -m
multimodal_idbn_tpu_torch.generate`` serves it).

Data parallelism (``training.dp_devices: N``, :67, :180) runs one process
per device, started by a launcher:

    torchrun --nproc-per-node N -m multimodal_idbn_tpu_torch.train_multimodal \
        --config <config with training.dp_devices: N>

Each process joins the launcher's group (``parallel.initialize_distributed``)
and trains its rows of every batch on its device; N > 1 without such a
group raises ``ValueError``. Rank 0 alone prints the summary and writes
the checkpoints, the pickle and the run's logs; every rank resumes from
the same checkpoints.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional

import yaml

from multimodal_idbn_tpu_torch.checkpoint import (
    cli_checkpoint_paths, config_fingerprint,
    load_train_checkpoint_expecting, remove_checkpoints)
from multimodal_idbn_tpu_torch.data import (create_dataloaders_uniform,
                                            create_dataloaders_zipfian)
from multimodal_idbn_tpu_torch.device import (resolve_device,
                                              set_matmul_precision,
                                              synchronize)
from multimodal_idbn_tpu_torch.models import iMDBN
from multimodal_idbn_tpu_torch.parallel.distributed import (
    initialize_distributed, is_main_process, process_rank_and_count)
from multimodal_idbn_tpu_torch.utils.wandb_compat import wandb

DEFAULT_CONFIG_PATH = (Path(__file__).resolve().parent.parent / "configs"
                       / "multimodal_training_config.yaml")


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        "Train a multimodal iDBN (image) + joint RBM with label softmax "
        "(PyTorch/CUDA port)")
    ap.add_argument("--config", type=Path, default=DEFAULT_CONFIG_PATH)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def load_config(path: Path) -> dict:
    with path.open("r") as f:
        return yaml.safe_load(f)


def join_process_group(cfg: dict) -> None:
    """Join a launcher's process group when ``training.dp_devices`` asks
    for data parallelism; shared by the training entry points."""
    if (cfg.get("training", {}) or {}).get("dp_devices"):
        initialize_distributed()


def check_common(cfg: dict) -> None:
    """Raise ``ValueError`` for a ``training.dp_devices`` of more devices
    than this process's group has, as JAX's "requested N devices, have M"
    (parallel/data_parallel.py:44-51); shared by the training entry
    points."""
    t = cfg.get("training", {}) or {}
    n = t.get("dp_devices")
    if not n or str(n).lower() == "all":
        return
    have = process_rank_and_count()[1]
    if int(n) > have:
        raise ValueError(
            f"training.dp_devices={n}: requested {n} devices, have {have}. "
            f"Data parallelism runs one process per device: launch with "
            f"torchrun --nproc-per-node {n} -m <entry point> --config ...")


def make_loaders(dataset: dict, tag: str = "train_multimodal"):
    """The loader factory of ``dataset.distribution``: zipfian or uniform
    (scripts/train_multimodal.py:149-153)."""
    if dataset.get("distribution") == "zipfian":
        print(f"[{tag}] zipfian class distribution")
        return create_dataloaders_zipfian
    return create_dataloaders_uniform


def check_supported(cfg: dict) -> None:
    """Raise for every setting this entry point cannot run."""
    check_common(cfg)


def build_params(cfg: dict) -> dict:
    """YAML → UPPERCASE params (scripts/train_multimodal.py:42-84)."""
    t = cfg.get("training", {}) or {}
    return {
        "LEARNING_RATE": t.get("learning_rate", 0.1),
        "WEIGHT_PENALTY": t.get("weight_penalty", 1e-4),
        "INIT_MOMENTUM": t.get("init_momentum", 0.5),
        "FINAL_MOMENTUM": t.get("final_momentum", 0.95),
        "LEARNING_RATE_DYNAMIC": t.get("learning_rate_dynamic", True),
        "CD": t.get("cd", 1),
        "EPOCHS_IMG": t.get("epochs_image", 100),
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
    }


def build_logging_params(cfg: dict) -> dict:
    """The logging cadences the entry points pass to ``train`` /
    ``train_joint`` (scripts/train_multimodal.py:87-98); the models read
    the energy, neighbour and convergence cadences from their
    ``logging_cfg``."""
    log_cfg = cfg.get("logging", {}) or {}
    return {
        "LOG_EVERY": log_cfg.get("log_every", 5),
        "LOG_EVERY_PCA": log_cfg.get("log_every_pca", 25),
        "LOG_EVERY_PROBE": log_cfg.get("log_every_probe", 10),
        "LOG_EVERY_TRAJECTORY": log_cfg.get("log_every_trajectory", 50),
    }


def maybe_wandb(cfg: dict, params: dict,
                project: str = "multimodal-idbn-tpu"):
    """The run object of ``wandb.init`` when the YAML's ``wandb.enable``
    is set, else None (scripts/train_multimodal.py:101-119); a run that
    cannot start disables logging and says why."""
    wcfg = cfg.get("wandb", {}) or {}
    if not wcfg.get("enable", False):
        return None
    try:
        run = wandb.init(project=wcfg.get("project", project),
                         entity=wcfg.get("entity"),
                         name=wcfg.get("run_name"), config=cfg)
        if run is not None and getattr(run, "config", None) is not None:
            run.config.update({"_derived_params": params},
                              allow_val_change=True)
        return run
    except Exception as e:  # a run that cannot start must not stop training
        print(f"[maybe_wandb] disabled ({e})")
        return None


def train_dbn(dbn, epochs: int, init_retry: int, start_epoch: int,
              train_kw: dict, tag: str) -> None:
    """Train one iDBN phase, through ``train_with_retry`` when
    ``training.init_retry`` asks for it. With ``start_epoch`` the first
    attempt continues a restored run and the collapse check still runs at
    its end (scripts/train_multimodal.py:238-255). ``train_kw``: the
    checkpoint and logging-cadence arguments of ``iDBN.train``."""
    if init_retry > 0:
        retries = dbn.train_with_retry(epochs, max_retries=init_retry,
                                       start_epoch=start_epoch, **train_kw)
        if retries:
            print(f"[{tag}] init_retry: re-initialized {retries} time(s) "
                  f"after blank-level recon")
    else:
        dbn.train(epochs, start_epoch=start_epoch, **train_kw)


def matmul_precision(cfg: dict) -> str:
    return str((cfg.get("training", {}) or {}).get("matmul_precision",
                                                   "highest"))


def main(argv: Optional[List[str]] = None,
         params: Optional[dict] = None) -> dict:
    """Run the flow; returns a summary: per-phase wall seconds, the image
    CD loss history, the last cross-modal metrics and the save path.
    ``params`` is laid over the params built from the YAML: keys the YAML
    does not express, such as ``PCD``, which the JAX package too reaches
    only through the params dict. No command-line option sets it."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    join_process_group(cfg)
    device = resolve_device(args.device)
    check_supported(cfg)
    main_rank = is_main_process()
    # true fp32 products unless training.matmul_precision says otherwise
    # (scripts/train_multimodal.py:127-131)
    set_matmul_precision(matmul_precision(cfg))
    dataset = cfg.get("dataset", {}) or {}
    model = cfg.get("model", {}) or {}
    params = dict(build_params(cfg), **(params or {}))
    log_params = build_logging_params(cfg)

    t0 = time.perf_counter()
    train_loader, val_loader, _ = make_loaders(dataset)(
        data_path=dataset.get("path"), data_name=dataset.get("name"),
        batch_size=dataset.get("batch_size", 128),
        num_classes=model.get("num_labels", 32),
        n_samples=dataset.get("n_samples", 512),
        side=dataset.get("side", 100))
    wandb_run = maybe_wandb(cfg, params) if main_rank else None
    imdbn = iMDBN(
        layer_sizes_img=model.get("image_layers", [10000, 1500, 1500]),
        joint_layer_size=model.get("joint_hidden", 1000), params=params,
        dataloader=train_loader, val_loader=val_loader, device=device,
        num_labels=model.get("num_labels", 32), seed=params.get("SEED"),
        wandb_run=wandb_run, logging_cfg=cfg.get("logging", {}) or {})
    if params.get("DP_DEVICES") and main_rank:
        print(f"[train_multimodal] data-parallel training over "
              f"{params['DP_DEVICES']} device(s)")
    synchronize(device)
    t1 = time.perf_counter()

    # Crash-safe resume (scripts/train_multimodal.py:184-227). The
    # training-relevant config is fingerprinted into every checkpoint, so
    # a resume after a hyperparameter edit refuses.
    t_cfg = cfg.get("training", {}) or {}
    paths = cfg.get("paths", {}) or {}
    ckpt_every = int(params.get("CHECKPOINT_EVERY", 0) or 0)
    image_ckpt = joint_ckpt = None
    image_start = joint_start = 0
    image_done = False
    fp = config_fingerprint(
        params,
        image_layers=model.get("image_layers", [10000, 1500, 1500]),
        joint_hidden=model.get("joint_hidden", 1000),
        num_labels=model.get("num_labels", 32),
        matmul_precision=matmul_precision(cfg))
    imdbn._ckpt_fingerprint = fp
    imdbn.image_idbn._ckpt_fingerprint = fp
    ignore_cfg = bool(t_cfg.get("resume_ignore_config", False))
    if ckpt_every > 0:
        ckpts = cli_checkpoint_paths(cfg, ("image", "joint"))
        image_ckpt, joint_ckpt = ckpts["image"], ckpts["joint"]
        if joint_ckpt.exists():
            joint_start = load_train_checkpoint_expecting(
                imdbn, joint_ckpt, "joint", ignore_config=ignore_cfg)
            image_done = True
            print(f"[train_multimodal] resuming joint training at epoch "
                  f"{joint_start}/{params['EPOCHS_JOINT']}")
        elif image_ckpt.exists():
            image_start = load_train_checkpoint_expecting(
                imdbn.image_idbn, image_ckpt, "image",
                ignore_config=ignore_cfg)
            image_done = image_start >= int(params["EPOCHS_IMG"])
            print(f"[train_multimodal] resuming image training at epoch "
                  f"{image_start}/{params['EPOCHS_IMG']}")

    # 1) image iDBN: load if available, otherwise train
    image_pre = paths.get("image_idbn_pretrained")
    if not (image_done
            or (image_pre and imdbn.load_pretrained_image_idbn(image_pre))):
        print("Training image iDBN..." if not image_pre else
              "[main] fallback: training image iDBN from scratch...")
        train_dbn(imdbn.image_idbn, params["EPOCHS_IMG"],
                  int(params.get("INIT_RETRY", 0) or 0), image_start,
                  dict({"checkpoint_every": ckpt_every,
                        "checkpoint_path": str(image_ckpt)}
                       if ckpt_every else {},
                       log_every_pca=log_params["LOG_EVERY_PCA"],
                       log_every_probe=log_params["LOG_EVERY_PROBE"]),
                  "train_multimodal")
    # optional last-layer fine-tune; skipped when the image phase had
    # completed, since the restored states are past it
    ft_epochs = int(paths.get("image_idbn_finetune_last_epochs", 0) or 0)
    if ft_epochs > 0 and not image_done:
        imdbn.finetune_image_last_layer(epochs=ft_epochs, lr_scale=0.3)
    if ckpt_every and not image_done:
        # phase-complete marker, after the fine-tune hook: a crash during
        # joint training must not retrain or re-fine-tune the image stack
        imdbn.image_idbn._save_train_checkpoint(
            str(image_ckpt), int(params["EPOCHS_IMG"]))
    synchronize(device)
    t2 = time.perf_counter()

    # 2) joint training
    print("Training joint RBM...")
    imdbn.train_joint(params["EPOCHS_JOINT"],
                      log_every=log_params["LOG_EVERY"],
                      log_every_pca=log_params["LOG_EVERY_PCA"],
                      log_every_probe=log_params["LOG_EVERY_PROBE"],
                      **({"checkpoint_every": ckpt_every,
                          "checkpoint_path": str(joint_ckpt),
                          "start_epoch": joint_start} if ckpt_every else {}))
    synchronize(device)
    t3 = time.perf_counter()

    save_dir = Path(paths.get("save_dir", "./networks")).expanduser()
    save_dir.mkdir(parents=True, exist_ok=True)
    save_path = save_dir / f"{paths.get('save_name', 'imdbn_trained')}.pkl"
    if main_rank:
        imdbn.save_model(str(save_path))
        print(f"Saved multimodal model to {save_path}")
        if ckpt_every:  # the run completed and the model is saved
            remove_checkpoints((image_ckpt, joint_ckpt))
    if wandb_run:
        wandb_run.finish()

    summary = {
        "device": str(device),
        "seconds": {"setup": t1 - t0, "image": t2 - t1, "joint": t3 - t2},
        "image_loss": list(imdbn.image_idbn.loss_history),
        "cross_metrics": imdbn.last_metrics,
        "save_path": str(save_path),
        "model": imdbn,
    }
    if main_rank:
        print(f"[train_multimodal] phases (s): setup {t1 - t0:.3f}, "
              f"image {t2 - t1:.3f}, joint {t3 - t2:.3f}; "
              f"last cross metrics {imdbn.last_metrics}")
    return summary


if __name__ == "__main__":
    main()
