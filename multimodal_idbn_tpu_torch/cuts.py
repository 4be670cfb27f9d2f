"""The cut configurations that ``chip_smoke.py`` and ``profile_main_path``
drive on the card: a shipped YAML with every width and step count kept
and only its scale cut (samples and epochs).

- ``flagship-cut``: configs/multimodal_training_config.yaml, image
  [10000, 1500, 500] CD-10, joint 532×500 CD-5; 384 samples, 1 image
  epoch, 9 joint epochs (8 warm-up + 1 main).
- ``bimodal-cut``: configs/bimodal_training_config.yaml, MOD1
  [10000, 1500, 1500], MOD2 [1568, 500, 500, 1000], joint [1500, 500]
  (layer 0 is 2500×1500) with CD-10, joint CD-5, 50 cross steps, 30 aux
  steps; 384 samples, 1 epoch per modality, 9 joint epochs.
- ``mdbn-cut``: configs/mdbn_flickr_training_config.yaml, the multimodal
  DBN's Gaussian [3857, 1024, 1024] and replicated-softmax [2000, 1024,
  1024] pathways CD-10, joint [2048]; 2 048 samples (1 434 training rows,
  as the benchmark's cells), 1 epoch per pathway and 1 joint epoch.

With 384 samples the training split is 268 rows: 2 full batches of 128
and a remainder of 12, so both batch shapes run.

``RESUME`` are the overrides of the resume drive: checkpoints every 2
epochs, 3 image epochs and 11 joint epochs (8 warm-up + 3 main), so there
is a checkpoint inside the image phase, inside the warm-up, at its
boundary and after the first two main epochs.

``DIAGNOSTICS`` are the overrides of the diagnostics drive: W&B on, every
``logging`` section of the YAML enabled and every cadence 8, so each
diagnostic fires at joint epochs 0 and 8 and at image epoch 0 of the
same cut (the training itself is unchanged). ``TINY`` shrinks a cut's
hidden widths, nothing else, for a CPU run of the same diagnostics: every
layer count, image size, step count, sample count and label count is
kept, so the same keys are logged.

``VARIANTS`` are the runs of the variants drive: a cut under the YAML
overrides of one opt-in setting (bf16 storage with stochastic rounding
left to auto or off, mixed precision, ``matmul_precision: high``, zipfian
data, which the default ``auto`` backend draws with the native generator)
or under a params override the YAML cannot express: ``PCD``, which the
JAX package also reaches only through the params dict. ``PCD_RESUME``
cuts the PCD run to 2 image epochs with a checkpoint after each and 1
joint epoch, so a resume continues the fantasy chains.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import yaml

CONFIGS = Path(__file__).resolve().parent.parent / "configs"

CUTS: Dict[str, dict] = {
    "flagship-cut": {
        "yaml": "multimodal_training_config.yaml",
        "entry": "train_multimodal",
        "cut": {"dataset": {"n_samples": 384},
                "training": {"epochs_image": 1, "epochs_joint": 9}},
    },
    "bimodal-cut": {
        "yaml": "bimodal_training_config.yaml",
        "entry": "train_bimodal",
        "cut": {"dataset": {"n_samples": 384},
                "training": {"epochs_mod1": 1, "epochs_mod2": 1,
                             "epochs_joint": 9}},
    },
    # the multimodal DBN's widths, 1 434 training rows (the split of
    # 2 048), one epoch of each pathway and of the joint
    "mdbn-cut": {
        "yaml": "mdbn_flickr_training_config.yaml",
        "entry": "train_bimodal",
        "cut": {"dataset": {"n_samples": 2048},
                "training": {"epochs_mod1": 1, "epochs_mod2": 1,
                             "epochs_joint": 1}},
    },
}


RESUME: Dict[str, dict] = {
    "flagship-cut": {"training": {"checkpoint_every": 2, "epochs_image": 3,
                                  "epochs_joint": 11}},
    "bimodal-cut": {"training": {"checkpoint_every": 2,
                                 "epochs_joint": 11}},
}


_EVERY = {k: 8 for k in (
    "log_every", "log_every_pca", "log_every_probe", "log_every_energy",
    "log_every_trajectory", "log_every_neighbors", "log_every_convergence")}
DIAGNOSTICS: Dict[str, dict] = {
    "flagship-cut": {
        "wandb": {"enable": True},
        "logging": dict(_EVERY, **{s: {"enable": True} for s in (
            "snapshots", "pca", "probes", "energy", "trajectory",
            "neighbors")}, convergence={"enable": True, "num_steps": 50}),
    },
    "bimodal-cut": {
        "wandb": {"enable": True},
        "logging": dict(_EVERY, **{s: {"enable": True} for s in (
            "snapshots", "pca", "probes", "trajectory")}),
    },
}
TINY: Dict[str, dict] = {
    "flagship-cut": {"model": {"image_layers": [10000, 64, 32],
                               "joint_hidden": 24}},
    "bimodal-cut": {"model": {"mod1_layers": [10000, 64, 32],
                              "mod2_layers": [1568, 32, 32, 48],
                              "joint_hidden": [40, 20]}},
}


VARIANTS: Dict[str, dict] = {
    "pcd": {"cut": "flagship-cut", "params": {"PCD": True}},
    "bf16-sr-auto": {"cut": "flagship-cut",
                     "overrides": {"training": {"dtype": "bfloat16"}}},
    "bf16-sr-off": {"cut": "flagship-cut", "overrides": {"training": {
        "dtype": "bfloat16", "stochastic_rounding": False}}},
    "mixed-bf16": {"cut": "flagship-cut", "overrides": {"training": {
        "compute_dtype": "bfloat16"}}},
    "matmul-high": {"cut": "flagship-cut", "overrides": {"training": {
        "matmul_precision": "high"}}},
    "zipfian-native": {"cut": "flagship-cut", "overrides": {"dataset": {
        "distribution": "zipfian"}}},
    "bimodal-bf16": {"cut": "bimodal-cut",
                     "overrides": {"training": {"dtype": "bfloat16"}}},
}
PCD_RESUME = {"training": {"epochs_image": 2, "checkpoint_every": 1,
                           "epochs_joint": 1}}


def write_cut(name: str, workdir: Path,
              overrides: Optional[dict] = None) -> Path:
    """Write the cut YAML of ``name`` (saving its model under
    ``workdir``), with ``overrides`` ({section: {key: value}}; a dict
    value is laid over the YAML's dict, so ``{"enable": True}`` keeps a
    section's other settings) laid over the cut, and return its path."""
    spec = CUTS[name]
    cfg = yaml.safe_load((CONFIGS / spec["yaml"]).read_text())
    for layer in (spec["cut"], overrides or {}):
        for section, values in layer.items():
            for key, value in values.items():
                old = cfg[section].get(key)
                cfg[section][key] = (dict(old, **value) if isinstance(
                    value, dict) and isinstance(old, dict) else value)
    cfg["paths"]["save_dir"] = str(workdir)
    path = Path(workdir) / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_cut(name: str, workdir: Path, device: str = "cuda",
            overrides: Optional[dict] = None,
            params: Optional[dict] = None) -> dict:
    """Train the cut ``name`` through its entry point; returns the entry
    point's summary. ``params`` are laid over the params the entry point
    builds from the YAML (its ``main(params=)``)."""
    from multimodal_idbn_tpu_torch import train_bimodal, train_multimodal
    entry = {"train_multimodal": train_multimodal,
             "train_bimodal": train_bimodal}[CUTS[name]["entry"]]
    return entry.main(["--config",
                       str(write_cut(name, workdir, overrides)),
                       "--device", device], params=params)


def run_variant(variant: str, workdir: Path, device: str = "cuda",
                extra: Optional[dict] = None) -> dict:
    """Train the run ``variant`` of ``VARIANTS`` (with ``extra`` YAML
    overrides laid over its own) through its cut's entry point."""
    spec = VARIANTS[variant]
    over = {k: dict(v) for k, v in spec.get("overrides", {}).items()}
    for section, values in (extra or {}).items():
        over.setdefault(section, {}).update(values)
    return run_cut(spec["cut"], workdir, device, over, spec.get("params"))


def run_logged(name: str, workdir: Path, device: str = "cuda",
               tiny: bool = False) -> dict:
    """``run_cut`` under the ``DIAGNOSTICS`` overrides (and ``TINY`` with
    ``tiny``), through the entry point as a user runs it: W&B's ``init``
    is replaced, for the run only, by one that returns a
    ``RecorderRun``, which the summary holds as ``"run"``."""
    from multimodal_idbn_tpu_torch.utils.wandb_compat import (RecorderRun,
                                                              wandb)
    runs = []

    def init(**kw):
        runs.append(RecorderRun(**kw))
        return runs[-1]

    wandb.init = init
    try:
        summary = run_cut(name, workdir, device, dict(
            DIAGNOSTICS[name], **(TINY[name] if tiny else {})))
    finally:
        del wandb.init
    summary["run"] = runs[0]
    return summary
