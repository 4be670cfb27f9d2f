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

With 384 samples the training split is 268 rows: 2 full batches of 128
and a remainder of 12, so both batch shapes run.

``RESUME`` are the overrides of the resume drive: checkpoints every 2
epochs, 3 image epochs and 11 joint epochs (8 warm-up + 3 main), so there
is a checkpoint inside the image phase, inside the warm-up, at its
boundary and after the first two main epochs.
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
}


RESUME: Dict[str, dict] = {
    "flagship-cut": {"training": {"checkpoint_every": 2, "epochs_image": 3,
                                  "epochs_joint": 11}},
    "bimodal-cut": {"training": {"checkpoint_every": 2,
                                 "epochs_joint": 11}},
}


def write_cut(name: str, workdir: Path,
              overrides: Optional[dict] = None) -> Path:
    """Write the cut YAML of ``name`` (saving its model under
    ``workdir``), with ``overrides`` ({section: {key: value}}) laid over
    the cut, and return its path."""
    spec = CUTS[name]
    cfg = yaml.safe_load((CONFIGS / spec["yaml"]).read_text())
    for layer in (spec["cut"], overrides or {}):
        for section, values in layer.items():
            cfg[section].update(values)
    cfg["paths"]["save_dir"] = str(workdir)
    path = Path(workdir) / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_cut(name: str, workdir: Path, device: str = "cuda",
            overrides: Optional[dict] = None) -> dict:
    """Train the cut ``name`` through its entry point; returns the entry
    point's summary."""
    from multimodal_idbn_tpu_torch import train_bimodal, train_multimodal
    entry = {"train_multimodal": train_multimodal,
             "train_bimodal": train_bimodal}[CUTS[name]["entry"]]
    return entry.main(["--config",
                       str(write_cut(name, workdir, overrides)),
                       "--device", device])
