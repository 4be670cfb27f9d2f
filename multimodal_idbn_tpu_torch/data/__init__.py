"""Dataset layer of the port: npz-backed numerosity loaders with a
synthetic fallback.

Copy of multimodal_idbn_tpu/data/__init__.py:36-175:
``create_dataloaders_uniform`` and ``create_dataloaders_zipfian`` return
(train, val, test) loaders over ``{data_path}/{data_name}`` when that npz
exists, else over a deterministic synthetic numerosity dataset
(``numerosity.generate_numerosity_dataset``) with uniform or Zipf class
frequencies, drawn by the generator's default backend "auto", as in the
JAX package: the native C++ generator when it builds, else the Python
one. With ``second_modality="mnist100"`` the dataset is bimodal:
batches are (numerosity images, MNIST-100 images), the second modality
read from ``mnist100_path`` or rendered from the labels
(``numerosity.generate_mnist100_images``). ``create_dataloaders_features_tags``
gives the multimodal DBN's bimodal loaders instead: (image features, tag
counts) batches of the synthetic set of ``features_tags``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from multimodal_idbn_tpu_torch.data.loaders import (  # noqa: F401
    DataLoader,
    NumerosityDataset,
    Subset,
    train_val_test_split,
)
from multimodal_idbn_tpu_torch.data.features_tags import (  # noqa: F401
    generate_feature_tag_dataset,
)
from multimodal_idbn_tpu_torch.data.numerosity import (  # noqa: F401
    generate_mnist100_images,
    generate_numerosity_dataset,
    zipf_probs,
)

_IMAGE_KEYS = ("images", "data", "x", "X", "stimuli")
_LABEL_KEYS = ("labels", "y", "Y", "numerosity", "N")


def _load_npz(path: str) -> dict:
    """Liberal npz reader: images + numeric labels + optional geometry."""
    with np.load(path, allow_pickle=False) as f:
        keys = set(f.files)
        img_key = next((k for k in _IMAGE_KEYS if k in keys), None)
        lbl_key = next((k for k in _LABEL_KEYS if k in keys), None)
        if img_key is None or lbl_key is None:
            raise KeyError(
                f"npz {path} missing image/label arrays (found {sorted(keys)})")
        images = np.asarray(f[img_key], np.float32)
        labels = np.asarray(f[lbl_key]).astype(np.float32).reshape(-1)
        out = {"images": images, "labels": labels}
        for name, cands in (("cumArea", ("cumArea", "cum_area",
                                         "cumulative_area")),
                            ("CH", ("CH", "convex_hull", "hull")),
                            ("density", ("density",)),
                            ("N_dots", ("N_dots", "n_dots"))):
            k = next((c for c in cands if c in keys), None)
            if k is not None:
                out[name] = np.asarray(f[k], np.float32).reshape(-1)
    return out


def _from_npz_or_synthetic(data_path: Optional[str], data_name: Optional[str],
                           num_classes: int, n_samples: int, side: int,
                           seed: int, class_probs=None) -> dict:
    path = None
    if data_path:
        cand = os.path.join(data_path, data_name) if data_name else data_path
        if os.path.isfile(cand):
            path = cand
        elif data_name and os.path.isfile(cand + ".npz"):
            path = cand + ".npz"
    if path is None:
        return generate_numerosity_dataset(
            n_samples=n_samples, num_classes=num_classes, side=side,
            seed=seed, class_probs=class_probs)
    raw = _load_npz(path)
    labels = raw["labels"]
    values = np.unique(labels)
    cls = np.searchsorted(values, labels)
    onehot = np.eye(len(values), dtype=np.float32)[cls]
    images = raw["images"]
    if images.ndim == 2:  # flattened -> square
        s = int(round(images.shape[1] ** 0.5))
        images = images.reshape(-1, s, s)
    cum = raw.get("cumArea", images.reshape(len(images), -1).sum(1))
    ch = raw.get("CH", np.maximum(cum, 1.0))
    return {"images": images, "labels": labels, "onehot": onehot,
            "cumArea": cum, "CH": ch, "density": raw.get("density"),
            "N_dots": raw.get("N_dots"), "class_idx": cls}


def _build_loaders(data: dict, batch_size: int,
                   second_modality: Optional[str],
                   mnist100_path: Optional[str], val_size: float,
                   test_size: float, seed: int):
    """(train, val, test) loaders over ``data`` (data/__init__.py:95-128)."""
    mod2 = None
    mode = "multimodal"
    if second_modality:  # bimodal
        if second_modality != "mnist100":
            raise ValueError(f"unknown second_modality {second_modality!r}")
        if mnist100_path and os.path.isfile(mnist100_path):
            mod2 = _load_npz(mnist100_path)["images"]
        else:
            mod2 = generate_mnist100_images(data["labels"], seed=seed)
        mode = "bimodal"
    ds = NumerosityDataset(
        images=data["images"], labels=data["labels"], onehot=data["onehot"],
        cumArea=data["cumArea"], CH=data["CH"],
        density=data.get("density"), n_dots=data.get("N_dots"),
        mod2_images=mod2, mode=mode)
    tr, va, te = train_val_test_split(len(ds), val_size=val_size,
                                      test_size=test_size, seed=42)
    return (DataLoader(Subset(ds, tr), batch_size=batch_size, shuffle=True,
                       seed=seed),
            DataLoader(Subset(ds, va), batch_size=batch_size, shuffle=False),
            DataLoader(Subset(ds, te), batch_size=batch_size, shuffle=False))


def create_dataloaders_uniform(data_path: Optional[str] = None,
                               data_name: Optional[str] = None,
                               batch_size: int = 128, num_workers: int = 1,
                               multimodal_flag: bool = True,
                               second_modality: Optional[str] = None,
                               mnist100_path: Optional[str] = None,
                               val_size: float = 0.15,
                               test_size: float = 0.15,
                               num_classes: int = 32, n_samples: int = 512,
                               side: int = 100, seed: int = 0,
                               path2data: Optional[str] = None):
    """(train, val, test) loaders with uniform class frequencies
    (multimodal_idbn_tpu/data/__init__.py:131-154). ``num_workers`` and
    ``multimodal_flag`` are accepted for the reference's signature and
    unused, as there: batches are gathered with NumPy, and unimodal and
    multimodal loaders share the (images, onehot) batch contract.
    ``path2data`` is the reference's older name of ``data_path``."""
    del num_workers, multimodal_flag
    data = _from_npz_or_synthetic(data_path or path2data, data_name,
                                  num_classes, n_samples, side, seed)
    return _build_loaders(data, batch_size, second_modality, mnist100_path,
                          val_size, test_size, seed)


def create_dataloaders_zipfian(data_path: Optional[str] = None,
                               data_name: Optional[str] = None,
                               batch_size: int = 128, num_workers: int = 1,
                               multimodal_flag: bool = True,
                               second_modality: Optional[str] = None,
                               mnist100_path: Optional[str] = None,
                               val_size: float = 0.15,
                               test_size: float = 0.15,
                               num_classes: int = 32, n_samples: int = 512,
                               side: int = 100, seed: int = 0,
                               zipf_exponent: float = 1.0,
                               path2data: Optional[str] = None):
    """(train, val, test) loaders with Zipf-distributed class frequencies,
    p_k ∝ 1/k^zipf_exponent (multimodal_idbn_tpu/data/__init__.py:157-175,
    reference README.md:219); ``path2data`` as in
    ``create_dataloaders_uniform``."""
    del num_workers, multimodal_flag
    data = _from_npz_or_synthetic(
        data_path or path2data, data_name, num_classes, n_samples, side, seed,
        class_probs=zipf_probs(num_classes, zipf_exponent))
    return _build_loaders(data, batch_size, second_modality, mnist100_path,
                          val_size, test_size, seed)


def create_dataloaders_features_tags(n_features: int, vocab: int,
                                     batch_size: int = 128,
                                     num_classes: int = 32,
                                     n_samples: int = 512, seed: int = 0,
                                     max_words: int = 10,
                                     val_size: float = 0.15,
                                     test_size: float = 0.15):
    """(train, val, test) bimodal loaders of (image features, tag counts)
    batches over ``generate_feature_tag_dataset``, split as the numerosity
    loaders are."""
    data = generate_feature_tag_dataset(n_samples, n_features, vocab,
                                        num_classes, seed=seed,
                                        max_words=max_words)
    ds = NumerosityDataset(
        images=data["images"], labels=data["labels"], onehot=data["onehot"],
        cumArea=data["cumArea"], CH=data["CH"], mod2_images=data["tags"],
        mode="bimodal")
    tr, va, te = train_val_test_split(len(ds), val_size=val_size,
                                      test_size=test_size, seed=42)
    return (DataLoader(Subset(ds, tr), batch_size=batch_size, shuffle=True,
                       seed=seed),
            DataLoader(Subset(ds, va), batch_size=batch_size, shuffle=False),
            DataLoader(Subset(ds, te), batch_size=batch_size, shuffle=False))
