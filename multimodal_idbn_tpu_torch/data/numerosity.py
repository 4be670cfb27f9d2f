"""Synthetic numerosity dot-pattern stimuli with geometry features, and
the synthetic MNIST-100 second modality.

Copy of multimodal_idbn_tpu/data/numerosity.py:20-184 with its backends
(:95-139): ``backend="auto"`` (the native C++ generator of ``data.native``
when it builds, else the Python one), ``"native"`` (raises when it does
not build) or ``"python"``; for the same seed each gives the same arrays
as the JAX package's same backend. The two backends draw different
(statistically matching) images. Also ``zipf_probs`` (:179-184) and the
MNIST-100 renderer (:186-236). Deterministic per seed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _convex_hull_area(points: np.ndarray) -> float:
    """Area of the convex hull of 2-D points (monotone chain + shoelace)."""
    pts = np.unique(points, axis=0)
    if len(pts) < 3:
        return 0.0
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    upper = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    hull = np.array(lower[:-1] + upper[:-1], dtype=np.float64)
    x, y = hull[:, 0], hull[:, 1]
    return float(0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))))


def generate_dot_image(rng: np.random.RandomState, n_dots: int,
                       side: int = 100, r_min: int = 2, r_max: int = 6,
                       max_tries: int = 200):
    """One binary dot image + geometry features.

    Dots are non-overlapping discs of random radius placed uniformly.
    Returns (image [side, side] float32 in {0,1}, features dict).
    """
    img = np.zeros((side, side), np.float32)
    centers, radii = [], []
    yy, xx = np.mgrid[0:side, 0:side]
    # keep radii placeable on small canvases (need r < side - r)
    r_max = max(1, min(r_max, side // 2 - 2))
    r_min = max(1, min(r_min, r_max))
    def try_place(r: int) -> bool:
        cx = rng.randint(r, side - r)
        cy = rng.randint(r, side - r)
        ok = all((cx - px) ** 2 + (cy - py) ** 2 >= (r + pr + 1) ** 2
                 for (px, py), pr in zip(centers, radii))
        if ok:
            centers.append((cx, cy))
            radii.append(r)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1.0
        return ok

    for _ in range(n_dots):
        placed = False
        for _try in range(max_tries):
            if try_place(rng.randint(r_min, r_max + 1)):
                placed = True
                break
        if not placed:
            # fallback at the smallest radius so the labeled numerosity
            # stays truthful even at dense configurations
            for _try in range(max_tries):
                if try_place(r_min):
                    break
    cum_area = float(img.sum())
    ch = _convex_hull_area(np.array(centers, np.float64)) if len(centers) >= 3 \
        else cum_area
    density = float(len(centers) / max(ch, 1.0))
    feats = {"cumArea": cum_area, "CH": max(ch, 1.0), "density": density,
             "N": len(centers)}
    return img, feats


def generate_numerosity_dataset(n_samples: int = 512, num_classes: int = 32,
                                side: int = 100, seed: int = 0,
                                class_probs: Optional[np.ndarray] = None,
                                numerosities: Optional[np.ndarray] = None,
                                backend: str = "auto"
                                ) -> Dict[str, np.ndarray]:
    """Generate a full synthetic numerosity dataset.

    Args:
        n_samples: number of images.
        num_classes: number of numerosity classes (reference flagship: 32).
        side: image side (reference flagship: 100 → 10000 visibles).
        class_probs: per-class sampling probabilities (None = uniform;
            zipfian datasets pass 1/rank weights).
        numerosities: the numerosity value of each class (default 1..K).
        backend: "auto" (native C++ generator when buildable, else
            Python), "native", or "python". Both backends are
            deterministic per seed; their RNG streams differ, so the
            backends produce different (statistically matching) images.

    Returns dict with keys: images [N, side, side], labels (numeric
    numerosity per sample), class_idx [N], onehot [N, K], cumArea, CH,
    density, N_dots — mirroring the metadata contract of SURVEY.md §2.3.
    """
    rng = np.random.RandomState(seed)
    if numerosities is None:
        numerosities = np.arange(1, num_classes + 1)
    numerosities = np.asarray(numerosities)
    if class_probs is None:
        class_probs = np.full(num_classes, 1.0 / num_classes)
    class_probs = np.asarray(class_probs, np.float64)
    class_probs = class_probs / class_probs.sum()

    cls = rng.choice(num_classes, size=n_samples, p=class_probs)

    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown backend {backend!r} "
                         f"(auto | native | python)")
    use_native = False
    if backend in ("auto", "native"):
        from multimodal_idbn_tpu_torch.data import native as _native
        use_native = _native.native_available()
        if backend == "native" and not use_native:
            raise RuntimeError("native dotgen backend unavailable")

    if use_native:
        per_sample = numerosities[cls].astype(np.int32)
        images, cum_area, ch, density, n_dots = (
            _native.generate_dot_dataset_native(seed, per_sample,
                                                side=side))
    else:
        images = np.zeros((n_samples, side, side), np.float32)
        cum_area = np.zeros(n_samples, np.float32)
        ch = np.zeros(n_samples, np.float32)
        density = np.zeros(n_samples, np.float32)
        n_dots = np.zeros(n_samples, np.int32)
        for i in range(n_samples):
            img, f = generate_dot_image(rng, int(numerosities[cls[i]]),
                                        side=side)
            images[i] = img
            cum_area[i] = f["cumArea"]
            ch[i] = f["CH"]
            density[i] = f["density"]
            n_dots[i] = f["N"]

    # Keep labels truthful: if any placement still failed (rare after the
    # r_min fallback), relabel from the actual dot count when numerosities
    # are the default consecutive 1..K range.
    labels_arr = numerosities[cls].astype(np.float32)
    default_range = np.array_equal(numerosities,
                                   np.arange(1, num_classes + 1))
    mismatch = np.asarray(n_dots) != labels_arr.astype(np.int32)
    if default_range and mismatch.any():
        actual = np.clip(np.asarray(n_dots), 1, num_classes)
        cls = np.where(mismatch, actual - 1, cls)
        labels_arr = numerosities[cls].astype(np.float32)

    onehot = np.eye(num_classes, dtype=np.float32)[cls]
    return {
        "images": images,
        "labels": labels_arr,
        "class_idx": cls.astype(np.int64),
        "onehot": onehot,
        "cumArea": cum_area,
        "CH": ch,
        "density": density,
        "N_dots": n_dots,
    }


def zipf_probs(num_classes: int, exponent: float = 1.0) -> np.ndarray:
    """Zipf-distributed class probabilities p_k ∝ 1/(k+1)^a."""
    ranks = np.arange(1, num_classes + 1, dtype=np.float64)
    p = 1.0 / ranks ** exponent
    return p / p.sum()


# ---------------------------------------------------------------------------
# MNIST-100 second modality (28×56 two-digit images, bimodal config)
# ---------------------------------------------------------------------------

# 5x3 bitmap font for digits 0-9 (enough structure for the 28×56 modality).
_DIGIT_FONT = {
    0: ["111", "101", "101", "101", "111"],
    1: ["010", "110", "010", "010", "111"],
    2: ["111", "001", "111", "100", "111"],
    3: ["111", "001", "111", "001", "111"],
    4: ["101", "101", "111", "001", "001"],
    5: ["111", "100", "111", "001", "111"],
    6: ["111", "100", "111", "101", "111"],
    7: ["111", "001", "010", "010", "010"],
    8: ["111", "101", "111", "101", "111"],
    9: ["111", "101", "111", "001", "111"],
}


def _digit_glyph(d: int, h: int = 28, w: int = 28,
                 jitter_rng=None) -> np.ndarray:
    """Upscale the 5×3 bitmap of digit ``d`` to h×w with optional jitter."""
    bitmap = np.array([[int(c) for c in row] for row in _DIGIT_FONT[d]],
                      np.float32)
    img = np.kron(bitmap, np.ones((4, 6), np.float32))  # 20×18
    canvas = np.zeros((h, w), np.float32)
    oy, ox = (h - img.shape[0]) // 2, (w - img.shape[1]) // 2
    if jitter_rng is not None:
        oy += jitter_rng.randint(-3, 4)
        ox += jitter_rng.randint(-3, 4)
    canvas[oy:oy + img.shape[0], ox:ox + img.shape[1]] = img
    return canvas


def generate_mnist100_images(values: np.ndarray, seed: int = 0,
                             noise: float = 0.02) -> np.ndarray:
    """Render each value (0..99) as a 28×56 two-digit binary image, the
    synthetic stand-in for the reference's mnist100.npz second modality."""
    rng = np.random.RandomState(seed)
    out = np.zeros((len(values), 28, 56), np.float32)
    for i, v in enumerate(np.asarray(values, np.int64)):
        v = int(v) % 100
        left = _digit_glyph(v // 10, jitter_rng=rng)
        right = _digit_glyph(v % 10, jitter_rng=rng)
        img = np.concatenate([left, right], axis=1)
        if noise > 0:
            img = np.where(rng.rand(*img.shape) < noise, 1.0 - img, img)
        out[i] = img
    return out
