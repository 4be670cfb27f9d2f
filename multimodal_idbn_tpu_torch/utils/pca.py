"""Minimal PCA (SVD-based) for embedding visualization.

Copy of multimodal_idbn_tpu/utils/pca.py:1-41 (the port keeps its own
copy): NumPy on the host, equal to the JAX package's function on the same
input. Only ``fit_transform`` on small validation embeddings is needed.
"""

from __future__ import annotations

import numpy as np


def pca_fit_transform(X: np.ndarray, n_components: int) -> np.ndarray:
    """Project X [N, D] onto its top ``n_components`` principal axes.

    Matches sklearn's convention (centered data, components from SVD,
    sign-fixed so the largest absolute loading per component is positive).
    """
    X = np.asarray(X, np.float64)
    Xc = X - X.mean(axis=0, keepdims=True)
    U, S, Vt = np.linalg.svd(Xc, full_matrices=False)
    k = min(n_components, Vt.shape[0])
    # sklearn-style deterministic sign flip
    max_idx = np.argmax(np.abs(U[:, :k]), axis=0)
    signs = np.sign(U[max_idx, range(k)])
    signs[signs == 0] = 1.0
    out = (U[:, :k] * S[:k]) * signs
    if k < n_components:
        out = np.pad(out, ((0, 0), (0, n_components - k)))
    return out.astype(np.float32)


class PCA:
    """sklearn-like shim: ``PCA(n).fit_transform(X)``."""

    def __init__(self, n_components: int):
        self.n_components = int(n_components)

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return pca_fit_transform(X, self.n_components)
