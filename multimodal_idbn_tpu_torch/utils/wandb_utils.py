"""W&B plotting utilities.

Port of multimodal_idbn_tpu/utils/wandb_utils.py:21-268: the same public
functions, metric keys and figure layouts (2D/3D embedding scatters with
per-PC Spearman correlations, ``log(values)`` coloring for the "Labels"
feature; image grids from a NumPy tiler). Inputs may be tensors on any
device; they are copied to the host once, as the numpy the figures and
scipy need.

Numbers first, figures after: each function computes and logs its
numbers before it imports matplotlib, and where matplotlib is missing it
logs ``warn/<diagnostic>_figure_skipped`` in place of the figure
(``wandb_compat.pyplot``). The embedding functions also log the
correlations they compute, under ``..._2d_correlations`` /
``..._3d_correlations``: the JAX package shows them only in the figure's
titles, so without matplotlib they would be lost.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from multimodal_idbn_tpu_torch.device import to_numpy
from multimodal_idbn_tpu_torch.utils.wandb_compat import pyplot, wandb


def _spearmanr(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (scipy, average-rank ties)."""
    from scipy.stats import spearmanr
    rho, _ = spearmanr(a, b)
    return float(rho)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              normalize: bool = False) -> np.ndarray:
    """Tile [N, H, W] (or [N, C, H, W]) images into one [H', W', C] grid —
    NumPy replacement for torchvision.utils.make_grid."""
    imgs = np.asarray(to_numpy(images), np.float32)
    if imgs.ndim == 3:
        imgs = imgs[:, None]
    n, c, h, w = imgs.shape
    if normalize:
        lo, hi = imgs.min(), imgs.max()
        imgs = (imgs - lo) / max(1e-8, float(hi - lo))
    ncol = min(nrow, n)
    nrows = int(math.ceil(n / ncol))
    grid = np.zeros((c, nrows * (h + pad) + pad, ncol * (w + pad) + pad),
                    np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[:, pad + r * (h + pad): pad + r * (h + pad) + h,
             pad + col * (w + pad): pad + col * (w + pad) + w] = imgs[i]
    return np.transpose(grid, (1, 2, 0))


def _to_square(x) -> np.ndarray:
    """[N, D] flat images -> [N, s, s] (or [N, D, 1] when non-square)."""
    x = to_numpy(x)
    if x.ndim >= 3:
        return x.reshape(x.shape[0], *x.shape[-2:])
    n, d = x.shape
    s = int(round(d ** 0.5))
    if s * s == d:
        return x.reshape(n, s, s)
    return x.reshape(n, d, 1)


def log_reconstructions_to_wandb(original, reconstruction, step: int = 0,
                                 num_images: int = 8,
                                 name: str = "reconstruction_grid"):
    """GT/recon pair grid to the global W&B run (JAX wandb_utils.py:62-73)."""
    if wandb.run is None:
        return
    orig = _to_square(to_numpy(original)[:num_images])
    recon = _to_square(to_numpy(reconstruction)[:num_images])
    combined = np.stack([v for pair in zip(orig, recon) for v in pair])
    grid = make_grid(combined, nrow=2, normalize=True)
    wandb.log({name: [wandb.Image(grid, caption=name)]})


def log_reconstruction_grid(wandb_run, original, reconstruction, epoch: int,
                            key: str = "auto_recon_grid"):
    """Original-above-reconstruction grid (JAX wandb_utils.py:76-84)."""
    if wandb_run is None:
        return
    orig = _to_square(original)
    rec = np.clip(_to_square(reconstruction), 0, 1)
    grid = make_grid(np.concatenate([orig, rec], axis=0), nrow=len(orig))
    wandb_run.log({key: wandb.Image(grid), "epoch": epoch})


def log_barplot(results: Dict[str, float], metric_name: str, arch_name: str,
                dist_name: str, ylabel: str = "Value"):
    """Bar plot over numerosity bins to the global W&B run
    (JAX wandb_utils.py:87-105)."""
    if wandb.run is None:
        return
    plt = pyplot(wandb.run, f"{arch_name}_{dist_name}_{metric_name}_bins")
    if plt is None:
        return
    bins = list(results.keys())
    values = list(results.values())
    plt.figure(figsize=(6, 4))
    plt.bar(bins, values, color="steelblue", alpha=0.8)
    plt.ylabel(ylabel)
    plt.xlabel("Numerosity bins")
    plt.title(f"{metric_name} ({arch_name}, {dist_name})")
    plt.tight_layout()
    wandb.log({f"{arch_name}_{dist_name}_{metric_name}_bins_plot":
               wandb.Image(plt.gcf())})
    plt.close()


def _correlations(emb: np.ndarray, features: dict, dims: int) -> dict:
    """{feature_dim{d}: Spearman rho of PC d with the feature}; NaN where
    the feature's length does not match or is below 2."""
    out = {}
    for feat_name, values in features.items():
        values = np.asarray(values)
        ok = len(values) == emb.shape[0] and len(values) >= 2
        for d in range(dims):
            out[f"{feat_name}_dim{d + 1}"] = (
                _spearmanr(emb[:, d], values) if ok else np.nan)
    return out


def plot_2d_embedding_and_correlations(emb_2d, features, arch_name,
                                       dist_name, method_name, wandb_run):
    """2D embedding scatter per feature + Spearman per PC
    (JAX wandb_utils.py:108-161). Returns the correlation dict, which is
    also logged."""
    emb_2d = to_numpy(emb_2d)
    if emb_2d.shape[0] == 0 or emb_2d.shape[1] != 2:
        return {}
    prefix = f"embeddings/{dist_name}/{arch_name}/{method_name}_2d"
    n_features = len(features)
    n_cols = 3
    n_rows = int(np.ceil(n_features / n_cols))
    correlations = _correlations(emb_2d, features, 2)
    if wandb_run is not None:
        wandb_run.log({f"{prefix}_correlations": dict(correlations)})
    plt = pyplot(wandb_run, f"{arch_name}_{method_name}_2d_embedding")
    if plt is None:
        return correlations

    fig, axs = plt.subplots(n_rows, n_cols, figsize=(5 * n_cols, 4 * n_rows))
    axs = np.atleast_1d(axs).flatten()
    i = 0
    for feat_name, values in features.items():
        values = np.asarray(values)
        if len(values) != emb_2d.shape[0] or len(values) < 2:
            i += 1
            continue
        # labels are numerosities >= 1, so log-coloring is in-domain
        color_values = np.log(values) if feat_name == "Labels" else values
        sc = axs[i].scatter(emb_2d[:, 0], emb_2d[:, 1], c=color_values,
                            cmap="viridis", s=40, alpha=0.8)
        axs[i].set_title(
            f"Feature: {feat_name}\n"
            f"Dim1={correlations[f'{feat_name}_dim1']:.2f}, "
            f"Dim2={correlations[f'{feat_name}_dim2']:.2f}")
        axs[i].set_xlabel(f"{method_name}-1")
        axs[i].set_ylabel(f"{method_name}-2")
        fig.colorbar(sc, ax=axs[i], label=feat_name)
        i += 1
    for j in range(i, len(axs)):
        axs[j].axis("off")

    plt.suptitle(f"{method_name} 2D Embedding for {arch_name} ({dist_name})",
                 fontsize=16)
    plt.tight_layout(rect=[0, 0.03, 1, 0.95])
    if wandb_run is not None:
        wandb_run.log({f"{prefix}_embedding": wandb.Image(plt.gcf())})
    plt.close(fig)
    return correlations


def plot_3d_embedding_and_correlations(emb_3d, features, arch_name,
                                       dist_name, method_name, wandb_run):
    """3D variant (JAX wandb_utils.py:164-215)."""
    emb_3d = to_numpy(emb_3d)
    if emb_3d.shape[0] == 0 or emb_3d.shape[1] != 3:
        return {}
    prefix = f"embeddings/{dist_name}/{arch_name}/{method_name}_3d"
    correlations = _correlations(emb_3d, features, 3)
    if wandb_run is not None:
        wandb_run.log({f"{prefix}_correlations": dict(correlations)})
    plt = pyplot(wandb_run, f"{arch_name}_{method_name}_3d_embedding")
    if plt is None:
        return correlations

    n_features = len(features)
    n_cols = 3
    n_rows = int(math.ceil(n_features / n_cols)) if n_features > 0 else 1
    fig = plt.figure(figsize=(5 * n_cols, 4 * n_rows))
    for idx, (feat_name, values) in enumerate(features.items()):
        ax = fig.add_subplot(n_rows, n_cols, idx + 1, projection="3d")
        values = np.asarray(values)
        if len(values) != emb_3d.shape[0] or len(values) < 2:
            ax.axis("off")
            continue
        rhos = [correlations[f"{feat_name}_dim{d}"] for d in (1, 2, 3)]
        color_values = np.log(values) if feat_name == "Labels" else values
        sc = ax.scatter(emb_3d[:, 0], emb_3d[:, 1], emb_3d[:, 2],
                        c=color_values, cmap="viridis", s=30, alpha=0.8)
        ax.set_title(f"{feat_name}\nDim1={rhos[0]:.2f}, Dim2={rhos[1]:.2f}, "
                     f"Dim3={rhos[2]:.2f}")
        ax.set_xlabel(f"{method_name}-1")
        ax.set_ylabel(f"{method_name}-2")
        ax.set_zlabel(f"{method_name}-3")
        fig.colorbar(sc, ax=ax, shrink=0.6, aspect=12, pad=0.1,
                     label=feat_name)
    for idx in range(n_features, n_rows * n_cols):
        ax = fig.add_subplot(n_rows, n_cols, idx + 1, projection="3d")
        ax.axis("off")

    plt.suptitle(f"{method_name} 3D Embedding for {arch_name} ({dist_name})",
                 fontsize=16)
    plt.tight_layout(rect=[0, 0.03, 1, 0.95])
    if wandb_run is not None:
        wandb_run.log({f"{prefix}_embedding": wandb.Image(fig)})
    plt.close(fig)
    return correlations


def log_pca_embeddings(wandb_run, emb, feat_map: dict, arch_name: str,
                       dist_name: str = "val") -> None:
    """PCA(2) and, with at least 3 dimensions, PCA(3) of [N, D] embeddings
    with their correlations to the features, as the models log them
    (JAX models/idbn.py:612-625, models/imdbn.py:790-809)."""
    from multimodal_idbn_tpu_torch.utils.pca import pca_fit_transform
    emb = to_numpy(emb)
    if emb.shape[0] <= 2 or emb.shape[1] <= 2:
        return
    plot_2d_embedding_and_correlations(
        emb_2d=pca_fit_transform(emb, 2), features=feat_map,
        arch_name=arch_name, dist_name=dist_name, method_name="pca",
        wandb_run=wandb_run)
    if emb.shape[1] >= 3:
        plot_3d_embedding_and_correlations(
            emb_3d=pca_fit_transform(emb, 3), features=feat_map,
            arch_name=arch_name, dist_name=dist_name, method_name="pca",
            wandb_run=wandb_run)


def log_snapshot_panels(wandb_run, epoch: int, imgs, recs, p_y, y_onehot,
                        class_names: Optional[list] = None):
    """Snapshot suite (JAX wandb_utils.py:218-268): GT|REC pair grid
    (``snap/image_from_text``), confusion matrix (``snap/text_confusion``),
    image MSE (``snap/image_mse``) and the top-k table (``snap/text_topk``).
    No figure: the grid is tiled in NumPy."""
    if wandb_run is None:
        return
    imgs4 = _to_square(imgs)
    recs4 = _to_square(recs)
    p_y = to_numpy(p_y)
    y_onehot = to_numpy(y_onehot)
    B = imgs4.shape[0]

    mse = float(np.mean((imgs4.reshape(B, -1) - recs4.reshape(B, -1)) ** 2))
    wandb_run.log({"snap/image_mse": mse, "epoch": epoch})

    pair = np.stack([imgs4, recs4], axis=1).reshape(-1, *imgs4.shape[1:])
    grid = make_grid(pair, nrow=2)
    wandb_run.log({"snap/image_from_text": wandb.Image(grid),
                   "epoch": epoch})

    pred = p_y.argmax(axis=1)
    gt = y_onehot.argmax(axis=1)
    K = p_y.shape[1]
    names = (class_names if class_names and len(class_names) == K
             else [str(i) for i in range(K)])
    try:
        cm_plot = wandb.plot.confusion_matrix(
            y_true=[names[i] for i in gt], preds=[names[i] for i in pred],
            class_names=names)
        wandb_run.log({"snap/text_confusion": cm_plot, "epoch": epoch})
    except Exception:  # a real W&B may refuse the plot; the rest goes on
        pass

    try:
        probs = np.clip(p_y, 1e-9, 1)
        cols = ["idx", "gt_idx", "pred_idx", "p_pred", "p_y_true"]
        has_names = class_names and len(class_names) == K
        if has_names:
            cols += ["gt_label", "pred_label"]
        tbl = wandb.Table(columns=cols)
        for i in range(B):
            gt_i, pred_i = int(gt[i]), int(pred[i])
            row = [i, gt_i, pred_i, float(probs[i, pred_i]),
                   float(probs[i, gt_i])]
            if has_names:
                row += [class_names[gt_i], class_names[pred_i]]
            tbl.add_data(*row)
        wandb_run.log({"snap/text_topk": tbl, "epoch": epoch})
    except Exception as e:
        wandb_run.log({"warn/snap_topk_table_error": str(e), "epoch": epoch})
