"""iMDBN trajectory / neighbour / auto-reconstruction logging.

Port of multimodal_idbn_tpu/utils/imdbn_logging.py:41-690: PCA-2/3 latent
trajectories of the TXT→IMG chain with reconstruction panels, the
validation "vector DB" banks with top-k neighbour search and dedup, and
the joint auto-reconstruction metrics.

The trajectory chain is a plain torch loop on the model's device that
keeps every step's latent (JAX's ``lax.scan``), its Bernoulli draws keyed
by the joint RBM's own stream through ``ops.sampling``; on the card it is
one graph replay (``ops.graphs``, the model's graphs), as JAX jits it
(:79). The 2-D panel's
end point is the full training-path reconstruction ``_cross_reconstruct``
(the chain kernel on the card). Encoding runs on the device; the banks and
the PCA projections are host NumPy, as in JAX, so neighbour indices equal
the JAX package's. Numbers first: the chains and banks are computed, and
the numbers logged, before matplotlib is imported for a panel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from multimodal_idbn_tpu_torch.device import as_tensor, to_numpy
from multimodal_idbn_tpu_torch.ops import graphs, rbm_ops, rng
from multimodal_idbn_tpu_torch.ops.sampling import (apply_softmax_groups,
                                                    clamp_mask,
                                                    sample_bernoulli)
from multimodal_idbn_tpu_torch.utils.wandb_compat import pyplot, wandb
from multimodal_idbn_tpu_torch.utils.wandb_utils import make_grid


# ---------------------------------------------------------------------------
# Shared chain / sample helpers (JAX imdbn_logging.py:41-135)
# ---------------------------------------------------------------------------

def _device(model) -> torch.device:
    return model.joint_rbm.state.w.device


def _fetch_val_sample(model, sample_idx: int):
    """(x_i [1, D], y_i [1, K]) as host numpy at position ``sample_idx``
    of the (unshuffled) val loader."""
    seen = 0
    for imgs, lbls in model.val_loader:
        b = len(imgs)
        if seen + b <= sample_idx:
            seen += b
            continue
        pos = sample_idx - seen
        x_i = np.asarray(imgs, np.float32)[pos:pos + 1]
        y_i = np.asarray(lbls, np.float32)[pos:pos + 1]
        return x_i.reshape(1, -1), y_i
    return None, None


def _init_txt2img_state(model, y_i):
    """Initial joint visible state for a y-clamped chain: z from
    ``z_class_mean`` when available, else one mean-field pass
    (JAX imdbn_logging.py:57-76)."""
    dev = _device(model)
    y_i = as_tensor(y_i, dev)
    Dz = model.Dz_img
    K = model.num_labels
    B = y_i.shape[0]
    v_known = torch.cat([torch.zeros((B, Dz), device=dev), y_i], dim=1)
    km = torch.cat([torch.zeros((B, Dz), device=dev),
                    torch.ones((B, K), device=dev)], dim=1)
    if getattr(model, "z_class_mean", None) is not None:
        z0 = as_tensor(model.z_class_mean, dev)[y_i.argmax(dim=1)]
        v_cur = torch.cat([z0, y_i], dim=1)
    else:
        groups = tuple(tuple(g) for g in model.joint_rbm.softmax_groups)
        h0 = rbm_ops.hidden_probs(model.joint_rbm.state, v_known)
        v_prob0 = rbm_ops.visible_probs(model.joint_rbm.state, h0,
                                        groups=groups)
        v_cur = clamp_mask(v_prob0, v_known, km)
    return v_cur, v_known, km


def _traj_chain(joint: rbm_ops.RBMState, key: int, v_cur, v_known, km, *,
                steps: int, groups, Dz: int) -> torch.Tensor:
    """TXT→IMG chain with sampled h (``h ~ Bernoulli(p(h|v))``, softmax
    groups on the logits, y re-clamped); returns the per-step z
    [steps, B, Dz] (JAX imdbn_logging.py:79-96)."""
    zs = []
    v = v_cur
    for t in range(int(steps)):
        h = sample_bernoulli(rng.fold_in(key, t),
                             rbm_ops.hidden_probs(joint, v))
        v_logits = h @ joint.w.T + joint.vb
        v = clamp_mask(apply_softmax_groups(torch.sigmoid(v_logits),
                                            v_logits, groups), v_known, km)
        zs.append(v[:, :Dz])
    if not zs:
        return torch.zeros((0, v.shape[0], Dz), device=v.device)
    return torch.stack(zs)


def _run_traj(model, y_i, steps: int) -> np.ndarray:
    """z trajectory [steps+1, Dz] including the init point, host numpy."""
    v_cur, v_known, km = _init_txt2img_state(model, y_i)
    groups = tuple(tuple(g) for g in model.joint_rbm.softmax_groups)
    zs = graphs.serve(model, v_cur.device, _traj_chain,
                      model.joint_rbm._next_key(),
                      rbm_ops.weights_only(model.joint_rbm.state),
                      v_cur=v_cur, v_known=v_known, km=km, steps=int(steps),
                      groups=groups, Dz=model.Dz_img)
    z0 = to_numpy(v_cur[:, :model.Dz_img])
    return np.concatenate([z0, to_numpy(zs)[:, 0, :]], axis=0)


def _vec_to_img_np(vec) -> np.ndarray:
    v = to_numpy(vec).reshape(-1)
    side = int(round(v.size ** 0.5))
    if side * side != v.size:
        return np.clip(v.reshape(v.size, 1), 0, 1)
    return np.clip(v.reshape(side, side), 0, 1)


def _val_embeddings(model):
    """(image-top val latents as host numpy, features)."""
    from multimodal_idbn_tpu_torch.utils.probe_utils import (
        compute_val_embeddings_and_features)
    E, feats = compute_val_embeddings_and_features(
        model.image_idbn, upto_layer=len(model.image_idbn.layers))
    return to_numpy(E), feats


def _color_vec(model, feats, n):
    try:
        base = model.val_loader.dataset.dataset
        indices = model.val_loader.dataset.indices
        if getattr(base, "N_list", None) is not None:
            return np.array([base.N_list[i] for i in indices], dtype=float)
    except AttributeError:  # a loader without the Subset protocol
        pass
    if "labels" in feats:
        return np.asarray(feats["labels"], dtype=float)
    return np.zeros(n, dtype=float)


def _pca_projection(Z: np.ndarray, k: int):
    """(mean [1, D], projection [D, k]) of a refit PCA; the cloud and the
    trajectory share one matrix, so neither can mirror the other."""
    mean = Z.mean(0, keepdims=True)
    _, _, Vt = np.linalg.svd(Z - mean, full_matrices=False)
    return mean, Vt[:k].T


def _recon_panel(fig, gs, rows, cols, panel_imgs, panel_titles):
    right_gs = gs[:, 4:].subgridspec(nrows=rows, ncols=cols)
    for k, img in enumerate(panel_imgs):
        r, c = divmod(k, cols)
        ax = fig.add_subplot(right_gs[r, c])
        ax.imshow(img, cmap="gray", vmin=0.0, vmax=1.0)
        ax.set_title(panel_titles[k], fontsize=9)
        ax.axis("off")


# ---------------------------------------------------------------------------
# PCA-2 trajectory + recon panel (JAX imdbn_logging.py:142-263)
# ---------------------------------------------------------------------------

def log_latent_trajectory_with_recon_panel(model, sample_idx: int = 0,
                                           steps: int = 40,
                                           tag: str = "pca_traj_with_recon",
                                           n_frames: Optional[int] = None,
                                           scatter_size: Optional[int] = None,
                                           scatter_alpha: Optional[float] = None):
    """PCA(2) cloud of val latents + the TXT→IMG trajectory of one sample,
    with a GT + staged-reconstruction panel. Like the reference, the
    trajectory interpolates start→end, the end being the full annealed
    ``_cross_reconstruct`` (JAX imdbn_logging.py:142-263)."""
    assert model.val_loader is not None, "val_loader missing"
    run = model.wandb_run
    Z_val, feats = _val_embeddings(model)
    if Z_val.size == 0:
        if run:
            run.log({f"{tag}/warn": "no val embeddings"})
        return
    N_val, Dz = Z_val.shape
    sample_idx = int(max(0, min(sample_idx, N_val - 1)))
    color_vec = _color_vec(model, feats, N_val)

    cfg = getattr(model, "logging_cfg", {}) or {}
    pca_cfg = ((cfg.get("logging") or {}).get("pca_trajectory") or {})
    n_frames = int(pca_cfg.get("n_frames", 8)) if n_frames is None else n_frames
    scatter_size = (int(pca_cfg.get("scatter_size", 12))
                    if scatter_size is None else scatter_size)
    scatter_alpha = (float(pca_cfg.get("scatter_alpha", 0.35))
                     if scatter_alpha is None else scatter_alpha)

    mean, proj = _pca_projection(Z_val, 2)
    Z2 = (Z_val - mean) @ proj
    z_true_2d = Z2[sample_idx:sample_idx + 1]

    x_i, y_i = _fetch_val_sample(model, sample_idx)
    if x_i is None:
        if run:
            run.log({f"{tag}/warn": "sample not found"})
        return
    gt_class = int(y_i.argmax(axis=1)[0])

    v_cur, _, _ = _init_txt2img_state(model, y_i)
    z_init = to_numpy(v_cur[:, :Dz])
    traj_points = [z_init[0]]
    recon_points = [_vec_to_img_np(model.image_idbn.decode(z_init))]

    # full training-path reconstruction (annealing + μ-pull + best-of-K)
    z_img_true = model.image_idbn.represent(x_i)
    img_from_txt, _ = model._cross_reconstruct(z_img_true, y_i, steps=steps)
    z_final = to_numpy(model.image_idbn.represent(img_from_txt))
    traj_points.append(z_final[0])
    recon_points.append(_vec_to_img_np(img_from_txt))

    num_frames = min(int(steps / 5), 8)
    for i in range(1, num_frames):
        alpha = i / num_frames
        z_interp = (1 - alpha) * z_init + alpha * z_final
        traj_points.append(z_interp[0])
        recon_points.append(_vec_to_img_np(model.image_idbn.decode(z_interp)))

    traj = np.stack([(z - mean[0]) @ proj for z in traj_points])

    n_frames = max(2, n_frames)
    sel_idx = np.unique(np.linspace(0, len(recon_points) - 1, n_frames,
                                    dtype=int)).tolist()
    panel_imgs = [_vec_to_img_np(x_i)] + [recon_points[si] for si in sel_idx]
    panel_titles = ["GT"] + [f"step {si}" for si in sel_idx]

    plt = pyplot(run, tag.replace("/", "_"))
    if plt is None:
        return
    rows = 2
    cols = math.ceil(len(panel_imgs) / rows)
    fig = plt.figure(figsize=(8 + cols * 2.2, max(6, rows * 2.2)))
    gs = fig.add_gridspec(nrows=rows, ncols=cols + 4)
    ax0 = fig.add_subplot(gs[:, :4])
    sc = ax0.scatter(Z2[:, 0], Z2[:, 1], c=color_vec, cmap="viridis",
                     s=scatter_size, alpha=scatter_alpha)
    ax0.scatter(z_true_2d[0, 0], z_true_2d[0, 1], s=80, marker="*", c="k",
                edgecolor="w", linewidths=0.8,
                label=f"sample GT (class={gt_class})", zorder=3)
    ax0.scatter(traj[0, 0], traj[0, 1], s=50, marker="D", c="red",
                edgecolor="k", linewidths=0.5, label="chain start", zorder=3)
    ax0.plot(traj[:, 0], traj[:, 1], linewidth=1.6, marker="o", markersize=3,
             c="red", label="trajectory", zorder=2)
    for t in range(0, len(traj), max(1, len(traj) // 10)):
        ax0.text(traj[t, 0], traj[t, 1], str(t), fontsize=7, color="red")
    ax0.set_title(f"PCA z_img - sample {sample_idx} (class={gt_class}) - "
                  f"steps={steps}")
    ax0.set_xlabel("PC1")
    ax0.set_ylabel("PC2")
    cbar = fig.colorbar(sc, ax=ax0, fraction=0.046, pad=0.02)
    cbar.set_label("Numerosity / N_list (fallback: Labels)")
    ax0.legend(loc="best")
    _recon_panel(fig, gs, rows, cols, panel_imgs, panel_titles)
    plt.tight_layout()
    if run:
        run.log({f"{tag}/plot": wandb.Image(fig)})
    plt.close(fig)


# ---------------------------------------------------------------------------
# PCA-3 trajectories (JAX imdbn_logging.py:270-410)
# ---------------------------------------------------------------------------

def log_pca3_trajectory(model, sample_idx: int, steps: int = 40,
                        tag: str = "pca3_traj"):
    """3D PCA cloud + raw sampled-h trajectory (JAX :270-303)."""
    run = model.wandb_run
    Z_val, _ = _val_embeddings(model)
    if Z_val.size == 0:
        if run:
            run.log({f"{tag}/warn": "no val embeddings"})
        return
    x_i, y_i = _fetch_val_sample(model, sample_idx)
    if x_i is None:
        return
    Z_traj = _run_traj(model, y_i, steps)
    mean, proj = _pca_projection(Z_val, 3)
    Z3 = (Z_val - mean) @ proj
    T3 = (Z_traj - mean) @ proj

    plt = pyplot(run, tag.replace("/", "_"))
    if plt is None:
        return
    fig = plt.figure(figsize=(6.5, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(Z3[:, 0], Z3[:, 1], Z3[:, 2], s=6, alpha=0.15)
    ax.plot(T3[:, 0], T3[:, 1], T3[:, 2], c="r", linewidth=1.2)
    ax.set_title("PCA-3 trajectory")
    fig.tight_layout()
    if run:
        run.log({f"{tag}/pca3": wandb.Image(fig)})
    plt.close(fig)


def log_pca3_trajectory_with_recon_panel(model, sample_idx: int = 0,
                                         steps: int = 40,
                                         tag: str = "pca3_traj_with_recon",
                                         n_frames: Optional[int] = None,
                                         scatter_size: Optional[int] = None,
                                         scatter_alpha: Optional[float] = None,
                                         elev: Optional[float] = None,
                                         azim: Optional[float] = None):
    """3D PCA scatter + trajectory + recon panel; the per-step
    reconstructions decode the trajectory latents (JAX :306-410)."""
    cfg = getattr(model, "logging_cfg", {}) or {}
    pca_cfg = ((cfg.get("logging") or {}).get("pca_trajectory") or {})
    p3_cfg = (pca_cfg.get("three_d") or {})
    n_frames = int(pca_cfg.get("n_frames", 8)) if n_frames is None else n_frames
    scatter_size = (int(p3_cfg.get("scatter_size", 6))
                    if scatter_size is None else scatter_size)
    scatter_alpha = (float(p3_cfg.get("scatter_alpha", 0.15))
                     if scatter_alpha is None else scatter_alpha)
    elev = float(p3_cfg.get("elev", 20)) if elev is None else elev
    azim = float(p3_cfg.get("azim", 35)) if azim is None else azim

    assert model.val_loader is not None, "val_loader missing"
    run = model.wandb_run
    Z_val, feats = _val_embeddings(model)
    if Z_val.size == 0:
        if run:
            run.log({f"{tag}/warn": "no val embeddings"})
        return
    N_val, Dz = Z_val.shape
    sample_idx = int(max(0, min(sample_idx, N_val - 1)))
    color_vec = _color_vec(model, feats, N_val)

    mean, proj = _pca_projection(Z_val, 3)
    Z3 = (Z_val - mean) @ proj
    z_true_3d = Z3[sample_idx:sample_idx + 1]

    x_i, y_i = _fetch_val_sample(model, sample_idx)
    if x_i is None:
        if run:
            run.log({f"{tag}/warn": "sample not found"})
        return
    gt_class = int(y_i.argmax(axis=1)[0])

    Z_traj = _run_traj(model, y_i, steps)                # [steps+1, Dz]
    traj3 = (Z_traj - mean) @ proj
    recs = to_numpy(model.image_idbn.decode(Z_traj))     # [steps+1, D]
    recon_imgs = [_vec_to_img_np(r) for r in recs]

    n_frames = max(2, n_frames)
    sel_idx = np.unique(np.linspace(0, len(recon_imgs) - 1, n_frames,
                                    dtype=int)).tolist()
    panel_imgs = [_vec_to_img_np(x_i)] + [recon_imgs[si] for si in sel_idx]
    panel_titles = ["GT"] + [f"step {si}" for si in sel_idx]

    plt = pyplot(run, tag.replace("/", "_"))
    if plt is None:
        return
    rows = 2
    cols = math.ceil(len(panel_imgs) / rows)
    fig = plt.figure(figsize=(8 + cols * 2.2, max(6, rows * 2.2)))
    gs = fig.add_gridspec(nrows=rows, ncols=cols + 4)
    ax0 = fig.add_subplot(gs[:, :4], projection="3d")
    sc = ax0.scatter(Z3[:, 0], Z3[:, 1], Z3[:, 2], c=color_vec,
                     cmap="viridis", s=scatter_size, alpha=scatter_alpha)
    ax0.scatter(z_true_3d[0, 0], z_true_3d[0, 1], z_true_3d[0, 2], s=80,
                marker="*", c="k", edgecolor="w", linewidths=0.8,
                label=f"sample GT (class={gt_class})", zorder=3)
    ax0.scatter(traj3[0, 0], traj3[0, 1], traj3[0, 2], s=50, marker="D",
                c="red", edgecolor="k", linewidths=0.5, label="chain start",
                zorder=3)
    ax0.plot(traj3[:, 0], traj3[:, 1], traj3[:, 2], linewidth=1.6,
             marker="o", markersize=3, c="red", label="trajectory", zorder=2)
    ax0.view_init(elev=elev, azim=azim)
    ax0.set_title(f"PCA-3 z_img - sample {sample_idx} (class={gt_class}) - "
                  f"steps={steps}")
    ax0.set_xlabel("PC1")
    ax0.set_ylabel("PC2")
    ax0.set_zlabel("PC3")
    cb = fig.colorbar(sc, ax=ax0, fraction=0.046, pad=0.02)
    cb.set_label("Numerosity / N_list (fallback: Labels)")
    ax0.legend(loc="best")
    _recon_panel(fig, gs, rows, cols, panel_imgs, panel_titles)
    plt.tight_layout()
    if run:
        run.log({f"{tag}/plot": wandb.Image(fig)})
    plt.close(fig)


# ---------------------------------------------------------------------------
# Vector-DB neighbour search (JAX imdbn_logging.py:417-640)
# ---------------------------------------------------------------------------

def ensure_val_bank(model) -> None:
    """Build and cache the host (Z, X, Y, H) validation banks on the model;
    H = [Σx, Σx²] is the image hash used for dedup (JAX :417-434)."""
    if hasattr(model, "_Z_bank"):
        return
    Z_list, X_list, Y_list, H_list = [], [], [], []
    for imgs, lbls in model.val_loader:
        Z_list.append(to_numpy(model.image_idbn.represent(imgs)))
        X_list.append(np.asarray(imgs, np.float32))
        Y_list.append(np.asarray(lbls, np.float32))
        flat = np.asarray(imgs, np.float32).reshape(len(imgs), -1)
        H_list.append(np.stack([flat.sum(1), (flat ** 2).sum(1)], axis=1))
    model._Z_bank = np.concatenate(Z_list, 0)
    model._X_bank = np.concatenate(X_list, 0)
    model._Y_bank = np.concatenate(Y_list, 0)
    model._H_bank = np.concatenate(H_list, 0)


def find_first_val_index_with_label(model, k: int) -> int:
    """First val index whose argmax label == k (JAX :437-446)."""
    idx = 0
    for _, lbls in model.val_loader:
        y = np.asarray(lbls).argmax(1)
        for j in range(len(y)):
            if int(y[j]) == int(k):
                return idx + j
        idx += len(y)
    return -1


def _scores(z_query: np.ndarray, Z: np.ndarray, metric: str) -> np.ndarray:
    if metric == "cosine":
        Zn = Z / (np.linalg.norm(Z, axis=1, keepdims=True) + 1e-12)
        zq = z_query / (np.linalg.norm(z_query, axis=1, keepdims=True)
                        + 1e-12)
        return zq @ Zn.T
    if metric in ("ip", "inner"):
        return z_query @ Z.T
    a2 = (z_query ** 2).sum(1, keepdims=True)
    b2 = (Z ** 2).sum(1)[None, :]
    return -(a2 + b2 - 2 * z_query @ Z.T)


def topk_similar_in_latent(model, z_query, k: int = 8,
                           metric: str = "cosine"):
    """Top-k neighbours in the validation latent bank by cosine / inner
    product / −L² (JAX :462-472). Returns (indices, scores)."""
    assert hasattr(model, "_Z_bank"), "Call ensure_val_bank() first."
    Z = model._Z_bank
    scores = _scores(np.asarray(to_numpy(z_query), np.float32), Z, metric)
    kk = min(k, Z.shape[0])
    topi = np.argsort(-scores, axis=1)[:, :kk]
    topv = np.take_along_axis(scores, topi, axis=1)
    return topi, topv


def log_vecdb_neighbors_for_traj(model, sample_idx: int = 0,
                                 steps: Optional[int] = None, k: int = 8,
                                 metric: str = "cosine", tag: str = "vecdb",
                                 also_l2: bool = True, dedup: str = "index",
                                 exclude_self: bool = True):
    """Neighbour grids and panels for z_true / z0 / zT of the TXT→IMG
    trajectory, with dedup by index or image hash and optional
    self-exclusion (JAX imdbn_logging.py:475-552)."""
    ensure_val_bank(model)
    Z_bank, X_bank = model._Z_bank, model._X_bank
    H_bank = model._H_bank
    run = model.wandb_run

    x_i, y_i = _fetch_val_sample(model, sample_idx)
    if x_i is None:
        if run:
            run.log({f"{tag}/warn": "sample_idx out of range"})
        return

    T = int(model.cross_steps if steps is None else steps)
    Z_traj = _run_traj(model, y_i, T)
    z_true = to_numpy(model.image_idbn.represent(x_i))
    z0 = Z_traj[:1]
    zT = Z_traj[-1:]

    def topk_dedup(zq, met, k):
        scores = _scores(np.asarray(zq, np.float32), Z_bank, met)[0]
        order = np.argsort(-scores)
        picked_ids, picked_vs = [], []
        seen_idx, seen_hash = set(), set()
        for i in order:
            i = int(i)
            if exclude_self and i == sample_idx:
                continue
            if dedup == "index":
                if i in seen_idx:
                    continue
                seen_idx.add(i)
            elif dedup == "image":
                key = (float(H_bank[i, 0]), float(H_bank[i, 1]))
                if key in seen_hash:
                    continue
                seen_hash.add(key)
            picked_ids.append(i)
            picked_vs.append(float(scores[i]))
            if len(picked_ids) >= k:
                break
        return np.asarray(picked_ids), np.asarray(picked_vs)

    idx_true, sc_true = topk_dedup(z_true, metric, k)
    idx_z0, sc_z0 = topk_dedup(z0, metric, k)
    idx_zT, sc_zT = topk_dedup(zT, metric, k)

    if run:
        for name, idx in [("z_true", idx_true), ("z0", idx_z0),
                          ("zT", idx_zT)]:
            X = X_bank[idx]
            grid = make_grid(X.reshape(len(X), *_img_shape(X)),
                             nrow=min(4, len(X)))
            run.log({f"{tag}/knn_{name}": wandb.Image(grid)})

    panels = [("Neighbors of z_true with GT", idx_true, sc_true,
               f"{tag}/knn_true_with_gt"),
              ("Neighbors of z0 with GT", idx_z0, sc_z0,
               f"{tag}/knn_z0_with_gt"),
              ("Neighbors of zT with GT", idx_zT, sc_zT,
               f"{tag}/knn_zT_with_gt")]
    if also_l2:
        idx_l2, sc_l2 = topk_dedup(zT, "l2", k)
        panels.append(("Neighbors of zT (L2) with GT", idx_l2, sc_l2,
                       f"{tag}/knn_zT_l2_with_gt"))
    for title, idx, sc, key in panels:
        panel_with_gt_and_neighbors(model, title, x_i, X_bank[idx], idx, sc,
                                    key)
    panel_gt_vs_decode_neighbors(model, "Neighbors of zT - GT vs Decode(z)",
                                 idx_zT, f"{tag}/knn_zT_gt_vs_decode")


def _img_shape(X: np.ndarray):
    if X.ndim >= 3:
        return X.shape[1:]
    side = int(round(X.shape[1] ** 0.5))
    return (side, side) if side * side == X.shape[1] else (X.shape[1], 1)


def panel_with_gt_and_neighbors(model, panel_title: str, gt_img,
                                neighbor_imgs, neighbor_indices,
                                neighbor_scores, tag_key: str):
    """GT tile + k neighbour tiles with rank/idx/score/label captions
    (JAX imdbn_logging.py:562-598)."""
    plt = pyplot(model.wandb_run, tag_key.replace("/", "_"))
    if plt is None:
        return
    gt = np.asarray(gt_img).reshape(1, *_img_shape(
        np.asarray(gt_img).reshape(1, -1)))
    nbr = np.asarray(neighbor_imgs)
    nbr = nbr.reshape(len(nbr), *_img_shape(nbr))
    k = len(nbr)
    y_idx_all = model._Y_bank.argmax(1)
    labels = [int(y_idx_all[int(i)]) for i in np.asarray(neighbor_indices)]

    rows = 2
    cols = math.ceil((k + 1) / rows)
    fig = plt.figure(figsize=(cols * 2.6, rows * 2.8))
    fig.suptitle(panel_title, fontsize=12)
    ax = fig.add_subplot(rows, cols, 1)
    ax.imshow(gt[0], cmap="gray", vmin=0, vmax=1)
    ax.set_title("Ground Truth", fontsize=10)
    ax.axis("off")
    for r in range(k):
        ax = fig.add_subplot(rows, cols, r + 2)
        ax.imshow(nbr[r], cmap="gray", vmin=0, vmax=1)
        ax.set_title(f"rank {r} | idx {int(neighbor_indices[r])}\n"
                     f"score {float(neighbor_scores[r]):.4f} | "
                     f"label {labels[r]}", fontsize=8)
        ax.axis("off")
    fig.tight_layout(rect=[0, 0.03, 1, 0.95])
    if model.wandb_run:
        model.wandb_run.log({tag_key: wandb.Image(fig)})
    plt.close(fig)


def panel_gt_vs_decode_neighbors(model, panel_title: str, neighbor_indices,
                                 tag_key: str):
    """GT vs Decode(z) pairs for neighbour latents (JAX :601-629)."""
    pick = np.asarray(neighbor_indices, np.int64)
    X = model._X_bank[pick]
    rec = to_numpy(model.image_idbn.decode(model._Z_bank[pick]))
    plt = pyplot(model.wandb_run, tag_key.replace("/", "_"))
    if plt is None:
        return
    X = X.reshape(len(X), *_img_shape(X))
    rec = rec.reshape(len(rec), *_img_shape(rec))
    k = len(X)
    fig = plt.figure(figsize=(2 * 2.4, max(1, k) * 2.2))
    fig.suptitle(panel_title, fontsize=12)
    for r in range(k):
        ax = fig.add_subplot(k, 2, 2 * r + 1)
        ax.imshow(X[r], cmap="gray", vmin=0, vmax=1)
        ax.set_title("GT", fontsize=9)
        ax.axis("off")
        ax = fig.add_subplot(k, 2, 2 * r + 2)
        ax.imshow(rec[r], cmap="gray", vmin=0, vmax=1)
        ax.set_title("Decode(z)", fontsize=9)
        ax.axis("off")
    fig.tight_layout(rect=[0, 0.03, 1, 0.95])
    if model.wandb_run:
        model.wandb_run.log({tag_key: wandb.Image(fig)})
    plt.close(fig)


def log_neighbors_images(model, indices, tag: str):
    """Simple neighbour-image grid (JAX imdbn_logging.py:632-640)."""
    X = model._X_bank
    pick = np.asarray(indices).reshape(-1).astype(np.int64)
    sel = X[pick]
    sel = sel.reshape(len(sel), *_img_shape(sel))
    grid = make_grid(sel, nrow=min(4, len(sel)))
    if model.wandb_run:
        model.wandb_run.log({tag: wandb.Image(grid)})


# ---------------------------------------------------------------------------
# Joint auto-reconstruction (JAX imdbn_logging.py:647-690)
# ---------------------------------------------------------------------------

def log_joint_auto_recon(model, epoch: int, num: int = 8):
    """One up-down pass through the joint RBM: text top-1/BCE and image MSE
    under ``auto_recon/*``, then the GT|joint grid (JAX :647-690)."""
    if (model.wandb_run is None or model.validation_images is None
            or model.validation_labels is None):
        return
    run = model.wandb_run
    dev = _device(model)
    imgs = as_tensor(model.validation_images, dev)[:num]
    lbls = as_tensor(model.validation_labels, dev)[:num]
    B = imgs.shape[0]

    z_top = model.image_idbn.represent(imgs)
    h = model.joint_rbm.forward(torch.cat([z_top, lbls], dim=1))
    v_recon = model.joint_rbm.backward(h)
    Dz = model.Dz_img
    y_hat = to_numpy(v_recon[:, Dz:])
    rec_img = np.clip(to_numpy(model.image_idbn.decode(v_recon[:, :Dz])),
                      0, 1)

    imgs_np = to_numpy(imgs)
    shape = _img_shape(imgs_np)
    imgs4 = imgs_np.reshape(B, *shape)
    rec4 = rec_img.reshape(B, *shape)

    t = to_numpy(lbls)
    top1 = float((y_hat.argmax(axis=1) == t.argmax(axis=1)).mean())
    p = np.clip(y_hat, 1e-6, 1 - 1e-6)
    text_bce = float(-(t * np.log(p) + (1 - t) * np.log1p(-p)).mean())
    mse = float(np.mean((imgs4.reshape(B, -1) - rec4.reshape(B, -1)) ** 2))
    run.log({"auto_recon/text_top1": top1, "epoch": epoch})
    run.log({"auto_recon/text_bce": text_bce, "epoch": epoch})
    run.log({"auto_recon/image_mse": mse, "epoch": epoch})

    pair = np.stack([imgs4, rec4], axis=1).reshape(-1, *shape)
    run.log({"auto_recon/gt_vs_joint": wandb.Image(make_grid(pair, nrow=2)),
             "epoch": epoch})
    return {"top1": top1, "text_bce": text_bce, "image_mse": mse}
