"""Cross-modal convergence tracing (steps-to-converge, no free energy).

Port of multimodal_idbn_tpu/utils/conditional_steps.py:33-661: the same
public functions, convergence criteria (``eps_l1=1e-3, stable_steps=3,
gap_thresh=0.25`` for IMG→TXT; Δz-L2 + MSE patience for TXT→IMG), keys and
panel statistics (p50/p95 and the "NC" histogram bin).

As in JAX, each panel's chains run batched over the whole panel for a
fixed number of steps and the convergence criteria are evaluated post-hoc
on the recorded trajectories. The chains are plain torch loops on the
model's device that keep every step (the chain kernel returns only the
final state), copied to the host once per chain; on the card each panel
chain is one graph replay (``ops.graphs``, the model's graphs), as JAX
jits ``_img2txt_panel_chain`` and ``_txt2img_panel_chain`` (:56, :88).
Draws come from
``ops.rng`` / ``ops.sampling`` keyed by the joint RBM's own stream, so the
deterministic sampler modes pin them in the tests. Numbers first: every
summary and statistic is logged before the figures.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multimodal_idbn_tpu_torch.device import as_tensor, to_numpy
from multimodal_idbn_tpu_torch.ops import dbn_train, graphs, rbm_ops, rng
from multimodal_idbn_tpu_torch.ops.sampling import (clamp_mask,
                                                    sample_bernoulli,
                                                    sample_visible)
from multimodal_idbn_tpu_torch.utils.wandb_compat import pyplot, wandb


def _groups(rbm):
    return tuple(tuple(g) for g in getattr(rbm, "softmax_groups", []) or [])


def _gibbs_conditional_step(rbm, v, v_known, known_mask, sample_h=False,
                            sample_v=False):
    """One conditional Gibbs step re-clamping to the ORIGINAL known values
    (JAX conditional_steps.py:33-53). Returns (v_next, v_prob)."""
    state = rbm.state if hasattr(rbm, "state") else rbm
    dev = state.w.device
    groups = _groups(rbm)
    key = rbm._next_key() if hasattr(rbm, "_next_key") else rng.fold_in(0, 0)
    kh, kv = rng.fold_in(key, 0), rng.fold_in(key, 1)
    h_prob = rbm_ops.hidden_probs(state, as_tensor(v, dev))
    h = sample_bernoulli(kh, h_prob) if sample_h else h_prob
    v_prob = rbm_ops.visible_probs(state, h, groups=groups)
    v_next = sample_visible(kv, v_prob, groups) if sample_v else v_prob
    v_next = clamp_mask(v_next, as_tensor(v_known, dev),
                        as_tensor(known_mask, dev))
    return v_next, v_prob


def _chain_step(joint, v, v_known, km, skey, groups, sample_h, sample_v):
    """(clamped v_next, v_prob) of one step of the panel chains."""
    kh, kv = rng.fold_in(skey, 0), rng.fold_in(skey, 1)
    h_prob = rbm_ops.hidden_probs(joint, v)
    h = sample_bernoulli(kh, h_prob) if sample_h else h_prob
    v_prob = rbm_ops.visible_probs(joint, h, groups=groups)
    v_next = sample_visible(kv, v_prob, groups) if sample_v else v_prob
    return clamp_mask(v_next, v_known, km), v_prob


def _img2txt_panel_chain(joint: rbm_ops.RBMState, key: int,
                         z: torch.Tensor, *, steps: int, groups,
                         sample_h: bool, sample_v: bool, Dz: int):
    """Batched IMG→TXT conditional chain; returns (y0 baseline [B, K],
    per-step y_soft [steps, B, K]) (JAX conditional_steps.py:56-85)."""
    B = z.shape[0]
    K = joint.vb.shape[0] - Dz
    dev = z.device
    v_known = torch.cat([z, torch.zeros((B, K), device=dev)], dim=1)
    km = torch.cat([torch.ones((B, Dz), device=dev),
                    torch.zeros((B, K), device=dev)], dim=1)
    k0, kloop = rng.fold_in(key, 0), rng.fold_in(key, 1)
    v = v_known * km + (1 - km) * rng.uniform(k0, v_known.shape, dev)
    # baseline half-step (reference conditional_steps.py:69-72)
    h0 = rbm_ops.hidden_probs(joint, v)
    y_prev0 = rbm_ops.visible_probs(joint, h0, groups=groups)[:, Dz:]
    ys = []
    for t in range(int(steps)):
        v, v_prob = _chain_step(joint, v, v_known, km, rng.fold_in(kloop, t),
                                groups, sample_h, sample_v)
        ys.append(v_prob[:, Dz:])
    return y_prev0, (torch.stack(ys) if ys
                     else torch.zeros((0, B, K), device=dev))


def _txt2img_panel_chain(joint: rbm_ops.RBMState, idbn_states, key: int,
                         y_onehot: torch.Tensor, img_gt: torch.Tensor,
                         z_init: torch.Tensor, *, steps: int, groups,
                         sample_h: bool, sample_v: bool, Dz: int,
                         ema_beta: float = 0.0):
    """Batched TXT→IMG chain with per-step decode; returns
    (dz [steps, B], mse [steps, B], z_final [B, Dz])
    (JAX conditional_steps.py:88-129).

    ``ema_beta`` > 0 smooths the *measured* trace only
    (``z_new = (1-beta)*z_prev + beta*z_soft``, decoded, diffed and carried
    as z_prev); the chain state ``v`` itself is never smoothed."""
    B, K = y_onehot.shape
    dev = y_onehot.device
    v_known = torch.cat([torch.zeros((B, Dz), device=dev), y_onehot], dim=1)
    km = torch.cat([torch.zeros((B, Dz), device=dev),
                    torch.ones((B, K), device=dev)], dim=1)
    v = torch.cat([z_init, y_onehot], dim=1)
    z_prev = v[:, :Dz]
    dzs, mses = [], []
    for t in range(int(steps)):
        v, v_prob = _chain_step(joint, v, v_known, km, rng.fold_in(key, t),
                                groups, sample_h, sample_v)
        z_soft = v_prob[:, :Dz]
        z_new = ((1.0 - ema_beta) * z_prev + ema_beta * z_soft
                 if ema_beta > 0.0 else z_soft)
        img_rec = dbn_train.dbn_decode(idbn_states, z_new)
        mses.append(((img_rec - img_gt) ** 2).mean(dim=1))
        dzs.append(torch.sqrt(((z_new - z_prev) ** 2).sum(dim=1)))
        z_prev = z_new
    empty = torch.zeros((0, B), device=dev)
    return (torch.stack(dzs) if dzs else empty,
            torch.stack(mses) if mses else empty, z_prev)


# ------------------------------
# IMG -> TXT trace (JAX conditional_steps.py:136-217)
# ------------------------------

def _img2txt_posthoc(y_prev0, ys, gt_idx, max_steps, eps_l1, stable_steps,
                     gap_thresh):
    """The reference's in-loop convergence bookkeeping, post-hoc on one
    sample (JAX conditional_steps.py:136-182)."""
    K = ys.shape[1]
    y_prev = y_prev0
    pred_cur = int(y_prev.argmax())
    streak = 0
    steps_to_conv = max_steps + 1
    p_top1, p_top2, p_gap, p_gt, l1_list = [], [], [], [], []
    top1_seq, top2_seq = [], []
    t_stop = max_steps
    for t in range(1, max_steps + 1):
        y = ys[t - 1]
        order = np.argsort(-y)
        k1, k2 = int(order[0]), int(order[1]) if K > 1 else int(order[0])
        p1, p2 = float(y[k1]), float(y[k2]) if K > 1 else 0.0
        gap = p1 - p2
        p_top1.append(p1)
        p_top2.append(p2)
        p_gap.append(gap)
        top1_seq.append(k1)
        top2_seq.append(k2)
        if gt_idx is not None:
            p_gt.append(float(y[gt_idx]))
        l1 = float(np.abs(y - y_prev).sum())
        l1_list.append(l1)
        pred_new = k1
        streak = streak + 1 if pred_new == pred_cur else 1
        pred_cur = pred_new
        if (l1 < eps_l1) and (streak >= stable_steps) and (gap >= gap_thresh):
            steps_to_conv = t
            t_stop = t
            break
        y_prev = y
    return {
        "dir": "img2txt",
        "steps_to_converge": steps_to_conv,
        "p_top1": p_top1[:t_stop],
        "p_top2": p_top2[:t_stop],
        "p_gap": p_gap[:t_stop],
        "p_gt": p_gt[:t_stop] if gt_idx is not None else None,
        "l1": l1_list[:t_stop],
        "predT": pred_cur,
        "top1_idx": top1_seq[:t_stop],
        "top2_idx": top2_seq[:t_stop],
        "gt_idx": gt_idx,
    }


def trace_img2txt_cross_batch(model, imgs, lbls=None, max_steps=70,
                              sample_h=False, sample_v=False, eps_l1=1e-3,
                              stable_steps=3, gap_thresh=0.25):
    """Batched IMG→TXT traces: one chain for all samples, then per-sample
    post-hoc convergence. Returns a list of reference-schema dicts."""
    z = model.image_idbn.represent(imgs)
    Dz = getattr(model, "Dz_img", z.shape[1])
    y0, ys = graphs.serve(
        model, z.device, _img2txt_panel_chain, model.joint_rbm._next_key(),
        rbm_ops.weights_only(model.joint_rbm.state), z=z,
        steps=int(max_steps), groups=_groups(model.joint_rbm),
        sample_h=sample_h, sample_v=sample_v, Dz=Dz)
    y0, ys = to_numpy(y0), to_numpy(ys)                      # ys [steps, B, K]
    gts = to_numpy(lbls).argmax(axis=1) if lbls is not None else None
    out = []
    for i in range(z.shape[0]):
        gt_i = int(gts[i]) if gts is not None else None
        out.append(_img2txt_posthoc(y0[i], ys[:, i], gt_i, int(max_steps),
                                    eps_l1, stable_steps, gap_thresh))
    return out


def trace_img2txt_cross(model, img, lbl_onehot=None, max_steps=70,
                        sample_h=False, sample_v=False, eps_l1=1e-3,
                        stable_steps=3, gap_thresh=0.25):
    """Single-sample IMG→TXT trace (JAX conditional_steps.py:210-217)."""
    return trace_img2txt_cross_batch(
        model, img, lbl_onehot, max_steps=max_steps, sample_h=sample_h,
        sample_v=sample_v, eps_l1=eps_l1, stable_steps=stable_steps,
        gap_thresh=gap_thresh)[0]


# ------------------------------
# TXT -> IMG trace (JAX conditional_steps.py:224-314)
# ------------------------------

def _txt2img_posthoc(dzs, mses, max_steps, eps_z, mse_tol, patience):
    best_mse = float("inf")
    no_improve = 0
    steps_to_conv = max_steps + 1
    z_l2_list, mse_list = [], []
    t_stop = max_steps
    for t in range(1, max_steps + 1):
        mse = float(mses[t - 1])
        dz = float(dzs[t - 1])
        mse_list.append(mse)
        z_l2_list.append(dz)
        if dz < eps_z:
            if mse + 1e-12 < best_mse - mse_tol:
                best_mse = mse
                no_improve = 0
            else:
                no_improve += 1
            if no_improve >= patience:
                steps_to_conv = t
                t_stop = t
                break
        else:
            if mse + 1e-12 < best_mse - mse_tol:
                best_mse = mse
            no_improve = 0
    return {
        "dir": "txt2img",
        "steps_to_converge": steps_to_conv,
        "z_l2": z_l2_list[:t_stop],
        "image_mse": mse_list[:t_stop],
        "best_mse": best_mse,
    }


def trace_txt2img_cross_batch(model, imgs, lbls, max_steps=70,
                              sample_h=False, sample_v=False, eps_z=1e-3,
                              mse_tol=1e-5, patience=3, ema_beta=0.0,
                              init: str = "reference"):
    """Batched TXT→IMG traces (one chain); returns (list of dicts, z_final
    as host numpy).

    ``init``: "reference" starts z from ``z_class_mean`` when available,
    else from one mean-field pass (reference conditional_steps.py:168-177);
    "random" from U(0,1) (the z-mismatch check's init, reference :602).
    """
    dev = model.joint_rbm.state.w.device
    img_gt = as_tensor(imgs, dev)
    y = as_tensor(lbls, dev)
    Dz = getattr(model, "Dz_img",
                 int(model.image_idbn.layers[-1].num_hidden))
    groups = _groups(model.joint_rbm)
    state = model.joint_rbm.state
    if init == "random":
        z_init = rng.uniform(model.joint_rbm._next_key(), (y.shape[0], Dz),
                             dev)
    elif getattr(model, "z_class_mean", None) is not None:
        z_init = as_tensor(model.z_class_mean, dev)[y.argmax(dim=1)]
    else:
        B = y.shape[0]
        v_known = torch.cat([torch.zeros((B, Dz), device=dev), y], dim=1)
        h0 = rbm_ops.hidden_probs(state, v_known)
        z_init = rbm_ops.visible_probs(state, h0, groups=groups)[:, :Dz]
    dzs, mses, z_final = graphs.serve(
        model, dev, _txt2img_panel_chain, model.joint_rbm._next_key(),
        rbm_ops.weights_only(state), model.image_idbn._weights(),
        y_onehot=y, img_gt=img_gt, z_init=z_init, steps=int(max_steps),
        groups=groups,
        sample_h=sample_h, sample_v=sample_v, Dz=Dz,
        ema_beta=float(ema_beta))
    dzs, mses = to_numpy(dzs), to_numpy(mses)
    out = [_txt2img_posthoc(dzs[:, i], mses[:, i], int(max_steps), eps_z,
                            mse_tol, patience)
           for i in range(img_gt.shape[0])]
    return out, to_numpy(z_final)


def trace_txt2img_cross(model, img, lbl_onehot, max_steps=70, sample_h=False,
                        sample_v=False, eps_z=1e-3, mse_tol=1e-5,
                        patience=3, ema_beta: float = 0.0):
    """Single-sample TXT→IMG trace (JAX conditional_steps.py:306-314)."""
    out, _ = trace_txt2img_cross_batch(
        model, img, lbl_onehot, max_steps=max_steps, sample_h=sample_h,
        sample_v=sample_v, eps_z=eps_z, mse_tol=mse_tol, patience=patience,
        ema_beta=ema_beta)
    return out[0]


# ------------------------------
# Fixed case / panel caches (JAX conditional_steps.py:321-362)
# ------------------------------

def pick_fixed_val_case(model, target_label: Optional[int] = None,
                        within_batch_index: int = 0):
    """Cache one val sample on ``model._fixed_val_case``."""
    from multimodal_idbn_tpu_torch.utils.energy_utils import (
        pick_fixed_val_case as _pick)
    return _pick(model, target_label=target_label,
                 within_batch_index=within_batch_index)


def build_or_get_fixed_val_panel(model, per_class: int = 4):
    """Fixed per-class validation panel, cached on
    ``model._fixed_val_panel`` as host numpy
    (JAX conditional_steps.py:330-362)."""
    if getattr(model, "_fixed_val_panel", None) is not None:
        return model._fixed_val_panel
    if model.val_loader is None:
        raise RuntimeError("val_loader is None")

    K = getattr(model, "num_labels", 32)
    buckets = [[] for _ in range(K)]
    for imgs, lbls in model.val_loader:
        imgs = np.asarray(imgs)
        lbls = np.asarray(lbls)
        for i in range(len(imgs)):
            cls = int(lbls[i].argmax())
            if len(buckets[cls]) < per_class:
                buckets[cls].append((imgs[i:i + 1], lbls[i:i + 1]))
        if all(len(b) >= per_class for b in buckets):
            break

    imgs_list, lbls_list = [], []
    for b in buckets:
        imgs_list.extend([x for (x, _) in b])
        lbls_list.extend([y for (_, y) in b])
    if not imgs_list:
        imgs, lbls = next(iter(model.val_loader))
        imgs_list = [np.asarray(imgs)[:1]]
        lbls_list = [np.asarray(lbls)[:1]]

    panel = (np.concatenate(imgs_list, axis=0),
             np.concatenate(lbls_list, axis=0))
    model._fixed_val_panel = panel
    return panel


# ------------------------------
# Logging (JAX conditional_steps.py:369-661)
# ------------------------------

def log_cross_case(model, out_img2txt: dict, out_txt2img: dict, epoch: int,
                   tag: str):
    """Per-case summary, then convergence plots and the top-k table
    (JAX conditional_steps.py:369-465)."""
    run = getattr(model, "wandb_run", None)
    if run is None:
        return
    class_names = getattr(model, "class_names", None)
    summary = {
        "img2txt_steps": (out_img2txt.get("steps_to_converge")
                          if out_img2txt else None),
        "txt2img_steps": (out_txt2img.get("steps_to_converge")
                          if out_txt2img else None),
        "txt2img_best_mse": (out_txt2img.get("best_mse")
                             if out_txt2img else None),
        "img2txt_pred_final": (out_img2txt.get("predT")
                               if out_img2txt else None),
        "img2txt_gt": (out_img2txt.get("gt_idx") if out_img2txt else None),
    }
    run.log({f"cross/{tag}/summary": summary, "epoch": epoch})

    if out_img2txt and out_img2txt.get("p_top1"):
        try:
            cols = ["step", "top1_idx", "p_top1", "top2_idx", "p_top2"]
            has_gt = out_img2txt.get("p_gt") is not None
            if has_gt:
                cols += ["y_true_idx", "p_y_true"]
            if class_names:
                cols += ["top1_label", "top2_label"]
                if has_gt:
                    cols += ["y_true_label"]
            tbl = wandb.Table(columns=cols)
            gt_idx = out_img2txt.get("gt_idx")
            for t in range(len(out_img2txt["p_top1"])):
                r = [t + 1, out_img2txt["top1_idx"][t],
                     out_img2txt["p_top1"][t], out_img2txt["top2_idx"][t],
                     out_img2txt["p_top2"][t]]
                if has_gt:
                    r += [gt_idx, out_img2txt["p_gt"][t]]
                if class_names:
                    r += [class_names[out_img2txt["top1_idx"][t]],
                          class_names[out_img2txt["top2_idx"][t]]]
                    if has_gt and gt_idx is not None:
                        r += [class_names[gt_idx]]
                tbl.add_data(*r)
            run.log({f"cross/{tag}/img2txt_topk_table": tbl, "epoch": epoch})
        except Exception:  # a real W&B may refuse a ragged table
            pass

    if not ((out_img2txt and out_img2txt.get("p_top1")) or out_txt2img):
        return
    plt = pyplot(run, f"cross_{tag}")
    if plt is None:
        return
    if out_img2txt and out_img2txt.get("p_top1"):
        xs = range(1, 1 + len(out_img2txt["p_top1"]))
        fig1, ax1 = plt.subplots(figsize=(5, 3))
        ax1.plot(xs, out_img2txt["p_top1"], label="p_top1")
        ax1.plot(xs, out_img2txt["p_top2"], label="p_top2")
        if out_img2txt.get("p_gt"):
            ax1.plot(xs, out_img2txt["p_gt"], label="p(y_true)",
                     linestyle="--")

        def to_name(k):
            if class_names and 0 <= k < len(class_names):
                return f"{k}:{class_names[k]}"
            return str(k)

        k1f = out_img2txt["top1_idx"][-1]
        k2f = out_img2txt["top2_idx"][-1]
        ax1.set_ylim(0, 1)
        ax1.set_xlabel("step")
        ax1.set_ylabel("prob")
        ax1.set_title(f"IMG->TXT (Gibbs) - final top1={to_name(k1f)}, "
                      f"top2={to_name(k2f)}")
        ax1.legend()
        run.log({f"cross/{tag}/img2txt_p": wandb.Image(fig1),
                 "epoch": epoch})
        plt.close(fig1)

        fig2, ax2 = plt.subplots(figsize=(5, 3))
        ax2.plot(xs, out_img2txt["p_gap"], label="gap=p1-p2")
        ax2.set_xlabel("step")
        ax2.set_ylabel("gap")
        ax2.set_title("IMG->TXT gap")
        run.log({f"cross/{tag}/img2txt_gap": wandb.Image(fig2),
                 "epoch": epoch})
        plt.close(fig2)

    if out_txt2img:
        fig3, ax3 = plt.subplots(figsize=(5, 3))
        xs = range(1, 1 + len(out_txt2img["image_mse"]))
        ax3.plot(xs, out_txt2img["image_mse"])
        ax3.set_xlabel("step")
        ax3.set_ylabel("MSE")
        ax3.set_title("TXT->IMG (Gibbs) MSE vs GT")
        run.log({f"cross/{tag}/txt2img_mse": wandb.Image(fig3),
                 "epoch": epoch})
        plt.close(fig3)


def run_and_log_cross_fixed_case(model, epoch: int,
                                 target_label: Optional[int] = None,
                                 within_batch_index: int = 0,
                                 max_steps: int = 70, sample_h: bool = False,
                                 sample_v: bool = False,
                                 tag: str = "fixed_cross"):
    """Both directions on the fixed sample (JAX :468-484)."""
    img, lbl = pick_fixed_val_case(model, target_label=target_label,
                                   within_batch_index=within_batch_index)
    out_img2txt = trace_img2txt_cross(model, img, lbl_onehot=lbl,
                                      max_steps=max_steps, sample_h=sample_h,
                                      sample_v=sample_v)
    out_txt2img = trace_txt2img_cross(model, img, lbl_onehot=lbl,
                                      max_steps=max_steps, sample_h=sample_h,
                                      sample_v=sample_v)
    log_cross_case(model, out_img2txt, out_txt2img, epoch=epoch, tag=tag)
    return out_img2txt, out_txt2img


def _steps_stats(steps_list, max_steps):
    """Converged-only stats (JAX conditional_steps.py:487-500)."""
    arr = np.asarray(steps_list, dtype=np.int32)
    conv_mask = arr <= max_steps
    conv_vals = arr[conv_mask]
    stats = {
        "n_total": int(arr.size),
        "n_converged": int(conv_vals.size),
        "frac_converged": float(conv_vals.size / max(1, arr.size)),
        "mean": float(conv_vals.mean()) if conv_vals.size else None,
        "p50": float(np.percentile(conv_vals, 50)) if conv_vals.size else None,
        "p95": float(np.percentile(conv_vals, 95)) if conv_vals.size else None,
    }
    return stats, conv_mask


def _plot_steps_hist_with_nc(plt, steps_list, max_steps, title):
    """Histogram 1..max_steps plus an 'NC' (non-converged) bin
    (JAX conditional_steps.py:503-521)."""
    arr = np.asarray(steps_list, dtype=np.int32)
    counts = [int((arr == s).sum()) for s in range(1, max_steps + 1)]
    labels = [str(s) for s in range(1, max_steps + 1)]
    counts.append(int((arr > max_steps).sum()))
    labels.append("NC")
    fig, ax = plt.subplots(figsize=(min(12, max_steps * 0.35 + 2), 3.2))
    ax.bar(np.arange(len(labels)), counts)
    ax.set_xticks(np.arange(len(labels)))
    ax.set_xticklabels(labels)
    ax.set_xlabel("Gibbs steps")
    ax.set_ylabel("# samples")
    ax.set_title(title)
    return fig


def run_and_log_cross_panel(model, epoch: int, per_class: int = 4,
                            max_steps: int = 70, sample_h: bool = False,
                            sample_v: bool = False, tag: str = "panel"):
    """Panel aggregation: per-class fixed panel, both directions, p50/p95/
    frac_converged summary, then the histograms
    (JAX conditional_steps.py:524-592). The whole panel runs as two batched
    chains, one per direction."""
    imgs, lbls = build_or_get_fixed_val_panel(model, per_class=per_class)

    outs_i2t = trace_img2txt_cross_batch(model, imgs, lbls,
                                         max_steps=max_steps,
                                         sample_h=sample_h,
                                         sample_v=sample_v)
    outs_t2i, _ = trace_txt2img_cross_batch(model, imgs, lbls,
                                            max_steps=max_steps,
                                            sample_h=sample_h,
                                            sample_v=sample_v)

    i2t_steps = [int(o["steps_to_converge"]) for o in outs_i2t]
    t2i_steps = [int(o["steps_to_converge"]) for o in outs_t2i]
    i2t_p1_final = [float(o["p_top1"][-1]) for o in outs_i2t if o["p_top1"]]
    i2t_gap_final = [float(o["p_gap"][-1]) for o in outs_i2t if o["p_gap"]]
    t2i_best_mse = [float(o.get("best_mse", float("inf")))
                    for o in outs_t2i]

    i2t_stats, _ = _steps_stats(i2t_steps, max_steps)
    t2i_stats, _ = _steps_stats(t2i_steps, max_steps)
    mean_p1 = float(np.mean(i2t_p1_final)) if i2t_p1_final else None
    mean_gap = float(np.mean(i2t_gap_final)) if i2t_gap_final else None
    mean_best_mse = float(np.mean(t2i_best_mse)) if t2i_best_mse else None

    run = getattr(model, "wandb_run", None)
    if run is not None:
        summary = {
            "img2txt/mean": i2t_stats["mean"],
            "img2txt/p50": i2t_stats["p50"],
            "img2txt/p95": i2t_stats["p95"],
            "img2txt/frac_converged": i2t_stats["frac_converged"],
            "txt2img/mean": t2i_stats["mean"],
            "txt2img/p50": t2i_stats["p50"],
            "txt2img/p95": t2i_stats["p95"],
            "txt2img/frac_converged": t2i_stats["frac_converged"],
            "img2txt/p_top1_final_mean": mean_p1,
            "img2txt/p_gap_final_mean": mean_gap,
            "txt2img/best_mse_mean": mean_best_mse,
            "n_total": i2t_stats["n_total"],
        }
        run.log({f"conv/panel/{tag}/summary": summary, "epoch": epoch})
        plt = pyplot(run, f"conv_panel_{tag}")
        if plt is not None:
            for direction, steps in (("img2txt", i2t_steps),
                                     ("txt2img", t2i_steps)):
                label = ("IMG->TXT" if direction == "img2txt"
                         else "TXT->IMG")
                fig = _plot_steps_hist_with_nc(
                    plt, steps, max_steps,
                    f"{label} panel: steps to converge")
                run.log({f"conv/panel/{tag}/{direction}_steps_hist":
                         wandb.Image(fig), "epoch": epoch})
                plt.close(fig)

    return {
        "img2txt": {"steps": i2t_steps, "stats": i2t_stats,
                    "p1_mean": mean_p1, "gap_mean": mean_gap},
        "txt2img": {"steps": t2i_steps, "stats": t2i_stats,
                    "best_mse_mean": mean_best_mse},
    }


def run_and_log_z_mismatch_check(model, epoch: int, max_steps: int = 20,
                                 sample_h: bool = False,
                                 sample_v: bool = False,
                                 tag: str = "z_check"):
    """Compare z_img (from the image branch) with z_y (from TXT→IMG
    inference): per-component stats, cos(z_y, z_img), then histograms
    (JAX conditional_steps.py:595-661). One chain for the whole
    validation batch, from a random init like the reference's."""
    run = getattr(model, "wandb_run", None)
    if run is None:
        return
    try:
        imgs, lbls = next(iter(model.val_loader))
    except (StopIteration, TypeError):  # no loader or an empty one
        return

    z_img = to_numpy(model.image_idbn.represent(imgs))
    _, z_y = trace_txt2img_cross_batch(model, imgs, lbls,
                                       max_steps=max_steps,
                                       sample_h=sample_h, sample_v=sample_v,
                                       init="random")

    def _stats(t):
        return {
            "mean": float(t.mean()),
            "std": float(t.std()),
            "q10": float(np.quantile(t, 0.10)),
            "q90": float(np.quantile(t, 0.90)),
        }

    z_img_u = z_img / (np.linalg.norm(z_img, axis=1, keepdims=True) + 1e-12)
    z_y_u = z_y / (np.linalg.norm(z_y, axis=1, keepdims=True) + 1e-12)
    cosine = np.clip((z_img_u * z_y_u).sum(axis=1), -1, 1)

    run.log({f"zcheck/{tag}/z_img_stats": _stats(z_img), "epoch": epoch})
    run.log({f"zcheck/{tag}/z_y_stats": _stats(z_y), "epoch": epoch})
    run.log({f"zcheck/{tag}/cosine_mean": float(cosine.mean()),
             "epoch": epoch})

    plt = pyplot(run, f"zcheck_{tag}")
    if plt is not None:
        fig1, ax1 = plt.subplots(figsize=(5, 3))
        ax1.hist(z_img.flatten(), bins=50, alpha=0.6, label="z_img")
        ax1.hist(z_y.flatten(), bins=50, alpha=0.6, label="z_y")
        ax1.set_title("Histogram z values")
        ax1.legend()
        run.log({f"zcheck/{tag}/hist": wandb.Image(fig1), "epoch": epoch})
        plt.close(fig1)

        fig2, ax2 = plt.subplots(figsize=(5, 3))
        ax2.hist(cosine, bins=30)
        ax2.set_title("cos(z_y, z_img) per sample")
        run.log({f"zcheck/{tag}/cosine_hist": wandb.Image(fig2),
                 "epoch": epoch})
        plt.close(fig2)
    return float(cosine.mean())
