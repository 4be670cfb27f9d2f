"""Free-energy diagnostics and IMG→TXT convergence tracing.

Port of multimodal_idbn_tpu/utils/energy_utils.py:29-324: free energy,
per-class free energies F_k(z) broadcast over K, the deterministic
"mean-field lite" IMG→TXT step, fixed-validation-case caching, and the
logging helpers. The fixed-length trace is a plain torch loop on the
model's device that keeps every step (JAX's ``lax.scan``; the chain kernel
returns only the final state), copied to the host once; on the card it
and the class free energies are one graph replay each (``ops.graphs``,
the model's graphs), as JAX jits them (:39, :115); the convergence
criterion is then evaluated post-hoc on the trajectory, as in JAX.
Numbers first: the case summary is logged before its two figures.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multimodal_idbn_tpu_torch.device import as_tensor, to_numpy
from multimodal_idbn_tpu_torch.ops import graphs, rbm_ops, rng
from multimodal_idbn_tpu_torch.ops.sampling import (
    sample_bernoulli, sample_categorical_onehot)
from multimodal_idbn_tpu_torch.utils.wandb_compat import pyplot, wandb


def _state_of(rbm) -> rbm_ops.RBMState:
    return rbm.state if hasattr(rbm, "state") else rbm


def _device_of(rbm) -> torch.device:
    return _state_of(rbm).w.device


def rbm_free_energy(rbm, v) -> torch.Tensor:
    """F(v) = −v·b_v − Σ_j softplus(b_h + vW)_j (JAX energy_utils.py:33-36).
    Accepts an RBM shell or an RBMState."""
    return rbm_ops.free_energy(_state_of(rbm), as_tensor(v, _device_of(rbm)))


def class_free_energies(joint_rbm, z_img_top, K: int, Dz: int
                        ) -> torch.Tensor:
    """F_k(z) = F([z, e_k]) for all classes, broadcast over K without a
    B×K visible blowup (JAX energy_utils.py:39-57); one graph replay on
    the card, in the shell's graphs (``graphs.SHARED`` for a bare
    state)."""
    state = _state_of(joint_rbm)
    dev = state.w.device
    owner = joint_rbm if hasattr(joint_rbm, "state") else graphs.SHARED
    return graphs.serve(owner, dev, _class_free_energies, None,
                        rbm_ops.weights_only(state),
                        as_tensor(z_img_top, dev), K=int(K), Dz=int(Dz))


def _class_free_energies(state: rbm_ops.RBMState, z: torch.Tensor, *,
                         K: int, Dz: int) -> torch.Tensor:
    Wz, Wy = state.w[:Dz, :], state.w[Dz:Dz + K, :]
    bz, by = state.vb[:Dz], state.vb[Dz:Dz + K]
    z_bz = (z * bz[None, :]).sum(dim=1, keepdim=True)          # [B, 1]
    pre_h_base = z @ Wz + state.hb[None, :]                    # [B, H]
    pre_h_all = pre_h_base[:, None, :] + Wy[None, :, :]        # [B, K, H]
    term_hidden = torch.nn.functional.softplus(pre_h_all).sum(dim=2)
    return -(z_bz + by[None, :]) - term_hidden


# ============================================================
# Deterministic IMG→TXT "mean-field lite" step (JAX :64-112)
# ============================================================

def _lite_label_block(v_next: torch.Tensor, Dz: int, K: int,
                      softmax_y: bool) -> torch.Tensor:
    y = v_next[:, Dz:Dz + K]
    if softmax_y:
        # the reference softmaxes the sigmoid *probabilities*, not logits
        # (energy_utils.py:72-74) — the deliberate "lite" step
        return torch.softmax(y, dim=1)
    return torch.clamp(y, 1e-6, 1 - 1e-6)


def _deterministic_img2txt_step_fn(state: rbm_ops.RBMState, v: torch.Tensor,
                                   Dz: int, K: int,
                                   softmax_y: bool = True) -> torch.Tensor:
    h_prob = torch.sigmoid(v @ state.w + state.hb)
    v_next = torch.sigmoid(h_prob @ state.w.T + state.vb)
    v_next = torch.cat([v[:, :Dz], v_next[:, Dz:]], dim=1)     # re-clamp z
    y = _lite_label_block(v_next, Dz, K, softmax_y)
    return torch.cat([v_next[:, :Dz], y, v_next[:, Dz + K:]], dim=1)


def _deterministic_img2txt_step(joint_rbm, v, Dz: int, K: int,
                                softmax_y: bool = True, sample_h: bool = False,
                                sample_v: bool = False,
                                key: Optional[int] = None) -> torch.Tensor:
    """Public mirror of JAX energy_utils.py:80-112. The stochastic branches
    (Bernoulli h, categorical y resampling) default off like the callers'."""
    state = _state_of(joint_rbm)
    v = as_tensor(v, state.w.device)
    if not sample_h and not sample_v:
        return _deterministic_img2txt_step_fn(state, v, Dz, K, softmax_y)
    if key is None:
        key = (joint_rbm._next_key() if hasattr(joint_rbm, "_next_key")
               else rng.fold_in(0, 0))
    kh, kv = rng.fold_in(key, 0), rng.fold_in(key, 1)
    h_prob = torch.sigmoid(v @ state.w + state.hb)
    h = sample_bernoulli(kh, h_prob) if sample_h else h_prob
    v_next = torch.sigmoid(h @ state.w.T + state.vb)
    v_next = torch.cat([v[:, :Dz], v_next[:, Dz:]], dim=1)
    y = _lite_label_block(v_next, Dz, K, softmax_y)
    if sample_v:  # categorical resampling of y (reference :83-85)
        y = sample_categorical_onehot(kv, y)
    return torch.cat([v_next[:, :Dz], y, v_next[:, Dz + K:]], dim=1)


def _img2txt_chain(state: rbm_ops.RBMState, z: torch.Tensor, *, Dz: int,
                   K: int, steps: int) -> torch.Tensor:
    """Full fixed-length y-trajectory [steps, B, K] (JAX :115-128)."""
    B = z.shape[0]
    v = torch.cat([z, torch.full((B, K), 1.0 / K, device=z.device)], dim=1)
    ys = []
    for _ in range(int(steps)):
        v = _deterministic_img2txt_step_fn(state, v, Dz, K, True)
        ys.append(v[:, Dz:Dz + K])
    if not ys:
        return torch.zeros((0, B, K), device=z.device)
    return torch.stack(ys)


def trace_single_img2txt(model, img, lbl_onehot=None, steps: int = 30,
                         eps_l1: float = 1e-3, stable_steps: int = 3,
                         gap_thresh: float = 0.25) -> dict:
    """Energy-based IMG→TXT convergence trace on one sample
    (JAX energy_utils.py:131-214): mean-field steps until the label
    distribution stabilizes, with per-class free energies computed once
    (z is clamped, so F_k(z) is constant). Trajectories are truncated at
    the convergence step, like the reference's early break."""
    joint = model.joint_rbm
    z = torch.clamp(model.image_idbn.represent(img), 1e-6, 1 - 1e-6)

    Dz = getattr(model, "Dz_img", z.shape[1])
    K = getattr(model, "num_labels",
                lbl_onehot.shape[1] if lbl_onehot is not None else 32)

    Fk = to_numpy(class_free_energies(joint, z, K, Dz))[0]     # [K]
    kstar = int(Fk.argmin())
    Fmin = float(Fk.min())
    top2 = np.sort(Fk)[:2]
    margin_energy = float(top2[1] - top2[0])

    ys = to_numpy(graphs.serve(
        model, z.device, _img2txt_chain, None,
        rbm_ops.weights_only(_state_of(joint)), z, Dz=Dz, K=K,
        steps=int(steps)))[:, 0, :]                            # [steps, K]

    gt = (int(np.argmax(to_numpy(lbl_onehot), axis=1)[0])
          if lbl_onehot is not None else None)

    # Post-hoc convergence scan (the reference's in-loop criterion,
    # energy_utils.py:144-167)
    p_top1, p_top2, p_gap, p_gt, deltaF = [], [], [], [], []
    y_prev = np.full(K, 1.0 / K, np.float32)
    pred_cur = int(y_prev.argmax())
    streak = 0
    steps_to_conv = steps + 1
    t_stop = steps
    for t in range(1, steps + 1):
        y = ys[t - 1]
        srt = np.sort(y)[::-1]
        p1, p2 = float(srt[0]), float(srt[1]) if K > 1 else 0.0
        gap = p1 - p2
        p_top1.append(p1)
        p_top2.append(p2)
        p_gap.append(gap)
        if gt is not None:
            p_gt.append(float(y[gt]))
        pred_new = int(y.argmax())
        streak = streak + 1 if pred_new == pred_cur else 1
        pred_cur = pred_new
        deltaF.append(float(Fk[pred_cur] - Fmin))
        l1 = float(np.abs(y - y_prev).sum())
        if (l1 < eps_l1) and (streak >= stable_steps) and (
                pred_cur == kstar or gap >= gap_thresh):
            steps_to_conv = t
            t_stop = t
            break
        y_prev = y

    p_top1, p_top2, p_gap = p_top1[:t_stop], p_top2[:t_stop], p_gap[:t_stop]
    deltaF = deltaF[:t_stop]
    fe_probs = np.exp(-Fk - np.max(-Fk))
    fe_probs = fe_probs / fe_probs.sum()
    fe_sorted = np.sort(fe_probs)[::-1]

    return {
        "deltaF_pred_traj": deltaF,
        "deltaF_pred_final": deltaF[-1] if deltaF else None,
        "p_top1": p_top1,
        "p_top2": p_top2,
        "p_gap": p_gap,
        "p_gt": p_gt if gt is not None else None,
        "p_top1_final": p_top1[-1] if p_top1 else float(1.0 / K),
        "p_gap_final": p_gap[-1] if p_gap else 0.0,
        "fe_top1_final": float(fe_sorted[0]),
        "fe_gap_final": float(fe_sorted[0] - fe_sorted[1]) if K > 1 else 0.0,
        "steps_to_converge": steps_to_conv,
        "kstar": kstar,
        "predT": pred_cur,
        "margin_energy": margin_energy,
        "gt": gt,
    }


# ============================================================
# Fixed validation case (JAX energy_utils.py:221-262)
# ============================================================

def pick_fixed_val_case(model, target_label: Optional[int] = None,
                        within_batch_index: int = 0):
    """Pick one val (img, onehot) pair and cache it on
    ``model._fixed_val_case`` (host numpy) so every epoch traces the same
    sample (JAX energy_utils.py:221-254)."""
    if getattr(model, "_fixed_val_case", None) is not None:
        return model._fixed_val_case
    if model.val_loader is None:
        raise RuntimeError("model.val_loader is None")

    chosen_img, chosen_lbl = None, None
    if target_label is None:
        for imgs, lbls in model.val_loader:
            chosen_img = np.asarray(imgs)[within_batch_index:
                                          within_batch_index + 1]
            chosen_lbl = np.asarray(lbls)[within_batch_index:
                                          within_batch_index + 1]
            break
    else:
        for imgs, lbls in model.val_loader:
            idx = np.nonzero(np.asarray(lbls).argmax(axis=1)
                             == target_label)[0]
            if idx.size > 0:
                i0 = int(idx[0])
                chosen_img = np.asarray(imgs)[i0:i0 + 1]
                chosen_lbl = np.asarray(lbls)[i0:i0 + 1]
                break
        if chosen_img is None:
            imgs, lbls = next(iter(model.val_loader))
            chosen_img = np.asarray(imgs)[:1]
            chosen_lbl = np.asarray(lbls)[:1]

    model._fixed_val_case = (chosen_img, chosen_lbl)
    return chosen_img, chosen_lbl


def pick_val_case(model, target_label: Optional[int] = None,
                  batch_idx: int = 0, within_batch_index: int = 0):
    """Backwards-compatible alias (JAX energy_utils.py:257-262)."""
    del batch_idx
    return pick_fixed_val_case(model, target_label=target_label,
                               within_batch_index=within_batch_index)


# ============================================================
# Logging (JAX energy_utils.py:269-324)
# ============================================================

def log_single_case_energy(model, case_dict: dict, epoch: int,
                           tag: str = "fixed_case"):
    """Summary, then ΔF_pred(t) and confidence curves
    (JAX energy_utils.py:269-312)."""
    run = getattr(model, "wandb_run", None)
    if run is None:
        return
    txt = {k: case_dict.get(k) for k in
           ("gt", "kstar", "predT", "steps_to_converge", "p_top1_final",
            "p_gap_final", "fe_top1_final", "fe_gap_final",
            "deltaF_pred_final", "margin_energy")}
    run.log({f"case/{tag}/summary": txt, "epoch": epoch})

    plt = pyplot(run, f"case_{tag}")
    if plt is None:
        return
    if case_dict.get("deltaF_pred_traj"):
        fig1, ax1 = plt.subplots(figsize=(5, 3))
        xs = range(1, 1 + len(case_dict["deltaF_pred_traj"]))
        ax1.plot(xs, case_dict["deltaF_pred_traj"])
        ax1.set_xlabel("step")
        ax1.set_ylabel("dF_pred = F_yhat - F_min")
        ax1.set_title("Label energy (IMG->TXT)")
        run.log({f"case/{tag}/deltaF_pred_vs_steps": wandb.Image(fig1),
                 "epoch": epoch})
        plt.close(fig1)

    if case_dict.get("p_top1") and case_dict.get("p_top2"):
        fig2, ax2 = plt.subplots(figsize=(5, 3))
        ax2.plot(range(1, 1 + len(case_dict["p_top1"])),
                 case_dict["p_top1"], label="p_top1")
        ax2.plot(range(1, 1 + len(case_dict["p_top2"])),
                 case_dict["p_top2"], label="p_top2")
        if case_dict.get("p_gt"):
            ax2.plot(range(1, 1 + len(case_dict["p_gt"])),
                     case_dict["p_gt"], label="p(y_true)", linestyle="--")
        ax2.set_ylim(0, 1)
        ax2.set_xlabel("step")
        ax2.set_ylabel("probability")
        ax2.set_title("Confidence over time (IMG->TXT)")
        ax2.legend()
        run.log({f"case/{tag}/p_curves": wandb.Image(fig2), "epoch": epoch})
        plt.close(fig2)


def run_and_log_fixed_case(model, epoch: int,
                           target_label: Optional[int] = None,
                           within_batch_index: int = 0, steps: int = 30,
                           tag: str = "fixed") -> dict:
    """Trace the fixed case and log (JAX energy_utils.py:315-324)."""
    img, lbl = pick_fixed_val_case(model, target_label=target_label,
                                   within_batch_index=within_batch_index)
    case = trace_single_img2txt(model, img, lbl, steps=steps)
    log_single_case_energy(model, case, epoch=epoch, tag=tag)
    return case
