"""Linear-probe diagnostics over validation embeddings.

Port of multimodal_idbn_tpu/utils/probe_utils.py:29-396: the same public
functions, metric names and CSV side effects. Embeddings are computed and
kept on the model's device, and the probe trains there: a full-batch
linear classifier with cross entropy, AdamW written as the JAX package
writes it (:161-171; not ``torch.optim.AdamW``, whose decay is applied in
another order) and early stopping on the validation loss with patience.

JAX runs the probe as one ``lax.while_loop`` (:174-233). Here the loop's
state stays on the device and every step is masked by the loop's
condition (``step < max_steps and no_improve < patience``): once it is
false the state freezes exactly, and the host reads the condition only
every ``check_every`` steps to leave the loop early. The result is the
same whatever ``check_every`` is, with one host sync per ``check_every``
steps instead of one per step. On the card a chunk of ``check_every``
steps is one graph replay (``ops.graphs.update``, the graphs of
``graphs.SHARED``): captured once per probe shape and setting, the state
updated in its buffers from chunk to chunk. The gradient is the closed form of the
softmax cross entropy's, ``Xᵀ(softmax(XW + b) − onehot(y)) / n``.

The initial weights: JAX draws them from threefry, which the port cannot
draw; ``train_linear_classifier`` takes them as ``init=(W0, b0)`` (the
tests hand it JAX's), and by default draws the same U(−1/√D, 1/√D) from a
``torch.Generator`` seeded 0, on the CPU, so a probe starts from the same
weights on every device.

Numbers first: accuracies, confusion counts and bin edges are logged
before the summary figure. The confusion table is JAX's
``Table(dataframe=df)`` where pandas is installed, else the same counts as
``Table(columns=..., data=...)``; the CSV is the same file either way.
"""

from __future__ import annotations

import csv
import math
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodal_idbn_tpu_torch.device import as_tensor, to_numpy
from multimodal_idbn_tpu_torch.ops import graphs
from multimodal_idbn_tpu_torch.utils.wandb_compat import (has_pandas, pyplot,
                                                          wandb)


# -------------------------
# Embeddings + features (JAX probe_utils.py:29-105)
# -------------------------

def _get_feat(d: dict, *candidates):
    norm = {k.lower().replace(" ", "").replace("_", ""): k for k in d.keys()}
    for c in candidates:
        key = norm.get(c.lower().replace(" ", "").replace("_", ""))
        if key is not None:
            return d[key]
    return None


def _to_1d_float(t) -> Optional[np.ndarray]:
    if t is None:
        return None
    t = to_numpy(t)
    if t.ndim == 2:  # one-hot → indices
        t = np.argmax(t, axis=1)
    return t.reshape(-1).astype(np.float32)


def _collect_feats(model, n: int) -> Dict[str, np.ndarray]:
    feats_src = getattr(model, "features", None)
    if feats_src is None:
        raise RuntimeError("model.features is required")
    cum_area = _to_1d_float(_get_feat(feats_src, "Cumulative Area",
                                      "cum_area"))
    chull = _to_1d_float(_get_feat(feats_src, "Convex Hull", "convex_hull",
                                   "convexhull"))
    labels = _to_1d_float(_get_feat(feats_src, "Labels", "labels"))
    density = _to_1d_float(_get_feat(feats_src, "Density", "density"))

    def _check(name, v):
        if v is None:
            return False
        if v.size != n:
            raise RuntimeError(f"Feature '{name}' length mismatch: "
                               f"{v.size} vs embeddings {n}.")
        return True

    feats: Dict[str, np.ndarray] = {}
    if _check("cum_area", cum_area):
        feats["cum_area"] = cum_area
    if _check("convex_hull", chull):
        feats["convex_hull"] = chull
    if _check("labels", labels):
        feats["labels"] = labels
    if density is not None and _check("density", density):
        feats["density"] = density
    return feats


def _model_device(model) -> torch.device:
    return getattr(model, "device", None) or torch.device("cpu")


def compute_val_embeddings_and_features(model, upto_layer: Optional[int] = None
                                        ) -> Tuple[torch.Tensor, dict]:
    """Encode the whole (unshuffled) val set; return [N, D] embeddings on
    the model's device and the aligned feature dict
    (JAX probe_utils.py:78-92)."""
    assert model.val_loader is not None, "val_loader is None."
    embeds = []
    for batch_data, batch_labels in model.val_loader:
        x = batch_labels if getattr(model, "text_flag", False) else batch_data
        embeds.append(model.represent(x) if upto_layer is None
                      else model.represent(x, upto_layer=upto_layer))
    E = (torch.cat(embeds, dim=0) if embeds
         else torch.zeros((0, 0), device=_model_device(model)))
    return E, _collect_feats(model, E.shape[0])


def compute_joint_embeddings_and_features(model) -> Tuple[torch.Tensor, dict]:
    """Joint-top embeddings over the val set (JAX probe_utils.py:95-105)."""
    assert model.val_loader is not None, "val_loader is None."
    embeds = [model.represent((img_data, labels))
              for img_data, labels in model.val_loader]
    if not embeds:
        return torch.zeros((0, 0), device=_model_device(model)), {}
    E = torch.cat(embeds, dim=0)
    return E, _collect_feats(model, E.shape[0])


# -------------------------
# Binning + split (JAX probe_utils.py:112-154), NumPy as there
# -------------------------

def make_bin_labels(values: np.ndarray, n_bins: int = 5):
    """Quantile binning with a 1e-6 jitter on tied edges; returns
    (labels 0..n_bins-1, edges [n_bins+1])."""
    values = np.asarray(values, np.float32)
    qs = np.linspace(0, 1, n_bins + 1)
    edges = np.quantile(values, qs, method="linear").astype(np.float32)
    for k in range(1, len(edges)):
        if edges[k] <= edges[k - 1]:
            edges[k] = edges[k - 1] + 1e-6
    inner = edges[1:-1]
    # torch.bucketize(right=False) == searchsorted side='left'
    labels = np.searchsorted(inner, values, side="left")
    return labels.astype(np.int64), edges


def _format_bin_names(edges: np.ndarray, precision: int = 4) -> List[str]:
    e = np.asarray(edges, float)

    def fmt(v):
        return f"{v:.{precision}f}".rstrip("0").rstrip(".")

    return [f"{fmt(e[i])}-{fmt(e[i + 1])}" for i in range(len(e) - 1)]


def stratified_split(labels, test_size: float = 0.2, rng_seed: int = 42):
    """Per-class stratified split keeping ≥1 train sample per class
    (seed 42)."""
    labels = np.asarray(labels)
    rng = random.Random(rng_seed)
    train_idx: List[int] = []
    test_idx: List[int] = []
    for c in np.unique(labels).tolist():
        idxs = np.nonzero(labels == c)[0].tolist()
        rng.shuffle(idxs)
        n = len(idxs)
        if n <= 1:
            test_idx.extend(idxs)
            continue
        n_test = max(1, int(round(n * test_size)))
        n_test = min(n_test, n - 1)
        test_idx.extend(idxs[:n_test])
        train_idx.extend(idxs[n_test:])
    return train_idx, test_idx


# -------------------------
# Linear classifier probe (JAX probe_utils.py:161-233)
# -------------------------

def _ce(W, b, X, y) -> torch.Tensor:
    logp = torch.log_softmax(X @ W + b, dim=1)
    return -logp.gather(1, y[:, None]).mean()


def default_probe_init(D: int, n_classes: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """U(−1/√D, 1/√D) weights and bias (torch ``nn.Linear``'s default
    range, as in JAX probe_utils.py:193-197), drawn on the CPU from a
    generator seeded 0."""
    lim = 1.0 / math.sqrt(max(1, D))
    g = torch.Generator().manual_seed(0)
    W0 = (torch.rand((D, n_classes), generator=g) * 2.0 - 1.0) * lim
    b0 = (torch.rand((n_classes,), generator=g) * 2.0 - 1.0) * lim
    return W0, b0


def _probe_chunk(state: dict, Xtr, onehot, Xva, yva, bc, *, steps: int,
                 max_steps: int, lr: float, weight_decay: float,
                 patience: int, min_delta: float, b1: float, b2: float,
                 eps: float) -> Tuple[dict, tuple]:
    """``steps`` masked AdamW steps of the probe from ``state`` (W, b,
    their moments, the best (W, b) and loss, the patience counter and the
    step, all on the device): a step runs while ``step < max_steps and
    no_improve < patience``, and once that is false the state is frozen.
    ``bc`` [2, ≥ max_steps] holds the bias corrections 1 − β^t of each
    step, read at the device's step counter. Returns (state, ())."""
    W, b, mW, vW, mb, vb = (state[k] for k in ("W", "b", "mW", "vW", "mb",
                                                "vb"))
    best_W, best_b, best_loss = state["best_W"], state["best_b"], \
        state["best_loss"]
    no_improve, step = state["no_improve"], state["step"]
    zero = torch.zeros_like(no_improve)
    n = Xtr.shape[0]
    # the VJP of log_softmax as autodiff takes it: g − softmax·Σg
    g_out = onehot * (-1.0 / n)
    for _ in range(int(steps)):
        active = (no_improve < patience) & (step < max_steps)
        logp = torch.log_softmax(Xtr @ W + b, dim=1)
        g_logits = g_out - torch.exp(logp) * g_out.sum(dim=1, keepdim=True)
        bc1, bc2 = bc.index_select(1, step.reshape(1)).reshape(2).unbind(0)
        new = []
        for p, m, v, g in ((W, mW, vW, Xtr.T @ g_logits),
                           (b, mb, vb, g_logits.sum(0))):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g ** 2
            p = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                - lr * weight_decay * p
            new.append((p, m, v))
        (W_n, mW_n, vW_n), (b_n, mb_n, vb_n) = new
        v_loss = _ce(W_n, b_n, Xva, yva)
        improved = active & (v_loss < best_loss - min_delta)
        best_loss = torch.where(improved, v_loss, best_loss)
        best_W = torch.where(improved, W_n, best_W)
        best_b = torch.where(improved, b_n, best_b)
        no_improve = torch.where(
            active, torch.where(improved, zero, no_improve + 1), no_improve)
        W, mW, vW = (torch.where(active, a, o) for a, o in
                     ((W_n, W), (mW_n, mW), (vW_n, vW)))
        b, mb, vb = (torch.where(active, a, o) for a, o in
                     ((b_n, b), (mb_n, mb), (vb_n, vb)))
        step = step + 1
    return dict(W=W, b=b, mW=mW, vW=vW, mb=mb, vb=vb, best_W=best_W,
                best_b=best_b, best_loss=best_loss, no_improve=no_improve,
                step=step), ()


def fit_linear_probe(Xtr: torch.Tensor, ytr: torch.Tensor,
                     Xva: torch.Tensor, yva: torch.Tensor, W0: torch.Tensor,
                     b0: torch.Tensor, *, max_steps: int = 1000,
                     lr: float = 1e-2, weight_decay: float = 0.0,
                     patience: int = 20, min_delta: float = 0.0,
                     check_every: int = 25, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best (W, b) by validation loss of the full-batch AdamW probe
    (JAX probe_utils.py:199-228), on the device of ``Xtr``: chunks of
    ``check_every`` steps (``_probe_chunk``; one graph replay each on the
    card, captured once per shape and setting), the loop's condition read
    on the host before each chunk."""
    dev = Xtr.device
    n_classes = W0.shape[1]
    max_steps = int(max_steps)
    chunk = max(1, min(int(check_every), max_steps))
    n_chunks = -(-max_steps // chunk)
    W, b = W0.to(dev).clone(), b0.to(dev).clone()
    state = dict(W=W, b=b, mW=torch.zeros_like(W), vW=torch.zeros_like(W),
                 mb=torch.zeros_like(b), vb=torch.zeros_like(b),
                 best_W=W.clone(), best_b=b.clone(),
                 best_loss=torch.tensor(float("inf"), device=dev),
                 no_improve=torch.zeros((), dtype=torch.int64, device=dev),
                 step=torch.zeros((), dtype=torch.int64, device=dev))
    onehot = torch.nn.functional.one_hot(ytr, n_classes).to(W.dtype)
    # bias corrections in fp32, as JAX takes a float32 power (CPU scalars),
    # one per step of every chunk
    b1_32, b2_32 = (torch.tensor(x, dtype=torch.float32) for x in (b1, b2))
    ts = [torch.tensor(t + 1, dtype=torch.float32)
          for t in range(n_chunks * chunk)]
    bc = torch.stack([torch.stack([1 - b1_32 ** t for t in ts]),
                      torch.stack([1 - b2_32 ** t for t in ts])]
                     ) if ts else torch.ones((2, 1))
    bc = bc.to(dev)
    statics = dict(steps=chunk, max_steps=max_steps, lr=float(lr),
                   weight_decay=float(weight_decay), patience=int(patience),
                   min_delta=float(min_delta), b1=float(b1), b2=float(b2),
                   eps=float(eps))
    for _ in range(n_chunks):
        if not bool(state["no_improve"] < patience):
            break
        state, _ = graphs.update(graphs.SHARED, dev, _probe_chunk, None,
                                 state, Xtr, onehot, Xva, yva, bc,
                                 **statics)
    return state["best_W"].clone(), state["best_b"].clone()


def train_linear_classifier(X_train, y_train, X_val, y_val, device=None,
                            n_classes: int = 5, max_steps: int = 1000,
                            lr: float = 1e-2, weight_decay: float = 0.0,
                            patience: int = 20, min_delta: float = 0.0, *,
                            init: Optional[Tuple] = None,
                            check_every: int = 25):
    """Full-batch linear probe with AdamW + CE + early stopping on val loss
    (JAX probe_utils.py:174-233). Returns (best val accuracy, y_true list,
    y_pred list).

    Runs on the device of ``X_train`` when it is a tensor, else on
    ``device`` (the CPU by default). ``init=(W0, b0)`` gives the initial
    weights [D, n_classes] and bias [n_classes]; by default
    ``default_probe_init``.
    """
    if isinstance(X_train, torch.Tensor):
        dev = X_train.device
    else:
        dev = torch.device(device or "cpu")
    Xtr, Xva = as_tensor(X_train, dev), as_tensor(X_val, dev)
    ytr = torch.as_tensor(to_numpy(y_train), dtype=torch.int64).to(dev)
    yva = torch.as_tensor(to_numpy(y_val), dtype=torch.int64).to(dev)
    W0, b0 = init if init is not None else default_probe_init(
        Xtr.shape[1], n_classes)
    W, b = fit_linear_probe(
        Xtr, ytr, Xva, yva, torch.tensor(np.array(to_numpy(W0), np.float32)),
        torch.tensor(np.array(to_numpy(b0), np.float32)),
        max_steps=max_steps, lr=lr, weight_decay=weight_decay,
        patience=patience, min_delta=min_delta, check_every=check_every)
    preds = to_numpy((Xva @ W + b).argmax(dim=1))
    y_true = to_numpy(yva)
    return float((preds == y_true).mean()), y_true.tolist(), preds.tolist()


# -------------------------
# Confusion matrix + logging (JAX probe_utils.py:240-294)
# -------------------------

def _confusion_counts(y_true, y_pred, n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=int)
    for t, p in zip(y_true, y_pred):
        if 0 <= t < n_classes and 0 <= p < n_classes:
            cm[t, p] += 1
    return cm


def _confusion_frame(cm: np.ndarray, bin_names: List[str]):
    """The confusion counts as JAX's pandas DataFrame (True × Pred)."""
    import pandas as pd
    df = pd.DataFrame(cm, index=bin_names, columns=bin_names)
    df.index.name = "True"
    df.columns.name = "Pred"
    return df


def _save_confusion_csv(cm: np.ndarray, bin_names: List[str], model,
                        metric_name: str, epoch: int) -> str:
    """The CSV pandas writes for JAX's frame: a "True" header column, one
    row per true bin."""
    os.makedirs(model.arch_dir, exist_ok=True)
    path = os.path.join(model.arch_dir,
                        f"probe_{metric_name}_confusion_epoch{epoch}.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["True", *bin_names])
        for name, row in zip(bin_names, cm.tolist()):
            w.writerow([name, *row])
    return path


def _log_confusion_table_wandb(wandb_run, cm: np.ndarray, bin_names,
                               metric_name: str, epoch: int):
    if not wandb_run:
        return
    if has_pandas():
        df = _confusion_frame(cm, bin_names)
        try:
            table = wandb.Table(dataframe=df)
        except Exception:  # a real W&B may refuse the frame
            wandb_run.log({f"probe/{metric_name}/confusion_dict":
                           df.to_dict(), "epoch": epoch})
            return
    else:
        table = wandb.Table(columns=["True", *bin_names],
                            data=[[name, *row] for name, row in
                                  zip(bin_names, cm.tolist())])
    wandb_run.log({f"probe/{metric_name}/confusion_table": table,
                   "epoch": epoch})


def _log_accuracy_wandb(wandb_run, metric_name: str, acc: float, epoch: int):
    if not wandb_run:
        return
    wandb_run.log({f"probe/{metric_name}/acc": acc, "epoch": epoch})


def _log_bin_edges_wandb(wandb_run, metric_name: str, edges, epoch: int):
    if not wandb_run:
        return
    wandb_run.log({f"probe/{metric_name}/bin_edges": np.asarray(edges),
                   "epoch": epoch})


def _prepare_targets(feats: dict, mkey: str, n_bins: int):
    """All probe targets are quantile-binned, including 'labels'
    (JAX probe_utils.py:288-294)."""
    vals = np.asarray(feats[mkey], np.float32)
    y, edges = make_bin_labels(vals, n_bins=n_bins)
    bin_names = _format_bin_names(edges, precision=4)
    return y, n_bins, edges, bin_names


# -------------------------
# Orchestrators (JAX probe_utils.py:301-396)
# -------------------------

def log_probe_summary(wandb_run, summary_rows, epoch: int, summary_key: str,
                      summary_color: str, title: str, diagnostic: str,
                      with_epoch: bool) -> None:
    """The bar chart of the accuracies (JAX probe_utils.py:345-357)."""
    if not summary_rows or not wandb_run:
        return
    plt = pyplot(wandb_run, diagnostic)
    if plt is None:
        return
    labels = [name for name, _ in summary_rows]
    values = [val for _, val in summary_rows]
    fig, ax = plt.subplots(figsize=(max(6, len(labels) * 1.2), 4))
    ax.bar(range(len(labels)), values, color=summary_color)
    ax.set_xticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_ylim(0, 1)
    ax.set_ylabel("Accuracy")
    ax.set_title(title)
    fig.tight_layout()
    payload = {summary_key: wandb.Image(fig)}
    if with_epoch:
        payload["epoch"] = epoch
    wandb_run.log(payload)
    plt.close(fig)


def _run_probes(model, E, feats, epoch, n_bins, test_size, steps, lr,
                rng_seed, patience, min_delta, save_csv, name_fn,
                summary_key, summary_color):
    wandb_run = getattr(model, "wandb_run", None)
    probe_targets = ["cum_area", "convex_hull", "labels"]
    if "density" in feats:
        probe_targets.append("density")

    summary_rows = []
    results = {}
    for mkey in probe_targets:
        y, n_classes, edges, bin_names = _prepare_targets(feats, mkey,
                                                          n_bins=n_bins)
        metric_name = name_fn(mkey)
        train_idx, test_idx = stratified_split(y, test_size=test_size,
                                               rng_seed=rng_seed)
        if len(train_idx) == 0 or len(test_idx) == 0:
            _log_accuracy_wandb(wandb_run,
                                f"{metric_name}/warn_empty_split", 0.0,
                                epoch)
            continue
        tr = torch.as_tensor(train_idx, device=E.device)
        te = torch.as_tensor(test_idx, device=E.device)
        acc, y_true, y_pred = train_linear_classifier(
            E[tr], y[train_idx], E[te], y[test_idx], n_classes=n_classes,
            max_steps=steps, lr=lr, weight_decay=0.0, patience=patience,
            min_delta=min_delta)

        summary_rows.append((metric_name, acc))
        results[metric_name] = acc
        cm = _confusion_counts(y_true, y_pred, n_classes)
        _log_accuracy_wandb(wandb_run, metric_name, acc, epoch)
        _log_confusion_table_wandb(wandb_run, cm, bin_names, metric_name,
                                   epoch)
        _log_bin_edges_wandb(wandb_run, metric_name, edges, epoch)
        if save_csv:
            csv_path = _save_confusion_csv(
                cm, bin_names, model, metric_name.replace("/", "_"), epoch)
            if wandb_run:
                wandb_run.log({f"probe/{metric_name}/confusion_csv_path":
                               csv_path, "epoch": epoch})

    log_probe_summary(wandb_run, summary_rows, epoch, summary_key,
                      summary_color, f"Linear probe summary @ epoch {epoch}",
                      summary_key.replace("/", "_"), with_epoch=False)
    return results


def log_linear_probe(model, epoch: int, n_bins: int = 5,
                     test_size: float = 0.2, steps: int = 1000,
                     lr: float = 1e-2, rng_seed: int = 42,
                     patience: int = 20, min_delta: float = 0.0,
                     save_csv: bool = True, upto_layer: Optional[int] = None,
                     layer_tag: Optional[str] = None):
    """Probe cum_area/convex_hull/labels (+density) from layer embeddings;
    logs ``probe/<name>/acc``, confusion tables, bin edges, CSV
    (JAX probe_utils.py:361-377). Returns {metric_name: acc}."""
    E, feats = compute_val_embeddings_and_features(model,
                                                   upto_layer=upto_layer)
    return _run_probes(
        model, E, feats, epoch, n_bins, test_size, steps, lr, rng_seed,
        patience, min_delta, save_csv,
        name_fn=lambda mkey: f"{layer_tag}/{mkey}" if layer_tag else mkey,
        summary_key=f"probe/{layer_tag or 'top'}/summary",
        summary_color="steelblue")


def log_joint_linear_probe(model, epoch: int, n_bins: int = 5,
                           test_size: float = 0.2, steps: int = 1000,
                           lr: float = 1e-2, rng_seed: int = 42,
                           patience: int = 20, min_delta: float = 0.0,
                           save_csv: bool = False,
                           metric_prefix: str = "joint"):
    """Linear probe on joint embeddings (JAX probe_utils.py:380-396)."""
    E, feats = compute_joint_embeddings_and_features(model)
    if E.numel() == 0:
        return {}
    return _run_probes(
        model, E, feats, epoch, n_bins, test_size, steps, lr, rng_seed,
        patience, min_delta, save_csv,
        name_fn=lambda mkey: (f"{metric_prefix}/{mkey}" if metric_prefix
                              else mkey),
        summary_key=f"probe/{metric_prefix or 'joint'}/summary",
        summary_color="indianred")
