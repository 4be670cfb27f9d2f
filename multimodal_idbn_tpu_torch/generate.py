"""Generate images from class labels with a trained iMDBN.

Port of scripts/generate.py:30-120. It loads a ``save_model`` pickle,
rebuilds the model (``iMDBN.load_model`` + ``from_payload``) and draws
images from p(img | y) with ``sample_txt2img``, or decodes the
conditional mean with ``txt2img`` under ``--mean`` (one chain-kernel
launch on the card). Run it as

    python -m multimodal_idbn_tpu_torch.generate --model model.pkl \
        --labels 3 7 12 --n-per-label 4 --seed 0 --out draws.npz \
        [--mean] [--gibbs-steps N] [--png draws.png] [--device cpu]

It runs on ``cuda`` unless ``--device cpu`` is given (the JAX script's
``--cpu``), and raises without a GPU. ``--matmul-precision`` sets the
precision of the plain torch products as the JAX script's does
(``device.set_matmul_precision``). Output: an npz with ``images
[N, D]`` (pixel probabilities) and ``labels [N]``; optionally a PNG grid.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from multimodal_idbn_tpu_torch.device import (resolve_device,
                                              set_matmul_precision)
from multimodal_idbn_tpu_torch.models import iMDBN


def positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError("must be >= 1")
    return n


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        "Draw images from p(img | label) with a trained iMDBN "
        "(PyTorch/CUDA port)")
    ap.add_argument("--model", required=True,
                    help="path to a save_model pickle")
    ap.add_argument("--labels", type=int, nargs="+", required=True,
                    help="class ids to condition on")
    ap.add_argument("--n-per-label", type=positive_int, default=1)
    ap.add_argument("--gibbs-steps", type=int, default=None,
                    help="chain length (default: the model's "
                         "CROSS_GIBBS_STEPS)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mean", action="store_true",
                    help="use the reference-semantics mean decoder "
                         "(txt2img) instead of sampling")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="generated.npz")
    ap.add_argument("--png", default=None,
                    help="also save a PNG grid (needs matplotlib and a "
                         "square image size)")
    ap.add_argument("--matmul-precision", default="highest",
                    choices=["default", "high", "highest"],
                    help="fp32 matmul precision of the plain torch products "
                         "(device.set_matmul_precision: 'high' is TF32; "
                         "'highest' matches training)")
    return ap.parse_args(argv)


def save_png(imgs: np.ndarray, ids: np.ndarray, path: str) -> None:
    side = int(round(imgs.shape[1] ** 0.5))
    if side * side != imgs.shape[1]:
        print(f"[generate] skipping PNG: image dim {imgs.shape[1]} is not "
              f"square")
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = imgs.shape[0]
    cols = min(8, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(1.6 * cols, 1.6 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            ax.imshow(imgs[i].reshape(side, side), cmap="gray_r", vmin=0,
                      vmax=1)
            ax.set_title(str(ids[i]), fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"[generate] grid -> {path}")


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Generate, write ``--out`` and return the images [N, D]."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_matmul_precision(args.matmul_precision)
    model = iMDBN.from_payload(iMDBN.load_model(args.model, device=device))

    ids = np.repeat(np.asarray(args.labels, np.int64), args.n_per_label)
    if args.mean:
        # --gibbs-steps and --seed hold on the mean path too: txt2img
        # draws its chain key from the joint RBM's stream and reads
        # cross_steps (scripts/generate.py:78-86).
        if args.gibbs_steps is not None:
            model.cross_steps = int(args.gibbs_steps)
        model.joint_rbm.reseed(args.seed)
        imgs = model.txt2img(ids)
    else:
        imgs = model.sample_txt2img(ids, gibbs_steps=args.gibbs_steps,
                                    seed=args.seed)
    imgs = imgs.detach().cpu().numpy()
    np.savez(args.out, images=imgs, labels=ids)
    print(f"[generate] {imgs.shape[0]} images "
          f"({'mean decode' if args.mean else 'sampled'}) -> {args.out} "
          f"(pixel mean {imgs.mean():.4f})")
    if args.png:
        save_png(imgs, ids, args.png)
    return imgs


if __name__ == "__main__":
    main()
