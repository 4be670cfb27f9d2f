"""Inputs of a run, made on the device from ``--seed``: the dataset and
the initial weights that the program and the reference both receive.

The dataset follows the law of the shipped synthetic numerosity generator
(a class c of K is an image of c + 1 discs of radius 2-6 at uniform
centres on a ``side`` × ``side`` canvas), drawn in a few tensor calls on
the device instead of one Python loop per disc; unlike the shipped
generator, discs may overlap (``assumed`` in the configuration files).
The bimodal second modality stands in for the MNIST-100 renders: one
binary template per class, each pixel of a row flipped with probability
0.05. Weights are ``N(0, 1) / sqrt(V)`` as the port's RBMs draw them,
biases and momentum zero."""

from __future__ import annotations

from typing import Dict, List

import torch

M63 = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use of the seed (``stream``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + stream) & M63)
    return gen


def n_train(cfg: dict) -> int:
    """Rows of the training split: what the shipped 70/15/15 split keeps
    of ``n_samples``."""
    n = int(cfg["dataset"]["n_samples"])
    return n - 2 * int(0.15 * n)


def dot_images(seed: int, n: int, side: int, num_classes: int, device,
               r_min: int = 2, r_max: int = 6):
    """(images [n, side²] float32 in {0, 1}, class ids [n] int64)."""
    gen = generator(seed, 1, device)
    cls = torch.randint(0, num_classes, (n,), generator=gen, device=device)
    slots = num_classes
    r = torch.randint(r_min, r_max + 1, (n, slots), generator=gen,
                      device=device).float()
    cx = r + torch.rand((n, slots), generator=gen, device=device) * (
        side - 2 * r)
    cy = r + torch.rand((n, slots), generator=gen, device=device) * (
        side - 2 * r)
    cx, cy = cx.floor(), cy.floor()
    active = torch.arange(slots, device=device)[None, :] <= cls[:, None]
    yy, xx = torch.meshgrid(torch.arange(side, device=device).float(),
                            torch.arange(side, device=device).float(),
                            indexing="ij")
    yy, xx = yy.reshape(1, -1), xx.reshape(1, -1)
    img = torch.zeros((n, side * side), device=device, dtype=torch.bool)
    for s in range(slots):
        inside = ((yy - cy[:, s:s + 1]) ** 2 + (xx - cx[:, s:s + 1]) ** 2
                  <= r[:, s:s + 1] ** 2)
        img |= inside & active[:, s:s + 1]
    return img.float(), cls


def second_modality(seed: int, cls: torch.Tensor, width: int,
                    num_classes: int, device, density: float = 0.2,
                    flip: float = 0.05) -> torch.Tensor:
    """[n, width] binary rows: the class template with noise."""
    gen = generator(seed, 2, device)
    templates = (torch.rand((num_classes, width), generator=gen,
                            device=device) < density)
    noise = torch.rand((cls.shape[0], width), generator=gen,
                       device=device) < flip
    return (templates[cls] ^ noise).float()


def rbm_weights(seed: int, sizes: List[int], device, stream: int = 10
                ) -> List[Dict[str, torch.Tensor]]:
    """One state per layer of a stack of ``sizes``: w, hb, vb and their
    momentum buffers."""
    gen = generator(seed, stream, device)
    out = []
    for v, h in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((v, h), generator=gen, device=device) / (
            max(1, v) ** 0.5)
        out.append(dict(w=w, hb=torch.zeros(h, device=device),
                        vb=torch.zeros(v, device=device),
                        w_m=torch.zeros_like(w),
                        hb_m=torch.zeros(h, device=device),
                        vb_m=torch.zeros(v, device=device)))
    return out
