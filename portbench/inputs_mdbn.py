"""Inputs of the multimodal DBN's cells, made on the device from
``--seed``: image features and tag counts of the training split, standing
in for MIR-Flickr's (``assumed`` in ``configs/mdbn-flickr.json``).

A row's class c of K is drawn uniformly. Its image features are the class's
centre, N(0, 1) per dimension, plus N(0, 1) noise, standardised per
dimension over the split (the paper standardises its features). Its tags
are D words, D uniform in 1 .. ``max_words``, each drawn from the class's
word distribution: a softmax over the vocabulary of N(0, 2²) logits, so a
class favours a few dozen words."""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.inputs import generator


def features_and_tags(seed: int, n: int, n_features: int, vocab: int,
                      num_classes: int, device, max_words: int = 10
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features [n, n_features] float32, standardised; tag counts
    [n, vocab] float32, each row summing to its D)."""
    gen = generator(seed, 3, device)
    cls = torch.randint(0, num_classes, (n,), generator=gen, device=device)
    centres = torch.randn((num_classes, n_features), generator=gen,
                          device=device)
    x = centres[cls] + torch.randn((n, n_features), generator=gen,
                                   device=device)
    x = (x - x.mean(0)) / x.std(0).clamp_min(1e-6)
    logits = 2.0 * torch.randn((num_classes, vocab), generator=gen,
                               device=device)
    probs = torch.softmax(logits, dim=1)[cls]
    words = torch.randint(1, max_words + 1, (n,), generator=gen,
                          device=device)
    picks = torch.multinomial(probs, max_words, replacement=True,
                              generator=gen)
    take = (torch.arange(max_words, device=device)[None, :]
            < words[:, None]).float()
    tags = torch.zeros((n, vocab), device=device).scatter_add_(1, picks,
                                                               take)
    return x.float().contiguous(), tags.contiguous()
