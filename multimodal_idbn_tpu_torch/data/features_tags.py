"""A synthetic image-feature and tag dataset for the multimodal DBN of
Srivastava & Salakhutdinov (JMLR 15, 2014), in the shape of MIR-Flickr's:
real-valued image features for a Gaussian visible layer and word counts
over a tag vocabulary for a replicated-softmax one.

A row's class c of K is drawn uniformly. Its features are the class's
centre, N(0, 1) per dimension, plus N(0, 1) noise, standardised per
dimension over the whole set (as the paper standardises its features).
Its tags are D words, D uniform in 1 .. ``max_words``, each drawn from the
class's word distribution, a softmax of N(0, 2²) logits over the
vocabulary. Deterministic in ``seed``; NumPy only."""

from __future__ import annotations

from typing import Dict

import numpy as np


def generate_feature_tag_dataset(n_samples: int, n_features: int,
                                 vocab: int, num_classes: int, seed: int = 0,
                                 max_words: int = 10
                                 ) -> Dict[str, np.ndarray]:
    """{"images": features [n, n_features], "tags": counts [n, vocab],
    "labels", "onehot", "cumArea", "CH"}, float32; ``labels`` the class
    index, ``cumArea`` each row's words and ``CH`` the same, standing in
    for the numerosity sets' geometry so that the loaders' metadata
    protocol holds."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, num_classes, n_samples)
    centres = rng.standard_normal((num_classes, n_features))
    x = centres[cls] + rng.standard_normal((n_samples, n_features))
    x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-6)
    logits = 2.0 * rng.standard_normal((num_classes, vocab))
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    words = rng.integers(1, max_words + 1, n_samples)
    tags = np.zeros((n_samples, vocab), np.float32)
    for r in range(n_samples):
        tags[r] = rng.multinomial(int(words[r]), probs[cls[r]])
    onehot = np.eye(num_classes, dtype=np.float32)[cls]
    return {"images": x.astype(np.float32), "tags": tags,
            "labels": cls.astype(np.float32), "onehot": onehot,
            "cumArea": words.astype(np.float32),
            "CH": words.astype(np.float32)}
