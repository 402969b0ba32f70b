"""Procedural data: the port's own copies of
``repro/data/synthetic.py``'s ``make_classification_data`` (images) and
``make_lm_data`` (a Markov token stream).

CIFAR is not available offline; each class has a fixed low-frequency
template and samples are random shifts, per-sample gains and Gaussian
noise. Numpy only, so both packages draw bit-identical data from one
seed (tests/test_torch_data.py).
"""
from __future__ import annotations

import numpy as np


def _class_templates(rng, num_classes, size, ch):
    """Smooth per-class templates: sum of a few random 2-D cosines."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32) / size
    t = np.zeros((num_classes, size, size, ch), np.float32)
    for c in range(num_classes):
        for _ in range(4):
            fx, fy = rng.integers(1, 5, 2)
            phase = rng.uniform(0, 2 * np.pi, ch)
            amp = rng.uniform(0.5, 1.0, ch)
            for k in range(ch):
                t[c, :, :, k] += amp[k] * np.cos(
                    2 * np.pi * (fx * xs + fy * ys) + phase[k])
    t /= np.abs(t).max(axis=(1, 2, 3), keepdims=True)
    return t


def make_classification_data(seed: int, *, num_classes=10, size=32, ch=3,
                             train_per_class=512, test_per_class=128,
                             noise=0.35):
    """Returns dict(train=(x,y), test=(x,y)) with x in [-1, 1], NHWC."""
    rng = np.random.default_rng(seed)
    templates = _class_templates(rng, num_classes, size, ch)

    def sample(n_per_class):
        xs, ys = [], []
        for c in range(num_classes):
            shifts = rng.integers(-size // 8, size // 8 + 1, (n_per_class, 2))
            gains = rng.uniform(0.7, 1.3, (n_per_class, 1, 1, 1)).astype(np.float32)
            base = np.stack([np.roll(templates[c], tuple(s), axis=(0, 1))
                             for s in shifts])
            x = base * gains + noise * rng.standard_normal(
                base.shape).astype(np.float32)
            xs.append(np.clip(x, -1, 1))
            ys.append(np.full((n_per_class,), c, np.int32))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        perm = rng.permutation(len(y))
        return x[perm].astype(np.float32), y[perm]

    return {"train": sample(train_per_class), "test": sample(test_per_class)}


def make_lm_data(seed: int, *, vocab=512, n_tokens=200_000, order_bias=0.9):
    """Markov token stream: each token strongly predicts a successor band
    (learnable structure for LM smoke training). int32 (n_tokens,)."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, vocab)
    toks = np.empty((n_tokens,), np.int32)
    toks[0] = rng.integers(vocab)
    jumps = rng.random(n_tokens) > order_bias
    rand = rng.integers(0, vocab, n_tokens)
    for i in range(1, n_tokens):
        toks[i] = rand[i] if jumps[i] else (succ[toks[i - 1]] + i % 3) % vocab
    return toks
