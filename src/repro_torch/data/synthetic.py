"""Offline synthetic datasets shaped like the paper's benchmarks.

A numpy copy of ``repro.data.synthetic``: F-MNIST / CIFAR-10 / KWS are
generated as class-template + structured-noise images with the exact input
shapes and class counts of the real datasets, and Zipfian token streams
stand in for text.  For the same seed every array is bit-identical to the
reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.configs.paper_models import CNNConfig


class Dataset(NamedTuple):
    x: np.ndarray       # (N, H, W, C) float32
    y: np.ndarray       # (N,) int64
    n_classes: int
    name: str


def make_classification(cfg: CNNConfig, n_train: int = 4000, n_test: int = 1000,
                        seed: int = 0, noise: float = 0.35):
    """(train, test) with class-template structure at cfg.input_shape."""
    rng = np.random.default_rng(seed)
    h, w, c = cfg.input_shape
    n_cls = cfg.num_classes
    # smooth class templates: random low-frequency patterns
    freq = rng.normal(size=(n_cls, 4, 4, c))
    templates = np.stack([
        _upsample(freq[k], h, w) for k in range(n_cls)
    ])  # (n_cls, h, w, c)

    def sample(n):
        ys = rng.integers(0, n_cls, size=n)
        xs = templates[ys] + noise * rng.normal(size=(n, h, w, c))
        return xs.astype(np.float32), ys.astype(np.int64)

    xtr, ytr = sample(n_train)
    xte, yte = sample(n_test)
    return (
        Dataset(xtr, ytr, n_cls, cfg.dataset),
        Dataset(xte, yte, n_cls, cfg.dataset),
    )


def _upsample(small: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear-ish upsample of a (4,4,C) pattern to (h,w,C)."""
    sh, sw, c = small.shape
    yi = np.linspace(0, sh - 1, h)
    xi = np.linspace(0, sw - 1, w)
    y0 = np.floor(yi).astype(int)
    y1 = np.minimum(y0 + 1, sh - 1)
    x0 = np.floor(xi).astype(int)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = (yi - y0)[:, None, None]
    wx = (xi - x0)[None, :, None]
    a = small[y0][:, x0]
    b = small[y0][:, x1]
    cgrid = small[y1][:, x0]
    d = small[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + cgrid * wy * (1 - wx) + d * wy * wx)


def zipf_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Zipfian token streams for LM smoke training and serving."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return rng.choice(vocab, size=(n_seqs, seq_len), p=probs).astype(np.int32)
