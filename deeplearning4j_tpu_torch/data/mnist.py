"""MNIST-shaped dataset.

A copy of ``deeplearning4j_tpu/data/mnist.py`` for the PyTorch port: host
numpy code, which the port keeps as the reference has it (the port imports
nothing of the JAX package).

Reference: org.deeplearning4j.datasets.iterator.impl.MnistDataSetIterator
(the LeNet-MNIST benchmark input, BASELINE.json:7). This environment has no
network access (SURVEY.md §7 env facts), so real MNIST cannot be downloaded;
this module produces a DETERMINISTIC PROCEDURAL dataset at MNIST shape
(28x28 grayscale, 10 classes): seven-segment-style digit glyphs rasterized
with per-example random translation, scaling, stroke noise and background
noise. It is learnable (a LeNet reaches >97% quickly) and serves as the
documented stand-in for throughput benchmarks — provenance is recorded by
``PROVENANCE`` below, per BASELINE.md measurement notes.

If a real ``mnist.npz`` (keras layout) is placed at ``~/.dl4j_tpu/mnist.npz``
it is used instead.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .dataset import DataSet
from .iterators import DataSetIterator, ListDataSetIterator

PROVENANCE = "procedural-7seg-v1 (synthetic; no-network environment)"

# seven-segment layout:  segments (top, top-left, top-right, middle,
# bottom-left, bottom-right, bottom)
_SEGMENTS = {
    0: (1, 1, 1, 0, 1, 1, 1),
    1: (0, 0, 1, 0, 0, 1, 0),
    2: (1, 0, 1, 1, 1, 0, 1),
    3: (1, 0, 1, 1, 0, 1, 1),
    4: (0, 1, 1, 1, 0, 1, 0),
    5: (1, 1, 0, 1, 0, 1, 1),
    6: (1, 1, 0, 1, 1, 1, 1),
    7: (1, 0, 1, 0, 0, 1, 0),
    8: (1, 1, 1, 1, 1, 1, 1),
    9: (1, 1, 1, 1, 0, 1, 1),
}


def _render_digit(digit: int, rng: np.random.Generator) -> np.ndarray:
    """Rasterize one 28x28 glyph with random geometry."""
    img = np.zeros((28, 28), dtype=np.float32)
    # glyph box with random position/size
    h = rng.integers(16, 22)
    w = rng.integers(8, 13)
    top = rng.integers(2, 28 - h - 1)
    left = rng.integers(2, 28 - w - 1)
    t = rng.integers(2, 4)  # stroke thickness
    mid = top + h // 2
    seg = _SEGMENTS[digit]
    if seg[0]:
        img[top : top + t, left : left + w] = 1.0
    if seg[1]:
        img[top : mid, left : left + t] = 1.0
    if seg[2]:
        img[top : mid, left + w - t : left + w] = 1.0
    if seg[3]:
        img[mid : mid + t, left : left + w] = 1.0
    if seg[4]:
        img[mid : top + h, left : left + t] = 1.0
    if seg[5]:
        img[mid : top + h, left + w - t : left + w] = 1.0
    if seg[6]:
        img[top + h - t : top + h, left : left + w] = 1.0
    # stroke intensity variation + blur-ish noise
    img *= rng.uniform(0.6, 1.0)
    img += rng.normal(0, 0.08, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _generate(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    images = np.stack([_render_digit(int(d), rng) for d in labels])
    return images.reshape(n, 784).astype(np.float32), labels.astype(np.int64)


def _load_real() -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    path = os.path.expanduser("~/.dl4j_tpu/mnist.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return (
        z["x_train"].reshape(-1, 784).astype(np.float32) / 255.0,
        z["y_train"].astype(np.int64),
        z["x_test"].reshape(-1, 784).astype(np.float32) / 255.0,
        z["y_test"].astype(np.int64),
    )


class MnistDataSetIterator(ListDataSetIterator):
    """Reference-shaped constructor: MnistDataSetIterator(batch, train[, seed]).
    Features [n, 784] in [0,1]; labels one-hot [n, 10]."""

    def __init__(
        self,
        batch: int,
        train: bool = True,
        seed: int = 123,
        num_examples: Optional[int] = None,
        shuffle: bool = True,
    ) -> None:
        real = _load_real()
        if real is not None:
            xtr, ytr, xte, yte = real
            x, y = (xtr, ytr) if train else (xte, yte)
            self.provenance = "mnist.npz (real)"
        else:
            n = num_examples or (12800 if train else 2048)
            x, y = _generate(n, seed if train else seed + 999)
            self.provenance = PROVENANCE
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        labels = np.eye(10, dtype=np.float32)[y]
        super().__init__(DataSet(x, labels), batch, shuffle=shuffle, seed=seed)
