"""CIFAR-10 / EMNIST-shaped dataset fetchers.

A copy of ``deeplearning4j_tpu/data/fetchers.py`` for the PyTorch port: host
numpy code, which the port keeps as the reference has it (the port imports
nothing of the JAX package).

Reference: org.deeplearning4j.datasets.iterator.impl.{Cifar10DataSetIterator,
EmnistDataSetIterator} and the datasets-fetchers family (SURVEY.md §2.2
"Dataset fetchers"). No network exists in this environment (SURVEY.md §7),
so — like data/mnist.py — these produce DETERMINISTIC PROCEDURAL datasets at
the real datasets' exact shapes, learnable and suitable for shape-true
pipeline/throughput work, with provenance recorded. Real data dropped at
``~/.dl4j_tpu/cifar10.npz`` / ``~/.dl4j_tpu/emnist-<split>.npz`` (keras npz
layout) is used instead when present.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .dataset import DataSet
from .iterators import ListDataSetIterator

CIFAR_PROVENANCE = "procedural-cifar10-v1 (synthetic; no-network environment)"
EMNIST_PROVENANCE = "procedural-emnist-v1 (synthetic; no-network environment)"

# EMNIST split -> class count (reference: EmnistDataSetIterator.Set)
EMNIST_SPLITS = {"mnist": 10, "digits": 10, "letters": 26, "balanced": 47,
                 "byclass": 62, "bymerge": 47}


def _cifar_example(cls: int, rng: np.random.Generator) -> np.ndarray:
    """One 3x32x32 image: class-keyed hue + oriented texture + a class
    shape, noised — separable but not trivial."""
    base = np.zeros((3, 32, 32), np.float32)
    hue = np.asarray([((cls * 3 + c) % 10) / 10.0 for c in range(3)],
                     np.float32)
    base += hue[:, None, None] * rng.uniform(0.4, 0.8)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    angle = cls * np.pi / 10.0
    wave = np.sin((xx * np.cos(angle) + yy * np.sin(angle)) *
                  (0.3 + 0.05 * cls) + rng.uniform(0, 6.28))
    base += 0.2 * wave[None]
    cy, cx = rng.integers(8, 24), rng.integers(8, 24)
    r = 4 + (cls % 5)
    m = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
    base[cls % 3, m] = rng.uniform(0.7, 1.0)
    base += rng.normal(0, 0.08, base.shape).astype(np.float32)
    return np.clip(base, 0.0, 1.0)


def _emnist_glyph(cls: int, n_classes: int,
                  rng: np.random.Generator) -> np.ndarray:
    """28x28 glyph: a fixed per-class 7x5 bitmap (class-seeded, so every
    class has one stable shape) placed with random geometry + noise."""
    pattern_rng = np.random.default_rng(10_000 + cls)  # class-stable glyph
    bitmap = (pattern_rng.random((7, 5)) > 0.5).astype(np.float32)
    bitmap[0, :] = 1.0  # guarantee some ink
    scale = rng.integers(2, 4)
    glyph = np.kron(bitmap, np.ones((scale, scale), np.float32))
    gh, gw = glyph.shape
    img = np.zeros((28, 28), np.float32)
    top = rng.integers(0, 28 - gh + 1)
    left = rng.integers(0, 28 - gw + 1)
    img[top: top + gh, left: left + gw] = glyph * rng.uniform(0.6, 1.0)
    img += rng.normal(0, 0.08, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _load_npz(path: str, flatten: Optional[int], train: bool):
    path = os.path.expanduser(path)
    if not os.path.exists(path):
        return None
    z = np.load(path)
    x = z["x_train" if train else "x_test"].astype(np.float32) / 255.0
    y = z["y_train" if train else "y_test"].astype(np.int64)
    if flatten:
        x = x.reshape(len(x), flatten)
    return x, y


# Cifar10DataSetIterator is defined below as a subclass of the shared
# _ProceduralImageIterator (same npz-override/procedural skeleton as SVHN
# and TinyImageNet).


class EmnistDataSetIterator(ListDataSetIterator):
    """Reference-shaped: EmnistDataSetIterator(split, batch[, train]).
    Features [n, 784] in [0, 1]; labels one-hot over the split's classes."""

    def __init__(self, split: str, batch: int, train: bool = True,
                 seed: int = 123, num_examples: Optional[int] = None,
                 shuffle: bool = True,
                 shard: Optional[Tuple[int, int]] = None) -> None:
        if split not in EMNIST_SPLITS:
            raise ValueError(
                f"unknown EMNIST split {split!r}; one of {sorted(EMNIST_SPLITS)}")
        k = EMNIST_SPLITS[split]
        real = _load_npz(f"~/.dl4j_tpu/emnist-{split}.npz", 784, train)
        if real is not None:
            x, y = real
            self.provenance = f"emnist-{split}.npz (real)"
        else:
            n = num_examples or (8192 if train else 1024)
            rng = np.random.default_rng(seed if train else seed + 999)
            y = rng.integers(0, k, size=n)
            x = np.stack([_emnist_glyph(int(c), k, rng) for c in y])
            x = x.reshape(n, 784)
            self.provenance = EMNIST_PROVENANCE
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        x, y = _apply_shard(x, y, shard)
        labels = np.eye(k, dtype=np.float32)[y]
        self.num_classes = k
        super().__init__(DataSet(x, labels), batch, shuffle=shuffle, seed=seed)


def _apply_shard(x, y, shard: Optional[Tuple[int, int]]):
    """Per-host rows for multi-process training (sharded loading,
    data/sharded.py): host ``i`` of ``count`` keeps every count-th
    example — sizes within 1, every example on exactly one host, and
    ``(0, 1)`` is the identity."""
    if shard is None:
        return x, y
    index, count = shard
    if count < 1 or not 0 <= index < count:
        raise ValueError(f"invalid shard {shard!r}; want (index, count)")
    return x[index::count], y[index::count]
SVHN_PROVENANCE = "procedural-svhn-v1 (synthetic; no-network environment)"
TINYIMAGENET_PROVENANCE = \
    "procedural-tinyimagenet-v1 (synthetic; no-network environment)"


def _class_image(cls: int, n_classes: int, rng: np.random.Generator,
                 size: int, channels: int) -> np.ndarray:
    """Class-conditioned procedural image, learnable at any class count:
    class identity is factored into stripe orientation (cls mod 10) and a
    strong localized blob whose grid position encodes cls // 10 — every
    class pair differs in at least one high-amplitude factor."""
    img = rng.normal(0.45, 0.08, (size, size, channels)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    ang = 2 * np.pi * (cls % 10) / 10.0
    stripe = 0.5 + 0.5 * np.sin(
        8 * np.pi * (xx * np.cos(ang) + yy * np.sin(ang)) + cls)
    block = cls // 10  # blob grid position encodes the coarse class
    grid = max(int(np.ceil(np.sqrt(max(n_classes // 10, 1)))), 1)
    cy = 0.15 + 0.7 * (block % grid) / max(grid - 1, 1) if grid > 1 else 0.5
    cx = 0.15 + 0.7 * (block // grid) / max(grid - 1, 1) if grid > 1 else 0.5
    blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 0.01))
    for c in range(channels):
        w = 0.5 + 0.5 * np.cos(ang + c)
        img[:, :, c] += 0.35 * w * stripe + 0.5 * blob
    return np.clip(img, 0.0, 1.0).transpose(2, 0, 1)  # NCHW


class _ProceduralImageIterator(ListDataSetIterator):
    """Shared loader for image datasets with an npz-real-data override and
    a class-conditioned procedural fallback (the Cifar10 recipe)."""

    def __init__(self, npz_name: str, num_classes: int, size: int,
                 provenance: str, default_train: int, default_eval: int,
                 batch: int, train: bool, seed: int,
                 num_examples: Optional[int], shuffle: bool,
                 make_example=None,
                 shard: Optional[Tuple[int, int]] = None) -> None:
        real = _load_npz(f"~/.dl4j_tpu/{npz_name}", None, train)
        if real is not None:
            x, y = real
            if x.ndim == 4 and x.shape[-1] == 3:  # NHWC npz -> NCHW
                x = x.transpose(0, 3, 1, 2)
            self.provenance = f"{npz_name} (real)"
        else:
            gen = make_example or (
                lambda c, rng: _class_image(c, num_classes, rng, size, 3))
            n = num_examples or (default_train if train else default_eval)
            rng = np.random.default_rng(seed if train else seed + 999)
            y = rng.integers(0, num_classes, size=n)
            x = np.stack([gen(int(c), rng) for c in y])
            self.provenance = provenance
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        x, y = _apply_shard(x, y, shard)
        labels = np.eye(num_classes, dtype=np.float32)[y]
        super().__init__(DataSet(x, labels), batch, shuffle=shuffle,
                         seed=seed)


class Cifar10DataSetIterator(_ProceduralImageIterator):
    """Reference-shaped: Cifar10DataSetIterator(batch[, train, seed]).
    Features [n, 3, 32, 32] (NCHW) in [0, 1]; labels one-hot [n, 10]."""

    NUM_CLASSES = 10

    def __init__(self, batch: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None,
                 shuffle: bool = True,
                 shard: Optional[Tuple[int, int]] = None) -> None:
        super().__init__("cifar10.npz", 10, 32, CIFAR_PROVENANCE, 8192, 1024,
                         batch, train, seed, num_examples, shuffle,
                         make_example=_cifar_example, shard=shard)


class SvhnDataSetIterator(_ProceduralImageIterator):
    """Reference-shaped: SvhnDataSetIterator(batch[, train]) — Street View
    House Numbers. Features [n, 3, 32, 32] NCHW in [0, 1]; labels one-hot
    [n, 10]. Real data at ``~/.dl4j_tpu/svhn.npz`` is preferred."""

    NUM_CLASSES = 10

    def __init__(self, batch: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None,
                 shuffle: bool = True,
                 shard: Optional[Tuple[int, int]] = None) -> None:
        super().__init__("svhn.npz", 10, 32, SVHN_PROVENANCE, 8192, 1024,
                         batch, train, seed, num_examples, shuffle,
                         shard=shard)


class TinyImageNetDataSetIterator(_ProceduralImageIterator):
    """Reference-shaped: TinyImageNetDataSetIterator(batch[, train]) —
    200 classes at [3, 64, 64] NCHW. Real data at
    ``~/.dl4j_tpu/tinyimagenet.npz`` is preferred."""

    NUM_CLASSES = 200

    def __init__(self, batch: int, train: bool = True, seed: int = 123,
                 num_examples: Optional[int] = None,
                 shuffle: bool = True,
                 shard: Optional[Tuple[int, int]] = None) -> None:
        super().__init__("tinyimagenet.npz", 200, 64,
                         TINYIMAGENET_PROVENANCE, 4096, 512,
                         batch, train, seed, num_examples, shuffle,
                         shard=shard)
