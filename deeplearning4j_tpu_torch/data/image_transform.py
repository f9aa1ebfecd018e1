"""Image augmentation transforms.

Port of ``deeplearning4j_tpu/data/image_transform.py``: the per-image transforms are its
numpy code, copied; the batched flip and crop are device functions on torch
tensors (see the end of the module).

Reference: datavec-data-image's ImageTransform hierarchy (FlipImageTransform,
CropImageTransform, RandomCropTransform, RotateImageTransform,
ResizeImageTransform, PipelineImageTransform — SURVEY.md §2.2 "DataVec
image", "the ImageNet input path"). Host-side numpy/PIL on [h, w, c] float32
arrays, composable via PipelineImageTransform, pluggable into
ImageRecordReader(transform=...).

The heavy lifting (normalize, random flip/crop at batch granularity) can also
run ON DEVICE via ``batch_random_flip`` / ``batch_random_crop`` — batched
augmentation on the card is the right answer when the host is a few slow
cores and the card is idle between steps (the reference leans on OpenCV +
host thread pools instead). Each is a draw (``draw_flips`` /
``draw_crop_offsets``, from an explicit ``torch.Generator``) and a
deterministic apply at given flips or offsets (``apply_flips`` /
``apply_crops``), so the same augmentation can be replayed from other draws.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class ImageTransform:
    """Base: ``call(image, rng)`` -> image, both [h, w, c] float32.

    ``uint8_safe`` marks transforms whose math is dtype-agnostic (pure
    index shuffles: flip/crop) — the only ones ImageRecordReader's uint8
    fast path may run before the on-device float cast."""

    uint8_safe = False

    def call(self, image: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, image: np.ndarray,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        return self.call(np.asarray(image, np.float32),
                         rng or np.random.RandomState())


@dataclasses.dataclass
class FlipImageTransform(ImageTransform):
    """Reference: FlipImageTransform(flipMode). mode: 0 = vertical,
    1 = horizontal, -1 = both, None = random choice per call."""

    mode: Optional[int] = 1
    uint8_safe = True

    def call(self, image, rng):
        mode = self.mode
        if mode is None:
            mode = rng.choice([-1, 0, 1])
        if mode in (0, -1):
            image = image[::-1]
        if mode in (1, -1):
            image = image[:, ::-1]
        # a VIEW, not a copy: downstream consumers (reader _load, resize)
        # make one contiguous copy at the end of the whole pipeline
        return image


@dataclasses.dataclass
class CropImageTransform(ImageTransform):
    """Deterministic border crop (reference: CropImageTransform)."""

    top: int = 0
    left: int = 0
    bottom: int = 0
    right: int = 0
    uint8_safe = True

    def call(self, image, rng):
        h, w = image.shape[:2]
        return image[self.top: h - self.bottom or h,
                     self.left: w - self.right or w]


@dataclasses.dataclass
class RandomCropTransform(ImageTransform):
    """Random crop to (height, width) (reference: RandomCropTransform)."""

    height: int = 0
    width: int = 0
    uint8_safe = True

    def call(self, image, rng):
        h, w = image.shape[:2]
        if h < self.height or w < self.width:
            raise ValueError(f"image {h}x{w} smaller than crop "
                             f"{self.height}x{self.width}")
        top = rng.randint(0, h - self.height + 1)
        left = rng.randint(0, w - self.width + 1)
        return image[top: top + self.height, left: left + self.width]


@dataclasses.dataclass
class RotateImageTransform(ImageTransform):
    """Rotate by ``angle`` degrees, or uniformly in [-angle, angle] when
    ``random`` (reference: RotateImageTransform). Right-angle rotations are
    exact (np.rot90); others resample bilinearly via PIL."""

    angle: float = 0.0
    random: bool = False

    def call(self, image, rng):
        angle = float(self.angle)
        if self.random:
            angle = float(rng.uniform(-self.angle, self.angle))
        if angle % 90.0 == 0.0:
            return np.ascontiguousarray(np.rot90(image, int(angle // 90) % 4))
        from PIL import Image

        chans = []
        for c in range(image.shape[2]):
            im = Image.fromarray(image[:, :, c].astype(np.float32), mode="F")
            chans.append(np.asarray(im.rotate(angle, resample=Image.BILINEAR)))
        return np.stack(chans, axis=2)


@dataclasses.dataclass
class ResizeImageTransform(ImageTransform):
    """Bilinear resize (reference: ResizeImageTransform)."""

    height: int = 0
    width: int = 0

    def call(self, image, rng):
        from .. import native

        return native.resize_bilinear(image, self.height, self.width)


@dataclasses.dataclass
class BrightnessTransform(ImageTransform):
    """Additive brightness jitter in [-delta, delta] (for [0, 255] or
    [0, 1] ranged images alike — delta is in image units)."""

    delta: float = 0.0

    def call(self, image, rng):
        return image + rng.uniform(-self.delta, self.delta)


class PipelineImageTransform(ImageTransform):
    """Chain transforms, each applied with a probability (reference:
    PipelineImageTransform with (transform, probability) pairs)."""

    def __init__(self, *steps, shuffle: bool = False) -> None:
        self.steps: List[Tuple[ImageTransform, float]] = [
            s if isinstance(s, tuple) else (s, 1.0) for s in steps
        ]
        self.shuffle = shuffle
        self.uint8_safe = all(t.uint8_safe for t, _ in self.steps)

    def call(self, image, rng):
        order = list(range(len(self.steps)))
        if self.shuffle:
            rng.shuffle(order)
        for i in order:
            t, p = self.steps[i]
            if p >= 1.0 or rng.rand() < p:
                image = t.call(image, rng)
        return image


# ---------------------------------------------------------------------------
# device-side batched augmentation ([n, c, h, w] torch tensors)
# ---------------------------------------------------------------------------

def draw_flips(n: int, generator: torch.Generator, device=None):
    """[n] bool: which images to flip, each with probability 1/2, drawn
    from ``generator`` (on the generator's device) and moved to ``device``."""
    u = torch.rand((n,), generator=generator, device=generator.device)
    return (u < 0.5).to(device if device is not None else u.device)


def apply_flips(x, flips):
    """Flip the images of ``x`` [n, c, h, w] where ``flips`` [n] is true
    (horizontally: the last axis)."""
    return torch.where(flips.to(x.device)[:, None, None, None], torch.flip(x, dims=(-1,)), x)


def batch_random_flip(x, generator: torch.Generator):
    """Per-image random horizontal flip on the device of ``x`` [n, c, h, w]."""
    return apply_flips(x, draw_flips(x.shape[0], generator, x.device))


def draw_crop_offsets(n: int, h: int, w: int, height: int, width: int,
                      generator: torch.Generator, device=None):
    """([n] tops, [n] lefts), int64, uniform in ``[0, h - height]`` and
    ``[0, w - width]``, drawn from ``generator``."""
    gd = generator.device
    tops = torch.randint(0, h - height + 1, (n,), generator=generator, device=gd)
    lefts = torch.randint(0, w - width + 1, (n,), generator=generator, device=gd)
    if device is not None:
        tops, lefts = tops.to(device), lefts.to(device)
    return tops, lefts


def apply_crops(x, tops, lefts, height: int, width: int):
    """Crop image ``i`` of ``x`` [n, c, h, w] to rows ``tops[i] +
    [0, height)`` and columns ``lefts[i] + [0, width)``: one gather over
    the batch, no loop over images. Offsets are clamped to the image, as
    ``lax.dynamic_slice`` clamps them."""
    n, c, h, w = x.shape
    tops = torch.clamp(tops.to(x.device).long(), 0, h - height)
    lefts = torch.clamp(lefts.to(x.device).long(), 0, w - width)
    rows = tops[:, None] + torch.arange(height, device=x.device)[None, :]      # [n, height]
    cols = lefts[:, None] + torch.arange(width, device=x.device)[None, :]      # [n, width]
    idx = rows[:, :, None] * w + cols[:, None, :]                               # [n, height, width]
    flat = x.reshape(n, c, h * w)
    out = torch.gather(flat, 2, idx.reshape(n, 1, height * width).expand(n, c, height * width))
    return out.reshape(n, c, height, width)


def batch_random_crop(x, generator: torch.Generator, height: int, width: int):
    """Per-image random crop on the device of ``x``: [n, c, h, w] ->
    [n, c, height, width]."""
    n, _, h, w = x.shape
    tops, lefts = draw_crop_offsets(n, h, w, height, width, generator, x.device)
    return apply_crops(x, tops, lefts, height, width)
