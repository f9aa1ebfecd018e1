"""Weight initialization (port of ``deeplearning4j_tpu/nn/weights.py``).

The same ``WeightInit`` vocabulary and fan conventions. Random draws come
from an explicit CPU ``torch.Generator`` and are then moved to the target
device, so a seed gives the same weights on every device. They are not
JAX's weights: threefry and torch's generator differ, and weights cross
between the packages through the model zip (``model/serializer.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Sequence, Tuple

import torch

from ..core.config import register_config


class WeightInit(enum.Enum):
    ZERO = "ZERO"
    ONES = "ONES"
    IDENTITY = "IDENTITY"
    NORMAL = "NORMAL"  # N(0, 1/sqrt(fanIn))
    UNIFORM = "UNIFORM"  # U(-a, a), a = 1/sqrt(fanIn)
    XAVIER = "XAVIER"  # N(0, 2/(fanIn+fanOut))
    XAVIER_UNIFORM = "XAVIER_UNIFORM"  # U +- sqrt(6/(fanIn+fanOut))
    XAVIER_FAN_IN = "XAVIER_FAN_IN"  # N(0, 1/fanIn)
    RELU = "RELU"  # He normal: N(0, 2/fanIn)
    RELU_UNIFORM = "RELU_UNIFORM"  # U +- sqrt(6/fanIn)
    SIGMOID_UNIFORM = "SIGMOID_UNIFORM"  # U +- 4*sqrt(6/(fanIn+fanOut))
    LECUN_NORMAL = "LECUN_NORMAL"  # N(0, 1/fanIn)
    LECUN_UNIFORM = "LECUN_UNIFORM"  # U +- sqrt(3/fanIn)
    VAR_SCALING_NORMAL_FAN_IN = "VAR_SCALING_NORMAL_FAN_IN"
    VAR_SCALING_NORMAL_FAN_OUT = "VAR_SCALING_NORMAL_FAN_OUT"
    VAR_SCALING_NORMAL_FAN_AVG = "VAR_SCALING_NORMAL_FAN_AVG"
    VAR_SCALING_UNIFORM_FAN_IN = "VAR_SCALING_UNIFORM_FAN_IN"
    VAR_SCALING_UNIFORM_FAN_OUT = "VAR_SCALING_UNIFORM_FAN_OUT"
    VAR_SCALING_UNIFORM_FAN_AVG = "VAR_SCALING_UNIFORM_FAN_AVG"
    DISTRIBUTION = "DISTRIBUTION"

    @classmethod
    def from_any(cls, w) -> "WeightInit":
        if isinstance(w, WeightInit):
            return w
        return cls[str(w).upper()]


@register_config
@dataclasses.dataclass(frozen=True)
class Distribution:
    """Custom distribution for WeightInit.DISTRIBUTION (reference: org.deeplearning4j.nn.conf.distribution.*)."""

    kind: str = "normal"  # normal|uniform|truncated_normal|constant|orthogonal
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    value: float = 0.0
    gain: float = 1.0


def init_weights(
    gen: torch.Generator,
    shape: Sequence[int],
    weight_init: WeightInit,
    fan_in: float,
    fan_out: float,
    distribution: Optional[Distribution] = None,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Draw a weight of ``shape`` from the CPU generator ``gen`` (in f32,
    then cast to ``dtype``) and place it on ``device``."""
    w = WeightInit.from_any(weight_init)
    shape = tuple(int(s) for s in shape)

    def normal(std: float) -> torch.Tensor:
        return std * torch.randn(shape, generator=gen)

    def uniform(a: float) -> torch.Tensor:
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * a

    def draw() -> torch.Tensor:
        if w is WeightInit.ZERO:
            return torch.zeros(shape)
        if w is WeightInit.ONES:
            return torch.ones(shape)
        if w is WeightInit.IDENTITY:
            if len(shape) != 2 or shape[0] != shape[1]:
                raise ValueError("IDENTITY init requires a square 2-D weight")
            return torch.eye(shape[0])
        if w is WeightInit.NORMAL:
            return normal(1.0 / math.sqrt(fan_in))
        if w is WeightInit.UNIFORM:
            return uniform(1.0 / math.sqrt(fan_in))
        if w is WeightInit.XAVIER:
            return normal(math.sqrt(2.0 / (fan_in + fan_out)))
        if w is WeightInit.XAVIER_UNIFORM:
            return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
        if w is WeightInit.XAVIER_FAN_IN:
            return normal(math.sqrt(1.0 / fan_in))
        if w is WeightInit.RELU:
            return normal(math.sqrt(2.0 / fan_in))
        if w is WeightInit.RELU_UNIFORM:
            return uniform(math.sqrt(6.0 / fan_in))
        if w is WeightInit.SIGMOID_UNIFORM:
            return uniform(4.0 * math.sqrt(6.0 / (fan_in + fan_out)))
        if w is WeightInit.LECUN_NORMAL:
            return normal(math.sqrt(1.0 / fan_in))
        if w is WeightInit.LECUN_UNIFORM:
            return uniform(math.sqrt(3.0 / fan_in))
        if w.value.startswith("VAR_SCALING"):
            mode = w.value.rsplit("_", 2)[-2:]
            fan = {"IN": fan_in, "OUT": fan_out, "AVG": 0.5 * (fan_in + fan_out)}[mode[1]]
            if "NORMAL" in w.value:
                return normal(math.sqrt(1.0 / fan))
            return uniform(math.sqrt(3.0 / fan))
        if w is WeightInit.DISTRIBUTION:
            d = distribution or Distribution()
            if d.kind == "normal":
                return d.mean + d.std * torch.randn(shape, generator=gen)
            if d.kind == "truncated_normal":
                t = torch.empty(shape)
                torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                return d.mean + d.std * t
            if d.kind == "uniform":
                return d.lower + (d.upper - d.lower) * torch.rand(shape, generator=gen)
            if d.kind == "constant":
                return torch.full(shape, d.value)
            if d.kind == "orthogonal":
                t = torch.empty(shape)
                torch.nn.init.orthogonal_(t, gain=d.gain, generator=gen)
                return t
            raise ValueError(f"Unknown distribution kind {d.kind!r}")
        raise ValueError(f"Unhandled weight init {w}")

    return draw().to(device=device, dtype=dtype)


def conv_fans(kernel: Sequence[int], c_in: int, c_out: int, depth_mult: int = 1) -> Tuple[float, float]:
    """Fan-in/out for conv kernels, matching the reference's convention."""
    rf = 1
    for k in kernel:
        rf *= int(k)
    return float(c_in * rf), float(c_out * rf * depth_mult) / max(1, depth_mult)
