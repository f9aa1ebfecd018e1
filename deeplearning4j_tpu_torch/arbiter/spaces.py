"""Parameter spaces (a copy of ``deeplearning4j_tpu/arbiter/spaces.py``, which
uses no framework).

Reference: org.deeplearning4j.arbiter.optimize.api.ParameterSpace and the
concrete spaces (ContinuousParameterSpace, DiscreteParameterSpace,
IntegerParameterSpace, FixedValue).
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence

import numpy as np


class ParameterSpace:
    """SPI: sample a value from [0,1)^n coordinates, or enumerate a grid."""

    def sample(self, rng: np.random.RandomState) -> Any:
        raise NotImplementedError

    def grid(self, resolution: int) -> List[Any]:
        """Discretization used by grid search."""
        raise NotImplementedError


class FixedValue(ParameterSpace):
    def __init__(self, value: Any) -> None:
        self.value = value

    def sample(self, rng) -> Any:
        return self.value

    def grid(self, resolution: int) -> List[Any]:
        return [self.value]


class ContinuousParameterSpace(ParameterSpace):
    """Uniform (or log-uniform) float range — log scale is the right prior
    for learning rates / regularization strengths."""

    def __init__(self, min_value: float, max_value: float,
                 log_scale: bool = False) -> None:
        if min_value >= max_value:
            raise ValueError("min must be < max")
        if log_scale and min_value <= 0:
            raise ValueError("log scale needs positive bounds")
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.log_scale = log_scale

    def sample(self, rng) -> float:
        if self.log_scale:
            lo, hi = math.log(self.min_value), math.log(self.max_value)
            return float(math.exp(rng.uniform(lo, hi)))
        return float(rng.uniform(self.min_value, self.max_value))

    def grid(self, resolution: int) -> List[float]:
        if self.log_scale:
            return list(np.exp(np.linspace(math.log(self.min_value),
                                           math.log(self.max_value),
                                           resolution)))
        return list(np.linspace(self.min_value, self.max_value, resolution))


class IntegerParameterSpace(ParameterSpace):
    def __init__(self, min_value: int, max_value: int) -> None:
        if min_value > max_value:
            raise ValueError("min must be <= max")
        self.min_value = int(min_value)
        self.max_value = int(max_value)

    def sample(self, rng) -> int:
        return int(rng.randint(self.min_value, self.max_value + 1))

    def grid(self, resolution: int) -> List[int]:
        span = self.max_value - self.min_value + 1
        if span <= resolution:
            return list(range(self.min_value, self.max_value + 1))
        return sorted({int(v) for v in np.linspace(
            self.min_value, self.max_value, resolution)})


class DiscreteParameterSpace(ParameterSpace):
    def __init__(self, values: Sequence[Any]) -> None:
        if not values:
            raise ValueError("empty value set")
        self.values = list(values)

    def sample(self, rng) -> Any:
        return self.values[rng.randint(len(self.values))]

    def grid(self, resolution: int) -> List[Any]:
        return list(self.values)
