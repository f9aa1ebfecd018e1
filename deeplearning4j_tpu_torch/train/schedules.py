"""Learning-rate (and generic hyperparameter) schedules (port of
``deeplearning4j_tpu/train/schedules.py``).

Reference: org.nd4j.linalg.schedule.{ISchedule, StepSchedule,
ExponentialSchedule, InverseSchedule, PolySchedule, SigmoidSchedule,
MapSchedule, CycleSchedule, RampSchedule} with ScheduleType ITERATION/EPOCH.

Each schedule is a config dataclass callable as ``sched(iteration, epoch)``.
The JAX package writes them in jnp because the iteration counter is traced
inside its jitted step; PyTorch runs eagerly and the updaters keep their
step count on the host, so here ``iteration`` and ``epoch`` are Python
numbers and the value is a Python float.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Optional

from ..core.config import register_config


class ScheduleType(enum.Enum):
    ITERATION = "ITERATION"
    EPOCH = "EPOCH"


@dataclasses.dataclass(frozen=True)
class ISchedule:
    def value_at(self, iteration, epoch) -> float:
        raise NotImplementedError

    def __call__(self, iteration, epoch=0) -> float:
        return self.value_at(iteration, epoch)

    def _t(self, iteration, epoch):
        st = getattr(self, "schedule_type", ScheduleType.ITERATION)
        return epoch if st is ScheduleType.EPOCH else iteration


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


@register_config
@dataclasses.dataclass(frozen=True)
class FixedSchedule(ISchedule):
    value: float = 1e-3

    def value_at(self, iteration, epoch):
        return self.value


@register_config
@dataclasses.dataclass(frozen=True)
class StepSchedule(ISchedule):
    """lr = initial * decay^floor(t / step)."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 1e-3
    decay_rate: float = 0.5
    step: float = 1000.0

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return self.initial_value * self.decay_rate ** math.floor(t / self.step)


@register_config
@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(ISchedule):
    """lr = initial * gamma^t."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 1e-3
    gamma: float = 0.99

    def value_at(self, iteration, epoch):
        return self.initial_value * self.gamma ** self._t(iteration, epoch)


@register_config
@dataclasses.dataclass(frozen=True)
class InverseSchedule(ISchedule):
    """lr = initial / (1 + gamma*t)^power."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 1e-3
    gamma: float = 0.1
    power: float = 1.0

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return self.initial_value / (1.0 + self.gamma * t) ** self.power


@register_config
@dataclasses.dataclass(frozen=True)
class PolySchedule(ISchedule):
    """lr = initial * (1 - t/maxIter)^power."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 1e-3
    power: float = 1.0
    max_iter: int = 10000

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        frac = _clip(t / self.max_iter, 0.0, 1.0)
        return self.initial_value * (1.0 - frac) ** self.power


@register_config
@dataclasses.dataclass(frozen=True)
class SigmoidSchedule(ISchedule):
    """lr = initial / (1 + exp(-gamma*(t - stepSize)))."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    initial_value: float = 1e-3
    gamma: float = 0.01
    step_size: int = 1000

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return self.initial_value / (1.0 + math.exp(-self.gamma * (t - self.step_size)))


@register_config
@dataclasses.dataclass(frozen=True)
class MapSchedule(ISchedule):
    """Piecewise-constant: explicit {t: lr} map (reference: MapSchedule).
    Value holds from each key until the next."""

    schedule_type: ScheduleType = ScheduleType.ITERATION
    values: Dict[str, float] = dataclasses.field(default_factory=dict)  # str keys for JSON

    def value_at(self, iteration, epoch):
        t = self._t(iteration, epoch)
        points = sorted((int(k), v) for k, v in self.values.items())
        if not points:
            raise ValueError("MapSchedule requires at least one entry")
        result = points[0][1]
        for thresh, val in points[1:]:
            if t >= thresh:
                result = val
        return result


@register_config
@dataclasses.dataclass(frozen=True)
class CycleSchedule(ISchedule):
    """1-cycle schedule (reference: CycleSchedule): ramp up to max_lr, back
    down, then annihilation phase at the end."""

    initial_value: float = 1e-4
    max_value: float = 1e-2
    cycle_length: int = 1000
    annealing_cycles: int = 1
    annealing_decay: float = 0.1

    def value_at(self, iteration, epoch):
        t = iteration % self.cycle_length
        half = self.cycle_length // 2
        if t < half:
            lr = self.initial_value + (self.max_value - self.initial_value) * (t / half)
        else:
            lr = self.max_value - (self.max_value - self.initial_value) * ((t - half) / half)
        cycle_idx = iteration // self.cycle_length
        return lr * self.annealing_decay ** min(cycle_idx, self.annealing_cycles)


@register_config
@dataclasses.dataclass(frozen=True)
class RampSchedule(ISchedule):
    """Linear warmup wrapper (reference: RampSchedule)."""

    underlying: Optional[ISchedule] = None
    num_iterations: int = 100

    def value_at(self, iteration, epoch):
        base = self.underlying.value_at(iteration, epoch) if self.underlying else 1.0
        return base * min((iteration + 1) / self.num_iterations, 1.0)


@register_config
@dataclasses.dataclass(frozen=True)
class WarmupSchedule(ISchedule):
    """Linear LR warmup from 0 over ``warmup_iterations`` steps, then the
    base schedule unmodified (the large-batch LARS/LAMB recipe). ``base``
    may be any ISchedule; ``base_value`` is the flat target when it is
    None. Nested schedules round-trip through JSON."""

    base: Optional[ISchedule] = None
    warmup_iterations: int = 100
    base_value: float = 1.0  # used when ``base`` is None (flat warmup target)

    def value_at(self, iteration, epoch):
        v = (self.base.value_at(iteration, epoch)
             if self.base is not None else self.base_value)
        if self.warmup_iterations <= 0:
            return v
        return v * _clip((iteration + 1.0) / self.warmup_iterations, 0.0, 1.0)
