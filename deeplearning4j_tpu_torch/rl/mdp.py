"""MDP environment interface + local CartPole (a copy of
``deeplearning4j_tpu/rl/mdp.py``, which uses no framework).

Reference: org.deeplearning4j.rl4j.mdp.MDP (gym-style contract) and the
bundled toy environments (rl4j used gym/malmo bindings; with zero egress
the classic CartPole dynamics are implemented locally — same physics
constants as gym's CartPole-v1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class StepReply:
    observation: np.ndarray
    reward: float
    done: bool
    info: Any = None


class MDP:
    """Environment SPI (reference: MDP<OBSERVATION, ACTION, ACTION_SPACE>)."""

    observation_size: int
    action_size: int

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> StepReply:
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:  # reference API
        pass


class CartPole(MDP):
    """Classic cart-pole balancing (gym CartPole-v1 physics)."""

    observation_size = 4
    action_size = 2

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LENGTH = 0.5
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * math.pi / 180
    X_LIMIT = 2.4

    def __init__(self, max_steps: int = 500, seed: int = 0) -> None:
        self.max_steps = max_steps
        self.rng = np.random.RandomState(seed)
        self.state: Optional[np.ndarray] = None
        self.steps = 0
        self._done = True

    def reset(self) -> np.ndarray:
        self.state = self.rng.uniform(-0.05, 0.05, 4)
        self.steps = 0
        self._done = False
        return self.state.astype(np.float32)

    def step(self, action: int) -> StepReply:
        assert self.state is not None and not self._done, "call reset() first"
        x, x_dot, theta, theta_dot = self.state
        force = self.FORCE if action == 1 else -self.FORCE
        total_mass = self.CART_MASS + self.POLE_MASS
        pm_l = self.POLE_MASS * self.POLE_HALF_LENGTH
        cos_t, sin_t = math.cos(theta), math.sin(theta)
        temp = (force + pm_l * theta_dot ** 2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LENGTH
            * (4.0 / 3.0 - self.POLE_MASS * cos_t ** 2 / total_mass))
        x_acc = temp - pm_l * theta_acc * cos_t / total_mass
        self.state = np.array([
            x + self.DT * x_dot,
            x_dot + self.DT * x_acc,
            theta + self.DT * theta_dot,
            theta_dot + self.DT * theta_acc,
        ])
        self.steps += 1
        out_of_bounds = (abs(self.state[0]) > self.X_LIMIT
                         or abs(self.state[2]) > self.THETA_LIMIT)
        self._done = out_of_bounds or self.steps >= self.max_steps
        return StepReply(self.state.astype(np.float32), 1.0, self._done)

    def is_done(self) -> bool:
        return self._done
