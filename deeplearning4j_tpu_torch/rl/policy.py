"""Action policies (a copy of ``deeplearning4j_tpu/rl/policy.py``).

Reference: org.deeplearning4j.rl4j.policy.{Policy, EpsGreedy, DQNPolicy}.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class GreedyPolicy:
    """argmax-Q policy (reference: DQNPolicy)."""

    def __init__(self, q_fn: Callable[[np.ndarray], np.ndarray]) -> None:
        self.q_fn = q_fn

    def next_action(self, observation: np.ndarray) -> int:
        q = np.asarray(self.q_fn(observation[None, :]))[0]
        return int(q.argmax())


class EpsGreedyPolicy(GreedyPolicy):
    """Annealed epsilon-greedy wrapper (reference: EpsGreedy): linear decay
    from ``eps_start`` to ``eps_min`` over ``decay_steps`` calls."""

    def __init__(self, q_fn, n_actions: int, *, eps_start: float = 1.0,
                 eps_min: float = 0.05, decay_steps: int = 1000,
                 seed: int = 0) -> None:
        super().__init__(q_fn)
        self.n_actions = int(n_actions)
        self.eps_start = float(eps_start)
        self.eps_min = float(eps_min)
        self.decay_steps = int(decay_steps)
        self.rng = np.random.RandomState(seed)
        self.steps = 0

    @property
    def epsilon(self) -> float:
        frac = min(1.0, self.steps / max(1, self.decay_steps))
        return self.eps_start + (self.eps_min - self.eps_start) * frac

    def next_action(self, observation: np.ndarray) -> int:
        eps = self.epsilon
        self.steps += 1
        if self.rng.rand() < eps:
            return int(self.rng.randint(self.n_actions))
        return super().next_action(observation)
