"""Experience replay buffer (a copy of ``deeplearning4j_tpu/rl/replay.py``).

Reference: org.deeplearning4j.rl4j.learning.sync.ExpReplay — bounded FIFO
of transitions with uniform random minibatch sampling.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Transition:
    observation: np.ndarray
    action: int
    reward: float
    next_observation: np.ndarray
    done: bool


class ExpReplay:
    def __init__(self, max_size: int = 10000, batch_size: int = 32,
                 seed: int = 0) -> None:
        self.max_size = int(max_size)
        self.batch_size = int(batch_size)
        self.rng = np.random.RandomState(seed)
        self._buf: List[Transition] = []
        self._pos = 0

    def store(self, t: Transition) -> None:
        if len(self._buf) < self.max_size:
            self._buf.append(t)
        else:  # ring overwrite
            self._buf[self._pos] = t
            self._pos = (self._pos + 1) % self.max_size

    def __len__(self) -> int:
        return len(self._buf)

    def sample(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray, np.ndarray]:
        """Uniform minibatch as stacked arrays (obs, action, reward,
        next_obs, done)."""
        n = min(self.batch_size, len(self._buf))
        idx = self.rng.randint(0, len(self._buf), n)
        ts = [self._buf[i] for i in idx]
        return (
            np.stack([t.observation for t in ts]).astype(np.float32),
            np.asarray([t.action for t in ts], np.int32),
            np.asarray([t.reward for t in ts], np.float32),
            np.stack([t.next_observation for t in ts]).astype(np.float32),
            np.asarray([t.done for t in ts], np.float32),
        )
