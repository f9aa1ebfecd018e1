"""Seeded random streams (port of ``deeplearning4j_tpu/core/rng.py``).

The JAX package's ``RngState`` splits threefry keys; here a stream hands out
``torch.Generator`` objects instead. Each :meth:`RngState.next_key` returns a
fresh CPU generator seeded from the stream's own generator, which advances
once per call, so two ``RngState(seed)`` give the same sequence of generators
and a restored :meth:`RngState.state_dict` continues it exactly. The bits are
not threefry's: streams agree with the JAX package's in their law, not in
their values.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import torch


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


class RngState:
    """A stream of generators with DL4J-style global seeding semantics."""

    def __init__(self, seed: int = 0) -> None:
        self._seed = int(seed)
        self._gen = _seeded(self._seed)
        self._count = 0

    @property
    def seed(self) -> int:
        return self._seed

    def _draw(self) -> int:
        self._count += 1
        return int(torch.randint(0, 2**62, (), generator=self._gen))

    def next_key(self) -> torch.Generator:
        """A fresh generator; the stream advances by one."""
        return _seeded(self._draw())

    def state_dict(self) -> dict:
        """JSON-able snapshot of the stream position: restoring it makes the
        next :meth:`next_key` return what the snapshotted stream would have."""
        return {"seed": self._seed, "count": self._count}

    def load_state_dict(self, state: dict) -> None:
        self._seed = int(state["seed"])
        self._gen = _seeded(self._seed)
        self._count = 0
        for _ in range(int(state["count"])):
            self._draw()

    def split(self, n: int) -> List[torch.Generator]:
        return [self.next_key() for _ in range(n)]

    def fork(self) -> "RngState":
        """A child stream seeded from this one (which advances by one)."""
        return RngState(self._draw())

    def keys(self) -> Iterator[torch.Generator]:
        while True:
            yield self.next_key()


_default: Optional[RngState] = None


def get_default_rng() -> RngState:
    global _default
    if _default is None:
        _default = RngState(0)
    return _default


def set_default_seed(seed: int) -> None:
    global _default
    _default = RngState(seed)
