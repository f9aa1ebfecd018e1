"""Candidate generation + local optimization runner (a copy of
``deeplearning4j_tpu/arbiter/search.py``, which uses no framework).

Reference: org.deeplearning4j.arbiter.optimize.{generator.
RandomSearchGenerator/GridSearchCandidateGenerator, config.
OptimizationConfiguration, runner.LocalOptimizationRunner}. A candidate is
a sampled {name: value} dict; the user's ``model_factory(hp)`` builds a
model from it (the Pythonic stand-in for MultiLayerSpace), a score
function rates it, and the runner tracks every result plus the best.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from .spaces import ParameterSpace


class CandidateGenerator:
    def __iter__(self) -> Iterator[Dict[str, Any]]:
        raise NotImplementedError


class RandomSearchGenerator(CandidateGenerator):
    def __init__(self, spaces: Dict[str, ParameterSpace],
                 num_candidates: int = 10, seed: int = 12345) -> None:
        self.spaces = dict(spaces)
        self.num_candidates = int(num_candidates)
        self.seed = seed

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        for _ in range(self.num_candidates):
            yield {k: s.sample(rng) for k, s in self.spaces.items()}


class GridSearchGenerator(CandidateGenerator):
    def __init__(self, spaces: Dict[str, ParameterSpace],
                 discretization: int = 3) -> None:
        self.spaces = dict(spaces)
        self.discretization = int(discretization)

    def __iter__(self):
        names = list(self.spaces)
        axes = [self.spaces[n].grid(self.discretization) for n in names]
        for combo in itertools.product(*axes):
            yield dict(zip(names, combo))


@dataclasses.dataclass
class CandidateResult:
    index: int
    hyperparameters: Dict[str, Any]
    score: float
    duration_s: float
    model: Any = None
    error: Optional[str] = None


@dataclasses.dataclass
class OptimizationConfiguration:
    """Reference: OptimizationConfiguration.Builder fields."""

    candidate_generator: CandidateGenerator
    model_factory: Callable[[Dict[str, Any]], Any]
    score_function: Callable[[Any, Dict[str, Any]], float]
    minimize: bool = True
    keep_models: bool = False


class LocalOptimizationRunner:
    """Sequential local executor (reference: LocalOptimizationRunner —
    its thread pool parallelised CPU training; on one card candidates
    serialize through the device anyway)."""

    def __init__(self, config: OptimizationConfiguration) -> None:
        self.config = config
        self.results: List[CandidateResult] = []

    def execute(self, log_fn=None) -> CandidateResult:
        cfg = self.config
        for i, hp in enumerate(cfg.candidate_generator):
            t0 = time.perf_counter()
            try:
                model = cfg.model_factory(hp)
                score = float(cfg.score_function(model, hp))
                res = CandidateResult(
                    index=i, hyperparameters=hp, score=score,
                    duration_s=time.perf_counter() - t0,
                    model=model if cfg.keep_models else None)
            except Exception as e:  # a failed candidate shouldn't end search
                res = CandidateResult(
                    index=i, hyperparameters=hp,
                    score=float("inf") if cfg.minimize else float("-inf"),
                    duration_s=time.perf_counter() - t0, error=str(e))
            self.results.append(res)
            if log_fn:
                log_fn(f"candidate {i}: score={res.score:.5f} hp={hp}"
                       + (f" ERROR={res.error}" if res.error else ""))
        if not self.results:
            raise ValueError("candidate generator produced no candidates")
        return self.best_result()

    def best_result(self) -> CandidateResult:
        key = (min if self.config.minimize else max)
        return key(self.results, key=lambda r: r.score)

    def num_candidates_completed(self) -> int:
        return len(self.results)
