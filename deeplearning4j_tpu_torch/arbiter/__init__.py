"""Arbiter — hyperparameter search (a copy of ``deeplearning4j_tpu/arbiter``,
which uses no framework).

Reference: arbiter (SURVEY.md §2.2): parameter spaces over configs,
random/grid candidate generation, local execution scoring candidates by
training + evaluating, result tracking.
"""

from .spaces import (
    ContinuousParameterSpace,
    DiscreteParameterSpace,
    FixedValue,
    IntegerParameterSpace,
    ParameterSpace,
)
from .search import (
    CandidateResult,
    GridSearchGenerator,
    LocalOptimizationRunner,
    OptimizationConfiguration,
    RandomSearchGenerator,
)

__all__ = [
    "CandidateResult",
    "ContinuousParameterSpace",
    "DiscreteParameterSpace",
    "FixedValue",
    "GridSearchGenerator",
    "IntegerParameterSpace",
    "LocalOptimizationRunner",
    "OptimizationConfiguration",
    "ParameterSpace",
    "RandomSearchGenerator",
]
