"""Serving over the port's models (port of the JAX package's
``parallel`` serving modules): :class:`DecodeEngine`, the
continuous-batching generation loop, with its streaming
:class:`GenerationHandle` and :class:`DecodeAIMD` controller;
:class:`ParallelInference`, dynamic batching over one network's forward;
and :class:`EnginePool`, replica pools behind power-of-two-choices
dispatch, with its :class:`ResponseCache` and :class:`AdaptiveBatcher`.
The JAX package's distributed-training modules are ROADMAP A8."""

from .decode import DecodeAIMD, DecodeEngine, GenerationHandle
from .inference import InferenceMode, ParallelInference, Servable
from .pool import AdaptiveBatcher, EnginePool, PoolServable, ResponseCache

__all__ = [
    "AdaptiveBatcher",
    "DecodeAIMD",
    "DecodeEngine",
    "EnginePool",
    "GenerationHandle",
    "InferenceMode",
    "ParallelInference",
    "PoolServable",
    "ResponseCache",
    "Servable",
]
