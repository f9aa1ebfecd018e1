"""Serving over the port's models (port of the JAX package's
``parallel`` serving modules): :class:`DecodeEngine`, the
continuous-batching generation loop, with its streaming
:class:`GenerationHandle` and :class:`DecodeAIMD` controller;
:class:`ParallelInference`, dynamic batching over one network's forward;
and :class:`EnginePool`, replica pools behind power-of-two-choices
dispatch, with its :class:`ResponseCache` and :class:`AdaptiveBatcher`.

Data-parallel training over ``torch.distributed``: :class:`DistributedTrainer`
with its gradient sync strategies, ZeRO-1 and grouped batch norm, and the
mesh helpers (:func:`initialize_distributed`, :func:`make_mesh`). The JAX
package's pipeline, sequence and tensor parallelism are ROADMAP A8 part 2."""

from .decode import DecodeAIMD, DecodeEngine, GenerationHandle
from .inference import InferenceMode, ParallelInference, Servable
from .mesh import (MeshSpec, PartitionSpec, initialize_distributed, local_batch_slice,
                   make_mesh, zero1_partition_spec)
from .pool import AdaptiveBatcher, EnginePool, PoolServable, ResponseCache
from .strategies import (BucketedAllReduceSync, GradientSyncStrategy, ParameterAveragingSync,
                         SyncAllReduce, ThresholdCompressedSync, TopKCompressedSync)
from .trainer import DistributedTrainer

__all__ = [
    "AdaptiveBatcher",
    "BucketedAllReduceSync",
    "DecodeAIMD",
    "DecodeEngine",
    "DistributedTrainer",
    "EnginePool",
    "GenerationHandle",
    "GradientSyncStrategy",
    "InferenceMode",
    "MeshSpec",
    "ParallelInference",
    "ParameterAveragingSync",
    "PartitionSpec",
    "PoolServable",
    "ResponseCache",
    "Servable",
    "SyncAllReduce",
    "ThresholdCompressedSync",
    "TopKCompressedSync",
    "initialize_distributed",
    "local_batch_slice",
    "make_mesh",
    "zero1_partition_spec",
]
