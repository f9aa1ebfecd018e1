"""Serving over the port's models (port of the JAX package's
``parallel`` serving modules): :class:`DecodeEngine`, the
continuous-batching generation loop, with its streaming
:class:`GenerationHandle` and :class:`DecodeAIMD` controller;
:class:`ParallelInference`, dynamic batching over one network's forward;
and :class:`EnginePool`, replica pools behind power-of-two-choices
dispatch, with its :class:`ResponseCache` and :class:`AdaptiveBatcher`.

Training over ``torch.distributed``, one process per rank:
:class:`DistributedTrainer` (data parallelism with its gradient sync
strategies, ZeRO-1 and grouped batch norm); :class:`PipelineParallelTrainer`
(the layer stack over a ``pipe`` axis under GPipe or 1F1B tick schedules,
composing with ``data`` and ZeRO-1) and the pipeline primitives;
:func:`ring_attention` and :func:`ulysses_attention` (sequence parallelism
over a ``seq`` axis); :class:`ShardedEmbeddingTable` (rows over a ``model``
axis); and the mesh helpers (:func:`initialize_distributed`,
:func:`make_mesh`). The JAX package's tensor parallelism and explicit expert
parallelism (``param_sharding_rules``, ``moe_expert_parallel_rules``) are
ROADMAP A8 part 3."""

from .decode import DecodeAIMD, DecodeEngine, GenerationHandle
from .inference import InferenceMode, ParallelInference, Servable
from .mesh import (MeshSpec, PartitionSpec, initialize_distributed, local_batch_slice,
                   make_mesh, zero1_partition_spec)
from .pipeline import (PipelineSchedule, StagePartition, build_pipeline_schedule,
                       dense_block_stage, partition_stages, pipeline_apply, pipeline_stages_init,
                       pipeline_value_and_grad, run_pipeline_schedule, shard_stage_params)
from .pool import AdaptiveBatcher, EnginePool, PoolServable, ResponseCache
from .sequence import (ring_attention, ring_attention_shard, ulysses_attention,
                       ulysses_attention_shard)
from .sharded_embedding import ShardedEmbeddingTable, shard_rows
from .strategies import (BucketedAllReduceSync, GradientSyncStrategy, ParameterAveragingSync,
                         SyncAllReduce, ThresholdCompressedSync, TopKCompressedSync)
from .trainer import DistributedTrainer, PipelineParallelTrainer

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
    "PipelineParallelTrainer",
    "PipelineSchedule",
    "PoolServable",
    "ResponseCache",
    "Servable",
    "ShardedEmbeddingTable",
    "StagePartition",
    "SyncAllReduce",
    "ThresholdCompressedSync",
    "TopKCompressedSync",
    "build_pipeline_schedule",
    "dense_block_stage",
    "initialize_distributed",
    "local_batch_slice",
    "make_mesh",
    "partition_stages",
    "pipeline_apply",
    "pipeline_stages_init",
    "pipeline_value_and_grad",
    "ring_attention",
    "ring_attention_shard",
    "run_pipeline_schedule",
    "shard_rows",
    "shard_stage_params",
    "ulysses_attention",
    "ulysses_attention_shard",
    "zero1_partition_spec",
]
