"""Serving over the port's models (port of the JAX package's
``parallel`` serving modules): :class:`DecodeEngine`, the
continuous-batching generation loop, with its streaming
:class:`GenerationHandle` and :class:`DecodeAIMD` controller;
:class:`ParallelInference`, dynamic batching over one network's forward;
and :class:`EnginePool`, replica pools behind power-of-two-choices
dispatch, with its :class:`ResponseCache` and :class:`AdaptiveBatcher`.

Training over ``torch.distributed``, one process per rank:
:class:`DistributedTrainer` (data parallelism with its gradient sync
strategies, ZeRO-1 and grouped batch norm; tensor and expert parallelism
over a ``model`` axis through ``param_sharding_rules`` and
:func:`moe_expert_parallel_rules`, with the group collectives
:func:`copy_to_group`, :func:`reduce_from_group`, :func:`gather_from_group`
and :func:`scatter_to_group`); :class:`PipelineParallelTrainer`
(the layer stack over a ``pipe`` axis under GPipe or 1F1B tick schedules,
composing with ``data`` and ZeRO-1) and the pipeline primitives;
:func:`ring_attention` and :func:`ulysses_attention` (sequence parallelism
over a ``seq`` axis); :class:`ShardedEmbeddingTable` (rows over a ``model``
axis); and the mesh helpers (:func:`initialize_distributed`,
:func:`make_mesh`)."""

from .decode import DecodeAIMD, DecodeEngine, GenerationHandle
from .inference import InferenceMode, ParallelInference, Servable
from .mesh import (MeshSpec, PartitionSpec, copy_to_group, gather_from_group,
                   initialize_distributed, local_batch_slice, make_mesh, reduce_from_group,
                   scatter_to_group, zero1_partition_spec)
from .pipeline import (PipelineSchedule, StagePartition, build_pipeline_schedule,
                       dense_block_stage, partition_stages, pipeline_apply, pipeline_stages_init,
                       pipeline_value_and_grad, run_pipeline_schedule, shard_stage_params)
from .pool import AdaptiveBatcher, EnginePool, PoolServable, ResponseCache
from .sequence import (ring_attention, ring_attention_shard, ulysses_attention,
                       ulysses_attention_shard)
from .sharded_embedding import ShardedEmbeddingTable, shard_rows
from .strategies import (BucketedAllReduceSync, GradientSyncStrategy, ParameterAveragingSync,
                         SyncAllReduce, ThresholdCompressedSync, TopKCompressedSync)
from .trainer import DistributedTrainer, PipelineParallelTrainer, moe_expert_parallel_rules

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
    "copy_to_group",
    "dense_block_stage",
    "gather_from_group",
    "initialize_distributed",
    "local_batch_slice",
    "make_mesh",
    "moe_expert_parallel_rules",
    "partition_stages",
    "pipeline_apply",
    "pipeline_stages_init",
    "pipeline_value_and_grad",
    "reduce_from_group",
    "ring_attention",
    "ring_attention_shard",
    "run_pipeline_schedule",
    "scatter_to_group",
    "shard_rows",
    "shard_stage_params",
    "ulysses_attention",
    "ulysses_attention_shard",
    "zero1_partition_spec",
]
