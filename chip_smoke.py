#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one NVIDIA Hopper card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deeplearning4j_tpu_torch/csrc/``,
holds each against its plain PyTorch version on the card (the flash
forward B1, the flash backward B2 dq and B3 dk/dv, the decode kernel B4,
the grouped expert matmul B5), then drives the port's main paths at GPT-2
small's published widths (vocab 50257, hidden 768, 12 layers, 12 heads,
ffn 3072, 1024 positions; float32; random weights from a seed): it serves
a ``TransformerLM`` through ``output()`` on 8 prompts of 1024 tokens and
``GenerationSession.generate`` on 8 ragged prompts (the decode step replayed
from a CUDA graph), serves the same prompts through the continuous-batching
``DecodeEngine`` over static, paged, int8 and paged int8 caches and with
speculative decoding (the target as its own draft, and a 2-block draft),
serves it over HTTP (``JsonModelServer`` on 127.0.0.1: batched ``output()``
on ``/v1/serving``, streamed ``/v1/generate`` over the static engine, a
disaggregated prefill host -> handoff -> paged decode host behind a
``DisaggCoordinator`` with its unified fallback, a hot swap from a
``ModelStore`` through deploy, canary and promotion with ``park()`` and
``unpark()``, and an ``EnginePool`` of two engines), holding every stream
to the in-process engine's, checks the device sampler against the CPU's
and a softmax, trains one with
``Solver.fit_batch`` (Adam 1e-4) on 8 x 1024 tokens, and runs ``output()``
and ``Solver.fit_batch`` on the MoE network of
``tools/moe_profile.py::moe_lm_conf`` (one such block, then 8 experts of
hidden 1536, top-2, capacity factor 1.25, through B5). Each path runs with
the launch counts set to 0 just before it and read just after. It checks
those counts, the cached decode's log-probs against a full forward, the
training scores, the kernel-path gradients against the materialised-scores
reference, and the MoE network's outputs and gradients against its sort
dispatch (``torch.bmm`` over capacity slots); it counts HMMA and atomic
instructions in every kernel's SASS. The kernels take float32, bf16, f16
and f64 with head dims up to 256, and so it also holds every such
instantiation against its plain version, and drives the entry points
through them against the materialised-scores seam: a head-dim-256
``TransformerLM`` (hidden 2048, 8 heads, 2 blocks) through ``output()``,
gradients, 2 training steps and greedy ``generate()``; the GPT-2-small-width
LM in float16 through ``output()`` and ``generate()``; a small float64 LM
through ``output()``, gradients, one Adam step and ``generate()``; and a
float64 MoE layer through B5. Then the CNN and graph paths: the zoo
``LeNet()`` (``MultiLayerNetwork``, 28x28x1 flat input, both preprocessors
inserted) through ``output()`` and 20 ``fit`` steps on a batch of 64; the
zoo ``ResNet50()`` (``ComputationGraph``, He et al. 2015's widths,
224x224x3, 1000 classes, nothing cut) through ``output()`` and 5
``GraphSolver.fit_batch`` steps on a batch of 32, with cuDNN's TF32 switch
at PyTorch's default, its float32 output held against float64 on the CPU
and every batch norm's running statistics required to move; and the zoo
``BertEncoder()`` at bert-base's widths through ``output(ids,
masks=[mask])`` and 5 masked training steps on [8, 512] ids with ragged key
masks, through B1 (non-causal, key mask) and B2/B3, held against the
materialised-scores seam (gradients on a 2-block cut). LeNet and ResNet-50
also compare the "cudnn" conv2d helper with "im2col". Then the recurrent
slice: the zoo ``TextGenerationLSTM()`` (the GravesLSTM char-RNN: vocab 77,
hidden 200, 2 peephole layers, TBPTT 50, nothing cut) through 5 ``fit``
batches of 32 x 200 one-hot characters (4 truncated-BPTT windows each),
``output()`` against float64 on the CPU, ``rnn_time_step`` one character at
a time against ``output()``, and ``TextGenerationLSTM.generate`` of 200
greedy characters on 8 ragged prompts from a CUDA-graphed decode step; a
``LearnedSelfAttentionLayer`` network (768 wide, 12 heads, 8 queries) on
[8, 512] ids with ragged key masks through B1-B3, against the seam; and the
GPT-2-small-width LM with ``gradient_checkpointing`` (loss and gradients
against the plain step, peak memory) and with ``compute_dtype="bfloat16"``
(float32 master weights, bf16 B1-B3, against the bf16 seam). Then the
data slice: the bf16 ``compute_dtype`` LM's generation (the graphed session,
the engine over static, paged, int8 and paged int8 caches and speculative
``k=4``, through B4, each greedy token held against a full bf16
``output()``); the zoo ``LeNet()`` trained by ``model.fit`` from
``MnistDataSetIterator(64, train=True, num_examples=12800)`` and evaluated on
the 2048 test digits against the JAX package's accuracy on the CPU; and
``bench.py``'s ResNet-50 from files (512 seeded 256x256x3 P6 files ->
``ImageRecordReader(output_dtype="uint8")`` -> ``RecordReaderDataSetIterator``
-> ``AsyncDataSetIterator(device_put_fn=device_put_dataset,
device_buffers=2)`` -> crop and flip on the card -> ``GraphSolver.fit_iterator``
on ``ResNet50(num_classes=8, compute_dtype="bfloat16")``), its first batch
held bit-equal to the decoded files and the host library required to load.
Then the SameDiff slice, at ``bench.py``'s sizes for ``BASELINE.json``'s
"BERT-base via SameDiff TF import": the frozen BERT-base graph (L 12, H 768,
12 heads, vocab 30522) read from the committed skeleton
(``deeplearning4j_tpu_torch/tools/bert_skeleton.py``, filled from seed 0) by
the port's own GraphDef reader, with no TensorFlow (whether TensorFlow and
protobuf are importable is printed, not gated), imported onto the card and
run on [16, 128] ids eagerly and as one CUDA graph from ``compile()``
(``graphed`` required; graph within 1e-6 of eager; positions 0-1 within 2e-4
of the JAX package's output on the CPU, the committed golden; float32
within 1e-4 of the graph with its float constants in float64); then
fine-tuned as ``bench.py`` does (``convert_to_variables``, a ``cls_W`` head,
``Adam(1e-5)``, 2 + 16 steps: loss finite and falling, one step's gradients
in float32 within 1e-3 of float64 by norm per variable); and a native
SameDiff ``multi_head_dot_product_attention`` graph on [8, 512, 768] with
ragged key masks through B1-B3 (``output()`` and 3 ``fit`` steps), held
against the attention seam's plain route (1e-4 / 1e-3).
Then the import slice, where neither h5py nor protobuf is used (whether
h5py, protobuf and onnx are importable is printed, not gated):
``keras.applications.ResNet50(weights=None)`` (224x224x3, 1000 classes,
nothing cut) read from the committed HDF5 skeleton by the port's own reader
(``deeplearning4j_tpu_torch/tools/keras_resnet50.py``, filled from seed 0)
and imported by ``KerasModelImport`` onto the card as a ``ComputationGraph``:
its pooled features and probabilities on 2 images held to the JAX package's
CPU output (2e-4 relative, 1e-4) and float32 to float64 (1e-4), then
``output()`` at batch 32 timed beside the zoo ResNet-50's, and 5
``GraphSolver.fit_batch`` steps (Adam 1e-4) through the imported MCXENT
``OutputLayer`` (score finite and falling; before the first step the score
f32 vs f64 within 1e-5 and the gradients within 0.1 by norm, batch norms'
f32 rounding amplified); and BERT-base's encoder (L 12, H 768, vocab 30522)
read from the committed ONNX skeleton by the port's own wire reader
(``tools/onnx_bert.py``, seed 0), imported by ``OnnxGraphMapper`` onto the
card and run on [16, 128] int64 ids with a ragged attention mask, eagerly
and as one CUDA graph (``graphed``; graph within 1e-6 of eager; positions
0-1 within 2e-4 of the JAX golden; f32 within 1e-4 of f64). These three
paths reach none of B1-B5 (the imported graphs spell attention as products
and a softmax, as in the JAX package); their launch counts enter ``paths``
all the same.
Then the rewrite slice (``nn/rewrite``): after the HTTP phase the
GPT-2-small-width LM is published to a ``ModelStore`` and deployed through
``ModelManager(optimize="inference:int8")`` (12 int8 decoder blocks; the
embeddings and the softmax head stay float32), served through ``output()``
on 8 x 1024 (B1), ``GenerationSession`` and ``DecodeEngine`` (B4 in the
step's CUDA graph), redeployed as ``"inference:fp8"`` and rolled back, its
int8 output held to the same int8 network in float64 through the plain
attention (1e-4), graph to eager (1e-6), cached decode to a full forward
(2e-3), beside the float32 model's numbers in the same call; after the
ONNX phase, the MoE network int8 (grouped dispatch through B5 against
sort), the zoo ResNet-50 under each rewrite (stem, fold, ``"inference"``,
``"inference:int8"``; images/s in turns, the float rewrites within 1e-4)
and 3 ``GraphSolver(optimize="training")`` steps beside plain ones (the
first score within 1e-4), the zoo LeNet with ``calibrate()`` ranges (the
card's int32 accumulators equal the CPU's), and the thirteen other zoo
models at their published input sizes, batch 8 (the JAX package's output
shapes, finite, the ``"inference"`` rewrite within 1e-4).
Then fault-tolerant training, on the GPT-2-small-width LM (12 blocks, f32,
``Adam(1e-4)``) through B1-B3: 8 steps from an in-memory iterator of 8
seeded [8, 1024] batches uninterrupted, again with an async
``CheckpointListener`` (every 4 iterations, keep 2, the iterator's cursor in
the sidecar), ``HeartbeatListener`` and an installed ``PreemptionHandler``
(params and scores bitwise the uninterrupted run's), and again restored from
the iteration-4 checkpoint into a fresh model (bitwise again), with the
step ms, the snapshot's ms on the step thread (beside pinned and pageable
copies of the same tensors), the writer's seconds and bytes per zip and the
restore seconds; the port's chaos harness
(``tools/check_training_resilience_contract.py``, ``"lm"``: the same widths
and [8, 1024] batches, cut to 2 blocks, since each child boot writes or
restores a ~1.1 GB zip)
under ``elastic_fit``, its SIGKILL, SIGTERM and stall legs each ending
bitwise on the uninterrupted leg's parameters, SIGTERM with no iteration
lost, with the goodput ratio, downtime by reason and child boot seconds;
``EarlyStoppingTrainer`` for 3 epochs of 2 batches (the best model's
recomputed held-out loss equal to ``best_model_score``, its tensors not the
live model's); and 6 steps under ``Solver(profiler=StepProfiler(
sync_every=2))`` beside 6 without (scores bitwise equal).
Then data-parallel training (``parallel/trainer.py``'s
``DistributedTrainer``): the GPT-2-small-width LM (12 blocks, f32,
``Adam(1e-4)``) at world size 1 over NCCL for 2 steps on [8, 1024] (params
bit for bit ``Solver.fit_batch``'s from the same weights and batches; 12
B1, B2 and B3 launches a step); two ranks sharing ``cuda:0`` over gloo
(NCCL refuses two ranks on one device), [4, 1024] each, one boot running
``SyncAllReduce``, ``BucketedAllReduceSync``, ZeRO-1 and
``ThresholdCompressedSync`` for 2 steps each (ranks bit for bit equal after
every leg, bucketed and ZeRO-1 bit for bit ``SyncAllReduce``, ZeRO-1's
updater bytes per rank the replicated bytes less half of every sliced
leaf's, ``SyncAllReduce`` within 6e-4 of world 1; ms a step and the
collectives' host-timed share); the zoo ResNet-50 on two ranks under
``ThresholdCompressedSync`` with ``bn_group_size=2``, batch 32 a rank, 2
steps (params and running statistics bit for bit equal across the ranks,
scores finite; ``BASELINE.json``'s gradient-sharing ResNet-50 cut to one
card); and the port's elastic resize harness
(``tools/check_elastic_resize_contract.py``, ``"lm"``: 2 blocks at full
width, [8, 1024], ZeRO-1, ``OrbaxCheckpointer``) resized 2 -> 1 -> 2 ranks
by two SIGKILLs, nothing consumed twice or skipped, and each resumed boot
restoring the killed boot's checkpoint bit for bit (width 2 -> 1, 1 -> 2).
Then pipeline and sequence parallelism (``parallel/pipeline.py``,
``PipelineParallelTrainer``, ``parallel/sequence.py``,
``parallel/sharded_embedding.py``), gloo ranks sharing ``cuda:0``
(``tools/pp_legs.py``): the GPT-2-small-width LM over two stages (6 blocks
each), [8, 1024] in 4 microbatches, 2 steps under 1F1B and 2 under GPipe,
held against the data-parallel world-1 run (``Solver.fit_batch``'s params)
within ``TOL_PP``, with three planted faults (a microbatch's loss dropped,
the last stage's update skipped, the head gradients unsummed over pipe)
read above it, and exactly 2·6·4 B1 and 6·4 B2 and B3 launches a step a
rank (the stash-and-rerun design); the 2-block float64 LM over pipe=2 x
data=2 on four ranks, replicated and ZeRO-1 (bit for bit equal), within
1e-10 of ``Solver``, its checkpoint restored into ``DistributedTrainer``
and ``Solver`` for their next step (1e-10); and on two ranks ring and
Ulysses attention at [8, 12, 1024, 64] and [1, 12, 16384, 64] in float32,
causal and not, and a cross-length causal ring, held against
``flash_attention`` on the whole sequence in one process, with a
50257 x 768 ``ShardedEmbeddingTable`` against a dense table. B1-B3 are
also held, at the ring's explicit causal offsets, against their plain
versions, and at the default offset bit for bit against an explicit
``tk - tq``. Then tensor and expert parallelism (``DistributedTrainer(
param_sharding_rules=...)``, ``parallel/tensor_parallel.py``), gloo ranks
sharing ``cuda:0`` (``tools/tp_legs.py``): the GPT-2-small-width LM
Megatron-split over two ranks (B1-B3 on 6 heads a rank), 2 steps held
against the world-1 run within ``TOL_TP``, with one step under each of
three planted faults (the row-parallel all-reduce skipped, *g*'s backward
a sum, *f*'s backward skipped) read above it; the MoE network's 8 experts
over two ranks (B5 over 4 a rank), grouped and sort, its gradients and
output held against the replicated network at the MoE phase's gates, two
planted faults read above; and in float64 over data=2 x model=2 the
2-block LM (``CLIP_L2_PER_LAYER``, Lamb) replicated and ZeRO-1 within
1e-10 of ``Solver``, its checkpoint restored into ``DistributedTrainer``
and ``Solver``, and the MoE network under ``BucketedAllReduceSync`` with
the expert rules, plain and ZeRO-1, within 1e-10 of it without them.
Then the periphery (``bench``, ``nlp``, ``ui``, ``rl``, ``arbiter``): the
zoo ``BertEncoder()`` at bert-base's widths pretrained by masked LM from
``BertIterator(task=UNSUPERVISED, max_length=512, batch_size=8,
mask_prob=0.15)`` over a generated 30522-entry WordPiece vocabulary and
seeded sentences that fill their rows, 8 ``GraphSolver.fit_batch`` steps
with the iterator's key and label masks (B1-B3) under ``StatsListener``
(``FileStatsStorage``, full stats every 4 iterations), ``ProfilingListener``
and ``NanPanicListener`` with a ``UIServer`` scraped during the run
(``/train/stats`` equal to the storage, ``/metrics``, 8 iterations in the
Chrome trace, the score falling), tokens/s and MFU against ``bench``'s
``chip_peak_flops(device, "float32")``; Word2Vec (negative sampling and
hierarchical softmax), GloVe and ParagraphVectors with 300-wide tables on
seeded Zipf corpora (``tools/embedding_reference.py``), each table within
``TOL_EMBED_REL`` (hierarchical softmax: ``TOL_EMBED_HS_REL``) of the same
fit on the CPU, run by a process of its own
started after the build; DQN with the rl4j CartPole example's settings and
A3C at ``A3CConfiguration()`` on CartPole, one DQN ``train_step`` and one
A3C update within ``TOL_RL_CARD`` of the CPU's; and an arbiter random
search over the zoo ``LeNet``'s learning rate from ``MnistDataSetIterator``
with a candidate whose factory raises.
Then, right after the HTTP phase and on its model, the port's eleven
contract harnesses (``deeplearning4j_tpu_torch/tools/check_*``: serving,
metrics, trace, pool, generate, registry, fabric, disagg, multiplex, input
pipeline, rewrite), each holding the JAX harness's gates on the card: the
seven serving ones behind the GPT-2-small-width LM (B1 on ``/v1/serving``,
B4 in the graphed decode steps), the registry and multiplexer on 2-block
models of its widths, the input pipeline on [128, 3, 224, 224] uint8
batches, the rewrite harness on its own graphs (phase "contract
harnesses"). The kernels build on a thread of their own while the phases
that launch none of B1-B5 run (the CNNs, the char-RNN, the iterator-fed
paths, the imported graphs, the rewrites, the zoo, RL and the arbiter);
the build's end is waited for before the first kernel phase.
Depth cut to keep the script near 1000 s with the periphery's phases
(every gate, fault leg and kernel launch kept):
``DP_STEPS`` 3 -> 2 (the world-1, two-rank, ResNet-50, pipelined,
pipe x data, tensor- and expert-parallel legs); ``/v1/serving`` rows
[1, 16] -> [1, ``SERVING_T``] (the answers' JSON held the phase); the
DQN's ``max_step`` 150000 -> ``DQN_MAX_STEP``; the embedding corpora cut in
tokens (not in table widths).
It times each kernel at its main path's
shape: B1, B2 and B3 in three rounds paired with SDPA's forward or
backward, B4 by device time (200 calls replayed from one CUDA graph), with
the host's time to issue a call printed apart, and B5 paired with a padded
``torch.bmm`` at the routed and a balanced load; and the new
instantiations at d = 256 and in f16 and f64. Then it prints the timings,
a ``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits with 2 and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import ctypes
import dataclasses
import http.client
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import importlib

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.core.listeners import TrainingListener
from deeplearning4j_tpu_torch.generate import GenerationSession
from deeplearning4j_tpu_torch.modelimport import KerasModelImport
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxGraphMapper
from deeplearning4j_tpu_torch.model.zoo import (BertEncoder, LeNet, ResNet50, TextGenerationLSTM,
                                                TransformerLM)
from deeplearning4j_tpu_torch import ops as fa
from deeplearning4j_tpu_torch.nn import (Activation, InputType, LossFunction,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (EmbeddingSequenceLayer, GlobalPoolingLayer,
                                                LayerContext, LearnedSelfAttentionLayer,
                                                MixtureOfExpertsLayer, OutputLayer, PoolingType)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.rewrite import (BatchNormAffinePass, ConvBatchNormFoldPass,
                                                 QuantizedDenseLayer, QuantizeWeightsPass,
                                                 RewritePass, SpaceToDepthStemPass, calibrate,
                                                 count_quantized_layers, rewrite_model)
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import model_bytes as serving_model_bytes
from deeplearning4j_tpu_torch.samediff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.samediff.tf_import import TFGraphMapper
from deeplearning4j_tpu_torch.ops import cuda_build, helpers
from deeplearning4j_tpu_torch.tools import bert_skeleton, keras_resnet50, onnx_bert
from deeplearning4j_tpu_torch.tools import kernel_variants as kv
from deeplearning4j_tpu_torch.tools.moe_profile import MOE_LAYER, moe_lm_conf
from deeplearning4j_tpu_torch.tools.serving_profile import _device_profile
from deeplearning4j_tpu_torch.train import Solver
from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver
from deeplearning4j_tpu_torch.train.updaters import Adam

# the module (ops/__init__ exports a function of this name): the timings call
# the kernels' wrappers directly, without the delta pass around them
fa_mod = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")
gm_mod = importlib.import_module("deeplearning4j_tpu_torch.ops.grouped_matmul")

SEED = 1234
B, H, D = 8, 12, 64          # the serving shapes: batch 8, GPT-2 small's heads
T_FULL = 1024                 # output() prompt length = max_len
MAX_TOKENS = 64
LONG_L = 4096                 # the decode kernel's long-cache case: one (b, h) pair of rows
# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth; dense TF32 on
# the tensor cores, of which a float32-accurate product takes three (the
# 3xTF32 split: the fastest float32-accurate product the card offers, and the
# float32 bound); float32 on the CUDA cores, printed beside it for
# continuity; bf16 dense on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
CUDA_CORE_F32_FLOPS = 67e12
# float64 on the CUDA cores: 67 TFLOP/s with the tensor cores' DMMA, which
# the float64 kernels do not use, 34 TFLOP/s without (data sheet).
PEAK_FLOPS = {torch.float32: TF32_FLOPS / 3, torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float64: 34e12}
# Kernel vs plain version, max abs error allowed. float32: both sides
# compute in float32 and differ only in summation order. bfloat16 and
# float16: both widen the same 16-bit inputs to float32, so they differ by
# the rounding of the output, one ulp at |out| < 4 (2^-6 in bf16, 2^-9 in
# f16); lse stays float32. float64: both compute in float64, in another
# order (~1e-15 relative).
TOL_OUT = {torch.float32: 5e-5, torch.bfloat16: 1.6e-2, torch.float16: 2e-3,
           torch.float64: 1e-10}
TOL_LSE = {torch.float32: 1e-4, torch.bfloat16: 1e-4, torch.float16: 1e-4,
           torch.float64: 1e-10}
# Backward kernels vs plain versions, max abs error over the largest |value|
# of the plain gradient. float32: both sum up to t = 1024 terms in float32,
# in another order, the kernels of 3xTF32 products exact to ~2^-21.
# bfloat16 and float16: both round float32 sums to the 16-bit type, so they
# may differ by one ulp at the largest value (2^-7 of it in bf16, 2^-10 in
# f16). float64: float64 sums in another order.
TOL_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7 + 1e-4,
               torch.float16: 2.0 ** -10 + 1e-4, torch.float64: 1e-10}
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
# Model gradients through the kernels vs through materialised scores and
# plain autograd, per parameter, max abs error over the parameter's largest
# |gradient|. Both run in float32; the attention sums differ in order in each
# of 12 layers, which moves gradients by ~1e-5 of their scale. A gradient that
# skipped attention (no backward through the kernel) misses by ~1.
TOL_GRAD_REL = 1e-3
TRAIN_STEPS = 5
# B5 vs its plain version, max abs error over the largest |value| of the
# plain output. float32: the path's CUDA-core kernel sums the d products by
# fmaf in k order, as cuBLAS's float32 product in the plain version does;
# the 3xTF32 tensor-core kernel timed beside it drops a_lo·b_lo and the
# bits below lo (~2^-21 of each product) and sums in another order, so it
# does not agree with the plain version bit for bit. bfloat16 and float16:
# both sum the
# exact products of the 16-bit inputs in float32 and round once, so they may
# differ by one ulp at the largest value (2^-7 in bf16, 2^-10 in f16).
# float64: float64 sums in another order.
TOL_GMM_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7 + 1e-4,
               torch.float16: 2.0 ** -10 + 1e-4, torch.float64: 1e-10}
# The head-dim-256 LM (C1) against the materialised-scores seam, both in
# float32: output probabilities, max abs error over the largest (as the MoE
# network's grouped-vs-sort check). The attention sums differ in order and
# by 3xTF32 rounding (~1e-6 relative), in 2 blocks.
TOL_OUT_REL = 1e-4
# The float16 LM against the materialised-scores seam in float16: output and
# decode-step probabilities, max abs error over the largest. float16 keeps
# 11 significant bits (unit roundoff 2^-11 = 4.9e-4). The reference rounds
# the scores, the softmax weights and the attention output to float16 in
# each of 12 blocks, where the kernels sum in float32 and round once: ~40
# roundings of 2^-11, which float16 residual adds and LayerNorms carry to
# the logits, hence 2e-2.
TOL_F16_REL = 2e-2
# The float64 paths (LM output, gradients, one Adam step, decode; the MoE
# layer through B5) against the reference seams: float64 sums in another
# order, ~1e-15 relative; 1e-10 leaves room for 2 blocks and one step.
TOL_F64_REL = 1e-10
# The CNN phases. "cudnn" against "im2col" on one network's output(), max
# abs error over the largest probability: both sum the same float32
# products in another order in every convolution (~1e-7 relative each).
TOL_CONV_HELPERS = 1e-5
# ResNet-50 output() in float32 on the card against the same weights in
# float64 on the CPU, max abs error over the largest value of the pooled
# features, the logits and the probabilities: float32 rounding through 53
# convolutions and batch norms in inference (~1e-6 relative). A TF32
# convolution keeps 10 mantissa bits (~5e-4 relative a product) and misses
# this (4.0e-4 on the features, 1.1e-4 on the probabilities of an H100 80GB
# HBM3 at 700 W with the guard off).
TOL_F32_VS_F64 = 1e-4
LENET_BATCH, LENET_STEPS = 64, 20
RESNET_BATCH = 32
BERT_BATCH, BERT_T = 8, 512
# The MoE layer's widths (the JAX package's MoE dispatch benchmark) and its
# capacity at 8 x 1024 tokens: ceil(2 * 8192 / 8 * 1.25) = 2560 = m_pad.
E_MOE, H_MOE, TOPK, CAPACITY = 8, 1536, 2, 2560
# Cached decode vs full forward, max abs error of the log-probs. Both run in
# float32 through different kernels and matrix shapes; float32 rounding
# moves log-probs near -10.8 by ~1e-5. A bfloat16 model would miss this by
# an order of magnitude: one bf16 rounding of an activation is ~4e-3 relative.
TOL_LOGPROB = 2e-3
# The int8 KV cache against float32, teacher-forced. An int8 slot of absmax
# a has the step a/127, so each dequantized K or V entry is within a/254 of
# the float one: 1/254 of its slot's magnitude. Taken linearly, a first-order
# estimate and not a proof, each of the model's attention layers can move the
# logits by that share of what attention contributes, once through K and
# once through V; so the gate is 2 x blocks / 254 of the largest logit spread
# above the mean (0.094 for 12 blocks). A scale applied twice or not at all
# moves the log-probs by the whole spread.
INT8_STEP_REL = 1 / 254
# POST /v1/serving against output() on the same row, max abs error over the
# largest probability. The server batches the 8 clients' rows into one
# forward, output() runs one row: the same float32 arithmetic per row (B1
# and the layer norms work row by row), but the dense products may take
# other cuBLAS blockings for another batch (~1e-7 relative).
TOL_HTTP_REL = 1e-5
# The hot-swap check's depth (GPT-2 small's widths, 2 of its 12 blocks): two
# published versions of 2 blocks take 2 x 0.37 GB of disk and load in
# seconds; 12 blocks would take 2 x 0.65 GB.
SWAP_LAYERS = 2
# the hot swap's clients pause this long between requests (see phase_http)
SWAP_CLIENT_PAUSE_S = 0.25
# The char-RNN (BASELINE.json:9; the JAX package's bench.py:396-433): the zoo
# TextGenerationLSTM's defaults (vocab 77, hidden 200, 2 GravesLSTM layers,
# TBPTT 50), batch 32 of 200 characters = 4 windows a batch.
CHAR_V, CHAR_BATCH, CHAR_T, CHAR_BATCHES = 77, 32, 200, 5
CHAR_GEN_TOKENS, CHAR_MAX_LEN = 200, 512
# output() in float32 on the card against the same weights in float64 on the
# CPU, max abs error over the largest probability: 200 steps of two layers'
# float32 gates (products of 77-200 terms, ~2^-24 relative each); the
# forget gate (< 1) damps what a step carries forward, so the error stays
# near one step's, ~1e-6. A TF32 product (2^-11 = 4.9e-4 a product) misses.
TOL_LSTM_F32_VS_F64 = 1e-4
# rnn_time_step one character at a time against output() over the sequence,
# and greedy characters against a teacher-forced full forward: the same
# float32 operations, with other matrix shapes (one step's [32, 77] input
# projection against all 200 steps' [6400, 77]), so cuBLAS may sum in
# another order: float32 rounding, relative to the largest probability (and
# on log-probs near -4.3, absolute).
TOL_STREAM_REL = 1e-5
TOL_CHAR_LOGPROB = 1e-4
# The LearnedSelfAttention network (a BERT-width embedding, 12 heads of 64,
# 8 learned queries over 512 keys, a pooled 10-way softmax), batch 8.
LSA_VOCAB, LSA_CLASSES, LSA_QUERIES = 30522, 10, 8
# The bf16 compute_dtype LM against the bf16 materialised-scores seam,
# output probabilities, max abs error over the largest. The float16 gate
# (TOL_F16_REL, 2e-2 for 11 significant bits) scaled by bfloat16's 3 fewer
# bits (2^3): the seam rounds scores, softmax weights and the attention
# output to bfloat16 (unit roundoff 2^-8) in each of 12 blocks, the kernels
# round once. The rest of the network runs the same bf16 operations on both
# sides. Gradients, per parameter over its largest |gradient|: the same
# roundings, carried back through 12 blocks twice (B2 and B3).
TOL_BF16_REL = 0.16
TOL_BF16_GRAD_REL = 0.16
BF16_STEPS = 3
# Gradient checkpointing: first loss equal to 1e-6 relative (the same float32
# forward, recomputed); gradients within 1e-4 of each parameter's largest.
# B2/B3 own their output tiles (no atomics), but the embeddings' backward
# accumulates rows with atomics in no fixed order, so two runs without
# checkpointing may differ too: the phase prints that gap beside the gate.
TOL_REMAT_LOSS_REL = 1e-6
TOL_REMAT_GRAD_REL = 1e-4
# The device sampler's chi-square against the softmax over a small fixed
# vocabulary (8 tokens, 7 degrees of freedom): 24.32 is its 0.999 quantile.
CHI2_DF7_999 = 24.32
# bf16 compute_dtype generation: a greedy token's log-prob below its
# position's maximum in a full bf16 forward (bf16 keeps 3 fewer mantissa
# bits than the gates of the float32 decode, TOL_LOGPROB 2e-3)
TOL_BF16_LOGPROB = 2e-2
# LeNet from MnistDataSetIterator: the JAX package's accuracy with the same
# recipe on the CPU (tools/jax_lenet_mnist_accuracy.py, seed 1234: 0.99072265625)
# less 0.05, and never below 0.5
LENET_JAX_ACCURACY = 0.99072265625
LENET_ACC_GATE = max(0.5, LENET_JAX_ACCURACY - 0.05)
LENET_TRAIN = 12800
FILE_PASSES = 2               # timed passes over the 512 files after the warm-up pass
# The SameDiff TF-import BERT-base (bench.py:457-573 at its sizes): batch and
# length of the ids, timing rounds and calls a round, fine-tune steps, and
# the SameDiff attention phase's fit steps.
BERT_IMPORT_B, BERT_IMPORT_T = 16, 128
SD_ROUNDS, SD_CALLS, SD_TRAIN_STEPS, SD_ATT_STEPS = 5, 5, 16, 3
# compile()'s CUDA graph against eager output(): the same kernels on the same
# inputs, max abs error.
TOL_SD_GRAPH = 1e-6
# Positions 0-1 of the imported BERT against the JAX package's float32 output
# on the CPU (tools/make_bert_skeleton.py), max abs error: float32 rounding
# through 12 layers (outputs of magnitude ~1 after LayerNorm), summed in
# another order by cuBLAS than by XLA on the CPU (~1e-6 a layer).
TOL_SD_GOLDEN = 2e-4
# One fine-tune step's gradients in float32 against float64 on the card, per
# variable: norm of the difference over the norm of the float64 gradient, or
# over SD_GRAD_FLOOR of the largest variable's where its own is smaller. The
# key biases' exact gradient is 0 (softmax ignores a shift shared by every
# key), so theirs is float rounding alone (~1e-8 of the largest in float32).
TOL_SD_GRAD_F64 = 1e-3
SD_GRAD_FLOOR = 1e-4
#: tokens/s of each float32 engine of phase_engine, for the bf16 phase's print
ENGINE_TPS = {}
#: images/s of the zoo ResNet-50's output() (phase_resnet50), for the Keras
#: ResNet-50 phase's print
RESNET_IMAGES_PER_S = {}
# The Keras-applications ResNet-50 against the JAX package's float32 output
# on the CPU (tools/make_keras_resnet50_skeleton.py) on 2 images: the pooled
# features, max abs error over the largest (float32 rounding through 53
# convolutions and batch norms, summed by cuDNN in another order than XLA on
# the CPU, ~1e-6 relative); the probabilities (top 0.068, not saturated),
# max abs error.
TOL_KERAS_FEATURES, TOL_KERAS_PROBS = 2e-4, 1e-4
KERAS_FT_STEPS, KERAS_GRAD_BATCH = 5, 8
# The imported ResNet-50's first fine-tune step in float32 against float64 on
# the card, batch norms in training mode. The score: float32 rounding of one
# forward (~1e-6 relative). The gradients, per parameter by norm (the
# SameDiff fine-tune's rule, TOL_SD_GRAD_F64's floor): each of 53 batch
# norms' backward subtracts the batch means of its incoming gradient, which
# nearly cancel, so float32 rounding grows on the way back to the stem: the
# JAX package's own float32 gradients on the CPU miss float64 by 3.2e-2
# (tools/keras_resnet50_grad_precision.py, the whole vector 2.7e-2), the
# port's by 2.1e-2. 0.1 holds the rounding and catches a lost or wrong
# backward term (an error of order 1).
TOL_KERAS_SCORE_F64, TOL_KERAS_GRAD_F64 = 1e-5, 0.1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def host_us(fn, calls: int) -> float:
    """Host microseconds a call to issue ``fn`` (no synchronisation inside
    the window; the queue is drained before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def roofline(flops: float, nbytes: float, dtype) -> tuple:
    """(bound ms, what binds): the larger of the operations at the peak rate
    of ``dtype`` and the bytes at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cuda_core_note(flops: float, dtype) -> str:
    """The float32 CUDA-core bound, printed beside a float32 row's bound."""
    if dtype != torch.float32:
        return ""
    return f"; CUDA-core f32 bound {1e3 * flops / CUDA_CORE_F32_FLOPS:.4f} ms"


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, taken in float64 (so float64 results keep their
    digits)."""
    return float((a.double() - b.double()).abs().max())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_err(a, b) / max(float(b.double().abs().max()), 1e-30)


def phase_device() -> str:
    """Prints and returns the card's name and power limit."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def _demangle(names: list) -> list:
    """C++ names of mangled kernel symbols (cu++filt or c++filt), or the
    symbols as they are when neither tool is found."""
    tool = (shutil.which("cu++filt") or shutil.which("c++filt")
            or "/usr/local/cuda/bin/cu++filt")
    try:
        out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names
    return [re.sub(r"\(anonymous namespace\)::", "", n) for n in out]


def start_build():
    """Starts building every kernel source (one ``nvcc`` a source, all at
    once) and then reading each library's SASS on a thread of its own, so
    that the phases which launch none of the kernels run meanwhile:
    (thread, result box)."""
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["libs"] = cuda_build.build_all()
            box["seconds"] = time.perf_counter() - t0
            stems = sorted(box["libs"])
            with concurrent.futures.ThreadPoolExecutor(len(stems)) as pool:  # a cuobjdump each
                box["sass"] = dict(zip(stems, pool.map(_sass_counts, stems)))
            box["sass_seconds"] = time.perf_counter() - t0 - box["seconds"]
        except BaseException as e:  # noqa: BLE001 — re-raised by phase_build
            box["error"] = e

    th = threading.Thread(target=run, name="kernel-build", daemon=True)
    th.start()
    return th, box


def phase_build(build) -> None:
    """Waits for the build ``start_build`` began, raises its error if it
    failed, and prints each instantiation's ptxas registers, spills and
    static shared memory."""
    th, box = build
    th.join()
    if "error" in box:
        raise box["error"]
    print(f"build: {sorted(box['libs'])} in {box['seconds']:.2f} s (the kernel-free "
          f"phases ran meanwhile)")
    for stem, log in sorted(cuda_build.build_logs.items()):
        names, stats = [], []
        for line in log.splitlines():
            if "Compiling entry function" in line:  # the mangled kernel name
                names.append(line.split(chr(39))[1])
                stats.append("")
            elif names and ("registers" in line or "spill" in line):
                stats[-1] += " " + line.split(":", 2)[-1].strip()
        for name, stat in zip(_demangle(names), stats):
            print(f"  ptxas {stem} {name}:{stat}")


def _sass_counts(stem: str) -> dict:
    """HMMA and atomic instructions per function in the SASS of the library
    built from ``csrc/<stem>.cu`` (``phase_sass`` prints them)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = cuda_build._lib_path(cuda_build.CSRC / f"{stem}.cu")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    atomic = re.compile(r"\b(ATOMG?|ATOMS|RED)\b")
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HMMA": 0, "atomics": 0}
        elif fn is not None:
            counts[fn]["HMMA"] += "HMMA" in line
            # the substring test first, the regex only where it can match
            if ("ATOM" in line or "RED" in line) and atomic.search(line):
                counts[fn]["atomics"] += 1
    return counts


def phase_sass(build) -> None:
    """The flash forward and backward kernels and B5's tensor-core kernels
    run their products on the tensor cores, and no kernel has
    atomics: counted per function (each instantiation) in the built
    libraries' SASS. Instantiations: B2/B3 and B1 at 3 dtypes x 4 widths
    (DMAX 32 to 256), B4 at 3 x 4 x 2 load paths, the float64 B1-B4 at 4
    widths each; B5's tensor-core kernel in bf16, f16 and float32 (3xTF32,
    timed beside the path's kernel), its float32 CUDA-core kernel (2 load
    paths) and its float64 one. The counts come from the build's thread."""
    sass = build[1]["sass"]
    print(f"sass: read in {build[1]['sass_seconds']:.2f} s on the build's thread")
    for stem, counts in sass.items():
        for fn, c in counts.items():
            print(f"  sass {stem} {fn}: {c['HMMA']} HMMA, {c['atomics']} atomics")
    bwd = sass["flash_backward"]
    check(len(bwd) == 24 and all(c["HMMA"] > 0 and c["atomics"] == 0 for c in bwd.values()),
          "every backward kernel must run HMMA and no atomics")
    fwd = sass["flash_forward"]
    check(len(fwd) == 12 and all(c["HMMA"] > 0 and c["atomics"] == 0 for c in fwd.values()),
          "every forward kernel must run HMMA and no atomics")
    dec = sass["flash_decode"]
    check(len(dec) == 24 and all(c["atomics"] == 0 for c in dec.values()),
          "the decode kernels must have no atomics")
    f64 = sass["flash_f64"]
    check(len(f64) == 16 and all(c["atomics"] == 0 for c in f64.values()),
          "the float64 attention kernels must have no atomics")
    gmm = sass["grouped_matmul"]
    tc = [c for fn, c in gmm.items() if "grouped_matmul_tc_kernel" in fn]
    check(len(gmm) == 6 and len(tc) == 3 and all(c["HMMA"] > 0 for c in tc)
          and all(c["atomics"] == 0 for c in gmm.values()),
          "B5's tensor-core kernels (bf16, f16 and the float32 3xTF32 one) must run HMMA, "
          "and no B5 kernel atomics")


def _key_mask(gen, tk: int) -> torch.Tensor:
    """Ragged [B, tk] key mask; row 3 is fully masked."""
    lens = torch.randint(1, tk + 1, (B,), generator=gen)
    mask = (torch.arange(tk)[None, :] < lens[:, None]).float()
    mask[3] = 0.0
    return mask


def phase_flash_forward(gen) -> dict:
    worst = 0.0
    cases = [(t, t, c, m) for t in (128, T_FULL) for c in (False, True) for m in (False, True)]
    cases.append((128, T_FULL, True, True))  # tq < tk, causal bottom-right aligned
    for dtype in (torch.float32, torch.bfloat16):
        for tq, tk, causal, masked in cases:
            q = torch.randn(B, H, tq, D, generator=gen).to("cuda", dtype)
            k = torch.randn(B, H, tk, D, generator=gen).to("cuda", dtype)
            v = torch.randn(B, H, tk, D, generator=gen).to("cuda", dtype)
            mask = _key_mask(gen, tk).cuda() if masked else None
            out, lse = fa.flash_attention(q, k, v, mask, causal, return_lse=True)
            p_out, p_lse = fa.flash_attention_plain(q, k, v, mask, causal)
            x_out, x_lse = fa.flash_attention(q, k, v, mask, causal, return_lse=True,
                                              causal_offset=tk - tq)
            torch.cuda.synchronize()
            check(torch.equal(out, x_out) and torch.equal(lse, x_lse),
                  "B1 at the default causal offset must equal an explicit tk - tq bit for bit")
            e_out, e_lse = max_err(out, p_out), max_err(lse, p_lse)
            print(f"flash_forward {str(dtype)[6:]:8s} tq={tq:4d} tk={tk:4d} "
                  f"causal={causal!s:5s} mask={masked!s:5s}: out max_abs={e_out:.3e} "
                  f"rel={rel_err(out, p_out):.3e} (tol {TOL_OUT[dtype]:g}), "
                  f"lse max_abs={e_lse:.3e} (tol {TOL_LSE[dtype]:g})")
            check(e_out <= TOL_OUT[dtype] and e_lse <= TOL_LSE[dtype],
                  "flash_forward disagrees with its plain version")
            if masked:
                check(bool((out[3] == 0).all()) and bool((lse[3] == 1e30).all()),
                      "fully masked row must give 0 and lse +1e30")
            if dtype == torch.float32:
                worst = max(worst, e_out, e_lse)
    # the ring's blocks: rank i's queries against block src at the offset
    # i·tq + n·(tk - tq) - src·tk (n = 2 ranks of [8, 12, 1024, 64], and the
    # cross-length ring, tq 512 / tk 1024 split over 2)
    for dtype in (torch.float32, torch.bfloat16):
        for tq, tk, off in ((512, 512, 0), (512, 512, 512), (256, 512, 256), (256, 512, 768),
                            (256, 512, -256)):
            q = torch.randn(B, H, tq, D, generator=gen).to("cuda", dtype)
            k = torch.randn(B, H, tk, D, generator=gen).to("cuda", dtype)
            v = torch.randn(B, H, tk, D, generator=gen).to("cuda", dtype)
            out, lse = fa.flash_attention(q, k, v, None, True, return_lse=True,
                                          causal_offset=off)
            p_out, p_lse = fa.flash_attention_plain(q, k, v, None, True, causal_offset=off)
            torch.cuda.synchronize()
            e_out, e_lse = max_err(out, p_out), max_err(lse, p_lse)
            print(f"flash_forward {str(dtype)[6:]:8s} tq={tq:4d} tk={tk:4d} causal offset "
                  f"{off:5d}: out max_abs={e_out:.3e}, lse max_abs={e_lse:.3e}")
            check(e_out <= TOL_OUT[dtype] and e_lse <= TOL_LSE[dtype],
                  "flash_forward at an explicit causal offset disagrees with its plain version")
            if dtype == torch.float32:
                worst = max(worst, e_out, e_lse)

    # timing at the main path's shape: output() on [8, 1024], causal, no mask;
    # B1 and SDPA's forward back to back, three rounds, so the comparison is paired
    row = {"max_abs_err": worst}
    pairs = B * H * T_FULL * (T_FULL + 1) // 2  # (q, k) pairs the causal mask keeps
    flops = 4 * D * pairs
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(B, H, T_FULL, D, generator=gen).to("cuda", dtype)
                   for _ in range(3))
        rounds = {"flash_forward": [], "sdpa": []}
        for _ in range(3):
            rounds["flash_forward"].append(
                kv.ms(lambda: fa.flash_attention(q, k, v, causal=True), 10))
            rounds["sdpa"].append(
                kv.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 10))
        ms, lib_ms = (float(np.median(rounds[n])) for n in ("flash_forward", "sdpa"))
        plain_ms = kv.ms(lambda: fa.flash_attention_plain(q, k, v, causal=True), 5)
        nbytes = (4 * B * H * T_FULL * D) * q.element_size() + B * H * T_FULL * 4
        bound_ms, bound_by = roofline(flops, nbytes, dtype)
        print(f"flash_forward {str(dtype)[6:]} [8,12,1024,64] causal, 3 paired rounds (ms): "
              + "; ".join(f"{n} {[round(x, 4) for x in r]}" for n, r in rounds.items())
              + f"; medians: kernel {ms:.4f} ms against sdpa {lib_ms:.4f} ms "
              f"({ms / lib_ms:.2f}x); plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB"
              f"{cuda_core_note(flops, dtype)})")
        if dtype == torch.float32:
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
    return row


def phase_flash_decode(gen, decode_pos) -> dict:
    """B4 against its plain version at the serving shape and at one (b, h)
    pair of rows against a long cache (where the split over a cluster
    matters), then timed: device time from a CUDA graph of many calls, and
    apart from it the host's time to issue a call."""
    L = T_FULL
    worst = 0.0
    start = torch.tensor([-1, 0, 37, 511, 1023, 100, 300, 700], dtype=torch.int32).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, H, 1, D, generator=gen).to("cuda", dtype)
        k = torch.randn(B, H, L, D, generator=gen).to("cuda", dtype)
        v = torch.randn(B, H, L, D, generator=gen).to("cuda", dtype)
        out = fa.flash_decode_attention(q, k, v, start)
        ref = fa.flash_decode_attention_plain(q, k, v, start)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        print(f"flash_decode {str(dtype)[6:]:8s} L={L} start_pos={start.tolist()}: "
              f"max_abs={e:.3e} rel={rel_err(out, ref):.3e} (tol {TOL_OUT[dtype]:g})")
        check(e <= TOL_OUT[dtype], "flash_decode disagrees with its plain version")
        check(bool((out[0] == 0).all()), "start_pos -1 must give 0")
        if dtype == torch.float32:
            worst = max(worst, e)
        # one (b, h) pair of rows against a long cache: all, one or no live key
        q1 = torch.randn(1, 2, 1, D, generator=gen).to("cuda", dtype)
        k1 = torch.randn(1, 2, LONG_L, D, generator=gen).to("cuda", dtype)
        v1 = torch.randn(1, 2, LONG_L, D, generator=gen).to("cuda", dtype)
        for sp in (-1, 0, LONG_L - 1, LONG_L + 100):
            pos1 = torch.tensor([sp], dtype=torch.int32).cuda()
            out = fa.flash_decode_attention(q1, k1, v1, pos1)
            ref = fa.flash_decode_attention_plain(q1, k1, v1, pos1)
            torch.cuda.synchronize()
            e = max_err(out, ref)
            print(f"flash_decode {str(dtype)[6:]:8s} [1,2,1,{D}] L={LONG_L} start_pos={sp}: "
                  f"max_abs={e:.3e} (tol {TOL_OUT[dtype]:g})")
            check(e <= TOL_OUT[dtype] and bool(torch.isfinite(out).all()),
                  "flash_decode disagrees with its plain version on a long cache")
            check(sp >= 0 or bool((out == 0).all()), "start_pos -1 must give 0")
            if dtype == torch.float32:
                worst = max(worst, e)

    # timing at the main path's shape: one decode step at the smoke's
    # mid-generation positions; 4 caches in turn (200 MB in f32) so each
    # call finds its cache outside the 50 MB L2, as a layer's step does
    pos = torch.tensor(decode_pos, dtype=torch.int32).cuda()
    row = {"max_abs_err": worst}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, H, 1, D, generator=gen).to("cuda", dtype)
        caches = [(torch.randn(B, H, L, D, generator=gen).to("cuda", dtype),
                   torch.randn(B, H, L, D, generator=gen).to("cuda", dtype)) for _ in range(4)]
        keep = (torch.arange(L, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
        it = iter(range(1 << 30))

        def turn(fn):
            c = caches[next(it) % 4]
            return fn(c[0], c[1])

        kernel = lambda: turn(lambda kk, vv: fa.flash_decode_attention(q, kk, vv, pos))  # noqa: E731
        ms = kv.graph_ms(kernel, 200)
        prof_ms, seen = kv.kernel_ms(kernel, "flash_decode_kernel", 200)
        check(seen > 0, "the profiler saw no flash_decode kernel")
        events_ms = kv.ms(kernel, 200)
        issue_us = host_us(kernel, 200)
        plain_ms = kv.graph_ms(lambda: turn(
            lambda kk, vv: fa.flash_decode_attention_plain(q, kk, vv, pos)), 50)
        lib_ms = kv.graph_ms(lambda: turn(lambda kk, vv: F.scaled_dot_product_attention(
            q, kk, vv, attn_mask=keep)), 200)
        keys = int((pos.long() + 1).sum()) * H  # cached positions this step reads
        nbytes = (2 * keys * D + 2 * B * H * D) * q.element_size() + B * 4
        flops = 4 * D * keys
        bound_ms, bound_by = roofline(flops, nbytes, dtype)
        print(f"flash_decode {str(dtype)[6:]} [8,12,1,64] vs L={L} at start_pos="
              f"{decode_pos}, device time a call from a CUDA graph of 200: kernel {ms:.5f} ms "
              f"(profiler, each launch alone: {prof_ms:.5f} ms over {seen} launches), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; "
              f"{nbytes / 1e6:.2f} MB); host {issue_us:.1f} us to issue a call; CUDA events "
              f"around back-to-back calls {events_ms:.5f} ms a call")
        if dtype == torch.float32:
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        del caches
    # the long cache, every position live
    q1 = torch.randn(1, 2, 1, D, generator=gen).cuda()
    k1, v1 = (torch.randn(1, 2, LONG_L, D, generator=gen).cuda() for _ in range(2))
    pos1 = torch.tensor([LONG_L - 1], dtype=torch.int32).cuda()
    ms1 = kv.graph_ms(lambda: fa.flash_decode_attention(q1, k1, v1, pos1), 200)
    bound1, _ = roofline(4 * D * 2 * LONG_L, (2 * 2 * LONG_L * D + 4 * D) * 4 + 4,
                         torch.float32)
    print(f"flash_decode float32 [1,2,1,{D}] vs L={LONG_L} at start_pos={LONG_L - 1}: kernel "
          f"{ms1:.5f} ms of device time (CUDA graph), bound {bound1:.5f} ms (bytes; the 4 MB "
          f"cache stays in L2 between calls)")
    return row


def phase_flash_backward(gen) -> dict:
    """B2 and B3 against their plain versions at the forward phase's cases,
    then timed at the training path's shape."""
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(t, t, c, m) for t in (128, T_FULL) for c in (False, True) for m in (False, True)]
    cases.append((128, T_FULL, True, True))  # tq < tk, causal bottom-right aligned
    for dtype in (torch.float32, torch.bfloat16):
        for tq, tk, causal, masked in cases:
            q = torch.randn(B, H, tq, D, generator=gen).to("cuda", dtype)
            k = torch.randn(B, H, tk, D, generator=gen).to("cuda", dtype)
            v = torch.randn(B, H, tk, D, generator=gen).to("cuda", dtype)
            g = torch.randn(B, H, tq, D, generator=gen).to("cuda", dtype)
            mask = _key_mask(gen, tk).cuda() if masked else None
            out, lse = fa.flash_attention_plain(q, k, v, mask, causal)
            dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, g, mask, causal)
            explicit = fa.flash_attention_bwd(q, k, v, out, lse, g, mask, causal,
                                              causal_offset=tk - tq)
            check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), explicit)),
                  "B2/B3 at the default causal offset must equal an explicit tk - tq bit for bit")
            delta = torch.sum(g.float() * out.float(), dim=-1)
            args = (q, k, v, g, lse, delta, mask, causal)
            p_dq = fa.flash_attention_bwd_dq_plain(*args)
            p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(*args)
            torch.cuda.synchronize()
            errs = {"dq": (dq, p_dq), "dk": (dk, p_dk), "dv": (dv, p_dv)}
            rel = {n: rel_err(a, b) for n, (a, b) in errs.items()}
            print(f"flash_backward {str(dtype)[6:]:8s} tq={tq:4d} tk={tk:4d} "
                  f"causal={causal!s:5s} mask={masked!s:5s}: " + ", ".join(
                      f"{n} max_abs={max_err(a, b):.3e} rel={rel[n]:.3e}"
                      for n, (a, b) in errs.items()) + f" (rel tol {TOL_BWD_REL[dtype]:.3g})")
            check(max(rel.values()) <= TOL_BWD_REL[dtype],
                  "flash backward disagrees with its plain version")
            if masked:
                check(all(bool((x[3] == 0).all()) for x in (dq, dk, dv)),
                      "a fully masked row must give zero gradients")
            if dtype == torch.float32:
                worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], max_err(dq, p_dq))
                worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], max_err(dk, p_dk),
                                             max_err(dv, p_dv))

    # the ring's backward blocks (the forward phase's offsets), with the
    # row's lse and delta from the whole sequence, as the ring passes them
    for dtype in (torch.float32, torch.bfloat16):
        for tq, tk, off in ((512, 512, 512), (256, 512, 768), (256, 512, 256)):
            q, k, v, g = (torch.randn(B, H, t, D, generator=gen).to("cuda", dtype)
                          for t in (tq, tk, tk, tq))
            out, lse = fa.flash_attention_plain(q, k, v, None, True, causal_offset=off)
            delta = torch.sum(g.float() * out.float(), dim=-1).contiguous()
            args = (q, k, v, g, lse, delta, None, True, D ** -0.5, off)
            got = (fa_mod._flash_bwd_dq_cuda(*args), *fa_mod._flash_bwd_dkv_cuda(*args))
            want = (fa.flash_attention_bwd_dq_plain(*args),
                    *fa.flash_attention_bwd_dkv_plain(*args))
            torch.cuda.synchronize()
            rel = [rel_err(a, b) for a, b in zip(got, want)]
            print(f"flash_backward {str(dtype)[6:]:8s} tq={tq:4d} tk={tk:4d} causal offset "
                  f"{off:5d}: rel dq/dk/dv {['%.3e' % r for r in rel]}")
            check(max(rel) <= TOL_BWD_REL[dtype],
                  "B2/B3 at an explicit causal offset disagree with their plain versions")

    # timing at the training path's shape: [8, 12, 1024, 64], causal, no mask
    rows = {n: {"max_abs_err": w} for n, w in worst.items()}
    pairs = B * H * T_FULL * (T_FULL + 1) // 2  # (q, k) pairs the causal mask keeps
    n_in = B * H * T_FULL * D  # values in each of q, k, v, g
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (torch.randn(B, H, T_FULL, D, generator=gen).to("cuda", dtype)
                      for _ in range(4))
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        delta = torch.sum(g.float() * out.float(), dim=-1)
        args = (q, k, v, g, lse, delta, None, True)
        scale = D ** -0.5
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        timed = {
            # name: (kernel, plain version, products, values written)
            "flash_bwd_dq": (lambda: fa_mod._flash_bwd_dq_cuda(*args, scale),
                             lambda: fa.flash_attention_bwd_dq_plain(*args), 3, 1),
            "flash_bwd_dkv": (lambda: fa_mod._flash_bwd_dkv_cuda(*args, scale),
                              lambda: fa.flash_attention_bwd_dkv_plain(*args), 4, 2),
        }
        # B2, B3 and SDPA's backward back to back, three rounds, so that the
        # comparison is paired (SDPA's bf16 time has moved 10x between calls)
        rounds = {"flash_bwd_dq": [], "flash_bwd_dkv": [], "sdpa": []}
        for _ in range(3):
            for name, (kernel, *_rest) in timed.items():
                rounds[name].append(kv.ms(kernel, 10))
            rounds["sdpa"].append(kv.ms(lambda: torch.autograd.grad(
                o_lib, (qs, ks, vs), g, retain_graph=True), 10))
        med = {n: float(np.median(r)) for n, r in rounds.items()}
        lib_ms = med["sdpa"]
        both = med["flash_bwd_dq"] + med["flash_bwd_dkv"]
        print(f"flash backward {str(dtype)[6:]} [8,12,1024,64] causal, 3 paired rounds (ms): "
              + "; ".join(f"{n} {[round(x, 4) for x in r]}" for n, r in rounds.items())
              + f"; medians: B2 + B3 {both:.4f} against sdpa backward {lib_ms:.4f} "
              f"({both / lib_ms:.2f}x)")
        for name, (kernel, plain, products, n_out) in timed.items():
            ms = med[name]
            plain_ms = kv.ms(plain, 3)
            flops = 2 * products * D * pairs
            nbytes = (4 + n_out) * n_in * q.element_size() + 2 * B * H * T_FULL * 4
            bound_ms, bound_by = roofline(flops, nbytes, dtype)
            print(f"{name} {str(dtype)[6:]} [8,12,1024,64] causal: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, sdpa backward (dq+dk+dv) {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB{cuda_core_note(flops, dtype)})")
            if dtype == torch.float32:
                rows[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        del o_lib
    return rows


def _attention_case(gen, dtype, b, h, tq, tk, d, dv, masked):
    q = torch.randn(b, h, tq, d, generator=gen).to("cuda", dtype)
    k = torch.randn(b, h, tk, d, generator=gen).to("cuda", dtype)
    v = torch.randn(b, h, tk, dv, generator=gen).to("cuda", dtype)
    g = torch.randn(b, h, tq, dv, generator=gen).to("cuda", dtype)
    mask = None
    if masked:
        lens = torch.randint(1, tk + 1, (b,), generator=gen)
        mask = (torch.arange(tk)[None, :] < lens[:, None]).float()
        mask[-1] = 0.0  # a fully masked batch row
        mask = mask.cuda()
    return q, k, v, g, mask


def phase_new_instantiations(gen) -> None:
    """The instantiations C1 adds, each against its plain version at ragged
    shapes: float16 and float64 in B1-B4 (float64 in ``csrc/flash_f64.cu``),
    and head dims above 128 up to 256 in every dtype. Then timed: B1, B2 and
    B3 at d = 256 ([1, 8, 2048, 256] causal) in float32, bf16 and f16, and at
    the training shape in f16 and f64, each beside SDPA's forward or
    backward in the same dtype; B4 at d = 256 and in f16 and f64 by device
    time."""
    cases = [  # (b, h, tq, tk, d, dv, causal, masked)
        (2, 3, 129, 200, 64, 64, True, True),
        (2, 3, 200, 333, 256, 256, True, True),
        (2, 2, 77, 150, 200, 136, False, True),
    ]
    for dtype in DTYPES:
        for b, h, tq, tk, d, dv, causal, masked in cases:
            if d <= 128 and dtype in (torch.float32, torch.bfloat16):
                continue  # the forward and backward phases hold these
            q, k, v, g, mask = _attention_case(gen, dtype, b, h, tq, tk, d, dv, masked)
            out, lse = fa.flash_attention(q, k, v, mask, causal, return_lse=True)
            p_out, p_lse = fa.flash_attention_plain(q, k, v, mask, causal)
            acc = p_lse.dtype
            delta = torch.sum(g.to(acc) * p_out.to(acc), dim=-1)
            dq, dk, dv_ = fa.flash_attention_bwd(q, k, v, p_out, p_lse, g, mask, causal)
            args = (q, k, v, g, p_lse, delta, mask, causal)
            p_dq = fa.flash_attention_bwd_dq_plain(*args)
            p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(*args)
            torch.cuda.synchronize()
            e_out = float((out.double() - p_out.double()).abs().max())
            e_lse = float((lse.double() - p_lse.double()).abs().max())
            rel = {n: rel_err(x.double(), y.double()) for n, x, y in
                   (("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv_, p_dv))}
            print(f"new instantiation {str(dtype)[6:]:8s} [{b},{h},{tq}/{tk},{d}/{dv}] "
                  f"causal={causal!s:5s} mask={masked!s:5s}: B1 out max_abs={e_out:.3e} "
                  f"(tol {TOL_OUT[dtype]:g}) lse max_abs={e_lse:.3e} (tol "
                  f"{TOL_LSE[dtype]:g}); B2/B3 rel " + ", ".join(
                      f"{n} {e:.3e}" for n, e in rel.items())
                  + f" (tol {TOL_BWD_REL[dtype]:.3g})")
            check(out.dtype == dtype and lse.dtype == acc, "B1 output dtypes")
            check(e_out <= TOL_OUT[dtype] and e_lse <= TOL_LSE[dtype],
                  "a new B1 instantiation disagrees with its plain version")
            check(max(rel.values()) <= TOL_BWD_REL[dtype],
                  "a new B2/B3 instantiation disagrees with its plain version")
            if masked:
                check(bool((out[-1] == 0).all()) and bool((dq[-1] == 0).all()),
                      "a fully masked row must give 0 and no gradient")
        for d in (64, 256):
            if d <= 128 and dtype in (torch.float32, torch.bfloat16):
                continue
            L = 333
            q = torch.randn(5, 3, 1, d, generator=gen).to("cuda", dtype)
            k = torch.randn(5, 3, L, d, generator=gen).to("cuda", dtype)
            v = torch.randn(5, 3, L, d, generator=gen).to("cuda", dtype)
            start = torch.tensor([-1, 0, 100, L - 1, L + 7], dtype=torch.int32).cuda()
            out = fa.flash_decode_attention(q, k, v, start)
            ref = fa.flash_decode_attention_plain(q, k, v, start)
            torch.cuda.synchronize()
            e = float((out.double() - ref.double()).abs().max())
            print(f"new instantiation {str(dtype)[6:]:8s} B4 [5,3,1,{d}] L={L} "
                  f"start_pos={start.tolist()}: max_abs={e:.3e} (tol {TOL_OUT[dtype]:g})")
            check(e <= TOL_OUT[dtype] and bool((out[0] == 0).all()),
                  "a new B4 instantiation disagrees with its plain version")

    # timings: B1 and B2 + B3 against SDPA's forward and backward, paired
    shapes = [((1, 8, 2048, 256), (torch.float32, torch.bfloat16, torch.float16)),
              ((B, H, T_FULL, D), (torch.float16, torch.float64))]
    for (b, h, t, d), dtypes in shapes:
        pairs = b * h * t * (t + 1) // 2
        for dtype in dtypes:
            q, k, v, g = (torch.randn(b, h, t, d, generator=gen).to("cuda", dtype)
                          for _ in range(4))
            out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
            delta = torch.sum(g.to(lse.dtype) * out.to(lse.dtype), dim=-1)
            args = (q, k, v, g, lse, delta, None, True, d ** -0.5)
            qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            timed = {"B1": lambda: fa.flash_attention(q, k, v, causal=True),
                     "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                     "B2": lambda: fa_mod._flash_bwd_dq_cuda(*args),
                     "B3": lambda: fa_mod._flash_bwd_dkv_cuda(*args),
                     "sdpa backward": lambda: torch.autograd.grad(
                         o_lib, (qs, ks, vs), g, retain_graph=True)}
            iters = 2 if dtype == torch.float64 else 10
            rounds = {n: [] for n in timed}
            for _ in range(3):
                for n, fn in timed.items():
                    rounds[n].append(kv.ms(fn, iters))
            med = {n: float(np.median(r)) for n, r in rounds.items()}
            bounds = {n: roofline(2 * p * d * pairs, (4 + w) * b * h * t * d * q.element_size(),
                                  dtype)[0]
                      for n, p, w in (("B1", 2, 0), ("B2", 3, 1), ("B3", 4, 2))}
            print(f"new instantiation {str(dtype)[6:]} [{b},{h},{t},{d}] causal, median of 3 "
                  f"paired rounds (ms): " + ", ".join(f"{n} {m:.4f}" for n, m in med.items())
                  + "; bounds " + ", ".join(f"{n} {x:.4f}" for n, x in bounds.items())
                  + f"; B1 {med['B1'] / med['sdpa']:.2f}x sdpa, B2 + B3 "
                  f"{(med['B2'] + med['B3']) / med['sdpa backward']:.2f}x sdpa backward")
            del o_lib, qs, ks, vs

    # B4 by device time at the serving positions
    pos = torch.tensor([132, 532, 230, 410, 378, 310, 299, 450], dtype=torch.int32).cuda()
    for (b, h, d), dtype in (((8, 8, 256), torch.float32), ((B, H, D), torch.float16),
                             ((B, H, D), torch.float64)):
        q = torch.randn(b, h, 1, d, generator=gen).to("cuda", dtype)
        kk, vv = (torch.randn(b, h, T_FULL, d, generator=gen).to("cuda", dtype)
                  for _ in range(2))
        keep = (torch.arange(T_FULL, device="cuda")[None, :] <= pos[:, None])[:, None, None, :]
        ms = kv.graph_ms(lambda: fa.flash_decode_attention(q, kk, vv, pos), 200)
        lib_ms = kv.graph_ms(lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=keep),
                             200)
        keys = int((pos.long() + 1).sum()) * h
        bound, by = roofline(4 * d * keys, 2 * keys * d * q.element_size(), dtype)
        print(f"new instantiation {str(dtype)[6:]} B4 [{b},{h},1,{d}] vs L={T_FULL} at "
              f"start_pos={pos.tolist()}: kernel {ms:.5f} ms of device time, sdpa "
              f"{lib_ms:.5f} ms, bound {bound:.5f} ms ({by})")


def _with_impl(impl: str, fn):
    """``fn()`` with the attention seam set to ``impl``, then back to "auto"."""
    fa.set_attention_impl(impl)
    try:
        return fn()
    finally:
        fa.set_attention_impl("auto")


def _worst_grad(grads, ref, what: str) -> tuple:
    """(largest per-parameter relative error, its name), checking that every
    parameter the reference gives a gradient gets one."""
    worst = (0.0, "")
    for lname, lg in ref.items():
        for pname, r in lg.items():
            g = grads[lname][pname]
            check(float(g.abs().max()) > 0 or float(r.abs().max()) == 0,
                  f"{lname}.{pname} has no gradient through {what}")
            worst = max(worst, (rel_err(g, r), f"{lname}.{pname}"))
    return worst


def phase_model(prompts) -> dict:
    lm = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12,
                       ffn_size=3072, max_len=T_FULL, seed=SEED, dtype="float32")
    t0 = time.perf_counter()
    model = lm.init()  # on the current CUDA device
    torch.cuda.synchronize()
    print(f"model: TransformerLM GPT-2-small widths, {model.num_params()} params, "
          f"{len(model.layers)} layers, init {time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(SEED)
    session = GenerationSession(model, max_len=T_FULL)
    ids = rs.randint(0, 50257, (B, T_FULL))
    # warm-up at the timed shapes: library handles and plans, allocator pools
    model.output(ids)
    session.generate(prompts, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0, output() then generate() ----
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    probs = model.output(ids)
    torch.cuda.synchronize()
    output_ms = 1e3 * (time.perf_counter() - t0)
    after_output = dict(fa.LAUNCH_COUNTS)
    t0 = time.perf_counter()
    gen = session.generate(prompts, MAX_TOKENS)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    counts = dict(fa.LAUNCH_COUNTS)
    steps = MAX_TOKENS - 1  # the first token comes from prefill
    print(f"launches: after output() {after_output}, after generate() {counts}")
    no_bwd = {"flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    check(after_output == {"flash_forward": 12, "flash_decode": 0, **no_bwd},
          "output() must launch flash_forward once per decoder block (12)")
    check(counts == {"flash_forward": 12, "flash_decode": 12 * steps, **no_bwd},
          f"generate() must launch flash_decode 12 x {steps} decode steps")
    check(tuple(probs.shape) == (B, 50257, T_FULL) and bool(torch.isfinite(probs).all()),
          "output() must be finite [8, 50257, 1024]")
    sums = probs[:, :, :: 128].sum(dim=1)
    check(float((sums - 1).abs().max()) < 1e-4, "softmax rows must sum to 1")
    check(all(len(r) == MAX_TOKENS and all(0 <= t < 50257 for t in r) for r in gen),
          "generate() must return 64 valid tokens per row")
    del probs

    # ---- correctness: prefill + cached decode vs a full forward ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, logits, lens = session.prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    cached = [logits]
    t0 = time.perf_counter()
    for s in range(steps):
        carry, logits = session.decode(carry, [row[s] for row in gen])
        cached.append(logits)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / steps
    cached = torch.stack(cached, dim=1)  # [b, 64, V]
    seqs = [p + g[:steps] for p, g in zip(prompts, gen)]
    t_max = max(len(s) for s in seqs)
    ids = np.zeros((B, t_max), np.int32)
    mask = np.zeros((B, t_max), np.float32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1.0
    full = model.output(ids, mask)  # [b, V, t]
    worst = 0.0
    for i, p in enumerate(prompts):
        ref = torch.log(torch.clamp_min(full[i, :, len(p) - 1: len(p) - 1 + MAX_TOKENS], 1e-30)).T
        worst = max(worst, max_err(cached[i], ref))
    print(f"cached decode vs full forward: log-prob max_abs={worst:.3e} (tol {TOL_LOGPROB:g})")
    check(worst <= TOL_LOGPROB, "cached decode disagrees with the full forward")

    peak = torch.cuda.max_memory_allocated()
    # the decode step is bound by the host's launches, whose time varies
    # from call to call: generate twice more and report the median of three
    runs = [generate_s]
    for _ in range(2):
        t0 = time.perf_counter()
        session.generate(prompts, MAX_TOKENS)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    generate_s = sorted(runs)[1]
    print(f"serving: output() [8,1024] {output_ms:.2f} ms; generate 8 x {MAX_TOKENS} tokens "
          f"(prompts {sorted(len(p) for p in prompts)}, bucket 512) median "
          f"{generate_s * 1e3:.1f} ms of {[round(r * 1e3, 1) for r in runs]} = "
          f"{B * MAX_TOKENS / generate_s:.1f} tokens/s; prefill {prefill_ms:.2f} ms; "
          f"decode {decode_ms:.3f} ms/step; peak memory {peak / 2**30:.2f} GiB")

    # ---- the decode graph: a second generate() with other prompts through
    # the same session (a new carry, so a new graph), and the graph step
    # against the uncaptured step on two carries from one prefill
    rs2 = np.random.RandomState(SEED + 3)
    prompts2 = [rs2.randint(0, 50257, n).tolist() for n in rs2.randint(50, 301, B)]
    gen2 = session.generate(prompts2, 16)
    check(not session._graphs, "generate() must release its decode graph")
    for label, ps, g in (("first", prompts, gen), ("second", prompts2, gen2)):
        gap = _greedy_gap(model, ps, g)
        print(f"generate() {label} call through one session ({len(g[0])} tokens a row): "
              f"worst gap of a greedy token below its position's maximum log-prob, "
              f"teacher-forced, {gap:.3e} (tol {TOL_LOGPROB:g})")
        check(gap <= TOL_LOGPROB, f"the {label} generate() is not greedy")
    carry_g, logits_g, _ = session.prefill(prompts2)
    carry_e, _, _ = session.prefill(prompts2)
    toks = torch.argmax(logits_g, dim=-1)
    worst_ge, same, t_graph, t_eager = 0.0, True, [], []
    for s_ in range(24):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry_g, lg = session.decode(carry_g, toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            le = session.step(carry_e, toks.to(torch.int32))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if s_ >= 2:  # step 0 runs eagerly, step 1 captures
            t_graph.append(t1 - t0)
            t_eager.append(t2 - t1)
        worst_ge = max(worst_ge, max_err(lg, le))
        same = same and torch.equal(torch.argmax(lg, -1), torch.argmax(le, -1))
        toks = torch.argmax(lg, dim=-1)
    check(session._graphs[B].step is not None, "decode() must replay a graph from step 2")
    graph_launches = session._graphs[B].step.launches
    session.release_graphs()
    print(f"session decode [8, 1]: CUDA graph step vs the uncaptured step on a copy of the "
          f"carry, 24 steps: logits max_abs {worst_ge:.3e} (tol 1e-6), tokens equal {same}; "
          f"graph {1e3 * np.median(t_graph):.3f} ms/step, eager "
          f"{1e3 * np.median(t_eager):.3f} ms/step (medians of 22); a replay launches "
          f"{graph_launches}")
    check(worst_ge <= 1e-6 and same, "the graph step disagrees with the eager step")
    check(graph_launches == {"flash_decode": 12}, "a decode graph must hold 12 B4 launches")
    return counts, model


def phase_sampler() -> None:
    """The device sampler (``generate/sampling.py``): the hash's bits on the
    card equal the CPU's, the same draws come out, and a draw over a small
    fixed vocabulary passes a chi-square against the softmax."""
    from deeplearning4j_tpu_torch.generate import sampling

    n, temp = 20000, 0.8
    seeds, steps = np.arange(n), np.full(n, 3)
    bits_c = sampling.random_bits(seeds, steps, 0, 8, "cpu")
    bits_g = sampling.random_bits(seeds, steps, 0, 8, "cuda").cpu()
    check(torch.equal(bits_c, bits_g), "the sampler's bits differ between the CPU and the card")
    z = torch.tensor([2.0, 1.0, 0.0, -1.0, 0.5, 1.5, -0.5, 0.25])

    def draw(dev):
        return sampling.sample_tokens(z.to(dev).expand(n, -1), seeds, steps, np.zeros(n, bool),
                                      torch.full((n,), temp), torch.zeros(n, dtype=torch.int64),
                                      torch.ones(n)).cpu()

    d_g, d_c = draw("cuda"), draw("cpu")
    same = float((d_g == d_c).double().mean())
    freq = np.bincount(d_g.numpy(), minlength=8)
    expect = n * torch.softmax(z / temp, -1).double().numpy()
    chi2 = float(((freq - expect) ** 2 / expect).sum())
    print(f"device sampler: {n} draws over 8 tokens (T {temp}): chi-square {chi2:.3f} "
          f"(7 dof, 0.999 quantile {CHI2_DF7_999}); bits equal to the CPU's; draws equal to "
          f"the CPU's: {same:.5f}")
    check(chi2 < CHI2_DF7_999, "the device sampler does not follow the softmax")
    check(same >= 0.999, "the card draws other tokens than the CPU from the same keys")


def _teacher_forced(model, prompts, streams, vocab=None, cache_dtype=None) -> list:
    """Per request, the log-probs [len(stream), V] a full ``output()`` over
    ``prompt + stream[:-1]`` gives at the positions that produced the
    stream's tokens (one-hot encoded over ``vocab`` for a char-RNN). With
    ``cache_dtype="int8"`` the same full forward runs on a fresh int8 decode
    carry: every position's K and V are quantized into the cache and each
    query attends over their dequantized values, as in the int8 engine's
    prefill and decode steps."""
    seqs = [p + s[:-1] for p, s in zip(prompts, streams)]
    ids = np.zeros((len(seqs), max(len(s) for s in seqs)), np.int32)
    mask = np.zeros(ids.shape, np.float32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1.0
    if cache_dtype is None:
        full = model.output(ids if vocab is None else _onehot(ids, vocab), mask)  # [b, V, t]
    else:
        carry = GenerationSession(model, max_len=ids.shape[1],
                                  cache_dtype=cache_dtype).decode_state(len(seqs))
        with torch.no_grad():
            full, _, _ = model.forward_pure(
                model.params, model.state, torch.from_numpy(ids).to(model.device),
                train=False, rng=None, mask=torch.from_numpy(mask).to(model.device, model.dtype),
                rnn_state=carry)
        del carry
        full = full.float()
    out = [torch.log(torch.clamp_min(full[i, :, len(p) - 1: len(p) - 1 + len(s)], 1e-30)).T
           for i, (p, s) in enumerate(zip(prompts, streams))]
    del full
    return out


def _greedy_gap(model, prompts, streams, lps=None, bf16_ties: bool = False) -> float:
    """The largest distance of a generated token's log-prob below the
    maximum at its position, teacher-forced (``lps``, when given, are
    ``_teacher_forced``'s log-probs): 0 for an exact greedy stream, up to
    the decode path's rounding where two tokens nearly tie. With
    ``bf16_ties`` each position's distance is first less one bfloat16 ulp
    of its maximum: a decode that returns its log-probs in bfloat16 ties
    every token within one ulp of the largest, and argmax takes the first."""
    gap = 0.0
    if lps is None:
        lps = _teacher_forced(model, prompts, streams)
    for lp, s in zip(lps, streams):
        tok = torch.tensor(s, device=lp.device)[:, None]
        top = lp.max(dim=1).values
        g = top - lp.gather(1, tok)[:, 0]
        if bf16_ties:
            g = g - torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
        gap = max(gap, float(g.max()))
    return gap


def _run_engine(eng, prompts, n_tok: int, hook=None):
    """Submits every prompt at once to ``eng`` for ``n_tok`` greedy tokens;
    returns (streams, seconds, engine steps). ``hook`` runs on the engine's
    thread after each step. Every request must end "completed" (the JAX
    engine's reason for reaching ``max_tokens``) with ``n_tok`` tokens: a
    step that raised inside the engine ends its requests "failed", which
    fails the run here."""
    turns = [0]

    def step_hook():
        turns[0] += 1
        if hook is not None:
            hook()

    eng._step_hook = step_hook
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_tokens=n_tok) for p in prompts]
    streams = [h.result(timeout=600) for h in handles]
    dt = time.perf_counter() - t0
    eng._step_hook = None
    for h in handles:
        if h.reason != "completed" or len(h.tokens) != n_tok:
            last = list(h.events(timeout=1))[-1]
            raise AssertionError(f"{eng.name}: a request ended {h.reason!r} with "
                                 f"{len(h.tokens)} tokens: {last.get('error', '')}")
    return streams, dt, turns[0]


def _seam_snapshot(eng) -> dict:
    """The int8 cache of the carry's first decoder block as the decode
    attention reads it, copied (the paged one gathered through the table)."""
    name, st = next((n, s) for n, s in eng._carry.items() if "cache_k" in s)
    pos = st["pos"].clone()
    if "block_table" in st:
        tbl = st["block_table"]
        planes = {k: fa.paged_gather(st[k], tbl) for k in
                  ("cache_k", "cache_v", "cache_k_scale", "cache_v_scale")}
    else:
        planes = {k: st[k].clone() for k in ("cache_k", "cache_v", "cache_k_scale",
                                              "cache_v_scale")}
    return dict(planes, pos=pos, active=torch.from_numpy(eng._active.copy()))


def phase_engine(model, prompts, card: str) -> dict:
    """The continuous-batching ``DecodeEngine`` on the serving phase's
    GPT-2-small-width LM: 8 slots, ``max_len`` 1024, the 8 ragged prompts
    submitted at once for 64 greedy tokens each, over (a) the static float32
    cache, (b) the paged one (``block_size=16``), (c) the int8 cache, (d)
    paged int8, and (e) speculative decoding with ``k=4``, once with the
    target as its own draft and once with a 2-block draft at the same
    widths. Each engine first serves one short warm-up request, so its
    plain step's CUDA graph is captured before the counted run. Returns the
    launch counts of the counted runs and the static engine's greedy
    streams."""
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import DecodeEngine

    total = {n: 0 for n in fa.LAUNCH_COUNTS}
    n_blocks = sum(isinstance(l, type(model.layers[2])) for l in model.layers)
    streams, info = {}, {}

    def run(label, hook=None, **kw):
        eng = DecodeEngine(model, max_len=T_FULL, slots=B, registry=MetricsRegistry(),
                           name=label, **kw)
        try:
            _run_engine(eng, prompts[:1], 3)  # warm-up: eager step, capture, replay
            before = eng.stats()["speculative"]
            fa.reset_launch_counts()
            peak = [0]
            snap = {}

            def watch():
                peak[0] = max(peak[0], eng._kv_cache_bytes)
                if hook is not None and not snap:
                    snap.update(hook(eng))

            out, dt, turns = _run_engine(eng, prompts, MAX_TOKENS, watch)
            torch.cuda.synchronize()
            got = dict(fa.LAUNCH_COUNTS)
            for n, c in got.items():
                total[n] += c
            st = eng.stats()
            st["speculative"] = {k: st["speculative"][k] - before[k]
                                 for k in ("steps", "proposed", "accepted")}
            decode_ms = 1e3 * eng._h_decode.sum / max(1, eng._h_decode.count)
            info[label] = dict(s=dt, turns=turns, launches=got, stats=st, peak_kv=peak[0],
                               decode_ms=decode_ms, snap=snap, eng=eng)
            ENGINE_TPS[label] = B * MAX_TOKENS / dt
            streams[label] = out
            print(f"engine {label} ({card}): {B} x {MAX_TOKENS} tokens in {dt * 1e3:.1f} ms "
                  f"= {B * MAX_TOKENS / dt:.1f} tokens/s (prefill of the 8 prompts included); "
                  f"{turns} loop turns, mean decode step {decode_ms:.3f} ms; kv_cache_bytes "
                  f"gauge peak {peak[0]}; launches {got}")
            return eng
        except Exception:
            eng.shutdown(drain=False)
            raise

    # (a) static float32: every step a graph replay of 12 B4 launches
    eng_a = run("static")
    got, turns = info["static"]["launches"], info["static"]["turns"]
    check(got["flash_decode"] == n_blocks * turns and got["flash_forward"] == 0,
          f"the static engine must launch B4 {n_blocks} times a step ({turns} steps): {got}")
    check(eng_a._graph is not None and eng_a._graph.launches == {"flash_decode": n_blocks},
          f"the static engine's step must replay a CUDA graph of {n_blocks} B4 launches")
    # the plain step, uncaptured against graph replay, on the engine's carry
    # (idle: every row stepped at the positions the run left)
    rows = np.ones(B, bool)
    ints, floats = eng_a._step_inputs(rows)
    ints_d, floats_d = ints.cuda(), floats.cuda()

    def eager_step():
        return eng_a._decode_rows(ints_d, floats_d).cpu()

    def graph_step():
        return eng_a._plain_step(ints, floats).cpu()

    times = {"eager": [], "graph": []}
    with torch.no_grad():
        for label in ("eager", "graph", "graph", "eager"):
            fn = eager_step if label == "eager" else graph_step
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times[label].append(time.perf_counter() - t0)
    eager_ms = 1e3 * float(np.median(times["eager"]))
    graph_ms_ = 1e3 * float(np.median(times["graph"]))
    print(f"engine static plain step [8, 1] ({card}): eager {eager_ms:.3f} ms/step = "
          f"{B / eager_ms * 1e3:.1f} tokens/s, CUDA graph {graph_ms_:.3f} ms/step = "
          f"{B / graph_ms_ * 1e3:.1f} tokens/s (median of 20 each, paired rounds, sampled "
          f"tokens read back to the host as the engine does)")
    eng_a.shutdown()

    # sampled: one request alone and the same in the full batch
    skw = dict(greedy=False, temperature=0.8, top_k=40, top_p=0.95, seed=7)
    eng_s = DecodeEngine(model, max_len=T_FULL, slots=B, registry=MetricsRegistry(), name="sampled")
    try:
        alone = eng_s.submit(prompts[0], max_tokens=16, **skw).result(timeout=600)
        batch = [eng_s.submit(p, max_tokens=16) for p in prompts[1:]]
        mine = eng_s.submit(prompts[0], max_tokens=16, **skw)
        in_batch = mine.result(timeout=600)
        for h in batch + [mine]:
            h.result(timeout=600)
            check(h.reason == "completed", f"sampled run: a request ended {h.reason!r}")
    finally:
        eng_s.shutdown()
    print(f"sampled request (T 0.8, top-k 40, top-p 0.95, seed 7): alone {alone}, in a batch "
          f"of 8 {in_batch}")
    check(alone == in_batch, "a sampled request must draw the same tokens alone and in a batch")

    # (b) paged float32: the same B4 inputs after the gather
    run("paged", block_size=16).shutdown()
    got, turns = info["paged"]["launches"], info["paged"]["turns"]
    check(got["flash_decode"] == n_blocks * turns,
          f"the paged engine must launch B4 {n_blocks} x {turns}: {got}")
    check(streams["paged"] == streams["static"],
          "the paged engine's greedy streams must equal the static engine's")
    # (c), (d) int8: B4 on the dequantized cache
    for label, kw in (("int8", {}), ("paged int8", {"block_size": 16})):
        run(label, hook=_seam_snapshot, cache_dtype="int8", **kw).shutdown()
        got, turns = info[label]["launches"], info[label]["turns"]
        check(got["flash_decode"] == n_blocks * turns,
              f"the {label} engine must launch B4 {n_blocks} x {turns}: {got}")
        snap = info[label]["snap"]
        check(bool(snap), f"{label}: no step ran")
        gen = torch.Generator().manual_seed(SEED + 9)
        q = torch.randn(B, H, 1, D, generator=gen).cuda()
        before = fa.LAUNCH_COUNTS["flash_decode"]
        out = fa.decode_attention(q, snap["cache_k"], snap["cache_v"], snap["pos"],
                                  k_scale=snap["cache_k_scale"], v_scale=snap["cache_v_scale"])
        check(fa.LAUNCH_COUNTS["flash_decode"] == before + 1, "int8 tq=1 must reach B4")
        deq = [snap[k].float() * snap[k + "_scale"][..., None] for k in ("cache_k", "cache_v")]
        ref = fa.decode_attention_reference(q, deq[0], deq[1], snap["pos"])
        live = snap["active"].cuda()
        e = max_err(out[live], ref[live])
        print(f"{label} seam: B4 on the dequantized cache vs decode_attention_reference, "
              f"active rows at positions {snap['pos'][live].tolist()}: max_abs {e:.3e} "
              f"(tol {TOL_OUT[torch.float32]:g})")
        check(e <= TOL_OUT[torch.float32], f"{label}: B4 disagrees with the reference")
    check(streams["paged int8"] == streams["int8"],
          "the paged int8 engine's greedy streams must equal the int8 engine's")
    # (e) speculative, k = 4
    blk = model.layers[2]
    draft = TransformerLM(vocab_size=model.layers[-1].n_out, hidden=blk.n_in, n_layers=2,
                          n_heads=blk.n_heads, ffn_size=blk.ffn_size, max_len=T_FULL,
                          seed=SEED + 11, dtype="float32").init()
    for label, dm, nl in (("spec self-draft", model, n_blocks), ("spec 2-block draft", draft, 2)):
        eng = run(label, draft_model=dm, speculative_k=4)
        eng.shutdown()
        sp = info[label]["stats"]["speculative"]
        got, turns = info[label]["launches"], info[label]["turns"]
        spec_steps = sp["steps"]
        plain_turns = turns - spec_steps
        check(got["flash_decode"] == 5 * nl * spec_steps + n_blocks * plain_turns,
              f"{label}: B4 must launch {nl} x 5 a speculative step and {n_blocks} a plain "
              f"one ({spec_steps}, {plain_turns}): {got}")
        # a row proposes k = 4 a step: its steps are proposed / 4, and each
        # emits its accepted tokens plus one from the target
        row_steps = sp["proposed"] / 4
        sp["rate"] = sp["accepted"] / sp["proposed"]
        sp["per_step"] = (sp["accepted"] + row_steps) / row_steps
        print(f"{label}: acceptance {sp['accepted']} of {sp['proposed']} proposed = "
              f"{sp['rate']:.4f}, {sp['per_step']:.4f} tokens a row per target forward, over "
              f"{spec_steps} speculative steps of the batch")
        info[label]["sp"] = sp
    check(info["spec self-draft"]["sp"]["per_step"] == 5.0,
          "the target as its own draft must have every greedy proposal accepted")
    check(info["spec 2-block draft"]["sp"]["rate"] < 1.0, "a 2-block draft must see rejections")
    del draft

    # every greedy token near the position's maximum, teacher-forced
    for label in ("static", "paged", "spec self-draft", "spec 2-block draft"):
        gap = _greedy_gap(model, prompts, streams[label])
        print(f"engine {label}: greedy tokens vs a teacher-forced output(): worst gap below the "
              f"position's maximum log-prob {gap:.3e} (tol {TOL_LOGPROB:g})")
        check(gap <= TOL_LOGPROB, f"{label}: a greedy token is not the argmax")
    # int8 against float32, teacher-forced on the float32 stream
    fp = _teacher_forced(model, prompts, streams["static"])
    s8 = GenerationSession(model, max_len=T_FULL, cache_dtype="int8")
    carry, logits, _ = s8.prefill(prompts)
    lp8 = [logits]
    for s_ in range(MAX_TOKENS - 1):
        carry, logits = s8.decode(carry, [row[s_] for row in streams["static"]])
        lp8.append(logits)
    lp8 = torch.stack(lp8, dim=1)  # [b, 64, V]
    gap8 = max(max_err(lp8[i], fp[i]) for i in range(B))
    spread = max(float((f.max(dim=1).values - f.mean(dim=1)).max()) for f in fp)
    int8_rel = 2 * n_blocks * INT8_STEP_REL
    gate8 = int8_rel * spread
    agree8 = sum(a == b for ra, rb in zip(streams["int8"], streams["static"]) for a, b in zip(ra, rb))
    print(f"int8 vs float32, teacher-forced on the float32 stream: log-prob max_abs "
          f"{gap8:.3e}, gate {gate8:.3e} ({int8_rel:.4f} x the largest logit spread above the "
          f"mean {spread:.4f}); int8 greedy tokens equal to float32's: {agree8} of "
          f"{B * MAX_TOKENS}")
    check(gap8 <= gate8, "int8 log-probs outside the quantization bound")
    del fp, lp8, carry
    # resident cache bytes
    sess = GenerationSession(model, max_len=T_FULL)
    print(f"cache_bytes(8): static float32 {sess.cache_bytes(B)}, int8 {s8.cache_bytes(B)}; "
          f"kv_cache_bytes gauge peaks: static {info['static']['peak_kv']}, paged "
          f"{info['paged']['peak_kv']}, int8 {info['int8']['peak_kv']}, paged int8 "
          f"{info['paged int8']['peak_kv']}, 2-block draft {info['spec 2-block draft']['peak_kv']}")
    return total, streams["static"]


def _http(port: int, path: str, payload=None, *, method: str = "POST",
          headers=None):
    """One HTTP call to a local server: (status, headers, body bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = None if payload is None else json.dumps(payload).encode()
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _stream(port: int, prompt, n_tok: int):
    """A streamed ``POST /v1/generate``: (tokens, seconds from sending to
    the first NDJSON event, the terminal event)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": prompt, "max_tokens": n_tok, "stream": True}).encode())
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"/v1/generate answered {resp.status}: {resp.read()[:200]}")
        toks, ttft, last = [], None, None
        for line in resp:
            if not line.strip():
                continue
            ev = json.loads(line)
            ttft = time.perf_counter() - t0 if ttft is None else ttft
            if "token" in ev:
                toks.append(ev["token"])
            if ev.get("done"):
                last = ev
                break
        check(last is not None and last["reason"] == "completed" and len(toks) == n_tok,
              f"a stream ended {last} after {len(toks)} tokens")
        return toks, ttft, last
    finally:
        conn.close()


def _concurrently(fn, arg_lists):
    """``fn(*args)`` for every ``args`` on a thread of its own, all started
    together: the results in order, or the first error raised."""
    out, errors = [None] * len(arg_lists), []

    def run(i, args):
        try:
            out[i] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(arg_lists)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    check(not any(th.is_alive() for th in threads), "a client thread did not finish")
    if errors:
        raise errors[0]
    return out


def _streams_over_http(port: int, prompts, n_tok: int):
    """The prompts' streams from one client thread each: (streams, seconds,
    mean seconds to the first event)."""
    t0 = time.perf_counter()
    res = _concurrently(_stream, [(port, p, n_tok) for p in prompts])
    dt = time.perf_counter() - t0
    return [r[0] for r in res], dt, float(np.mean([r[1] for r in res]))


def _streams_in_process(eng, prompts, n_tok: int):
    """The same through ``eng.submit``, one consumer thread a handle."""
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_tokens=n_tok) for p in prompts]

    def consume(h):
        first = None
        for _ in h.events(timeout=600):
            first = time.perf_counter() - t0 if first is None else first
        check(h.reason == "completed", f"{eng.name}: a request ended {h.reason!r}")
        return list(h.tokens), first

    res = _concurrently(consume, [(h,) for h in handles])
    dt = time.perf_counter() - t0
    return [r[0] for r in res], dt, float(np.mean([r[1] for r in res]))


def _hist_mean(h, since=(0.0, 0)) -> tuple:
    """(mean of a histogram child's observations since ``since``, count)."""
    n = h.count - since[1]
    return ((h.sum - since[0]) / n if n else float("nan")), n


# /v1/serving's rows: each answer is 50257 x SERVING_T probabilities of JSON,
# whose encoding holds the phase (12.7 s for 8 rows of 16 tokens, H100 80GB
# HBM3, 700 W); the gate (answers vs output()) does not depend on the length
SERVING_T = 4


def phase_http(model, prompts, want, card: str) -> dict:
    """The port's HTTP serving stack on the GPT-2-small-width LM, every
    server on 127.0.0.1 with port 0, in this process:

    1. ``POST /v1/serving``: 8 concurrent clients send one [1, ``SERVING_T``]
       row of ids each; ``ParallelInference`` batches them (B1 in every
       block), and each answer must be within ``TOL_HTTP_REL`` of
       ``output()``.
    2. ``POST /v1/generate`` over the static ``DecodeEngine``: the 8 ragged
       prompts from 8 client threads for 64 greedy tokens, streams equal to
       ``phase_engine``'s ``want``; the in-process engine's tokens/s and
       time to first token beside the HTTP ones; ``/metrics`` carries the
       ``dl4j_tpu_generate_*`` series, ``/v1/traces`` the engine's spans.
    3. Disaggregated: a prefill host (``PrefillEngine``), a decode host (a
       paged ``DecodeEngine``, ``block_size=16``) and a front host whose
       generator is a ``DisaggCoordinator``; the same streams, the handoff
       bytes and milliseconds per request; then one request with the
       prefill host stopped takes the unified fallback and still matches.
    4. Hot swap: a ``ModelStore`` in a temporary directory with two
       published versions (``SWAP_LAYERS`` blocks at GPT-2's widths,
       different seeds) behind ``/v1/models/lm``; ``deploy(1)``,
       ``start_canary(2)``, ``promote_canary()`` while two clients keep
       sending requests, none of which may fail; then ``park()`` must lower
       ``torch.cuda.memory_allocated`` by at least the live model's
       parameter bytes, and ``unpark()`` serve again.
    5. An ``EnginePool`` over two static ``DecodeEngine`` replicas behind
       ``/v1/generate`` (``pool=``): the same streams.

    Returns the B1/B4 launch counts of the phase (the references of check
    1 are computed before the counts are set to 0)."""
    from deeplearning4j_tpu_torch.obs import MetricsRegistry, Tracer
    from deeplearning4j_tpu_torch.parallel import DecodeEngine, EnginePool
    from deeplearning4j_tpu_torch.remote import JsonModelServer
    from deeplearning4j_tpu_torch.serving import (DisaggCoordinator, ModelManager,
                                                  ModelStore, PrefillEngine, model_bytes)

    rs = np.random.RandomState(SEED + 21)
    vocab = model.layers[-1].n_out
    rows = [rs.randint(0, vocab, (1, SERVING_T)) for _ in range(B)]
    refs = [model.output(r)[0].cpu() for r in rows]
    fa.reset_launch_counts()

    # (1) batched output() over HTTP
    srv = JsonModelServer(model, registry=MetricsRegistry(), name="http-serving", workers=2,
                          batch_limit=B).start()
    try:
        def call(r):
            st, _, body = _http(srv.port, "/v1/serving", {"data": r.tolist()})
            check(st == 200, f"/v1/serving answered {st}")
            return torch.tensor(json.loads(body)["output"])

        t0 = time.perf_counter()
        outs = _concurrently(call, [(r,) for r in rows])
        dt = time.perf_counter() - t0
        err = max(max_err(o, ref) / float(ref.abs().max()) for o, ref in zip(outs, refs))
        s = srv.stats()
        print(f"http /v1/serving ({card}): {B} clients x [1, {SERVING_T}] ids in "
              f"{dt * 1e3:.1f} ms "
              f"({s['batches']} forwards, mean batch {s['mean_batch_size']:.2f}); answers vs "
              f"output() max_abs over the largest probability {err:.3e} (tol {TOL_HTTP_REL:g})")
        check(all(tuple(o.shape) == (vocab, SERVING_T) for o in outs),
              "/v1/serving answered a wrong shape")
        check(err <= TOL_HTTP_REL, "/v1/serving disagrees with output()")
    finally:
        srv.stop()

    # (2) streamed generation over the static engine
    tracer = Tracer(sample_rate=1.0)
    reg = MetricsRegistry()
    eng = DecodeEngine(model, max_len=T_FULL, slots=B, registry=reg, name="http-static",
                       tracer=tracer)
    srv = JsonModelServer(generator=eng, registry=reg, tracer=tracer, name="http-generate").start()
    try:
        _stream(srv.port, prompts[0][:8], 3)  # warm-up: eager step, capture, replay
        local, dt_l, ttft_l = _streams_in_process(eng, prompts, MAX_TOKENS)
        remote, dt_h, ttft_h = _streams_over_http(srv.port, prompts, MAX_TOKENS)
        check(local == want, "the in-process streams differ from phase_engine's static streams")
        check(remote == want, "the HTTP streams differ from the in-process engine's")
        metrics = _http(srv.port, "/metrics", method="GET")[2].decode()
        check("dl4j_tpu_generate_tokens_total" in metrics, "/metrics lacks dl4j_tpu_generate_*")
        tracer.flush()
        traces = json.loads(_http(srv.port, "/v1/traces?limit=200", method="GET")[2])["traces"]
        spans = {sp["name"] for tr in traces for sp in tr["spans"]}
        check({"server.request", "engine.prefill", "engine.decode"} <= spans,
              f"/v1/traces lacks the engine's spans: {sorted(spans)}")
        n = B * MAX_TOKENS
        print(f"http /v1/generate static ({card}): {B} x {MAX_TOKENS} greedy tokens, "
              f"{n / dt_h:.1f} tokens/s, mean time to first token {ttft_h * 1e3:.1f} ms over "
              f"HTTP; in process {n / dt_l:.1f} tokens/s, {ttft_l * 1e3:.1f} ms (streams equal "
              f"to phase_engine's; spans {sorted(spans)})")
    finally:
        srv.stop()
        eng.shutdown()

    # (3) disaggregated prefill -> handoff -> decode, and the fallback
    reg = MetricsRegistry()
    pe = PrefillEngine(model, max_len=T_FULL, registry=reg, name="prefill")
    pre = JsonModelServer(prefill=pe, registry=reg, name="prefill-host").start()
    dec_eng = DecodeEngine(model, max_len=T_FULL, slots=B, block_size=16, registry=reg,
                           name="decode")
    dec = JsonModelServer(generator=dec_eng, registry=reg, name="decode-host").start()
    coord = DisaggCoordinator([f"http://127.0.0.1:{pre.port}"],
                              [f"http://127.0.0.1:{dec.port}"], timeout=600.0, workers=B,
                              registry=reg, name="front")
    front = JsonModelServer(generator=coord, registry=reg, name="front-host").start()
    try:
        _stream(front.port, prompts[0][:8], 3)  # warm-up through both hops

        def per_request(run, n):
            """``run()``'s result and the handoff figures of its ``n``
            requests: mean wire bytes, prefill-host and decode-host ms."""
            since = {k: (h.sum, h.count) for k, h in (("bytes", coord._h_bytes),
                                                     ("prefill", pe._h_prefill))}
            copy0 = dict(dec_eng.handoff_copy)
            out = run()
            hb, n_ho = _hist_mean(coord._h_bytes, since["bytes"])
            pms, _ = _hist_mean(pe._h_prefill, since["prefill"])
            n_cp = dec_eng.handoff_copy["requests"] - copy0["requests"]
            cms = (dec_eng.handoff_copy["seconds"] - copy0["seconds"]) / max(1, n_cp)
            check(n_ho == n and n_cp == n, f"{n_ho} handoffs shipped, {n_cp} installed, not {n}")
            return out, (f"handoff {hb:.0f} bytes on the wire, prefill host {pms * 1e3:.2f} ms "
                         f"(bucketed prefill + copy to the host), decode host {cms * 1e3:.2f} ms "
                         f"to rebuild the row on the card")

        # the longest prompt alone, then the 8 together
        (toks, ttft1, _), alone = per_request(
            lambda: _stream(front.port, prompts[1], MAX_TOKENS), 1)
        check(toks == want[1], "the disaggregated stream differs from the unified one")
        print(f"http disaggregated, one request of {len(prompts[1])} tokens alone ({card}): "
              f"time to first token {ttft1 * 1e3:.1f} ms; {alone}")
        (got, dt, ttft), each = per_request(
            lambda: _streams_over_http(front.port, prompts, MAX_TOKENS), B)
        check(got == want, "the disaggregated streams differ from the unified ones")
        print(f"http disaggregated ({card}): {B} x {MAX_TOKENS} greedy tokens, "
              f"{B * MAX_TOKENS / dt:.1f} tokens/s, mean time to first token {ttft * 1e3:.1f} ms; "
              f"per request: {each}")
        pre.stop()
        toks, _, _ = _stream(front.port, prompts[3], MAX_TOKENS)
        fb = coord.stats()
        check(toks == want[3] and fb["fallbacks"] == 1 and fb["handoffs"]["fallback"] == 1,
              f"the fallback request must match and be counted: {fb['handoffs']}")
        print(f"http disaggregated fallback ({card}): prefill host stopped, 1 request through "
              f"the decode host's /v1/generate, stream equal; handoffs {fb['handoffs']}")
    finally:
        front.stop()
        coord.shutdown()
        dec.stop()
        dec_eng.shutdown()
        pre.stop()

    # (4) hot swap from a model store, then park/unpark
    widths = dict(vocab_size=vocab, hidden=model.layers[2].n_in, n_layers=SWAP_LAYERS,
                  n_heads=model.layers[2].n_heads, ffn_size=model.layers[2].ffn_size,
                  max_len=T_FULL, dtype="float32")
    with tempfile.TemporaryDirectory() as root:
        store = ModelStore(root)
        t0 = time.perf_counter()
        for seed in (SEED + 31, SEED + 32):
            store.publish("lm", TransformerLM(seed=seed, **widths).init())
        t_pub = time.perf_counter() - t0
        reg = MetricsRegistry()
        mgr = ModelManager(store, "lm", version=2, warmup_example=np.zeros((1, 1)), workers=2,
                           batch_limit=4, registry=reg)
        srv = JsonModelServer(managers={"lm": mgr}, registry=reg, name="swap-host").start()
        # one id a row: the answer (50257 floats of JSON) keeps the clients'
        # encoding from starving the swap's own thread of the interpreter;
        # each client pauses SWAP_CLIENT_PAUSE_S between requests for the same
        # reason (an answer's encoding holds the interpreter ~0.1 s: two
        # clients back to back, or 50 ms apart, held deploy() at 10-12 s)
        row = rs.randint(0, vocab, (1, 1)).tolist()
        stop, answers = threading.Event(), []

        def client():
            while not stop.is_set():
                st, hd, _ = _http(srv.port, "/v1/models/lm", {"data": row})
                answers.append((st, hd.get("X-Model-Version")))
                time.sleep(SWAP_CLIENT_PAUSE_S)

        def await_answers(k):
            end, n0 = time.monotonic() + 300, len(answers)
            while len(answers) < n0 + k and time.monotonic() < end:
                time.sleep(0.01)

        clients = [threading.Thread(target=client) for _ in range(2)]
        try:
            for th in clients:
                th.start()
            await_answers(4)
            steps = {}
            for label, fn in (("deploy(1)", lambda: mgr.deploy(1)),
                              ("start_canary(2)", lambda: mgr.start_canary(2, weight=0.5)),
                              ("promote_canary()", mgr.promote_canary)):
                t0 = time.perf_counter()
                fn()
                steps[label] = time.perf_counter() - t0
                await_answers(4)
        finally:
            stop.set()
            for th in clients:
                th.join(timeout=600)
        check(not any(th.is_alive() for th in clients), "a hot-swap client did not finish")
        codes = sorted({st for st, _ in answers})
        served = sorted({v for _, v in answers if v})
        check(codes == [200], f"requests failed across the hot swap: codes {codes}")
        check(mgr.live_version == "2" and served == ["1", "2"],
              f"live {mgr.live_version}, versions served {served}")
        torch.cuda.synchronize()
        live_bytes = model_bytes(mgr.engine.model)
        resident = mgr.resident_bytes()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        mgr.park()
        t_park = time.perf_counter() - t0
        after = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        mgr.unpark()
        t_unpark = time.perf_counter() - t0
        again = torch.cuda.memory_allocated()
        st, hd, _ = _http(srv.port, "/v1/models/lm", {"data": row})
        srv.stop()
        mgr.shutdown()
    print(f"http hot swap ({card}; depth cut 12 -> {SWAP_LAYERS} blocks at GPT-2 small's "
          f"widths): 2 versions published in {t_pub:.2f} s; "
          + ", ".join(f"{k} {v * 1e3:.0f} ms" for k, v in steps.items())
          + f"; {len(answers)} requests across it, all 200, versions served {served}")
    print(f"http park/unpark ({card}): memory_allocated {before} -> {after} bytes after park() "
          f"(-{before - after}; live model's parameters {live_bytes}, resident live + rollback "
          f"{resident}), {again} after unpark(); park {t_park * 1e3:.1f} ms, unpark "
          f"{t_unpark * 1e3:.1f} ms (load, checksum, warm-up)")
    check(before - after >= live_bytes, "park() did not free the live model's parameters")
    check(st == 200 and hd.get("X-Model-Version") == "2", f"after unpark: {st}, {hd}")

    # (5) a pool of two decode replicas behind /v1/generate
    reg = MetricsRegistry()
    reps = [DecodeEngine(model, max_len=T_FULL, slots=B, registry=reg, name=f"pool-r{i}")
            for i in range(2)]
    pool = EnginePool(engines=reps, registry=reg, name="http-pool")
    srv = JsonModelServer(pool=pool, registry=reg, name="pool-host").start()
    try:
        for r in reps:  # warm-up: each replica captures its step's graph
            r.submit(prompts[0][:8], max_tokens=3).result(timeout=600)
        got, dt, ttft = _streams_over_http(srv.port, prompts, MAX_TOKENS)
        check(got == want, "the pooled streams differ from the unified ones")
        done = {r.name: r.stats()["completed"] - 1 for r in reps}
        print(f"http pool ({card}): 2 static replicas, {B} x {MAX_TOKENS} greedy tokens, "
              f"{B * MAX_TOKENS / dt:.1f} tokens/s, mean time to first token {ttft * 1e3:.1f} ms, "
              f"requests per replica {done}; streams equal")
    finally:
        srv.stop()
        pool.shutdown()
    torch.cuda.synchronize()
    got = dict(fa.LAUNCH_COUNTS)
    print(f"http serving launches: {got}")
    check(got["flash_forward"] > 0 and got["flash_decode"] > 0,
          "the HTTP paths must launch B1 and B4")
    return got


# the port's contract harnesses (deeplearning4j_tpu_torch/tools/), in the
# JAX harnesses' order, and the model each runs on here: the 12-block LM the
# caller hands over, or the harness's own size ("lm": 2-block models for
# the registry and the multiplexer, [128, 3, 224, 224] uint8 batches for
# the input pipeline, the rewrite contract's own graphs in float32)
CONTRACTS = (("serving", "check_serving_contract", True),
             ("metrics", "check_metrics_contract", True),
             ("trace", "check_trace_contract", True),
             ("pool", "check_pool_contract", True),
             ("generate", "check_generate_contract", True),
             ("registry", "check_registry_contract", False),
             ("fabric", "check_fabric_contract", True),
             ("disagg", "check_disagg_contract", True),
             ("multiplex", "check_multiplex_contract", False),
             ("input pipeline", "check_input_pipeline_contract", False),
             ("rewrite", "check_rewrite_equivalence", False))


def phase_contracts(model, card: str) -> dict:
    """The port's eleven contract harnesses on the card, in this process:
    the serving, metrics, trace, pool, generate, fabric and disagg
    harnesses on ``model`` (the GPT-2-small-width LM: ``/v1/serving`` rows
    reach B1 in every block, every ``/v1/generate`` decode step B4 in the
    graphed step; the generate harness's speculative pool drafts with a
    2-block ``TransformerLM.draft_of``), the registry and multiplex
    harnesses on 2-block models at GPT-2 small's widths (a version or a
    tenant is a whole ~369 MB zip, published, paged and parked), the input
    pipeline on [128, 3, 224, 224] uint8 batches through
    ``device_put_dataset`` with ``device_buffers=2``, and the rewrite
    harness on its own graphs. Each prints its gates as they pass and
    raises at the first that fails; its seconds follow. Returns the phase's
    launch counts (B1 and B4 required)."""
    fa.reset_launch_counts()
    t_all = time.perf_counter()
    for label, module, on_model in CONTRACTS:
        mod = importlib.import_module(f"deeplearning4j_tpu_torch.tools.{module}")
        lines = []

        def log(m, label=label, lines=lines):
            lines.append(m)
            print(f"contract {label}: {m}", flush=True)

        t0 = time.perf_counter()
        rc = mod.main(device="cuda", model=model if on_model else "lm", log=log)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(rc == 0, f"the {label} contract returned {rc}")
        gates = sum(1 for m in lines if not m.startswith("  "))
        print(f"contract {label} ({card}): {gates} lines of gates passed in {dt:.2f} s")
    got = dict(fa.LAUNCH_COUNTS)
    print(f"contract harnesses ({card}): all {len(CONTRACTS)} passed in "
          f"{time.perf_counter() - t_all:.2f} s; launches {got}")
    check(got["flash_forward"] > 0 and got["flash_decode"] > 0,
          "the contract harnesses must launch B1 and B4")
    return got


def phase_train(card: str) -> dict:
    """The training path: ``Solver.fit_batch`` on one fixed batch of 8 x 1024
    tokens, labels the ids shifted by one. Returns the launch counts of the
    timed steps."""
    lm = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12,
                       ffn_size=3072, max_len=T_FULL, seed=SEED, dtype="float32")
    model = lm.init()
    solver = Solver(model)
    rs = np.random.RandomState(SEED + 2)
    ids_np = rs.randint(0, 50257, (B, T_FULL + 1))
    ids = torch.from_numpy(ids_np[:, :-1]).cuda()
    labels = torch.from_numpy(ids_np[:, 1:]).cuda()
    solver.fit_batch(ids, labels)  # warm-up: library handles, allocator pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the training path: counts from 0, TRAIN_STEPS steps ----
    fa.reset_launch_counts()
    scores, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        before = dict(fa.LAUNCH_COUNTS)
        t0 = time.perf_counter()
        score, _ = solver.fit_batch(ids, labels)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        scores.append(float(score))
        per_step = {n: fa.LAUNCH_COUNTS[n] - before[n] for n in before}
        check(per_step == {"flash_forward": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                           "flash_decode": 0},
              f"a training step must launch B1, B2 and B3 once per block (12): {per_step}")
    counts = dict(fa.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    print(f"launches in {TRAIN_STEPS} training steps: {counts}")
    check(all(np.isfinite(scores)), f"training scores must be finite: {scores}")
    check(scores[-1] < scores[0], f"the score must fall over the steps: {scores}")
    ms = float(np.median(step_ms))
    print(f"training ({card}): Solver.fit_batch [8,1024] Adam(1e-4), {TRAIN_STEPS} steps "
          f"after one warm-up: median {ms:.2f} ms/step of "
          f"{[round(t, 2) for t in step_ms]} = {B * T_FULL / ms * 1e3:.1f} tokens/s; "
          f"scores {[round(x, 5) for x in scores]}; peak memory {peak / 2**30:.2f} GiB")

    # ---- correctness: kernel-path gradients vs materialised scores ----
    grads = model.calculate_gradients(ids, labels)
    ref = _with_impl("reference", lambda: model.calculate_gradients(ids, labels))
    worst = _worst_grad(grads, ref, "the kernels")
    print(f"gradients through the kernels vs the reference: worst rel error "
          f"{worst[0]:.3e} at {worst[1]} (tol {TOL_GRAD_REL:g})")
    check(worst[0] <= TOL_GRAD_REL, "kernel-path gradients disagree with the reference")
    return counts


def _all_counts() -> dict:
    return {**fa.LAUNCH_COUNTS, **fa.GROUPED_MATMUL_LAUNCH_COUNTS}


def phase_moe(card: str):
    """The MoE network's paths: ``output()`` on [8, 1024] ids without and
    with a ragged mask, then ``TRAIN_STEPS`` ``Solver.fit_batch`` steps;
    then its grouped dispatch (B5) against sort dispatch on the same
    params. Returns the launch counts over both paths and the per-expert
    row counts the last training step routed."""
    t0 = time.perf_counter()
    model = MultiLayerNetwork(moe_lm_conf()).init()  # on the current CUDA device
    torch.cuda.synchronize()
    print(f"moe model: one GPT-2-small-width block + MoE (8 experts x hidden 1536, top-2, "
          f"capacity factor 1.25), {model.num_params()} params, init "
          f"{time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(SEED + 3)
    ids_np = rs.randint(0, 50257, (B, T_FULL + 1))
    ids = torch.from_numpy(ids_np[:, :-1]).cuda()
    labels = torch.from_numpy(ids_np[:, 1:]).cuda()
    lens = torch.tensor([T_FULL, 700] + rs.randint(200, T_FULL, B - 2).tolist())
    mask = (torch.arange(T_FULL)[None, :] < lens[:, None]).float().cuda()
    real = int(mask.sum())
    solver = Solver(model)
    # warm-up at the timed shapes: library handles, allocator pools
    model.output(ids)
    model.output(ids, mask)
    solver.fit_batch(ids, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- output(): counts from 0 for each call ----
    serve, out_ms = {}, {}
    for label, m in (("no mask", None), ("ragged mask", mask)):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        probs = model.output(ids, m)
        torch.cuda.synchronize()
        out_ms[label] = 1e3 * (time.perf_counter() - t0)
        counts = _all_counts()
        check(counts == {"flash_forward": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                         "flash_decode": 0, "grouped_matmul": 2},
              f"MoE output() must launch B1 once and B5 twice: {counts}")
        serve = {n: serve.get(n, 0) + c for n, c in counts.items()}
        check(tuple(probs.shape) == (B, 50257, T_FULL) and bool(torch.isfinite(probs).all()),
              "MoE output() must be finite [8, 50257, 1024]")
        sums = probs[:, :, :: 128].sum(dim=1)
        check(float((sums - 1).abs().max()) < 1e-4, "softmax rows must sum to 1")
        del probs

    # ---- training: counts from 0, TRAIN_STEPS steps ----
    fa.reset_launch_counts()
    scores, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        before = _all_counts()
        t0 = time.perf_counter()
        score, _ = solver.fit_batch(ids, labels)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        scores.append(float(score))
        per_step = {n: c - before[n] for n, c in _all_counts().items()}
        check(per_step == {"flash_forward": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                           "flash_decode": 0, "grouped_matmul": 4},
              f"a MoE training step must launch B1, B2, B3 once and B5 4 times: {per_step}")
    train = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(scores)), f"MoE training scores must be finite: {scores}")
    check(scores[-1] < scores[0], f"the MoE score must fall over the steps: {scores}")
    st = model.state[MOE_LAYER]
    routed = [int(v) for v in st["expert_tokens"].tolist()]
    kept, dropped = sum(routed), float(st["dropped_tokens"])
    check(kept + dropped == TOPK * B * T_FULL and float(st["capacity_slots"]) == E_MOE * CAPACITY,
          f"every assignment is kept or dropped: {routed} + {dropped}")
    with torch.no_grad():  # the masked path's state
        _, new_state, _ = model.forward_pure(model.params, model.state, ids, mask=mask)
    st_m = new_state[MOE_LAYER]
    m_kept, m_dropped = float(st_m["expert_tokens"].sum()), float(st_m["dropped_tokens"])
    check(m_kept + m_dropped == TOPK * real,
          f"masked: kept {m_kept} + dropped {m_dropped} != 2 x {real} real tokens")
    ms = float(np.median(step_ms))
    print(f"moe serving: output() [8,1024] {out_ms['no mask']:.2f} ms, with a ragged mask "
          f"({real} real tokens) {out_ms['ragged mask']:.2f} ms")
    print(f"moe training ({card}): Solver.fit_batch [8,1024] Adam(1e-4), {TRAIN_STEPS} steps "
          f"after one warm-up: median {ms:.2f} ms/step of {[round(t, 2) for t in step_ms]} = "
          f"{B * T_FULL / ms * 1e3:.1f} tokens/s; scores {[round(x, 5) for x in scores]}; "
          f"peak memory {peak / 2**30:.2f} GiB; last step routed {routed} (capacity "
          f"{CAPACITY}), dropped {dropped:.0f} of {TOPK * B * T_FULL}; masked call kept "
          f"{m_kept:.0f}, dropped {m_dropped:.0f}")

    # ---- correctness: grouped dispatch (B5) vs sort dispatch (torch.bmm) ----
    sort_model = MultiLayerNetwork(moe_lm_conf("sort")).init()
    sort_model.load_state_dict(model.state_dict())
    out_g, out_s = model.output(ids, mask), sort_model.output(ids, mask)
    e_out = rel_err(out_g, out_s)
    del out_g, out_s
    grads = model.calculate_gradients(ids, labels, mask)
    ref = sort_model.calculate_gradients(ids, labels, mask)
    worst = _worst_grad(grads, ref, "grouped dispatch")
    print(f"moe grouped vs sort dispatch (ragged mask): output rel error {e_out:.3e} "
          f"(tol {TOL_BWD_REL[torch.float32]:g}); gradients worst rel error {worst[0]:.3e} "
          f"at {worst[1]} (tol {TOL_GRAD_REL:g})")
    check(e_out <= TOL_BWD_REL[torch.float32], "grouped-dispatch outputs disagree with sort")
    check(worst[0] <= TOL_GRAD_REL, "grouped-dispatch gradients disagree with sort")
    del sort_model, grads, ref
    return {n: serve[n] + train[n] for n in serve}, routed


def phase_lm_head256() -> dict:
    """C1, head dim 256: ``TransformerLM(hidden=2048, n_heads=8)``, float32,
    the d_model and 8 heads of 256 of Gemma 2B (Gemma Team 2024), GPT-2's
    vocab (50257) and 1024 positions, depth cut to 2 blocks (what the phase
    adds is the d = 256 instantiations under the entry points, not depth). ``output()`` on [2, 1024], the gradients, 2 ``Solver.fit_batch``
    steps and ``generate()`` of 16 greedy tokens, each against the
    materialised-scores seam. Returns the launch counts of its paths."""
    lm = TransformerLM(vocab_size=50257, hidden=2048, n_layers=2, n_heads=8,
                       max_len=T_FULL, seed=SEED, dtype="float32")
    model = lm.init()
    rs = np.random.RandomState(SEED + 5)
    ids_np = rs.randint(0, 50257, (2, T_FULL + 1))
    ids = torch.from_numpy(ids_np[:, :-1]).cuda()
    labels = torch.from_numpy(ids_np[:, 1:]).cuda()
    print(f"head-dim-256 model: TransformerLM hidden 2048, 8 heads of 256 (Gemma 2B's head "
          f"width), 2 blocks (depth cut; Gemma 2B has 18), vocab 50257, "
          f"{model.num_params()} params, float32")
    total = {n: 0 for n in fa.LAUNCH_COUNTS}

    def counted(fn):
        fa.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = dict(fa.LAUNCH_COUNTS)
        for n, c in got.items():
            total[n] += c
        return out, got

    probs, got = counted(lambda: model.output(ids))
    check(got == {"flash_forward": 2, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_decode": 0},
          f"output() must launch B1 once a block: {got}")
    ref = _with_impl("reference", lambda: model.output(ids))
    e_out = rel_err(probs, ref)
    check(bool(torch.isfinite(probs).all()) and e_out <= TOL_OUT_REL,
          f"head-dim-256 output() disagrees with the reference: {e_out:.3e}")
    del probs, ref
    grads, got = counted(lambda: model.calculate_gradients(ids, labels))
    check(got["flash_bwd_dq"] == 2 and got["flash_bwd_dkv"] == 2,
          f"the gradients must launch B2 and B3 once a block: {got}")
    worst = _worst_grad(grads, _with_impl("reference", lambda: model.calculate_gradients(
        ids, labels)), "the d = 256 kernels")
    check(worst[0] <= TOL_GRAD_REL, "head-dim-256 gradients disagree with the reference")
    del grads
    solver = Solver(model)
    scores = []
    for _ in range(2):
        (score, _), got = counted(lambda: solver.fit_batch(ids, labels))
        check(got == {"flash_forward": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                      "flash_decode": 0}, f"a step must launch B1, B2, B3 once a block: {got}")
        scores.append(float(score))
    check(all(np.isfinite(scores)), f"head-dim-256 training scores must be finite: {scores}")
    prompts = [rs.randint(0, 50257, n).tolist() for n in (300, 700)]
    session = GenerationSession(model, max_len=T_FULL)
    toks, got = counted(lambda: session.generate(prompts, 16))
    check(got["flash_decode"] == 2 * 15, f"generate() must launch B4 2 x 15 times: {got}")
    ref_toks = _with_impl("reference", lambda: session.generate(prompts, 16))
    check(toks == ref_toks, f"greedy tokens differ from the reference: {toks} vs {ref_toks}")
    print(f"head-dim-256 model: output() rel error {e_out:.3e} (tol {TOL_OUT_REL:g}); gradients "
          f"worst rel error {worst[0]:.3e} at {worst[1]} (tol {TOL_GRAD_REL:g}); 2 steps, "
          f"scores {[round(x, 5) for x in scores]}; 16 greedy tokens a row equal the "
          f"reference's; launches {total}")
    return total


def phase_lm_f16(prompts) -> dict:
    """C1, float16: the GPT-2-small-width LM (12 blocks, 12 heads of 64)
    with ``dtype="float16"``. ``output()`` on [8, 1024] through B1 and
    ``generate()`` of 16 greedy tokens through B4, against the
    materialised-scores seam in float16: the output probabilities, and
    each decode step's probabilities with both seams fed the generated
    tokens (prefill takes the reference spelling under both seams). Returns
    the launch counts of ``output()`` and ``generate()``."""
    lm = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12, ffn_size=3072,
                       max_len=T_FULL, seed=SEED, dtype="float16")
    model = lm.init()
    ids = np.random.RandomState(SEED + 6).randint(0, 50257, (B, T_FULL))
    fa.reset_launch_counts()
    probs = model.output(ids)
    torch.cuda.synchronize()
    after_output = dict(fa.LAUNCH_COUNTS)
    check(after_output["flash_forward"] == 12, f"output() must launch B1 12 times: {after_output}")
    ref = _with_impl("reference", lambda: model.output(ids))
    check(probs.dtype == torch.float16 and bool(torch.isfinite(probs).all()),
          "float16 output() must be finite float16")
    e_out = rel_err(probs, ref)
    del probs, ref
    session = GenerationSession(model, max_len=T_FULL)
    n_tok = 16
    fa.reset_launch_counts()
    toks = session.generate(prompts, n_tok)
    torch.cuda.synchronize()
    counts = {n: after_output[n] + c for n, c in fa.LAUNCH_COUNTS.items()}
    check(fa.LAUNCH_COUNTS["flash_decode"] == 12 * (n_tok - 1),
          f"generate() must launch B4 12 x {n_tok - 1} times: {dict(fa.LAUNCH_COUNTS)}")
    ref_toks = _with_impl("reference", lambda: session.generate(prompts, n_tok))
    carry_k, _, _ = session.prefill(prompts)
    carry_r, _, _ = session.prefill(prompts)
    e_dec = 0.0
    for s_ in range(n_tok - 1):
        step = [row[s_] for row in toks]
        carry_k, lk = session.decode(carry_k, step)
        carry_r, lr = _with_impl("reference", lambda: session.decode(carry_r, step))
        e_dec = max(e_dec, rel_err(lk.float().exp(), lr.float().exp()))
    agree = sum(a == b for ra, rb in zip(toks, ref_toks) for a, b in zip(ra, rb))
    print(f"float16 model (GPT-2-small widths): output() [8,1024] probabilities rel error "
          f"{e_out:.3e}, decode-step probabilities rel error {e_dec:.3e} (tol {TOL_F16_REL:g}); "
          f"greedy tokens equal to the reference's: {agree} of {B * n_tok}; launches {counts}")
    check(e_out <= TOL_F16_REL and e_dec <= TOL_F16_REL,
          "the float16 model disagrees with the reference seam")
    return counts


def phase_lm_f64() -> dict:
    """C1, float64: a small LM (vocab 1000, hidden 256, 4 heads of 64, 2
    blocks, 256 positions) with ``dtype="float64"``, through the float64
    kernels: ``output()``, the gradients and one ``Solver.fit_batch`` step
    (two copies of the model, one a seam), and a greedy ``generate()``,
    against the reference seam to 1e-10. Returns the launch counts."""
    lm = TransformerLM(vocab_size=1000, hidden=256, n_layers=2, n_heads=4, max_len=256,
                       seed=SEED, dtype="float64")
    models = {impl: lm.init() for impl in ("auto", "reference")}
    rs = np.random.RandomState(SEED + 7)
    ids_np = rs.randint(0, 1000, (4, 257))
    ids = torch.from_numpy(ids_np[:, :-1]).cuda()
    labels = torch.from_numpy(ids_np[:, 1:]).cuda()
    model = models["auto"]
    fa.reset_launch_counts()
    out = model.output(ids)
    grads = model.calculate_gradients(ids, labels)
    score, _ = Solver(model).fit_batch(ids, labels)
    prompts = [rs.randint(0, 1000, n).tolist() for n in (10, 100, 37, 200)]
    session = GenerationSession(model, max_len=256)
    toks = session.generate(prompts, 16)
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCH_COUNTS)
    check(counts == {"flash_forward": 2 + 2 + 2, "flash_bwd_dq": 4, "flash_bwd_dkv": 4,
                     "flash_decode": 2 * 15}, f"float64 launches: {counts}")
    rm = models["reference"]
    ref_out = _with_impl("reference", lambda: rm.output(ids))
    ref_grads = _with_impl("reference", lambda: rm.calculate_gradients(ids, labels))
    ref_score, _ = _with_impl("reference", lambda: Solver(rm).fit_batch(ids, labels))
    ref_toks = _with_impl("reference", lambda: GenerationSession(rm, max_len=256).generate(
        prompts, 16))
    e_out = rel_err(out, ref_out)
    worst = _worst_grad(grads, ref_grads, "the float64 kernels")
    sd, ref_sd = model.state_dict(), rm.state_dict()
    e_step = max(rel_err(sd[n], ref_sd[n]) for n in ref_sd if ref_sd[n].is_floating_point())
    e_score = abs(float(score) - float(ref_score)) / abs(float(ref_score))
    print(f"float64 model: output() rel error {e_out:.3e}, gradients worst {worst[0]:.3e} at "
          f"{worst[1]}, one Adam step: score {e_score:.3e}, params {e_step:.3e} (tol "
          f"{TOL_F64_REL:g}); greedy tokens equal: {toks == ref_toks}; launches {counts}")
    check(out.dtype == torch.float64 and max(e_out, worst[0], e_step, e_score) <= TOL_F64_REL,
          "the float64 model disagrees with the reference seam")
    check(toks == ref_toks, "float64 greedy tokens differ from the reference")
    return counts


def phase_moe_f64() -> dict:
    """C1, float64 through B5: a small MoE network (4 experts of hidden 128,
    top-2, grouped dispatch) with ``data_type("float64")``, one ``output()``
    call through B5's float64 kernel against the grouped matmul's plain
    version (the ``"reference"`` impl), to 1e-10."""
    conf = (NeuralNetConfiguration.builder().seed(SEED).data_type("float64").list()
            .layer(MixtureOfExpertsLayer(n_out=96, num_experts=4, hidden=128, top_k=2,
                                         dispatch_mode="grouped"))
            .layer(OutputLayer(n_out=10, loss=LossFunction.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(64)).build())
    net = MultiLayerNetwork(conf).init()
    x = torch.from_numpy(np.random.RandomState(SEED + 8).randn(512, 64)).cuda()
    fa.reset_launch_counts()
    out = net.output(x)
    torch.cuda.synchronize()
    counts = _all_counts()
    check(counts["grouped_matmul"] == 2, f"the MoE layer must launch B5 twice: {counts}")
    fa.set_grouped_matmul_impl("reference")
    try:
        ref = net.output(x)
    finally:
        fa.set_grouped_matmul_impl("auto")
    e = rel_err(out, ref)
    print(f"float64 MoE layer through B5: output() [512, 64] rel error {e:.3e} "
          f"(tol {TOL_F64_REL:g}); launches {counts}")
    check(out.dtype == torch.float64 and e <= TOL_F64_REL,
          "the float64 MoE layer disagrees with the plain grouped matmul")
    return counts


def _helpers_gap(fn) -> float:
    """``fn()`` under the "cudnn" conv2d helper against under "im2col"."""
    a = fn()
    helpers.set_helper("conv2d", "im2col")
    try:
        b = fn()
    finally:
        helpers.set_helper("conv2d", "cudnn")
    return rel_err(a, b)


@contextlib.contextmanager
def _cudnn_tf32_default():
    """cuDNN's TF32 switch at PyTorch's default (on) for the CNN phases
    (``phase_device`` turns it off for the rest): the port's own guard
    (``ops/helpers.py::convolution``) must keep the convolutions in
    float32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def phase_lenet(card: str) -> dict:
    """BASELINE config 1: the zoo ``LeNet()`` (28x28x1 ``convolutional_flat``
    input, 10 classes, both preprocessors inserted) through
    ``MultiLayerNetwork.output()`` and ``LENET_STEPS`` ``fit`` steps on one
    seeded batch of 64; then "cudnn" against "im2col" on ``output()``.
    Returns the launch counts of its path (no attention kernel)."""
    model = LeNet(seed=SEED).init()  # on the current CUDA device
    names = [type(l).__name__ for l in model.layers]
    check(names[0] == "FeedForwardToCnnPreProcessor" and names[5] == "CnnToFeedForwardPreProcessor"
          and model.num_params() == 1_256_080, f"LeNet layers {names}, {model.num_params()}")
    rs = np.random.RandomState(SEED + 9)
    x = torch.from_numpy(rs.rand(LENET_BATCH, 784).astype(np.float32)).cuda()
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[rs.randint(0, 10, LENET_BATCH)]).cuda()
    model.output(x)  # warm-up: cuDNN handles, allocator pools
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    probs = model.output(x)
    torch.cuda.synchronize()
    out_ms = 1e3 * (time.perf_counter() - t0)
    check(tuple(probs.shape) == (LENET_BATCH, 10) and bool(torch.isfinite(probs).all())
          and float((probs.sum(1) - 1).abs().max()) < 1e-5, "LeNet output() rows")
    scores = []
    t0 = time.perf_counter()
    for _ in range(LENET_STEPS):
        model.fit(x, y)
        scores.append(model.score_value)
    step_ms = 1e3 * (time.perf_counter() - t0) / LENET_STEPS
    counts = _all_counts()
    check(all(np.isfinite(scores)) and scores[-1] < scores[0],
          f"LeNet scores must be finite and falling: {scores}")
    gap = _helpers_gap(lambda: model.output(x))
    print(f"lenet ({card}): MultiLayerNetwork {model.num_params()} params, output() "
          f"[{LENET_BATCH},784] {out_ms:.2f} ms, {LENET_STEPS} fit steps {step_ms:.2f} ms/step "
          f"({LENET_BATCH / step_ms * 1e3:.0f} images/s); scores {scores[0]:.5f} -> "
          f"{scores[-1]:.5f}; cudnn vs im2col output() gap {gap:.3e} of the largest "
          f"probability (tol {TOL_CONV_HELPERS:g}); launches {counts}")
    check(gap <= TOL_CONV_HELPERS, "LeNet output() under cudnn and im2col disagree")
    return counts


def phase_resnet50(card: str) -> dict:
    """BASELINE config 2: the zoo ``ResNet50()`` at He et al. 2015's widths
    (224x224x3, stages [3, 4, 6, 3], 1000 classes, 25,557,032 params,
    ``Adam(1e-3)``), nothing cut, batch ``RESNET_BATCH``: ``output()`` in
    eval mode and ``TRAIN_STEPS`` ``GraphSolver.fit_batch`` steps, with
    cuDNN's TF32 switch at its default. Then the precision check (2 images
    through the card's float32 ``output()`` and the CPU's float64, same
    weights and statistics) and "cudnn" against "im2col" on ``output()``
    (batch 4). Returns the launch counts of its path (no attention
    kernel)."""
    t0 = time.perf_counter()
    model = ResNet50(seed=SEED).init()  # on the current CUDA device
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model.num_params() == 25_557_032 and len(model.conf.vertices) == 174,
          f"ResNet-50 has {model.num_params()} params")
    rs = np.random.RandomState(SEED + 10)
    x = torch.from_numpy(rs.randn(RESNET_BATCH, 3, 224, 224).astype(np.float32)).cuda()
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, RESNET_BATCH)]).cuda()
    bn = [n for n, st in model.state.items() if "mean" in st]
    stats0 = {n: {k: t.clone() for k, t in model.state[n].items()} for n in bn}
    solver = GraphSolver(model)
    model.output(x)  # warm-up: cuDNN handles, allocator pools
    torch.cuda.synchronize()
    with _cudnn_tf32_default():
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        n_out = 3
        for _ in range(n_out):
            probs = model.output(x)
        torch.cuda.synchronize()
        out_ms = 1e3 * (time.perf_counter() - t0) / n_out
        check(tuple(probs.shape) == (RESNET_BATCH, 1000) and bool(torch.isfinite(probs).all()),
              "ResNet-50 output() must be finite [32, 1000]")
        torch.cuda.reset_peak_memory_stats()
        scores, step_ms = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            score = solver.fit_batch((x,), (y,))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            scores.append(float(score))
        counts = _all_counts()
        peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(scores)) and scores[-1] < scores[0],
          f"ResNet-50 scores must be finite and falling: {scores}")
    unmoved = [n for n in bn for k in ("mean", "var")
               if torch.equal(model.state[n][k], stats0[n][k])]
    check(not unmoved, f"batch-norm running statistics that did not move: {unmoved}")
    ms = float(np.median(step_ms))
    RESNET_IMAGES_PER_S["output"] = RESNET_BATCH / out_ms * 1e3
    print(f"resnet50 ({card}): ComputationGraph {model.num_params()} params, "
          f"{len(model.conf.vertices)} vertices, {len(bn)} batch norms, init {init_s:.2f} s; "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark}, cudnn.allow_tf32=True (the "
          f"port's guard keeps float32); output() [{RESNET_BATCH},3,224,224] {out_ms:.2f} ms = "
          f"{RESNET_BATCH / out_ms * 1e3:.1f} images/s; GraphSolver.fit_batch Adam(1e-3), "
          f"{TRAIN_STEPS} steps after a warm-up forward: median {ms:.2f} ms/step of "
          f"{[round(t, 2) for t in step_ms]} = {RESNET_BATCH / ms * 1e3:.1f} images/s; scores "
          f"{[round(v, 5) for v in scores]}; peak memory {peak / 2**30:.2f} GiB; every batch "
          f"norm's running mean and var moved; launches {counts}")

    # ---- precision: the card's float32 against float64 on the CPU ----
    cpu = ResNet50(seed=SEED, dtype="float64").init(device="cpu")
    cpu.set_params_flat(model.params_flat())
    cpu.state = {n: {k: t.double().cpu() for k, t in st.items()} for n, st in model.state.items()}
    # two fresh images: the training batch's own are memorised by now
    x2 = torch.from_numpy(rs.randn(2, 3, 224, 224).astype(np.float32)).cuda()
    feats = {}

    def pooled(m, xx):
        """Pooled features, logits and probabilities of ``output()``'s walk."""
        with torch.inference_mode():
            acts, _ = m.forward_pure(m.params, m.state, m._as_inputs((xx,)))
            fc = m.conf.spec("fc").layer
            logits = fc.preoutput(m.params["fc"], acts["avgpool"], LayerContext())
        return [t.double().cpu() for t in (acts["avgpool"], logits, acts["fc"])]

    with _cudnn_tf32_default():
        feats["card"] = pooled(model, x2)
        with mock.patch.object(helpers, "_no_tf32", contextlib.nullcontext):
            feats["tf32"] = pooled(model, x2)  # the guard off: TF32 convolutions
    feats["cpu"] = pooled(cpu, x2.double().cpu())
    gaps = [rel_err(a, b) for a, b in zip(feats["card"], feats["cpu"])]
    tf32 = [rel_err(a, b) for a, b in zip(feats["tf32"], feats["cpu"])]
    top = feats["cpu"][2].max(dim=1).values.tolist()
    print(f"resnet50 precision ({card}): 2 images, float32 card output() vs float64 CPU, "
          f"max error over the largest value: pooled features {gaps[0]:.3e}, logits "
          f"{gaps[1]:.3e}, probabilities {gaps[2]:.3e} (tol {TOL_F32_VS_F64:g}; top "
          f"probabilities {[round(v, 5) for v in top]}: an untrained ResNet saturates its "
          f"softmax in inference); with the TF32 guard off: {tf32[0]:.3e}, {tf32[1]:.3e}, "
          f"{tf32[2]:.3e}")
    check(max(gaps) <= TOL_F32_VS_F64,
          "ResNet-50's float32 output() on the card disagrees with float64")
    del cpu
    with _cudnn_tf32_default():
        gap = _helpers_gap(lambda: model.output(x[:4]))
    print(f"resnet50 cudnn vs im2col output() [4,3,224,224]: {gap:.3e} of the largest "
          f"probability (tol {TOL_CONV_HELPERS:g})")
    check(gap <= TOL_CONV_HELPERS, "ResNet-50 output() under cudnn and im2col disagree")
    del model, solver
    return counts


def phase_bert(card: str) -> dict:
    """The zoo ``BertEncoder()`` at bert-base's published widths (Devlin et
    al. 2018: L 12, H 768, A 12, FFN 3072, vocab 30522, 512 positions),
    nothing cut, a ``ComputationGraph``: ``output(ids, masks=[mask])`` on
    [8, 512] with seeded ragged key masks (lengths in [128, 512]) and
    ``TRAIN_STEPS`` masked ``GraphSolver.fit_batch`` steps on sparse MLM
    labels, through B1 (non-causal, key mask) and B2/B3. Then the kernel
    route against the materialised-scores seam: ``output()`` at full size,
    gradients on a 2-block cut. Returns the launch counts of its path."""
    t0 = time.perf_counter()
    model = BertEncoder(seed=SEED).init()  # on the current CUDA device
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model.num_params() == 132_324_666 and len(model.conf.vertices) == 88,
          f"BertEncoder has {model.num_params()} params")
    rs = np.random.RandomState(SEED + 11)
    ids = torch.from_numpy(rs.randint(0, 30522, (BERT_BATCH, BERT_T))).cuda()
    labels = torch.from_numpy(rs.randint(0, 30522, (BERT_BATCH, BERT_T))).cuda()
    lens = torch.tensor([BERT_T, 128] + rs.randint(128, BERT_T + 1, BERT_BATCH - 2).tolist())
    mask = (torch.arange(BERT_T)[None, :] < lens[:, None]).float().cuda()
    real = int(mask.sum())
    solver = GraphSolver(model)
    model.output(ids, masks=[mask])  # warm-up
    solver.fit_batch((ids,), (labels,), masks=(mask,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    probs = model.output(ids, masks=[mask])
    torch.cuda.synchronize()
    out_ms = 1e3 * (time.perf_counter() - t0)
    serve = _all_counts()
    check(serve == {"flash_forward": 12, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                    "flash_decode": 0, "grouped_matmul": 0},
          f"BERT output() must launch B1 once a block: {serve}")
    check(tuple(probs.shape) == (BERT_BATCH, 30522, BERT_T) and bool(torch.isfinite(probs).all()),
          "BERT output() must be finite [8, 30522, 512]")
    scores, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        before = _all_counts()
        t0 = time.perf_counter()
        score = solver.fit_batch((ids,), (labels,), masks=(mask,))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        scores.append(float(score))
        per_step = {n: c - before[n] for n, c in _all_counts().items()}
        check(per_step == {"flash_forward": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                           "flash_decode": 0, "grouped_matmul": 0},
              f"a BERT training step must launch B1, B2 and B3 once a block: {per_step}")
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(scores)) and scores[-1] < scores[0],
          f"BERT scores must be finite and falling: {scores}")
    ms = float(np.median(step_ms))
    tok = BERT_BATCH * BERT_T
    print(f"bert-base ({card}): ComputationGraph {model.num_params()} params, "
          f"{len(model.conf.vertices)} vertices, init {init_s:.2f} s; output(ids, masks) "
          f"[{BERT_BATCH},{BERT_T}] ({real} unmasked of {tok} positions) {out_ms:.2f} ms = "
          f"{tok / out_ms * 1e3:.0f} tokens/s; GraphSolver.fit_batch Adam(1e-4) masked, "
          f"{TRAIN_STEPS} steps after one warm-up: median {ms:.2f} ms/step of "
          f"{[round(t, 2) for t in step_ms]} = {tok / ms * 1e3:.0f} tokens/s; scores "
          f"{[round(v, 5) for v in scores]}; peak memory {peak / 2**30:.2f} GiB; launches "
          f"{counts}")

    # ---- the kernel route against the materialised-scores seam ----
    del probs
    probs = model.output(ids, masks=[mask])
    ref = _with_impl("reference", lambda: model.output(ids, masks=[mask]))
    e_out = rel_err(probs, ref)
    del probs, ref, solver, model
    cut = BertEncoder(seed=SEED, n_layers=2).init()
    grads = cut.calculate_gradients(ids, labels, mask=[mask])
    ref_grads = _with_impl("reference", lambda: cut.calculate_gradients(ids, labels,
                                                                         mask=[mask]))
    worst = _worst_grad(grads, ref_grads, "the kernels")
    print(f"bert-base kernels vs the reference seam: output() rel error {e_out:.3e} (tol "
          f"{TOL_OUT_REL:g}); gradients on a 2-block cut (the same widths, 2 of 12 blocks) "
          f"worst rel error {worst[0]:.3e} at {worst[1]} (tol {TOL_GRAD_REL:g})")
    check(e_out <= TOL_OUT_REL, "BERT output() through B1 disagrees with the reference")
    check(worst[0] <= TOL_GRAD_REL, "BERT gradients through B1-B3 disagree with the reference")
    return counts


def _onehot(ids: np.ndarray, v: int) -> torch.Tensor:
    """[b, t] character ids -> one-hot [b, v, t] float32 on the card."""
    return F.one_hot(torch.from_numpy(ids).long().cuda(), v).float().transpose(1, 2)


def phase_char_rnn(card: str) -> dict:
    """The zoo ``TextGenerationLSTM()`` (BASELINE.json:9, the GravesLSTM
    char-RNN; the JAX package measures it in ``bench.py:396-433``): vocab
    77, hidden 200, 2 GravesLSTM layers with peepholes, RnnOutputLayer
    MCXENT/softmax, TBPTT 50/50, RmsProp(1e-3), float32, nothing cut.
    ``CHAR_BATCHES`` ``Solver.fit`` batches of 32 x 200 one-hot characters
    (4 TBPTT windows each); ``output()`` on the card against the same
    weights in float64 on the CPU; ``rnn_time_step`` one character at a
    time against ``output()``; ``TextGenerationLSTM.generate`` of 200
    greedy characters on 8 ragged prompts (10-100 characters) through
    ``GenerationSession``, whose decode step replays a CUDA graph. The
    recurrence is plain PyTorch: no B kernel launches. Returns the launch
    counts of its path."""
    model = TextGenerationLSTM().init()
    check(model.num_params() == 559_877, f"TextGenerationLSTM has {model.num_params()} params")
    rs = np.random.RandomState(SEED + 20)
    ids = rs.randint(0, CHAR_V, (CHAR_BATCH, CHAR_T + 1))
    x, y = _onehot(ids[:, :-1], CHAR_V), _onehot(ids[:, 1:], CHAR_V)
    solver = Solver(model)
    solver.fit(x, y)  # warm-up: library handles, allocator pools
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated()  # weights, moments, batch, earlier phases' leftovers
    torch.cuda.reset_peak_memory_stats()

    # ---- the training path: counts from 0, CHAR_BATCHES batches ----
    fa.reset_launch_counts()
    scores, batch_ms = [], []
    for _ in range(CHAR_BATCHES):
        t0 = time.perf_counter()
        solver.fit(x, y)
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        scores.append(model.score_value)
    train_counts = _all_counts()
    peak = torch.cuda.max_memory_allocated() - rest
    check(all(np.isfinite(scores)) and scores[-1] < scores[0],
          f"char-RNN scores must be finite and falling: {scores}")
    busy, launches, rows = _device_profile(lambda: solver.fit(x, y))
    ms = float(np.median(batch_ms))
    idle = 1 - busy / ms
    print(f"char-rnn ({card}): TextGenerationLSTM {model.num_params()} params; Solver.fit "
          f"[{CHAR_BATCH},{CHAR_V},{CHAR_T}] TBPTT {model.conf.tbptt_fwd_length} "
          f"({CHAR_T // model.conf.tbptt_fwd_length} windows) RmsProp(1e-3), {CHAR_BATCHES} "
          f"batches after one warm-up: median {ms:.2f} ms/batch of "
          f"{[round(t, 2) for t in batch_ms]} = {CHAR_BATCH * CHAR_T / ms * 1e3:.0f} chars/s; "
          f"scores (last window) {[round(v, 5) for v in scores]}; peak memory above resting "
          f"{peak / 2**20:.1f} MiB; one profiled batch: {launches:.0f} kernel launches, device "
          f"busy {busy:.2f} ms (idle share {idle:.3f} of the median batch); B launches "
          f"{train_counts}")
    for key, kms, count in rows[:5]:
        print(f"    {kms:9.3f} ms  {count:6.0f}x  {key[:90]}")

    # ---- output() on the card in f32 against float64 on the CPU ----
    model.output(x)  # warm-up: the inference path's first call
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    probs = model.output(x)
    torch.cuda.synchronize()
    out_ms = 1e3 * (time.perf_counter() - t0)
    check(tuple(probs.shape) == (CHAR_BATCH, CHAR_V, CHAR_T) and bool(torch.isfinite(probs).all()),
          "char-RNN output() must be finite [32, 77, 200]")
    ref64 = MultiLayerNetwork(dataclasses.replace(model.conf, dtype="float64"), device="cpu").init()
    with torch.no_grad():
        for (_, p64), (_, p) in zip(ref64.named_parameters(), model.named_parameters()):
            p64.copy_(p.double().cpu())
    e64 = rel_err(probs.cpu(), ref64.output(x.double().cpu()))
    print(f"char-rnn output() [{CHAR_BATCH},{CHAR_V},{CHAR_T}] {out_ms:.2f} ms; f32 on the card vs "
          f"f64 on the CPU: max abs error over the largest probability {e64:.3e} "
          f"(tol {TOL_LSTM_F32_VS_F64:g})")
    check(e64 <= TOL_LSTM_F32_VS_F64, "char-RNN f32 output() disagrees with float64")

    # ---- rnn_time_step, one character at a time ----
    model.rnn_clear_previous_state()
    t0 = time.perf_counter()
    steps = [model.rnn_time_step(x[:, :, t]) for t in range(CHAR_T)]
    torch.cuda.synchronize()
    stream_ms = 1e3 * (time.perf_counter() - t0) / CHAR_T
    e_stream = rel_err(torch.stack(steps, dim=2), probs)
    model.rnn_clear_previous_state()
    print(f"char-rnn rnn_time_step one character at a time ({stream_ms:.3f} ms a call) vs "
          f"output(): max abs error over the largest probability {e_stream:.3e} "
          f"(tol {TOL_STREAM_REL:g})")
    check(e_stream <= TOL_STREAM_REL, "rnn_time_step disagrees with output()")
    del probs, steps

    # ---- generation through GenerationSession, the step a CUDA graph ----
    lens = [10, 100] + rs.randint(10, 101, B - 2).tolist()
    prompts = [rs.randint(0, CHAR_V, n).tolist() for n in lens]
    TextGenerationLSTM.generate(model, prompts, 4, max_len=CHAR_MAX_LEN)  # warm-up
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = TextGenerationLSTM.generate(model, prompts, CHAR_GEN_TOKENS, max_len=CHAR_MAX_LEN)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    gen_counts = _all_counts()
    check(all(len(r) == CHAR_GEN_TOKENS and all(0 <= c < CHAR_V for c in r) for r in gen),
          "generate() must return 200 valid characters a row")
    lp = _teacher_forced(model, prompts, gen, vocab=CHAR_V)
    gap, exact = 0.0, 0
    for lp_i, s_ in zip(lp, gen):
        tok = torch.tensor(s_, device=lp_i.device)[:, None]
        gap = max(gap, float((lp_i.max(dim=1).values - lp_i.gather(1, tok)[:, 0]).max()))
        exact += int((torch.argmax(lp_i, dim=1) == tok[:, 0]).sum())
    session = GenerationSession(model, max_len=CHAR_MAX_LEN)
    carry_g, logits_g, _ = session.prefill(prompts)
    carry_e, _, _ = session.prefill(prompts)
    toks = torch.argmax(logits_g, dim=-1)
    worst_ge, t_graph, t_eager = 0.0, [], []
    for s_ in range(24):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry_g, lg = session.decode(carry_g, toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            le = session.step(carry_e, toks.to(torch.int32))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if s_ >= 2:  # step 0 runs eagerly, step 1 captures
            t_graph.append(t1 - t0)
            t_eager.append(t2 - t1)
        worst_ge = max(worst_ge, max_err(lg, le))
        toks = torch.argmax(lg, dim=-1)
    check(session._graphs[B].step is not None, "decode() must replay a graph from step 2")
    session.release_graphs()
    gen_s = sorted(runs)[1]
    n_chars = B * CHAR_GEN_TOKENS
    print(f"char-rnn generate: 8 prompts of {sorted(lens)} characters, {CHAR_GEN_TOKENS} greedy "
          f"characters each, median {gen_s * 1e3:.1f} ms of {[round(r * 1e3, 1) for r in runs]} "
          f"= {n_chars / gen_s:.0f} chars/s; teacher-forced full forward: {exact} of {n_chars} "
          f"characters its exact argmax, worst gap below the position's largest log-prob "
          f"{gap:.3e} (tol {TOL_CHAR_LOGPROB:g}); graph step vs the uncaptured step, 24 steps: "
          f"logits max_abs {worst_ge:.3e} (tol 1e-6), graph {1e3 * np.median(t_graph):.3f} "
          f"ms/step, eager {1e3 * np.median(t_eager):.3f} ms/step")
    check(gap <= TOL_CHAR_LOGPROB, "char-RNN generate() is not greedy")
    check(worst_ge <= 1e-6, "the char-RNN graph step disagrees with the eager step")
    check(all(v == 0 for v in gen_counts.values()), f"the recurrence launches no B kernel: "
          f"{gen_counts}")
    return train_counts


def phase_learned_attention(card: str) -> dict:
    """``EmbeddingSequenceLayer`` -> ``LearnedSelfAttentionLayer(n_out=768,
    n_heads=12, n_queries=8)`` -> average pooling -> a 10-way softmax, on
    [8, 512] ids with seeded ragged key masks (128-512): ``output()`` and 2
    Adam steps through B1 (tq = 8 learned queries, tk = 512, non-causal,
    key mask) and B2/B3, held against the materialised-scores seam.
    Returns the launch counts of its path."""
    conf = (NeuralNetConfiguration.builder().seed(SEED).updater(Adam(1e-3)).list()
            .layer(EmbeddingSequenceLayer(n_in=LSA_VOCAB, n_out=768))
            .layer(LearnedSelfAttentionLayer(n_out=768, n_heads=12, n_queries=LSA_QUERIES))
            .layer(GlobalPoolingLayer(pooling_type=PoolingType.AVG))
            .layer(OutputLayer(n_out=LSA_CLASSES, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
            .set_input_type(InputType.recurrent(LSA_VOCAB)).build())
    model = MultiLayerNetwork(conf).init()
    rs = np.random.RandomState(SEED + 21)
    ids = torch.from_numpy(rs.randint(0, LSA_VOCAB, (BERT_BATCH, BERT_T))).cuda()
    lens = torch.tensor([BERT_T, 128] + rs.randint(128, BERT_T + 1, BERT_BATCH - 2).tolist())
    mask = (torch.arange(BERT_T)[None, :] < lens[:, None]).float().cuda()
    y = F.one_hot(torch.from_numpy(rs.randint(0, LSA_CLASSES, BERT_BATCH)).cuda(),
                  LSA_CLASSES).float()
    solver = Solver(model)
    model.output(ids, mask)  # warm-up
    Solver(model).fit_batch(ids, y, mask=mask)  # warm-up on a throwaway updater state
    torch.cuda.synchronize()

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    probs = model.output(ids, mask)
    torch.cuda.synchronize()
    out_ms = 1e3 * (time.perf_counter() - t0)
    check(_all_counts() == {"flash_forward": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                            "flash_decode": 0, "grouped_matmul": 0},
          f"output() must launch B1 once: {_all_counts()}")
    scores, step_ms = [], []
    for _ in range(2):
        before = _all_counts()
        t0 = time.perf_counter()
        score, _ = solver.fit_batch(ids, y, mask=mask)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        scores.append(float(score))
        per_step = {n: c - before[n] for n, c in _all_counts().items()}
        check(per_step == {"flash_forward": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                           "flash_decode": 0, "grouped_matmul": 0},
              f"a training step must launch B1, B2 and B3 once: {per_step}")
    counts = _all_counts()
    check(tuple(probs.shape) == (BERT_BATCH, LSA_CLASSES) and bool(torch.isfinite(probs).all())
          and all(np.isfinite(scores)), "LearnedSelfAttention outputs and scores must be finite")
    ref = _with_impl("reference", lambda: model.output(ids, mask))
    e_out = rel_err(model.output(ids, mask), ref)
    grads = model.calculate_gradients(ids, y, mask=mask)
    worst = _worst_grad(grads, _with_impl("reference", lambda: model.calculate_gradients(
        ids, y, mask=mask)), "the kernels")
    print(f"learned self-attention ({card}): {model.num_params()} params, [{BERT_BATCH},{BERT_T}] "
          f"ids, key lengths {sorted(lens.tolist())}, {LSA_QUERIES} queries x 12 heads of 64; "
          f"output() {out_ms:.2f} ms; 2 Solver.fit_batch Adam(1e-3) {[round(t, 2) for t in step_ms]} "
          f"ms, scores {[round(v, 5) for v in scores]}; launches {counts}; vs the reference seam: "
          f"output() rel error {e_out:.3e} (tol {TOL_OUT_REL:g}), gradients worst rel error "
          f"{worst[0]:.3e} at {worst[1]} (tol {TOL_GRAD_REL:g})")
    check(e_out <= TOL_OUT_REL, "LearnedSelfAttention output() through B1 disagrees")
    check(worst[0] <= TOL_GRAD_REL, "LearnedSelfAttention gradients through B1-B3 disagree")
    return counts


def _lm_conf(**changes):
    conf = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12, ffn_size=3072,
                         max_len=T_FULL, seed=SEED).conf()
    return dataclasses.replace(conf, **changes)


def _lm_batch():
    rs = np.random.RandomState(SEED + 2)
    ids = torch.from_numpy(rs.randint(0, 50257, (B, T_FULL + 1))).cuda()
    return ids[:, :-1], ids[:, 1:]


def _timed_steps(solver, ids, labels, n: int):
    """(scores, ms of each step, peak bytes allocated above the resting
    level) of ``n`` ``fit_batch`` steps after one warm-up."""
    solver.fit_batch(ids, labels)
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    scores, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        score, _ = solver.fit_batch(ids, labels)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        scores.append(float(score))
    return scores, ms, torch.cuda.max_memory_allocated() - rest


def phase_remat_and_bf16(card: str) -> dict:
    """The GPT-2-small-width ``TransformerLM`` of the "LM training" phase on
    its 8 x 1024 batch, three ways. ``gradient_checkpointing``: float32, the
    first loss and the gradients with and without it (each block's forward
    recomputed in the backward), 2 steps each with their peak memory.
    ``compute_dtype="bfloat16"`` with float32 master weights: ``output()``
    and ``BF16_STEPS`` steps through bf16 B1-B3, held against the bf16
    materialised-scores seam, beside the float32 step. Returns the launch
    counts of the checkpointed and bf16 paths."""
    ids, labels = _lm_batch()
    tok = B * T_FULL
    plain = MultiLayerNetwork(_lm_conf()).init()
    remat = MultiLayerNetwork(_lm_conf(gradient_checkpointing=True)).init()
    check(all(torch.equal(a, b) for a, b in zip(plain.parameters(), remat.parameters())),
          "the two LMs must start from the same weights")
    fa.reset_launch_counts()
    g_remat = remat.calculate_gradients(ids, labels)
    check(fa.LAUNCH_COUNTS["flash_forward"] == 24 and fa.LAUNCH_COUNTS["flash_bwd_dq"] == 12,
          f"a checkpointed backward runs each block's B1 twice: {dict(fa.LAUNCH_COUNTS)}")
    g_plain = plain.calculate_gradients(ids, labels)
    g_plain2 = plain.calculate_gradients(ids, labels)
    worst = _worst_grad(g_remat, g_plain, "checkpointing")
    rerun = _worst_grad(g_plain2, g_plain, "the plain path")
    del g_remat, g_plain, g_plain2
    s_plain, ms_plain, peak_plain = _timed_steps(Solver(plain), ids, labels, 2)
    del plain
    fa.reset_launch_counts()
    s_remat, ms_remat, peak_remat = _timed_steps(Solver(remat), ids, labels, 2)
    remat_counts = _all_counts()
    del remat
    loss_gap = abs(s_remat[0] - s_plain[0]) / abs(s_plain[0])
    print(f"gradient checkpointing ({card}): LM [8,1024] f32, Adam(1e-4); first loss after a "
          f"warm-up step {s_plain[0]:.7f} plain, {s_remat[0]:.7f} checkpointed (rel gap "
          f"{loss_gap:.3e}, tol {TOL_REMAT_LOSS_REL:g}); gradients worst rel error "
          f"{worst[0]:.3e} at {worst[1]} (tol {TOL_REMAT_GRAD_REL:g}; two plain runs differ by "
          f"{rerun[0]:.3e} at {rerun[1]}); step ms plain {[round(t, 2) for t in ms_plain]}, "
          f"checkpointed {[round(t, 2) for t in ms_remat]}; peak memory above the resting "
          f"weights and moments: plain {peak_plain / 2**30:.2f} GiB, checkpointed "
          f"{peak_remat / 2**30:.2f} GiB")
    check(loss_gap <= TOL_REMAT_LOSS_REL, "checkpointing changed the loss")
    check(worst[0] <= TOL_REMAT_GRAD_REL, "checkpointing changed the gradients")
    check(peak_remat < peak_plain, "checkpointing must lower the peak memory")

    bf = MultiLayerNetwork(_lm_conf(compute_dtype="bfloat16")).init()
    probe_ids = ids[:, :T_FULL]
    fa.reset_launch_counts()
    probs = bf.output(probe_ids)
    torch.cuda.synchronize()
    bf_out_counts = _all_counts()
    check(bf_out_counts["flash_forward"] == 12, f"bf16 output() launches B1 12 times: "
          f"{bf_out_counts}")
    check(probs.dtype == torch.float32 and bool(torch.isfinite(probs).all()),
          "bf16 compute output() must be finite float32")
    raw, _, _ = bf.forward_pure(bf.params, bf.state, bf._input(probe_ids[:1, :16]))
    check(raw.dtype == torch.bfloat16, "the layers must compute in bfloat16")
    e_out = rel_err(probs, _with_impl("reference", lambda: bf.output(probe_ids)))
    del probs
    grads = bf.calculate_gradients(ids, labels)
    check({g.dtype for lg in grads.values() for g in lg.values()} == {torch.float32},
          "master gradients must be float32")
    worst_bf = _worst_grad(grads, _with_impl("reference", lambda: bf.calculate_gradients(
        ids, labels)), "the bf16 kernels")
    del grads
    bf_counts_before = _all_counts()
    s_bf, ms_bf, peak_bf = _timed_steps(Solver(bf), ids, labels, BF16_STEPS)
    bf_counts = {n: c - bf_counts_before[n] for n, c in _all_counts().items()}
    check(bf_counts["flash_bwd_dkv"] == 12 * (BF16_STEPS + 1), f"bf16 steps launch B3: {bf_counts}")
    check(all(np.isfinite(s_bf)) and s_bf[-1] < s_bf[0], f"bf16 scores must fall: {s_bf}")
    check({p.dtype for p in bf.parameters()} == {torch.float32}, "master weights stay float32")
    ms_b, ms_f = float(np.median(ms_bf)), float(np.median(ms_plain))
    print(f"bf16 compute_dtype LM ({card}): output() vs the bf16 reference seam rel error "
          f"{e_out:.3e} (tol {TOL_BF16_REL:g}); gradients worst rel error {worst_bf[0]:.3e} at "
          f"{worst_bf[1]} (tol {TOL_BF16_GRAD_REL:g}); {BF16_STEPS} steps "
          f"{[round(t, 2) for t in ms_bf]} ms, median {ms_b:.2f} ms/step = "
          f"{tok / ms_b * 1e3:.0f} tokens/s beside f32 {ms_f:.2f} ms/step = "
          f"{tok / ms_f * 1e3:.0f} tokens/s (this phase); scores {[round(v, 5) for v in s_bf]}; "
          f"peak above resting {peak_bf / 2**30:.2f} GiB")
    check(e_out <= TOL_BF16_REL, "bf16 output() through B1 disagrees with the bf16 seam")
    check(worst_bf[0] <= TOL_BF16_GRAD_REL, "bf16 gradients through B1-B3 disagree")
    return {n: remat_counts[n] + bf_out_counts[n] + c for n, c in bf_counts.items()}


def phase_bf16_generation(prompts, card: str) -> dict:
    """Generation over the GPT-2-small-width LM with
    ``compute_dtype="bfloat16"`` (float32 master weights): the session's
    graphed decode, then the engine over static, paged, int8 and paged int8
    caches and speculative decoding (``k=4``, the target as its own draft),
    each on the 8 prompts for 64 greedy tokens. A float cache holds the
    master dtype, so the decode computes in the promoted float32 from the
    first block's attention on, as the JAX package does, and B4 runs its
    float32 instantiation; an int8 cache is dequantized in the query's
    bfloat16, as in JAX, so that step stays in bfloat16 (B4's bf16
    instantiation in every block, bf16 log-probs). Every request
    must complete, B4 must launch on every path, static must equal paged,
    and each greedy token's log-prob must be within ``TOL_BF16_LOGPROB`` of
    the maximum of a full bf16 forward on its prefix (for an int8 stream,
    the forward over an int8 cache, ``_teacher_forced(cache_dtype="int8")``,
    after one ulp where the int8 step's log-probs are bfloat16).
    Returns the launch counts of its runs."""
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import DecodeEngine

    bf = MultiLayerNetwork(_lm_conf(compute_dtype="bfloat16")).init()
    n_blocks = sum(isinstance(l, type(bf.layers[2])) for l in bf.layers)
    total = {n: 0 for n in _all_counts()}
    streams, rates = {}, {}

    def add(counts):
        for n, c in counts.items():
            total[n] += c

    sess = GenerationSession(bf, max_len=T_FULL)
    sess.generate(prompts[:1], 2)  # warm-up: eager step, graph capture
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    streams["session"] = sess.generate(prompts, MAX_TOKENS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = _all_counts()
    add(got)
    rates["session"] = B * MAX_TOKENS / dt
    check(got["flash_decode"] == n_blocks * (MAX_TOKENS - 1),
          f"the bf16 session must launch B4 {n_blocks} x {MAX_TOKENS - 1}: {got}")
    del sess
    for label, kw in (("static", {}), ("paged", {"block_size": 16}),
                      ("int8", {"cache_dtype": "int8"}),
                      ("paged int8", {"cache_dtype": "int8", "block_size": 16}),
                      ("spec self-draft", {"draft_model": bf, "speculative_k": 4})):
        eng = DecodeEngine(bf, max_len=T_FULL, slots=B, registry=MetricsRegistry(),
                           name=f"bf16 {label}", **kw)
        try:
            _run_engine(eng, prompts[:1], 3)  # warm-up: eager step, capture, replay
            fa.reset_launch_counts()
            out, dt, turns = _run_engine(eng, prompts, MAX_TOKENS)
            torch.cuda.synchronize()
            got = _all_counts()
        finally:
            eng.shutdown()
        add(got)
        streams[label], rates[label] = out, B * MAX_TOKENS / dt
        check(got["flash_decode"] >= n_blocks * turns > 0,
              f"the bf16 {label} engine must launch B4 each step: {got}, {turns} steps")
        print(f"bf16 engine {label} ({card}): {B} x {MAX_TOKENS} tokens in {dt * 1e3:.1f} ms = "
              f"{rates[label]:.1f} tokens/s beside the float32 engine's "
              f"{ENGINE_TPS.get(label, float('nan')):.1f} (same run); {turns} loop turns; "
              f"launches {got}")
    check(streams["paged"] == streams["static"], "bf16: paged streams must equal static")
    check(streams["paged int8"] == streams["int8"], "bf16: paged int8 must equal int8")
    # every greedy token against a full bf16 forward on its prefix, within
    # TOL_BF16_LOGPROB of the position's maximum; the int8 streams against
    # the same forward over an int8 cache (K and V quantized and dequantized
    # as the engine's). An int8 step dequantizes its cache in the query's
    # bfloat16, as the JAX package does, so nothing promotes it to float32
    # and its log-probs come out in bfloat16, read here from one step: where
    # they do, tokens within one ulp of the maximum tie (about 0.0625 at a
    # log-prob near -10), and the gate is taken after that ulp.
    s8 = GenerationSession(bf, max_len=T_FULL, cache_dtype="int8")
    with torch.no_grad():
        carry, _, _ = s8.prefill(prompts[:1])
        int8_dtype = s8.step(carry, torch.zeros(1, dtype=torch.int32, device="cuda")).dtype
    del s8, carry
    gaps, raw = {}, {}
    for label, st in streams.items():
        int8 = "int8" in label
        lps = _teacher_forced(bf, prompts, st, cache_dtype="int8" if int8 else None)
        ties = int8 and int8_dtype == torch.bfloat16
        gaps[label] = _greedy_gap(bf, prompts, st, lps, bf16_ties=ties)
        if ties:
            raw[label] = _greedy_gap(bf, prompts, st, lps)
        del lps
    agree = {label: sum(a == b for ra, rb in zip(st, streams["static"]) for a, b in zip(ra, rb))
             for label, st in streams.items()}
    print(f"bf16 compute_dtype generation ({card}): session {rates['session']:.1f} tokens/s "
          f"(float32 session: see the serving phase); greedy tokens vs a full bf16 forward "
          f"(over an int8 cache for the int8 streams): worst gap below the position's maximum "
          f"log-prob {gaps} (tol {TOL_BF16_LOGPROB:g}; the int8 step's log-probs are "
          f"{str(int8_dtype)[6:]}, so the int8 gaps are after one ulp of the maximum, before it "
          f"{raw}); tokens equal to the static engine's of {B * MAX_TOKENS}: {agree}; "
          f"launches {total}")
    for label, gap in gaps.items():
        check(gap <= TOL_BF16_LOGPROB, f"bf16 {label}: a greedy token is not the argmax")
    check(total["flash_decode"] > 0, "bf16 generation must run through B4")
    del bf
    return total


def phase_lenet_iterator(card: str) -> dict:
    """BASELINE config 1 as ``bench.py`` runs it: the zoo ``LeNet()``
    trained by ``model.fit(MnistDataSetIterator(64, train=True,
    num_examples=12800), epochs=1)`` (200 steps over the procedural digits,
    each batch copied to the card by the step), then
    ``model.evaluate(MnistDataSetIterator(64, train=False))`` (2048 digits)
    against ``LENET_ACC_GATE``; beside it 20 ``fit`` steps on one batch
    already on the card (after a short warm-up fit of another LeNet).
    Returns the launch counts of the fit (no attention kernel)."""
    from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator

    t0 = time.perf_counter()
    train = MnistDataSetIterator(LENET_BATCH, train=True, num_examples=LENET_TRAIN)
    test = MnistDataSetIterator(LENET_BATCH, train=False)
    data_s = time.perf_counter() - t0
    # warm-up on a throwaway LeNet: cuDNN plans and the allocator's pools
    LeNet(seed=SEED + 1).init().fit(MnistDataSetIterator(LENET_BATCH, num_examples=640))
    model = LeNet(seed=SEED).init()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(train, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = _all_counts()
    check(model.iteration_count == LENET_TRAIN // LENET_BATCH and np.isfinite(model.score_value),
          f"LeNet fit(iterator): {model.iteration_count} steps, score {model.score_value}")
    t0 = time.perf_counter()
    ev = model.evaluate(test)
    eval_s = time.perf_counter() - t0
    acc = ev.accuracy()
    # beside it: the synthetic-batch step of the LeNet phase, on this model
    x = torch.from_numpy(train.data.features[:LENET_BATCH]).cuda()
    y = torch.from_numpy(train.data.labels[:LENET_BATCH]).cuda()
    model.fit(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LENET_STEPS):
        model.fit(x, y)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / LENET_STEPS
    print(f"lenet from MnistDataSetIterator ({card}): digits made in {data_s:.2f} s "
          f"({train.provenance}); fit(iterator) {LENET_TRAIN // LENET_BATCH} steps of "
          f"{LENET_BATCH} in {fit_s:.2f} s = {LENET_TRAIN / fit_s:.0f} images/s beside "
          f"{LENET_BATCH / step_ms * 1e3:.0f} images/s for a batch already on the card "
          f"({step_ms:.3f} ms/step); final score {model.score_value:.5f}; evaluate() of "
          f"{int(ev.confusion.sum())} test digits in {eval_s:.2f} s: accuracy {acc:.5f} "
          f"(gate {LENET_ACC_GATE:.5f} = the JAX package's {LENET_JAX_ACCURACY} on the CPU "
          f"less 0.05); launches {counts}")
    check(acc >= LENET_ACC_GATE, f"LeNet accuracy {acc} below the gate {LENET_ACC_GATE}")
    del model
    return counts


def phase_resnet_files(card: str) -> dict:
    """``bench.py``'s ``measure_resnet50_e2e_fit`` at its own sizes: 512
    seeded 256x256x3 P6 files in 8 class directories, read by
    ``ImageRecordReader(output_dtype="uint8")`` into
    ``RecordReaderDataSetIterator(batch_size=128)``, copied by
    ``AsyncDataSetIterator(device_put_fn=device_put_dataset,
    device_buffers=2)`` on its prefetch thread, cropped to 224 and flipped
    on the card by ``MappedDataSetIterator``, and trained by
    ``GraphSolver.fit_iterator`` on ``ResNet50(num_classes=8,
    compute_dtype="bfloat16")``: one warm-up pass, then ``FILE_PASSES``
    timed passes, beside the same model's step on one synthetic batch on the
    card. The first batch the consumer receives must be a CUDA tensor
    bit-equal to the decoded files, copied on the prefetch thread; the
    scores finite; the host library loaded. Returns the launch counts of
    the timed passes (no attention kernel)."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.core.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator, device_put_dataset
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.tools import data_profile as dp

    check(native.available(), "the host library (native/dl4jtpu_native.cpp) must load on the "
          "card's machine: the numpy fallback would hide it")
    root = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        t0 = time.perf_counter()
        dp.write_ppm_tree(root)
        write_s = time.perf_counter() - t0
        threads = []

        def put(ds):
            threads.append(threading.current_thread().name)
            return device_put_dataset(ds)

        probe = AsyncDataSetIterator(dp.image_batches(root), device_put_fn=put,
                                     device_buffers=2, registry=MetricsRegistry())
        first = probe.next()
        probe.close()
        host = next(iter(dp.image_batches(root)))
        check(first.features.is_cuda and first.features.dtype == torch.uint8
              and tuple(first.features.shape) == (dp.FILE_BATCH, dp.RAW, dp.RAW, 3),
              f"the first batch must arrive on the card as uint8: {first.features.dtype} "
              f"{tuple(first.features.shape)} on {first.features.device}")
        check(torch.equal(first.features.cpu(), torch.from_numpy(host.features))
              and torch.equal(first.labels.cpu(), torch.from_numpy(host.labels)),
              "the first batch on the card must equal the decoded files bit for bit")
        check(bool(threads) and all(n.startswith("dsi-") for n in threads),
              f"device_put_dataset must run on the prefetch thread: {threads}")
        del first, host

        model = ResNet50(seed=SEED, num_classes=dp.N_CLASSES, compute_dtype="bfloat16").init()
        solver = GraphSolver(model)
        gen = torch.Generator(device="cuda").manual_seed(SEED)

        def one_pass():
            it, prefetch = dp.file_pipeline(root, gen, registry=MetricsRegistry())
            try:
                score = solver.fit_iterator(it, epochs=1)
            finally:
                prefetch.close()
            return score, prefetch.stats()

        warm = CollectScoresListener()
        model.add_listeners(warm)
        one_pass()                    # warm-up: cuDNN plans, the page cache
        model.listeners.remove(warm)
        check(len(warm.scores) == dp.N_IMAGES // dp.FILE_BATCH
              and all(np.isfinite(warm.scores)), f"warm-up pass scores {warm.scores}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        pass_s, scores, stats = [], [], None
        for _ in range(FILE_PASSES):
            t0 = time.perf_counter()
            score, stats = one_pass()
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
            scores.append(float(score))
        counts = _all_counts()
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(scores)), f"ResNet-50 from files: scores {scores}")
        rs = np.random.RandomState(SEED + 12)
        x = torch.from_numpy(rs.rand(dp.FILE_BATCH, 3, dp.OUT, dp.OUT).astype(np.float32)).cuda()
        y = torch.from_numpy(np.eye(dp.N_CLASSES, dtype=np.float32)[
            rs.randint(0, dp.N_CLASSES, dp.FILE_BATCH)]).cuda()
        solver.fit_batch((x,), (y,))
        torch.cuda.synchronize()
        steps = dp.N_IMAGES // dp.FILE_BATCH
        t0 = time.perf_counter()
        for _ in range(steps):
            solver.fit_batch((x,), (y,))
        torch.cuda.synchronize()
        synth_s = time.perf_counter() - t0
        files_ips = dp.N_IMAGES / float(np.median(pass_s))
        synth_ips = dp.N_IMAGES / synth_s
        keep = ("prefetch_hit_rate", "consumer_starvation_s", "producer_blocked_s", "batches",
                "fetches", "queue_high_water")
        print(f"resnet50 from files ({card}): {dp.N_IMAGES} P6 files {dp.RAW}x{dp.RAW}x3 in "
              f"{dp.N_CLASSES} classes written in {write_s:.2f} s; native.available()="
              f"{native.available()}; bf16 compute, batch {dp.FILE_BATCH}, uint8 to the card on "
              f"the prefetch thread, crop {dp.OUT} + flip on the card; {FILE_PASSES} timed "
              f"passes {[round(t, 3) for t in pass_s]} s = {files_ips:.1f} images/s from files "
              f"beside {synth_ips:.1f} images/s on a synthetic batch on the card ({steps} "
              f"steps, same batch and dtype): the input path costs "
              f"{1 - files_ips / synth_ips:.3f} of the synthetic rate; last pass stats "
              f"{ {k: stats[k] for k in keep} }; scores {[round(v, 5) for v in scores]}; peak "
              f"memory {peak / 2**30:.2f} GiB; launches {counts}")
        del model, solver, x, y
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def importable(mod: str) -> bool:
    import importlib.util

    try:
        return importlib.util.find_spec(mod) is not None
    except ModuleNotFoundError:
        return False


def _sd_tokens_per_s(fn, tokens: int) -> tuple:
    """(median tokens/s, per-call ms of each round) over ``SD_ROUNDS`` rounds
    of ``SD_CALLS`` calls of ``fn``, synchronised at each round's end."""
    rates, per_call = [], []
    for _ in range(SD_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SD_CALLS):
            fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(tokens * SD_CALLS / dt)
        per_call.append(1e3 * dt / SD_CALLS)
    return float(np.median(rates)), per_call


def _top_kernels(rows, n: int = 4) -> str:
    """The ``n`` kernels of a ``_device_profile`` with the most device time."""
    return "; ".join(f"{name[:60]} {ms:.2f} ms ({count})" for name, ms, count in rows[:n])


def _sd_float64(sd):
    """A view of ``sd`` with its float values in float64 (nodes shared)."""
    out = copy.copy(sd)
    out._values = {k: v.double() if v.is_floating_point() else v for k, v in sd._values.items()}
    out._training = None
    return out


def phase_samediff_bert(card: str) -> dict:
    """``bench.py``'s SameDiff TF-import BERT-base (``measure_bert_import``,
    ``bench.py:457-507``, at its sizes: L 12, H 768, 12 heads, vocab 30522,
    [16, 128] int32 ids): the frozen graph read from the committed skeleton
    (``tools/bert_skeleton.py``, seed 0) by the port's own GraphDef reader,
    imported by ``TFGraphMapper.import_graph`` onto the card, run eagerly by
    ``output()`` and as one CUDA graph by ``compile()``. Gates: ``graphed``;
    the graph within 1e-6 of eager; positions 0-1 within 2e-4 of the JAX
    package's output on the CPU (the committed golden); float32 within 1e-4
    of the same graph with its float constants in float64. Returns the
    imported model and its names for the fine-tune phase, and the launch
    counts of its path."""
    print(f"samediff environment ({card}): tensorflow importable {importable('tensorflow')}, "
          f"google.protobuf importable {importable('google.protobuf')}")
    t0 = time.perf_counter()
    gd, in_name, out_name = bert_skeleton.load_bert_base(0)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = TFGraphMapper.import_graph(gd, outputs=[out_name])
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    ids = torch.from_numpy(bert_skeleton.bench_ids()).cuda()
    feeds = {in_name: ids}
    tokens = ids.numel()
    sd.output(feeds, [out_name])  # warm-up: library handles, allocator pools
    compiled = sd.compile(feeds, [out_name])
    check(compiled.graphed, f"the imported BERT must compile to one CUDA graph: {compiled.reason}")
    values = dict(sd._values)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launch_counts()
    eager = sd.output(feeds, [out_name])[out_name]
    graphed = compiled(values, feeds)[out_name].clone()
    torch.cuda.synchronize()
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    eager_tps, eager_ms = _sd_tokens_per_s(lambda: sd.output(feeds, [out_name]), tokens)
    graph_tps, graph_ms = _sd_tokens_per_s(lambda: compiled(values, feeds), tokens)
    busy_e, launches_e, rows_e = _device_profile(lambda: sd.output(feeds, [out_name]))
    busy_g, launches_g, _ = _device_profile(lambda: compiled(values, feeds))
    e_graph = max_err(graphed, eager)
    gold = bert_skeleton.golden()
    e_gold = max_err(eager[:, :2].cpu(), torch.from_numpy(gold["first2"]))
    sd64 = _sd_float64(sd)
    ref64 = sd64.output(feeds, [out_name])[out_name]
    e_f64 = rel_err(eager, ref64)
    del sd64, ref64
    n_closure = len(sd._closure([out_name]))
    print(f"samediff tf-import bert-base ({card}): skeleton {len(gd.node)} nodes read and "
          f"filled in {read_s:.2f} s, imported {len(sd._nodes)} nodes in {import_s:.2f} s "
          f"({n_closure} in the output's closure); [{BERT_IMPORT_B},{BERT_IMPORT_T}] ids; "
          f"output() eager {eager_tps:.0f} tokens/s (median of {SD_ROUNDS} rounds of "
          f"{SD_CALLS}: {[round(t, 2) for t in eager_ms]} ms a call), device busy "
          f"{busy_e:.2f} ms, {launches_e} launches, idle share "
          f"{1 - busy_e / float(np.median(eager_ms)):.3f}; compile() graphed {graph_tps:.0f} "
          f"tokens/s ({[round(t, 2) for t in graph_ms]} ms a call), device busy {busy_g:.2f} ms, "
          f"{launches_g} launches, idle share {1 - busy_g / float(np.median(graph_ms)):.3f}; "
          f"peak memory {peak / 2**30:.2f} GiB; graph vs eager {e_graph:.3e} (tol "
          f"{TOL_SD_GRAPH:g}); positions 0-1 vs the JAX golden {e_gold:.3e} (tol "
          f"{TOL_SD_GOLDEN:g}); mean {float(eager.double().mean()):.6g} (JAX "
          f"{float(gold['mean']):.6g}), mean |x| {float(eager.abs().double().mean()):.6g} (JAX "
          f"{float(gold['mean_abs']):.6g}); f32 vs f64 rel {e_f64:.3e} (tol {TOL_F32_VS_F64:g}); "
          f"attention launches {counts}; top device time of the eager forward: "
          f"{_top_kernels(rows_e)}")
    check(tuple(eager.shape) == (BERT_IMPORT_B, BERT_IMPORT_T, 768)
          and bool(torch.isfinite(eager).all()), "the imported BERT's output must be finite")
    check(e_graph <= TOL_SD_GRAPH, "the graphed BERT disagrees with eager")
    check(e_gold <= TOL_SD_GOLDEN, "the imported BERT disagrees with the JAX golden")
    check(e_f64 <= TOL_F32_VS_F64, "the imported BERT in float32 disagrees with float64")
    del compiled, graphed
    return (sd, in_name, out_name, ids), counts


def phase_samediff_finetune(card: str, imported) -> dict:
    """``bench.py``'s ``measure_bert_import_train`` (``bench.py:509-573``):
    ``convert_to_variables()``, a ``cls_W [768, 2]`` head over the mean of
    the positions, ``softmax_cross_entropy`` and ``Adam(1e-5)``, fed through
    ``TrainingConfig``'s mappings; 2 warm-up steps, then ``SD_TRAIN_STEPS``
    timed ones on the repeated batch. Gates: the loss finite and lower
    after the steps than at the first; one step's gradients in float32
    within 1e-3 (relative, by norm) of float64 for every variable. Returns
    the launch counts of its path."""
    sd, in_name, out_name, ids = imported
    converted = sd.convert_to_variables()
    hidden = sd.get_variable(out_name)
    pooled = sd._op("reduce_mean", hidden, axis=[1])
    w = sd.var("cls_W", shape=(768, 2))
    logits = sd._op("matmul", pooled, w, name="logits")
    labels = sd.placeholder("labels", dtype="float32")
    loss = sd._op("softmax_cross_entropy", labels, logits)
    sd._op("reduce_mean", loss, name="loss")
    sd.set_loss_variables("loss")
    rng = np.random.default_rng(0)
    rng.integers(0, 30522, (BERT_IMPORT_B, BERT_IMPORT_T))  # bench.py draws the ids first
    y = torch.from_numpy(np.eye(2, dtype=np.float32)[rng.integers(0, 2, BERT_IMPORT_B)]).cuda()
    cfg = TrainingConfig(updater=Adam(1e-5), data_set_feature_mapping=[in_name],
                         data_set_label_mapping=["labels"])
    feeds = {in_name: ids, "labels": y}
    g32 = sd.calculate_gradients(feeds, sd.variables())
    g64 = _sd_float64(sd).calculate_gradients(feeds, sd.variables())
    norms = {n: float(torch.linalg.vector_norm(g.reshape(-1))) for n, g in g64.items()}
    floor = SD_GRAD_FLOOR * max(norms.values())
    worst = max((float(torch.linalg.vector_norm((g32[n].double() - g64[n]).reshape(-1)))
                 / max(norms[n], floor), n) for n in g64)
    n_floor = sum(v < floor for v in norms.values())
    del g32, g64
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    warm = sd.fit([(ids, y)] * 2, cfg, epochs=1).loss_curve
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = sd.fit([(ids, y)] * SD_TRAIN_STEPS, cfg, epochs=1).loss_curve
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / SD_TRAIN_STEPS
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    busy, launches, rows = _device_profile(lambda: sd.fit([(ids, y)], cfg, epochs=1))
    losses = warm + timed
    tokens = ids.numel()
    print(f"samediff bert-base fine-tune ({card}): convert_to_variables() {len(converted)} "
          f"constants -> variables ({sum(sd._values[sd._names[n]].numel() for n in converted)} "
          f"values) + cls_W, Adam(1e-5), 2 warm-up + {SD_TRAIN_STEPS} timed steps: {ms:.2f} "
          f"ms/step = {tokens / ms * 1e3:.0f} tokens/s; one profiled step: device busy "
          f"{busy:.2f} ms, {launches} launches, idle share {1 - busy / ms:.3f}; peak memory "
          f"{peak / 2**30:.2f} GiB; loss {losses[0]:.6f} -> {losses[-1]:.6f}; gradients f32 vs "
          f"f64 worst rel (by norm) {worst[0]:.3e} at {worst[1]} (tol {TOL_SD_GRAD_F64:g}; "
          f"{n_floor} of {len(norms)} variables under the floor of {SD_GRAD_FLOOR:g} x the "
          f"largest gradient norm {max(norms.values()):.4g}); "
          f"attention launches {counts}; top device time of a step: {_top_kernels(rows)}")
    check(all(np.isfinite(losses)), f"the fine-tune loss must be finite: {losses}")
    check(losses[-1] < losses[0], f"the fine-tune loss must fall: {losses}")
    check(worst[0] <= TOL_SD_GRAD_F64, "the fine-tune gradients in float32 disagree with float64")
    return counts


def phase_samediff_attention(card: str) -> dict:
    """A native SameDiff graph through B1-B3: a [8, 512, 768] placeholder,
    ``wq``/``wk``/``wv``/``wo`` variables, ``multi_head_dot_product_attention``
    with 12 heads and seeded ragged key masks (lengths 128-512, as the
    BERT-base encoder phase), the mean of the squared output as the loss;
    ``output()`` and ``SD_ATT_STEPS`` ``fit`` steps (Adam 1e-3). Gates,
    against the same graph with the attention seam on its plain route:
    outputs within 1e-4 and gradients within 1e-3 (relative to the
    largest). Returns the launch counts of its path."""
    rs = np.random.RandomState(SEED + 31)
    x = torch.from_numpy(rs.randn(BERT_BATCH, BERT_T, 768).astype(np.float32)).cuda()
    lens = torch.tensor([BERT_T, 128] + rs.randint(128, BERT_T + 1, BERT_BATCH - 2).tolist())
    mask = (torch.arange(BERT_T)[None, :] < lens[:, None]).float().cuda()
    sd = SameDiff.create()
    xin = sd.placeholder("x", (None, BERT_T, 768))
    ws = [sd.var(n, (rs.randn(768, 768) * 0.03).astype(np.float32))
          for n in ("wq", "wk", "wv", "wo")]
    att = sd.nn.multi_head_dot_product_attention(xin, xin, xin, *ws, n_heads=12, mask=mask,
                                                 name="att")
    sd._op("reduce_mean", sd._op("square", att), name="loss")
    sd.set_loss_variables("loss")
    feeds = {"x": x}
    cfg = TrainingConfig(updater=Adam(1e-3), data_set_feature_mapping=("x",))
    sd.output(feeds, ["att"])  # warm-up
    torch.cuda.synchronize()

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = sd.output(feeds, ["att"])["att"]
    torch.cuda.synchronize()
    out_ms = 1e3 * (time.perf_counter() - t0)
    check(_all_counts() == {"flash_forward": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                            "flash_decode": 0, "grouped_matmul": 0},
          f"the SameDiff attention op's output() must launch B1 once: {_all_counts()}")
    losses, step_ms = [], []
    for _ in range(SD_ATT_STEPS):
        before = _all_counts()
        t0 = time.perf_counter()
        losses += sd.fit([(x, None)], cfg, epochs=1).loss_curve
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step = {n: c - before[n] for n, c in _all_counts().items()}
        check(per_step == {"flash_forward": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                           "flash_decode": 0, "grouped_matmul": 0},
              f"a SameDiff fit step must launch B1, B2 and B3 once: {per_step}")
    counts = _all_counts()
    out = sd.output(feeds, ["att"])["att"]
    ref = _with_impl("reference", lambda: sd.output(feeds, ["att"])["att"])
    e_out = rel_err(out, ref)
    names = ["wq", "wk", "wv", "wo"]
    grads = sd.calculate_gradients(feeds, names)
    ref_grads = _with_impl("reference", lambda: sd.calculate_gradients(feeds, names))
    worst = max((rel_err(grads[n], ref_grads[n]), n) for n in names)
    print(f"samediff multi-head attention ({card}): [{BERT_BATCH},{BERT_T},768] x 12 heads, key "
          f"lengths {sorted(lens.tolist())}; output() {out_ms:.2f} ms; {SD_ATT_STEPS} fit steps "
          f"Adam(1e-3) {[round(t, 2) for t in step_ms]} ms, losses "
          f"{[round(v, 6) for v in losses]}; launches {counts}; vs the reference seam: output "
          f"rel error {e_out:.3e} (tol {TOL_OUT_REL:g}), gradients worst rel error "
          f"{worst[0]:.3e} at {worst[1]} (tol {TOL_GRAD_REL:g})")
    check(bool(torch.isfinite(out).all()) and all(np.isfinite(losses)),
          "the SameDiff attention outputs and losses must be finite")
    check(e_out <= TOL_OUT_REL, "the SameDiff attention op through B1 disagrees with the seam")
    check(worst[0] <= TOL_GRAD_REL, "the SameDiff attention gradients through B1-B3 disagree")
    return counts


def _environment(card: str, label: str) -> None:
    print(f"{label} environment ({card}): h5py importable {importable('h5py')}, "
          f"google.protobuf importable {importable('google.protobuf')}, onnx importable "
          f"{importable('onnx')} (the port reads HDF5 and the ONNX wire format itself)")


def _float64_graph(net: ComputationGraph) -> ComputationGraph:
    """``net``'s configuration, weights and statistics in float64, on its device."""
    out = ComputationGraph(dataclasses.replace(net.conf, dtype="float64"), device=net.device)
    out.init()
    out.set_params_flat(net.params_flat())
    out.state = {n: {k: t.double() for k, t in st.items()} for n, st in net.state.items()}
    return out


def _graph_acts(net: ComputationGraph, x: torch.Tensor, names) -> list:
    with torch.inference_mode():
        acts, _ = net.forward_pure(net.params, net.state, [x])
    return [acts[n] for n in names]


def phase_keras_resnet50(card: str):
    """``keras.applications.ResNet50(weights=None)`` (224x224x3, 1000
    classes, nothing cut) read from the committed HDF5 skeleton by the port's
    own reader (no h5py; whether h5py, protobuf and onnx are importable is
    printed, not gated), filled from seed 0 (``tools/keras_resnet50.py``) and
    imported by ``KerasModelImport`` onto the card as a ``ComputationGraph``
    (the zoo ResNet-50's network plus Keras's ZeroPadding layers and conv
    biases). Gates: the ``avg_pool`` features within 2e-4 (over the largest)
    and the probabilities within 1e-4 of the JAX package's on the CPU (the
    committed golden, 2 images); float32 within 1e-4 of the same graph in
    float64 on the card. Then ``output()`` at batch ``RESNET_BATCH`` with
    cuDNN's TF32 switch at its default, timed beside the zoo ResNet-50's.
    No attention or grouped-matmul kernel lies on this path. Returns the
    model and batch for the fine-tune phase, and the launch counts."""
    _environment(card, "keras import")
    t0 = time.perf_counter()
    f = keras_resnet50.load(0)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = KerasModelImport.import_keras_model_and_weights(f)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    check(net.device.type == "cuda" and net.num_params() == keras_resnet50.N_PARAMS,
          f"the imported ResNet-50 has {net.num_params()} params on {net.device}")
    names = (keras_resnet50.FEATURES, keras_resnet50.OUTPUT)
    gold = keras_resnet50.golden()
    x2 = torch.from_numpy(keras_resnet50.golden_input()).cuda()
    with _cudnn_tf32_default():
        feats, probs = _graph_acts(net, x2, names)
    e_feat = float((feats.cpu() - torch.from_numpy(gold["features"])).abs().max()
                   / float(np.abs(gold["features"]).max()))
    e_prob = max_err(probs.cpu(), torch.from_numpy(gold["probs"]))
    net64 = _float64_graph(net)
    f64 = _graph_acts(net64, x2.double(), names)
    e_f64 = [rel_err(a, b) for a, b in zip((feats, probs), f64)]
    del net64, f64
    rs = np.random.RandomState(SEED + 40)
    x = torch.from_numpy(rs.randn(RESNET_BATCH, 3, 224, 224).astype(np.float32)).cuda()
    with _cudnn_tf32_default():
        net.output(x)  # warm-up: cuDNN handles, allocator pools
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        n_out = 5
        for _ in range(n_out):
            out = net.output(x)
        torch.cuda.synchronize()
        out_ms = 1e3 * (time.perf_counter() - t0) / n_out
        counts = _all_counts()
        busy, launches, rows = _device_profile(lambda: net.output(x))
    check(tuple(out.shape) == (RESNET_BATCH, 1000) and bool(torch.isfinite(out).all()),
          "the imported ResNet-50's output() must be finite [32, 1000]")
    zoo = RESNET_IMAGES_PER_S.get("output", float("nan"))
    print(f"keras resnet50 ({card}): skeleton read and filled in {read_s:.2f} s (320 datasets, "
          f"no h5py), imported in {import_s:.2f} s: ComputationGraph {net.num_params()} params, "
          f"{len(net.conf.vertices)} vertices; output() [{RESNET_BATCH},3,224,224] "
          f"{out_ms:.2f} ms = {RESNET_BATCH / out_ms * 1e3:.1f} images/s (the zoo ResNet-50 "
          f"in this run: {zoo:.1f} images/s), device busy {busy:.2f} ms, {launches} launches, "
          f"idle share {1 - busy / out_ms:.3f}; vs the JAX golden: features {e_feat:.3e} (tol "
          f"{TOL_KERAS_FEATURES:g}), probabilities {e_prob:.3e} (tol {TOL_KERAS_PROBS:g}; top "
          f"{float(probs.max()):.5f}); f32 vs f64 on the card: features {e_f64[0]:.3e}, "
          f"probabilities {e_f64[1]:.3e} (tol {TOL_F32_VS_F64:g}); launches {counts}; top "
          f"device time: {_top_kernels(rows)}")
    check(e_feat <= TOL_KERAS_FEATURES, "the imported ResNet-50's features disagree with JAX")
    check(e_prob <= TOL_KERAS_PROBS, "the imported ResNet-50's probabilities disagree with JAX")
    check(max(e_f64) <= TOL_F32_VS_F64, "the imported ResNet-50 in float32 disagrees with float64")
    return (net, x), counts


def phase_keras_finetune(card: str, imported) -> dict:
    """The imported ResNet-50 fine-tuned: ``KERAS_FT_STEPS``
    ``GraphSolver.fit_batch`` steps (Adam 1e-4, set on the imported
    configuration) at batch ``RESNET_BATCH`` on a fixed batch, through the
    ``OutputLayer`` (MCXENT) the importer made of the trailing softmax
    Dense. Gates: the score finite and falling; before the first step, at
    batch ``KERAS_GRAD_BATCH``, the score in float32 within 1e-5 of float64
    on the card and the gradients within 0.1 (``TOL_KERAS_GRAD_F64`` says
    why not 1e-3), by norm per parameter over the larger of its float64
    norm and ``SD_GRAD_FLOOR`` of the largest. No attention or
    grouped-matmul kernel lies on this path. Returns its launch counts."""
    _environment(card, "keras fine-tune")
    net, x = imported
    net.conf = dataclasses.replace(net.conf, updater=Adam(1e-4))
    rs = np.random.RandomState(SEED + 41)
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, RESNET_BATCH)]).cuda()
    xg, yg = x[:KERAS_GRAD_BATCH], y[:KERAS_GRAD_BATCH]
    g32 = net.calculate_gradients(xg, yg)
    net64 = _float64_graph(net)
    g64 = net64.calculate_gradients(xg.double(), yg.double())
    s32, s64 = net.score(xg, yg), net64.score(xg.double(), yg.double())
    e_score = abs(s32 - s64) / abs(s64)
    del net64
    norms = {(l, k): float(torch.linalg.vector_norm(g.reshape(-1)))
             for l, lg in g64.items() for k, g in lg.items()}
    floor = SD_GRAD_FLOOR * max(norms.values())
    worst = max((float(torch.linalg.vector_norm((g32[l][k].double() - g64[l][k]).reshape(-1)))
                 / max(norms[(l, k)], floor), f"{l}/{k}") for (l, k) in norms)
    n_floor = sum(v < floor for v in norms.values())
    del g32, g64
    solver = GraphSolver(net)
    with _cudnn_tf32_default():
        solver.fit_batch((x,), (y,))  # warm-up step: cuDNN's backward handles, Adam's state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        scores, step_ms = [], []
        for _ in range(KERAS_FT_STEPS):
            t0 = time.perf_counter()
            scores.append(float(solver.fit_batch((x,), (y,))))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        counts = _all_counts()
        peak = torch.cuda.max_memory_allocated()
        busy, launches, rows = _device_profile(lambda: solver.fit_batch((x,), (y,)))
    ms = float(np.median(step_ms))
    print(f"keras resnet50 fine-tune ({card}): GraphSolver.fit_batch Adam(1e-4) through the "
          f"imported OutputLayer (MCXENT), 1 warm-up + {KERAS_FT_STEPS} steps at batch "
          f"{RESNET_BATCH}: median {ms:.2f} ms/step of {[round(t, 2) for t in step_ms]} = "
          f"{RESNET_BATCH / ms * 1e3:.1f} images/s; one profiled step: device busy {busy:.2f} "
          f"ms, {launches} launches, idle share {1 - busy / ms:.3f}; peak memory "
          f"{peak / 2**30:.2f} GiB; scores {[round(v, 5) for v in scores]}; at batch "
          f"{KERAS_GRAD_BATCH} before the first step, f32 vs f64: score {e_score:.3e} (tol "
          f"{TOL_KERAS_SCORE_F64:g}), gradients worst rel (by norm) {worst[0]:.3e} at {worst[1]} "
          f"(tol {TOL_KERAS_GRAD_F64:g}; {n_floor} of {len(norms)} under the floor); launches "
          f"{counts}; top device time: {_top_kernels(rows)}")
    check(all(np.isfinite(scores)) and scores[-1] < scores[0],
          f"the imported ResNet-50's fine-tune scores must be finite and falling: {scores}")
    check(e_score <= TOL_KERAS_SCORE_F64,
          "the imported ResNet-50's score in float32 disagrees with float64")
    check(worst[0] <= TOL_KERAS_GRAD_F64,
          "the imported ResNet-50's gradients in float32 disagree with float64")
    return counts


def phase_onnx_bert(card: str) -> dict:
    """BERT-base's encoder (L 12, H 768, 12 heads, FFN 3072, vocab 30522)
    read from the committed ONNX skeleton by the port's own wire reader (no
    protobuf or onnx), filled from seed 0 (``tools/onnx_bert.py``), imported
    by ``OnnxGraphMapper`` onto the card, and run on [16, 128] int64 ids
    with a ragged attention mask, eagerly by ``output()`` and as one CUDA
    graph by ``compile()``. Gates: ``graphed``; the graph within 1e-6 of
    eager; positions 0-1 within 2e-4 of the JAX package's output on the
    CPU (the committed golden); float32 within 1e-4 of the same graph with
    its float constants in float64. Attention is spelled MatMul + Softmax,
    so no attention or grouped-matmul kernel lies on this path. Returns its
    launch counts."""
    _environment(card, "onnx import")
    t0 = time.perf_counter()
    model = onnx_bert.load(0)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = OnnxGraphMapper.import_model(model, outputs=[onnx_bert.OUTPUT])
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    out_name = onnx_bert.OUTPUT
    feeds = {k: torch.from_numpy(v).cuda() for k, v in onnx_bert.bench_feeds().items()}
    tokens = feeds[onnx_bert.INPUTS[0]].numel()
    sd.output(feeds, [out_name])  # warm-up: library handles, allocator pools
    compiled = sd.compile(feeds, [out_name])
    check(compiled.graphed, f"the imported ONNX BERT must compile to one CUDA graph: "
                            f"{compiled.reason}")
    values = dict(sd._values)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    eager = sd.output(feeds, [out_name])[out_name]
    graphed = compiled(values, feeds)[out_name].clone()
    torch.cuda.synchronize()
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated()
    eager_tps, eager_ms = _sd_tokens_per_s(lambda: sd.output(feeds, [out_name]), tokens)
    graph_tps, graph_ms = _sd_tokens_per_s(lambda: compiled(values, feeds), tokens)
    busy_e, launches_e, rows_e = _device_profile(lambda: sd.output(feeds, [out_name]))
    busy_g, launches_g, _ = _device_profile(lambda: compiled(values, feeds))
    e_graph = max_err(graphed, eager)
    gold = onnx_bert.golden()
    e_gold = max_err(eager[:, :2].cpu(), torch.from_numpy(gold["first2"]))
    sd64 = _sd_float64(sd)
    e_f64 = rel_err(eager, sd64.output(feeds, [out_name])[out_name])
    del sd64
    print(f"onnx bert-base ({card}): skeleton {len(model.graph.node)} nodes, "
          f"{len(model.graph.initializer)} initializers (74 filled), read in "
          f"{read_s:.2f} s, imported {len(sd._nodes)} nodes in {import_s:.2f} s; "
          f"[{onnx_bert.BATCH},{onnx_bert.SEQ}] int64 ids + ragged mask; output() eager "
          f"{eager_tps:.0f} tokens/s ({[round(t, 2) for t in eager_ms]} ms a call), device busy "
          f"{busy_e:.2f} ms, {launches_e} launches, idle share "
          f"{1 - busy_e / float(np.median(eager_ms)):.3f}; compile() graphed {graph_tps:.0f} "
          f"tokens/s ({[round(t, 2) for t in graph_ms]} ms a call), device busy {busy_g:.2f} ms, "
          f"{launches_g} launches, idle share {1 - busy_g / float(np.median(graph_ms)):.3f}; "
          f"peak memory {peak / 2**30:.2f} GiB; graph vs eager {e_graph:.3e} (tol "
          f"{TOL_SD_GRAPH:g}); positions 0-1 vs the JAX golden {e_gold:.3e} (tol "
          f"{TOL_SD_GOLDEN:g}); mean |x| {float(eager.abs().double().mean()):.6g} (JAX "
          f"{float(gold['mean_abs']):.6g}); f32 vs f64 rel {e_f64:.3e} (tol "
          f"{TOL_F32_VS_F64:g}); launches {counts}; top device time of the eager forward: "
          f"{_top_kernels(rows_e)}")
    check(tuple(eager.shape) == (onnx_bert.BATCH, onnx_bert.SEQ, onnx_bert.HIDDEN)
          and bool(torch.isfinite(eager).all()), "the imported ONNX BERT's output must be finite")
    check(e_graph <= TOL_SD_GRAPH, "the graphed ONNX BERT disagrees with eager")
    check(e_gold <= TOL_SD_GOLDEN, "the imported ONNX BERT disagrees with the JAX golden")
    check(e_f64 <= TOL_F32_VS_F64, "the imported ONNX BERT in float32 disagrees with float64")
    del compiled, graphed
    return counts


def _kept_rows(sizes, m_pad: int, n: int) -> torch.Tensor:
    """[n] bool: the rows some group keeps (local index < m_pad, row < n)."""
    kept = torch.zeros(n, dtype=torch.bool)
    start = 0
    for s_ in sizes:
        kept[start: min(start + min(s_, m_pad), n)] = True
        start += s_
    return kept


def _gmm_3xtf32(lhs, gs, rhs, m_pad: int) -> torch.Tensor:
    """B5's float32 product as 3xTF32 on the tensor cores (the C entry
    ``dl4j_grouped_matmul_3xtf32``), kept beside the CUDA-core kernel that
    the port's path runs: called directly, so no launch is counted."""
    fn = cuda_build.library("grouped_matmul").dl4j_grouped_matmul_3xtf32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros((lhs.shape[0], rhs.shape[2]), dtype=torch.float32, device="cuda")
    err = fn(lhs.data_ptr(), gs.data_ptr(), rhs.contiguous().data_ptr(), out.data_ptr(),
             lhs.shape[0], lhs.shape[1], rhs.shape[2], rhs.shape[0], m_pad, 0,
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"the 3xTF32 kernel did not launch: cudaError {err}")
    return out


def phase_grouped_matmul(gen, routed) -> dict:
    """B5 against its plain version at ragged shapes and at the MoE layer's
    two products, in float32, bf16, f16 and f64, then timed at the first,
    ``[16384, 768] x [8, 768, 1536]`` with ``m_pad`` 2560, at two loads: the
    row counts the network routed, and a balanced load (2048 rows an expert,
    every row kept). Returns the float32 row at the routed load."""
    n_rows = TOPK * B * T_FULL
    cases = [
        # (label, n, d, h, group sizes, max_group_size, int8 rhs)
        ("empty groups, groups over m_pad, tail", 1000, 256, 200, (0, 300, 0, 350, 100), 256,
         False),
        ("n, d, h off the tiles and vectors", 333, 100, 90, (100, 0, 150), None, False),
        ("int8 rhs", 512, 128, 192, (200, 300), None, True),
        ("MoE first product", n_rows, 768, H_MOE, routed, CAPACITY, False),
        ("MoE second product", n_rows, H_MOE, 768, routed, CAPACITY, False),
    ]
    worst = 0.0
    for dtype in DTYPES:
        for label, n, d, h, sizes, mg, q in cases:
            lhs = torch.randn(n, d, generator=gen).to("cuda", dtype)
            if q:
                rhs = torch.randint(-127, 128, (len(sizes), d, h), generator=gen,
                                    dtype=torch.int8).cuda()
            else:
                rhs = (torch.randn(len(sizes), d, h, generator=gen) * d ** -0.5).to("cuda", dtype)
            gs = torch.tensor(sizes, dtype=torch.int32).cuda()
            y = fa.grouped_matmul(lhs, gs, rhs, max_group_size=mg)
            ref = fa.grouped_matmul_plain(lhs, gs, rhs, max_group_size=mg)
            m_pad = gm_mod._tiling(n, mg, 128)[0]
            if dtype == torch.float32:  # the 3xTF32 kernel timed beside the path's
                y3 = _gmm_3xtf32(lhs, gs, rhs.float(), m_pad)
                torch.cuda.synchronize()
                e3 = rel_err(y3, ref)
                print(f"grouped_matmul float32 3xTF32 [{n},{d}]x[{len(sizes)},{d},{h}] {label}: "
                      f"rel={e3:.3e} (tol {TOL_GMM_REL[dtype]:.3g})")
                check(e3 <= TOL_GMM_REL[dtype], "the 3xTF32 kernel disagrees with the plain version")
            torch.cuda.synchronize()
            dropped = ~_kept_rows(sizes, m_pad, n).cuda()
            e = rel_err(y, ref)
            print(f"grouped_matmul {str(dtype)[6:]:8s} [{n},{d}]x[{len(sizes)},{d},{h}] "
                  f"m_pad={m_pad} {label}: max_abs={max_err(y, ref):.3e} rel={e:.3e} "
                  f"(tol {TOL_GMM_REL[dtype]:.3g}); {int(dropped.sum())} rows must be 0")
            check(e <= TOL_GMM_REL[dtype], "grouped_matmul disagrees with its plain version")
            check(bool((y[dropped] == 0).all()), "dropped rows and rows past the frontier must be 0")
            if dtype == torch.float32:
                worst = max(worst, max_err(y, ref))
            del lhs, rhs, y, ref

    # timing at the main path's first product, at the routed and a balanced load
    n, d, h = n_rows, 768, H_MOE
    lhs32 = torch.randn(n, d, generator=gen).cuda()
    rhs32 = (torch.randn(E_MOE, d, h, generator=gen) * d ** -0.5).cuda()
    row = {"max_abs_err": worst}
    loads = {"routed": routed, "balanced": [n // E_MOE] * E_MOE}
    for load, sizes in loads.items():
        gs = torch.tensor(sizes, dtype=torch.int32).cuda()
        kept = sum(min(s_, CAPACITY) for s_ in sizes)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            lhs, rhs = lhs32.to(dtype), rhs32.to(dtype)
            buf = gm_mod._to_groups(lhs, gs, CAPACITY)  # [8, 2560, 768], zero-padded
            timed = {"kernel": lambda: fa.grouped_matmul(lhs, gs, rhs, max_group_size=CAPACITY),
                     "bmm": lambda: torch.bmm(buf, rhs)}
            if dtype == torch.float32:
                timed["3xTF32"] = lambda: _gmm_3xtf32(lhs, gs, rhs, CAPACITY)
            rounds = {name: [] for name in timed}
            for _ in range(3):  # kernel and padded bmm in turn, so the comparison is paired
                for name, fn in timed.items():
                    rounds[name].append(kv.ms(fn, 20))
            ms, lib_ms = (float(np.median(rounds[name])) for name in ("kernel", "bmm"))
            alt = ""
            if "3xTF32" in rounds:
                alt = (f"; the 3xTF32 tensor-core kernel {float(np.median(rounds['3xTF32'])):.4f}"
                       f" ms (rounds {[round(x, 4) for x in rounds['3xTF32']]})")
            plain_ms = kv.ms(lambda: fa.grouped_matmul_plain(lhs, gs, rhs,
                                                               max_group_size=CAPACITY), 5)
            flops = 2 * kept * d * h
            # kept lhs rows read, rhs read, every output row written, group sizes
            nbytes = (kept * d + E_MOE * d * h + n * h) * lhs.element_size() + 4 * E_MOE
            bound_ms, bound_by = roofline(flops, nbytes, dtype)
            extra = ""
            if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
                offs = torch.cumsum(gs, 0, dtype=torch.int32)
                try:
                    gmm_ms = kv.ms(lambda: torch._grouped_mm(lhs, rhs, offs=offs), 20)
                    extra = f", torch._grouped_mm {gmm_ms:.4f} ms"
                except Exception as exc:  # a yardstick only: report why it did not run
                    extra = (f", torch._grouped_mm not run ({type(exc).__name__}: "
                             f"{str(exc)[:120]})")
            print(f"grouped_matmul {str(dtype)[6:]} [{n},{d}]x[{E_MOE},{d},{h}] "
                  f"m_pad={CAPACITY}, {load} load, {kept} kept rows {sizes}, 3 paired rounds "
                  f"(ms): kernel {[round(x, 4) for x in rounds['kernel']]}, padded torch.bmm "
                  f"{[round(x, 4) for x in rounds['bmm']]}; medians: kernel {ms:.4f} ms, "
                  f"padded torch.bmm {lib_ms:.4f} ms ({ms / lib_ms:.2f}x){extra}, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB"
                  f"{cuda_core_note(flops, dtype)}; {bound_ms / ms:.0%} of it){alt}")
            if dtype == torch.float32 and load == "routed":
                row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
            del buf
    return row


# ---------------------------------------------------------------------------
# The graph rewrite passes and post-training quantization (nn/rewrite)
# ---------------------------------------------------------------------------

# A rewritten graph against the unrewritten one on the card, both float32,
# max abs error over the largest value: the fold scales each conv kernel in
# float64 and rounds it to float32 once, and the stem conv sums its 49 taps
# (plus 15 zeros) in another order; ~1e-6 relative through 53 layers. A
# fold that dropped a BN's shift or scale misses by ~1.
TOL_REWRITE_REL = 1e-4
# The quantized LM's float32 output() on the card against the same quantized
# network (the same int8 or fp8 weights and float32 scales) in float64
# through the plain attention: the f32-vs-f64 gate of the other phases.
TOL_QUANT_F64 = TOL_F32_VS_F64
# The graphed decode step against the uncaptured one on the same carry, as in
# phase_model: the same kernels and shapes, replayed.
TOL_GRAPH_STEP = 1e-6
# The published-size zoo, batch 8: (class, constructor arguments, input
# [c, h, w], the JAX package's output shape; tests/test_torch_zoo.py holds
# the shapes against the JAX package's shape inference).
ZOO_BATCH = 8
ZOO_CASES = [
    ("AlexNet", {}, (3, 224, 224), (8, 1000)),
    ("VGG16", {}, (3, 224, 224), (8, 1000)),
    ("VGG19", {}, (3, 224, 224), (8, 1000)),
    ("SqueezeNet", {}, (3, 224, 224), (8, 1000)),
    ("Darknet19", {}, (3, 224, 224), (8, 1000)),
    ("TinyYOLO", {}, (3, 416, 416), (8, 125, 13, 13)),
    ("YOLO2", {}, (3, 416, 416), (8, 125, 13, 13)),
    ("UNet", {}, (3, 128, 128), (8, 1, 128, 128)),
    ("Xception", {}, (3, 299, 299), (8, 1000)),
    ("NASNet", {}, (3, 224, 224), (8, 1000)),
    ("InceptionResNetV1", {}, (3, 160, 160), (8, 1000)),
    ("SimpleCNN", {}, (3, 48, 48), (8, 10)),
    ("FaceNetNN4Small2", {}, (3, 96, 96), (8, 128)),
]


class _Float64(RewritePass):
    """The network itself in float64: every float32 tensor widened (exact),
    the int8 and fp8 weights as they are. The reference side of the
    quantized LM's f32-vs-f64 gate."""

    name = "float64"

    def apply_sequential(self, conf, params, state):
        def wide(d):
            return {k: (v.detach().double() if v.dtype == torch.float32 else v.detach())
                    for k, v in d.items()}

        return (dataclasses.replace(conf, dtype="float64"),
                {l: wide(p) for l, p in params.items()},
                {l: wide(s) for l, s in state.items()}, True)


def _seed_bn_stats(net, seed: int) -> None:
    """Running statistics of every batch norm from ``seed`` (means ~N(0, 0.1),
    variances in [0.5, 1.5)), so that a fold moves every kernel."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for st in net.state.values():
            if "mean" in st:
                st["mean"].copy_(0.1 * torch.randn(st["mean"].shape, generator=g))
                st["var"].copy_(0.5 + torch.rand(st["var"].shape, generator=g))


def _serve_lm(m, prompts, ids, label: str) -> dict:
    """One LM's serving numbers on the card: ``output()`` [8, 1024] (after a
    warm-up), ``GenerationSession.generate`` of 8 x 64 greedy tokens (median
    of 3), the graphed decode step against the uncaptured one on two carries
    of one prefill (24 steps), the cached decode's log-probs against a full
    forward, and the peak memory above the resident tensors."""
    session = GenerationSession(m, max_len=T_FULL)
    m.output(ids)  # warm-up at the timed shape: the allocator's pools, library plans
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probs = m.output(ids)
    torch.cuda.synchronize()
    output_ms = 1e3 * (time.perf_counter() - t0)
    rows = probs[:2].clone()
    del probs
    runs, gen = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        gen = session.generate(prompts, MAX_TOKENS)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    generate_s = sorted(runs)[1]
    lp_gap = _greedy_gap(m, prompts, gen)
    # cached decode vs a full forward, teacher-forced on the stream
    steps = MAX_TOKENS - 1
    carry, logits, _ = session.prefill(prompts)
    cached = [logits]
    for s in range(steps):
        carry, logits = session.decode(carry, [row[s] for row in gen])
        cached.append(logits)
    cached = torch.stack(cached, dim=1)
    ref = _teacher_forced(m, prompts, [g[:MAX_TOKENS] for g in gen])
    decode_err = max(max_err(cached[i], ref[i]) for i in range(len(prompts)))
    del carry, cached, ref
    session.release_graphs()
    # graph replay vs the uncaptured step
    carry_g, logits_g, _ = session.prefill(prompts)
    carry_e, _, _ = session.prefill(prompts)
    toks = torch.argmax(logits_g, dim=-1)
    worst, t_graph, t_eager = 0.0, [], []
    for s_ in range(24):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry_g, lg = session.decode(carry_g, toks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            le = session.step(carry_e, toks.to(torch.int32))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if s_ >= 2:  # step 0 runs eagerly, step 1 captures
            t_graph.append(t1 - t0)
            t_eager.append(t2 - t1)
        worst = max(worst, max_err(lg, le))
        toks = torch.argmax(lg, dim=-1)
    entry = session._graphs.get(B)
    graph_launches = entry.step.launches if entry is not None and entry.step is not None else None
    session.release_graphs()
    del carry_g, carry_e
    out = dict(rows=rows, gen=gen, output_ms=output_ms, generate_s=generate_s,
               tokens_per_s=B * MAX_TOKENS / generate_s, decode_err=decode_err,
               greedy_gap=lp_gap, graph_ms=1e3 * float(np.median(t_graph)),
               eager_ms=1e3 * float(np.median(t_eager)), graph_err=worst,
               graph_launches=graph_launches, peak=peak,
               model_bytes=serving_model_bytes(m))
    print(f"quantized lm {label}: output() [8,1024] {output_ms:.2f} ms; generate 8 x "
          f"{MAX_TOKENS} median {generate_s * 1e3:.1f} ms of {[round(r * 1e3, 1) for r in runs]}"
          f" = {out['tokens_per_s']:.1f} tokens/s; decode step graph {out['graph_ms']:.3f} ms,"
          f" eager {out['eager_ms']:.3f} ms (medians of 22), graph vs eager logits max_abs "
          f"{worst:.3e}; cached decode vs full forward log-prob max_abs {decode_err:.3e}, "
          f"greedy gap {lp_gap:.3e}; model_bytes {out['model_bytes']}; peak memory above the "
          f"resident {peak / 2**30:.3f} GiB")
    return out


def phase_quant_lm(model, prompts, card: str) -> dict:
    """The GPT-2-small-width LM (163,050,577 params, float32) published to a
    ``ModelStore`` and deployed through ``ModelManager(optimize=
    "inference:int8")``: the 12 decoder blocks are quantized in memory
    (count_quantized_layers 12, the quantized gauge 12), its ``output()`` on
    8 x 1024 runs B1, ``GenerationSession`` and ``DecodeEngine`` generate 64
    greedy tokens on the 8 prompts through B4 (the decode step replayed
    from a CUDA graph); the same version is redeployed as ``"inference:fp8"``
    and rolled back. Gates: the card's int8 output against the same int8
    network in float64 through the plain attention (1e-4), graph vs eager
    (1e-6), decode log-probs vs a full forward (2e-3), the engine's streams
    greedy, and the rollback serving the int8 incumbent's exact outputs. The
    f32 model's numbers are taken first, in the same call. Returns the
    launch counts of the int8 and fp8 paths."""
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import DecodeEngine
    from deeplearning4j_tpu_torch.serving import ModelManager, ModelStore

    rs = np.random.RandomState(SEED + 43)
    ids = torch.from_numpy(rs.randint(0, 50257, (B, T_FULL))).cuda()
    f32 = _serve_lm(model, prompts, ids, f"f32 ({card})")
    n_blocks = sum(isinstance(l, type(model.layers[2])) for l in model.layers)
    with tempfile.TemporaryDirectory() as root:
        store = ModelStore(root)
        t0 = time.perf_counter()
        store.publish("lm", model)
        t_pub = time.perf_counter() - t0
        reg = MetricsRegistry()
        t0 = time.perf_counter()
        mgr = ModelManager(store, "lm", version=1, optimize="inference:int8",
                           warmup_example=np.zeros((1, 1)), workers=1, batch_limit=4,
                           registry=reg)
        t_deploy = time.perf_counter() - t0
        try:
            qm = mgr.engine.model
            n_q = count_quantized_layers(qm)
            gauge = reg.get("dl4j_tpu_serving_quantized_live").labels("lm").value
            passes = [e["passes"] for e in reg.events("model_rewrite")]
            check(n_q == n_blocks == 12 and gauge == 12.0 and passes == [["quantize_weights_int8"]],
                  f"the int8 deploy quantized {n_q} layers (gauge {gauge}, passes {passes})")
            w = qm.params["layer_2"]
            check(w["Wq_q"].dtype == torch.int8 and w["Wq_q"].is_cuda
                  and w["Wq_scale"].dtype == torch.float32,
                  "int8 weights and float32 scales must stay on the card")
            fa.reset_launch_counts()
            int8 = _serve_lm(qm, prompts, ids, f"int8 ({card})")
            # the manager's own serving path answers
            served = np.asarray(mgr.output(ids[:1].cpu().numpy(), timeout=300))
            check(served.shape[-2:] == (50257, T_FULL) and bool(np.isfinite(served).all()),
                  f"the manager's int8 answer: {served.shape}")
            eng = DecodeEngine(qm, max_len=T_FULL, slots=B, registry=MetricsRegistry(),
                               name="int8-lm")
            try:
                _run_engine(eng, prompts[:1], 3)  # warm-up: eager step, capture, replay
                streams, dt, turns = _run_engine(eng, prompts, MAX_TOKENS)
                eng_graph = eng._graph.launches if eng._graph is not None else None
            finally:
                eng.shutdown(drain=False)
            eng_gap = _greedy_gap(qm, prompts, streams)
            # the f32-vs-f64 gate on the same int8 network
            q64, _ = rewrite_model(qm, [_Float64()])
            ref = _with_impl("reference", lambda: q64.output(ids[:2]))
            e64 = rel_err(int8["rows"], ref)
            del q64, ref
            e_f32 = rel_err(int8["rows"], f32["rows"])
            incumbent = qm.output(ids[:2])  # what the rollback must serve again
            # redeploy the same version as fp8, then roll back to int8
            t0 = time.perf_counter()
            mgr.deploy(1, optimize="inference:fp8")
            t_fp8 = time.perf_counter() - t0
            fm = mgr.engine.model
            check(mgr.live_version == "1" and mgr.previous_version == "1"
                  and count_quantized_layers(fm) == 12
                  and fm.params["layer_2"]["Wq_q"].dtype == torch.float8_e4m3fn,
                  "the fp8 redeploy of version 1 must be a real swap to 12 fp8 blocks")
            fp8 = _serve_lm(fm, prompts, ids, f"fp8 ({card})")
            e_fp8 = rel_err(fp8["rows"], f32["rows"])
            del fm
            mgr.rollback()
            check(mgr.engine.model is qm and count_quantized_layers(qm) == 12,
                  "the rollback must restore the int8 incumbent")
            again = qm.output(ids[:2])
            torch.cuda.synchronize()
            counts = _all_counts()
            deploys = {d: reg.get("dl4j_tpu_serving_quantized_deploys_total").labels("lm", d).value
                       for d in ("int8", "fp8")}
        finally:
            mgr.shutdown(drain=False)
    rollback_exact = torch.equal(again, incumbent)
    top1 = {k: float((r["rows"].argmax(1) == f32["rows"].argmax(1)).float().mean())
            for k, r in (("int8", int8), ("fp8", fp8))}
    print(f"int8 lm serving ({card}): publish {t_pub:.2f} s, ModelManager(optimize="
          f"'inference:int8') load + rewrite + warm-up {t_deploy:.2f} s, {n_q} quantized blocks,"
          f" gauge {gauge}; engine {B} x {MAX_TOKENS} tokens in {dt * 1e3:.1f} ms = "
          f"{B * MAX_TOKENS / dt:.1f} tokens/s ({turns} turns), step graph {eng_graph}, greedy "
          f"gap {eng_gap:.3e}; int8 vs f64 {e64:.3e} (tol {TOL_QUANT_F64:g}); output error vs "
          f"f32 int8 {e_f32:.3e}, fp8 {e_fp8:.3e}, top-1 agreement with f32 over 2 x {T_FULL} "
          f"positions {top1}; fp8 redeploy {t_fp8:.2f} s; rollback exact "
          f"{rollback_exact}; quantized deploys {deploys}; launches {counts}")
    print(f"quantized lm ({card}): f32 / int8 / fp8 output() ms {f32['output_ms']:.2f} / "
          f"{int8['output_ms']:.2f} / {fp8['output_ms']:.2f}; decode step graph ms "
          f"{f32['graph_ms']:.3f} / {int8['graph_ms']:.3f} / {fp8['graph_ms']:.3f}; tokens/s "
          f"{f32['tokens_per_s']:.1f} / {int8['tokens_per_s']:.1f} / {fp8['tokens_per_s']:.1f}; "
          f"model_bytes {f32['model_bytes']} / {int8['model_bytes']} / {fp8['model_bytes']} "
          f"({int8['model_bytes'] / f32['model_bytes']:.3f} of f32); peak memory above the "
          f"resident GiB {f32['peak'] / 2**30:.3f} / {int8['peak'] / 2**30:.3f} / "
          f"{fp8['peak'] / 2**30:.3f}")
    for label, r in (("int8", int8), ("fp8", fp8)):
        check(r["graph_err"] <= TOL_GRAPH_STEP and r["graph_launches"] == {"flash_decode": 12},
              f"the {label} decode graph disagrees with eager ({r['graph_err']:.3e}) or "
              f"launches {r['graph_launches']}")
        check(r["decode_err"] <= TOL_LOGPROB and r["greedy_gap"] <= TOL_LOGPROB,
              f"the {label} cached decode disagrees with the full forward")
    check(e64 <= TOL_QUANT_F64, f"the int8 output() on the card disagrees with float64: {e64}")
    check(eng_gap <= TOL_LOGPROB and eng_graph == {"flash_decode": 12},
          f"the int8 engine's streams are not greedy ({eng_gap}) or its graph {eng_graph}")
    check(rollback_exact, "the rollback does not serve the int8 incumbent's outputs")
    check(deploys == {"int8": 1.0, "fp8": 1.0}, f"quantized deploys {deploys}")
    check(counts["flash_forward"] > 0 and counts["flash_decode"] > 0,
          f"the quantized LM must run B1 and B4: {counts}")
    return counts


def phase_quant_moe(card: str) -> dict:
    """The MoE network of ``phase_moe`` (one GPT-2-small-width block, 8
    experts x hidden 1536, top-2) after ``QuantizeWeightsPass("int8")``: the
    block's six products and the expert slabs int8 (per-expert scales), the
    router float32. ``output()`` on [8, 1024] in grouped dispatch (B5 on the
    slab cast to the rows' dtype) and in sort dispatch; gate: grouped equals
    sort to the MoE phase's output gate. Returns the grouped call's launch
    counts."""
    model = MultiLayerNetwork(moe_lm_conf()).init()
    sort_model = MultiLayerNetwork(moe_lm_conf("sort")).init()
    sort_model.load_state_dict(model.state_dict())
    rs = np.random.RandomState(SEED + 44)
    ids = torch.from_numpy(rs.randint(0, 50257, (B, T_FULL))).cuda()
    model.output(ids)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = model.output(ids)
    torch.cuda.synchronize()
    ms_f32 = 1e3 * (time.perf_counter() - t0)
    qm, applied = rewrite_model(model, [QuantizeWeightsPass("int8")])
    qs, _ = rewrite_model(sort_model, [QuantizeWeightsPass("int8")])
    del model, sort_model
    moe = qm.params[MOE_LAYER]
    check(applied == ["quantize_weights_int8"] and count_quantized_layers(qm) == 2
          and moe["We1_q"].dtype == torch.int8 and tuple(moe["We1_scale"].shape) == (E_MOE, H_MOE)
          and moe["Wg"].dtype == torch.float32,
          f"the int8 MoE network: {applied}, {count_quantized_layers(qm)} layers")
    qm.output(ids)  # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out_g = qm.output(ids)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = _all_counts()
    out_s = qs.output(ids)
    e_gs, e_f32 = rel_err(out_g, out_s), rel_err(out_g, ref)
    mean_f32 = float((out_g - ref).abs().mean() / ref.abs().mean())
    top1 = float((out_g.argmax(1) == ref.argmax(1)).float().mean())
    print(f"int8 moe ({card}): QuantizeWeightsPass('int8') on the MoE network (block + 8 "
          f"experts x hidden 1536), output() [8,1024] grouped {ms:.2f} ms (f32 {ms_f32:.2f} ms); "
          f"grouped vs sort "
          f"rel error {e_gs:.3e} (tol {TOL_BWD_REL[torch.float32]:g}); int8 vs f32: max "
          f"{e_f32:.3e}, mean {mean_f32:.3e} of the mean, top-1 agreement {top1:.4f} (a token "
          f"whose top-2 experts change takes other experts' outputs); launches {counts}")
    check(counts["grouped_matmul"] == 2 and counts["flash_forward"] == 1,
          f"the int8 MoE output() must launch B5 twice and B1 once: {counts}")
    check(e_gs <= TOL_BWD_REL[torch.float32], "int8 grouped dispatch disagrees with sort")
    return counts


def _images_per_s(nets: dict, x, rounds: int = 3) -> dict:
    """``output()`` images/s of each network, the medians of ``rounds``
    rounds taken in turns (forward order, then reversed), after a warm-up."""
    times = {k: [] for k in nets}
    for net in nets.values():
        net.output(x)
    for r in range(rounds):
        for k in (list(nets) if r % 2 == 0 else list(nets)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nets[k].output(x)
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {k: x.shape[0] / float(np.median(v)) for k, v in times.items()}


def phase_resnet_rewrite(card: str) -> dict:
    """The zoo ResNet-50 (224x224x3, 1000 classes) with seeded batch-norm
    statistics, rewritten by ``rewrite_model``: the stem pass alone, the
    fold and affine passes without the stem, the ``"inference"`` pipeline
    (stem, fold; affine where a BN is left) and ``"inference:int8"``;
    ``output()`` images/s at batch 32 of each beside the unrewritten
    network, taken in turns; gate: each float rewrite within 1e-4 of the
    unrewritten output (pooled features and probabilities). Then 3
    ``GraphSolver(optimize="training")`` steps beside 3 plain ones from the
    same weights: the first score (before any update) within 1e-4; the
    later ones printed. Returns the launch counts (no attention kernel)."""
    net = ResNet50(seed=SEED).init()
    _seed_bn_stats(net, SEED + 45)
    rs = np.random.RandomState(SEED + 46)
    x = torch.from_numpy(rs.randn(RESNET_BATCH, 3, 224, 224).astype(np.float32)).cuda()
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, RESNET_BATCH)]).cuda()
    specs = {"stem only": [SpaceToDepthStemPass()],
             "fold + affine": [ConvBatchNormFoldPass(), BatchNormAffinePass()],
             "inference": "inference", "inference:int8": "inference:int8"}
    fa.reset_launch_counts()
    nets, applied = {"unrewritten": net}, {}
    t_rw = {}
    for k, spec in specs.items():
        t0 = time.perf_counter()
        nets[k], applied[k] = rewrite_model(net, spec)
        torch.cuda.synchronize()
        t_rw[k] = time.perf_counter() - t0
    check(applied["inference"] == ["space_to_depth_stem", "conv_bn_fold"]
          and applied["stem only"] == ["space_to_depth_stem"]
          and applied["fold + affine"] == ["conv_bn_fold"]
          and count_quantized_layers(nets["inference:int8"]) == 53,
          f"ResNet-50 rewrites: {applied}, "
          f"{count_quantized_layers(nets['inference:int8'])} quantized layers")
    feats = {k: _graph_acts(m, x[:8], ["avgpool", "fc"]) for k, m in nets.items()}
    errs = {k: max(rel_err(a, b) for a, b in zip(feats[k], feats["unrewritten"]))
            for k in specs}
    del feats
    ips = _images_per_s(nets, x)
    counts = _all_counts()
    print(f"resnet50 inference rewrite ({card}): applied {applied}; rewrite s "
          f"{ {k: round(v, 2) for k, v in t_rw.items()} }; vertices "
          f"{ {k: len(m.conf.vertices) for k, m in nets.items()} }; max error vs unrewritten "
          f"(pooled features, probabilities; 8 images) "
          f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tol {TOL_REWRITE_REL:g} for the float "
          f"rewrites); output() [{RESNET_BATCH},3,224,224] images/s "
          f"{ {k: round(v, 1) for k, v in ips.items()} } (medians of 3 rounds in turns)")
    for k in ("stem only", "fold + affine", "inference"):
        check(errs[k] <= TOL_REWRITE_REL, f"the {k} rewrite disagrees with the unrewritten "
                                          f"ResNet-50: {errs[k]}")
    check(np.isfinite(errs["inference:int8"]), "the int8 ResNet-50 output is not finite")
    del nets
    # training through the stem and affine rewrites, beside plain training
    plain = ResNet50(seed=SEED).init()
    rewritten = ResNet50(seed=SEED).init()
    for m in (plain, rewritten):
        _seed_bn_stats(m, SEED + 45)
    s_plain = GraphSolver(plain)
    s_rw = GraphSolver(rewritten, optimize="training")
    check(s_rw.applied_rewrites == ["space_to_depth_stem", "bn_affine_precompute"],
          f"GraphSolver(optimize='training') applied {s_rw.applied_rewrites}")
    scores = {"plain": [], "rewritten": []}
    ms = {"plain": [], "rewritten": []}
    for _ in range(3):
        for k, s in (("plain", s_plain), ("rewritten", s_rw)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores[k].append(float(s.fit_batch((x,), (y,))))
            torch.cuda.synchronize()
            ms[k].append(1e3 * (time.perf_counter() - t0))
    gaps = [abs(a - b) / abs(a) for a, b in zip(scores["plain"], scores["rewritten"])]
    print(f"resnet50 training rewrite ({card}): GraphSolver(optimize='training') applied "
          f"{s_rw.applied_rewrites}; scores plain {[round(v, 6) for v in scores['plain']]}, "
          f"rewritten {[round(v, 6) for v in scores['rewritten']]}, relative gaps "
          f"{[f'{g:.3e}' for g in gaps]} (tol {TOL_REWRITE_REL:g} on the first: the stem "
          f"kernel's 15 zero taps of each 8x8 block train too, so later steps leave the plain "
          f"trajectory); ms/step plain {[round(v, 1) for v in ms['plain']]}, rewritten "
          f"{[round(v, 1) for v in ms['rewritten']]}")
    check(gaps[0] <= TOL_REWRITE_REL and all(np.isfinite(scores["rewritten"])),
          f"the rewritten first step's score disagrees with plain training: {gaps}")
    del plain, rewritten, s_plain, s_rw
    return counts


def phase_calibrated_dense(card: str) -> dict:
    """The zoo LeNet on a batch of 64 with ``calibrate()`` ranges, rewritten
    by ``QuantizeWeightsPass("int8", act_ranges=...)``: its dense layer
    quantizes its input too and accumulates int8 x int8 in int32
    (``torch._int_mm`` on the card, k = 800, n = 500 padded to 504); gate:
    the card's int32 accumulators equal the CPU's (int64 products) exactly.
    Returns the launch counts (no attention kernel)."""
    net = LeNet(seed=SEED).init()
    rs = np.random.RandomState(SEED + 47)
    x = torch.from_numpy(rs.rand(LENET_BATCH, 784).astype(np.float32)).cuda()
    ranges = calibrate(net, [x])
    fa.reset_launch_counts()
    qm, applied = rewrite_model(net, [QuantizeWeightsPass("int8", act_ranges=ranges)])
    dense = qm.layers[6]
    check(isinstance(dense, QuantizedDenseLayer) and dense.act_absmax == ranges["layer_6"],
          f"the calibrated dense layer: {type(dense).__name__}, ranges {ranges}")
    with torch.inference_mode():
        _, _, _, acts = qm.forward_pure(qm.params, qm.state, qm._input(x), collect=True)
        dense_in = acts[5]
        acc, _ = dense.int32_accumulators(qm.params["layer_6"], dense_in)
        cpu_params = {k: v.detach().cpu() for k, v in qm.params["layer_6"].items()}
        acc_cpu, _ = dense.int32_accumulators(cpu_params, dense_in.cpu())
    exact = torch.equal(acc.cpu(), acc_cpu)
    t0 = time.perf_counter()
    out = qm.output(x)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    err = rel_err(out, net.output(x))
    counts = _all_counts()
    print(f"calibrated int8 dense ({card}): LeNet, calibrate() ranges {ranges}; layer_6 "
          f"int32 accumulators {tuple(acc.shape)} {acc.dtype}, card vs CPU exact {exact} "
          f"(largest |acc| {int(acc.abs().max())}); output() [{LENET_BATCH},784] {ms:.2f} ms, "
          f"error vs f32 {err:.3e}")
    check(acc.is_cuda and acc.dtype == torch.int32 and exact,
          "the card's int32 accumulators differ from the CPU's")
    return counts


def phase_zoo(card: str) -> dict:
    """The rest of the zoo at its published input sizes, batch 8, float32,
    random weights from the constructors' seed and seeded batch-norm
    statistics: ``output()`` (the JAX package's output shape, finite),
    images/s (median of 3 after a warm-up), the parameter count, and the
    ``"inference"`` rewrite within 1e-4 of the unrewritten output. Returns
    the launch counts (no attention kernel)."""
    import deeplearning4j_tpu_torch.model.zoo as zoo

    rs = np.random.RandomState(SEED + 48)
    fa.reset_launch_counts()
    for name, kw, chw, shape in ZOO_CASES:
        t0 = time.perf_counter()
        net = getattr(zoo, name)(**kw).init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        _seed_bn_stats(net, SEED + 49)
        x = torch.from_numpy(rs.randn(ZOO_BATCH, *chw).astype(np.float32)).cuda()
        out = net.output(x)
        out = out[0] if isinstance(out, tuple) else out
        check(tuple(out.shape) == shape and bool(torch.isfinite(out).all()),
              f"{name} output() {tuple(out.shape)} (JAX: {shape}) must be finite")
        rw, applied = rewrite_model(net, "inference")
        rout = rw.output(x)
        rout = rout[0] if isinstance(rout, tuple) else rout
        gap = rel_err(rout, out)
        ips = _images_per_s({"plain": net, "rewritten": rw} if applied else {"plain": net}, x)
        print(f"zoo {name} ({card}): {net.num_params()} params, input [{ZOO_BATCH},"
              f"{','.join(map(str, chw))}] -> {list(out.shape)}, init {init_s:.2f} s; output() "
              f"{ips['plain']:.1f} images/s; 'inference' applied {applied}"
              + (f", {ips['rewritten']:.1f} images/s" if applied else "")
              + f", max error vs unrewritten {gap:.3e} (tol {TOL_REWRITE_REL:g})")
        check(gap <= TOL_REWRITE_REL, f"{name}: the inference rewrite disagrees: {gap}")
        del net, rw, out, rout
    return _all_counts()


# ---- fault-tolerant training (checkpoints, exact resume, early stopping,
# preemption, elastic restart, the step profiler) ---------------------------

FT_STEPS = 8                  # the fault-tolerant phase's steps, one batch each
FT_SAVE_EVERY = 4             # checkpoints at iterations 4 and 8
ES_EPOCHS, ES_BATCHES = 3, 2  # early stopping: 3 epochs of 2 batches
PROFILED_STEPS = 6


def _ft_iterator(n_batches: int, seed: int = SEED + 60):
    """``n_batches`` seeded [8, 1024] batches (labels the ids shifted by
    one) in an in-memory iterator, in order."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 50257, (n_batches * B, T_FULL + 1))
    return ListDataSetIterator(DataSet(ids[:, :-1], ids[:, 1:]), B)


class _StepClock(TrainingListener):
    """A listener that records the wall time of every iteration_done (the
    first in the chain, so a step's interval holds the listeners after it)."""

    def __init__(self):
        self.ts = []

    def iteration_done(self, model, iteration, epoch, score):
        self.ts.append(time.perf_counter())

    def step_ms(self):
        return [1e3 * (b - a) for a, b in zip(self.ts, self.ts[1:])]


def _params_equal(a, b) -> bool:
    return all(torch.equal(p, b.params[l][k]) for l, lp in a.params.items()
               for k, p in lp.items())


def _snapshot_variants(model) -> dict:
    """Seconds on the step thread for the two ways a checkpoint snapshot can
    copy the model's parameters and Adam's moments to the host, each taken
    twice, while the listener's writer writes in the background as it does
    in a run: into pinned buffers (allocated, copies queued ``non_blocking``,
    an event recorded; then waited on) and into pageable ones
    (``to("cpu", copy=True)``, which returns once the copy landed). The
    second of each pair reuses the first's buffers."""
    from deeplearning4j_tpu_torch.train.checkpoint import _tensors

    live = _tensors(({l: dict(lp) for l, lp in model.params.items()},
                     model._trainer.opt_state), [])
    out = {"bytes": sum(t.numel() * t.element_size() for t in live)}
    torch.cuda.synchronize()
    bufs = None
    for key in ("pinned_fresh", "pinned_reused"):
        t0 = time.perf_counter()
        if bufs is None:
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in live]
        for b, t in zip(bufs, live):
            b.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        out[key] = time.perf_counter() - t0
        ev.synchronize()
        out[key + "_landed"] = time.perf_counter() - t0
    del bufs
    bufs = None
    for key in ("pageable_fresh", "pageable_reused"):
        t0 = time.perf_counter()
        if bufs is None:
            bufs = [t.detach().to("cpu", copy=True) for t in live]
        else:
            for b, t in zip(bufs, live):
                b.copy_(t)
        out[key] = time.perf_counter() - t0
    check(all(torch.equal(b, t.cpu()) for b, t in zip(bufs[:3], live[:3])),
          "the pageable snapshot must equal the live tensors")
    return out


def phase_fault_tolerant_lm(card: str) -> dict:
    """The GPT-2-small-width LM (12 blocks, f32, ``Adam(1e-4)``) trained for
    8 steps from an in-memory iterator of 8 seeded [8, 1024] batches, three
    times from the same initial weights (``clone()``): uninterrupted; with
    ``CheckpointListener(async_save=True, save_every_n_iterations=4,
    keep_last=2, iterator=...)``, ``HeartbeatListener`` and an installed
    ``PreemptionHandler`` (params and scores bitwise the uninterrupted
    run's); and restored from the iteration-4 checkpoint into a fresh model
    (``restore_model(load_updater=True)``, ``restore_training_state``, a
    fresh iterator) and fitted to iteration 8 (bitwise again). Returns the
    launch counts of the three runs and a function that waits for the
    writer to finish the iteration-8 zip and prints the phase's numbers
    (``main`` runs the elastic phase meanwhile: its children are processes
    of their own)."""
    from deeplearning4j_tpu_torch.core.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.model import restore_model
    from deeplearning4j_tpu_torch.train import (CheckpointListener, HeartbeatListener,
                                                PreemptionHandler, restore_training_state)

    base = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12, ffn_size=3072,
                         max_len=T_FULL, seed=SEED, dtype="float32").init()
    fa.reset_launch_counts()

    def run(model, it, *extra):
        clock, scores = _StepClock(), CollectScoresListener()
        model.add_listeners(clock, *extra, scores)
        solver = model._trainer if model._trainer is not None else Solver(model)
        model._trainer = solver
        while model.iteration_count < FT_STEPS:
            solver.fit_iterator(it, epochs=1)
        torch.cuda.synchronize()
        return scores.scores, clock.step_ms()

    ref = base.clone()
    before = dict(fa.LAUNCH_COUNTS)
    ref_scores, ref_ms = run(ref, _ft_iterator(FT_STEPS))
    per_step = {n: (fa.LAUNCH_COUNTS[n] - before[n]) / FT_STEPS for n in before}
    check(per_step == {"flash_forward": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                       "flash_decode": 0},
          f"a training step must launch B1, B2 and B3 once per block (12): {per_step}")

    d = tempfile.mkdtemp(prefix="ft_lm_")
    try:
        run_model = base.clone()
        del base
        it = _ft_iterator(FT_STEPS)
        ckpt = CheckpointListener(d, save_every_n_iterations=FT_SAVE_EVERY, keep_last=2,
                                  async_save=True, iterator=it)
        preempt = PreemptionHandler(checkpoint=ckpt).install()
        try:
            scores, ms = run(run_model, it, ckpt, HeartbeatListener(d), preempt)
        finally:
            preempt.uninstall()
        check(scores == ref_scores and _params_equal(run_model, ref),
              f"the checkpointed run must equal the uninterrupted one bitwise: {scores} vs "
              f"{ref_scores}")
        del run_model
        # restore the iteration-4 checkpoint as soon as it is down, while the
        # writer still writes iteration 8's
        zip4 = os.path.join(d, f"checkpoint_iter{FT_SAVE_EVERY}_epoch0.zip")
        deadline = time.monotonic() + 900
        while not os.path.exists(zip4[:-4] + ".state.json") and time.monotonic() < deadline:
            time.sleep(0.1)
        with open(zip4[:-4] + ".state.json") as f:
            state = json.load(f)
        t0 = time.perf_counter()
        resumed = restore_model(zip4, load_updater=True)
        it2 = _ft_iterator(FT_STEPS)
        restore_training_state(resumed, state, iterator=it2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rscores, rms = run(resumed, it2)
        check(rscores == ref_scores[FT_SAVE_EVERY:] and _params_equal(resumed, ref),
              f"the resumed run must equal the uninterrupted one bitwise: {rscores} vs "
              f"{ref_scores[FT_SAVE_EVERY:]}")
        counts = _all_counts()
        del resumed
        variants = _snapshot_variants(ref)
        del ref
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
    t_drain = time.perf_counter()

    def finish():
        try:
            ckpt.close(timeout=900)
            drained = time.perf_counter() - t_drain
            zips = sorted(f for f in os.listdir(d) if f.endswith(".zip"))
            sizes = {f: os.path.getsize(os.path.join(d, f)) for f in zips}
            check(len(ckpt.write_seconds) == 2 and CheckpointListener.last_checkpoint(
                d).endswith(f"checkpoint_iter{FT_STEPS}_epoch0.zip"),
                f"two checkpoints must land: {zips}")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        v = {k: (round(x, 4) if isinstance(x, float) else x) for k, x in variants.items()}
        print(f"fault-tolerant lm ({card}): 8 steps [8,1024] Adam(1e-4) from one clone each; "
              f"step ms median uninterrupted {float(np.median(ref_ms)):.2f} "
              f"{[round(t, 2) for t in ref_ms]}, checkpointed {float(np.median(ms)):.2f} "
              f"{[round(t, 2) for t in ms]} (the snapshot at 4 in step 5's interval, the "
              f"writer's start in step 6's), resumed {[round(t, 2) for t in rms]}; snapshot "
              f"s on the step thread {[round(t, 4) for t in ckpt.snapshot_seconds]}; the "
              f"same tensors copied to the host once more (s on the step thread; pinned: "
              f"until queued, then until landed) {v}; writer s per zip "
              f"{[round(t, 2) for t in ckpt.write_seconds]} (the second beside the "
              f"elastic phase; {drained:.1f} s waited after the resumed run), bytes {sizes}; "
              f"restore {restore_s:.2f} s; scores {[round(x, 5) for x in ref_scores]} bitwise "
              f"in all three runs; launches {counts} (12 B1, B2, B3 a step, 20 steps)")

    return counts, finish


def phase_elastic(card: str) -> dict:
    """The port's chaos harness (``tools/check_training_resilience_contract.py``)
    under ``elastic_fit`` on the card, with its ``"lm"`` configuration: the
    LM at GPT-2 small's widths and the main path's [8, 1024] batch, cut to
    2 blocks, because every child boot writes or restores a checkpoint of
    the parameters and Adam's moments (about 1.1 GB at 2 blocks, 1.96 GB at
    12). Legs uninterrupted, SIGKILL, SIGTERM and stall, concurrently; each
    ends bitwise on the first's parameters, and SIGTERM loses no iteration.
    Returns the launch counts of the children's processes."""
    from deeplearning4j_tpu_torch.tools import check_training_resilience_contract as harness

    torch.cuda.empty_cache()  # the four children share the card with this process
    fa.reset_launch_counts()
    out = harness.run_legs(device="cuda", model="lm", log=lambda m: print(f"elastic {m}"))
    check(out["sigterm"]["lost_iterations"] == 0, "SIGTERM must lose no iteration")
    counts: dict = {}
    for name, leg in out.items():
        g = leg["result"]["goodput"]
        down = {k: round(v, 2) for k, v in g["downtime_seconds"].items() if v}
        per = {k: v / leg["steps"] for k, v in leg["launches"].items() if leg["steps"]}
        check(per.get("flash_forward") == per.get("flash_bwd_dq") ==
              per.get("flash_bwd_dkv") == 2,
              f"{name}: a 2-block step must launch B1, B2 and B3 twice: {leg['launches']}")
        for k, v in leg["launches"].items():
            counts[k] = counts.get(k, 0) + v
        print(f"elastic restart {name} ({card}; [8,1024], 2 of 12 blocks: each child "
              f"writes or restores a ~1.1 GB checkpoint): exit codes {leg['rcs']}, "
              f"{leg['steps']} steps over its runs, wall {leg['seconds']:.1f} s, goodput "
              f"ratio {g['ratio']:.4f}, downtime s {down}, child boot-to-first-step s "
              f"{[round(b, 2) for b in leg['boot_seconds']]}; bitwise equal to uninterrupted")
    counts["grouped_matmul"] = 0
    return counts


def phase_early_stopping_lm(card: str) -> dict:
    """``EarlyStoppingTrainer`` on the GPT-2-small-width LM (12 blocks, f32,
    ``Adam(1e-4)``): 3 epochs of 2 seeded [8, 1024] batches,
    ``DataSetLossCalculator`` on one held-out batch,
    ``MaxEpochsTerminationCondition(3)`` and
    ``ScoreImprovementEpochTerminationCondition(1)``, the best model saved to
    ``model_saver_path``. The best model's held-out loss, recomputed, must
    equal ``best_model_score`` and it must share no storage with the live
    model. Returns the launch counts."""
    from deeplearning4j_tpu_torch.model import serializer
    from deeplearning4j_tpu_torch.train.early_stopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration, EarlyStoppingTrainer,
        MaxEpochsTerminationCondition, ScoreImprovementEpochTerminationCondition)

    model = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12, ffn_size=3072,
                          max_len=T_FULL, seed=SEED, dtype="float32").init()
    d = tempfile.mkdtemp(prefix="es_lm_")
    calc = DataSetLossCalculator(_ft_iterator(1, seed=SEED + 61))
    conf = EarlyStoppingConfiguration(
        score_calculator=calc,
        epoch_termination_conditions=[MaxEpochsTerminationCondition(ES_EPOCHS),
                                      ScoreImprovementEpochTerminationCondition(1)],
        model_saver_path=os.path.join(d, "best.zip"))
    writes = []
    real_write = serializer.write_model

    def timed_write(*a, **kw):
        t0 = time.perf_counter()
        real_write(*a, **kw)
        writes.append(time.perf_counter() - t0)

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(serializer, "write_model", timed_write):
            res = EarlyStoppingTrainer(conf, model, _ft_iterator(ES_BATCHES)).fit()
        fit_s = time.perf_counter() - t0
        saved_bytes = os.path.getsize(conf.model_saver_path)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    counts = _all_counts()
    best = res.best_model
    check(best is not model and all(
        p.data_ptr() != model.params[l][k].data_ptr()
        for l, lp in best.params.items() for k, p in lp.items()),
          "the best model must be a copy of the live model's tensors")
    again = calc.calculate_score(best)
    check(again == res.best_model_score,
          f"the best model's held-out loss {again!r} must equal best_model_score "
          f"{res.best_model_score!r}")
    print(f"early stopping lm ({card}): {res.total_epochs} epochs of {ES_BATCHES} [8,1024] "
          f"batches in {fit_s:.2f} s; score_vs_epoch "
          f"{ {e: round(s, 6) for e, s in res.score_vs_epoch.items()} }; reason "
          f"{res.termination_reason} ({res.termination_details}); best epoch "
          f"{res.best_model_epoch}, recomputed held-out loss equal; model_saver_path write s "
          f"{[round(t, 2) for t in writes]} ({saved_bytes} bytes); launches {counts}")
    return counts


def phase_step_profiler(card: str) -> dict:
    """6 LM steps (GPT-2-small widths, 12 blocks, f32) under
    ``Solver(profiler=StepProfiler(sync_every=2))`` from a wrapped iterator
    and 6 without, from ``clone()``s of the same weights: the scores must be
    bitwise equal. Returns the launch counts."""
    from deeplearning4j_tpu_torch.core.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.obs import MetricsRegistry, StepProfiler

    base = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12, ffn_size=3072,
                         max_len=T_FULL, seed=SEED, dtype="float32").init()
    fa.reset_launch_counts()
    prof = StepProfiler(sync_every=2, registry=MetricsRegistry(), name="chip-smoke")
    runs = []
    for profiler in (prof, None):
        m = base.clone()
        scores = CollectScoresListener()
        m.add_listeners(scores)
        it = _ft_iterator(PROFILED_STEPS, seed=SEED + 62)
        Solver(m, profiler=profiler).fit(prof.wrap_iterator(it) if profiler else it)
        runs.append(scores.scores)
        del m
    check(runs[0] == runs[1], f"profiled scores must equal unprofiled: {runs}")
    st = prof.stats()
    print(f"step profiler lm ({card}): {st['steps']} steps, {st['sampled_steps']} fenced; "
          f"per-step ms {st['per_step_ms']}; share {st['share']}; "
          f"samples/s excluding input {prof.samples_per_sec_excl_input(B):.2f} "
          f"(= {prof.samples_per_sec_excl_input(B) * T_FULL:.0f} tokens/s); scores bitwise "
          f"equal to the unprofiled run; launches {_all_counts()}")
    return _all_counts()


# every data-parallel, pipelined, tensor- and expert-parallel leg's steps:
# 2 keep every gate (the score falls, each fault reads above its limit) and
# the second step is the first to read the carried updater state
DP_STEPS = 2


def _lm_dp_spec():
    from deeplearning4j_tpu_torch.tools import dp_legs

    return dp_legs.lm_spec(steps=DP_STEPS, global_batch=B, seq=T_FULL, seed=SEED)


def phase_dp_world1(card: str):
    """``DistributedTrainer`` at world size 1 over NCCL on the
    GPT-2-small-width LM, ``DP_STEPS`` steps on one seeded [8, 1024] batch, against
    ``Solver.fit_batch`` from the same weights on the same batch: params
    bit for bit equal (an all-reduce over one rank is the identity). It also
    reads what the two-rank phase's gate against this run would see under
    a planted fault: ``Solver`` on the first half of the rows (both ranks
    fed rank 0's rows, an exchange that kept one rank's gradient, or no
    exchange at all, seen from rank 0) and the start params (no update).
    Returns the launch counts of the trainer's steps and a dict: its final
    params (host float32), the params' shapes and the two fault readings."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import DistributedTrainer, initialize_distributed
    from deeplearning4j_tpu_torch.tools import dp_legs

    t0 = time.perf_counter()
    backend = initialize_distributed()
    check(backend == "nccl", f"a CUDA model's default backend must be NCCL, got {backend}")
    spec = _lm_dp_spec()
    ids, labels = (torch.from_numpy(a).cuda() for a in dp_legs.lm_batch(spec))

    def lm():
        return TransformerLM(**spec["lm"], seed=SEED, dtype="float32").init()

    try:
        model, ref = lm(), lm()
        trainer = DistributedTrainer(model)
        check(trainer.n_data_shards == 1, "world 1")
        start = model.params_flat().copy()
        fa.reset_launch_counts()
        scores, step_ms = [], []
        for _ in range(DP_STEPS):
            before = dict(fa.LAUNCH_COUNTS)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            scores.append(float(trainer.fit_batch(ids, labels)))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - ts))
            per_step = {n: fa.LAUNCH_COUNTS[n] - before[n] for n in before}
            check(per_step == {"flash_forward": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                               "flash_decode": 0},
                  f"a data-parallel step must launch B1, B2 and B3 once per block: {per_step}")
        counts = _all_counts()
        solver = Solver(ref)
        want = [float(solver.fit_batch(ids, labels)[0]) for _ in range(DP_STEPS)]
        check(scores == want, f"world-1 scores {scores} must equal Solver's {want}")
        same = all(torch.equal(p, ref.params[l][k]) for l, lp in model.params.items()
                   for k, p in lp.items())
        check(same, "world-1 params must equal Solver.fit_batch's bit for bit")
        check(scores[-1] < scores[0], f"the score must fall: {scores}")
        flat = model.params_flat().copy()
        shapes = [tuple(p.shape) for lp in model.params.values() for p in lp.values()]
        del trainer, model, ref, solver
        half, h = lm(), B // 2
        half_solver = Solver(half)
        for _ in range(DP_STEPS):
            half_solver.fit_batch(ids[:h], labels[:h])
        faults = {"rank 0's rows only": float(np.abs(half.params_flat() - flat).max()),
                  "no update": float(np.abs(start - flat).max())}
        del half, half_solver
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"data-parallel lm world 1 ({card}): NCCL, [8,1024] Adam(1e-4), {DP_STEPS} steps, "
          f"ms/step {[round(t, 2) for t in step_ms]}, scores {[round(x, 5) for x in scores]}; "
          f"params bit for bit Solver.fit_batch's; planted faults vs this run, max |diff| "
          f"{ {k: f'{v:.3e}' for k, v in faults.items()} }; launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s")
    return counts, {"params": flat, "shapes": shapes, "faults": faults}


# two-rank SyncAllReduce vs world 1 (H100 80GB HBM3, 700 W): 3.774e-06 sound;
# the limit sits between that and what a planted fault reads (the world-1
# phase measures those in every run, and the gate checks they stay above it)
TOL_DP_WORLD = 3e-5


def phase_dp_two_ranks(card: str, world1) -> dict:
    """Two ranks share ``cuda:0`` over gloo (NCCL takes one device per
    rank), [4, 1024] each (global [8, 1024], the world-1 phase's batch), in
    one boot: ``SyncAllReduce``, ``BucketedAllReduceSync``, ZeRO-1 (under
    the bucketed exchange) and ``ThresholdCompressedSync``, ``DP_STEPS`` steps each
    from the same seeded weights. Returns the launch counts of both ranks'
    processes."""
    from deeplearning4j_tpu_torch.tools import dp_legs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spec = _lm_dp_spec()
    out = tempfile.mkdtemp(prefix="dp_two_ranks_")
    try:
        reps = dp_legs.run_world(spec, world=2, backend="gloo", device="cuda", out_dir=out,
                                 timeout=900)
        r0, r1 = (r["legs"] for r in reps)
        for leg in r0:
            for k in ("params_sha256", "state_sha256", "scores"):
                check(r0[leg][k] == r1[leg][k], f"{leg}: the ranks differ in {k}")
        for leg in ("bucketed", "zero1"):
            check(r0[leg]["params_sha256"] == r0["sync"]["params_sha256"],
                  f"{leg} must equal SyncAllReduce bit for bit")
        rep, z = r0["bucketed"], r0["zero1"]
        check(z["updater_state_bytes_global"] == rep["updater_state_bytes"],
              "ZeRO-1's global updater bytes must be the replicated bytes")
        # Adam's two float32 moments of every param whose dim 0 the two
        # ranks divide: each rank holds half of them
        sliced = sum(2 * 4 * int(np.prod(s)) for s in world1["shapes"] if s and s[0] % 2 == 0)
        check(z["updater_state_bytes"] == rep["updater_state_bytes"] - sliced // 2,
              f"ZeRO-1 must hold half of the sliced leaves ({sliced} bytes) a rank: "
              f"{z['updater_state_bytes']} of {rep['updater_state_bytes']}")
        check(z["updater_state_bytes"] < 0.7 * rep["updater_state_bytes"],
              f"ZeRO-1 must hold about half of the replicated updater bytes a rank: "
              f"{z['updater_state_bytes']} of {rep['updater_state_bytes']}")
        th = r0["threshold"]
        check(all(np.isfinite(th["scores"])) and th["scores"][-1] < th["scores"][0],
              f"threshold-compressed scores must be finite and fall: {th['scores']}")
        two = np.load(r0["sync"]["params_path"])
        gap = np.abs(two - world1["params"])
        check(float(gap.max()) <= TOL_DP_WORLD,
              f"two-rank SyncAllReduce must be within {TOL_DP_WORLD} of world 1: {gap.max()}")
        check(all(v > TOL_DP_WORLD for v in world1["faults"].values()),
              f"a planted fault must read above the gate {TOL_DP_WORLD}: {world1['faults']}")
        counts: dict = {}
        for r in reps:
            for k, v in r["launches"].items():
                counts[k] = counts.get(k, 0) + v
        want = 2 * len(spec["legs"]) * DP_STEPS * 12
        check(all(counts[n] == want for n in ("flash_forward", "flash_bwd_dq",
                                               "flash_bwd_dkv")),
              f"each rank's step must launch B1-B3 once per block: {counts}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for leg, rec in r0.items():
        ms, coll = rec["step_ms"], rec["collective_ms"]
        share = [c / t for c, t in zip(coll, ms)]
        extra = ""
        if rec["compression"]:
            extra = (f", density {rec['compression']['density']:.4f}, threshold "
                     f"{rec['compression']['threshold']:.6g}")
        print(f"data-parallel lm 2 ranks {leg} ({card}; gloo, [4,1024] a rank): ms/step "
              f"{[round(t, 2) for t in ms]}, collectives ms {[round(c, 2) for c in coll]} "
              f"(share {[round(x, 3) for x in share]}), scores "
              f"{[round(x, 5) for x in rec['scores']]}, updater bytes a rank "
              f"{rec['updater_state_bytes']} of {rec['updater_state_bytes_global']}{extra}")
    print(f"data-parallel lm 2 ranks ({card}): ranks bit for bit equal after every leg; "
          f"bucketed and ZeRO-1 bit for bit SyncAllReduce; ZeRO-1 holds "
          f"{z['updater_state_bytes'] / rep['updater_state_bytes']:.4f} of the replicated "
          f"updater bytes a rank ({sliced} bytes of sliced leaves; the embedding's 50257 rows "
          f"do not divide by 2 and stay whole); SyncAllReduce vs world 1: max |diff| "
          f"{gap.max():.3e}, mean {gap.mean():.3e} (gate {TOL_DP_WORLD:g}; planted faults read "
          f"{ {k: f'{v:.3e}' for k, v in world1['faults'].items()} }); launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def phase_dp_resnet50(card: str) -> dict:
    """``BASELINE.json``'s "SharedTrainingMaster gradient-sharing ResNet-50",
    cut to two ranks sharing the card: the zoo ``ResNet50()`` (224x224x3,
    1000 classes) under ``ThresholdCompressedSync`` with ``bn_group_size=2``
    (each batch norm's moments over both ranks' rows), batch 32 a rank,
    ``DP_STEPS`` steps. Returns the launch counts (no B kernel runs here)."""
    from deeplearning4j_tpu_torch.tools import dp_legs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spec = dp_legs.resnet_spec(steps=DP_STEPS, local_batch=32, seed=SEED)
    out = tempfile.mkdtemp(prefix="dp_resnet_")
    try:
        reps = dp_legs.run_world(spec, world=2, backend="gloo", device="cuda", out_dir=out,
                                 timeout=900)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    a, b = (r["legs"]["threshold_bn2"] for r in reps)
    check(a["params_sha256"] == b["params_sha256"], "ResNet-50 ranks' params differ")
    check(a["state_sha256"] == b["state_sha256"], "ResNet-50 ranks' running statistics differ")
    check(all(np.isfinite(a["scores"])), f"ResNet-50 scores must be finite: {a['scores']}")
    counts: dict = {}
    for r in reps:
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
    comp = a["compression"]
    share = [c / t for c, t in zip(a["collective_ms"], a["step_ms"])]
    print(f"data-parallel resnet50 2 ranks ({card}; gloo, ThresholdCompressedSync, "
          f"bn_group_size=2, batch 32 a rank, 224x224): ms/step "
          f"{[round(t, 2) for t in a['step_ms']]}, collectives ms "
          f"{[round(c, 2) for c in a['collective_ms']]} (share "
          f"{[round(x, 3) for x in share]}), images/s "
          f"{2 * 32 / (np.median(a['step_ms']) / 1e3):.1f}, scores "
          f"{[round(x, 5) for x in a['scores']]}, density {comp['density']:.4f}, threshold "
          f"{comp['threshold']:.6g}; params and running statistics bit for bit equal across "
          f"the ranks; launches {counts}; {time.perf_counter() - t0:.1f} s")
    return counts


def phase_dp_elastic_resize(card: str) -> dict:
    """The port's elastic resize harness on the card
    (``tools/check_elastic_resize_contract.py``, ``"lm"``): 2 -> 1 -> 2 ranks
    by two SIGKILLs, ZeRO-1 state restored onto both widths, nothing
    consumed twice or skipped, the final loss within the gate of the
    fixed-width run, and each resumed boot restoring the killed boot's
    checkpoint bit for bit (width 2 -> 1 and 1 -> 2). Returns the launch
    counts of the ranks' processes."""
    from deeplearning4j_tpu_torch.tools import check_elastic_resize_contract as harness

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = harness.run_legs(device="cuda", model="lm", log=lambda m: print(f"elastic resize {m}"))
    counts: dict = {}
    for name in ("reference", "resize"):
        for k, v in out[name]["launches"].items():
            counts[k] = counts.get(k, 0) + v
    res = out["resize"]
    g = res["result"]["goodput"]
    down = {k: round(v, 2) for k, v in g["downtime_seconds"].items() if v}
    print(f"elastic resize lm ({card}; 2 of 12 blocks at full width, [8,1024], ZeRO-1, "
          f"OrbaxCheckpointer every 2 steps): widths {res['widths']}, exit codes {res['rcs']}, "
          f"committed {res['committed']}, eval loss {res['eval_loss']:.5f} vs fixed width "
          f"{res['reference_eval_loss']:.5f}, goodput {g['ratio']:.4f}, downtime s {down}, "
          f"boot-to-first-step s {[round(b, 2) for b in res['boot_seconds']]}, resize leg "
          f"{res['seconds']:.1f} s; each resumed boot restored the killed boot's checkpoint "
          f"bit for bit (2 -> 1, 1 -> 2); launches {counts}; {time.perf_counter() - t0:.1f} s")
    counts.setdefault("grouped_matmul", 0)
    return counts

# ---------------------------------------------------------------------------
# pipeline and sequence parallelism: gloo ranks sharing cuda:0
# ---------------------------------------------------------------------------

PP_MICRO = 4  # microbatches of the pipelined LM: 2 rows of [8, 1024] each
# the pipelined LM's params after DP_STEPS steps vs the world-1 run's (Solver's),
# max |diff|: between the sound gap and what a planted fault reads, both of
# which the phase reads in every run and the gate checks against this limit
TOL_PP = 3e-5
PP_F64_BATCH = 4  # the float64 pipe x data LM: [4, 1024], 2 microbatches
TOL_PP_F64 = 1e-10


def _sum_launches(reps, legs) -> dict:
    counts: dict = {}
    for r in reps:
        for leg in legs:
            for step in r["legs"][leg]["launches"]:
                for k, v in step.items():
                    counts[k] = counts.get(k, 0) + v
    return counts


def phase_pp_lm(card: str, world1) -> dict:
    """``PipelineParallelTrainer`` on two ranks sharing ``cuda:0`` (one
    stage each: the prelude and 6 blocks, then 6 blocks and the head), the
    GPT-2-small-width LM from the world-1 phase's seed, its [8, 1024] batch
    in 4 microbatches, ``DP_STEPS`` steps under 1F1B and as many under GPipe; each held
    against the world-1 run's params (bit for bit ``Solver.fit_batch``'s)
    within ``TOL_PP``, which each planted fault must exceed. Returns the
    launch counts of both ranks' steps under the two schedules."""
    from deeplearning4j_tpu_torch.tools import dp_legs, pp_legs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spec = {"kind": "pp_lm", "lm": dict(dp_legs.GPT2_SMALL), "seed": SEED, "global_batch": B,
            "seq": T_FULL, "steps": DP_STEPS, "n_micro": PP_MICRO,
            "schedules": ["1f1b", "gpipe"], "faults": list(pp_legs.FAULTS)}
    out = tempfile.mkdtemp(prefix="pp_lm_")
    try:
        reps = pp_legs.run_world(spec, world=2, backend="gloo", device="cuda", out_dir=out,
                                 timeout=900)
        gaps = {}
        for leg in ("1f1b", "gpipe", *pp_legs.FAULTS):
            check(reps[0]["legs"][leg]["scores"] == reps[1]["legs"][leg]["scores"],
                  f"pipelined {leg}: the ranks' scores differ")
            gaps[leg] = float(np.abs(np.load(reps[0]["legs"][leg]["params_path"])
                                     - world1["params"]).max())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for leg in ("1f1b", "gpipe"):
        rec = reps[0]["legs"][leg]
        check(gaps[leg] <= TOL_PP,
              f"pipelined {leg} must be within {TOL_PP} of Solver's params: {gaps[leg]:.3e}")
        check(rec["scores"][-1] < rec["scores"][0], f"the score must fall: {rec['scores']}")
        for r in reps:
            k = r["legs"][leg]["blocks"]
            want = {"flash_forward": 2 * k * PP_MICRO, "flash_bwd_dq": k * PP_MICRO,
                    "flash_bwd_dkv": k * PP_MICRO, "flash_decode": 0, "grouped_matmul": 0}
            for step in r["legs"][leg]["launches"]:
                check(step == want, f"pipelined {leg} rank {r['rank']} ({k} blocks) must launch "
                                    f"{want} a step: {step}")
    for f in pp_legs.FAULTS:
        check(gaps[f] > TOL_PP, f"the planted fault {f} must read above {TOL_PP}: {gaps[f]:.3e}")
    for leg in ("1f1b", "gpipe"):
        for r in reps:
            rec = r["legs"][leg]
            meas = [c["exchange"] / (c["compute"] + c["exchange"]) for c in rec["clock"]]
            hs = rec["host_staged"]
            print(f"pipeline-parallel lm 2 stages {leg} rank {r['rank']} ({card}; gloo, "
                  f"[8,1024] in {PP_MICRO} microbatches, stage {rec['stage']} of "
                  f"{rec['blocks']} blocks): ms/step {[round(t, 2) for t in rec['step_ms']]}, "
                  f"scores {[round(x, 5) for x in rec['scores']]}, bubble share of the "
                  f"schedule {rec['bubble_share']:.4f}, measured exchange-and-wait share of "
                  f"the tick walk {[round(x, 3) for x in meas]}, max_inflight "
                  f"{rec['max_inflight']}, stage times s "
                  f"{[round(x, 5) for x in rec['stage_times']]}, stage_param_bytes "
                  f"{rec['stage_param_bytes']} of {rec['stage_param_bytes_global']}, host "
                  f"transport {hs['calls']} calls, {hs['bytes'] / 1e6:.1f} MB, "
                  f"{1e3 * hs['seconds']:.1f} ms over {DP_STEPS} steps")
    counts = _sum_launches(reps, ("1f1b", "gpipe"))
    print(f"pipeline-parallel lm 2 stages ({card}): params vs the world-1 run (Solver's), max "
          f"|diff| 1f1b {gaps['1f1b']:.3e}, gpipe {gaps['gpipe']:.3e} (gate {TOL_PP:g}); "
          f"planted faults read { {f: f'{gaps[f]:.3e}' for f in pp_legs.FAULTS} }; launches "
          f"{counts}; the two ranks time-slice one card, so no speed-up from pipelining is "
          f"claimed; {time.perf_counter() - t0:.1f} s")
    return counts


def phase_pp_dp_f64(card: str) -> dict:
    """The 2-block GPT-2-width LM in float64 (the f64 kernels) over
    pipe=2 x data=2, four gloo ranks on ``cuda:0``, [4, 1024] in 2
    microbatches, ``DP_STEPS`` steps replicated and as many under ZeRO-1
    (bit for bit equal), within 1e-10 of ``Solver.fit_batch``; the
    replicated run's checkpoint restored into a ``DistributedTrainer`` over
    the four ranks and a ``Solver``, each of whose next step is within 1e-10
    of Solver's next.
    Returns the launch counts of the trainers' steps."""
    from deeplearning4j_tpu_torch.tools import dp_legs, pp_legs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    lm = dict(dp_legs.GPT2_SMALL, n_layers=2)
    spec = {"kind": "ppdp", "lm": lm, "seed": SEED, "global_batch": PP_F64_BATCH,
            "seq": T_FULL, "steps": DP_STEPS, "n_micro": 2}
    out = tempfile.mkdtemp(prefix="pp_dp_")
    try:
        reps = pp_legs.run_world(spec, world=4, backend="gloo", device="cuda", out_dir=out,
                                 timeout=900)
        legs = reps[0]["legs"]
        rep_p = np.load(legs["replicated"]["params_path"])
        z_p = np.load(legs["zero1"]["params_path"])
        dp_p = np.load(os.path.join(out, "params_dp_next.npy"))
        sv_p = np.load(os.path.join(out, "params_solver_next.npy"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    ids, labels = (torch.from_numpy(a).cuda() for a in pp_legs._lm_batch(spec))
    ref = TransformerLM(**lm, seed=SEED, dtype="float64").init()
    solver = Solver(ref)
    want = [float(solver.fit_batch(ids, labels)[0]) for _ in range(DP_STEPS)]
    ref_last = ref.params_flat().copy()
    want.append(float(solver.fit_batch(ids, labels)[0]))
    ref_next = ref.params_flat().copy()
    del ref, solver
    torch.cuda.empty_cache()
    for r in reps:
        for leg in ("replicated", "zero1"):
            check(r["legs"][leg]["scores"] == legs[leg]["scores"],
                  f"pipe x data {leg}: rank {r['rank']}'s scores differ")
    check(legs["zero1"]["scores"] == legs["replicated"]["scores"] and np.array_equal(z_p, rep_p),
          "ZeRO-1 must equal the replicated pipe x data run bit for bit")
    gap = float(np.abs(rep_p - ref_last).max())
    s_gap = max(abs(a - b) for a, b in zip(legs["replicated"]["scores"], want))
    check(gap <= TOL_PP_F64 and s_gap <= TOL_PP_F64,
          f"pipe x data float64 must be within {TOL_PP_F64} of Solver: params {gap:.3e}, "
          f"scores {s_gap:.3e}")
    check(legs["restored_stages"] == 2, f"the checkpoint must record 2 stages: "
                                        f"{legs['restored_stages']}")
    next_gaps = {"DistributedTrainer": (abs(legs["dp_next"] - want[DP_STEPS]),
                                        float(np.abs(dp_p - ref_next).max())),
                 "Solver": (abs(legs["solver_next"] - want[DP_STEPS]),
                            float(np.abs(sv_p - ref_next).max()))}
    for name, (sg, pg) in next_gaps.items():
        check(sg <= TOL_PP_F64 and pg <= TOL_PP_F64,
              f"the pipelined checkpoint restored into {name}: its next step must be within "
              f"{TOL_PP_F64} of Solver's: score {sg:.3e}, params {pg:.3e}")
    counts = _sum_launches(reps, ("replicated", "zero1"))
    for r in reps:
        k = r["legs"]["replicated"]["blocks"]
        want_l = {"flash_forward": 2 * k * 2, "flash_bwd_dq": k * 2, "flash_bwd_dkv": k * 2,
                  "flash_decode": 0, "grouped_matmul": 0}
        for leg in ("replicated", "zero1"):
            for step in r["legs"][leg]["launches"]:
                check(step == want_l, f"pipe x data rank {r['rank']} must launch {want_l} a "
                                      f"step: {step}")
    rec = legs["replicated"]
    print(f"pipeline x data lm float64 ({card}; 4 gloo ranks, pipe=2 x data=2, 2 blocks at "
          f"GPT-2 widths, [4,1024] in 2 microbatches): ms/step replicated "
          f"{[round(t, 2) for t in rec['step_ms']]}, ZeRO-1 "
          f"{[round(t, 2) for t in legs['zero1']['step_ms']]}; scores "
          f"{[round(x, 8) for x in rec['scores']]}; ZeRO-1 bit for bit replicated; vs Solver "
          f"params {gap:.3e}, scores {s_gap:.3e} (gate {TOL_PP_F64:g}); the checkpoint's next "
          f"step (score, params) { {k: (f'{a:.3e}', f'{b:.3e}') for k, (a, b) in next_gaps.items()} }; "
          f"launches {counts}; {time.perf_counter() - t0:.1f} s")
    return counts


# ring and Ulysses (2 ranks) vs flash_attention on the whole sequence in
# one process, float32: outputs max |diff| (the ring combines two blocks'
# normalised outputs by their lse, one more float32 rounding than the
# whole-sequence kernel), gradients relative to the largest value: B2/B3's
# own float32 limit against their plain versions, set for sums of up to
# t = 1024 terms, scaled by t / 1024, since a float32 sum's rounding grows
# with its length (H100 80GB HBM3, 700 W: the ring's dk at t = 1024 read
# 7.8e-06, at t = 16384 1.09e-04; a block lost or misplaced reads O(1))
TOL_SEQ_OUT = TOL_OUT[torch.float32]
TOL_SEQ_GRAD = TOL_BWD_REL[torch.float32]
# a 50257 x 768 float32 table's sparse update against numpy's np.add.at:
# index_add_ on the card adds repeated ids in another order (one float32
# ulp of values below 4)
TOL_TABLE = 1e-6


def phase_sequence(card: str) -> dict:
    """Ring and Ulysses attention on two gloo ranks sharing ``cuda:0`` at
    [8, 12, 1024, 64] and [1, 12, 16384, 64] in float32, causal and not,
    and a causal ring across lengths (q 512, k 1024), against
    ``flash_attention`` on the whole sequence in one process (forward and
    q/k/v gradients); then a 50257 x 768 ``ShardedEmbeddingTable`` over the
    two ranks against a dense table. Returns the launch counts of the ring
    and Ulysses runs."""
    from deeplearning4j_tpu_torch.tools import pp_legs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cases = []
    for kind in ("ring", "ulysses"):
        for shape in ([B, H, T_FULL, T_FULL, D], [1, H, 16384, 16384, D]):
            for causal in (True, False):
                cases.append(dict(label=f"{kind} [{shape[0]},{H},{shape[2]},{D}] causal={causal}",
                                  kind=kind, shape=shape, causal=causal, seed=SEED + len(cases)))
    cases.append(dict(label=f"ring cross-length q [{B},{H},512,{D}] k [{B},{H},{T_FULL},{D}] "
                            "causal", kind="ring", shape=[B, H, 512, T_FULL, D], causal=True,
                      seed=SEED + 99))
    spec = {"kind": "seq", "cases": cases,
            "table": {"vocab": 50257, "dim": 768, "seed": SEED, "lookups": 8 * T_FULL}}
    out = tempfile.mkdtemp(prefix="seq_")
    try:
        reps = pp_legs.run_world(spec, world=2, backend="gloo", device="cuda", out_dir=out,
                                 timeout=900)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    r0, r1 = (r["legs"] for r in reps)
    for rec, other in zip(r0["cases"], r1["cases"]):
        b, h, tq, tk, d = rec["shape"]
        errs = (rec["max_abs_out"], rec["rel_dq"], rec["rel_dk"], rec["rel_dv"])
        tol_grad = TOL_SEQ_GRAD * max(1.0, max(tq, tk) / T_FULL)
        check(rec["max_abs_out"] <= TOL_SEQ_OUT and max(errs[1:]) <= tol_grad,
              f"{rec['label']}: against the whole-sequence kernel: out {errs[0]:.3e} (tol "
              f"{TOL_SEQ_OUT:g}), rel dq/dk/dv {errs[1:]} (tol {tol_grad:g})")
        got = {n: rec["launches"][n] + other["launches"][n]
               for n in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")}
        if rec["kind"] == "ulysses":
            want = 2
        else:  # 2 ranks x 2 blocks, less the blocks wholly in the causal future
            skipped = sum(1 for i in range(2) for src in range(2)
                          if rec["causal"] and i * (tq // 2) + 2 * ((tk - tq) // 2)
                          - src * (tk // 2) + tq // 2 - 1 < 0)
            want = 4 - skipped
        check(all(v == want for v in got.values()),
              f"{rec['label']}: the two ranks must launch {want} of each of B1, B2, B3: {got}")
        hs = rec["host_staged"]
        print(f"sequence parallel {rec['label']} ({card}; 2 gloo ranks): forward "
              f"{rec['fwd_ms']:.2f} ms, backward {rec['bwd_ms']:.2f} ms (rank 0, host clock, "
              f"fenced), whole-sequence flash_attention forward {rec['whole_ms']:.3f} ms; out "
              f"max |diff| {errs[0]:.3e} (|out| <= {rec['ref_max_out']:.3f}), rel dq "
              f"{errs[1]:.3e} dk {errs[2]:.3e} dv {errs[3]:.3e} (tol {tol_grad:g}); launches "
              f"{got}; host "
              f"transport {hs['calls']} calls, {hs['bytes'] / 1e6:.1f} MB, "
              f"{1e3 * hs['seconds']:.1f} ms")
    tab = r0["table"]
    check(tab["lookup_err"] == 0.0, f"sharded table lookups must equal the dense rows: "
                                    f"{tab['lookup_err']}")
    check(tab["update_err"] <= TOL_TABLE, f"sharded table sparse update vs dense: "
                                          f"{tab['update_err']:.3e} (tol {TOL_TABLE:g})")
    counts: dict = {}
    for r in reps:
        for k, v in r["legs"]["main_launches"].items():
            counts[k] = counts.get(k, 0) + v
    print(f"sharded embedding table 50257x768 over 2 ranks ({card}): {tab['local_rows']} rows a "
          f"rank; {tab['lookups']} lookups (repeated ids) {tab['lookup_ms']:.2f} ms, exact; "
          f"sparse update {tab['add_ms']:.2f} ms, max |diff| vs np.add.at "
          f"{tab['update_err']:.3e}; sequence-parallel launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# tensor and expert parallelism: gloo ranks sharing cuda:0
# ---------------------------------------------------------------------------

# the Megatron-split LM's params after DP_STEPS steps vs the world-1 run's
# (Solver's), max |diff|: between the sound gap and what each planted fault
# reads, both of which the phase reads in every run
TOL_TP = 3e-5
# float64 legs: params max |diff|, scores relative to the score (a score
# of ~10.8 carries the params' gap through the loss: Lamb's layer norms are
# float32 in both packages, and a norm summed over shards rounds otherwise)
TOL_TP_F64 = 1e-10
TPEP_F64_STEPS = 2  # the float64 legs' steps (each leg also boots a model)


def _legs_check_ranks(reps, legs, what: str) -> None:
    """The ranks of each sound leg agree on every score (a planted fault's
    ranks need not: rank 0's params are read)."""
    for leg in legs:
        check(all(r["legs"][leg]["scores"] == reps[0]["legs"][leg]["scores"] for r in reps),
              f"{what} {leg}: the ranks' scores differ")


def _shares(rec) -> tuple:
    return ([round(c / t, 3) for c, t in zip(rec["collective_ms"], rec["step_ms"])],
            [round(c / t, 3) for c, t in zip(rec["activation_ms"], rec["step_ms"])])


def phase_tp_lm(card: str, world1) -> dict:
    """``DistributedTrainer`` under the Megatron rules on two ranks sharing
    ``cuda:0`` (``data=1, model=2``): the GPT-2-small-width LM from the
    world-1 phase's seed on its [8, 1024] batch, each rank holding half of
    every block's Wq/Wk/Wv/W1/b1 columns and Wo/W2 rows, ``DP_STEPS`` steps; held
    against the world-1 run's params (bit for bit ``Solver.fit_batch``'s)
    within ``TOL_TP``, which one step under each planted fault must exceed
    against the sound run's first step; ``output()`` over the shards
    against the model's own after ``sync_to_model``.
    Returns the launch counts of both ranks' sound steps."""
    from deeplearning4j_tpu_torch.tools import dp_legs, tp_legs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = tempfile.mkdtemp(prefix="tp_lm_")
    spec = {"kind": "tp_lm", "lm": dict(dp_legs.GPT2_SMALL), "seed": SEED, "global_batch": B,
            "seq": T_FULL, "steps": DP_STEPS, "faults": list(tp_legs.TP_FAULTS),
            "probe_len": 256, "reference": os.path.join(out, "world1.npy")}
    legs = ("sound", *tp_legs.TP_FAULTS)
    try:
        np.save(spec["reference"], world1["params"])
        reps = tp_legs.run_world(spec, world=2, backend="gloo", device="cuda", out_dir=out,
                                 timeout=900)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    _legs_check_ranks(reps, ("sound",), "tensor-parallel")
    gaps = {leg: reps[0]["legs"][leg]["fault_gap" if leg in tp_legs.TP_FAULTS else "params_gap"]
            for leg in legs}
    rec = reps[0]["legs"]["sound"]
    check(gaps["sound"] <= TOL_TP,
          f"the Megatron-split LM must be within {TOL_TP} of Solver's params: "
          f"{gaps['sound']:.3e}")
    check(rec["scores"][-1] < rec["scores"][0], f"the score must fall: {rec['scores']}")
    for f in tp_legs.TP_FAULTS:
        check(gaps[f] > TOL_TP, f"the planted fault {f} must read above {TOL_TP}: {gaps[f]:.3e}")
    want = {"flash_forward": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12, "flash_decode": 0,
            "grouped_matmul": 0}
    heads = H // 2
    for r in reps:
        s = r["legs"]["sound"]
        for step in s["launches"]:
            check(step == want, f"rank {r['rank']} must launch {want} a step: {step}")
        check(s["heads"] == {k: [heads] for k in ("flash_forward", "flash_bwd_dq",
                                                  "flash_bwd_dkv")},
              f"rank {r['rank']}: B1-B3 must run on {heads} heads: {s['heads']}")
        check(s["output_gap"] <= TOL_OUT[torch.float32],
              f"rank {r['rank']}: output() over the shards vs the whole model "
              f"{s['output_gap']:.3e} (tol {TOL_OUT[torch.float32]:g})")
        check(s["param_bytes"] < s["param_bytes_global"], "a rank must hold less than the model")
        coll, act = _shares(s)
        print(f"tensor-parallel lm 2 ranks rank {r['rank']} ({card}; gloo, data=1 x model=2, "
              f"Megatron rules on 12 blocks, [8,1024] Adam(1e-4)): ms/step "
              f"{[round(t, 2) for t in s['step_ms']]}, scores "
              f"{[round(x, 5) for x in s['scores']]}, host-timed share of the step in all "
              f"collectives {coll}, in the activation collectives {act}; B1-B3 heads "
              f"{s['heads']}; param bytes a rank {s['param_bytes']} of {s['param_bytes_global']} "
              f"({s['sharded_params']} params split); output() vs the whole model max |diff| "
              f"{s['output_gap']:.3e}")
    counts = _sum_launches(reps, ("sound",))
    print(f"tensor-parallel lm 2 ranks ({card}): params vs the world-1 run (Solver's), max "
          f"|diff| {gaps['sound']:.3e} (gate {TOL_TP:g}); one step under each planted fault "
          f"against the sound run's first reads "
          f"{ {f: f'{gaps[f]:.3e}' for f in tp_legs.TP_FAULTS} }; launches {counts}; the two "
          f"ranks time-slice one card, so no speed-up from tensor parallelism is claimed; "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def phase_ep_moe(card: str) -> dict:
    """``DistributedTrainer`` under ``moe_expert_parallel_rules`` on two
    ranks sharing ``cuda:0`` (``data=1, model=2``): the MoE network of
    phase "MoE network" on its [8, 1024] batch, each rank holding and
    computing 4 of the 8 experts, in grouped dispatch (B5 over the rank's 4
    experts) and in sort dispatch. From the seeded params, its gradients and
    ``output()`` are held against the replicated network's at the MoE
    phase's float32 gates (``TOL_GRAD_REL``, ``TOL_BWD_REL``), which each
    planted fault's gradients (grouped) must exceed; then ``DP_STEPS``
    steps, beside the replicated network's ``Solver`` steps. Returns the launch counts
    of both ranks' training steps."""
    from deeplearning4j_tpu_torch.tools import tp_legs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    modes = ["grouped", "sort"]
    spec = {"kind": "ep_moe", "seed": SEED, "global_batch": B, "seq": T_FULL,
            "steps": DP_STEPS, "modes": modes, "faults": list(tp_legs.EP_FAULTS),
            "probe_len": 256}
    out = tempfile.mkdtemp(prefix="ep_moe_")
    try:
        reps = tp_legs.run_world(spec, world=2, backend="gloo", device="cuda", out_dir=out,
                                 timeout=900)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    _legs_check_ranks(reps, modes, "expert-parallel")
    r0 = reps[0]["legs"]
    gaps = {m: r0[m]["params_gap"] for m in modes}
    tol_out = TOL_BWD_REL[torch.float32]
    for m in modes:
        rec = r0[m]
        check(rec["grad_rel"][0] <= TOL_GRAD_REL and rec["out_rel"] <= tol_out,
              f"expert-parallel {m} vs the replicated network: gradients worst rel "
              f"{rec['grad_rel']} (tol {TOL_GRAD_REL:g}), output rel {rec['out_rel']:.3e} "
              f"(tol {tol_out:g})")
        check(rec["scores"][-1] < rec["scores"][0], f"the score must fall: {rec['scores']}")
        want = {"flash_forward": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "flash_decode": 0,
                "grouped_matmul": 4 if m == "grouped" else 0}
        for r in reps:
            s = r["legs"][m]
            for step in s["launches"]:
                check(step == want, f"expert-parallel {m} rank {r['rank']} must launch {want} "
                                    f"a step: {step}")
            check(s["slabs"]["We1"] == [E_MOE // 2, 768, H_MOE] and s["ep_shards"] == 2,
                  f"rank {r['rank']} must hold 4 experts: {s['slabs']}")
            check(s["expert_tokens"] == rec["expert_tokens"]
                  and sum(s["expert_tokens"]) + s["dropped_tokens"] == TOPK * B * T_FULL,
                  f"rank {r['rank']}: the expert counts must be global: {s['expert_tokens']}")
            coll, act = _shares(s)
            print(f"expert-parallel moe 2 ranks {m} rank {r['rank']} ({card}; gloo, data=1 x "
                  f"model=2, [8,1024] Adam(1e-4)): expert slabs a rank We1 {s['slabs']['We1']}, "
                  f"We2 {s['slabs']['We2']}; ms/step {[round(t, 2) for t in s['step_ms']]}, "
                  f"scores {[round(x, 5) for x in s['scores']]} (replicated "
                  f"{[round(x, 5) for x in r0[f'replicated_{m}']['scores']]}); collectives "
                  f"share {coll}, activation share {act}; last step routed "
                  f"{[int(v) for v in s['expert_tokens']]}; param bytes a rank "
                  f"{s['param_bytes']} of {s['param_bytes_global']}")
    for f in tp_legs.EP_FAULTS:
        check(r0[f]["grad_rel"][0] > TOL_GRAD_REL,
              f"the planted fault {f} must read above {TOL_GRAD_REL}: {r0[f]['grad_rel']}")
    counts = _sum_launches(reps, modes)
    out_rel = {m: f"{r0[m]['out_rel']:.3e}" for m in modes}
    print(f"expert-parallel moe 2 ranks ({card}): vs the replicated network from the seeded "
          f"params, gradients worst rel { {m: r0[m]['grad_rel'] for m in modes} } (gate "
          f"{TOL_GRAD_REL:g}), output rel {out_rel} (gate {tol_out:g}); planted faults' gradients read "
          f"{ {f: r0[f]['grad_rel'] for f in tp_legs.EP_FAULTS} }; after {DP_STEPS} Adam steps params "
          f"max |diff| from the replicated run { {m: f'{g:.3e}' for m, g in gaps.items()} } "
          f"(no gate: a token whose top-2 or capacity slot flips on a float32 rounding moves "
          f"its experts' update by up to 2 x lr a step); launches {counts}; "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def phase_tpep_f64(card: str) -> dict:
    """Tensor and expert parallelism x data in float64 (the f64 kernels) on
    four gloo ranks sharing ``cuda:0`` at ``data=2, model=2``: the 2-block
    GPT-2-width LM under the Megatron rules with ``CLIP_L2_PER_LAYER`` and
    Lamb(1e-4), [4, 1024], 2 steps replicated and 2 under ZeRO-1, each within
    1e-10 of ``Solver.fit_batch``; the replicated leg's checkpoint restored
    into ``DistributedTrainer`` without rules and ``Solver``, each of whose
    next step is within 1e-10 of Solver's third; then the MoE network under
    ``BucketedAllReduceSync`` with the expert rules, plain and ZeRO-1,
    within 1e-10 of the trainer without rules. Returns the launch counts of
    the trainers' steps."""
    from deeplearning4j_tpu_torch.tools import dp_legs, tp_legs

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    lm = dict(dp_legs.GPT2_SMALL, n_layers=2)
    spec = {"kind": "tpep_f64", "lm": lm, "seed": SEED, "global_batch": PP_F64_BATCH,
            "seq": T_FULL, "steps": TPEP_F64_STEPS, "lamb_lr": 1e-4}
    out = tempfile.mkdtemp(prefix="tpep_")
    lm_legs, moe_legs = ("lm_replicated", "lm_zero1"), ("moe_ep", "moe_ep_zero1", "moe_replicated")
    try:
        reps = tp_legs.run_world(spec, world=4, backend="gloo", device="cuda", out_dir=out,
                                 timeout=900)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    _legs_check_ranks(reps, lm_legs + moe_legs, "float64")
    legs = reps[0]["legs"]
    pg, want = legs["gaps"], legs["solver"]
    gaps = {leg: (pg[leg], max(abs(a - b) / abs(b) for a, b in zip(legs[leg]["scores"], want)))
            for leg in lm_legs}
    for leg, g in gaps.items():
        check(max(g) <= TOL_TP_F64, f"{leg} must be within {TOL_TP_F64} of Solver: "
                                    f"params, relative scores {g}")
    z1_bitwise = legs["zero1_bitwise"]
    nxt = want[TPEP_F64_STEPS]
    next_gaps = {"DistributedTrainer": (abs(legs["dp_next"] - nxt) / abs(nxt), pg["dp_next"]),
                 "Solver": (abs(legs["solver_next"] - nxt) / abs(nxt), pg["solver_next"])}
    for name, (sg, gp) in next_gaps.items():
        check(sg <= TOL_TP_F64 and gp <= TOL_TP_F64,
              f"the tensor-parallel checkpoint restored into {name}: its next step must be "
              f"within {TOL_TP_F64} of Solver's: relative score {sg:.3e}, params {gp:.3e}")
    moe_gaps = {leg: pg[leg] for leg in ("moe_ep", "moe_ep_zero1")}
    for leg, g in moe_gaps.items():
        check(g <= TOL_TP_F64 and legs[leg]["ep_shards"] == 2,
              f"{leg} must be within {TOL_TP_F64} of the trainer without rules: {g:.3e}")
    moe_bitwise = {leg: legs[f"{leg}_bitwise"] for leg in moe_gaps}
    for r in reps:
        for leg in lm_legs + moe_legs:
            moe = leg.startswith("moe")
            want_l = ({"flash_forward": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                       "flash_decode": 0, "grouped_matmul": 4} if moe else
                      {"flash_forward": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                       "flash_decode": 0, "grouped_matmul": 0})
            for step in r["legs"][leg]["launches"]:
                check(step == want_l, f"float64 {leg} rank {r['rank']} must launch {want_l} a "
                                      f"step: {step}")
    counts = _sum_launches(reps, lm_legs + moe_legs)
    ms = {leg: [round(t, 2) for t in legs[leg]["step_ms"]] for leg in lm_legs + moe_legs}
    print(f"tensor and expert parallel x data float64 ({card}; 4 gloo ranks, data=2 x model=2, "
          f"[4,1024]): LM 2 blocks Megatron rules, CLIP_L2_PER_LAYER, Lamb(1e-4): vs Solver "
          f"(params, relative scores) { {k: (f'{a:.3e}', f'{b:.3e}') for k, (a, b) in gaps.items()} } "
          f"(gate {TOL_TP_F64:g}), ZeRO-1 bit for bit replicated: {z1_bitwise}; the "
          f"checkpoint's next step (relative score, params) "
          f"{ {k: (f'{a:.3e}', f'{b:.3e}') for k, (a, b) in next_gaps.items()} }; MoE under "
          f"BucketedAllReduceSync with expert rules vs without, max |diff| "
          f"{ {k: f'{v:.3e}' for k, v in moe_gaps.items()} }, bit for bit {moe_bitwise}; "
          f"ms/step {ms}; launches {counts}; {time.perf_counter() - t0:.1f} s")
    return counts


# ---- the periphery (ROADMAP A10): the NLP, UI, RL and arbiter modules -------

MLM_STEPS, MLM_STATS_EVERY = 8, 4
# bert-base's published WordPiece vocabulary size; the phase generates one
# of that size from SEED: the five specials, whole-word pieces, "##" pieces
MLM_VOCAB, MLM_WORDS = 30522, 20000
# Word2Vec, GloVe and ParagraphVectors on the card against the port's CPU
# run of the same fits (tools/embedding_reference.py, a process of its own
# started at the script's start): both draw the same pairs, negatives and
# permutations, so they differ by summation order only (index_add_'s
# atomics on the card); the gate is on the largest gap over the largest
# |value| of each table. Negative sampling, GloVe and ParagraphVectors read
# 4e-7-1.1e-5 (H100 80GB HBM3, 700 W). Hierarchical softmax sends every pair
# of a batch through the root's row, so its sums reorder most: the CPU's own
# fit with each step's index_add_ rows permuted moves syn0 by 2.8e-4 and
# syn1 by 5.0e-5 of their largest values (NS: 1.7e-6, 4.9e-6;
# tools/embedding_order_noise.py), and the card read 2.6e-4 and 4.3e-5;
# its gate sits above that noise
TOL_EMBED_REL = 1e-4
TOL_EMBED_HS_REL = 1e-3
# one DQN train_step and one A3C update on the card against the port's CPU
# result from the same params and batch, max abs gap over every param
# (float32 products in another summation order on a 4 x 16 x 16 x 16 x 2
# network)
TOL_RL_CARD = 1e-5
DQN_MAX_STEP = 2000       # the rl4j CartPole example's max_step 150000, cut
ARBITER_BATCHES, ARBITER_CANDIDATES = 20, 4


def start_embedding_reference(out_dir: str):
    """Starts the CPU run of the embedding phase's fits (2 threads, so the
    card's phases keep the host's other cores); :func:`phase_embeddings`
    waits for it."""
    out = os.path.join(out_dir, "embedding_reference.npz")
    log = os.path.join(out_dir, "embedding_reference.log")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")]))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.tools.embedding_reference",
             "--device", "cpu", "--threads", "2", "--seed", str(SEED), "--out", out],
            env=env, stdout=f, stderr=subprocess.STDOUT)
    return proc, out, log


def _mlm_corpus():
    """A ``Vocabulary`` of ``MLM_VOCAB`` entries generated from ``SEED`` (the
    five BERT specials, whole-word pieces and "##" continuations of 2-9
    lowercase letters) and 64 seeded sentences of Zipf-drawn words, some
    glued to a continuation, each longer than 512 word pieces."""
    from deeplearning4j_tpu_torch.nlp import Vocabulary

    rs = np.random.RandomState(SEED + 90)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    seen, words, pieces = set(), [], []
    while len(words) + len(pieces) < MLM_VOCAB - 5:
        s = "".join(letters[rs.randint(0, 26, rs.randint(2, 10))])
        if s in seen:
            continue
        seen.add(s)
        (words if len(words) < MLM_WORDS else pieces).append(s)
    vocab = Vocabulary(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
                       + ["##" + p for p in pieces])
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    sentences = []
    for _ in range(MLM_STEPS * BERT_BATCH):
        ws = [words[i] for i in rs.choice(len(words), 600, p=p)]
        glue = rs.rand(len(ws)) < 0.2
        sentences.append(" ".join(w + pieces[rs.randint(len(pieces))] if g else w
                                  for w, g in zip(ws, glue)))
    return vocab, sentences


def phase_bert_mlm(card: str) -> dict:
    """BERT-base masked-LM pretraining from ``BertIterator``, the training UI
    watching: the zoo ``BertEncoder()`` at bert-base's widths (L 12, H 768,
    A 12, FFN 3072, vocab 30522, 512 positions), a generated 30522-entry
    WordPiece vocabulary, ``BertIterator(task=UNSUPERVISED, max_length=512,
    batch_size=8, mask_prob=0.15)`` over 64 sentences that fill their rows,
    ``MLM_STEPS`` ``GraphSolver.fit_batch`` steps with the iterator's key and
    label masks under ``StatsListener(FileStatsStorage, update_frequency=4)``,
    ``ProfilingListener`` and ``NanPanicListener``, with ``UIServer(port=0)``
    scraped during the run and after it. MFU against ``bench``'s
    ``chip_peak_flops(device, "float32")`` (the CUDA cores: TF32 is off).
    Returns the launch counts of the training run (B1-B3)."""
    from deeplearning4j_tpu_torch.bench import bert_train_flops_per_token, chip_peak_flops
    from deeplearning4j_tpu_torch.nlp import BertIterator, BertTask, BertWordPieceTokenizer
    from deeplearning4j_tpu_torch.ui import (FileStatsStorage, NanPanicListener,
                                             ProfilingListener, StatsListener, UIServer)

    t0 = time.perf_counter()
    vocab, sentences = _mlm_corpus()
    it = BertIterator(BertWordPieceTokenizer(vocab), task=BertTask.UNSUPERVISED,
                      sentences=sentences, max_length=BERT_T, batch_size=BERT_BATCH,
                      mask_prob=0.15, seed=SEED)
    batches = list(it)
    data_s = time.perf_counter() - t0
    check(len(vocab) == MLM_VOCAB and len(batches) == MLM_STEPS,
          f"MLM data: vocab {len(vocab)}, {len(batches)} batches")
    ids0, mask0 = batches[0].features
    check(ids0.shape == (BERT_BATCH, BERT_T) and bool((mask0 == 1).all()),
          "every MLM row must fill its 512 positions")
    picked = float(np.mean([b.labels_masks[0].mean() for b in batches]))
    zoo = BertEncoder(seed=SEED)
    model = zoo.init()
    solver = GraphSolver(model)
    tmp = tempfile.mkdtemp(prefix="bert_mlm_")
    storage = FileStatsStorage(os.path.join(tmp, "stats.jsonl"))
    trace_path = os.path.join(tmp, "trace.json")
    model.add_listeners(StatsListener(storage, session_id="bert-mlm",
                                      update_frequency=MLM_STATS_EVERY),
                        ProfilingListener(trace_path), NanPanicListener())
    ui = UIServer(port=0).attach(storage).start()
    try:
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        scores, step_ms, listen_ms, scraped = [], [], [], None
        model.listeners.epoch_start(model)
        for mds in batches:
            (ids, mask), (labels,), (lmask,) = mds.features, mds.labels, mds.labels_masks
            t1 = time.perf_counter()
            score = solver.fit_batch((ids,), (labels,), masks=(mask,), label_masks=(lmask,))
            model.score_value = float(score)  # waits for the step
            t2 = time.perf_counter()
            model.iteration_count += 1
            model.listeners.iteration_done(model, model.iteration_count, model.epoch_count,
                                           model.score_value)
            step_ms.append(1e3 * (t2 - t1))
            listen_ms.append(1e3 * (time.perf_counter() - t2))
            scores.append(model.score_value)
            if model.iteration_count == MLM_STATS_EVERY:  # mid-run scrape
                scraped = json.loads(_http(ui.port, "/train/stats?sessionId=bert-mlm",
                                           method="GET")[2])
        model.listeners.epoch_end(model)
        counts = _all_counts()
        status, headers, body = _http(ui.port, "/metrics", method="GET")
        stats = json.loads(_http(ui.port, "/train/stats?sessionId=bert-mlm", method="GET")[2])
        sessions = json.loads(_http(ui.port, "/train/sessions", method="GET")[2])
    finally:
        ui.stop()
        storage.close()
    records = storage.records("bert-mlm")
    stored = [r["score"] for r in records]
    full = [r for r in records if "gradients" in r]
    events = [e for e in json.load(open(trace_path))["traceEvents"] if e["cat"] == "train"]
    shutil.rmtree(tmp, ignore_errors=True)
    check(all(counts[k] == 12 * MLM_STEPS for k in ("flash_forward", "flash_bwd_dq",
                                                     "flash_bwd_dkv")),
          f"every MLM step must launch B1, B2 and B3 once a block: {counts}")
    check(all(np.isfinite(scores)) and scores[-1] < scores[0],
          f"MLM scores must be finite and falling: {scores}")
    check(stats["scores"] == stored == scores and sessions == ["bert-mlm"],
          f"/train/stats scores {stats['scores']} vs the storage's {stored}")
    check(scraped is not None and scraped["scores"] == scores[:MLM_STATS_EVERY],
          "the mid-run /train/stats scrape must hold the first iterations' scores")
    check(status == 200 and headers.get("Content-Type", "").startswith("text/plain"),
          f"/metrics answered {status} {headers.get('Content-Type')}")
    check(len(events) == MLM_STEPS and len(full) == MLM_STEPS // MLM_STATS_EVERY
          and len(full[-1]["gradients"]) == sum(len(p) for p in model.params.values()),
          f"{len(events)} trace iterations, {len(full)} full stat records")
    ratios = stats["update_ratios"].get("tok_emb/W", [])
    ms = float(np.median(step_ms))
    tokens_s = BERT_BATCH * BERT_T / ms * 1e3
    flops_tok = bert_train_flops_per_token(zoo, BERT_T)
    peak = chip_peak_flops(torch.device("cuda", 0), "float32")
    mfu = None if peak is None else flops_tok * tokens_s / peak
    print(f"bert-base mlm from BertIterator ({card}): vocab {len(vocab)} generated, "
          f"{len(sentences)} sentences tokenized in {data_s:.2f} s, {picked:.4f} of positions "
          f"picked for MLM; {MLM_STEPS} GraphSolver.fit_batch steps [{BERT_BATCH},{BERT_T}] "
          f"with key and label masks: median {ms:.2f} ms/step of "
          f"{[round(t, 2) for t in step_ms]} = {tokens_s:.0f} tokens/s; "
          f"{flops_tok / 1e6:.2f} MFLOP/token x tokens/s / chip_peak_flops float32 "
          f"{None if peak is None else peak / 1e12} TFLOP/s = MFU "
          f"{'not measured' if mfu is None else f'{mfu:.4f}'}; listeners ms "
          f"{[round(t, 1) for t in listen_ms]} (full stats every {MLM_STATS_EVERY}); scores "
          f"{[round(s, 5) for s in scores]}; log10 update:param ratio of tok_emb/W "
          f"{[round(r, 3) for r in ratios]}; /metrics {len(body)} bytes; Chrome trace "
          f"{len(events)} iterations; launches {counts}")
    del model, solver
    return counts


def _max_rel_gap(card: np.ndarray, cpu: np.ndarray) -> float:
    return float(np.abs(card - cpu).max() / max(float(np.abs(cpu).max()), 1e-30))


def phase_embeddings(card: str, reference) -> dict:
    """Word2Vec (negative sampling, then hierarchical softmax; 300-wide
    tables over 21,188 words), GloVe and ParagraphVectors (with
    ``infer_vector`` on an unseen document) at the sizes of
    ``tools/embedding_reference.py``, on the card; each table held against
    the same fit on the CPU (the process :func:`start_embedding_reference`
    started) within ``TOL_EMBED_REL`` (hierarchical softmax's tables within
    ``TOL_EMBED_HS_REL``). Returns the launch counts of the
    card's fits (none of B1-B5)."""
    from deeplearning4j_tpu_torch.tools import embedding_reference as er

    fa.reset_launch_counts()
    tables, stats = er.run("cuda", SEED)
    counts = _all_counts()
    proc, path, log = reference
    t0 = time.perf_counter()
    proc.wait(timeout=600)
    wait_s = time.perf_counter() - t0
    with open(log) as f:
        check(proc.returncode == 0, f"the CPU embedding run failed:\n{f.read()[-4000:]}")
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    ref_stats = json.loads(str(ref.pop("stats")))
    gaps = {k: _max_rel_gap(tables[k], ref[k]) for k in sorted(tables)}
    check(set(tables) == set(ref) and all(tables[k].shape == ref[k].shape for k in tables),
          "the card's and the CPU's tables differ in shape")
    for name in ("w2v_ns", "w2v_hs"):
        s = stats[name]
        print(f"word2vec {name[4:]} ({card}): {s['tokens']} Zipf tokens ({er.W2V_TYPES} types),"
              f" vocab {s['vocab']} x {er.W2V['vector_size']} at min_count "
              f"{er.W2V['min_count']}, {s['pairs']} pairs in {s['seconds']:.2f} s = "
              f"{s['pairs'] / s['seconds']:.0f} pairs/s (CPU run {ref_stats[name]['seconds']:.2f}"
              f" s = {s['pairs'] / ref_stats[name]['seconds']:.0f} pairs/s); gaps to the CPU "
              f"syn0 {gaps[name + '_syn0']:.3e} syn1 {gaps[name + '_syn1']:.3e} of the largest "
              f"|value| (tol {TOL_EMBED_HS_REL if name == 'w2v_hs' else TOL_EMBED_REL:g})")
    g, p = stats["glove"], stats["pv"]
    print(f"glove ({card}): {g['tokens']} tokens, vocab {g['vocab']} x 300, {g['epochs']} "
          f"epochs in {g['seconds']:.2f} s (CPU {ref_stats['glove']['seconds']:.2f} s); gap "
          f"{gaps['glove_syn0']:.3e}; paragraph vectors: {p['docs']} docs, vocab {p['vocab']} "
          f"x 300, {p['epochs']} epochs in {p['seconds']:.2f} s (CPU "
          f"{ref_stats['pv']['seconds']:.2f} s); gaps docs {gaps['pv_docs']:.3e} syn1 "
          f"{gaps['pv_syn1']:.3e} infer_vector {gaps['pv_unseen']:.3e} (tol {TOL_EMBED_REL:g});"
          f" waited {wait_s:.1f} s for the CPU run; launches {counts}")
    tol = {k: TOL_EMBED_HS_REL if k.startswith("w2v_hs") else TOL_EMBED_REL for k in gaps}
    bad = [k for k in gaps if gaps[k] > tol[k]]
    check(not bad and all(np.isfinite(t).all() for t in tables.values()),
          f"embedding tables {bad} are {[gaps[k] for k in bad]} from the CPU run")
    return counts


def _params_np(params) -> dict:
    return {l: {k: p.detach().cpu().numpy() for k, p in lp.items()} for l, lp in params.items()}


def _max_param_gap(a, b) -> float:
    return max(float(np.abs(a[l][k] - b[l][k]).max()) for l in a for k in a[l])


def phase_rl(card: str) -> dict:
    """DQN and A3C on CartPole. DQN with the rl4j CartPole example's QLearning
    settings as far as ``QLearningConfiguration`` has fields (seed 123,
    max_epoch_step 200, exp_replay_size 150000, batch 32, target update
    every 500, update_start 10, gamma 0.99, min_epsilon 0.1 over 1000 steps,
    double DQN; 3 hidden dense layers of 16, Adam 5e-4), ``max_step`` cut
    from 150000 to ``DQN_MAX_STEP``; A3C at ``A3CConfiguration()`` (8
    workers, n_step 16, max_step 20000). One DQN ``train_step`` and one A3C
    update on the card are held against the port's CPU result from the same
    params and batch (``TOL_RL_CARD``). Returns the launch counts of the two
    training runs (none of B1-B5)."""
    from deeplearning4j_tpu_torch.model import load_jax_params
    from deeplearning4j_tpu_torch.rl import (A3CConfiguration, A3CDiscreteDense, CartPole,
                                             QLearningConfiguration, QLearningDiscreteDense,
                                             Transition)

    conf = QLearningConfiguration(
        seed=123, max_step=DQN_MAX_STEP, max_epoch_step=200, exp_replay_size=150000,
        batch_size=32, target_dqn_update_freq=500, update_start=10, gamma=0.99,
        min_epsilon=0.1, epsilon_nb_step=1000, double_dqn=True, learning_rate=5e-4,
        hidden=(16, 16, 16))
    gpu = QLearningDiscreteDense(CartPole(max_steps=200, seed=SEED), conf)
    cpu = QLearningDiscreteDense(CartPole(max_steps=200, seed=SEED), conf, device="cpu")
    load_jax_params(cpu.network, _params_np(gpu.network.params))
    cpu.target_params = {l: {k: p.clone() for k, p in lp.items()}
                         for l, lp in cpu.network.params.items()}
    env, rs = CartPole(max_steps=200, seed=SEED + 1), np.random.RandomState(SEED + 2)
    obs = env.reset()
    for _ in range(256):
        action = int(rs.randint(2))
        reply = env.step(action)
        for agent in (gpu, cpu):
            agent.replay.store(Transition(obs, action, reply.reward, reply.observation,
                                          reply.done))
        obs = env.reset() if reply.done else reply.observation
    batch = gpu.replay.sample()
    cpu.replay.sample()
    td_gap = float(np.abs(gpu._td_targets(*batch) - cpu._td_targets(*batch)).max())
    gpu.train_step()
    cpu.train_step()
    step_gap = _max_param_gap(_params_np(gpu.network.params), _params_np(cpu.network.params))

    a3c = A3CDiscreteDense(lambda seeds=iter(range(SEED, SEED + 64)): CartPole(
        seed=next(seeds)), A3CConfiguration())
    a3c_cpu = A3CDiscreteDense(lambda: CartPole(seed=SEED), A3CConfiguration(), device="cpu")
    load_jax_params(a3c_cpu, {k: p.detach().cpu().numpy() for k, p in a3c.params.items()})
    n = a3c.conf.num_threads * a3c.conf.n_step
    obs_b = rs.randn(n, 4).astype(np.float32)
    act_b = rs.randint(0, 2, n).astype(np.int32)
    ret_b = (rs.rand(n) * 20).astype(np.float32)
    a3c._update(a3c._put(obs_b), a3c._put(act_b), a3c._put(ret_b))
    a3c_cpu._update(a3c_cpu._put(obs_b), a3c_cpu._put(act_b), a3c_cpu._put(ret_b))
    a3c_gap = max(float(np.abs(a3c.params[k].detach().cpu().numpy()
                               - a3c_cpu.params[k].detach().numpy()).max()) for k in a3c.params)

    fa.reset_launch_counts()
    dqn = QLearningDiscreteDense(CartPole(max_steps=200, seed=SEED), conf)
    t0 = time.perf_counter()
    rewards = dqn.train()
    dqn_s = time.perf_counter() - t0
    a3c = A3CDiscreteDense(lambda seeds=iter(range(SEED, SEED + 64)): CartPole(
        seed=next(seeds)), A3CConfiguration())
    t0 = time.perf_counter()
    a3c.train()
    a3c_s = time.perf_counter() - t0
    counts = _all_counts()
    finite = all(bool(torch.isfinite(p).all()) for lp in dqn.network.params.values()
                 for p in lp.values()) and all(bool(torch.isfinite(p).all())
                                               for p in a3c.params.values())
    ep = a3c.episode_rewards

    def mean(xs):
        return round(float(np.mean(xs)), 2) if xs else None

    print(f"dqn cartpole ({card}): rl4j example settings, 3 x 16 hidden, Adam(5e-4), max_step "
          f"{DQN_MAX_STEP} (rl4j: 150000): {len(rewards)} episodes in {dqn_s:.2f} s = "
          f"{DQN_MAX_STEP / dqn_s:.0f} steps/s, rewards first 10 mean {mean(rewards[:10])}, "
          f"last 10 mean {mean(rewards[-10:])}, best {max(rewards)}; card vs CPU TD targets "
          f"{td_gap:.3e}, params after one train_step {step_gap:.3e} (tol {TOL_RL_CARD:g})")
    print(f"a3c cartpole ({card}): A3CConfiguration() {a3c.conf.num_threads} workers, n_step "
          f"{a3c.conf.n_step}, max_step {a3c.conf.max_step}: {len(ep)} episodes in "
          f"{a3c_s:.2f} s = {a3c.conf.max_step / a3c_s:.0f} steps/s, rewards first 20 mean "
          f"{mean(ep[:20])}, last 20 mean {mean(ep[-20:])}; card vs CPU params after one "
          f"update on [{n}, 4] {a3c_gap:.3e} (tol {TOL_RL_CARD:g}); launches {counts}")
    check(max(td_gap, step_gap, a3c_gap) <= TOL_RL_CARD, "DQN or A3C on the card disagrees "
          f"with the CPU: {td_gap:.3e}, {step_gap:.3e}, {a3c_gap:.3e}")
    check(finite and rewards and ep, "DQN/A3C params must stay finite over episodes")
    return counts


class _FailingCandidate:
    """The random candidates, then one whose model factory raises."""

    def __init__(self, gen) -> None:
        self.gen = gen

    def __iter__(self):
        yield from self.gen
        yield {"learning_rate": 1e-3, "fail": True}


def phase_arbiter(card: str) -> dict:
    """Arbiter random search over the zoo ``LeNet``'s learning rate
    (log-uniform in [1e-4, 1e-1]), ``ARBITER_CANDIDATES`` candidates plus
    one whose factory raises; each trains ``ARBITER_BATCHES`` batches from
    ``MnistDataSetIterator(64)`` and is scored by ``evaluate`` accuracy on
    1024 test digits. Returns the launch counts of the search (none)."""
    from deeplearning4j_tpu_torch.arbiter import (ContinuousParameterSpace,
                                                  LocalOptimizationRunner,
                                                  OptimizationConfiguration,
                                                  RandomSearchGenerator)
    from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator

    test = MnistDataSetIterator(256, train=False, num_examples=1024)

    def factory(hp):
        if hp.get("fail"):
            raise RuntimeError("planted failure: this candidate's factory raises")
        net = LeNet(seed=SEED, updater=Adam(hp["learning_rate"])).init()
        net.fit(MnistDataSetIterator(LENET_BATCH, num_examples=LENET_BATCH * ARBITER_BATCHES))
        return net

    def score(net, hp):
        test.reset()
        return net.evaluate(test).accuracy()

    gen = RandomSearchGenerator({"learning_rate": ContinuousParameterSpace(
        1e-4, 1e-1, log_scale=True)}, num_candidates=ARBITER_CANDIDATES, seed=SEED)
    runner = LocalOptimizationRunner(OptimizationConfiguration(
        candidate_generator=_FailingCandidate(gen), model_factory=factory,
        score_function=score, minimize=False))
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    best = runner.execute()
    wall = time.perf_counter() - t0
    counts = _all_counts()
    res = runner.results
    ok = [r for r in res if r.error is None]
    print(f"arbiter lenet ({card}): {len(res)} candidates in {wall:.2f} s: "
          + "; ".join(f"lr {r.hyperparameters['learning_rate']:.3e} "
                      + (f"accuracy {r.score:.4f}" if r.error is None else f"ERROR {r.error}")
                      + f" in {r.duration_s:.2f} s" for r in res)
          + f"; best lr {best.hyperparameters['learning_rate']:.3e} accuracy {best.score:.4f};"
          f" launches {counts}")
    check(len(res) == ARBITER_CANDIDATES + 1 and len(ok) == ARBITER_CANDIDATES
          and "planted" in (res[-1].error or ""), "the failing candidate must not end the search")
    check(best.error is None and best.score == max(r.score for r in ok),
          f"best_result() {best.score} is not the best score")
    check(all(r.duration_s > 0 for r in res), "every candidate must be timed")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    card = phase_device()
    name = torch.cuda.get_device_name(0)
    build = start_build()
    ref_dir = tempfile.mkdtemp(prefix="embedding_reference_")
    reference = []  # _main starts it once the kernels are built
    try:
        return _main(card, name, reference, build, ref_dir)
    finally:
        for proc, _, _ in reference:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ref_dir, ignore_errors=True)


def _main(card: str, name: str, reference: list, build, ref_dir: str) -> int:
    gen = torch.Generator().manual_seed(SEED)
    rs = np.random.RandomState(SEED + 1)
    prompt_lens = [100, 500] + rs.randint(100, 501, B - 2).tolist()
    prompts = [rs.randint(0, 50257, n).tolist() for n in prompt_lens]
    t0 = time.perf_counter()

    def timed(label, fn, *args):
        out = fn(*args)
        print(f"phase {label} done at {time.perf_counter() - t0:.1f} s")
        return out

    # the phases that launch none of B1-B5 run while nvcc builds them (a
    # phase that did launch one would wait for the build)
    paths = [timed("LeNet", phase_lenet, card), timed("ResNet-50", phase_resnet50, card),
             timed("TextGenerationLSTM", phase_char_rnn, card),
             timed("LeNet from MnistDataSetIterator", phase_lenet_iterator, card),
             timed("ResNet-50 from files", phase_resnet_files, card)]
    imported, counts = timed("SameDiff TF-imported BERT-base", phase_samediff_bert, card)
    paths += [counts, timed("SameDiff BERT-base fine-tune", phase_samediff_finetune, card,
                            imported)]
    del imported
    imported, counts = timed("Keras ResNet-50", phase_keras_resnet50, card)
    paths += [counts, timed("Keras ResNet-50 fine-tune", phase_keras_finetune, card, imported)]
    del imported
    paths += [timed("ONNX BERT-base", phase_onnx_bert, card),
              timed("ResNet-50 inference rewrite", phase_resnet_rewrite, card),
              timed("calibrated int8 Dense", phase_calibrated_dense, card),
              timed("zoo", phase_zoo, card), timed("DQN and A3C on CartPole", phase_rl, card),
              timed("arbiter random search over LeNet", phase_arbiter, card)]
    timed("kernel build", phase_build, build)
    # the embedding phase's CPU reference: after the build, whose nvcc
    # processes would otherwise share the host's cores with it
    reference.append(start_embedding_reference(ref_dir))
    timed("SASS", phase_sass, build)
    fwd = timed("B1", phase_flash_forward, gen)
    dec = timed("B4", phase_flash_decode, gen, [n + MAX_TOKENS // 2 for n in prompt_lens])
    bwd = timed("B2/B3", phase_flash_backward, gen)
    timed("new instantiations", phase_new_instantiations, gen)
    serving, model = timed("LM serving", phase_model, prompts)
    engine, static_streams = timed("LM engine", phase_engine, model, prompts, card)
    paths += [serving, engine,
             timed("HTTP serving", phase_http, model, prompts, static_streams, card),
             timed("contract harnesses", phase_contracts, model, card),
             timed("int8 LM serving", phase_quant_lm, model, prompts, card)]
    del model
    timed("device sampler", phase_sampler)
    paths.append(timed("LM training", phase_train, card))
    moe, routed = timed("MoE network", phase_moe, card)
    paths.append(moe)
    gmm = timed("B5", phase_grouped_matmul, gen, routed)
    paths += [timed("head-dim-256 LM", phase_lm_head256),
              timed("float16 LM", phase_lm_f16, prompts),
              timed("float64 LM", phase_lm_f64), timed("float64 MoE layer", phase_moe_f64),
              timed("BERT-base encoder", phase_bert, card),
              timed("LearnedSelfAttention", phase_learned_attention, card),
              timed("gradient checkpointing and bf16 compute_dtype LM", phase_remat_and_bf16,
                    card),
              timed("bf16 compute_dtype generation", phase_bf16_generation, prompts, card),
              timed("SameDiff multi-head attention", phase_samediff_attention, card),
              timed("int8 MoE", phase_quant_moe, card)]
    ft, ft_finish = timed("fault-tolerant LM training", phase_fault_tolerant_lm, card)
    paths += [ft, timed("elastic restart", phase_elastic, card)]
    timed("fault-tolerant LM checkpoint writes", ft_finish)
    paths += [timed("early stopping LM", phase_early_stopping_lm, card),
              timed("step profiler", phase_step_profiler, card)]
    dp1, world1 = timed("data-parallel LM, world 1", phase_dp_world1, card)
    paths += [dp1, timed("data-parallel LM, 2 ranks on one card", phase_dp_two_ranks, card,
                         world1)]
    paths += [timed("ResNet-50 gradient sharing, 2 ranks", phase_dp_resnet50, card),
              timed("elastic resize", phase_dp_elastic_resize, card),
              timed("pipeline-parallel LM, 2 stages", phase_pp_lm, card, world1)]
    paths += [timed("pipeline x data, 4 ranks", phase_pp_dp_f64, card),
              timed("ring and Ulysses attention, 2 ranks", phase_sequence, card),
              timed("tensor-parallel LM, 2 ranks", phase_tp_lm, card, world1),
              timed("expert-parallel MoE, 2 ranks", phase_ep_moe, card),
              timed("tensor and expert parallel x data, 4 ranks, float64", phase_tpep_f64,
                    card)]
    del world1
    paths += [timed("BERT-base MLM from BertIterator, UI watching", phase_bert_mlm, card),
              timed("Word2Vec, GloVe and ParagraphVectors", phase_embeddings, card, reference[0])]
    # launches over the paths. First the phases that run while the kernels
    # build and launch none of the five: LeNet and ResNet-50, the char-RNN,
    # LeNet and ResNet-50 fed by iterators, the SameDiff TF-imported
    # BERT-base served and fine-tuned, the Keras ResNet-50 served and
    # fine-tuned, the ONNX BERT-base, the ResNet-50 rewrites, the calibrated
    # LeNet, the zoo, DQN, A3C and the arbiter's LeNets. Then LM serving, the
    # engines, HTTP serving, the contract harnesses (B1 on /v1/serving, B4
    # in the graphed decode steps) and the int8 and fp8 LM (B1, B4);
    # training, the MoE network, the head-dim-256, float16, float64 and
    # float64-MoE paths, BERT-base, the LearnedSelfAttention network, the
    # checkpointed and bf16 LMs, the bf16 LM's generation, the SameDiff
    # attention op and the int8 MoE network (B1, B5); then fault-tolerant
    # training: the checkpointed and resumed LM, the elastic restart's
    # children (counted in their own processes), early stopping and the
    # profiled steps (B1-B3); then data-parallel training: the world-1
    # trainer, the two ranks' legs and the elastic resize's ranks (B1-B3,
    # counted in their processes) and the ResNet-50 ranks (none); then
    # pipeline and sequence parallelism: the two stages' steps under both
    # schedules, the float64 pipe x data trainers' steps, and the ring and
    # Ulysses runs (B1-B3, counted in the ranks' processes); then tensor and
    # expert parallelism: the Megatron-split LM's steps (B1-B3 on 6 heads),
    # the expert-parallel MoE network's (B1-B3, B5 over 4 experts) and the
    # float64 legs' (counted in the ranks' processes); then BERT-base's MLM
    # steps from BertIterator (B1-B3) and the embedding trainers (none)
    launches = {n: sum(p.get(n, 0) for p in paths) for n in moe}
    src = "deeplearning4j_tpu_torch/csrc/"
    kernels = [
        dict(name="flash_forward", route="cuda", source=src + "flash_forward.cu",
             replaces="deeplearning4j_tpu/ops/flash_attention.py:108", **fwd),
        dict(name="flash_bwd_dq", route="cuda", source=src + "flash_backward.cu",
             replaces="deeplearning4j_tpu/ops/flash_attention.py:366", **bwd["flash_bwd_dq"]),
        dict(name="flash_bwd_dkv", route="cuda", source=src + "flash_backward.cu",
             replaces="deeplearning4j_tpu/ops/flash_attention.py:420", **bwd["flash_bwd_dkv"]),
        dict(name="flash_decode", route="cuda", source=src + "flash_decode.cu",
             replaces="deeplearning4j_tpu/ops/flash_attention.py:697", **dec),
        dict(name="grouped_matmul", route="cuda", source=src + "grouped_matmul.cu",
             replaces="deeplearning4j_tpu/ops/grouped_matmul.py:144", **gmm),
    ]
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
        check(kern["launches"] > 0, f"{kern['name']} was not launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
