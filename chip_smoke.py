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
checks the device sampler against the CPU's and a softmax, trains one with
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
float64 MoE layer through B5. It times each kernel at its main path's
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

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time

import importlib

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.generate import GenerationSession
from deeplearning4j_tpu_torch.model.zoo import TransformerLM
from deeplearning4j_tpu_torch import ops as fa
from deeplearning4j_tpu_torch.nn import (Activation, InputType, LossFunction,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import MixtureOfExpertsLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.tools import kernel_variants as kv
from deeplearning4j_tpu_torch.tools.moe_profile import MOE_LAYER, moe_lm_conf
from deeplearning4j_tpu_torch.train import Solver

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
# The device sampler's chi-square against the softmax over a small fixed
# vocabulary (8 tokens, 7 degrees of freedom): 24.32 is its 0.999 quantile.
CHI2_DF7_999 = 24.32


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


def phase_build() -> None:
    """Builds every kernel source and prints each instantiation's ptxas
    registers, spills and static shared memory."""
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
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
    built from ``csrc/<stem>.cu``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = cuda_build._lib_path(cuda_build.CSRC / f"{stem}.cu")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HMMA": 0, "atomics": 0}
        elif fn is not None:
            counts[fn]["HMMA"] += "HMMA" in line
            counts[fn]["atomics"] += bool(re.search(r"\b(ATOMG?|ATOMS|RED)\b", line))
    for fn, c in counts.items():
        print(f"  sass {stem} {fn}: {c['HMMA']} HMMA, {c['atomics']} atomics")
    return counts


def phase_sass() -> None:
    """The flash forward and backward kernels and B5's tensor-core kernels
    run their products on the tensor cores, and no kernel has
    atomics: counted per function (each instantiation) in the built
    libraries' SASS. Instantiations: B2/B3 and B1 at 3 dtypes x 4 widths
    (DMAX 32 to 256), B4 at 3 x 4 x 2 load paths, the float64 B1-B4 at 4
    widths each; B5's tensor-core kernel in bf16, f16 and float32 (3xTF32,
    timed beside the path's kernel), its float32 CUDA-core kernel (2 load
    paths) and its float64 one."""
    bwd = _sass_counts("flash_backward")
    check(len(bwd) == 24 and all(c["HMMA"] > 0 and c["atomics"] == 0 for c in bwd.values()),
          "every backward kernel must run HMMA and no atomics")
    fwd = _sass_counts("flash_forward")
    check(len(fwd) == 12 and all(c["HMMA"] > 0 and c["atomics"] == 0 for c in fwd.values()),
          "every forward kernel must run HMMA and no atomics")
    dec = _sass_counts("flash_decode")
    check(len(dec) == 24 and all(c["atomics"] == 0 for c in dec.values()),
          "the decode kernels must have no atomics")
    f64 = _sass_counts("flash_f64")
    check(len(f64) == 16 and all(c["atomics"] == 0 for c in f64.values()),
          "the float64 attention kernels must have no atomics")
    gmm = _sass_counts("grouped_matmul")
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
            torch.cuda.synchronize()
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


def _teacher_forced(model, prompts, streams) -> list:
    """Per request, the log-probs [len(stream), V] a full ``output()`` over
    ``prompt + stream[:-1]`` gives at the positions that produced the
    stream's tokens."""
    seqs = [p + s[:-1] for p, s in zip(prompts, streams)]
    ids = np.zeros((len(seqs), max(len(s) for s in seqs)), np.int32)
    mask = np.zeros(ids.shape, np.float32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1.0
    full = model.output(ids, mask)  # [b, V, t]
    out = [torch.log(torch.clamp_min(full[i, :, len(p) - 1: len(p) - 1 + len(s)], 1e-30)).T
           for i, (p, s) in enumerate(zip(prompts, streams))]
    del full
    return out


def _greedy_gap(model, prompts, streams) -> float:
    """The largest distance of a generated token's log-prob below the
    maximum at its position, teacher-forced: 0 for an exact greedy stream,
    up to the decode path's rounding where two tokens nearly tie."""
    gap = 0.0
    for lp, s in zip(_teacher_forced(model, prompts, streams), streams):
        tok = torch.tensor(s, device=lp.device)[:, None]
        gap = max(gap, float((lp.max(dim=1).values - lp.gather(1, tok)[:, 0]).max()))
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
    launch counts of the counted runs."""
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
    return total


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    card = phase_device()
    name = torch.cuda.get_device_name(0)
    phase_build()
    phase_sass()
    gen = torch.Generator().manual_seed(SEED)
    rs = np.random.RandomState(SEED + 1)
    prompt_lens = [100, 500] + rs.randint(100, 501, B - 2).tolist()
    prompts = [rs.randint(0, 50257, n).tolist() for n in prompt_lens]
    t0 = time.perf_counter()

    def timed(label, fn, *args):
        out = fn(*args)
        print(f"phase {label} done at {time.perf_counter() - t0:.1f} s")
        return out

    fwd = timed("B1", phase_flash_forward, gen)
    dec = timed("B4", phase_flash_decode, gen, [n + MAX_TOKENS // 2 for n in prompt_lens])
    bwd = timed("B2/B3", phase_flash_backward, gen)
    timed("new instantiations", phase_new_instantiations, gen)
    serving, model = timed("LM serving", phase_model, prompts)
    paths = [serving, timed("LM engine", phase_engine, model, prompts, card)]
    del model
    timed("device sampler", phase_sampler)
    paths.append(timed("LM training", phase_train, card))
    moe, routed = timed("MoE network", phase_moe, card)
    paths.append(moe)
    gmm = timed("B5", phase_grouped_matmul, gen, routed)
    paths += [timed("head-dim-256 LM", phase_lm_head256),
              timed("float16 LM", phase_lm_f16, prompts),
              timed("float64 LM", phase_lm_f64), timed("float64 MoE layer", phase_moe_f64)]
    # launches over the paths: LM serving, the engines and training, the MoE
    # network, and the head-dim-256, float16, float64 and float64-MoE paths
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
