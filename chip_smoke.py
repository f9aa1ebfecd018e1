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
``GenerationSession.generate`` on 8 ragged prompts, trains one with
``Solver.fit_batch`` (Adam 1e-4) on 8 x 1024 tokens, and runs ``output()``
and ``Solver.fit_batch`` on the MoE network of
``tools/moe_profile.py::moe_lm_conf`` (one such block, then 8 experts of
hidden 1536, top-2, capacity factor 1.25, through B5). Each path runs with
the launch counts set to 0 just before it and read just after. It checks
those counts, the cached decode's log-probs against a full forward, the
training scores, the kernel-path gradients against the materialised-scores
reference, and the MoE network's outputs and gradients against its sort
dispatch (``torch.bmm`` over capacity slots); it counts HMMA and atomic
instructions in the attention kernels' SASS. It times each kernel at its
main path's shape: B1, B2 and B3 in three rounds paired with SDPA's
forward or backward, and B4 by device time (200 calls replayed from one
CUDA graph), with the host's time to issue a call printed apart. Then it
prints the timings, a ``kernels`` JSON line, and last ``{"ok": true,
"device": {...}}``.

Any failed check raises and the script exits non-zero. Without a CUDA
device it exits with 2 and prints no result.
"""

from __future__ import annotations

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
PEAK_FLOPS = {torch.float32: TF32_FLOPS / 3, torch.bfloat16: 989e12}
# Kernel vs plain version, max abs error allowed. float32: both sides
# compute in float32 and differ only in summation order. bfloat16: both
# widen the same bf16 inputs to float32, so they differ by the rounding of
# the bf16 output, one ulp at |out| < 4 (2^-6); lse stays float32.
TOL_OUT = {torch.float32: 5e-5, torch.bfloat16: 1.6e-2}
TOL_LSE = 1e-4
# Backward kernels vs plain versions, max abs error over the largest |value|
# of the plain gradient. float32: both sum up to t = 1024 terms in float32,
# in another order, the kernels of 3xTF32 products exact to ~2^-21.
# bfloat16: both round float32 sums to bf16, so they may differ by one bf16
# ulp at the largest value (2^-7 of it).
TOL_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7 + 1e-4}
# Model gradients through the kernels vs through materialised scores and
# plain autograd, per parameter, max abs error over the parameter's largest
# |gradient|. Both run in float32; the attention sums differ in order in each
# of 12 layers, which moves gradients by ~1e-5 of their scale. A gradient that
# skipped attention (no backward through the kernel) misses by ~1.
TOL_GRAD_REL = 1e-3
TRAIN_STEPS = 5
# B5 vs its plain version, max abs error over the largest |value| of the
# plain output. float32: both sum the same d float32 products, in another
# order. bfloat16: both sum the exact products of bf16 inputs in float32 and
# round once to bf16, so they may differ by one bf16 ulp (2^-7 of the
# largest value).
TOL_GMM_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7 + 1e-4}
# The MoE layer's widths (the JAX package's MoE dispatch benchmark) and its
# capacity at 8 x 1024 tokens: ceil(2 * 8192 / 8 * 1.25) = 2560 = m_pad.
E_MOE, H_MOE, TOPK, CAPACITY = 8, 1536, 2, 2560
# Cached decode vs full forward, max abs error of the log-probs. Both run in
# float32 through different kernels and matrix shapes; float32 rounding
# moves log-probs near -10.8 by ~1e-5. A bfloat16 model would miss this by
# an order of magnitude: one bf16 rounding of an activation is ~4e-3 relative.
TOL_LOGPROB = 2e-3


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
    return float((a.float() - b.float()).abs().max())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


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


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for stem, log in sorted(cuda_build.build_logs.items()):
        for line in log.splitlines():
            if "Compiling entry function" in line:  # the mangled kernel name
                print(f"  ptxas {stem}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {stem}:   {line.strip()}")


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
    """The flash forward and backward kernels run their products on the
    tensor cores, and no attention kernel has atomics: counted per function
    (each instantiation) in the built libraries' SASS."""
    bwd = _sass_counts("flash_backward")
    check(len(bwd) == 12 and all(c["HMMA"] > 0 and c["atomics"] == 0 for c in bwd.values()),
          "every backward kernel must run HMMA and no atomics")
    fwd = _sass_counts("flash_forward")
    check(len(fwd) == 6 and all(c["HMMA"] > 0 and c["atomics"] == 0 for c in fwd.values()),
          "every forward kernel must run HMMA and no atomics")
    dec = _sass_counts("flash_decode")
    check(len(dec) == 12 and all(c["atomics"] == 0 for c in dec.values()),
          "the decode kernels must have no atomics")


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
                  f"lse max_abs={e_lse:.3e} (tol {TOL_LSE:g})")
            check(e_out <= TOL_OUT[dtype] and e_lse <= TOL_LSE,
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
    return counts


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
    worst = (0.0, "")
    grads = model.calculate_gradients(ids, labels)
    fa.set_attention_impl("reference")
    try:
        ref = model.calculate_gradients(ids, labels)
    finally:
        fa.set_attention_impl("auto")
    for lname, lg in ref.items():
        for pname, r in lg.items():
            e = rel_err(grads[lname][pname], r)
            check(float(grads[lname][pname].abs().max()) > 0 or float(r.abs().max()) == 0,
                  f"{lname}.{pname} has no gradient through the kernels")
            worst = max(worst, (e, f"{lname}.{pname}"))
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
    with torch.inference_mode():  # the masked path's state
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
    worst = (0.0, "")
    for lname, lg in ref.items():
        for pname, r in lg.items():
            g = grads[lname][pname]
            check(float(g.abs().max()) > 0 or float(r.abs().max()) == 0,
                  f"{lname}.{pname} has no gradient through grouped dispatch")
            worst = max(worst, (rel_err(g, r), f"{lname}.{pname}"))
    print(f"moe grouped vs sort dispatch (ragged mask): output rel error {e_out:.3e} "
          f"(tol {TOL_BWD_REL[torch.float32]:g}); gradients worst rel error {worst[0]:.3e} "
          f"at {worst[1]} (tol {TOL_GRAD_REL:g})")
    check(e_out <= TOL_BWD_REL[torch.float32], "grouped-dispatch outputs disagree with sort")
    check(worst[0] <= TOL_GRAD_REL, "grouped-dispatch gradients disagree with sort")
    del sort_model, grads, ref
    return {n: serve[n] + train[n] for n in serve}, routed


def _kept_rows(sizes, m_pad: int, n: int) -> torch.Tensor:
    """[n] bool: the rows some group keeps (local index < m_pad, row < n)."""
    kept = torch.zeros(n, dtype=torch.bool)
    start = 0
    for s_ in sizes:
        kept[start: min(start + min(s_, m_pad), n)] = True
        start += s_
    return kept


def phase_grouped_matmul(gen, routed) -> dict:
    """B5 against its plain version at ragged shapes and at the MoE layer's
    two products, then timed at the first, ``[16384, 768] x [8, 768,
    1536]`` with ``m_pad`` 2560, with the row counts the network routed."""
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
    for dtype in (torch.float32, torch.bfloat16):
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
            torch.cuda.synchronize()
            m_pad = gm_mod._tiling(n, mg, 128)[0]
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

    # timing at the main path's first product
    n, d, h = n_rows, 768, H_MOE
    gs = torch.tensor(routed, dtype=torch.int32).cuda()
    kept = sum(min(s_, CAPACITY) for s_ in routed)
    lhs32 = torch.randn(n, d, generator=gen).cuda()
    rhs32 = (torch.randn(E_MOE, d, h, generator=gen) * d ** -0.5).cuda()
    row = {"max_abs_err": worst}
    for dtype in (torch.float32, torch.bfloat16):
        lhs, rhs = lhs32.to(dtype), rhs32.to(dtype)
        ms = kv.ms(lambda: fa.grouped_matmul(lhs, gs, rhs, max_group_size=CAPACITY), 20)
        plain_ms = kv.ms(lambda: fa.grouped_matmul_plain(lhs, gs, rhs,
                                                           max_group_size=CAPACITY), 5)
        buf = gm_mod._to_groups(lhs, gs, CAPACITY)  # [8, 2560, 768], zero-padded
        lib_ms = kv.ms(lambda: torch.bmm(buf, rhs), 20)
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
                extra = f", torch._grouped_mm not run ({type(exc).__name__}: {str(exc)[:120]})"
        print(f"grouped_matmul {str(dtype)[6:]} [{n},{d}]x[{E_MOE},{d},{h}] m_pad={CAPACITY}, "
              f"{kept} kept rows {routed}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"padded torch.bmm {lib_ms:.4f} ms{extra}, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB{cuda_core_note(flops, dtype)})")
        if dtype == torch.float32:
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
    fwd = phase_flash_forward(gen)
    dec = phase_flash_decode(gen, [n + MAX_TOKENS // 2 for n in prompt_lens])
    bwd = phase_flash_backward(gen)
    serve = phase_model(prompts)
    train = phase_train(card)
    moe, routed = phase_moe(card)
    gmm = phase_grouped_matmul(gen, routed)
    # launches over the main paths: serving, training, then the MoE network
    launches = {n: serve.get(n, 0) + train.get(n, 0) + moe[n] for n in moe}
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
