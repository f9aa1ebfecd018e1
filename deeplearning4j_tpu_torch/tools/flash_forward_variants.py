"""Design alternatives of the flash forward kernel (B1) and the decode kernel
(B4), timed against the kernels as they are.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.flash_forward_variants [variant ...] [--dtypes float32,...] [--no-decode]

Builds ``csrc/flash_forward.cu`` and ``csrc/flash_decode.cu`` as they are
and with each variant in :data:`FORWARD_VARIANTS` and
:data:`DECODE_VARIANTS` (text substitutions, see :mod:`.kernel_variants`;
those named on the command line, or all), all at once. Then B1's builds
are timed at the serving and training shape ([8, 12, 1024, 64], causal) in
float32, bfloat16 and float16 (or the ``--dtypes`` named), and at head dim
256 ([1, 8, 2048, 256], causal) in bfloat16, in turn, three rounds, by
CUDA events, SDPA's forward timed in the same rounds (the variants named
"(f32 ...)" change the float32 3xTF32 wgmma kernel, "f32 on mma.sync"
brings back the mma.sync design it replaced, the others act on the
bf16/f16 wgmma kernel); each line says whether the build's output equals
the source's as it is bit for bit. B4's builds are timed at the serving
shape (q [8, 12, 1, 64] against a [8, 12, 1024, 64] cache at positions
132-532, four caches in turn) and at one (b, h) pair of rows against a 4096-long cache, in float32,
three rounds, by device time (200 calls replayed from one CUDA graph).
Each prints its medians with its error against the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.tools import kernel_variants as kv

# the module (ops/__init__ exports a function of this name)
fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

B, H, T, D, ROUNDS = 8, 12, 1024, 64, 3
WIDE = (1, 8, 2048, 256)  # chip_smoke.py's head-dim-256 shape, timed in bf16
DECODE_POS = [132, 532, 230, 410, 378, 310, 299, 450]  # mid-generation, as chip_smoke.py's
LONG_L = 4096

_LO_SPLIT = "    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;"
_LO_MASKED = "    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;"

#: name: [(text in the source, its replacement), ...]
FORWARD_VARIANTS = {
    # the float32 kernel: the mma.sync design the 3xTF32 wgmma kernel
    # replaced (32-key tiles, cp.async), and the wgmma kernel's alternatives
    "f32 on mma.sync": [("constexpr bool kTf32Wgmma = true;", "constexpr bool kTf32Wgmma = false;")],
    "(f32 without the overlap)": [("constexpr bool kTf32Overlap = true;", "constexpr bool kTf32Overlap = false;")],
    # (the overlapped round at 64 keys crashes ptxas 12.9)
    "(f32 64-key walk, no overlap)": [
        ("constexpr bool kTf32Overlap = true;", "constexpr bool kTf32Overlap = false;"),
        ("constexpr int kTf32Keys = 32;", "constexpr int kTf32Keys = 64;")],
    "(f32 no overlap, two raw stages)": [
        ("constexpr bool kTf32Overlap = true;", "constexpr bool kTf32Overlap = false;"),
        ("constexpr int kTf32Stages = 1;", "constexpr int kTf32Stages = 2;")],
    # lo's 13 low bits cleared as well: bit-equal output shows that wgmma
    # drops them as mma.sync does
    "(f32 lo rounded in full)": [(_LO_SPLIT, _LO_MASKED)],
    "(f32 three blocks an SM)": [("constexpr int kTf32MinBlocks = 2;", "constexpr int kTf32MinBlocks = 3;")],
    "(f32 q from shared memory)": [("constexpr bool kTf32QRegs = true;", "constexpr bool kTf32QRegs = false;")],
    # diagnostics (wrong output): what binds the float32 wgmma kernel
    "(f32 diagnostic: no k/v split)": [
        ("    split_tile<NT, BN, W, true, false, false>(tid, Raw + j % ST * 2 * KT, 1.f, kt, kt + KT,\n                                              nullptr, nullptr);\n", ""),
        ("    split_tile<NT, BN, W, false, true, false>(tid, Raw + j % ST * 2 * KT + KT, 1.f, nullptr,\n                                              nullptr, vt, vt + KT);\n", "")],
    "(f32 diagnostic: s in one term)": [
        ("        wgmma_tf32(s, qa_lo[kd], desc_at(kh, ak), kd > 0);\n        wgmma_tf32(s, qa_hi[kd], desc_at(kl, ak), 1);\n        wgmma_tf32(s, qa_hi[kd], desc_at(kh, ak), 1);",
         "        wgmma_tf32(s, qa_hi[kd], desc_at(kh, ak), kd > 0);")],
    "(f32 split unrolled by 2)": [("#pragma unroll\n  for (int it = 0; it < R * W / 4 / NT; ++it) {",
                                   "#pragma unroll 2\n  for (int it = 0; it < R * W / 4 / NT; ++it) {")],
    "16-bit on mma.sync": [("constexpr bool kWgmma = true;",
                                   "constexpr bool kWgmma = false;")],
    "d 256 on mma.sync": [("constexpr int kWgmmaMaxD = 256;", "constexpr int kWgmmaMaxD = 128;")],
    "p·v under the softmax": [("constexpr bool kWgOverlap = false;",
                               "constexpr bool kWgOverlap = true;")],
    "no occupancy floor": [("constexpr int kWgMinBlocks = 4 / kWgGroups;",
                            "constexpr int kWgMinBlocks = 1;")],
    "128-key tiles, no floor": [("constexpr int kWgKeys = 64;", "constexpr int kWgKeys = 128;"),
                                ("constexpr int kWgMinBlocks = 4 / kWgGroups;",
                                 "constexpr int kWgMinBlocks = 1;")],
    "128 q rows, 2 warpgroups": [("constexpr int kWgGroups = 1;", "constexpr int kWgGroups = 2;")],
    "mask test on every tile": [("int n_full = mask != nullptr || !(s_mul > 0.f) ? 0 : tk / BN;",
                                 "int n_full = 0;")],
    # p in one bf16/f16 term: its error is printed beside its time; not shipped
    "one-term p (not shipped)": [("      wgmma_rs<1>(acc, a_lo[kk], bv, 1, T());\n", "")],
}
DECODE_VARIANTS = {
    "1 block an SM": [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 1;")],
    "4 blocks an SM": [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 4;")],
    "no split (S = 1)": [("constexpr int kMaxSplit = 8;", "constexpr int kMaxSplit = 1;")],
    "2 keys in flight a lane group": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "4 warps a block": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
}

_P, _I = ctypes.c_void_p, ctypes.c_int
FORWARD_SYMBOLS = {"dl4j_flash_forward": [_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]}
DECODE_SYMBOLS = {"dl4j_flash_decode": [_P] * 5 + [_I] * 5 + [ctypes.c_float, _I, _P]}


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _median(xs) -> float:
    return float(np.median(xs))


def forward(libs, dtypes) -> None:
    gen = torch.Generator().manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = [((B, H, T, D), dtype) for dtype in dtypes]
    if torch.bfloat16 in dtypes:
        shapes.append((WIDE, torch.bfloat16))
    for (B_, H_, T_, D_), dtype in shapes:
        q, k, v = (torch.randn(B_, H_, T_, D_, generator=gen).to("cuda", dtype)
                   for _ in range(3))
        ref, ref_lse = fa.flash_attention_plain(q, k, v, None, True)
        out = torch.empty_like(q)
        lse = torch.empty((B_, H_, T_), device="cuda")
        code = fa._KERNEL_DTYPES[dtype]
        calls, first = {}, None
        for name, lib in libs.items():
            def run(lib=lib):
                return lib.dl4j_flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                              out.data_ptr(), lse.data_ptr(), B_, H_, T_, T_, D_,
                                              D_, D_ ** -0.5, 1, 0, code, stream)
            if run():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            if first is None:
                first = (out.clone(), lse.clone())
            same = torch.equal(out, first[0]) and torch.equal(lse, first[1])
            calls[name] = (run, _err(out, ref), _err(lse, ref_lse), same)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
        times = {name: [] for name in (*calls, "sdpa")}
        for _ in range(ROUNDS):  # every build in turn, so the comparison is paired
            for name, (run, *_rest) in calls.items():
                times[name].append(kv.ms(run))
            times["sdpa"].append(kv.ms(sdpa))
        for name, (_, e_out, e_lse, same) in calls.items():
            print(f"B1 {str(dtype)[6:]:8s} [{B_},{H_},{T_},{D_}] {name:28s} "
                  f"{_median(times[name]):.4f} ms (rounds {[round(x, 4) for x in times[name]]}); "
                  f"max abs error out {e_out:.2e}, lse {e_lse:.2e}; bit-equal to as it is: {same}")
        print(f"B1 {str(dtype)[6:]:8s} [{B_},{H_},{T_},{D_}] {'sdpa forward':28s} "
              f"{_median(times['sdpa']):.4f} ms (rounds {[round(x, 4) for x in times['sdpa']]})")


def decode(libs) -> None:
    gen = torch.Generator().manual_seed(2)
    shapes = {
        "serving [8,12,1,64] vs L=1024": (B, H, T, DECODE_POS, 4),
        f"one row pair [1,2,1,64] vs L={LONG_L}": (1, 2, LONG_L, [LONG_L - 1], 1),
    }
    for label, (b, h, L, positions, n_caches) in shapes.items():
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        q = torch.randn(b, h, 1, D, generator=gen).cuda()
        caches = [tuple(torch.randn(b, h, L, D, generator=gen).cuda() for _ in range(2))
                  for _ in range(n_caches)]
        out = torch.empty((b, h, 1, D), device="cuda")
        calls = {}
        for name, lib in libs.items():
            turn = iter(range(1 << 30))

            def run(lib=lib, turn=turn):  # the stream read at the call: graph capture
                kk, vv = caches[next(turn) % n_caches]
                return lib.dl4j_flash_decode(q.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                                             pos.data_ptr(), out.data_ptr(), b, h, L, D, D,
                                             D ** -0.5, 0, torch.cuda.current_stream().cuda_stream)
            errs = []
            for kk, vv in caches:
                if lib.dl4j_flash_decode(q.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                                         pos.data_ptr(), out.data_ptr(), b, h, L, D, D,
                                         D ** -0.5, 0, torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError(f"{name}: launch failed")
                errs.append(_err(out, fa.flash_decode_attention_plain(q, kk, vv, pos)))
            calls[name] = (run, max(errs))
        times = {name: [] for name in calls}
        for _ in range(ROUNDS):
            for name, (run, _) in calls.items():
                times[name].append(kv.graph_ms(run, 200))
        for name, (_, e) in calls.items():
            print(f"B4 float32 {label} {name:30s} {_median(times[name]):.5f} ms of device "
                  f"time (rounds {[round(x, 5) for x in times[name]]}); max abs error {e:.2e}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_forward_variants needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", help="variants to build (default: all)")
    ap.add_argument("--dtypes", default="float32,bfloat16,float16")
    ap.add_argument("--against", action="append", default=[], metavar="TREE",
                    help="a checkout's root (a parent unpacked by git archive): its source "
                         "built and timed beside the variants")
    ap.add_argument("--no-decode", action="store_true", help="leave out B4")
    args = ap.parse_args()
    dtypes = [getattr(torch, n) for n in args.dtypes.split(",")]
    print(kv.card())
    fwd_only = [n for n in args.variants if n in FORWARD_VARIANTS]
    dec_only = [n for n in args.variants if n in DECODE_VARIANTS]
    if args.variants and not fwd_only and not dec_only:
        raise SystemExit(f"no such variant: {args.variants}")
    fwd = kv.build("fwd", kv.variant_sources("flash_forward", FORWARD_VARIANTS, fwd_only,
                                      args.against),
                   FORWARD_SYMBOLS)
    forward(fwd, dtypes)
    if not args.no_decode:
        dec = kv.build("dec", kv.variant_sources("flash_decode", DECODE_VARIANTS, dec_only,
                                          args.against),
                       DECODE_SYMBOLS)
        decode(dec)


if __name__ == "__main__":
    main()
