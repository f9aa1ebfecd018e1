"""Design alternatives of the flash forward kernel (B1) and the decode kernel
(B4), timed against the kernels as they are.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.flash_forward_variants

Builds ``csrc/flash_forward.cu`` and ``csrc/flash_decode.cu`` as they are
and with each variant in :data:`FORWARD_VARIANTS` and
:data:`DECODE_VARIANTS` (text substitutions, see :mod:`.kernel_variants`),
all at once. Then B1's builds are timed at the serving and training shape
([8, 12, 1024, 64], causal) in float32, bfloat16 and float16, and at head
dim 256 ([1, 8, 2048, 256], causal) in bfloat16, in turn, three rounds, by
CUDA events (the float32 variants change the mma.sync kernel, the others
the bf16/f16 wgmma kernel); and B4's builds at the serving
shape (q [8, 12, 1, 64] against a [8, 12, 1024, 64] cache at positions
132-532, four caches in turn) and at one (b, h) pair of rows against a 4096-long cache, in float32,
three rounds, by device time (200 calls replayed from one CUDA graph).
Each prints its medians with its error against the plain version.
"""

from __future__ import annotations

import ctypes
import importlib

import numpy as np
import torch

from deeplearning4j_tpu_torch.tools import kernel_variants as kv

# the module (ops/__init__ exports a function of this name)
fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

B, H, T, D, ROUNDS = 8, 12, 1024, 64, 3
WIDE = (1, 8, 2048, 256)  # chip_smoke.py's head-dim-256 shape, timed in bf16
DECODE_POS = [132, 532, 230, 410, 378, 310, 299, 450]  # mid-generation, as chip_smoke.py's
LONG_L = 4096

#: name: [(text in the source, its replacement), ...]
FORWARD_VARIANTS = {
    "128 q rows, 8 warps (f32)": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "64-key tiles in f32": [("sizeof(T) == 4 || DMAX > 128 ? 32 : 64", "DMAX > 128 ? 32 : 64")],
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


def forward(libs) -> None:
    gen = torch.Generator().manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    shapes = [((B, H, T, D), dtype) for dtype in (torch.float32, torch.bfloat16, torch.float16)]
    shapes.append((WIDE, torch.bfloat16))
    for (B_, H_, T_, D_), dtype in shapes:
        q, k, v = (torch.randn(B_, H_, T_, D_, generator=gen).to("cuda", dtype)
                   for _ in range(3))
        ref, ref_lse = fa.flash_attention_plain(q, k, v, None, True)
        out = torch.empty_like(q)
        lse = torch.empty((B_, H_, T_), device="cuda")
        code = fa._KERNEL_DTYPES[dtype]
        calls = {}
        for name, lib in libs.items():
            def run(lib=lib):
                return lib.dl4j_flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                                              out.data_ptr(), lse.data_ptr(), B_, H_, T_, T_, D_,
                                              D_, D_ ** -0.5, 1, 0, code, stream)
            if run():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            calls[name] = (run, _err(out, ref), _err(lse, ref_lse))
        times = {name: [] for name in calls}
        for _ in range(ROUNDS):  # every build in turn, so the comparison is paired
            for name, (run, _, _) in calls.items():
                times[name].append(kv.ms(run))
        for name, (_, e_out, e_lse) in calls.items():
            print(f"B1 {str(dtype)[6:]:8s} [{B_},{H_},{T_},{D_}] {name:28s} "
                  f"{_median(times[name]):.4f} ms (rounds {[round(x, 4) for x in times[name]]}); "
                  f"max abs error out {e_out:.2e}, lse {e_lse:.2e}")


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
    print(kv.card())
    fwd = kv.build("fwd", kv.variant_sources("flash_forward", FORWARD_VARIANTS), FORWARD_SYMBOLS)
    dec = kv.build("dec", kv.variant_sources("flash_decode", DECODE_VARIANTS), DECODE_SYMBOLS)
    forward(fwd)
    decode(dec)


if __name__ == "__main__":
    main()
