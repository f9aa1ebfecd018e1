"""Design alternatives of the flash backward kernels (B2 dq, B3 dk/dv), timed
against the kernels as they are.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.flash_backward_variants [variant ...]

Builds ``csrc/flash_backward.cu`` as it is and with each variant in
:data:`VARIANTS` (a text substitution of the source and its headers, see
:mod:`.kernel_variants`; those named on the command line, or all), all at once; then, at the training
path's shape ([8, 12, 1024, 64], causal), times each build's two kernels in
float32, bfloat16 and float16 in turn, three rounds, and prints the median
of each with the relative error against the plain versions and the
registers ptxas reports. The variants of the float32 kernels act on the
mma.sync kernels; the others on the bf16/f16 wgmma dq and dk/dv kernels
(among them the mma.sync dq design they replaced).
"""

from __future__ import annotations

import ctypes
import importlib
import sys

import torch

from deeplearning4j_tpu_torch.tools import kernel_variants as kv

# the module (ops/__init__ exports a function of this name)
fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

B, H, T, D, ROUNDS = 8, 12, 1024, 64, 3

_INT_SPLIT = """    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;"""
_CVT_SPLIT = """    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));"""

#: name: [(text in the source, its replacement), ...]
VARIANTS = {
    "split by cvt.rna.tf32.f32": [(_INT_SPLIT, _CVT_SPLIT)],
    "dq walks 32 keys": [("constexpr int kDqWalk = 64;", "constexpr int kDqWalk = 32;")],
    "dk/dv walks 16 q rows": [("constexpr int kDkvWalk = 32;", "constexpr int kDkvWalk = 16;")],
    "dk/dv walks 64 q rows": [("constexpr int kDkvWalk = 32;", "constexpr int kDkvWalk = 64;")],
    "16-bit dk/dv on mma.sync": [("constexpr bool kWgmma = true;",
                                         "constexpr bool kWgmma = false;")],
    "dk/dv walks 64 q rows, no floor": [
        ("constexpr int kWgWalk = 32;", "constexpr int kWgWalk = 64;"),
        ("constexpr int kWgMinBlocks = 3;", "constexpr int kWgMinBlocks = 1;")],
    "sums after the probabilities": [("constexpr bool kWgOverlap = true;",
                                      "constexpr bool kWgOverlap = false;")],
    "no occupancy floor": [("constexpr int kWgMinBlocks = 3;", "constexpr int kWgMinBlocks = 1;")],
    # the bf16/f16 dq kernel: the mma.sync design it replaced, without the
    # overlap of the sums, at 32 keys a tile; ds in one 16-bit term (error
    # printed beside the time; not shipped)
    "16-bit dq on mma.sync": [("  return sizeof(T) == 2 && DMAX <= kWgDqMaxD;", "  return false;")],
    "dq sums after the probabilities": [
        ("      wg_wait<1>();  // s and dp; the sums run on under the probabilities",
         "      wg_wait<0>();")],
    "wgmma dq walks 32 keys": [("constexpr int kWgDqKeys = 64;", "constexpr int kWgDqKeys = 32;")],
    "one-term ds in dq (not shipped)": [
        ("      wgmma_rs<1>(acc, ds_lo[kk], bk, 1, T());\n", "")],
    # pᵀ and dsᵀ in one bf16/f16 term: error printed beside the time; not shipped
    "one-term p, ds (not shipped)": [
        ("      wgmma_rs<1>(dv_acc, p_lo[kk], bg, 1, T());\n", ""),
        ("      wgmma_rs<1>(dk_acc, ds_lo[kk], bq, 1, T());\n", "")],
}

_P, _I = ctypes.c_void_p, ctypes.c_int
SYMBOLS = {"dl4j_flash_bwd_dq": [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P],
           "dl4j_flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_backward_variants needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(kv.card())
    libs = kv.build("bwd", kv.variant_sources("flash_backward", VARIANTS, sys.argv[1:]), SYMBOLS)
    gen = torch.Generator().manual_seed(1)
    scale = D ** -0.5
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen).to("cuda", dtype) for _ in range(4))
        out, lse = fa.flash_attention_plain(q, k, v, None, True)
        delta = torch.sum(g.float() * out.float(), dim=-1).contiguous()
        args = (q, k, v, g, lse, delta, None, True)
        ref = (fa.flash_attention_bwd_dq_plain(*args), *fa.flash_attention_bwd_dkv_plain(*args))
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        ptrs = [x.data_ptr() for x in (q, k, v, g, lse, delta)]
        code = fa._KERNEL_DTYPES[dtype]
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}
        for name, lib in libs.items():
            def run_dq(lib=lib):
                return lib.dl4j_flash_bwd_dq(*ptrs, None, dq.data_ptr(), B, H, T, T, D, D,
                                             scale, 1, 0, code, stream)

            def run_dkv(lib=lib):
                return lib.dl4j_flash_bwd_dkv(*ptrs, None, dk.data_ptr(), dv.data_ptr(), B, H, T,
                                              T, D, D, scale, 1, 0, code, stream)
            if run_dq() or run_dkv():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            errs = [_rel(a, r) for a, r in zip((dq, dk, dv), ref)]
            calls[name] = (run_dq, run_dkv, errs)
        times = {name: ([], []) for name in calls}
        for _ in range(ROUNDS):  # every build in turn, so the comparison is paired
            for name, (run_dq, run_dkv, _) in calls.items():
                times[name][0].append(kv.ms(run_dq))
                times[name][1].append(kv.ms(run_dkv))
        for name, (_, _, errs) in calls.items():
            t_dq, t_dkv = (sorted(t)[ROUNDS // 2] for t in times[name])
            print(f"{str(dtype)[6:]:8s} {name:32s} dq {t_dq:.4f} ms, dk/dv {t_dkv:.4f} ms "
                  f"(rounds dq {[round(x, 4) for x in times[name][0]]}, dk/dv "
                  f"{[round(x, 4) for x in times[name][1]]}); rel error dq/dk/dv "
                  f"{['%.1e' % e for e in errs]}")


if __name__ == "__main__":
    main()
