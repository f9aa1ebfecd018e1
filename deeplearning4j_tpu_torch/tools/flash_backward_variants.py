"""Design alternatives of the flash backward kernels (B2 dq, B3 dk/dv), timed
against the kernels as they are.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.flash_backward_variants [variant ...] [--dtypes float32,...]

Builds ``csrc/flash_backward.cu`` as it is and with each variant in
:data:`VARIANTS` (a text substitution of the source and its headers, see
:mod:`.kernel_variants`; those named on the command line, or all), all at
once; then, at the training path's shape ([8, 12, 1024, 64], causal), times
each build's two kernels in float32, bfloat16 and float16 (or the
``--dtypes`` named) in turn, three rounds, SDPA's backward in the same
rounds, and prints the median of each with the relative error against the
plain versions, whether the outputs equal the source's as it is bit for
bit, and the registers ptxas reports. "f32 dk/dv on mma.sync" brings back
the mma.sync design the float32 3xTF32 wgmma dk/dv kernel replaced, and
the variants named "(f32 ...)" act on that wgmma kernel; "dq walks 32
keys" acts on the float32 mma.sync dq kernel; the others on the bf16/f16
wgmma dq and dk/dv kernels (among them the mma.sync dq design they
replaced). ``--dtypes float64`` builds ``csrc/flash_f64.cu`` instead, with
the variants of :data:`VARIANTS_F64` (the SIMT dk/dv design the DMMA kernel
replaced, and that kernel's walk and block), and holds every build's dq,
dk and dv to the source's as it is, to 1e-10 of the largest value.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.tools import kernel_variants as kv

# the module (ops/__init__ exports a function of this name)
fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

B, H, T, D, ROUNDS = 8, 12, 1024, 64, 3

_INT_SPLIT = """    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;"""
_CVT_SPLIT = """    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));"""

_LO_SPLIT = "    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;"
_LO_MASKED = "    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;"



def _two_consumers(producer_regs: int, consumer_regs: int) -> list:
    """The float32 dk/dv kernel with two consumer warpgroups of 64 keys each
    sharing the producer's tiles (128 keys a block, 384 threads), the
    registers a thread moved by setmaxnreg to fit the SM's 64K."""
    return [("constexpr int kTf32Keys = 64;", "constexpr int kTf32Keys = 128;"),
            ("constexpr int kTf32Threads = 256;", "constexpr int kTf32Threads = 384;"),
            ("    const int me = tid - NC;\n",
             f'    asm volatile("setmaxnreg.dec.sync.aligned.u32 {producer_regs};");\n'
             "    const int me = tid - NC;\n"),
            ("  const int w0 = (tid >> 5) * 16;  // this warp's first key of the block's\n",
             f'  asm volatile("setmaxnreg.inc.sync.aligned.u32 {consumer_regs};");\n'
             "  const int w0 = (tid >> 5) * 16;  // this warp's first key of the block's\n"),
            # each warpgroup's 64 rows of v
            ("smem_desc(Vh, 16, 1024)", "smem_desc(Vh + (tid >> 7) * 64 * kF32Cols, 16, 1024)"),
            ("smem_desc(Vl, 16, 1024)", "smem_desc(Vl + (tid >> 7) * 64 * kF32Cols, 16, 1024)")]


#: name: [(text in the source, its replacement), ...]
VARIANTS = {
    "split by cvt.rna.tf32.f32": [(_INT_SPLIT, _CVT_SPLIT)],
    "f32 dk/dv on mma.sync": [("constexpr bool kTf32Wgmma = true;",
                               "constexpr bool kTf32Wgmma = false;")],
    "(f32 one raw stage)": [("constexpr int kTf32Raw = 2;", "constexpr int kTf32Raw = 1;")],
    # lo's 13 low bits cleared as well: bit-equal dk and dv show that wgmma
    # drops them as mma.sync does (dq, on mma.sync, is bit-equal either way)
    "(f32 lo rounded in full)": [(_LO_SPLIT, _LO_MASKED)],
    "(f32 two consumer warpgroups)": _two_consumers(40, 232),
    "(f32 two consumers, producer 56 registers)": _two_consumers(56, 224),
    # diagnostics (wrong output): what binds the float32 wgmma dk/dv kernel
    "(f32 diagnostic: no q/g split)": [
        ("      split_tile<NP, BM, W, true, true, true>(me, rq, scale, sp, sp + QT, sp + 4 * QT,\n                                              sp + 5 * QT);\n", ""),
        ("      split_tile<NP, BM, W, true, true, false>(me, rq + QT, 1.f, sp + 2 * QT, sp + 3 * QT,\n                                               sp + 6 * QT, sp + 7 * QT);\n", "")],
    "(f32 diagnostic: scores in one term)": [
        ("      wgmma_tf32(s, ka_lo[kd], desc_at(qh, aq), kd > 0);\n      wgmma_tf32(s, ka_hi[kd], desc_at(ql, aq), 1);\n", ""),
        ("      wgmma_tf32(s, ka_hi[kd], desc_at(qh, aq), 1);\n", "      wgmma_tf32(s, ka_hi[kd], desc_at(qh, aq), kd > 0);\n"),
        ("      wgmma_tf32(dp, desc_at(vl, ak), desc_at(gh, aq), kd > 0);\n      wgmma_tf32(dp, desc_at(vh, ak), desc_at(gl, aq), 1);\n", ""),
        ("      wgmma_tf32(dp, desc_at(vh, ak), desc_at(gh, aq), 1);\n", "      wgmma_tf32(dp, desc_at(vh, ak), desc_at(gh, aq), kd > 0);\n")],
    "(f32 diagnostic: sums in one term)": [
        ("      wgmma_tf32(dv_acc, p_lo[kk], desc_at(gth, at), 1);\n      wgmma_tf32(dv_acc, p_hi[kk], desc_at(gtl, at), 1);\n", ""),
        ("      wgmma_tf32(dk_acc, ds_lo[kk], desc_at(qth, at), 1);\n      wgmma_tf32(dk_acc, ds_hi[kk], desc_at(qtl, at), 1);\n", "")],
    "(f32 split unrolled by 2)": [("#pragma unroll\n  for (int it = 0; it < R * W / 4 / NT; ++it) {",
                                   "#pragma unroll 2\n  for (int it = 0; it < R * W / 4 / NT; ++it) {")],
    "dq walks 32 keys": [("constexpr int kDqWalk = 64;", "constexpr int kDqWalk = 32;")],
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

#: float64 (csrc/flash_f64.cu): name: [(text in the source, its replacement), ...]
VARIANTS_F64 = {
    # the SIMT dk/dv design at every width: 256 threads, a 4 x 4 register
    # tile each, scalar fma over tiles in shared memory
    "f64 dk/dv SIMT design": [
        ("__host__ __device__ constexpr bool use_dmma() { return DMAX <= kDmmaMaxD; }",
         "__host__ __device__ constexpr bool use_dmma() { return false; }")],
    "f64 dk/dv walks 16 q rows": [("constexpr int kDmmaWalk = 32;",
                                   "constexpr int kDmmaWalk = 16;")],
    "f64 dk/dv 4 warps (64 keys a block)": [("constexpr int kDmmaWarps = 8;",
                                             "constexpr int kDmmaWarps = 4;")],
}
TOL_F64 = 1e-10  # two float64 designs: float64 sums in another order

_P, _I = ctypes.c_void_p, ctypes.c_int
SYMBOLS_F64 = {"dl4j_flash_bwd_dq_f64": [_P] * 8 + [_I] * 6 + [ctypes.c_double, _I, _I, _I, _P],
               "dl4j_flash_bwd_dkv_f64": [_P] * 9 + [_I] * 6 + [ctypes.c_double, _I, _I, _I, _P]}
SYMBOLS = {"dl4j_flash_bwd_dq": [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P],
           "dl4j_flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_backward_variants needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", help="variants to build (default: all)")
    ap.add_argument("--dtypes", default="float32,bfloat16,float16")
    ap.add_argument("--against", action="append", default=[], metavar="TREE",
                    help="a checkout's root (a parent unpacked by git archive): its source "
                         "built and timed beside the variants")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(kv.card())
    if args.dtypes == "float64":
        return _float64(args)
    libs = kv.build("bwd", kv.variant_sources("flash_backward", VARIANTS, args.variants,
                                              args.against), SYMBOLS)
    gen = torch.Generator().manual_seed(1)
    scale = D ** -0.5
    for dtype in (getattr(torch, n) for n in args.dtypes.split(",")):
        q, k, v, g = (torch.randn(B, H, T, D, generator=gen).to("cuda", dtype) for _ in range(4))
        out, lse = fa.flash_attention_plain(q, k, v, None, True)
        delta = torch.sum(g.float() * out.float(), dim=-1).contiguous()
        args_ = (q, k, v, g, lse, delta, None, True)
        ref = (fa.flash_attention_bwd_dq_plain(*args_), *fa.flash_attention_bwd_dkv_plain(*args_))
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        ptrs = [x.data_ptr() for x in (q, k, v, g, lse, delta)]
        code = fa._KERNEL_DTYPES[dtype]
        stream = torch.cuda.current_stream().cuda_stream
        calls, first = {}, None
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
            if first is None:
                first = [x.clone() for x in (dq, dk, dv)]
            same = [torch.equal(a, b) for a, b in zip((dq, dk, dv), first)]
            calls[name] = (run_dq, run_dkv, errs, same)
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        sdpa = lambda: torch.autograd.grad(o_lib, (qs, ks, vs), g, retain_graph=True)  # noqa: E731
        times = {name: ([], []) for name in calls}
        t_sdpa = []
        for _ in range(ROUNDS):  # every build in turn, so the comparison is paired
            for name, (run_dq, run_dkv, _, _) in calls.items():
                times[name][0].append(kv.ms(run_dq))
                times[name][1].append(kv.ms(run_dkv))
            t_sdpa.append(kv.ms(sdpa))
        for name, (_, _, errs, same) in calls.items():
            t_dq, t_dkv = (sorted(t)[ROUNDS // 2] for t in times[name])
            print(f"{str(dtype)[6:]:8s} {name:32s} dq {t_dq:.4f} ms, dk/dv {t_dkv:.4f} ms "
                  f"(rounds dq {[round(x, 4) for x in times[name][0]]}, dk/dv "
                  f"{[round(x, 4) for x in times[name][1]]}); rel error dq/dk/dv "
                  f"{['%.1e' % e for e in errs]}; bit-equal to as it is dq/dk/dv {same}")
        print(f"{str(dtype)[6:]:8s} {'sdpa backward (dq, dk, dv)':32s} "
              f"{sorted(t_sdpa)[ROUNDS // 2]:.4f} ms (rounds {[round(x, 4) for x in t_sdpa]})")
        del o_lib


def _rel64(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _float64(args) -> None:
    """The float64 kernels of ``csrc/flash_f64.cu``: each build's dq and
    dk/dv timed in turn with SDPA's float64 backward, three rounds, and
    held to the plain versions and to the source's as it is."""
    libs = kv.build("bwd64", kv.variant_sources("flash_f64", VARIANTS_F64, args.variants,
                                                args.against), SYMBOLS_F64, focus="dkv")
    gen = torch.Generator().manual_seed(1)
    scale = D ** -0.5
    q, k, v, g = (torch.randn(B, H, T, D, generator=gen).to("cuda", torch.float64)
                  for _ in range(4))
    out, lse = fa.flash_attention_plain(q, k, v, None, True)
    delta = torch.sum(g * out, dim=-1).contiguous()
    args_ = (q, k, v, g, lse, delta, None, True)
    ref = (fa.flash_attention_bwd_dq_plain(*args_), *fa.flash_attention_bwd_dkv_plain(*args_))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = [x.data_ptr() for x in (q, k, v, g, lse, delta)]
    stream = torch.cuda.current_stream().cuda_stream
    calls, first = {}, None
    for name, lib in libs.items():
        def run_dq(lib=lib):
            return lib.dl4j_flash_bwd_dq_f64(*ptrs, None, dq.data_ptr(), B, H, T, T, D, D, scale,
                                             1, 0, 3, stream)

        def run_dkv(lib=lib):
            return lib.dl4j_flash_bwd_dkv_f64(*ptrs, None, dk.data_ptr(), dv.data_ptr(), B, H, T,
                                              T, D, D, scale, 1, 0, 3, stream)
        if run_dq() or run_dkv():
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        errs = [_rel64(a, r) for a, r in zip((dq, dk, dv), ref)]
        if first is None:
            first = [x.clone() for x in (dq, dk, dv)]
        gaps = [_rel64(a, b) for a, b in zip((dq, dk, dv), first)]
        if max(gaps + errs) > TOL_F64:
            raise AssertionError(f"{name}: dq/dk/dv off by {errs} from the plain versions, "
                                 f"{gaps} from the source as it is (tol {TOL_F64:g})")
        calls[name] = (run_dq, run_dkv, errs, gaps)
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa = lambda: torch.autograd.grad(o_lib, (qs, ks, vs), g, retain_graph=True)  # noqa: E731
    times = {name: ([], []) for name in calls}
    t_sdpa = []
    for _ in range(ROUNDS):  # every build in turn, so the comparison is paired
        for name, (run_dq, run_dkv, _, _) in calls.items():
            times[name][0].append(kv.ms(run_dq, 3))
            times[name][1].append(kv.ms(run_dkv, 3))
        t_sdpa.append(kv.ms(sdpa, 3))
    for name, (_, _, errs, gaps) in calls.items():
        t_dq, t_dkv = (sorted(t)[ROUNDS // 2] for t in times[name])
        print(f"float64  {name:36s} dq {t_dq:.4f} ms, dk/dv {t_dkv:.4f} ms "
              f"(rounds dq {[round(x, 4) for x in times[name][0]]}, dk/dv "
              f"{[round(x, 4) for x in times[name][1]]}); rel error dq/dk/dv "
              f"{['%.1e' % e for e in errs]}; against as it is {['%.1e' % e for e in gaps]}")
    print(f"float64  {'sdpa backward (dq, dk, dv)':36s} "
          f"{sorted(t_sdpa)[ROUNDS // 2]:.4f} ms (rounds {[round(x, 4) for x in t_sdpa]})")


if __name__ == "__main__":
    main()
