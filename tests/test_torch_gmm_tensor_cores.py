"""The arithmetic of the grouped expert matmul's tensor-core kernel (B5,
``deeplearning4j_tpu_torch/csrc/grouped_matmul.cu``), emulated on the CPU
and held against the port's plain version.

bf16 and f16 (the port's path) and float32 in 3xTF32 (the same kernel's
float32 instantiation, which ``chip_smoke.py`` times beside the CUDA-core
kernel that the port runs in float32).

float32: each element of lhs and rhs is split once into ``hi = tf32(x)``
and ``lo = tf32(x - hi)`` (``cvt.rna.tf32.f32``: 10 mantissa bits, ties
away from zero), and every 8-deep step of the reduction, in the kernel's
k-order, adds ``a_lo·b_hi``, ``a_hi·b_lo`` and ``a_hi·b_hi`` to the sum of
its 32-deep slab, which is then added to the total (each product of two
TF32 values is exact in float32). It drops ``a_lo·b_lo`` and the bits
below ``lo``, ~2^-21 of each product, so it stays within B5's float32
tolerance on the card, 1e-4 of the largest output value, of the plain
version's float32 product. What one TF32 term would give is recorded
(``record_property``), not asserted: about three decimal digits.

bf16 and f16 (the warpgroup kernel): the reduction axis in slabs of 64
(one stage of the kernel's ring, zero-filled past d), each four
wgmma.m64nNk16 steps of 16 in order, whose products of 16-bit values are
exact; emulated as exact products summed in float64 for each 16-deep
step, added to a float32 accumulator in k order, and the output rounded
once to the 16-bit type. Both it and the plain version (float32 sums of the
widened values, rounded once) lie within half an ulp of the exact value
plus float32 rounding, so they differ by at most one ulp at the largest
value: 2^-7 of it in bf16, 2^-10 in f16 (B5's tolerances on the card).

Rows the groups do not keep (past ``m_pad`` or past the frontier) are
exactly 0 in both."""

import importlib

import numpy as np
import pytest
import torch

gm = importlib.import_module("deeplearning4j_tpu_torch.ops.grouped_matmul")

TOL_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7 + 1e-4,
           torch.float16: 2.0 ** -10 + 1e-4}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on finite float32 values: the mantissa rounded to
    10 bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def kernel_products(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a [E, m, d] @ b [E, d, h]`` as B5 forms it: ``"3xtf32"`` and
    ``"1xtf32"`` in 8-deep float32 steps summed by 32-deep slab,
    ``"16bit"`` in 64-deep slabs of four 16-deep steps of exact products
    (a and b hold 16-bit values, widened)."""
    d = a.shape[-1]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if mode == "16bit":
        for s0 in range(0, d, 64):  # a stage of the ring; past d its steps add 0
            for k0 in range(s0, min(s0 + 64, d), 16):
                step = a[..., k0: k0 + 16].double() @ b[..., k0: k0 + 16, :].double()
                acc = acc + step.float()
        return acc
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    for s0 in range(0, d, 32):  # a slab's sum, then into the total
        part = torch.zeros_like(acc)
        for k0 in range(s0, min(s0 + 32, d), 8):
            s = slice(k0, k0 + 8)
            if mode == "3xtf32":
                part = part + al[..., s] @ bh[..., s, :]
                part = part + ah[..., s] @ bl[..., s, :]
            part = part + ah[..., s] @ bh[..., s, :]
        acc = acc + part
    return acc


def emulate(lhs, group_sizes, rhs, max_group_size, mode, out_dtype):
    """B5's output: the kept rows of each group times its slab, the products
    as ``mode`` forms them, rounded once to ``out_dtype``; other rows 0."""
    m_pad, _ = gm._tiling(lhs.shape[0], max_group_size, 128)
    buf = gm._to_groups(lhs.float(), group_sizes, m_pad)
    out = kernel_products(buf, rhs.float(), mode).to(out_dtype)
    return gm._from_groups(out, group_sizes, lhs.shape[0])


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _dropped(n, sizes, max_group) -> torch.Tensor:
    """[n] bool: the rows no group keeps (past m_pad, or past the frontier)."""
    m_pad, _ = gm._tiling(n, max_group, 128)
    kept = torch.zeros(n, dtype=torch.bool)
    start = 0
    for s in sizes:
        kept[start: min(start + min(s, m_pad), n)] = True
        start += s
    return ~kept


CASES = [  # n, d, h, group sizes, max_group_size
    (300, 72, 130, (0, 150, 90, 5), 100),   # an empty group, a group over m_pad, a tail
    (200, 768, 48, (60, 0, 90, 30), None),  # the MoE layer's d: 96 float32 steps
    (120, 100, 40, (50, 70), 64),           # d not a whole step: zero-filled
    (333, 100, 90, (100, 0, 150), None),    # d, h not whole 16-byte rows: copied by threads
]


@pytest.mark.parametrize("n,d,h,sizes,max_group", CASES)
def test_split_products_match_the_plain_version(n, d, h, sizes, max_group, record_property):
    rs = np.random.RandomState(n + d)
    lhs = torch.from_numpy(rs.randn(n, d).astype(np.float32))
    rhs = torch.from_numpy((rs.randn(len(sizes), d, h) * d ** -0.5).astype(np.float32))
    gs = torch.tensor(sizes, dtype=torch.int32)
    ref = gm.grouped_matmul_plain(lhs, gs, rhs, max_group_size=max_group)
    got = emulate(lhs, gs, rhs, max_group, "3xtf32", torch.float32)
    one = emulate(lhs, gs, rhs, max_group, "1xtf32", torch.float32)
    err = _rel(got, ref)
    record_property("split_rel_err", err)
    record_property("one_tf32_term_rel_err", _rel(one, ref))
    assert err <= TOL_REL[torch.float32], err
    dropped = _dropped(n, sizes, max_group)
    assert bool((got[dropped] == 0).all()) and bool((ref[dropped] == 0).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,d,h,sizes,max_group", CASES)
def test_16bit_products_match_the_plain_version(dtype, n, d, h, sizes, max_group):
    rs = np.random.RandomState(3 * n + d)
    lhs = torch.from_numpy(rs.randn(n, d).astype(np.float32)).to(dtype)
    rhs = torch.from_numpy((rs.randn(len(sizes), d, h) * d ** -0.5).astype(np.float32)).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32)
    ref = gm.grouped_matmul_plain(lhs, gs, rhs, max_group_size=max_group)
    got = emulate(lhs, gs, rhs, max_group, "16bit", dtype)
    assert got.dtype == ref.dtype == dtype
    assert _rel(got, ref) <= TOL_REL[dtype]
    dropped = _dropped(n, sizes, max_group)
    assert bool((got[dropped] == 0).all()) and bool((ref[dropped] == 0).all())
