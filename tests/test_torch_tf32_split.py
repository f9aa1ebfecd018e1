"""The arithmetic of the flash backward kernels' tensor-core products (B2 and
B3, ``deeplearning4j_tpu_torch/csrc/flash_backward.cu``), emulated on the
CPU and held against the port's plain versions.

The kernels run every product as TF32 ``mma``: an operand is rounded to
TF32 (``cvt.rna.tf32.f32``: 10 mantissa bits, ties away from zero), each
product of two TF32 values is exact in float32, and the sums are float32.
A float32 operand ``x`` is split into ``hi = tf32(x)`` and ``lo = tf32(x -
hi)``, and ``a·b`` is summed as ``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi``
(3xTF32). A bf16 operand is exact in TF32 and is not split: in bf16, s and
dp take one term, ds·k, dsᵀ·q and pᵀ·g two.

Tolerance: 1e-5 of the largest gradient value, ten times inside the
kernels' float32 tolerance on the card (1e-4): 3xTF32 drops only
``a_lo·b_lo`` and the bits below ``lo`` (~2^-21 of each product), and the
sums differ from the plain version's only in order. What a single TF32
term gives is recorded (``record_property``), not asserted: about three
decimal digits."""

import importlib

import numpy as np
import pytest
import torch

pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

TOL_REL = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the float32 mantissa rounded to 10 bits, ties
    away from zero (adding half a TF32 ulp to the magnitude bits carries
    into the exponent where it must)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(a, b, split_a: bool, split_b: bool) -> torch.Tensor:
    """``a @ b`` as the kernels form it: an operand that is split takes its
    ``lo`` term, and every operand is TF32 (an unsplit one is rounded, which
    leaves a bf16 value as it is)."""
    ah, al = split(a) if split_a else (tf32(a), None)
    bh, bl = split(b) if split_b else (tf32(b), None)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if split_a:
        out = out + al @ bh
    if split_b:
        out = out + ah @ bl
    return out + ah @ bh


def kernel_grads(q, k, v, g, lse, delta, mask, causal, scale, mode):
    """(dq, dk, dv) with the kernels' products. ``mode``: ``"3xtf32"`` (the
    float32 kernels), ``"bf16"`` (bf16-exact inputs: one term for s and dp,
    two for the products with p or ds, the scale applied to s and dk's sum)
    or ``"1xtf32"`` (one rounded term everywhere)."""
    full = mode == "3xtf32"
    if mode == "bf16":
        s = mm(q, k.transpose(-1, -2), False, False) * scale
    else:
        s = mm(q * scale, k.transpose(-1, -2), full, full)
    kept = pfa._masked_scores(q, k, mask, causal, scale) > -0.5e30
    s = torch.where(kept, s, torch.full_like(s, -1e30))
    p = torch.where(s > -0.5e30, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = mm(g, v.transpose(-1, -2), full, full)
    ds = p * (dp - delta[..., None])
    acc_split = mode != "1xtf32"  # p and ds are float32: split in both kernels' modes
    dq = mm(ds, k, acc_split, full) * scale
    dv = mm(p.transpose(-1, -2), g, acc_split, full)
    if mode == "bf16":
        dk = mm(ds.transpose(-1, -2), q, acc_split, False) * scale
    else:
        dk = mm(ds.transpose(-1, -2), q * scale, acc_split, full)
    return dq, dk, dv


def _inputs(seed, tq, tk, d, dv, causal, masked, bf16_exact):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(2, 2, t, w).astype(np.float32)
            for t, w in ((tq, d), (tk, d), (tk, dv), (tq, dv))]
    q, k, v, g = (torch.from_numpy(a) for a in arrs)
    if bf16_exact:
        q, k, v, g = (x.to(torch.bfloat16).float() for x in (q, k, v, g))
    mask = None
    if masked:
        mask = torch.from_numpy((rs.rand(2, tk) > 0.3).astype(np.float32))
        mask[1] = 0.0  # a fully masked batch row
    out, lse = pfa.flash_attention_plain(q, k, v, mask, causal)
    delta = torch.sum(g * out, dim=-1)
    return q, k, v, g, lse, delta, mask


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def test_tf32_rounds_to_nearest_ties_away_and_keeps_bf16_values():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12, one + 3 * 2 ** -12,
                      0.0, -0.0, 2.0 - 2 ** -23], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -10,
                         0.0, -0.0, 2.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    b = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(np.float32))
    b = b.to(torch.bfloat16).float()
    assert torch.equal(tf32(b), b)  # a bf16 value is exact in TF32
    f = torch.from_numpy(np.random.RandomState(1).randn(1000).astype(np.float32))
    hi, lo = split(f)
    assert float(((hi + lo - f).abs() / f.abs()).max()) <= 2.0 ** -21


CASES = [  # tq, tk, d, dv, causal, masked
    (40, 40, 16, 16, True, False),
    (33, 70, 36, 36, True, True),    # tq < tk, bottom-right causal, ragged d
    (64, 64, 64, 64, False, True),
    (70, 33, 24, 40, True, False),   # tq > tk: the first rows see no key; dv != d
]


@pytest.mark.parametrize("mode", ["3xtf32", "bf16"])
@pytest.mark.parametrize("tq,tk,d,dv,causal,masked", CASES)
def test_split_products_match_the_plain_version(mode, tq, tk, d, dv, causal, masked,
                                                record_property):
    """The 3-term split (float32 inputs) and the 2-term split beside an
    exact operand (bf16 inputs) give dq, dk and dv within 1e-5 of the plain
    version's largest value; a single TF32 term is recorded beside them."""
    q, k, v, g, lse, delta, mask = _inputs(tq * 100 + tk + d, tq, tk, d, dv, causal, masked,
                                           bf16_exact=mode == "bf16")
    scale = d ** -0.5
    args = (q, k, v, g, lse, delta, mask, causal, scale)
    ref = (pfa.flash_attention_bwd_dq_plain(*args), *pfa.flash_attention_bwd_dkv_plain(*args))
    got = kernel_grads(*args, mode)
    one = kernel_grads(*args, "1xtf32")
    errs = {n: _rel(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
    record_property("split_rel_err", errs)
    record_property("one_tf32_term_rel_err",
                    {n: _rel(a, r) for n, a, r in zip(("dq", "dk", "dv"), one, ref)})
    assert max(errs.values()) <= TOL_REL, errs
    if masked:  # the fully masked batch row keeps zero gradients
        assert all(bool((x[1] == 0).all()) for x in got)
