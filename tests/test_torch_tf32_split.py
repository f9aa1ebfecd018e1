"""The arithmetic of the flash kernels' tensor-core products (the forward
B1, ``deeplearning4j_tpu_torch/csrc/flash_forward.cu``, and the backward
B2 and B3, ``csrc/flash_backward.cu``), emulated on the CPU and held
against the port's plain versions.

The kernels run every product as TF32 ``mma``: an operand is rounded to
TF32 (``cvt.rna.tf32.f32``: 10 mantissa bits, ties away from zero), each
product of two TF32 values is exact in float32, and the sums are float32.
A float32 operand ``x`` is split into ``hi = tf32(x)`` and ``lo = tf32(x -
hi)``, and ``a·b`` is summed as ``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi``
(3xTF32). A bf16 operand is exact in TF32 and is not split: in bf16, s and
dp take one term, ds·k, dsᵀ·q, pᵀ·g and the forward's p·v two. The forward
also runs its online softmax over the key tiles the kernel walks.

The bf16 and f16 kernels on Hopper's warpgroup products (the forward, the
dq kernel and the dk/dv kernel up to head dim 128) take 16-bit operands
only: s and dp are exact products of the 16-bit inputs summed in float32,
and the float32 p and ds enter p·v, ds·k, dsᵀ·q and pᵀ·g as two 16-bit
terms, ``hi = round16(x)`` and ``lo = round16(x - hi)``, each times the
exact 16-bit operand (``"bf16x2"`` and ``"f16x2"`` below): 16 + 16
significant bits of x in bf16 (the rest is below 2^-17 of it) and 11 + 11
in f16, where lo falls below f16's normal range for |x| < 2^-3 and keeps
fewer bits.

The float32 forward up to head dim 128 and the float32 dk/dv kernel up to
head dim 64 run on Hopper's warpgroup products in TF32 (``"wg3xtf32"``
below): the same 3xTF32 products, with each element of a tile split once
into hi and lo in the orientation its product reads (v, and q and g for
the sums over q rows, transposed; the split of a transposed value is the
split of the value), and the softmax in base 2 on the float32 scores (s ·
log2 e, ``2^(s·log2 e - m)``; the backward's ``lse · log2 e``); the forward
walks 32-key tiles. The float32 dq kernel stays on mma.sync (``"3xtf32"``).

Tolerance: 1e-5 of the largest gradient or output value (and 1e-5
absolute on the forward's logsumexp), inside the kernels' float32
tolerances on the card (1e-4 relative for the gradients, 5e-5 absolute on
outputs of magnitude below 1): 3xTF32 drops only ``a_lo·b_lo`` and the
bits below ``lo`` (~2^-21 of each product), the two 16-bit terms drop less
than 2^-17 of p or ds in bf16 (and, in f16, what lo loses below f16's
normal range, on values whose products are far below the largest), and
the sums differ from the plain version's only in order. What a single
TF32 or 16-bit term gives is recorded (``record_property``), not asserted:
about three decimal digits in TF32, two to three in one 16-bit term."""

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


#: the 16-bit type of each mode whose operands are exact in it
EXACT = {"bf16": torch.bfloat16, "bf16x2": torch.bfloat16, "f16x2": torch.float16,
         "bf16x1": torch.bfloat16, "f16x1": torch.float16}


#: the single-term mode recorded beside each mode (else one TF32 term)
ONE_TERM = {"bf16x2": "bf16x1", "f16x2": "f16x1"}


def mm16(a, b, dtype, terms: int = 2) -> torch.Tensor:
    """``a @ b`` as a warpgroup product forms it with A from registers: the
    float32 ``a`` as ``terms`` 16-bit terms (hi, then lo = round16(a - hi)),
    each times the exact 16-bit ``b``; the products are exact in float32,
    the sums float32."""
    hi = a.to(dtype).float()
    out = hi @ b
    if terms == 2:
        out = out + (a - hi).to(dtype).float() @ b
    return out


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


LOG2E = float(np.float32(1.4426950408889634))
LN2 = float(np.float32(0.6931471805599453))


def mm_t(a, bt) -> torch.Tensor:
    """``a @ bt.T`` with ``bt`` given transposed ([n, k]) and split in that
    orientation, once an element, as the warpgroup kernels write their
    transposed hi and lo tiles: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi."""
    ah, al = split(a)
    bh, bl = split(bt)
    return al @ bh.transpose(-1, -2) + ah @ bl.transpose(-1, -2) + ah @ bh.transpose(-1, -2)


def kernel_grads(q, k, v, g, lse, delta, mask, causal, scale, mode):
    """(dq, dk, dv) with the kernels' products. ``mode``: ``"3xtf32"`` (the
    float32 kernels), ``"bf16"`` (the mma.sync kernels on bf16-exact
    inputs: one term for s and dp, two TF32 terms for the products with p
    or ds, the scale applied to s and dk's sum), ``"1xtf32"`` (one rounded
    term everywhere), ``"bf16x2"`` / ``"f16x2"`` (the warpgroup kernels on
    16-bit-exact inputs: exact s and dp, p and ds in two 16-bit terms),
    ``"bf16x1"`` / ``"f16x1"`` (one 16-bit term) or ``"wg3xtf32"`` (the
    float32 warpgroup dk/dv kernel beside the mma.sync dq kernel)."""
    if mode == "wg3xtf32":
        dq = kernel_grads(q, k, v, g, lse, delta, mask, causal, scale, "3xtf32")[0]
        # sᵀ = k·(q·scale)ᵀ and dpᵀ = v·gᵀ, q and g split as they lie
        st = mm(k, (q * scale).transpose(-1, -2), True, True)
        kept = pfa._masked_scores(q, k, mask, causal, scale).transpose(-1, -2) > -0.5e30
        st2 = torch.where(kept, st * LOG2E, torch.full_like(st, -1e30))
        pt = torch.where(st2 > -0.5e30, torch.exp2(st2 - lse[..., None, :] * LOG2E),
                         torch.zeros_like(st2))
        dst = pt * (mm(v, g.transpose(-1, -2), True, True) - delta[..., None, :])
        # the sums over q rows read q·scale and g split in the transposed
        # orientation: [d, q] tiles
        dk = mm_t(dst, (q * scale).transpose(-1, -2))
        dv = mm_t(pt, g.transpose(-1, -2))
        return dq, dk, dv
    if mode[-2:] in ("x1", "x2"):
        dt, terms = EXACT[mode], int(mode[-1])
        s = (q @ k.transpose(-1, -2)) * scale
        kept = pfa._masked_scores(q, k, mask, causal, scale) > -0.5e30
        s = torch.where(kept, s, torch.full_like(s, -1e30))
        p = torch.where(s > -0.5e30, torch.exp(s - lse[..., None]), torch.zeros_like(s))
        ds = p * (g @ v.transpose(-1, -2) - delta[..., None])
        return (mm16(ds, k, dt, terms) * scale, mm16(ds.transpose(-1, -2), q, dt, terms) * scale,
                mm16(p.transpose(-1, -2), g, dt, terms))
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


def _inputs(seed, tq, tk, d, dv, causal, masked, exact=None):
    """Seeded q, k, v, g (values of the 16-bit type ``exact``, if given),
    an optional key mask with a fully masked batch row, and the plain
    forward's lse and delta."""
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(2, 2, t, w).astype(np.float32)
            for t, w in ((tq, d), (tk, d), (tk, dv), (tq, dv))]
    q, k, v, g = (torch.from_numpy(a) for a in arrs)
    if exact is not None:
        q, k, v, g = (x.to(exact).float() for x in (q, k, v, g))
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


@pytest.mark.parametrize("mode", ["3xtf32", "bf16", "bf16x2", "f16x2", "wg3xtf32"])
@pytest.mark.parametrize("tq,tk,d,dv,causal,masked", CASES)
def test_split_products_match_the_plain_version(mode, tq, tk, d, dv, causal, masked,
                                                record_property):
    """The 3-term split (float32 inputs), the 2-term TF32 split beside an
    exact operand (bf16 inputs) and the two 16-bit terms of p and ds beside
    exact 16-bit operands (bf16 and f16 inputs) give dq, dk and dv within
    1e-5 of the plain version's largest value; a single TF32 or 16-bit term
    is recorded beside them."""
    q, k, v, g, lse, delta, mask = _inputs(tq * 100 + tk + d, tq, tk, d, dv, causal, masked,
                                           exact=EXACT.get(mode))
    scale = d ** -0.5
    args = (q, k, v, g, lse, delta, mask, causal, scale)
    ref = (pfa.flash_attention_bwd_dq_plain(*args), *pfa.flash_attention_bwd_dkv_plain(*args))
    got = kernel_grads(*args, mode)
    one = kernel_grads(*args, ONE_TERM.get(mode, "1xtf32"))
    errs = {n: _rel(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
    record_property("split_rel_err", errs)
    record_property("one_tf32_term_rel_err",
                    {n: _rel(a, r) for n, a, r in zip(("dq", "dk", "dv"), one, ref)})
    assert max(errs.values()) <= TOL_REL, errs
    if masked:  # the fully masked batch row keeps zero gradients
        assert all(bool((x[1] == 0).all()) for x in got)


# keys a tile of the forward kernel (tile_keys, wg_tile_keys and tf32_keys
# in flash_forward.cu): 32 in float32 (on mma.sync and on wgmma), 64 in bf16
# and f16
FWD_TILE = {"3xtf32": 32, "1xtf32": 32, "bf16": 64, "bf16x2": 64, "f16x2": 64, "bf16x1": 64,
            "f16x1": 64, "wg3xtf32": 32}


def kernel_forward(q, k, v, mask, causal, scale, mode):
    """``(out, lse)`` with the forward kernel's products and its online
    softmax over its key tiles. ``mode``: ``"3xtf32"`` (float32: three terms
    for s and for p·v, the scale folded into q), ``"bf16"`` (bf16-exact
    inputs: one term for s, scaled after the product, two for p·v),
    ``"1xtf32"`` (one rounded term everywhere), ``"bf16x2"`` /
    ``"f16x2"`` (the warpgroup kernel: s exact, p·v with p in two 16-bit
    terms; ``x1``: one), or ``"wg3xtf32"`` (the float32 warpgroup kernel:
    three terms, v split in the transposed orientation, the softmax in base
    2)."""
    if mode == "wg3xtf32":
        return kernel_forward_wg(q, k, v, mask, causal, scale)
    full = mode == "3xtf32"
    x16 = mode[-2:] in ("x1", "x2")
    if mode == "bf16" or x16:
        s = mm(q, k.transpose(-1, -2), False, False) * scale
    else:
        s = mm(q * scale, k.transpose(-1, -2), full, full)
    kept = pfa._masked_scores(q, k, mask, causal, scale) > -0.5e30
    s = torch.where(kept, s, torch.full_like(s, -1e30))
    m = torch.full(s.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + v.shape[-1:])
    tile = FWD_TILE[mode]
    for k0 in range(0, s.shape[-1], tile):
        st = s[..., k0: k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.where(st > -0.5e30, torch.exp(st - m_new), torch.zeros_like(st))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if x16:
            pv = mm16(p, v[..., k0: k0 + tile, :], EXACT[mode], int(mode[-1]))
        else:
            pv = mm(p, v[..., k0: k0 + tile, :], mode != "1xtf32", full)
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), torch.full_like(l, 1e30))
    return out, lse[..., 0]


def kernel_forward_wg(q, k, v, mask, causal, scale):
    """``(out, lse)`` of the float32 warpgroup forward: s = (q·scale)·kᵀ in
    three terms; over 32-key tiles, the running max m of s·log2 e, p =
    2^(s·log2 e - m), the sum and acc rescaled by 2^(m_old - m_new), acc +=
    p·v with vᵀ split once an element; lse = m·ln 2 + log(l)."""
    s = mm(q * scale, k.transpose(-1, -2), True, True)
    kept = pfa._masked_scores(q, k, mask, causal, scale) > -0.5e30
    s2 = torch.where(kept, s * LOG2E, torch.full_like(s, -1e30))
    m = torch.full(s.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + v.shape[-1:])
    tile = FWD_TILE["wg3xtf32"]
    for k0 in range(0, s.shape[-1], tile):
        st = s2[..., k0: k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.where(st > -0.5e30, torch.exp2(st - m_new), torch.zeros_like(st))
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm_t(p, v[..., k0: k0 + tile, :].transpose(-1, -2))
        m = m_new
    out = acc * (1.0 / torch.clamp_min(l, 1e-30))
    lse = torch.where(l > 0, m * LN2 + torch.log(torch.clamp_min(l, 1e-30)),
                      torch.full_like(l, 1e30))
    return out, lse[..., 0]


FWD_CASES = CASES + [(100, 150, 32, 48, True, True)]  # 3 or 5 key tiles, the last ragged


@pytest.mark.parametrize("mode", ["3xtf32", "bf16", "bf16x2", "f16x2", "wg3xtf32"])
@pytest.mark.parametrize("tq,tk,d,dv,causal,masked", FWD_CASES)
def test_forward_split_products_match_the_plain_version(mode, tq, tk, d, dv, causal, masked,
                                                        record_property):
    """The forward's split products and tiled online softmax give the
    output within 1e-5 of the plain version's largest value and the
    logsumexp within 1e-5; a single TF32 or 16-bit term is recorded beside
    them."""
    q, k, v, _, _, _, mask = _inputs(tq * 10 + tk + 3 * d, tq, tk, d, dv, causal, masked,
                                     exact=EXACT.get(mode))
    scale = d ** -0.5
    ref, ref_lse = pfa.flash_attention_plain(q, k, v, mask, causal, scale)
    out, lse = kernel_forward(q, k, v, mask, causal, scale, mode)
    one, one_lse = kernel_forward(q, k, v, mask, causal, scale, ONE_TERM.get(mode, "1xtf32"))
    err, lse_err = _rel(out, ref), float((lse - ref_lse).abs().max())
    record_property("split_rel_err", {"out": err, "lse_abs": lse_err})
    record_property("one_tf32_term_rel_err",
                    {"out": _rel(one, ref), "lse_abs": float((one_lse - ref_lse).abs().max())})
    assert err <= TOL_REL and lse_err <= 1e-5, (err, lse_err)
    if masked:  # the fully masked batch row: 0 and lse +1e30
        assert bool((out[1] == 0).all()) and bool((lse[1] == 1e30).all())
    if causal and tq > tk:  # rows that see no key
        assert bool((out[:, :, : tq - tk] == 0).all())
