"""The port's CUDA kernels against their plain versions, on the card, at
small ragged shapes the serving path does not reach (odd lengths, head
dims that are not a multiple of the tile, dv != d, rows that are not
16-byte aligned, one (b, h) pair of rows against a long cache that the
decode kernel splits over a cluster of blocks; the bf16/f16 wgmma forward,
dq and dk/dv kernels at head dims that take TMA, cp.async and plain loads,
and the profiler's names of the 16-bit dq and grouped matmul kernels;
the float64 dk/dv kernel on the float64 tensor cores at ragged shapes and
causal offsets, and the profiler's names of the float64 DMMA kernels;
for the grouped matmul B5
empty groups, groups over ``m_pad``, rows past the frontier and widths
that are not whole tiles or whole 16-byte vectors), the attention kernels'
determinism, and the wrappers' input checks.

These tests need a CUDA device and skip without one. Where there is one
(and, as on the chip machine, no JAX for ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances as in ``chip_smoke.py``: 5e-5 in float32 (same arithmetic,
another summation order), 1.6e-2 in bfloat16 and 2e-3 in float16 on the
output (one bf16 or f16 ulp at |out| < 4; both sides widen the same 16-bit
inputs and sum in float32), 1e-10 in float64 (float64 sums in another
order), 1e-4 on the float32 logsumexp and 1e-10 on the float64 one. The
backward kernels are held relative to the largest gradient value: 1e-4 in
float32 (sums over up to t terms in another order, of 3xTF32 products that
are exact to ~2^-21), one ulp there in bfloat16 (2^-7) and float16
(2^-10), where both sides round float32 sums of the same products, and
1e-10 in float64. B5 is held relative to the largest output value: 1e-4 in
float32 (its CUDA-core kernel sums d products in float32; the 3xTF32
tensor-core kernel kept beside it drops a_lo·b_lo, ~2^-21 of each product,
and sums in another order than the plain version), one ulp at the largest
value in bfloat16 (2^-7) and float16 (2^-10), where both sides sum exact
products of the 16-bit inputs in float32 and round once, and 1e-10 in
float64."""

import importlib

import pytest
import torch

from deeplearning4j_tpu_torch import ops

# the module (ops/__init__ exports a function of this name)
pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")
pgm = importlib.import_module("deeplearning4j_tpu_torch.ops.grouped_matmul")

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 5e-5, torch.bfloat16: 1.6e-2, torch.float16: 2e-3, torch.float64: 1e-10}
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-4, torch.float16: 1e-4, torch.float64: 1e-10}
BWD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7 + 1e-4,
               torch.float16: 2.0 ** -10 + 1e-4, torch.float64: 1e-10}
ALL = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rand(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen).to(device, dtype)


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("tq,tk,d,dv,causal", [
    (37, 91, 40, 40, True),
    (91, 37, 16, 16, True),     # tq > tk: the first rows see no key
    (65, 130, 32, 64, False),   # dv != d
    (1, 200, 128, 128, True),
    (70, 131, 256, 256, True),  # head dim 256
    (33, 40, 200, 136, False),  # 128 < d, dv <= 256, off the tiles
])
def test_flash_forward_matches_plain(cuda, dtype, tq, tk, d, dv, causal):
    gen = torch.Generator().manual_seed(tq * tk + d)
    q = _rand(gen, (2, 3, tq, d), dtype, cuda)
    k = _rand(gen, (2, 3, tk, d), dtype, cuda)
    v = _rand(gen, (2, 3, tk, dv), dtype, cuda)
    mask = (torch.rand((2, tk), generator=gen) > 0.2).float().to(cuda)
    before = ops.LAUNCH_COUNTS["flash_forward"]
    out, lse = ops.flash_attention(q, k, v, mask, causal, return_lse=True)
    assert ops.LAUNCH_COUNTS["flash_forward"] == before + 1
    ref, ref_lse = ops.flash_attention_plain(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (2, 3, tq, dv)
    assert lse.dtype == ref_lse.dtype
    assert float((out.double() - ref.double()).abs().max()) <= TOL[dtype]
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL[dtype]


def _fwd_case(gen, dtype, device, b, h, tq, tk, d, dv, masked):
    q = _rand(gen, (b, h, tq, d), dtype, device)
    k = _rand(gen, (b, h, tk, d), dtype, device)
    v = _rand(gen, (b, h, tk, dv), dtype, device)
    mask = None
    if masked:
        mask = (torch.rand((b, tk), generator=gen) > 0.2).float()
        mask[-1] = 0.0  # a fully masked batch row
        mask = mask.to(device)
    return q, k, v, mask


@pytest.mark.parametrize("dtype,tq,tk,d,dv,causal,masked", [
    (torch.bfloat16, 70, 129, 36, 36, True, True),  # bf16 rows of 72 bytes, ragged edges
    (torch.float32, 130, 130, 128, 128, True, True),
    (torch.bfloat16, 130, 130, 128, 128, False, True),
    (torch.float32, 200, 77, 16, 16, True, False),  # tq > tk: the first rows see no key
    (torch.bfloat16, 77, 200, 16, 16, True, True),
    (torch.bfloat16, 65, 65, 37, 37, True, True),   # bf16 rows of odd length: plain loads
    (torch.float16, 70, 129, 36, 36, True, True),   # f16 rows of 72 bytes, ragged edges
    (torch.float16, 65, 65, 37, 37, True, True),    # f16 rows of odd length: plain loads
    (torch.float16, 130, 130, 128, 128, False, True),
    (torch.float32, 130, 200, 256, 256, True, True),
    (torch.bfloat16, 77, 77, 250, 250, True, True),
    (torch.float16, 200, 77, 256, 256, True, False),
    # the bf16/f16 wgmma kernel: lengths off its 64-row and 64-key tiles, d
    # 31 (rows copied by the threads, plain loads), 100 (200-byte rows:
    # cp.async, not TMA), 64, 128, 200 and 256 (TMA)
    (torch.bfloat16, 77, 150, 31, 31, True, True),
    (torch.float16, 77, 150, 31, 31, False, True),
    (torch.bfloat16, 130, 333, 64, 64, True, True),
    (torch.float16, 150, 99, 64, 64, True, False),   # tq > tk: the first rows see no key
    (torch.bfloat16, 95, 161, 100, 100, True, True),
    (torch.float16, 95, 161, 100, 100, False, True),
    (torch.bfloat16, 129, 200, 128, 128, True, False),
    (torch.float16, 129, 200, 128, 128, True, True),
    (torch.bfloat16, 70, 190, 200, 200, True, True),
    (torch.float16, 70, 190, 200, 136, False, True),  # dv's last 64-column block wholly past dv
    (torch.bfloat16, 150, 99, 256, 256, True, True),
    (torch.float16, 99, 150, 256, 64, False, True),   # d 256 with dv 64
    # the float32 3xTF32 wgmma kernel (DMAX 32 to 128): lengths off its
    # 64-row and 32-key tiles, d 31 (124-byte rows: 4-byte cp.async), 36
    # (TMA, the second 32-column block partly past d), 64, 100 and 128
    (torch.float32, 77, 150, 31, 31, True, True),
    (torch.float32, 70, 129, 36, 36, False, True),
    (torch.float32, 130, 333, 64, 64, True, True),
    (torch.float32, 150, 99, 64, 64, True, False),   # tq > tk: the first rows see no key
    (torch.float32, 95, 161, 100, 100, True, True),
    (torch.float32, 129, 200, 128, 128, True, False),
    (torch.float32, 99, 150, 64, 32, False, True),   # dv's second 32-column block wholly past dv
])
def test_flash_forward_tensor_core_shapes(cuda, dtype, tq, tk, d, dv, causal, masked):
    """The tensor-core forward at widths and lengths off its tiles: every
    output within the tolerance, a fully masked batch row 0 with lse
    +1e30, rows that see no key 0, and a second launch bit for bit the
    first."""
    gen = torch.Generator().manual_seed(tq + 3 * tk + d)
    q, k, v, mask = _fwd_case(gen, dtype, cuda, 2, 3, tq, tk, d, dv, masked)
    out, lse = ops.flash_attention(q, k, v, mask, causal, return_lse=True)
    again = ops.flash_attention(q, k, v, mask, causal, return_lse=True)
    ref, ref_lse = ops.flash_attention_plain(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert float((out.float() - ref.float()).abs().max()) <= TOL[dtype]
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL[dtype]
    if masked:
        assert bool((out[-1] == 0).all()) and bool((lse[-1] == 1e30).all())
    if causal and tq > tk:
        assert bool((out[:, :, : tq - tk] == 0).all())
        assert bool((lse[:, :, : tq - tk] == 1e30).all())


@pytest.mark.parametrize("dtype", ALL)
def test_flash_forward_is_deterministic(cuda, dtype):
    """One block owns each output tile, with no atomics: two calls give
    bit-identical output and lse."""
    gen = torch.Generator().manual_seed(21)
    q, k, v, mask = _fwd_case(gen, dtype, cuda, 2, 3, 300, 300, 64, 64, True)
    runs = [ops.flash_attention(q, k, v, mask, True, return_lse=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("L,d,dv", [(300, 64, 64), (129, 36, 36), (77, 128, 32),
                                    (300, 256, 256), (129, 200, 160)])
def test_flash_decode_matches_plain(cuda, dtype, L, d, dv):
    gen = torch.Generator().manual_seed(L + d)
    b, h = 5, 3
    q = _rand(gen, (b, h, 1, d), dtype, cuda)
    k = _rand(gen, (b, h, L, d), dtype, cuda)
    v = _rand(gen, (b, h, L, dv), dtype, cuda)
    start = torch.tensor([-1, 0, L // 2, L - 1, L + 5], dtype=torch.int32, device=cuda)
    out = ops.flash_decode_attention(q, k, v, start)
    ref = ops.flash_decode_attention_plain(q, k, v, start)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert float((out.double() - ref.double()).abs().max()) <= TOL[dtype]
    assert bool((out[0] == 0).all())


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("start_pos", [4095, 0, -1, 5000])
def test_flash_decode_one_row_long_cache(cuda, dtype, start_pos):
    """One (b, h) pair of rows against a 4096-long cache: each row is split
    over a cluster of blocks, of which all, one or none hold live keys."""
    gen = torch.Generator().manual_seed(4096 + start_pos)
    q = _rand(gen, (1, 2, 1, 64), dtype, cuda)
    k = _rand(gen, (1, 2, 4096, 64), dtype, cuda)
    v = _rand(gen, (1, 2, 4096, 64), dtype, cuda)
    start = torch.tensor([start_pos], dtype=torch.int32, device=cuda)
    before = ops.LAUNCH_COUNTS["flash_decode"]
    out = ops.flash_decode_attention(q, k, v, start)
    assert ops.LAUNCH_COUNTS["flash_decode"] == before + 1
    ref = ops.flash_decode_attention_plain(q, k, v, start)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert float((out.double() - ref.double()).abs().max()) <= TOL[dtype]
    if start_pos < 0:
        assert bool((out == 0).all())
    if start_pos == 0:  # the first key alone: its value row comes back
        assert float((out[0, :, 0].double() - v[0, :, 0].double()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("b,h,L", [(8, 12, 1024), (1, 2, 4096)])
def test_flash_decode_is_deterministic(cuda, b, h, L):
    """Partials are combined in a fixed order, with no atomics: two calls
    give bit-identical outputs, and each call is one launch."""
    gen = torch.Generator().manual_seed(b + L)
    q = _rand(gen, (b, h, 1, 64), torch.float32, cuda)
    k = _rand(gen, (b, h, L, 64), torch.float32, cuda)
    v = _rand(gen, (b, h, L, 64), torch.float32, cuda)
    start = torch.randint(-1, L + 3, (b,), generator=gen, dtype=torch.int32).to(cuda)
    before = ops.LAUNCH_COUNTS["flash_decode"]
    runs = [ops.flash_decode_attention(q, k, v, start) for _ in range(2)]
    assert ops.LAUNCH_COUNTS["flash_decode"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("d", [31, 32])
def test_decode_unaligned_rows_take_the_scalar_path(cuda, d):
    gen = torch.Generator().manual_seed(3)
    flat = _rand(gen, (2 * 2 * 50 * d + 1,), torch.float32, cuda)
    k = flat[1:].view(2, 2, 50, d)  # contiguous, 4 bytes past a 16-byte boundary
    assert k.is_contiguous() and k.data_ptr() % 16 != 0
    v = _rand(gen, (2, 2, 50, d), torch.float32, cuda)
    q = _rand(gen, (2, 2, 1, d), torch.float32, cuda)
    start = torch.tensor([10, 49], dtype=torch.int32, device=cuda)
    out = ops.flash_decode_attention(q, k, v, start)
    ref = ops.flash_decode_attention_plain(q, k, v, start)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= TOL[torch.float32]


def _bwd_inputs(gen, dtype, device, b, h, tq, tk, d, dv, causal, masked):
    q = _rand(gen, (b, h, tq, d), dtype, device)
    k = _rand(gen, (b, h, tk, d), dtype, device)
    v = _rand(gen, (b, h, tk, dv), dtype, device)
    g = _rand(gen, (b, h, tq, dv), dtype, device)
    mask = None
    if masked:
        mask = (torch.rand((b, tk), generator=gen) > 0.2).float()
        mask[-1] = 0.0  # a fully masked batch row
        mask = mask.to(device)
    out, lse = ops.flash_attention_plain(q, k, v, mask, causal)
    acc = lse.dtype  # float32, or float64 for float64 operands
    delta = torch.sum(g.to(acc) * out.to(acc), dim=-1).contiguous()
    return q, k, v, g, mask, lse, delta


def _rel_err(a, b):
    return (float((a.double() - b.double()).abs().max())
            / max(float(b.double().abs().max()), 1e-30))


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("tq,tk,d,dv,causal,masked", [
    (129, 129, 36, 32, True, False),
    (129, 129, 36, 32, False, True),
    (70, 129, 64, 64, True, True),    # tq < tk, causal bottom-right aligned
    (129, 70, 16, 16, True, False),   # tq > tk: the first rows see no key
    (65, 65, 128, 128, False, False),
    (129, 129, 36, 36, True, True),   # bf16 rows of 72 bytes: 8-byte copies, not 16
    (100, 130, 256, 256, True, True),  # head dim 256
    (70, 70, 200, 160, False, True),   # 128 < d, dv <= 256, off the tiles
    # lengths off the dk/dv kernel's 64-key and 32-row tiles; d 31 (plain
    # loads in bf16/f16), 100 (cp.async), 128 and 200
    (77, 150, 31, 31, True, True),
    (150, 99, 64, 64, True, False),   # tq > tk
    (95, 161, 100, 100, True, True),
    (130, 190, 128, 128, False, True),
    (70, 190, 200, 200, True, True),
    # the bf16/f16 wgmma dq kernel: tk off its 64-key tiles; d != dv with
    # dv's second 64-column block wholly past dv; tq off its 64-row tiles
    # at DMAX 128 (32-key tiles)
    (130, 333, 64, 64, True, True),
    (33, 300, 100, 64, True, True),
    (200, 77, 128, 128, False, True),
    # the float32 3xTF32 wgmma dk/dv kernel (DMAX 32 and 64): tq off its
    # 32-row walk, d 32 (one 32-column block), d != dv
    (100, 64, 32, 32, False, True),
    (333, 130, 60, 64, True, True),
])
def test_flash_backward_matches_plain(cuda, dtype, tq, tk, d, dv, causal, masked):
    gen = torch.Generator().manual_seed(tq + 7 * tk + d)
    q, k, v, g, mask, lse, delta = _bwd_inputs(gen, dtype, cuda, 2, 3, tq, tk, d, dv,
                                               causal, masked)
    before = dict(ops.LAUNCH_COUNTS)
    dq = pfa._flash_bwd_dq_cuda(q, k, v, g, lse, delta, mask, causal, d ** -0.5)
    dk, dv_ = pfa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, mask, causal, d ** -0.5)
    assert ops.LAUNCH_COUNTS["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert ops.LAUNCH_COUNTS["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    dk2, dv2 = pfa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, mask, causal, d ** -0.5)
    dq2 = pfa._flash_bwd_dq_cuda(q, k, v, g, lse, delta, mask, causal, d ** -0.5)
    r_dq = ops.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, mask, causal)
    r_dk, r_dv = ops.flash_attention_bwd_dkv_plain(q, k, v, g, lse, delta, mask, causal)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk2) and torch.equal(dv_, dv2)  # deterministic
    assert torch.equal(dq, dq2)
    assert dq.dtype == dk.dtype == dv_.dtype == dtype
    for got, ref in ((dq, r_dq), (dk, r_dk), (dv_, r_dv)):
        assert _rel_err(got, ref) <= BWD_REL_TOL[dtype]
    if masked:
        assert bool((dq[-1] == 0).all())  # the fully masked row has no gradient
    if causal and tq > tk:
        assert bool((dq[:, :, : tq - tk] == 0).all())


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True), (True, True)])
def test_flash_backward_is_deterministic(cuda, dtype, causal, masked):
    """Every output tile is written by one block with no atomics, so two
    launches on the same inputs give bit-identical dq, dk and dv."""
    gen = torch.Generator().manual_seed(17)
    q, k, v, g, mask, lse, delta = _bwd_inputs(gen, dtype, cuda, 2, 3, 200, 200, 64, 64,
                                               causal, masked)
    runs = []
    for _ in range(2):
        dq = pfa._flash_bwd_dq_cuda(q, k, v, g, lse, delta, mask, causal, 0.125)
        dk, dv_ = pfa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, mask, causal, 0.125)
        runs.append((dq, dk, dv_))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("tq,tk,off", [
    (70, 90, -100),  # every key in the future: nothing kept, lse +1e30
    (70, 90, -30),   # the first rows see no key
    (64, 64, 0),
    (64, 128, 500),  # every key visible
    (33, 129, 17),
    (130, 333, 203),  # the frontier off the 64-row and 64-key tiles
    (150, 99, -51),
])
def test_flash_kernels_take_an_explicit_causal_offset(cuda, dtype, tq, tk, off):
    """B1-B3 with query i seeing keys <= i + off (a ring-attention block's
    place in the whole sequence), against the plain versions at the same
    offset."""
    gen = torch.Generator().manual_seed(tq + tk + off + 1000)
    q, k, v, mask = _fwd_case(gen, dtype, cuda, 2, 3, tq, tk, 64, 64, True)
    out, lse = ops.flash_attention(q, k, v, mask, True, return_lse=True, causal_offset=off)
    ref, ref_lse = ops.flash_attention_plain(q, k, v, mask, True, causal_offset=off)
    g = _rand(gen, (2, 3, tq, 64), dtype, cuda)
    acc = ref_lse.dtype
    delta = torch.sum(g.to(acc) * ref.to(acc), dim=-1).contiguous()
    args = (q, k, v, g, ref_lse, delta, mask, True, 64 ** -0.5, off)
    dq = pfa._flash_bwd_dq_cuda(*args)
    dk, dv_ = pfa._flash_bwd_dkv_cuda(*args)
    r_dq = ops.flash_attention_bwd_dq_plain(*args)
    r_dk, r_dv = ops.flash_attention_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    assert float((out.double() - ref.double()).abs().max()) <= TOL[dtype]
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL[dtype]
    for got, want in ((dq, r_dq), (dk, r_dk), (dv_, r_dv)):
        assert _rel_err(got, want) <= BWD_REL_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [31, 64, 100, 128, 200, 256])
@pytest.mark.parametrize("tq,tk,off", [(77, 150, 23), (130, 333, -40), (150, 99, 300)])
def test_flash_bwd_dq_16bit_widths_and_offsets(cuda, dtype, d, tq, tk, off):
    """The 16-bit dq kernels (the wgmma kernel up to d 128: d 31 by plain
    loads, 100 by cp.async, 64 and 128 by TMA; mma.sync at 200 and 256) at
    lengths off their tiles, a masked and a fully masked batch row and an
    explicit causal offset, against the plain version; a second launch
    equals the first bit for bit."""
    gen = torch.Generator().manual_seed(tq + tk + d + off)
    q, k, v, mask = _fwd_case(gen, dtype, cuda, 2, 3, tq, tk, d, d, True)
    ref, ref_lse = ops.flash_attention_plain(q, k, v, mask, True, causal_offset=off)
    g = _rand(gen, (2, 3, tq, d), dtype, cuda)
    delta = torch.sum(g.float() * ref.float(), dim=-1).contiguous()
    args = (q, k, v, g, ref_lse, delta, mask, True, d ** -0.5, off)
    dq = pfa._flash_bwd_dq_cuda(*args)
    again = pfa._flash_bwd_dq_cuda(*args)
    r_dq = ops.flash_attention_bwd_dq_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(dq, again)
    assert _rel_err(dq, r_dq) <= BWD_REL_TOL[dtype]
    assert bool((dq[-1] == 0).all())  # the fully masked row has no gradient


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_b2_and_b5_run_the_wgmma_kernels(cuda, dtype):
    """A bf16 or f16 dq launch (d 64) and grouped matmul run the warpgroup
    kernels, as the profiler names them, and never the mma.sync ones."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(9)
    q, k, v, g, mask, lse, delta = _bwd_inputs(gen, dtype, cuda, 2, 3, 130, 130, 64, 64,
                                               True, True)
    lhs, gs, rhs = _gmm_case(gen, 600, 128, 192, (250, 0, 300), dtype, cuda)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pfa._flash_bwd_dq_cuda(q, k, v, g, lse, delta, mask, True, 0.125)
        ops.grouped_matmul(lhs, gs, rhs)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("flash_bwd_dq_wgmma_kernel" in n for n in names), names
    assert any("grouped_matmul_wgmma_kernel" in n for n in names), names
    assert not any("flash_bwd_dq_kernel<" in n or "grouped_matmul_tc_kernel" in n
                   for n in names), names


def _kernel_names(fn) -> list:
    """Names of the CUDA kernels ``torch.profiler`` records over ``fn()``;
    the profiler can drop a short window's kernel records, so a window that
    records none is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def test_f32_b1_and_b3_run_the_wgmma_kernels(cuda):
    """A float32 forward and dk/dv launch at d 64 run the 3xTF32 warpgroup
    kernels, as the profiler names them, and never the mma.sync ones; at d
    256 both stay on mma.sync."""
    gen = torch.Generator().manual_seed(10)
    q, k, v, g, mask, lse, delta = _bwd_inputs(gen, torch.float32, cuda, 2, 3, 130, 130, 64,
                                               64, True, True)
    wq, wk, wv, wg, _, wlse, wdelta = _bwd_inputs(gen, torch.float32, cuda, 1, 2, 70, 70, 256,
                                                  256, True, False)

    def narrow():
        ops.flash_attention(q, k, v, mask, True)
        pfa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, mask, True, 0.125)

    def wide():
        ops.flash_attention(wq, wk, wv, None, True)
        pfa._flash_bwd_dkv_cuda(wq, wk, wv, wg, wlse, wdelta, None, True, 0.0625)

    names = _kernel_names(narrow)
    assert any("flash_forward_tf32_kernel" in n for n in names), names
    assert any("flash_bwd_dkv_tf32_kernel" in n for n in names), names
    assert not any("flash_forward_kernel<" in n or "flash_bwd_dkv_kernel<" in n
                   for n in names), names
    names = _kernel_names(wide)
    assert any("flash_forward_kernel<" in n for n in names), names
    assert any("flash_bwd_dkv_kernel<" in n for n in names), names


def test_f64_b3_and_b5_run_the_dmma_kernels(cuda):
    """A float64 dk/dv launch at d 64 and a float64 grouped matmul run the
    float64 tensor-core (DMMA) kernels, as the profiler names them: B5 the
    TMA-fed one where d and h are even, the cp.async one where they are
    odd; at d 128 dk/dv stays on the SIMT kernel."""
    gen = torch.Generator().manual_seed(12)
    q, k, v, g, mask, lse, delta = _bwd_inputs(gen, torch.float64, cuda, 2, 3, 130, 130, 64,
                                               64, True, True)
    wq, wk, wv, wg, _, wlse, wdelta = _bwd_inputs(gen, torch.float64, cuda, 1, 2, 70, 70, 128,
                                                  128, True, False)
    lhs, gs, rhs = _gmm_case(gen, 600, 128, 192, (250, 0, 300), torch.float64, cuda)

    def narrow():
        pfa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, mask, True, 0.125)
        ops.grouped_matmul(lhs, gs, rhs)

    names = _kernel_names(narrow)
    assert any("flash_bwd_dkv_dmma_kernel" in n for n in names), names
    assert any("grouped_matmul_dmma_kernel" in n for n in names), names
    assert not any("flash_bwd_dkv_f64_kernel" in n or "grouped_matmul_tc_kernel" in n
                   for n in names), names
    olhs, ogs, orhs = _gmm_case(gen, 77, 33, 17, (20, 0, 40), torch.float64, cuda)
    names = _kernel_names(lambda: ops.grouped_matmul(olhs, ogs, orhs))
    assert any("grouped_matmul_tc_kernel<double>" in n for n in names), names
    names = _kernel_names(
        lambda: pfa._flash_bwd_dkv_cuda(wq, wk, wv, wg, wlse, wdelta, None, True, 0.09))
    assert any("flash_bwd_dkv_f64_kernel" in n for n in names), names


@pytest.mark.parametrize("tq,tk,d,dv,off", [
    (77, 150, 32, 32, 23),      # DMAX 32
    (77, 150, 20, 32, -40),     # DMAX 32, columns past d inside a TMA block
    (150, 99, 64, 64, 300),     # tq > tk, offset past the last key
    (77, 300, 33, 33, 23),      # 264-byte rows: copied by the threads, not TMA
    (200, 333, 64, 48, -40),    # dv 48: a 16-column block wholly past dv
    (129, 260, 64, 64, None),   # tk off the 128-key blocks, the default offset
    (300, 129, 64, 64, None),   # tq off the 32-row walk, tq > tk
])
def test_f64_dkv_dmma_kernel_at_ragged_shapes(cuda, tq, tk, d, dv, off):
    """The float64 DMMA dk/dv kernel against its plain version to 1e-10 of
    the largest gradient, causal at explicit offsets, with a key mask and a
    fully masked batch row (zero gradients), twice bit for bit."""
    gen = torch.Generator().manual_seed(tq + tk + d + dv)
    q, k, v, g, mask, _, _ = _bwd_inputs(gen, torch.float64, cuda, 2, 3, tq, tk, d, dv, True,
                                         True)
    out, lse = ops.flash_attention_plain(q, k, v, mask, True, causal_offset=off)
    delta = torch.sum(g * out, dim=-1).contiguous()
    args = (q, k, v, g, lse, delta, mask, True, d ** -0.5, off)
    dk, dv_ = pfa._flash_bwd_dkv_cuda(*args)
    dk2, dv2 = pfa._flash_bwd_dkv_cuda(*args)
    r_dk, r_dv = ops.flash_attention_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk2) and torch.equal(dv_, dv2)
    assert _rel_err(dk, r_dk) <= BWD_REL_TOL[torch.float64]
    assert _rel_err(dv_, r_dv) <= BWD_REL_TOL[torch.float64]
    assert bool((dk[-1] == 0).all()) and bool((dv_[-1] == 0).all())


@pytest.mark.parametrize("dtype", ALL)
def test_default_causal_offset_is_bit_identical(cuda, dtype):
    """Every launch that passes no offset is the launch with tk - tq."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, g, mask, lse, delta = _bwd_inputs(gen, dtype, cuda, 2, 3, 100, 140, 64, 64,
                                               True, True)
    a = ops.flash_attention(q, k, v, mask, True, return_lse=True)
    b = ops.flash_attention(q, k, v, mask, True, return_lse=True, causal_offset=40)
    args = (q, k, v, g, lse, delta, mask, True, 0.125)
    da = (pfa._flash_bwd_dq_cuda(*args), *pfa._flash_bwd_dkv_cuda(*args))
    db = (pfa._flash_bwd_dq_cuda(*args, 40), *pfa._flash_bwd_dkv_cuda(*args, 40))
    torch.cuda.synchronize()
    for x, y in zip((*a, *da), (*b, *db)):
        assert torch.equal(x, y)


def test_cuda_flash_attention_gives_gradients(cuda):
    """The fault the autograd Function repairs: a CUDA ``flash_attention``
    output used in a loss must give q, k and v their gradients, equal to
    plain autograd through the materialised-scores reference."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (_rand(gen, (2, 3, 129, 36), torch.float32, cuda).requires_grad_()
               for _ in range(3))
    w = _rand(gen, (2, 3, 129, 36), torch.float32, cuda)
    mask = torch.ones((2, 129), device=cuda)
    mask[1, 100:] = 0.0
    before = dict(ops.LAUNCH_COUNTS)
    (ops.flash_attention(q, k, v, mask, True) * w).sum().backward()
    assert ops.LAUNCH_COUNTS["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert ops.LAUNCH_COUNTS["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    got = [t.grad for t in (q, k, v)]
    assert all(gr is not None for gr in got)
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    (ops.mha_attention_reference(q2, k2, v2, mask, True) * w).sum().backward()
    for gr, ref in zip(got, (q2.grad, k2.grad, v2.grad)):
        assert _rel_err(gr, ref) <= BWD_REL_TOL[torch.float32]


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_seam_launches_a_kernel_for_every_dtype_and_head_dim(cuda, dtype, d):
    """``mha_attention`` (training: forward and backward) and
    ``decode_attention`` in ``"auto"`` launch a kernel for float32,
    bfloat16, float16 and float64 operands at head dims 32 to 256, and agree
    with the materialised-scores reference; nothing on CUDA runs a plain
    version in place of a kernel."""
    gen = torch.Generator().manual_seed(d)
    q, k, v, mask = _fwd_case(gen, dtype, cuda, 2, 2, 40, 40, d, d, True)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = dict(ops.LAUNCH_COUNTS)
    out = ops.mha_attention(q, k, v, mask, causal=True)
    out.float().square().sum().backward()
    q0 = q.detach()[:, :, :1].contiguous()
    with torch.no_grad():
        dec = ops.decode_attention(q0, k.detach(), v.detach(),
                                   torch.tensor([10, 39], dtype=torch.int32, device=cuda))
    launched = {n: ops.LAUNCH_COUNTS[n] - before[n] for n in before}
    assert launched == {"flash_forward": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                        "flash_decode": 1}
    assert out.dtype == dec.dtype == dtype and q.grad.dtype == dtype
    with torch.no_grad():
        ref = ops.mha_attention_reference(q.detach().double(), k.detach().double(),
                                          v.detach().double(), mask.double(), True)
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2, torch.float16: 1e-2,
           torch.float64: 1e-10}[dtype]  # the 16-bit inputs' own rounding in the reference
    assert float((out.detach().double() - ref).abs().max()) <= tol


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 1, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        ops.flash_attention(q.int(), q.int(), q.int())
    with pytest.raises(TypeError):
        ops.flash_decode_attention(q[:, :, :1].int(), q.int(), q.int(),
                                   torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))
    wide = torch.zeros((1, 1, 8, 264), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_decode_attention(wide[:, :, :1], wide, wide,
                                   torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="mask"):
        ops.flash_attention(q, q, q, mask=torch.ones((1, 8)))  # mask on the CPU


GMM_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7 + 1e-4,
               torch.float16: 2.0 ** -10 + 1e-4, torch.float64: 1e-10}


def _gmm_case(gen, n, d, h, sizes, dtype, device):
    lhs = _rand(gen, (n, d), dtype, device)
    rhs = _rand(gen, (len(sizes), d, h), dtype, device)
    return lhs, torch.tensor(sizes, dtype=torch.int32, device=device), rhs


def _group_rows_kept(sizes, m_pad, n):
    """Boolean [n]: rows some group keeps (local index < m_pad, row < n)."""
    kept = torch.zeros(n, dtype=torch.bool)
    start = 0
    for s in sizes:
        kept[start: min(start + min(s, m_pad), n)] = True
        start += s
    return kept


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("n,d,h,sizes,max_group", [
    (300, 72, 130, (0, 150, 90, 5), 100),   # empty group, a group over m_pad=104, tail
    (77, 33, 17, (20, 0, 40), None),        # d, h not whole 16-byte vectors
    (1000, 64, 256, (500, 400, 100), 400),  # full groups, m_pad 512
    (50, 16, 8, (30, 40), None),            # sum(sizes) > n: rows >= n never touched
    (600, 100, 300, (250, 0, 300), 256),    # d: 3 slabs, the last ragged; 8-byte rows
    (400, 34, 66, (130, 270), None),        # 4-byte f32 pieces, 4-byte 16-bit pieces
    (333, 100, 90, (100, 0, 150), None),    # 16-bit rows of 200 and 180 bytes: no TMA
    (2000, 192, 400, (700, 0, 900, 400), 768),  # whole 128 x 192 tiles stored by TMA, tails
])
def test_grouped_matmul_matches_plain(cuda, dtype, n, d, h, sizes, max_group):
    gen = torch.Generator().manual_seed(n + d + h)
    lhs, gs, rhs = _gmm_case(gen, n, d, h, sizes, dtype, cuda)
    before = ops.GROUPED_MATMUL_LAUNCH_COUNTS["grouped_matmul"]
    y = ops.grouped_matmul(lhs, gs, rhs, max_group_size=max_group)
    assert ops.GROUPED_MATMUL_LAUNCH_COUNTS["grouped_matmul"] == before + 1
    ref = ops.grouped_matmul_plain(lhs, gs, rhs, max_group_size=max_group)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (n, h)
    assert _rel_err(y, ref) <= GMM_REL_TOL[dtype]
    m_pad = pgm._tiling(n, max_group, 128)[0]
    dropped = ~_group_rows_kept(sizes, m_pad, n).to(cuda)
    assert bool((y[dropped] == 0).all())  # past the frontier or past m_pad: exactly 0


def test_grouped_matmul_unaligned_rows_and_int8_rhs(cuda):
    gen = torch.Generator().manual_seed(11)
    flat = _rand(gen, (60 * 32 + 1,), torch.float32, cuda)
    lhs = flat[1:].view(60, 32)  # contiguous, 4 bytes past a 16-byte boundary
    assert lhs.data_ptr() % 16 != 0
    gs = torch.tensor([25, 0, 30], dtype=torch.int32, device=cuda)
    rhs_q = torch.randint(-127, 128, (3, 32, 40), generator=gen, dtype=torch.int8).to(cuda)
    y = ops.grouped_matmul(lhs, gs, rhs_q)
    ref = ops.grouped_matmul_plain(lhs, gs, rhs_q.float())
    torch.cuda.synchronize()
    assert y.dtype == torch.float32
    assert _rel_err(y, ref) <= GMM_REL_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_grouped_matmul_int8_rhs_16bit(cuda, dtype):
    """An int8 expert slab beside 16-bit rows is cast to their dtype and
    multiplied by the wgmma kernel, within one 16-bit ulp of the plain
    version; dropped rows stay 0."""
    gen = torch.Generator().manual_seed(14)
    lhs = (_rand(gen, (512, 128), torch.float32, cuda) * 0.01).to(dtype)
    gs = torch.tensor([200, 300], dtype=torch.int32, device=cuda)
    rhs_q = torch.randint(-127, 128, (2, 128, 192), generator=gen, dtype=torch.int8).to(cuda)
    y = ops.grouped_matmul(lhs, gs, rhs_q, max_group_size=256)
    ref = ops.grouped_matmul_plain(lhs, gs, rhs_q, max_group_size=256)
    torch.cuda.synchronize()
    assert y.dtype == dtype
    assert _rel_err(y, ref) <= GMM_REL_TOL[dtype]
    dropped = ~_group_rows_kept((200, 300), 256, 512).to(cuda)  # past m_pad 256, past 500
    assert bool((y[dropped] == 0).all())


def test_grouped_matmul_backward_launches_b5_for_dgrad(cuda):
    """Forward and dgrad launch B5; both gradients equal plain autograd
    through the plain version (the ``"reference"`` impl)."""
    gen = torch.Generator().manual_seed(12)
    lhs, gs, rhs = _gmm_case(gen, 200, 48, 72, (60, 0, 90, 30), torch.float32, cuda)
    w = _rand(gen, (200, 72), torch.float32, cuda)
    got = []
    for impl in ("kernel", "reference"):
        ops.set_grouped_matmul_impl(impl)
        try:
            l, r = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
            before = ops.GROUPED_MATMUL_LAUNCH_COUNTS["grouped_matmul"]
            (ops.grouped_matmul(l, gs, r, max_group_size=64) * w).sum().backward()
            launched = ops.GROUPED_MATMUL_LAUNCH_COUNTS["grouped_matmul"] - before
            got.append((l.grad, r.grad))
        finally:
            ops.set_grouped_matmul_impl("auto")
        assert launched == (2 if impl == "kernel" else 0)
    for a, b in zip(*got):
        assert _rel_err(a, b) <= GMM_REL_TOL[torch.float32]


@pytest.mark.parametrize("n,d,h,sizes,max_group", [
    (300, 72, 130, (0, 150, 90, 5), 100),
    (77, 33, 17, (20, 0, 40), None),
    (600, 100, 300, (250, 0, 300), 256),
])
def test_grouped_matmul_3xtf32_kernel_matches_plain(cuda, n, d, h, sizes, max_group):
    """The float32 3xTF32 tensor-core kernel that ``chip_smoke.py`` times
    beside the CUDA-core kernel on the port's path
    (``dl4j_grouped_matmul_3xtf32``), against the plain version."""
    import ctypes

    from deeplearning4j_tpu_torch.ops import cuda_build

    fn = cuda_build.library("grouped_matmul").dl4j_grouped_matmul_3xtf32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(n + h)
    lhs, gs, rhs = _gmm_case(gen, n, d, h, sizes, torch.float32, cuda)
    m_pad = pgm._tiling(n, max_group, 128)[0]
    out = torch.zeros((n, h), device=cuda)
    assert fn(lhs.data_ptr(), gs.data_ptr(), rhs.data_ptr(), out.data_ptr(), n, d, h,
              len(sizes), m_pad, 0, torch.cuda.current_stream().cuda_stream) == 0
    ref = ops.grouped_matmul_plain(lhs, gs, rhs, max_group_size=max_group)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= GMM_REL_TOL[torch.float32]
    dropped = ~_group_rows_kept(sizes, m_pad, n).to(cuda)
    assert bool((out[dropped] == 0).all())


@pytest.mark.parametrize("dtype", ALL)
def test_grouped_matmul_is_deterministic(cuda, dtype):
    """One block owns each output tile, with no atomics: two calls give
    bit-identical outputs."""
    gen = torch.Generator().manual_seed(13)
    lhs, gs, rhs = _gmm_case(gen, 700, 96, 200, (300, 0, 350), dtype, cuda)
    runs = [ops.grouped_matmul(lhs, gs, rhs) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


def test_grouped_matmul_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    lhs = torch.zeros((8, 16), device=cuda)
    gs = torch.tensor([4, 4], dtype=torch.int32, device=cuda)
    rhs = torch.zeros((2, 16, 8), device=cuda)
    with pytest.raises(TypeError):
        ops.grouped_matmul(lhs.int(), gs, rhs.int())
    with pytest.raises(ValueError, match="operands"):
        ops.grouped_matmul(lhs, gs.cpu(), rhs)


# ---------------------------------------------------------------------------
# the decode step's CUDA graph, the int8 seam and the device sampler
# ---------------------------------------------------------------------------


def _small_lm(device):
    from deeplearning4j_tpu_torch.model.zoo import TransformerLM

    return TransformerLM(vocab_size=97, hidden=64, n_layers=2, n_heads=2, max_len=64,
                         seed=4).init(device=device)


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_session_decode_graph_matches_the_eager_step(cuda, impl):
    """``GenerationSession.decode`` runs a carry's first step eagerly, then
    replays a graph of it: the same logits as the uncaptured step on a copy
    of the carry, and the graph's 2 B4 launches counted on each replay
    (none through the materialised-scores seam, which is captured too)."""
    ops.set_attention_impl(impl)
    try:
        _session_graph_case(cuda, impl)
    finally:
        ops.set_attention_impl("auto")


def _session_graph_case(cuda, impl):
    from deeplearning4j_tpu_torch.generate import GenerationSession

    session = GenerationSession(_small_lm(cuda), max_len=64)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 20]
    carry_g, logits, _ = session.prefill(prompts)
    carry_e, _, _ = session.prefill(prompts)
    toks = torch.argmax(logits, dim=-1)
    ops.reset_launch_counts()
    for _ in range(6):
        carry_g, lg = session.decode(carry_g, toks)
        with torch.no_grad():
            le = session.step(carry_e, toks.to(torch.int32))
        assert (lg - le).abs().max().item() <= 1e-6
        toks = torch.argmax(lg, dim=-1)
    n = 2 if impl == "auto" else 0
    assert session._graphs[3].step.launches == ({"flash_decode": n} if n else {})
    assert ops.LAUNCH_COUNTS["flash_decode"] == n * 12  # 6 steps each way
    session.release_graphs()
    assert not session._graphs


def test_engine_step_graph_keeps_greedy_streams_and_counts(cuda):
    from deeplearning4j_tpu_torch.generate import GenerationSession
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import DecodeEngine

    model = _small_lm(cuda)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 20]
    want = GenerationSession(model, max_len=64).generate(prompts, 12)
    for kw in ({}, {"block_size": 8}, {"cache_dtype": "int8"}):
        eng = DecodeEngine(model, max_len=64, slots=4, registry=MetricsRegistry(), **kw)
        turns = []
        eng._step_hook = lambda: turns.append(1)
        try:
            ops.reset_launch_counts()
            handles = [eng.submit(p, max_tokens=12) for p in prompts]
            got = [h.result(timeout=120) for h in handles]
            assert all(h.reason == "completed" for h in handles)
            assert eng._graph is not None and eng._graph.launches == {"flash_decode": 2}
            assert ops.LAUNCH_COUNTS["flash_decode"] == 2 * len(turns)
        finally:
            eng.shutdown()
        if "cache_dtype" not in kw:
            assert got == want


def test_int8_seam_reaches_b4(cuda):
    from deeplearning4j_tpu_torch.nn.layers.attention import quantize_kv_rows

    gen = torch.Generator().manual_seed(8)
    q = _rand(gen, (2, 3, 1, 64), torch.float32, cuda)
    kq, ks = quantize_kv_rows(_rand(gen, (2, 3, 40, 64), torch.float32, cuda))
    vq, vs = quantize_kv_rows(_rand(gen, (2, 3, 40, 64), torch.float32, cuda))
    pos = torch.tensor([5, 39], dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, kq, vq, pos, k_scale=ks, v_scale=vs)
    assert ops.LAUNCH_COUNTS["flash_decode"] == 1
    ref = ops.decode_attention_reference(q, kq.float() * ks[..., None], vq.float() * vs[..., None],
                                         pos)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]


def test_device_sampler_bits_equal_the_cpu_bits(cuda):
    from deeplearning4j_tpu_torch.generate import sampling

    seeds, steps = torch.arange(64) * 977, torch.arange(64) % 7
    for tag in (0, 0x5A, 0x5B):
        cpu = sampling.random_bits(seeds, steps, tag, 33, "cpu")
        assert torch.equal(sampling.random_bits(seeds, steps, tag, 33, cuda).cpu(), cpu)
