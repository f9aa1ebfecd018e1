"""The port's attention (the plain versions of the flash forward and decode
kernels, the reference spellings, and the helper seam) against the JAX
package's: the Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them. Inputs are made with numpy from a seed and
handed to both.

Tolerance: atol 2e-5 in float32, as the JAX package's flash-vs-reference
tests use; the two sides sum in different orders (block-wise online
softmax on the JAX side, one materialised row on the port's)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules (each package's ops/__init__ exports a function of this name)
jfa = importlib.import_module("deeplearning4j_tpu.ops.flash_attention")
pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

ATOL = 2e-5


def _qkv(seed, b, h, tq, tk, d):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, t, d).astype(np.float32) for t in (tq, tk, tk)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _restore_impl():
    yield
    pfa.set_attention_impl("auto")


@pytest.mark.parametrize("tq,tk,causal,masked", [
    (64, 64, False, False),
    (64, 64, True, False),
    (40, 72, True, True),    # tq < tk, causal bottom-right aligned
    (72, 40, True, False),   # tq > tk: the first rows see no key at all
    (48, 96, False, True),
])
def test_flash_forward_plain_matches_jax_kernel(tq, tk, causal, masked):
    q, k, v = _qkv(0, 2, 3, tq, tk, 16)
    mask = None
    if masked:
        mask = (np.random.RandomState(1).rand(2, tk) > 0.3).astype(np.float32)
        mask[1] = 0.0  # a fully masked batch row
    jm = None if mask is None else jnp.asarray(mask)
    j_out, j_lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, causal,
        0.25, 32, 32, True, with_lse=True)
    j_ref = jfa.mha_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jm, causal, 0.25)
    p_out, p_lse = pfa.flash_attention(_t(q), _t(k), _t(v),
                                       None if mask is None else _t(mask),
                                       causal=causal, scale=0.25, return_lse=True)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_ref), atol=ATOL)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), atol=ATOL, rtol=1e-6)
    if masked:
        assert np.all(p_out.numpy()[1] == 0.0)
        assert np.all(p_lse.numpy()[1] == 1e30)
    if causal and tq > tk:
        assert np.all(p_out.numpy()[:, :, : tq - tk] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_matches_jax(causal):
    q, k, v = _qkv(2, 2, 2, 24, 24, 8)
    mask = np.ones((2, 24), np.float32)
    mask[0, 17:] = 0.0
    j = jfa.mha_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(mask), causal)
    p = pfa.mha_attention_reference(_t(q), _t(k), _t(v), _t(mask), causal)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=ATOL)


def test_flash_decode_plain_matches_jax_kernel():
    b, h, L, d = 5, 3, 40, 16
    q = np.random.RandomState(3).randn(b, h, 1, d).astype(np.float32)
    _, k, v = _qkv(4, b, h, 1, L, d)
    start = np.array([-1, 0, 17, 33, 39], np.int32)
    j = jfa.flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(start), block_k=16, interpret=True)
    j_ref = jfa.decode_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(start))
    p = pfa.flash_decode_attention(_t(q), _t(k), _t(v), _t(start))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=ATOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(j_ref), atol=ATOL)
    assert np.all(p.numpy()[0] == 0.0)  # start_pos -1: no valid key
    # start_pos 0 attends the first key alone: its value row comes back
    np.testing.assert_allclose(p.numpy()[1, :, 0], v[1, :, 0], atol=1e-6)


def decode_split_combine(q, k, v, start_pos, scale, n_split):
    """The decode kernel's chunk-and-combine (``csrc/flash_decode.cu``), in
    float32 on the CPU: block r of a row's cluster of ``n_split`` takes the
    r-th chunk of ceil(length / n_split) live keys, keeps its partial
    ``(max, sum, accumulator)``, and rank 0 merges the partials in rank
    order, a partial with no live key weighted 0."""
    b, h, _, d = q.shape
    L = k.shape[2]
    out = torch.zeros(b, h, v.shape[-1])
    for bi in range(b):
        length = max(0, min(int(start_pos[bi]) + 1, L))
        chunk = -(-length // n_split)
        parts = []
        for r in range(n_split):
            c0 = min(r * chunk, length)
            c1 = min(c0 + chunk, length)
            if c0 == c1:
                parts.append((torch.full((h,), -1e30), torch.zeros(h), torch.zeros(h, v.shape[-1])))
                continue
            s = (q[bi, :, 0] * scale)[:, None, :].matmul(k[bi, :, c0:c1].transpose(-1, -2))[:, 0]
            m = s.amax(-1)
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(-1), p[:, None, :].matmul(v[bi, :, c0:c1])[:, 0]))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = torch.zeros(h, v.shape[-1]), torch.zeros(h)
        for m, l, acc in parts:  # rank order
            w = torch.where(m > -0.5e30, torch.exp(m - mx), torch.zeros_like(m))
            num, den = num + w[:, None] * acc, den + w * l
        out[bi] = num / torch.clamp_min(den, 1e-30)[:, None]
    return out[:, :, None, :]


@pytest.mark.parametrize("n_split", range(1, 9))
def test_decode_chunk_and_combine_matches_jax_kernel(n_split):
    """B4's split over up to 8 blocks a row, emulated, against the JAX
    decode kernel in interpret mode: empty chunks (3 live keys over up to 8
    blocks), no live key at all (start_pos -1: 0, not NaN), start_pos past
    the cache (every position), and chunks of uneven live length. L is a
    multiple of the JAX kernel's block: past L it pads the cache with zero
    keys, which a start_pos >= L would then count as live."""
    b, h, L, d = 6, 2, 48, 16
    q = np.random.RandomState(10).randn(b, h, 1, d).astype(np.float32)
    _, k, v = _qkv(11, b, h, 1, L, d)
    start = np.array([-1, 0, 2, 17, 47, 50], np.int32)
    j = jfa.flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(start), block_k=16, interpret=True)
    got = decode_split_combine(_t(q), _t(k), _t(v), _t(start), d ** -0.5, n_split)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(j), atol=ATOL)
    assert np.all(got.numpy()[0] == 0.0)


def test_decode_reference_multi_row_matches_jax():
    b, h, L, d = 3, 2, 32, 8
    q = np.random.RandomState(5).randn(b, h, 6, d).astype(np.float32)
    _, k, v = _qkv(6, b, h, 1, L, d)
    start = np.array([0, 9, 26], np.int32)
    j = jfa.decode_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(start))
    pfa.set_attention_impl("flash")  # tq > 1 never takes the kernel
    p = pfa.decode_attention(_t(q), _t(k), _t(v), _t(start))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=ATOL)


def test_seam_flash_on_cpu_raises_instead_of_falling_back():
    q, k, v = (_t(a) for a in _qkv(7, 1, 2, 8, 8, 8))
    pfa.set_attention_impl("flash")
    with pytest.raises(RuntimeError, match="CUDA"):
        pfa.mha_attention(q, k, v, causal=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        pfa.decode_attention(q[:, :, :1], k, v, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        pfa.set_attention_impl("xla")


def test_seam_routes_auto_and_reference():
    q, k, v = (_t(a) for a in _qkv(8, 1, 2, 8, 8, 8))
    pfa.set_attention_impl("reference")
    assert pfa.attention_impl() == "reference"
    ref = pfa.mha_attention(q, k, v, causal=True)
    pfa.set_attention_impl("auto")
    auto = pfa.mha_attention(q, k, v, causal=True)
    torch.testing.assert_close(auto, ref, atol=ATOL, rtol=0)
    # CPU calls run the plain versions: no kernel launch is counted
    assert pfa.LAUNCH_COUNTS == {"flash_forward": 0, "flash_bwd_dq": 0,
                                 "flash_bwd_dkv": 0, "flash_decode": 0}
