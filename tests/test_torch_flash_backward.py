"""The port's flash backward against the JAX package's: the plain versions of
the dq (B2) and dk/dv (B3) kernels, and the CPU path of the autograd
Function around B1, held against ``jax.vjp`` of the JAX ``flash_attention``
(Pallas forward in interpret mode on the CPU, so its backward is the scan
``_mea_bwd_single``) and of ``mha_attention_reference``. Inputs are made
with numpy from a seed and handed to both.

Tolerance: atol 5e-5 and rtol 1e-5 in float32. Both sides run the same
float32 arithmetic; the JAX side sums block by block (16-row blocks here),
the port over one materialised row, and the gradients reach |10| at these
shapes, where one float32 ulp is ~1e-6."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("deeplearning4j_tpu.ops.flash_attention")
pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

ATOL, RTOL = 5e-5, 1e-5
SCALE = 0.3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, tq, tk, d, dv, masked):
    rs = np.random.RandomState(seed)
    q = rs.randn(2, 2, tq, d).astype(np.float32)
    k = rs.randn(2, 2, tk, d).astype(np.float32)
    v = rs.randn(2, 2, tk, dv).astype(np.float32)
    g = rs.randn(2, 2, tq, dv).astype(np.float32)
    mask = None
    if masked:
        mask = (rs.rand(2, tk) > 0.3).astype(np.float32)
        mask[1] = 0.0  # a fully masked batch row
    return q, k, v, g, mask


def _jax_grads(fn, q, k, v, g):
    @jax.jit
    def grads(a, b, c, gg):
        return jax.vjp(fn, a, b, c)[1](gg)

    return [np.asarray(x) for x in grads(*(jnp.asarray(a) for a in (q, k, v, g)))]


CASES = [  # tq, tk, d, dv, causal, masked
    (16, 16, 8, 8, False, False),
    (16, 16, 8, 8, True, False),
    (40, 40, 8, 8, True, True),
    (40, 40, 8, 8, False, True),
    (16, 40, 8, 8, True, True),    # tq < tk, causal bottom-right aligned
    (40, 40, 8, 12, True, False),  # dv != d
]


@pytest.mark.parametrize("tq,tk,d,dv,causal,masked", CASES)
def test_flash_backward_matches_jax(tq, tk, d, dv, causal, masked):
    q, k, v, g, mask = _inputs(tq + tk + dv, tq, tk, d, dv, masked)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    j_flash = _jax_grads(lambda a, b, c: jfa.flash_attention(
        a, b, c, jm, causal, SCALE, block_q=16, block_k=16, bwd_block_q=16,
        bwd_block_k=16, interpret=True), q, k, v, g)
    j_ref = _jax_grads(lambda a, b, c: jfa.mha_attention_reference(
        a, b, c, jm, causal, SCALE), q, k, v, g)

    # the plain versions of B2 and B3, fed the forward's lse and delta
    out, lse = pfa.flash_attention_plain(_t(q), _t(k), _t(v), tm, causal, SCALE)
    delta = torch.sum(_t(g) * out, dim=-1)
    args = (_t(q), _t(k), _t(v), _t(g), lse, delta, tm, causal, SCALE)
    plain = [pfa.flash_attention_bwd_dq_plain(*args), *pfa.flash_attention_bwd_dkv_plain(*args)]

    # the autograd Function's CPU path
    tq_, tk_, tv_ = (_t(a).requires_grad_() for a in (q, k, v))
    o = pfa.flash_attention(tq_, tk_, tv_, tm, causal, SCALE)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.backward(_t(g))
    function = [tq_.grad, tk_.grad, tv_.grad]

    for mine in (plain, function):
        for got, jf, jr in zip(mine, j_flash, j_ref):
            np.testing.assert_allclose(got.numpy(), jf, atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(got.numpy(), jr, atol=ATOL, rtol=RTOL)
    if masked:  # the fully masked row gets exactly no gradient
        assert np.all(plain[0].numpy()[1] == 0.0)
        assert np.all(plain[1].numpy()[1] == 0.0) and np.all(plain[2].numpy()[1] == 0.0)


def test_function_passes_gradcheck_in_float64():
    rs = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 6, 4)).requires_grad_() for _ in range(3))
    mask = torch.tensor([[1.0, 1.0, 0.0, 1.0, 1.0, 1.0]], dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b, c: pfa.flash_attention(a, b, c, mask, True), (q, k, v))


def test_no_grad_skips_the_function_and_decode_refuses_a_graph():
    q, k, v = (torch.randn(1, 1, 4, 8, requires_grad=True) for _ in range(3))
    with torch.no_grad():
        assert pfa.flash_attention(q, k, v, causal=True).grad_fn is None
    with pytest.raises(RuntimeError, match="no backward"):
        pfa.flash_decode_attention(q[:, :, :1], k, v, torch.tensor([3]))
    with torch.no_grad():
        pfa.flash_decode_attention(q[:, :, :1], k, v, torch.tensor([3]))
