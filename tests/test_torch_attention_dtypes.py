"""The attention kernels' plain versions at the dtypes and head dims the
kernels now take (float16, float64, head dims up to 256), against the JAX
package: its Pallas kernels in interpret mode on the CPU, as its own tests
run them, and its reference spellings. Then a ``TransformerLM`` with head
dim 256 and a float16 ``TransformerLM`` through both packages on the same
model zip. Inputs are made with numpy from a seed and handed to both.

Tolerances, each from the arithmetic compared:
* float32 at d = 256: atol 2e-5 on outputs (as the d <= 128 tests: float32
  sums in another order), gradients rtol 1e-5 with atol 5e-5.
* float16: both sides widen the f16 inputs and sum in float32, then round
  the output to f16, so outputs differ by at most one f16 ulp, 2^-9 at
  |out| < 4 (atol 2e-3). The JAX backward also rounds p and ds to f16
  before its products (its MXU policy), where the plain versions keep them
  float32: gradients within 4 f16 roundings (4 x 2^-11) of the largest
  value.
* float64: the JAX kernels compute in float32 whatever their inputs, so the
  port's float64 plain versions are held against the JAX reference
  spellings in float64 (the tests run JAX with x64), to 1e-10.
* the LMs: rtol 1e-5 / atol 1e-7 on float32 probabilities, gradients rtol
  1e-4 / atol 1e-6 (as ``test_torch_transformer_lm.py`` and
  ``test_torch_training.py``); the float16 LM's probabilities within 1e-2
  of the largest (the two sides round scores, weights and activations to
  float16 at different places, ~2^-11 = 4.9e-4 each, about ten times in
  each of 2 blocks)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo.transformer_lm import TransformerLM as JaxLM

from deeplearning4j_tpu_torch.model import restore_multi_layer_network

jfa = importlib.import_module("deeplearning4j_tpu.ops.flash_attention")
pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

F16_ATOL = 2e-3
F16_GRAD_REL = 4 * 2.0 ** -11
F64_TOL = 1e-10


@pytest.fixture(autouse=True)
def _restore_impls():
    yield
    jfa.set_attention_impl("auto")
    pfa.set_attention_impl("auto")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, tq, tk, d, dv, dtype, masked):
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(2, 2, t, w).astype(dtype)
                  for t, w in ((tq, d), (tk, d), (tk, dv), (tq, dv)))
    mask = None
    if masked:
        mask = (rs.rand(2, tk) > 0.3).astype(np.float32)
        mask[1] = 0.0  # a fully masked batch row
    return q, k, v, g, mask


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_grads(fn, q, k, v, g):
    @jax.jit
    def grads(a, b, c, gg):
        return jax.vjp(fn, a, b, c)[1](gg)

    return [np.asarray(x) for x in grads(*(jnp.asarray(a) for a in (q, k, v, g)))]


CASES = [  # tq, tk, d, dv, causal, masked
    (24, 40, 256, 256, True, True),
    (40, 24, 256, 200, True, False),  # tq > tk: the first rows see no key; dv != d
    (32, 32, 144, 144, False, True),
]


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("tq,tk,d,dv,causal,masked", CASES)
def test_flash_forward_plain_matches_jax_kernel(dtype, tq, tk, d, dv, causal, masked):
    q, k, v, _, mask = _inputs(tq + tk + d, tq, tk, d, dv, dtype, masked)
    jm = None if mask is None else jnp.asarray(mask)
    scale = d ** -0.5
    j_out, j_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, causal,
                                      scale, 16, 16, True, with_lse=True)
    p_out, p_lse = pfa.flash_attention(_t(q), _t(k), _t(v), None if mask is None else _t(mask),
                                       causal=causal, scale=scale, return_lse=True)
    assert p_out.dtype == getattr(torch, dtype)
    assert p_lse.dtype == torch.float32
    atol = F16_ATOL if dtype == "float16" else 2e-5
    np.testing.assert_allclose(p_out.float().numpy(), np.asarray(j_out, np.float32), atol=atol)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), atol=2e-5, rtol=1e-6)
    if masked:
        assert np.all(p_out.float().numpy()[1] == 0.0)
        assert np.all(p_lse.numpy()[1] == 1e30)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("tq,tk,d,dv,causal,masked", CASES)
def test_flash_backward_plain_matches_jax(dtype, tq, tk, d, dv, causal, masked):
    q, k, v, g, mask = _inputs(3 * tq + tk + d, tq, tk, d, dv, dtype, masked)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    scale = d ** -0.5
    jg = _jax_grads(lambda a, b, c: jfa.flash_attention(
        a, b, c, jm, causal, scale, block_q=16, block_k=16, bwd_block_q=8,
        bwd_block_k=8, interpret=True), q, k, v, g)
    out, lse = pfa.flash_attention_plain(_t(q), _t(k), _t(v), tm, causal, scale)
    delta = torch.sum(_t(g).float() * out.float(), dim=-1)
    args = (_t(q), _t(k), _t(v), _t(g), lse, delta, tm, causal, scale)
    plain = [pfa.flash_attention_bwd_dq_plain(*args), *pfa.flash_attention_bwd_dkv_plain(*args)]
    for got, ref in zip(plain, jg):
        assert got.dtype == getattr(torch, dtype)
        if dtype == "float16":
            assert _rel(got.float().numpy(), ref.astype(np.float32)) <= F16_GRAD_REL
        else:
            np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("tq,tk,d,dv,causal,masked", CASES)
def test_float64_plain_versions_match_jax_reference(tq, tk, d, dv, causal, masked):
    """The float64 plain versions of B1, B2 and B3 (what ``flash_f64.cu``
    computes) against the JAX reference spelling and its ``jax.vjp`` in
    float64."""
    q, k, v, g, mask = _inputs(5 * tq + tk + d, tq, tk, d, dv, "float64", masked)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    scale = d ** -0.5
    ref = jfa.mha_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                                      causal, scale)
    assert ref.dtype == jnp.float64
    jg = _jax_grads(lambda a, b, c: jfa.mha_attention_reference(a, b, c, jm, causal, scale),
                    q, k, v, g)
    out, lse = pfa.flash_attention_plain(_t(q), _t(k), _t(v), tm, causal, scale)
    assert out.dtype == lse.dtype == torch.float64
    assert _rel(out.numpy(), ref) <= F64_TOL
    delta = torch.sum(_t(g) * out, dim=-1)
    args = (_t(q), _t(k), _t(v), _t(g), lse, delta, tm, causal, scale)
    plain = [pfa.flash_attention_bwd_dq_plain(*args), *pfa.flash_attention_bwd_dkv_plain(*args)]
    for got, r in zip(plain, jg):
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), r) <= F64_TOL


@pytest.mark.parametrize("dtype", ["float32", "float16", "float64"])
@pytest.mark.parametrize("d", [256, 160])
def test_flash_decode_plain_matches_jax(dtype, d):
    """B4's plain version at head dims above 128: against the JAX decode
    kernel (interpret mode; float32 and float16, where it computes in
    float32 as the port's plain version does) and, in float64, against the
    JAX reference spelling."""
    b, h, L = 5, 2, 48  # L a multiple of the JAX kernel's block (see its padding caveat)
    rs = np.random.RandomState(d)
    q = rs.randn(b, h, 1, d).astype(dtype)
    k, v = (rs.randn(b, h, L, d).astype(dtype) for _ in range(2))
    start = np.array([-1, 0, 17, 40, 47], np.int32)
    p = pfa.flash_decode_attention(_t(q), _t(k), _t(v), _t(start))
    assert p.dtype == getattr(torch, dtype)
    if dtype == "float64":
        ref = jfa.decode_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(start))
        assert _rel(p.numpy(), ref) <= F64_TOL
    else:
        j = jfa.flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(start), block_k=16, interpret=True)
        np.testing.assert_allclose(p.float().numpy(), np.asarray(j, np.float32),
                                   atol=F16_ATOL if dtype == "float16" else 2e-5)
    assert np.all(p.float().numpy()[0] == 0.0)


# ---- TransformerLM through both packages on one zip -------------------------


def _jax_zip(tmp_path, **kw):
    model = JaxLM(seed=7, **kw).init()
    path = str(tmp_path / "lm.zip")
    jax_write(model, path)
    return model, path


def _batch(vocab, b=3, t=16, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, 11:] = 0.0
    mask[2, 5:] = 0.0
    return ids, np.roll(ids, -1, axis=1), mask


@pytest.mark.parametrize("jax_impl,port_impl", [("xla", "auto"), ("flash", "auto")])
def test_head_dim_256_lm_matches_jax(tmp_path, jax_impl, port_impl):
    """``TransformerLM(hidden=256, n_heads=1)``, 2 blocks, t = 16: head dim
    256, past the 128 the kernels took before. ``output()`` with and
    without a key mask, and the gradients."""
    jmodel, path = _jax_zip(tmp_path, vocab_size=40, hidden=256, n_layers=2, n_heads=1,
                            max_len=32)
    port = restore_multi_layer_network(path, device="cpu")
    ids, labels, mask = _batch(40)
    jfa.set_attention_impl(jax_impl)
    pfa.set_attention_impl(port_impl)
    for mk in (None, mask):
        np.testing.assert_allclose(port.output(ids, mask=mk).numpy(),
                                   np.asarray(jmodel.output(ids, mask=mk)), rtol=1e-5,
                                   atol=1e-7)
    jgrad = jax.jit(jax.grad(lambda p, mk: jmodel.loss_pure(
        p, jmodel.state, jnp.asarray(ids), jnp.asarray(labels), rng=None, mask=mk,
        train=True)[0]))
    jg = jgrad(jmodel.params, jnp.asarray(mask))
    pg = port.calculate_gradients(ids, labels, mask=mask)
    for lname, lg in jg.items():
        for pname, arr in lg.items():
            np.testing.assert_allclose(pg[lname][pname].numpy(), np.asarray(arr), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{lname}.{pname}")


@pytest.mark.parametrize("port_impl", ["auto", "reference"])
def test_float16_lm_output_matches_jax(tmp_path, port_impl):
    """A float16 ``TransformerLM`` (2 blocks, head dim 8): ``output()`` with
    and without a key mask, the port's kernel path (the plain B1) and its
    reference spelling against the JAX package in float16."""
    jmodel, path = _jax_zip(tmp_path, vocab_size=40, hidden=16, n_layers=2, n_heads=2,
                            max_len=32, dtype="float16")
    port = restore_multi_layer_network(path, device="cpu")
    assert port.dtype == torch.float16
    ids, _, mask = _batch(40, seed=3)
    pfa.set_attention_impl(port_impl)
    for mk in (None, mask):
        p = port.output(ids, mask=mk)
        j = np.asarray(jmodel.output(ids, mask=mk))
        assert p.dtype == torch.float16 and j.dtype == np.float16
        assert _rel(p.float().numpy(), j.astype(np.float32)) <= 1e-2
