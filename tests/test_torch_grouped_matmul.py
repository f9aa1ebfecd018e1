"""The port's grouped expert matmul (``deeplearning4j_tpu_torch.ops.grouped_matmul``,
on the CPU its plain version) against the JAX package's two spellings: the
masked XLA ``grouped_matmul_reference`` and the Pallas kernel
``_gmm_pallas`` in interpret mode, on the same seeded numpy inputs. The
cases are those of ``tests/test_grouped_matmul.py``: uneven, empty and full
groups, rows past the frontier, the ``m_pad`` rounding of
``max_group_size``, bf16 with f32 accumulation and an int8 ``rhs``.

Tolerances: 1e-5 in float32 (the same products summed in another order);
one bf16 ulp relative to the largest value in bfloat16 (both sides sum the
exact products of bf16 inputs in float32 and round once, so only a sum that
lands next to a rounding boundary can differ); 1e-10 for float64 values and
gradients (float64 sums in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import grouped_matmul as jax_gmm
from deeplearning4j_tpu.ops import grouped_matmul_reference as jax_gmm_ref
from deeplearning4j_tpu.ops.grouped_matmul import _gmm_pallas, _tiling as jax_tiling

from deeplearning4j_tpu_torch import ops

pgm = importlib.import_module("deeplearning4j_tpu_torch.ops.grouped_matmul")

BF16_REL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _restore_impl():
    yield
    ops.set_grouped_matmul_impl("auto")


def _case(seed=0, e=4, d=8, h=16, n=40, sizes=(7, 0, 12, 5), dtype=np.float32):
    """lhs rows sorted by group; sum(sizes) < n leaves rows past the frontier."""
    rs = np.random.RandomState(seed)
    lhs = rs.randn(n, d).astype(dtype)
    rhs = rs.randn(e, d, h).astype(dtype)
    return lhs, np.asarray(sizes, np.int32), rhs


def _jax_both(lhs, gs, rhs, max_group):
    """(reference, Pallas kernel in interpret mode) of the JAX package."""
    jl, jg, jr = jnp.asarray(lhs), jnp.asarray(gs), jnp.asarray(rhs)
    ref = jax_gmm_ref(jl, jg, jr, max_group_size=max_group)
    m_pad, bm = jax_tiling(lhs.shape[0], max_group, 128)
    pallas = _gmm_pallas(jl, jr, jg, m_pad, bm, interpret=True)
    return np.asarray(ref), np.asarray(pallas)


_CASES = {
    "uneven": (dict(seed=0), None),
    "empty_and_full": (dict(seed=1, e=3, sizes=(0, 0, 6), n=6), None),
    "tail_past_frontier": (dict(seed=2, sizes=(3, 9, 0, 4), n=30), 16),
    # max_group_size 10 -> bm 16, m_pad 16: local rows 10..15 kept, 16.. dropped
    "m_pad_10": (dict(seed=3, e=3, sizes=(20, 4, 11), n=40), 10),
    # max_group_size 130 -> bm 128, m_pad 256: rows up to 255 kept
    "m_pad_130": (dict(seed=4, e=2, d=4, h=8, sizes=(270, 20), n=300), 130),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_matches_jax_reference_and_pallas(name):
    kw, max_group = _CASES[name]
    lhs, gs, rhs = _case(**kw)
    ref, pallas = _jax_both(lhs, gs, rhs, max_group)
    y = ops.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(gs),
                           torch.from_numpy(rhs), max_group_size=max_group)
    assert y.dtype == torch.float32 and tuple(y.shape) == ref.shape
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), pallas, rtol=1e-5, atol=1e-5)
    # rows past the frontier are exactly 0
    np.testing.assert_array_equal(y.numpy()[int(gs.sum()):], 0.0)


@pytest.mark.parametrize("max_group,kept", [(10, 16), (130, 256)])
def test_m_pad_rounding_keeps_rows_up_to_m_pad(max_group, kept):
    assert pgm._tiling(300, max_group, 128)[0] == jax_tiling(300, max_group, 128)[0] == kept
    lhs, gs, rhs = _case(seed=5, e=2, d=4, h=8, sizes=(280, 10), n=300)
    y = ops.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(gs),
                           torch.from_numpy(rhs), max_group_size=max_group).numpy()
    group0 = y[:280]
    assert np.all(np.abs(group0[max_group:kept]).max(axis=1) > 0)  # past the bound, kept
    np.testing.assert_array_equal(group0[kept:], 0.0)              # past m_pad, dropped
    np.testing.assert_allclose(y[280:290], lhs[280:290] @ rhs[1], rtol=1e-5, atol=1e-5)


def test_bf16_accumulates_in_f32():
    lhs, gs, rhs = _case(seed=6, n=32, d=64, sizes=(10, 6, 9, 7))
    lb, rb = (jnp.asarray(a, jnp.bfloat16) for a in (lhs, rhs))
    ref = np.asarray(jax_gmm_ref(lb, jnp.asarray(gs), rb), np.float32)
    y = ops.grouped_matmul(torch.from_numpy(lhs).bfloat16(), torch.from_numpy(gs),
                           torch.from_numpy(rhs).bfloat16())
    assert y.dtype == torch.bfloat16
    err = np.abs(y.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= BF16_REL
    # a bf16 accumulation would miss the exact f32 sum by far more
    exact = np.asarray(np.asarray(lb, np.float32), np.float64)
    naive = np.zeros_like(ref, dtype=np.float64)
    start = 0
    for e_, s in enumerate(gs):
        naive[start:start + s] = exact[start:start + s] @ np.asarray(rb, np.float64)[e_]
        start += s
    assert np.abs(y.float().numpy() - naive).max() / np.abs(naive).max() <= BF16_REL


def test_int8_rhs_is_cast_to_lhs_dtype():
    lhs, gs, _ = _case(seed=7)
    rhs_q = np.random.RandomState(8).randint(-127, 128, (4, 8, 16)).astype(np.int8)
    ref = np.asarray(jax_gmm(jnp.asarray(lhs), jnp.asarray(gs), jnp.asarray(rhs_q)))
    y = ops.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(gs),
                           torch.from_numpy(rhs_q))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("max_group", [None, 16, 10])
@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_f64_vjp_matches_jax_grad(max_group, impl):
    """The custom backward (``auto``: dgrad through the op again, wgrad over
    padded tiles) and plain autograd of the plain version (``reference``)
    against ``jax.grad`` of the JAX reference."""
    lhs, gs, rhs = _case(seed=9, sizes=(7, 0, 14, 5), dtype=np.float64)
    g = np.random.RandomState(10).randn(lhs.shape[0], rhs.shape[-1])

    def loss(l, r):
        return jnp.sum(jax_gmm_ref(l, jnp.asarray(gs), r, max_group_size=max_group)
                       * jnp.asarray(g))

    jdl, jdr = jax.grad(loss, argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    ops.set_grouped_matmul_impl(impl)
    tl, tr = (torch.from_numpy(a.copy()).requires_grad_() for a in (lhs, rhs))
    y = ops.grouped_matmul(tl, torch.from_numpy(gs), tr, max_group_size=max_group)
    pdl, pdr = torch.autograd.grad(torch.sum(y * torch.from_numpy(g)), (tl, tr))
    np.testing.assert_allclose(pdl.numpy(), np.asarray(jdl), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(pdr.numpy(), np.asarray(jdr), rtol=1e-10, atol=1e-10)


def test_seam_validates_and_counts_no_cpu_launch():
    assert ops.grouped_matmul_impl() == "auto"
    with pytest.raises(ValueError, match="unknown grouped_matmul"):
        ops.set_grouped_matmul_impl("cudnn")
    lhs, gs, rhs = (torch.from_numpy(a) for a in _case(seed=11))
    before = ops.GROUPED_MATMUL_LAUNCH_COUNTS["grouped_matmul"]
    auto = ops.grouped_matmul(lhs, gs, rhs)
    ops.set_grouped_matmul_impl("reference")
    torch.testing.assert_close(ops.grouped_matmul(lhs, gs, rhs), auto, rtol=0, atol=0)
    ops.set_grouped_matmul_impl("kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.grouped_matmul(lhs, gs, rhs)
    # CPU calls run the plain version: no kernel launch is counted
    assert ops.GROUPED_MATMUL_LAUNCH_COUNTS["grouped_matmul"] == before
    ops.reset_launch_counts()
    assert ops.GROUPED_MATMUL_LAUNCH_COUNTS == {"grouped_matmul": 0}


def test_shape_validation():
    lhs, gs, rhs = (torch.from_numpy(a) for a in _case())
    with pytest.raises(ValueError):
        ops.grouped_matmul(lhs, gs, rhs[:, :5])   # d mismatch
    with pytest.raises(ValueError):
        ops.grouped_matmul(lhs, gs[:2], rhs)      # E mismatch
    with pytest.raises(ValueError):
        ops.grouped_matmul(lhs[None], gs, rhs)    # lhs not 2-D
