"""The port's sequence-parallel attention against the JAX package's
(``parallel/sequence.py``): ring and Ulysses attention, outputs and the
gradients of ``sum(out**2)`` for q, k and v, with a key mask (one row
masked entirely), causal, and causal across lengths (tq != tk); the
divisibility errors; and the flash plain versions' explicit causal
offset, which the ring's blocks use.

The port's side runs on four gloo CPU ranks spawned once for the module
(``deeplearning4j_tpu_torch/tools/parallel_cases.py``): the flash
wrappers run their plain versions for CPU tensors. The JAX side runs on
the conftest's virtual CPU devices. Float64, 1e-10.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import mha_attention_reference as jax_reference
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmesh
from deeplearning4j_tpu.parallel.sequence import ring_attention as jring
from deeplearning4j_tpu.parallel.sequence import ulysses_attention as julysses

from deeplearning4j_tpu_torch.tools.parallel_cases import result, run_world

pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

TOL = 1e-10
WORLD = 4

#: name: (kind, b, h, tq, tk, d, causal, mask)
CASES = {
    "ring_causal": ("ring", 2, 4, 32, 32, 8, True, False),
    "ring_mask": ("ring", 2, 2, 32, 32, 8, False, True),
    "ring_plain": ("ring", 2, 4, 32, 32, 8, False, False),
    "ring_cross": ("ring", 1, 2, 16, 32, 8, True, False),
    "ring_causal_mask": ("ring", 2, 2, 32, 32, 8, True, True),
    "ulysses_causal": ("ulysses", 2, 4, 32, 32, 8, True, False),
    "ulysses_mask": ("ulysses", 2, 4, 32, 32, 8, False, True),
}


def _inputs(name):
    _, b, h, tq, tk, d, _, masked = CASES[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    out = {"q": rs.randn(b, h, tq, d), "k": rs.randn(b, h, tk, d), "v": rs.randn(b, h, tk, d)}
    if masked:
        mask = (rs.rand(b, tk) > 0.3).astype(np.float64)
        mask[0] = 0.0  # a row of the batch with no valid key at all
        out["mask"] = mask
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sequence"))
    cases = []
    for name, (kind, *_rest) in CASES.items():
        np.savez(f"{d}/{name}.npz", **_inputs(name))
        cases.append(dict(name=name, kind=kind, mesh={"seq": WORLD}, data=f"{d}/{name}.npz",
                          causal=CASES[name][6]))
    rs = np.random.RandomState(0)
    np.savez(f"{d}/bad_len.npz", q=rs.randn(1, 4, 30, 8), k=rs.randn(1, 4, 30, 8),
             v=rs.randn(1, 4, 30, 8))
    np.savez(f"{d}/bad_heads.npz", q=rs.randn(1, 3, 32, 8), k=rs.randn(1, 3, 32, 8),
             v=rs.randn(1, 3, 32, 8))
    cases += [dict(name="ring_bad_len", kind="ring", mesh={"seq": WORLD},
                   data=f"{d}/bad_len.npz"),
              dict(name="ulysses_bad_heads", kind="ulysses", mesh={"seq": WORLD},
                   data=f"{d}/bad_heads.npz")]
    run_world(cases, WORLD, d)
    return d


def _jax(name):
    """The JAX package's ring or Ulysses forward on the virtual devices,
    and its float64 reference attention with the gradients of
    ``sum(out**2)``."""
    kind, *_, causal, _ = CASES[name]
    fn = jring if kind == "ring" else julysses
    mesh = jmesh(seq=WORLD, devices=jax.devices()[:WORLD])
    arr = {k: jnp.asarray(v) for k, v in _inputs(name).items()}
    mask = arr.get("mask")
    out = fn(arr["q"], arr["k"], arr["v"], mask=mask, causal=causal, mesh=mesh)

    def ref(q, k, v):
        return jax_reference(q, k, v, mask=mask, causal=causal)

    r = ref(arr["q"], arr["k"], arr["v"])
    g = jax.grad(lambda q, k, v: jnp.sum(ref(q, k, v) ** 2), argnums=(0, 1, 2))(
        arr["q"], arr["k"], arr["v"])
    return out, r, g


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(world, name):
    """The port against the JAX float64 reference attention (outputs and
    q/k/v gradients to 1e-10) and against the JAX package's own ring or
    Ulysses forward. Its ring computes in float32 whatever the input dtype
    (``_ring_attention_local`` casts q, k and v), so that comparison is to
    float32 rounding, 1e-5 on these O(1) values."""
    r0 = result(world, name, 0)
    for r in range(1, WORLD):
        rr = result(world, name, r)
        for k in r0:
            assert np.array_equal(r0[k], rr[k]), (r, k)
    out, ref, g = _jax(name)
    assert np.max(np.abs(r0["out"] - np.asarray(ref))) <= TOL
    tol = 1e-5 if CASES[name][0] == "ring" else TOL
    assert np.max(np.abs(r0["out"] - np.asarray(out))) <= tol
    if CASES[name][7]:
        assert np.all(r0["out"][0] == 0)  # the fully masked row
    for k, gj in zip(("dq", "dk", "dv"), g):
        assert np.max(np.abs(r0[k] - np.asarray(gj))) <= TOL, k


def test_divisibility_errors_match_jax(world):
    mesh = jmesh(seq=WORLD, devices=jax.devices()[:WORLD])
    q = jnp.zeros((1, 4, 30, 8))
    with pytest.raises(ValueError) as je:
        jring(q, q, q, mesh=mesh)
    assert str(result(world, "ring_bad_len", 0)["error"]) == str(je.value)
    q2 = jnp.zeros((1, 3, 32, 8))
    with pytest.raises(ValueError) as je:
        julysses(q2, q2, q2, mesh=mesh)
    assert str(result(world, "ulysses_bad_heads", 0)["error"]) == str(je.value)


# ---- the explicit causal offset of the flash plain versions ------------------


def _offset_reference(q, k, v, off, scale):
    """softmax with query i seeing keys j <= i + off, materialised in
    float64; fully masked rows output 0."""
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    keep = (np.arange(q.shape[2])[:, None] + off) >= np.arange(k.shape[2])[None, :]
    s = np.where(keep, s, -np.inf)
    m = np.max(s, axis=-1, keepdims=True)
    p = np.where(keep, np.exp(s - np.where(np.isfinite(m), m, 0)), 0.0)
    l = p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bhkd->bhqd", p / np.where(l > 0, l, 1), v)
    return out, l[..., 0] > 0


@pytest.mark.parametrize("off", [-20, -5, 0, 3, 16, 40])
def test_plain_forward_with_offset(off):
    rs = np.random.RandomState(off + 50)
    q, k, v = rs.randn(1, 2, 16, 8), rs.randn(1, 2, 24, 8), rs.randn(1, 2, 24, 8)
    out, lse = pfa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), None, True,
                                         None, causal_offset=off)
    ref, any_key = _offset_reference(q, k, v, off, 8 ** -0.5)
    assert np.max(np.abs(out.numpy() - ref)) <= TOL
    assert np.all(lse.numpy()[~any_key] == 1e30)


def test_default_offset_is_bottom_right():
    rs = np.random.RandomState(7)
    args = [torch.from_numpy(rs.randn(1, 2, n, 8)) for n in (12, 20, 20)]
    g = torch.from_numpy(rs.randn(1, 2, 12, 8))
    a = pfa.flash_attention_plain(*args, None, True)
    b = pfa.flash_attention_plain(*args, None, True, causal_offset=8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    da = pfa.flash_attention_bwd(*args, a[0], a[1], g, None, True)
    db = pfa.flash_attention_bwd(*args, a[0], a[1], g, None, True, causal_offset=8)
    assert all(torch.equal(x, y) for x, y in zip(da, db))


@pytest.mark.parametrize("off", [-6, 0, 5, 30])
def test_plain_backward_with_offset_matches_autograd(off):
    rs = np.random.RandomState(off + 90)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, n, 8)).requires_grad_() for n in (12, 20, 20))
    g = torch.from_numpy(rs.randn(1, 2, 12, 8))
    out, lse = pfa.flash_attention_plain(q, k, v, None, True, causal_offset=off)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    got = pfa.flash_attention_bwd(q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), g,
                                  None, True, causal_offset=off)
    for a, b in zip(got, (dq, dk, dv)):
        assert float((a - b).abs().max()) <= TOL
