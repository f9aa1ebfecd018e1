"""Layer-helper SPI: per-op pluggable implementations (port of
``deeplearning4j_tpu/ops/helpers.py``).

Reference: org.deeplearning4j.nn.layers.LayerHelper and the cuDNN helper
classes consulted before builtin math. An op registers named
implementations, one is active, and layers call the op through
:func:`get_helper`, so a switch reaches every layer without touching it.

Built-in registrations:
  conv2d: "cudnn" (``aten.convolution``: cuDNN on the card, the default) —
          also registered as "xla", the JAX package's name for its fast
          path, so ``set_helper("conv2d", "xla")`` works in both packages —
          and "im2col" (padding, ``F.unfold`` and one matrix product: the
          plain, independent spelling that checks the first).

  lstm:   "scan" (the default) and "unrolled" — the JAX package's names for
          its one compiled loop and its unrolled Python loop. PyTorch runs
          eagerly, so both are a loop over the time-major inputs, one step
          at a time; the names stay so that a selection made for the JAX
          package works here. There is no "cudnn" entry: cuDNN's LSTM has
          no peepholes, another gate order and no masked-step carry.

PyTorch runs eagerly, so a switch has no compiled program to invalidate.

Every convolution of the port goes through :func:`convolution`, which
keeps float32 convolutions in float32: cuDNN may run float32 in TF32
(``torch.backends.cudnn.allow_tf32`` is on by default), which keeps 10
mantissa bits, and the JAX package asks for no reduced precision.
:func:`convolution` turns TF32 off around its forward and its backward.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

_IMPLS: Dict[str, Dict[str, Callable]] = {}
_ACTIVE: Dict[str, str] = {}

Pads = List[Tuple[int, int]]


def register_helper(op: str, name: str, fn: Callable, default: bool = False) -> None:
    """Register an implementation; the first registration for ``op`` (or a
    later one passing ``default=True``) becomes the active choice."""
    _IMPLS.setdefault(op, {})[name] = fn
    if default or op not in _ACTIVE:
        _ACTIVE[op] = name


def set_helper(op: str, name: str) -> None:
    """Select the implementation for ``op`` ("cudnn"/"xla"/"im2col"/...)."""
    if op not in _IMPLS:
        raise ValueError(f"no helpers registered for op {op!r}")
    if name not in _IMPLS[op]:
        raise ValueError(f"unknown helper {name!r} for {op!r}; have {sorted(_IMPLS[op])}")
    _ACTIVE[op] = name


def get_helper(op: str) -> Callable:
    return _IMPLS[op][_ACTIVE[op]]


def helper_name(op: str) -> str:
    return _ACTIVE[op]


def available_helpers(op: str):
    return sorted(_IMPLS.get(op, {}))


# ---------------------------------------------------------------------------
# padding as lax resolves it
# ---------------------------------------------------------------------------

def resolve_pads(padding: Union[str, Sequence[Tuple[int, int]]], spatial: Sequence[int],
                 kernel: Sequence[int], strides: Sequence[int],
                 dilation: Sequence[int]) -> Pads:
    """``padding`` ("SAME", "VALID" or (lo, hi) pairs) as explicit (lo, hi)
    pairs, resolved as lax does: SAME pads ``total // 2`` before and the
    rest after, so a stride-2 SAME window on an even size pads one more
    after than before (ResNet-50's 7x7/2 stem on 224: (2, 3))."""
    if not isinstance(padding, str):
        return [(int(lo), int(hi)) for lo, hi in padding]
    if padding.upper() == "VALID":
        return [(0, 0)] * len(spatial)
    pads = []
    for n, k, s, d in zip(spatial, kernel, strides, dilation):
        eff_k = (k - 1) * d + 1
        out = -(-n // s)
        total = max(0, (out - 1) * s + eff_k - n)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_arg(pads: Pads) -> List[int]:
    """(lo, hi) pairs for the leading spatial dims -> ``F.pad``'s argument
    (last dim first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


# ---------------------------------------------------------------------------
# full-precision convolution
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Convolution(torch.autograd.Function):
    """``aten.convolution`` and its backward, each with cuDNN's TF32 off
    (the backward runs after the forward's context has closed, so it sets
    the flag again itself)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, transposed, output_padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, transposed, output_padding, groups)
        with _no_tf32():
            return torch.ops.aten.convolution(x, w, None, stride, padding, dilation,
                                              transposed, output_padding, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, transposed, output_padding, groups = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, None, stride, padding, dilation, transposed,
                output_padding, groups, mask)
        return gx, gw, None, None, None, None, None, None


def convolution(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int], pads: Pads,
                dilation: Sequence[int], groups: int = 1) -> torch.Tensor:
    """N-d cross-correlation of channels-first ``x`` with ``w`` [O, I/groups,
    *k] under explicit (lo, hi) ``pads``, in the input's precision. The
    symmetric part of the padding goes to the convolution, any excess on
    one side to ``F.pad`` first."""
    sym = [min(lo, hi) for lo, hi in pads]
    extra = [(lo - s, hi - s) for (lo, hi), s in zip(pads, sym)]
    if any(lo or hi for lo, hi in extra):
        x = F.pad(x, pad_arg(extra))
    return _Convolution.apply(x, w, list(strides), sym, list(dilation), False,
                              [0] * len(sym), groups)


def conv_transpose(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
                   padding: Sequence[int], output_padding: Sequence[int],
                   dilation: Sequence[int]) -> torch.Tensor:
    """Transposed convolution (``w`` [I, O, *k], PyTorch's layout) with the
    same TF32 guard as :func:`convolution`."""
    return _Convolution.apply(x, w, list(strides), list(padding), list(dilation), True,
                              list(output_padding), 1)


# ---------------------------------------------------------------------------
# conv2d helpers — signature: (x, w, strides, padding, dilation, dn) -> y
# ``padding`` is "SAME"/"VALID" or (lo, hi) pairs, ``dn`` the data formats
# (("NCHW" | "NHWC"), "OIHW", same as input)
# ---------------------------------------------------------------------------

def _to_nchw(x: torch.Tensor, spec: str) -> torch.Tensor:
    return x if spec == "NCHW" else x.permute(*[spec.index(c) for c in "NCHW"])


def _from_nchw(y: torch.Tensor, spec: str) -> torch.Tensor:
    return y if spec == "NCHW" else y.permute(*["NCHW".index(c) for c in spec])


def _conv2d_cudnn(x, w, strides, padding, dilation, dn):
    in_spec, w_spec, out_spec = dn
    if w_spec != "OIHW":
        w = w.permute(*[w_spec.index(c) for c in "OIHW"])
    x = _to_nchw(x, in_spec)
    pads = resolve_pads(padding, x.shape[2:], w.shape[2:], strides, dilation)
    return _from_nchw(convolution(x, w, strides, pads, dilation), out_spec)


def _conv2d_im2col(x, w, strides, padding, dilation, dn):
    """Patch extraction + one [b*oh*ow, ci*kh*kw] @ [ci*kh*kw, co] product —
    the explicit-GEMM lowering (reference: the builtin im2col path)."""
    in_spec, w_spec, out_spec = dn
    if w_spec != "OIHW":
        w = w.permute(*[w_spec.index(c) for c in "OIHW"])
    x = _to_nchw(x, in_spec)
    n, _, h, wd = x.shape
    co, ci, kh, kw = w.shape
    pads = resolve_pads(padding, (h, wd), (kh, kw), strides, dilation)
    x = F.pad(x, pad_arg(pads))
    cols = F.unfold(x, (kh, kw), dilation=tuple(dilation), stride=tuple(strides))
    eff = [(k - 1) * d + 1 for k, d in zip((kh, kw), dilation)]
    oh = (x.shape[2] - eff[0]) // strides[0] + 1
    ow = (x.shape[3] - eff[1]) // strides[1] + 1
    y = cols.transpose(1, 2) @ w.reshape(co, ci * kh * kw).T  # [n, oh*ow, co]
    return _from_nchw(y.transpose(1, 2).reshape(n, co, oh, ow), out_spec)


register_helper("conv2d", "cudnn", _conv2d_cudnn, default=True)
register_helper("conv2d", "xla", _conv2d_cudnn)
register_helper("conv2d", "im2col", _conv2d_im2col)


def conv2d(x, w, strides, padding, dilation, dn):
    """Layer entry point: dispatch through the active conv2d helper."""
    return get_helper("conv2d")(x, w, strides, padding, dilation, dn)


# ---------------------------------------------------------------------------
# recurrent sequence helpers — signature: (inputs, step_fn, carry) ->
# (carry_final, stacked_outputs). ``inputs`` is a time-major tensor or a
# tuple of them; the cell math (gates, masking, peepholes) stays with the
# layer's step_fn.
# ---------------------------------------------------------------------------

def _time_slices(inputs, t: int):
    if isinstance(inputs, (tuple, list)):
        return type(inputs)(a[t] for a in inputs)
    return inputs[t]


def _n_steps(inputs) -> int:
    return (inputs[0] if isinstance(inputs, (tuple, list)) else inputs).shape[0]


def rnn_loop(inputs, step_fn, carry):
    """Run ``step_fn(carry, inputs[t]) -> (carry, out)`` for every t of the
    time-major ``inputs``; returns the last carry and the outputs stacked
    on a leading time axis (the loop ``lax.scan`` compiles)."""
    outs = []
    for t in range(_n_steps(inputs)):
        carry, out = step_fn(carry, _time_slices(inputs, t))
        outs.append(out)
    return carry, torch.stack(outs, dim=0)


register_helper("lstm", "scan", rnn_loop, default=True)
register_helper("lstm", "unrolled", rnn_loop)


def rnn_sequence(inputs, step_fn, carry):
    """Layer entry point: dispatch through the active lstm helper."""
    return get_helper("lstm")(inputs, step_fn, carry)
