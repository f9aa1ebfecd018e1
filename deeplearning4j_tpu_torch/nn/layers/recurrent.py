"""Recurrent layers: LSTM, GravesLSTM, GRU, SimpleRnn, Bidirectional and the
wrappers (port of ``deeplearning4j_tpu/nn/layers/recurrent.py``).

Reference: org.deeplearning4j.nn.conf.layers.{LSTM, GravesLSTM,
GravesBidirectionalLSTM, SimpleRnn}, impl LSTMHelpers.

The whole sequence's input projection is one matrix product
[b*t, nIn] @ [nIn, 4n]; a loop over time then carries (h, c) with only the
[b, n] @ [n, 4n] recurrent product and the gate arithmetic inside. The loop
runs eagerly, one step at a time, on the tensors' device: the JAX
package's ``lax.scan`` has no Pallas kernel, and neither has this loop.

Conventions, as in the JAX package:
* data format [batch, size, time] (NCW)
* gate order in the fused weight columns: [i, f, o, g]
  (input, forget, output, cell input — not PyTorch's [i, f, g, o])
* weights: W [nIn, 4n], RW [n, 4n], b [4n]; GravesLSTM's peepholes are a
  separate P [3, n] (rows pi, pf, po)
* ``forget_gate_bias_init`` default 1.0, on bias columns [n, 2n)
* masked time steps: the state is carried through unchanged and the
  output is zero
* stateful streaming via the carried (h, c): rnnTimeStep and truncated
  BPTT
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch

from ...core.config import register_config
from ...ops import helpers
from ..activations import Activation
from ..input_type import FeedForwardType, InputType, RecurrentType
from ..weights import WeightInit, init_weights, randn
from .base import Layer, LayerContext, Params, State, apply_input_dropout


def _time_major(x_proj: torch.Tensor, mask: Optional[torch.Tensor]):
    """[b, t, k] projections (+ [b, t] mask) -> the loop's time-major inputs."""
    xs = x_proj.transpose(0, 1)
    if mask is None:
        return xs
    return xs, mask.transpose(0, 1).to(x_proj.dtype)


def _lstm_scan(x_proj, rw, h0, c0, mask, gate_act, cell_act, peephole=None):
    """The LSTM recurrence over precomputed ``x_proj`` [b, t, 4n] (= x@W + b).
    Returns (h_seq [b, n, t], h_final, c_final)."""
    n = h0.shape[-1]
    if peephole is not None:
        pi, pf, po = peephole[0], peephole[1], peephole[2]

    def step(carry, inp):
        h, c = carry
        if mask is None:
            xp, m = inp, None
        else:
            xp, m = inp
        z = torch.addmm(xp, h, rw)  # [b, 4n]
        zi, zf, zo, zg = z[:, :n], z[:, n:2 * n], z[:, 2 * n:3 * n], z[:, 3 * n:]
        if peephole is not None:
            zi = zi + pi * c
            zf = zf + pf * c
        i = gate_act(zi)
        f = gate_act(zf)
        g = cell_act(zg)
        c_new = f * c + i * g
        if peephole is not None:
            zo = zo + po * c_new
        o = gate_act(zo)
        h_new = o * cell_act(c_new)
        if m is not None:
            mm = m[:, None]
            c_new = mm * c_new + (1.0 - mm) * c
            h_out = mm * h_new
            h_new = mm * h_new + (1.0 - mm) * h
        else:
            h_out = h_new
        return (h_new, c_new), h_out

    (h_f, c_f), hs = helpers.rnn_sequence(_time_major(x_proj, mask), step, (h0, c0))
    return hs.permute(1, 2, 0), h_f, c_f  # [b, n, t]


def _recurrent_output_type(layer, input_type: InputType) -> InputType:
    ts = input_type.timesteps if isinstance(input_type, RecurrentType) else None
    return RecurrentType(size=layer.n_out, timesteps=ts)


def _with_recurrent_input(layer, input_type: InputType):
    if layer.n_in or not isinstance(input_type, RecurrentType):
        return layer
    return dataclasses.replace(layer, n_in=input_type.size)


def _project(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """[b, nIn, t] input -> [b, t, k] projections x@W + b, as one product."""
    b, n_in, t = x.shape
    xt = x.transpose(1, 2).reshape(b * t, n_in)
    return (xt @ w + bias).reshape(b, t, w.shape[1])


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class LSTMLayer(Layer):
    """Standard LSTM, no peepholes (reference: conf.layers.LSTM)."""

    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0
    gate_activation: Activation = Activation.SIGMOID

    peephole: bool = dataclasses.field(default=False, repr=False)

    def output_type(self, input_type: InputType) -> InputType:
        return _recurrent_output_type(self, input_type)

    def with_input(self, input_type: InputType) -> "LSTMLayer":
        return _with_recurrent_input(self, input_type)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "RW", "b") + (("P",) if self.peephole else ())

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        wi = self.weight_init or WeightInit.XAVIER
        n, n_in = self.n_out, self.n_in
        dist = self.weight_init_distribution
        w = init_weights(gen, (n_in, 4 * n), wi, n_in, 4 * n, dist, dtype, device)
        rw = init_weights(gen, (n, 4 * n), wi, n, 4 * n, dist, dtype, device)
        b = torch.zeros((4 * n,), dtype=dtype, device=device)
        b[n:2 * n] = self.forget_gate_bias_init  # the forget-gate block
        p: Params = {"W": w, "RW": rw, "b": b}
        if self.peephole:
            p["P"] = (0.01 * randn((3, n), gen)).to(device=device, dtype=dtype)
        return p

    def decode_state(self, batch: int, max_len: int, dtype: torch.dtype,
                     device: Optional[torch.device] = None) -> State:
        # the LSTM decode carry is just (h, c): no per-position cache
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype, device=device),
                "c": torch.zeros((batch, self.n_out), dtype=dtype, device=device)}

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        b = x.shape[0]
        x_proj = _project(x, params["W"], params["b"])
        h0, c0 = state.get("h"), state.get("c")
        if h0 is None:
            h0 = torch.zeros((b, self.n_out), dtype=x.dtype, device=x.device)
            c0 = torch.zeros((b, self.n_out), dtype=x.dtype, device=x.device)
        cell_act = self.activation or Activation.TANH
        hs, h_f, c_f = _lstm_scan(x_proj, params["RW"], h0, c0, ctx.mask,
                                  self.gate_activation, cell_act, peephole=params.get("P"))
        return hs, {"h": h_f, "c": c_f}


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class GravesLSTMLayer(LSTMLayer):
    """LSTM with peephole connections per Graves (2013) — reference:
    GravesLSTM, the char-RNN benchmark layer."""

    peephole: bool = dataclasses.field(default=True, repr=False)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class GRULayer(Layer):
    """Gated recurrent unit (Cho 2014), Keras-compatible: fused gate columns
    [z, r, h~]; ``reset_after=True`` (Keras v2 default) applies the reset
    gate after the recurrent product and has a [2, 3n] bias (input row 0,
    recurrent row 1), ``reset_after=False`` before it, with a [3n] bias.
    Masked steps carry h unchanged and output zero."""

    n_in: int = 0
    n_out: int = 0
    reset_after: bool = True
    gate_activation: Activation = Activation.SIGMOID

    def output_type(self, input_type: InputType) -> InputType:
        return _recurrent_output_type(self, input_type)

    def with_input(self, input_type: InputType) -> "GRULayer":
        return _with_recurrent_input(self, input_type)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "RW", "b")

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        wi = self.weight_init or WeightInit.XAVIER
        n, n_in = self.n_out, self.n_in
        dist = self.weight_init_distribution
        w = init_weights(gen, (n_in, 3 * n), wi, n_in, 3 * n, dist, dtype, device)
        rw = init_weights(gen, (n, 3 * n), wi, n, 3 * n, dist, dtype, device)
        b_shape = (2, 3 * n) if self.reset_after else (3 * n,)
        return {"W": w, "RW": rw, "b": torch.zeros(b_shape, dtype=dtype, device=device)}

    def decode_state(self, batch: int, max_len: int, dtype: torch.dtype,
                     device: Optional[torch.device] = None) -> State:
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype, device=device)}

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        b = x.shape[0]
        n = self.n_out
        gate = self.gate_activation
        act = self.activation or Activation.TANH
        bias = params["b"]
        in_bias = bias[0] if self.reset_after else bias
        rec_bias = bias[1] if self.reset_after else None
        x_proj = _project(x, params["W"], in_bias)
        h0 = state.get("h")
        if h0 is None:
            h0 = torch.zeros((b, n), dtype=x.dtype, device=x.device)
        rw = params["RW"]
        mask = ctx.mask

        def step(h, inp):
            if mask is None:
                xp, m = inp, None
            else:
                xp, m = inp
            xz, xr, xh = xp[:, :n], xp[:, n:2 * n], xp[:, 2 * n:]
            if self.reset_after:
                rec = h @ rw + rec_bias  # [b, 3n]
                z = gate(xz + rec[:, :n])
                r = gate(xr + rec[:, n:2 * n])
                hh = act(xh + r * rec[:, 2 * n:])
            else:
                rec_zr = h @ rw[:, :2 * n]
                z = gate(xz + rec_zr[:, :n])
                r = gate(xr + rec_zr[:, n:])
                hh = act(xh + (r * h) @ rw[:, 2 * n:])
            h_new = z * h + (1.0 - z) * hh
            if m is not None:
                mm = m[:, None]
                h_out = mm * h_new
                h_new = mm * h_new + (1.0 - mm) * h
            else:
                h_out = h_new
            return h_new, h_out

        h_f, hs = helpers.rnn_sequence(_time_major(x_proj, mask), step, h0)
        return hs.permute(1, 2, 0), {"h": h_f}


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class SimpleRnnLayer(Layer):
    """Vanilla RNN: h_t = act(x_t W + h_{t-1} RW + b) (reference: SimpleRnn)."""

    n_in: int = 0
    n_out: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return _recurrent_output_type(self, input_type)

    def with_input(self, input_type: InputType) -> "SimpleRnnLayer":
        return _with_recurrent_input(self, input_type)

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        return ("W", "RW", "b")

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        wi = self.weight_init or WeightInit.XAVIER
        n, n_in = self.n_out, self.n_in
        dist = self.weight_init_distribution
        return {
            "W": init_weights(gen, (n_in, n), wi, n_in, n, dist, dtype, device),
            "RW": init_weights(gen, (n, n), wi, n, n, dist, dtype, device),
            "b": torch.full((n,), self.bias_init, dtype=dtype, device=device),
        }

    def decode_state(self, batch: int, max_len: int, dtype: torch.dtype,
                     device: Optional[torch.device] = None) -> State:
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype, device=device)}

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        x = apply_input_dropout(self, x, ctx)
        b = x.shape[0]
        act = self.activation or Activation.TANH
        x_proj = _project(x, params["W"], params["b"])
        h0 = state.get("h")
        if h0 is None:
            h0 = torch.zeros((b, self.n_out), dtype=x.dtype, device=x.device)
        rw = params["RW"]
        mask = ctx.mask

        def step(h, inp):
            if mask is None:
                xp, m = inp, None
            else:
                xp, m = inp
            h_new = act(torch.addmm(xp, h, rw))
            if m is not None:
                mm = m[:, None]
                h_out = mm * h_new
                h_new = mm * h_new + (1.0 - mm) * h
            else:
                h_out = h_new
            return h_new, h_out

        # the JAX layer runs lax.scan directly, outside the helper seam
        h_f, hs = helpers.rnn_loop(_time_major(x_proj, mask), step, h0)
        return hs.permute(1, 2, 0), {"h": h_f}


class BidirectionalMode(enum.Enum):
    CONCAT = "CONCAT"
    ADD = "ADD"
    MUL = "MUL"
    AVERAGE = "AVERAGE"


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class BidirectionalLayer(Layer):
    """Bidirectional wrapper around any recurrent layer (reference:
    conf.layers.recurrent.Bidirectional). GravesBidirectionalLSTM ==
    Bidirectional(GravesLSTM, CONCAT).

    The backward direction runs the layer on the time-reversed input with
    the time-reversed mask, as the JAX package does: for a left-aligned
    mask the reversed sequence starts with its padding."""

    fwd: Optional[Layer] = None
    mode: BidirectionalMode = BidirectionalMode.CONCAT

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.fwd.output_type(input_type)
        if self.mode is BidirectionalMode.CONCAT:
            return RecurrentType(size=inner.size * 2, timesteps=inner.timesteps)
        return inner

    def with_input(self, input_type: InputType) -> "BidirectionalLayer":
        return dataclasses.replace(self, fwd=self.fwd.with_input(input_type))

    def has_params(self) -> bool:
        return True

    def trainable_param_names(self) -> Tuple[str, ...]:
        names = self.fwd.trainable_param_names()
        return tuple(f"f_{n}" for n in names) + tuple(f"b_{n}" for n in names)

    def weight_param_names(self) -> Tuple[str, ...]:
        names = self.fwd.weight_param_names()
        return tuple(f"f_{n}" for n in names) + tuple(f"b_{n}" for n in names)

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        pf = self.fwd.init(gen, dtype, device)
        pb = self.fwd.init(gen, dtype, device)
        out = {f"f_{k}": v for k, v in pf.items()}
        out.update({f"b_{k}": v for k, v in pb.items()})
        return out

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        pf = {k[2:]: v for k, v in params.items() if k.startswith("f_")}
        pb = {k[2:]: v for k, v in params.items() if k.startswith("b_")}
        yf, _ = self.fwd.apply(pf, {}, x, ctx)
        ctx_rev = dataclasses.replace(
            ctx, mask=None if ctx.mask is None else torch.flip(ctx.mask, dims=(1,)))
        yb, _ = self.fwd.apply(pb, {}, torch.flip(x, dims=(2,)), ctx_rev)
        yb = torch.flip(yb, dims=(2,))
        if self.mode is BidirectionalMode.CONCAT:
            y = torch.cat([yf, yb], dim=1)
        elif self.mode is BidirectionalMode.ADD:
            y = yf + yb
        elif self.mode is BidirectionalMode.MUL:
            y = yf * yb
        else:
            y = 0.5 * (yf + yb)
        return y, state


class _Wrapper(Layer):
    """Shape inference, parameters and state of an optional ``underlying``
    layer, shared by the wrappers below."""

    def with_input(self, input_type: InputType):
        if self.underlying is None:
            return self
        return dataclasses.replace(self, underlying=self.underlying.with_input(input_type))

    def has_params(self) -> bool:
        return self.underlying is not None and self.underlying.has_params()

    def trainable_param_names(self) -> Tuple[str, ...]:
        return self.underlying.trainable_param_names() if self.underlying else ()

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        return self.underlying.init(gen, dtype, device) if self.underlying else {}

    def init_state(self, dtype: torch.dtype) -> State:
        return self.underlying.init_state(dtype) if self.underlying else {}


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class LastTimeStepLayer(_Wrapper):
    """Extract the last (unmasked) time step: [b, f, t] -> [b, f]
    (reference: recurrent.LastTimeStep wrapper)."""

    underlying: Optional[Layer] = None

    def output_type(self, input_type: InputType) -> InputType:
        it = self.underlying.output_type(input_type) if self.underlying else input_type
        return FeedForwardType(size=it.size)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        if self.underlying is not None:
            x, state = self.underlying.apply(params, state, x, ctx)
        if ctx.mask is not None:
            lengths = torch.sum(ctx.mask.to(torch.int32), dim=1)
            idx = torch.clamp_min(lengths - 1, 0).long()
            y = torch.gather(x, 2, idx[:, None, None].expand(x.shape[0], x.shape[1], 1))[:, :, 0]
        else:
            y = x[:, :, -1]
        return y, state

    def feed_forward_mask(self, mask, input_type):
        return None


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class MaskZeroLayer(_Wrapper):
    """Sets input time steps whose every feature equals ``mask_value`` to
    zero and masks them downstream (reference: recurrent.MaskZeroLayer)."""

    underlying: Optional[Layer] = None
    mask_value: float = 0.0

    def output_type(self, input_type: InputType) -> InputType:
        return self.underlying.output_type(input_type) if self.underlying else input_type

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        mask = torch.any(x != self.mask_value, dim=1).to(x.dtype)  # [b, t]
        x = x * mask[:, None, :]
        ctx = dataclasses.replace(ctx, mask=mask)
        if self.underlying is None:
            return x, state
        return self.underlying.apply(params, state, x, ctx)


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class TimeDistributedLayer(Layer):
    """Applies a feed-forward layer independently at every time step
    (reference: recurrent.TimeDistributed). [b, f, t] -> [b, f', t]."""

    underlying: Optional[Layer] = None

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.underlying.output_type(FeedForwardType(size=input_type.size))
        return RecurrentType(size=inner.flat_size(), timesteps=input_type.timesteps)

    def with_input(self, input_type: InputType) -> "TimeDistributedLayer":
        return dataclasses.replace(
            self, underlying=self.underlying.with_input(FeedForwardType(size=input_type.size)))

    def has_params(self) -> bool:
        return self.underlying.has_params()

    def trainable_param_names(self) -> Tuple[str, ...]:
        return self.underlying.trainable_param_names()

    def init(self, gen: torch.Generator, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> Params:
        return self.underlying.init(gen, dtype, device)

    def apply(self, params: Params, state: State, x: torch.Tensor,
              ctx: LayerContext) -> Tuple[torch.Tensor, State]:
        b, f, t = x.shape
        flat = x.transpose(1, 2).reshape(b * t, f)
        y, state = self.underlying.apply(params, state, flat,
                                         dataclasses.replace(ctx, mask=None))
        return y.reshape(b, t, -1).transpose(1, 2), state
