"""MultiLayerNetwork — the sequential-stack model (port of
``deeplearning4j_tpu/nn/sequential.py``: inference, gradients and ``fit``).

The network is an ``nn.Module`` holding one :class:`LayerModule` per layer,
registered under the layer's name, so ``state_dict`` keys read
``layer_2.Wq`` as the JAX package's param pytree does.

State model, as in the JAX package:
* ``params``    — {layer_name: {param_name: tensor}} (live ``nn.Parameter``s)
* ``state``     — persistent non-trainable state per layer
* ``rnn_state`` — the transient carry: the recurrent (h, c) of
                  :meth:`rnn_time_step` and truncated BPTT, the
                  incremental-decode KV caches and positions; threaded
                  through :meth:`forward_pure`'s ``rnn_state``, never
                  carried across ``fit`` batches

With ``compute_dtype`` set (``"bfloat16"``), the forward and backward run
in that dtype on cast copies of the parameters, which stay in ``dtype``
(the master weights); regularization reads the master parameters, the
score is at least float32 and ``output()`` returns ``dtype``. With
``gradient_checkpointing``, each layer of a training forward runs under
``torch.utils.checkpoint`` (``layers.base.apply_layer``).

PyTorch runs eagerly, so there is no jitted program per entry point; the
inference entry points run under ``torch.inference_mode``, and training
(``fit``, ``calculate_gradients``) records the autograd graph outside it.
The model lives on ``device`` (default: the current CUDA device; pass
``device="cpu"`` to run on the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.dtypes import as_input, cast_floats, default_device, to_numpy, torch_dtype
from ..core.listeners import ListenerBus, TrainingListener
from ..core.rng import RngState
from .conf import MultiLayerConfiguration
from .input_type import RecurrentType
from .layers.base import Layer, LayerContext, LayerModule, apply_layer
from .layers.output import BaseOutputLayer


def _layer_reg_score(layer: Layer, params: Dict[str, torch.Tensor],
                     score_dtype: torch.dtype) -> torch.Tensor:
    """l1/l2 regularization contribution (reference: calcRegularizationScore)."""
    device = next(iter(params.values())).device
    score = torch.zeros((), dtype=score_dtype, device=device)
    weight_names = set(layer.weight_param_names())
    for name, arr in params.items():
        is_weight = name in weight_names
        l1 = layer.l1 if is_weight else layer.l1_bias
        l2 = layer.l2 if is_weight else layer.l2_bias
        if l1:
            score = score + l1 * torch.sum(torch.abs(arr)).to(score_dtype)
        if l2:
            score = score + 0.5 * l2 * torch.sum(torch.square(arr)).to(score_dtype)
    return score


def grads_of(score: torch.Tensor, params: Dict[str, Dict[str, torch.Tensor]]
             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``d score / d params`` in the params' ``{layer: {param: tensor}}``
    layout (every layer present, as ``jax.grad`` gives it); a parameter the
    score does not reach gets zeros."""
    names = [(l, k) for l, lp in params.items() for k in lp]
    flat = torch.autograd.grad(score, [params[l][k] for l, k in names], allow_unused=True)
    grads: Dict[str, Dict[str, torch.Tensor]] = {l: {} for l in params}
    for (l, k), g in zip(names, flat):
        grads[l][k] = torch.zeros_like(params[l][k]) if g is None else g
    return grads


class MultiLayerNetwork(nn.Module):
    def __init__(self, conf: MultiLayerConfiguration,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__()
        self.conf = conf
        self.layers: Tuple[Layer, ...] = conf.layers
        if not self.layers:
            raise ValueError("Configuration has no layers")
        self.device = default_device(device)
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.rnn_state: Dict[str, Dict[str, torch.Tensor]] = {}
        self._persistent_keys: Dict[str, Tuple[str, ...]] = {}
        self.listeners = ListenerBus()
        self.iteration_count = 0
        self.epoch_count = 0
        self.last_batch_size = 0
        self.score_value = float("nan")
        # the dropout stream: a checkpoint carries its position (state_dict)
        self._rng = RngState(conf.seed)
        self._trainer = None
        self._initialized = False

    # ------------------------------------------------------------------ init
    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.conf.dtype)

    def keeps_int_input(self) -> bool:
        """True when the first layer consumes integer indices (embedding)."""
        return bool(self.layers) and getattr(self.layers[0], "consumes_indices", False)

    def _to_compute(self, params, x):
        """Mixed-precision boundary: params and input cast to
        ``compute_dtype`` while the master params stay in ``dtype``. A no-op
        when ``compute_dtype`` is unset or equals ``dtype``; idempotent."""
        cd = self.conf.compute_dtype
        if not cd or torch_dtype(cd) == self.dtype:
            return params, x
        return cast_floats(params, cd), cast_floats(x, cd)

    def layer_names(self) -> List[str]:
        return [self.conf.layer_name(i) for i in range(len(self.layers))]

    def named_param_layers(self) -> List[Tuple[str, Layer]]:
        """(name, layer) pairs for layers holding trainable params — the
        updater-block boundaries (used by the Solver's LayerOptimizers)."""
        return [(self.conf.layer_name(i), l) for i, l in enumerate(self.layers)
                if l.has_params()]

    def _next_generator(self) -> torch.Generator:
        """A fresh CPU generator for one training step's dropout draws; the
        model's own stream (seeded from the config's seed) advances once
        per step."""
        return self._rng.next_key()

    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Build every layer's parameters from one CPU ``torch.Generator``
        seeded with ``seed`` (default: the config's seed), drawn layer by
        layer in order and placed on the model's device."""
        gen = torch.Generator().manual_seed(self.conf.seed if seed is None else seed)
        dtype = self.dtype
        self.state, self._persistent_keys = {}, {}
        for i, layer in enumerate(self.layers):
            name = self.conf.layer_name(i)
            params = layer.init(gen, dtype, self.device) if layer.has_params() else {}
            self.add_module(name, LayerModule(layer, params))
            st = {k: v.to(self.device) for k, v in layer.init_state(dtype).items()}
            self.state[name] = st
            self._persistent_keys[name] = tuple(st.keys())
        self.rnn_state = {}
        self._trainer = None
        self._initialized = True
        return self

    def _check_init(self) -> None:
        if not self._initialized:
            self.init()

    def migrate_state(self) -> None:
        """Fill persistent-state keys that a layer's ``init_state`` defines
        but the state lacks (a state restored from an older version, such
        as an MoE layer's counters), with their defaults; existing values
        (batch norm's running statistics) stay."""
        if not self._initialized:
            return
        for i, layer in enumerate(self.layers):
            defaults = layer.init_state(self.dtype)
            if not defaults:
                continue
            name = self.conf.layer_name(i)
            cur = dict(self.state.get(name, {}))
            missing = [k for k in defaults if k not in cur]
            if missing:
                for k in missing:
                    cur[k] = defaults[k].to(self.device)
                self.state[name] = cur
                self._persistent_keys[name] = tuple(cur.keys())

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{layer_name: {param_name: nn.Parameter}} — live views."""
        return {name: getattr(self, name).params() for name in self.layer_names()}

    # -------------------------------------------------------------- forward
    def forward_pure(
        self,
        params: Dict[str, Dict[str, torch.Tensor]],
        state: Dict[str, Dict[str, torch.Tensor]],
        x: torch.Tensor,
        *,
        train: bool = False,
        rng: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
        rnn_state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        upto: Optional[int] = None,
        collect: bool = False,
    ):
        """Forward through layers [0, upto). Returns (out, new_state,
        new_rnn_state), and with ``collect`` each layer's output as a fourth
        element. Decode caches in ``rnn_state`` are written in place."""
        params, x = self._to_compute(params, x)
        remat = self.conf.gradient_checkpointing and train
        new_state: Dict[str, Dict[str, torch.Tensor]] = {}
        new_rnn: Dict[str, Dict[str, torch.Tensor]] = {}
        acts: List[torch.Tensor] = []
        cur_mask = mask
        n = len(self.layers) if upto is None else upto
        it = self.conf.input_type
        for i in range(n):
            layer = self.layers[i]
            name = self.conf.layer_name(i)
            lstate = dict(state.get(name, {}))
            if rnn_state is not None and name in rnn_state:
                lstate.update(rnn_state[name])
            ctx = LayerContext(train=train, rng=rng, mask=cur_mask)
            y, lstate_out = apply_layer(layer, params.get(name, {}), lstate, x, ctx,
                                        remat=remat)
            persistent = self._persistent_keys.get(name, ())
            new_state[name] = {k: v for k, v in lstate_out.items() if k in persistent}
            transient = {k: v for k, v in lstate_out.items() if k not in persistent}
            if transient:
                new_rnn[name] = transient
            if it is not None:
                cur_mask = layer.feed_forward_mask(cur_mask, it)
                it = layer.output_type(it)
            x = y
            if collect:
                acts.append(y)
        if collect:
            return x, new_state, new_rnn, acts
        return x, new_state, new_rnn

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out, _, _ = self.forward_pure(self.params, self.state, x, mask=mask)
        return out

    def _input(self, x) -> torch.Tensor:
        return as_input(x, self.dtype, self.keeps_int_input(), self.device)

    def _mask(self, mask) -> Optional[torch.Tensor]:
        if mask is None:
            return None
        return as_input(mask, self.dtype, False, self.device)

    def loss_pure(self, params, state, x, labels, *, rng=None, mask=None,
                  label_mask=None, rnn_state=None, train: bool = True):
        """Score = loss + regularization (reference: computeGradientAndScore).
        Returns (score, (new_state, new_rnn_state))."""
        out_layer = self.layers[-1]
        if not isinstance(out_layer, BaseOutputLayer):
            raise ValueError("Last layer must be an output/loss layer to compute a score")
        # regularization reads the master (uncast) params; the compute-dtype
        # cast applies to the forward math only
        master_params = params
        params, x = self._to_compute(params, x)
        feat, new_state, new_rnn = self.forward_pure(
            params, state, x, train=train, rng=rng, mask=mask,
            rnn_state=rnn_state, upto=len(self.layers) - 1)
        cur_mask = mask
        it = self.conf.input_type
        if it is not None and cur_mask is not None:
            for i in range(len(self.layers) - 1):
                cur_mask = self.layers[i].feed_forward_mask(cur_mask, it)
                it = self.layers[i].output_type(it)
        name = self.conf.layer_name(len(self.layers) - 1)
        ctx = LayerContext(train=train, rng=rng, mask=cur_mask)
        loss = out_layer.compute_loss(params.get(name, {}), feat, labels, ctx,
                                      label_mask=label_mask)
        new_state[name] = dict(state.get(name, {}))
        score_dtype = torch.promote_types(self.dtype, torch.float32)
        score = loss.to(score_dtype)
        for i, layer in enumerate(self.layers):
            lname = self.conf.layer_name(i)
            lparams = master_params.get(lname)
            if lparams:
                score = score + _layer_reg_score(layer, lparams, score_dtype)
            # MoE load-balance aux loss (GShard): the layer computed this
            # batch's term in its forward and left it in its state
            bl_w = getattr(layer, "balance_loss_weight", 0.0)
            if bl_w:
                aux = new_state.get(lname, {}).get("aux_load_balance")
                if aux is not None:
                    score = score + bl_w * aux.to(score_dtype)
        return score, (new_state, new_rnn)

    # -------------------------------------------------------------- user API
    def output(self, x, mask=None) -> torch.Tensor:
        """Inference forward (reference: MultiLayerNetwork.output)."""
        self._check_init()
        with torch.inference_mode():
            out, _, _ = self.forward_pure(self.params, self.state, self._input(x),
                                          mask=self._mask(mask))
        return out.to(self.dtype)

    def feed_forward(self, x, train: bool = False, mask=None) -> List[torch.Tensor]:
        """Every layer's activation (reference: feedForward), in layer order.
        ``train=True`` runs the training forward, drawing dropout from the
        model's stream."""
        self._check_init()
        rng = self._next_generator() if train else None
        with torch.no_grad():
            _, _, _, acts = self.forward_pure(self.params, self.state, self._input(x),
                                              train=train, rng=rng, mask=self._mask(mask),
                                              collect=True)
        return acts

    def score(self, features, labels, mask=None, label_mask=None) -> float:
        self._check_init()
        with torch.inference_mode():
            labels_t = as_input(labels, self.dtype, True, self.device)
            s, _ = self.loss_pure(self.params, self.state, self._input(features),
                                  labels_t, mask=self._mask(mask),
                                  label_mask=self._mask(label_mask), train=False)
        return float(s)

    def calculate_gradients(self, features, labels, mask=None, label_mask=None):
        """Full gradient ``{layer: {param: grad}}`` for the given batch — the
        grad-check entry point (reference: computeGradientAndScore +
        Gradient object). Runs the training forward without dropout."""
        self._check_init()
        labels_t = as_input(labels, self.dtype, True, self.device)
        s, _ = self.loss_pure(self.params, self.state, self._input(features), labels_t,
                              rng=None, mask=self._mask(mask),
                              label_mask=self._mask(label_mask), train=True)
        return grads_of(s, self.params)

    # ------------------------------------------------------------------ fit
    def add_listeners(self, *listeners: TrainingListener) -> None:
        for l in listeners:
            self.listeners.add(l)

    # reference spelling
    def set_listeners(self, *listeners: TrainingListener) -> None:
        self.listeners.clear()
        for l in listeners:
            self.listeners.add(l)

    def fit(self, data, labels=None, *, epochs: int = 1, mask=None, label_mask=None):
        """Train (reference: MultiLayerNetwork.fit). ``data`` may be a
        (features, labels) pair, a DataSet, or a DataSetIterator."""
        self._check_init()
        from ..train.solver import Solver

        if self._trainer is None:
            self._trainer = Solver(self)
        self._trainer.fit(data, labels, epochs=epochs, mask=mask, label_mask=label_mask)
        return self

    # ------------------------------------------------------- rnn streaming
    def rnn_time_step(self, x, mask=None) -> torch.Tensor:
        """Stateful streaming inference (reference: rnnTimeStep): the
        recurrent state (h, c) carries across calls. A 2-D [b, f] input to a
        network that takes sequences is one time step, and so is the
        [b, f] output."""
        self._check_init()
        x = self._input(x)
        single_step = False
        if x.ndim == 2 and self._expects_sequence_input():
            x = x[:, :, None]
            single_step = True
        with torch.no_grad():
            out, _, new_rnn = self.forward_pure(
                self.params, self.state, x, mask=self._mask(mask),
                rnn_state=self.rnn_state if self.rnn_state else None)
        self.rnn_state = new_rnn
        if single_step and out.ndim == 3:
            out = out[:, :, -1]
        return out

    def rnn_clear_previous_state(self) -> None:
        self.rnn_state = {}

    def rnn_get_previous_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return self.rnn_state

    def rnn_set_previous_state(self, state) -> None:
        self.rnn_state = state

    def _expects_sequence_input(self) -> bool:
        return isinstance(self.conf.input_type, RecurrentType)

    # --------------------------------------------------------- evaluation
    def evaluate(self, iterator_or_features, labels=None, mask=None):
        """Classification evaluation (reference: MultiLayerNetwork.evaluate)
        over a (features, labels) pair, a DataSet or a DataSetIterator; the
        outputs are accumulated on the host."""
        from ..train.evaluation import Evaluation

        ev = Evaluation()
        for feats, labs, msk, lmsk in _as_batches(iterator_or_features, labels, mask):
            out = self.output(feats, mask=msk)
            ev.eval(to_numpy(labs), to_numpy(out), mask=to_numpy(lmsk))
        return ev

    def evaluate_regression(self, iterator_or_features, labels=None):
        from ..train.evaluation import RegressionEvaluation

        ev = RegressionEvaluation()
        for feats, labs, msk, _ in _as_batches(iterator_or_features, labels, None):
            out = self.output(feats, mask=msk)
            ev.eval(to_numpy(labs), to_numpy(out))
        return ev

    # ------------------------------------------------------------- params
    def num_params(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))

    def _ravel_order(self) -> List[Tuple[str, str]]:
        """(layer, param) pairs in the JAX package's ``ravel_pytree`` order:
        dict keys sorted as strings at both levels (so ``layer_10`` comes
        before ``layer_2``, and ``W1`` before ``b1``)."""
        order = []
        for lname in sorted(self.layer_names()):
            for pname in sorted(getattr(self, lname).params()):
                order.append((lname, pname))
        return order

    def params_flat(self) -> np.ndarray:
        """Single flat float param vector in ``ravel_pytree`` order — the
        layout of the model zip's ``coefficients.npy``."""
        params = self.params
        parts = [params[l][p].detach().reshape(-1).cpu() for l, p in self._ravel_order()]
        if not parts:
            return np.zeros((0,), np.float32)
        flat = torch.cat(parts)
        if flat.dtype == torch.bfloat16:  # numpy has no bfloat16
            flat = flat.float()
        return flat.numpy()

    def get_layer_params(self, i: int) -> Dict[str, torch.Tensor]:
        return self.params[self.conf.layer_name(i)]

    def summary(self) -> str:
        """The JAX package's table: index, name, type and parameter count of
        each layer, then the total."""
        lines = [f"{'idx':<4}{'name':<28}{'type':<30}{'params':>10}"]
        total = 0
        params = self.params if self._initialized else {}
        for i, layer in enumerate(self.layers):
            name = self.conf.layer_name(i)
            n = sum(int(a.numel()) for a in params.get(name, {}).values())
            total += n
            lines.append(f"{i:<4}{name:<28}{type(layer).__name__:<30}{n:>10}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        """A copy of the configuration, parameters and state on the same
        device, with no trainer, counters or listeners, as the JAX
        package's. Every tensor is copied: the JAX package may share its
        arrays because they are immutable, but here the updater writes the
        parameters in place, and a shared copy would follow the live model."""
        m = MultiLayerNetwork(self.conf, device=self.device)
        if self._initialized:
            with torch.no_grad():
                for name in self.layer_names():
                    src = getattr(self, name)
                    m.add_module(name, LayerModule(src.conf, {
                        k: p.detach().clone() for k, p in src.params().items()}))
                m.state = {l: {k: v.clone() for k, v in st.items()}
                           for l, st in self.state.items()}
            m._persistent_keys = dict(self._persistent_keys)
            m._initialized = True
        return m

    def set_params_flat(self, vec) -> None:
        vec = np.asarray(vec)
        if vec.size != self.num_params():
            raise ValueError(f"flat vector has {vec.size} values, model has "
                             f"{self.num_params()} params")
        params = self.params
        off = 0
        with torch.no_grad():
            for lname, pname in self._ravel_order():
                p = params[lname][pname]
                n = p.numel()
                chunk = torch.from_numpy(np.ascontiguousarray(vec[off:off + n]))
                p.copy_(chunk.reshape(p.shape).to(device=p.device, dtype=p.dtype))
                off += n


# Alias with the TPU-native project's own idiom, as in the JAX package
Sequential = MultiLayerNetwork


def _as_batches(data, labels, mask):
    """Normalize (features, labels), a ``DataSet`` or an iterable of
    ``DataSet``s or (features, labels) pairs into batch tuples
    ``(features, labels, mask, label_mask)``. A batch that
    ``data.device_put_dataset`` copied asynchronously is waited for on the
    current stream first."""
    from ..data.dataset import DataSet

    if labels is not None:
        yield data, labels, mask, None
        return
    if isinstance(data, DataSet):
        data.wait_ready()
        yield data.features, data.labels, data.features_mask, data.labels_mask
        return
    for item in data:
        if isinstance(item, DataSet):
            item.wait_ready()
            yield item.features, item.labels, item.features_mask, item.labels_mask
        else:
            f, l = item[0], item[1]
            yield f, l, None, None
