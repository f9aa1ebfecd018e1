"""ComputationGraph — the DAG model (port of ``deeplearning4j_tpu/nn/graph.py``).

Reference: org.deeplearning4j.nn.graph.ComputationGraph — the ResNet-50
path. A topologically ordered forward over vertices, multiple inputs and
outputs, per-output loss weights. Backward is autograd over the whole
graph.

The graph is an ``nn.Module`` holding one :class:`LayerModule` per layer
vertex, registered under the vertex's name, so ``params`` reads
``{vertex: {param: tensor}}`` as the JAX package's param pytree does and
``state_dict`` keys read ``s0b0_a_conv.W``. State model:

* ``params`` — trainable parameters of the layer vertices (live views)
* ``state``  — persistent non-trainable state (batch norm's running
  ``mean``/``var``), written back by each training step

``compute_dtype`` and ``gradient_checkpointing`` act as in
``MultiLayerNetwork``: the walk runs on parameters and inputs cast to the
compute dtype while regularization reads the master parameters, and each
layer vertex of a training walk runs under ``torch.utils.checkpoint``.

Inference runs under ``torch.inference_mode``; training records the
autograd graph. The model lives on ``device`` (default: the current CUDA
device; pass ``device="cpu"`` to run on the CPU).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.dtypes import as_input, cast_floats, default_device, to_numpy, torch_dtype
from ..core.listeners import ListenerBus, TrainingListener
from ..core.rng import RngState
from .graph_conf import ComputationGraphConfiguration, VertexSpec
from .layers.base import Layer, LayerContext, LayerModule, apply_layer
from .layers.output import BaseOutputLayer
from .sequential import _layer_reg_score, grads_of

Tensors = Dict[str, Dict[str, torch.Tensor]]


class ComputationGraph(nn.Module):
    def __init__(self, conf: ComputationGraphConfiguration,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__()
        self.conf = conf
        self.device = default_device(device)
        self.state: Tensors = {}
        self._persistent_keys: Dict[str, Tuple[str, ...]] = {}
        self.listeners = ListenerBus()
        self.iteration_count = 0
        self.epoch_count = 0
        self.last_batch_size = 0
        self.score_value = float("nan")
        # the dropout stream: a checkpoint carries its position (state_dict)
        self._rng = RngState(conf.seed)
        self._solver = None
        self._initialized = False
        # loss weights per output (reference: setOutputs + loss weighting)
        self.output_weights: Dict[str, float] = {n: 1.0 for n in conf.network_outputs}
        # vertices whose activation another vertex reads
        self._consumed = {i for s in conf.vertices for i in s.inputs}

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.conf.dtype)

    def _layer_specs(self) -> List[VertexSpec]:
        return [s for s in self.conf.vertices if s.layer is not None]

    def keeps_int_input(self, input_name: str) -> bool:
        """True when ``input_name`` feeds an index-consuming layer
        (embedding lookup): its integer dtype is then kept."""
        return any(input_name in s.inputs and getattr(s.layer, "consumes_indices", False)
                   for s in self._layer_specs())

    def _as_inputs(self, xs) -> tuple:
        names = self.conf.network_inputs
        return tuple(
            as_input(x, self.dtype, self.keeps_int_input(names[i]) if i < len(names) else False,
                     self.device)
            for i, x in enumerate(xs))

    def _to_compute(self, params, inputs):
        """Mixed-precision boundary (see MultiLayerNetwork._to_compute)."""
        cd = self.conf.compute_dtype
        if not cd or torch_dtype(cd) == self.dtype:
            return params, inputs
        return cast_floats(params, cd), [cast_floats(x, cd) for x in inputs]

    def _as_labels(self, ys) -> tuple:
        return tuple(as_input(y, self.dtype, True, self.device) for y in ys)

    def _as_masks(self, masks) -> Optional[tuple]:
        if masks is None:
            return None
        return tuple(None if m is None else as_input(m, self.dtype, False, self.device)
                     for m in self._as_tuple(masks))

    # Solver surface ----------------------------------------------------------
    def named_param_layers(self) -> List[Tuple[str, Layer]]:
        return [(s.name, s.layer) for s in self._layer_specs() if s.layer.has_params()]

    def _next_generator(self) -> torch.Generator:
        """A fresh CPU generator for one training step's dropout draws; the
        model's own stream (seeded from the config's seed) advances once
        per step."""
        return self._rng.next_key()

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Build every layer vertex's parameters from one CPU
        ``torch.Generator`` seeded with ``seed`` (default: the config's
        seed), drawn vertex by vertex in topological order, on the model's
        device."""
        gen = torch.Generator().manual_seed(self.conf.seed if seed is None else seed)
        dtype = self.dtype
        self.state, self._persistent_keys = {}, {}
        for spec in self._layer_specs():
            name = spec.name
            if name not in self._modules and hasattr(self, name):
                raise ValueError(f"vertex name {name!r} collides with a ComputationGraph "
                                 "attribute")
            params = spec.layer.init(gen, dtype, self.device) if spec.layer.has_params() else {}
            self.add_module(name, LayerModule(spec.layer, params))
            st = {k: v.to(self.device) for k, v in spec.layer.init_state(dtype).items()}
            self.state[name] = st
            self._persistent_keys[name] = tuple(st.keys())
        self._initialized = True
        self._solver = None
        return self

    def _check_init(self) -> None:
        if not self._initialized:
            self.init()

    def migrate_state(self) -> None:
        """Fill persistent-state keys that a layer's ``init_state`` defines
        but the state lacks (a state restored from an older version), with
        their defaults; existing values stay."""
        if not self._initialized:
            return
        for spec in self._layer_specs():
            defaults = spec.layer.init_state(self.dtype)
            cur = dict(self.state.get(spec.name, {}))
            missing = [k for k in defaults if k not in cur]
            if missing:
                for k in missing:
                    cur[k] = defaults[k].to(self.device)
                self.state[spec.name] = cur
                self._persistent_keys[spec.name] = tuple(cur.keys())

    @property
    def params(self) -> Tensors:
        """{vertex: {param_name: nn.Parameter}} — live views."""
        return {s.name: self._modules[s.name].params() for s in self._layer_specs()}

    # -------------------------------------------------------------- forward
    def _run(self, params, state, inputs, *, train, rng, masks, labels=None,
             label_masks=None):
        """The topological walk shared by :meth:`forward_pure` and
        :meth:`loss_pure`. With ``labels``, each output layer that has labels
        computes its loss (and runs its forward only if another vertex reads
        it). Returns (activations, new_state, losses)."""
        params, inputs = self._to_compute(params, inputs)
        remat = self.conf.gradient_checkpointing and train
        acts: Dict[str, torch.Tensor] = dict(zip(self.conf.network_inputs, inputs))
        vmasks: Dict[str, Optional[torch.Tensor]] = {}
        if masks is not None:
            vmasks.update(zip(self.conf.network_inputs, masks))
        label_by_output = {} if labels is None else dict(zip(self.conf.network_outputs, labels))
        lmask_by_output = ({} if label_masks is None
                           else dict(zip(self.conf.network_outputs, label_masks)))
        new_state: Tensors = {}
        losses: Dict[str, torch.Tensor] = {}
        for spec in self.conf.vertices:
            xs = [acts[i] for i in spec.inputs]
            in_mask = vmasks.get(spec.inputs[0]) if spec.inputs else None
            if spec.vertex is not None:
                acts[spec.name] = spec.vertex.apply(*xs)
                vmasks[spec.name] = in_mask
                continue
            x = xs[0]
            ctx = LayerContext(train=train, rng=rng, mask=in_mask)
            if spec.preprocessor is not None:
                x, _ = spec.preprocessor.apply({}, {}, x, ctx)
            lparams = params.get(spec.name, {})
            lstate = dict(state.get(spec.name, {}))
            persistent = self._persistent_keys.get(spec.name, ())
            if isinstance(spec.layer, BaseOutputLayer) and spec.name in label_by_output:
                losses[spec.name] = spec.layer.compute_loss(
                    lparams, x, label_by_output[spec.name], ctx,
                    label_mask=lmask_by_output.get(spec.name))
                if spec.name not in self._consumed:
                    new_state[spec.name] = {k: v for k, v in lstate.items() if k in persistent}
                    continue
            y, lstate_out = apply_layer(spec.layer, lparams, lstate, x, ctx, remat=remat)
            new_state[spec.name] = {k: v for k, v in lstate_out.items() if k in persistent}
            vmasks[spec.name] = (None if in_mask is None
                                 else spec.layer.feed_forward_mask(in_mask, None))
            acts[spec.name] = y
        return acts, new_state, losses

    def forward_pure(self, params, state, inputs: Sequence[torch.Tensor], *,
                     train: bool = False, rng: Optional[torch.Generator] = None,
                     masks: Optional[Sequence[Optional[torch.Tensor]]] = None):
        """Topo-order forward. Returns ({vertex: activation}, new_state)."""
        acts, new_state, _ = self._run(params, state, inputs, train=train, rng=rng,
                                       masks=masks)
        return acts, new_state

    def loss_pure(self, params, state, inputs: Sequence[torch.Tensor],
                  labels: Sequence[torch.Tensor], *, rng: Optional[torch.Generator] = None,
                  masks=None, label_masks=None, train: bool = True):
        """Weighted sum of output-layer losses + regularization (on the
        master parameters) + each MoE layer's load-balance term. Returns
        (score, new_state)."""
        _, new_state, losses = self._run(params, state, inputs, train=train, rng=rng,
                                         masks=masks, labels=labels,
                                         label_masks=label_masks)
        score_dtype = torch.promote_types(self.dtype, torch.float32)
        total = torch.zeros((), dtype=score_dtype, device=self.device)
        for name, loss in losses.items():
            total = total + self.output_weights.get(name, 1.0) * loss.to(score_dtype)
        for name, layer in self.named_param_layers():
            if params.get(name):
                total = total + _layer_reg_score(layer, params[name], score_dtype)
            # MoE load-balance aux loss (GShard): the forward left this
            # batch's term in the layer's state
            bl_w = getattr(layer, "balance_loss_weight", 0.0)
            if bl_w:
                aux = new_state.get(name, {}).get("aux_load_balance")
                if aux is not None:
                    total = total + bl_w * aux.to(score_dtype)
        return total, new_state

    # -------------------------------------------------------------- user API
    @staticmethod
    def _as_tuple(x) -> Tuple:
        if isinstance(x, (list, tuple)):
            return tuple(x)
        return (x,)

    def forward(self, *inputs: torch.Tensor):
        acts, _ = self.forward_pure(self.params, self.state, inputs)
        outs = tuple(acts[n] for n in self.conf.network_outputs)
        return outs[0] if len(outs) == 1 else outs

    def output(self, *inputs, masks=None):
        """Inference; returns one tensor or a tuple matching network_outputs."""
        self._check_init()
        with torch.inference_mode():
            acts, _ = self.forward_pure(self.params, self.state, self._as_inputs(inputs),
                                        masks=self._as_masks(masks))
            outs = tuple(acts[n].to(self.dtype) for n in self.conf.network_outputs)
        return outs[0] if len(outs) == 1 else outs

    def score(self, features, labels, masks=None, label_masks=None) -> float:
        self._check_init()
        with torch.inference_mode():
            s, _ = self.loss_pure(self.params, self.state,
                                  self._as_inputs(self._as_tuple(features)),
                                  self._as_labels(self._as_tuple(labels)),
                                  masks=self._as_masks(masks),
                                  label_masks=self._as_masks(label_masks), train=False)
        return float(s)

    def calculate_gradients(self, features, labels, mask=None, label_mask=None):
        """Full gradient ``{vertex: {param: grad}}`` for the given batch
        (training forward, no dropout)."""
        self._check_init()
        s, _ = self.loss_pure(self.params, self.state,
                              self._as_inputs(self._as_tuple(features)),
                              self._as_labels(self._as_tuple(labels)),
                              masks=self._as_masks(mask),
                              label_masks=self._as_masks(label_mask), train=True)
        return grads_of(s, self.params)

    # ------------------------------------------------------------------ fit
    def add_listeners(self, *listeners: TrainingListener) -> None:
        for l in listeners:
            self.listeners.add(l)

    def fit(self, data, labels=None, *, epochs: int = 1) -> "ComputationGraph":
        """Train (reference: ComputationGraph.fit): ``data`` is a features
        tuple with ``labels``, or an iterable of (features, labels) pairs."""
        self._check_init()
        from ..train.graph_solver import GraphSolver

        if self._solver is None:
            self._solver = GraphSolver(self)
        self._solver.fit(data, labels, epochs=epochs)
        return self

    # the serializer's name for the solver
    @property
    def _trainer(self):
        return self._solver

    @_trainer.setter
    def _trainer(self, v) -> None:
        self._solver = v

    def evaluate(self, iterator_or_features, labels=None):
        """Classification evaluation of the first output against the first
        labels (reference: ComputationGraph.evaluate)."""
        from ..train.evaluation import Evaluation
        from .sequential import _as_batches

        ev = Evaluation()
        for feats, labs, _, _ in _as_batches(iterator_or_features, labels, None):
            out = self.output(*self._as_tuple(feats))
            first = out[0] if isinstance(out, tuple) else out
            ev.eval(to_numpy(self._as_tuple(labs)[0]), to_numpy(first))
        return ev

    # ------------------------------------------------------------- params
    def num_params(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))

    def summary(self) -> str:
        lines = [f"{'name':<28}{'type':<28}{'inputs':<30}{'params':>10}"]
        total = 0
        params = self.params if self._initialized else {}
        for spec in self.conf.vertices:
            kind = type(spec.layer or spec.vertex).__name__
            n = sum(int(a.numel()) for a in params.get(spec.name, {}).values())
            total += n
            lines.append(f"{spec.name:<28}{kind:<28}{','.join(spec.inputs):<30}{n:>10}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)

    def clone(self) -> "ComputationGraph":
        m = ComputationGraph(self.conf, device=self.device)
        if self._initialized:
            m.init()
            with torch.no_grad():
                for name, lp in self.params.items():
                    for pname, p in lp.items():
                        m.params[name][pname].copy_(p)
            m.state = {l: {k: v.clone() for k, v in st.items()} for l, st in self.state.items()}
        return m

    def _ravel_order(self) -> List[Tuple[str, str]]:
        """(vertex, param) pairs in the JAX package's ``ravel_pytree`` order:
        names sorted as strings at both levels (``fc`` before ``s0b0_a_bn``,
        ``s0b10`` before ``s0b2``)."""
        params = self.params
        return [(v, p) for v in sorted(params) for p in sorted(params[v])]

    def params_flat(self) -> np.ndarray:
        """Single flat float param vector in ``ravel_pytree`` order — the
        layout of the model zip's ``coefficients.npy``."""
        params = self.params
        parts = [params[v][p].detach().reshape(-1).cpu() for v, p in self._ravel_order()]
        if not parts:
            return np.zeros((0,), np.float32)
        flat = torch.cat(parts)
        if flat.dtype == torch.bfloat16:  # numpy has no bfloat16
            flat = flat.float()
        return flat.numpy()

    def set_params_flat(self, vec) -> None:
        vec = np.asarray(vec)
        if vec.size != self.num_params():
            raise ValueError(f"flat vector has {vec.size} values, model has "
                             f"{self.num_params()} params")
        params = self.params
        off = 0
        with torch.no_grad():
            for v, pname in self._ravel_order():
                p = params[v][pname]
                n = p.numel()
                chunk = torch.from_numpy(np.ascontiguousarray(vec[off:off + n]))
                p.copy_(chunk.reshape(p.shape).to(device=p.device, dtype=p.dtype))
                off += n
