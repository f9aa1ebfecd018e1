"""SameDiff — the graph/autodiff engine (port of
``deeplearning4j_tpu/samediff/samediff.py``).

Reference: org.nd4j.autodiff.samediff.SameDiff + SDVariable +
InferenceSession/TrainingSession. The JAX package traces the graph into one
XLA program; here the graph is interpreted eagerly over torch tensors, one
registry op (``ops.py``) after another, and gradients come from autograd.

Structure:
* a SameDiff holds nodes: placeholders, variables (trainable), constants and
  op nodes (op name from ``samediff/ops.py`` + attrs), and the values of its
  variables and constants as tensors on its device.
* SDVariable wraps a node with numpy-style operators and ``.eval()``.
* ``sd.output(feeds, names)`` evaluates topologically, without autograd.
* ``sd.calculate_gradients(feeds, wrt)`` = autograd over the interpretation.
* ``sd.fit(iterator, TrainingConfig)`` = forward, backward and the updater's
  transformation in place (``training.py``).
* ``while_loop`` runs as a Python loop whose predicate the host reads;
  ``ifCond`` runs the branch the predicate picks.
* ``compile(example_feeds, outputs)`` captures the interpretation once as a
  CUDA graph (``ops/cuda_graph.py::GraphedStep``) and replays it; a graph
  whose closure must read device values on the host or draws from a key
  (control flow, ops in ``ops.HOST_OPS``) stays eager, and says why
  (``graphed``, ``reason``).
* save/load: the JAX package's zip (``graph.json`` + ``values.npz`` keyed by
  node id), so a graph saved by either package loads in the other.

Devices: a SameDiff lives on one device. The constructor, :meth:`load` and
the TF importer take ``device=``, which defaults to the current CUDA device;
without a card they raise unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.dtypes import default_device, to_numpy
from ..core.rng import RngState
from .ops import HOST_OPS, SD_OPS, TENSOR_ATTRS, as_t, device_scope, get_sd_op, tdt


@dataclasses.dataclass
class Node:
    id: int
    name: str
    kind: str  # placeholder | variable | constant | op
    op: Optional[str] = None
    inputs: Tuple[int, ...] = ()
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    shape: Optional[Tuple[Optional[int], ...]] = None
    dtype: Optional[str] = None
    out_index: int = 0  # for multi-output ops: which output this node is
    n_outputs: int = 1


class SDVariable:
    def __init__(self, sd: "SameDiff", node: Node) -> None:
        self.sd = sd
        self.node = node

    @property
    def name(self) -> str:
        return self.node.name

    def rename(self, name: str) -> "SDVariable":
        old = self.node.name
        self.node.name = name
        self.sd._names.pop(old, None)
        self.sd._names[name] = self.node.id
        return self

    # ---- evaluation --------------------------------------------------------
    def eval(self, feeds: Optional[Dict[str, Any]] = None) -> np.ndarray:
        return to_numpy(self.sd.output(feeds or {}, [self.name])[self.name])

    # ---- operators ---------------------------------------------------------
    def _bin(self, op: str, other, reverse=False) -> "SDVariable":
        o = self.sd._lift(other)
        a, b = (o, self) if reverse else (self, o)
        return self.sd._op(op, a, b)

    def __add__(self, o):
        return self._bin("add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, reverse=True)

    def __mul__(self, o):
        return self._bin("mul", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, reverse=True)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __neg__(self):
        return self.sd._op("neg", self)

    def __matmul__(self, o):
        return self._bin("matmul", o)

    def __getitem__(self, item):
        return self.sd._op("getitem", self, item=item)

    # comparison producing bool tensors (reference: SDVariable.gt etc.)
    def gt(self, o):
        return self._bin("gt", o)

    def lt(self, o):
        return self._bin("lt", o)

    def eq(self, o):
        return self._bin("eq", o)

    # common methods (reference SDVariable surface)
    def add(self, o):
        return self.__add__(o)

    def mul(self, o):
        return self.__mul__(o)

    def mmul(self, o):
        return self.__matmul__(o)

    def _reduce(self, op, axis, keepdims=False):
        return self.sd._op(op, self, axis=list(axis) or None, keepdims=keepdims)

    def sum(self, *axis, keepdims=False):
        return self._reduce("reduce_sum", axis, keepdims)

    def mean(self, *axis, keepdims=False):
        return self._reduce("reduce_mean", axis, keepdims)

    def max(self, *axis, keepdims=False):
        return self._reduce("reduce_max", axis, keepdims)

    def min(self, *axis, keepdims=False):
        return self._reduce("reduce_min", axis, keepdims)

    def std(self, *axis, keepdims=False):
        return self._reduce("reduce_std", axis, keepdims)

    def norm2(self, *axis):
        return self.sd._op("norm2", self, axis=list(axis) or None)

    def reshape(self, *shape):
        return self.sd._op("reshape", self, shape=list(shape))

    def transpose(self, *perm):
        return self.sd._op("transpose", self, perm=list(perm) or None)

    def shape(self):
        return self.sd._op("shape_of", self)


class _Namespace:
    """Op-factory namespace (reference: sd.math(), sd.nn(), ...)."""

    def __init__(self, sd: "SameDiff") -> None:
        self._sd = sd

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in SD_OPS:
            raise AttributeError(f"No op {name!r} in this namespace")

        def call(*args, **kwargs):
            if any(not isinstance(a, SDVariable) for a in args):
                raise TypeError(
                    f"{name}: positional args must be SDVariables; pass attrs by keyword")
            return self._sd._op(name, *args, **kwargs)

        return call


_NAMESPACES = ("math", "nn", "cnn", "rnn", "loss", "bitwise", "image", "linalg", "random")
_RANDOM_OPS = ("dropout", "random_normal", "random_uniform", "random_bernoulli")


def _fold_in(gen: torch.Generator, nid: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for node ``nid``, derived from ``gen``'s
    seed (the role of ``jax.random.fold_in``): the node draws on the device."""
    return torch.Generator(device=device).manual_seed(
        (gen.initial_seed() * 1_000_003 + nid) % (2 ** 63))


def _op_attr(name: str, v, device: torch.device):
    if not isinstance(v, np.ndarray) or v.dtype == object:
        return v
    if v.dtype.kind in "iu" and name not in TENSOR_ATTRS:
        return v.tolist()
    return torch.as_tensor(v).to(device)


class SameDiff:
    def __init__(self, device=None) -> None:
        self.device = default_device(device)
        self._nodes: Dict[int, Node] = {}
        self._names: Dict[str, int] = {}
        self._values: Dict[int, torch.Tensor] = {}  # variables + constants
        self._next_id = 0
        self._loss_name: Optional[str] = None
        self._rng = RngState(0)
        self._training = None  # TrainingSession
        # (node id, device) -> the node's attrs as its op takes them, made
        # once (a replayed CUDA graph copies nothing): see _device_attrs
        self._op_attrs: Dict[Tuple[int, torch.device], Dict[str, Any]] = {}
        self._closures: Dict[Tuple, List[int]] = {}  # (targets, node count) -> order
        for ns in _NAMESPACES:
            setattr(self, ns, _Namespace(self))

    # ------------------------------------------------------------- creation
    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    def _new_node(self, name: Optional[str], kind: str, **kw) -> Node:
        nid = self._next_id
        self._next_id += 1
        if name is None:
            name = f"{kw.get('op', kind)}_{nid}"
        if name in self._names:
            raise ValueError(f"Duplicate variable name {name!r}")
        node = Node(id=nid, name=name, kind=kind, **kw)
        self._nodes[nid] = node
        self._names[name] = nid
        return node

    def placeholder(self, name: str, shape: Sequence[Optional[int]] = None,
                    dtype: str = "float32") -> SDVariable:
        node = self._new_node(name, "placeholder",
                              shape=None if shape is None else tuple(shape), dtype=dtype)
        return SDVariable(self, node)

    # reference spelling
    def ph(self, name, shape=None, dtype="float32"):
        return self.placeholder(name, shape, dtype)

    def _tensor(self, value) -> torch.Tensor:
        with device_scope(self.device):
            return as_t(value).to(self.device)

    def var(self, name: str, value=None, shape: Sequence[int] = None,
            dtype: str = "float32") -> SDVariable:
        """Trainable variable (reference: sd.var)."""
        if value is None:
            if shape is None:
                raise ValueError("var needs value or shape")
            value = 0.01 * torch.randn(tuple(shape), generator=self._rng.next_key(),
                                       dtype=tdt(dtype))
        value = self._tensor(value)
        node = self._new_node(name, "variable", shape=tuple(value.shape),
                              dtype=str(value.dtype).replace("torch.", ""))
        self._values[node.id] = value
        return SDVariable(self, node)

    def constant(self, value, name: Optional[str] = None) -> SDVariable:
        value = self._tensor(value)
        node = self._new_node(name, "constant", shape=tuple(value.shape),
                              dtype=str(value.dtype).replace("torch.", ""))
        self._values[node.id] = value
        return SDVariable(self, node)

    def _lift(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            return x
        return self.constant(x)

    # ops evaluated structurally by _eval_graph, not via the op registry
    _STRUCTURAL_OPS = ("getitem", "while_loop", "cond")

    def _op(self, op: str, *inputs: SDVariable, name: Optional[str] = None,
            **attrs) -> Union[SDVariable, Tuple[SDVariable, ...]]:
        if op not in self._STRUCTURAL_OPS:
            get_sd_op(op)  # validate early
        for v in inputs:
            if v.sd is not self:
                # node ids are per-graph; a foreign id would silently bind
                # to an unrelated node (outer-graph vars inside a
                # while_loop/cond subgraph builder)
                raise ValueError(
                    f"{op}: input {v.name!r} belongs to a different SameDiff "
                    "graph. Control-flow subgraphs are closed: thread outer "
                    "values through loop_vars/operands, or recreate "
                    "constants on the subgraph handle.")
        node = self._new_node(name, "op", op=op, inputs=tuple(v.node.id for v in inputs),
                              attrs=attrs)
        return SDVariable(self, node)

    # ------------------------------------------------------- control flow
    def while_loop(self, loop_vars: Sequence[SDVariable], cond_fn, body_fn,
                   name: Optional[str] = None,
                   max_iters: Optional[int] = None) -> List[SDVariable]:
        """Structured while loop (reference: SameDiff.whileLoop).

        ``cond_fn(sub_sd, *args) -> SDVariable`` builds the scalar-bool
        predicate; ``body_fn(sub_sd, *args) -> sequence`` builds the next
        carry (same arity/dtypes as ``loop_vars``). Both receive a fresh
        sub-SameDiff whose placeholders ``arg0..argN`` are the loop carry.
        Returns one SDVariable per loop var (the final carry).

        It runs as a Python loop: the host reads the predicate each
        iteration. ``max_iters`` bounds the loop and makes it
        differentiable, as the JAX package's bounded form: the body runs
        only while the condition holds, never on the frozen carry after
        exit. Gradients through a loop without ``max_iters`` raise, as
        they do in the JAX package.
        """
        n = len(loop_vars)
        cond_sd, cond_outs = self._build_subgraph(cond_fn, n)
        body_sd, body_outs = self._build_subgraph(body_fn, n)
        if len(cond_outs) != 1:
            raise ValueError("while_loop cond must produce exactly one value")
        if len(body_outs) != n:
            raise ValueError(
                f"while_loop body must return {n} values (the carry), got {len(body_outs)}")
        node_var = self._op(
            "while_loop", *loop_vars, name=name,
            cond_graph=cond_sd, cond_outputs=cond_outs,
            body_graph=body_sd, body_outputs=body_outs, n_vars=n,
            max_iters=max_iters)
        node_var.node.n_outputs = n
        return [self._op("getitem", node_var, item=i) for i in range(n)]

    whileLoop = while_loop

    def ifCond(self, pred: SDVariable, operands: Sequence[SDVariable],
               true_fn, false_fn, name: Optional[str] = None) -> List[SDVariable]:
        """Structured conditional (reference: SameDiff.ifCond).
        ``true_fn/false_fn(sub_sd, *args) -> sequence`` must return the
        same structure; the host reads ``pred`` and runs one branch."""
        n = len(operands)
        t_sd, t_outs = self._build_subgraph(true_fn, n)
        f_sd, f_outs = self._build_subgraph(false_fn, n)
        if len(t_outs) != len(f_outs):
            raise ValueError("ifCond branches must return the same arity")
        node_var = self._op(
            "cond", pred, *operands, name=name,
            true_graph=t_sd, true_outputs=t_outs,
            false_graph=f_sd, false_outputs=f_outs, n_vars=n)
        node_var.node.n_outputs = len(t_outs)
        return [self._op("getitem", node_var, item=i) for i in range(len(t_outs))]

    if_cond = ifCond

    def _build_subgraph(self, fn, n_args: int):
        sub = SameDiff(self.device)
        args = [sub.placeholder(f"arg{i}") for i in range(n_args)]
        outs = fn(sub, *args)
        if isinstance(outs, SDVariable):
            outs = [outs]
        return sub, [o.name for o in outs]

    def _subgraph_call(self, sub: "SameDiff", out_names: Sequence[str], args, rng,
                       training: bool):
        feeds = {f"arg{i}": v for i, v in enumerate(args)}
        res = sub._eval_graph(feeds, dict(sub._values), list(out_names), rng=rng,
                              training=training)
        return [res[o] for o in out_names]

    # ------------------------------------------------------------ accessors
    def get_variable(self, name: str) -> SDVariable:
        return SDVariable(self, self._nodes[self._names[name]])

    def variables(self) -> List[str]:
        return [n.name for n in self._nodes.values() if n.kind == "variable"]

    def placeholders(self) -> List[str]:
        return [n.name for n in self._nodes.values() if n.kind == "placeholder"]

    def set_loss_variables(self, *names: str) -> None:
        self._loss_name = names[0] if names else None

    def convert_to_variables(self, names: Optional[Sequence[str]] = None,
                             min_size: int = 2) -> List[str]:
        """Make constants trainable (reference: convertToVariable(s) — the
        import-then-finetune step: frozen-graph weights arrive as constants
        and must become variables before ``fit`` will update them).

        With ``names`` None, every float constant with at least ``min_size``
        elements converts (weights), leaving scalars and small shape-like
        constants frozen. Returns the converted names.
        """
        converted: List[str] = []
        if names is not None:
            targets = [self._nodes[self._names[n]] for n in names]
            # validate BEFORE mutating anything; already-variable names are
            # idempotent no-ops (the reference's convertToVariable)
            for node in targets:
                if node.kind not in ("constant", "variable"):
                    raise ValueError(f"{node.name!r} is {node.kind}, not constant")
            targets = [n for n in targets if n.kind == "constant"]
        else:
            targets = [n for n in self._nodes.values() if n.kind == "constant"]
        for node in targets:
            value = self._values.get(node.id)
            if names is None and (value is None or value.numel() < min_size
                                  or not value.is_floating_point()):
                continue
            node.kind = "variable"
            converted.append(node.name)
        if converted:
            # a cached TrainingSession snapshotted var_ids before the
            # conversion — it would silently keep the new variables frozen
            self._training = None
        return converted

    convertToVariables = convert_to_variables

    # ------------------------------------------------------------ execution
    def _closure(self, targets: Sequence[str]) -> List[int]:
        """Node ids the targets depend on, dependencies first (kept per
        target list until a node is added)."""
        key = (tuple(self._names[t] for t in targets), self._next_id)
        if key not in self._closures:
            self._closures[key] = self._order(key[0])
        return self._closures[key]

    def _order(self, roots) -> List[int]:
        order: List[int] = []
        seen: set = set()
        for root in roots:
            stack = [(root, False)]
            while stack:
                nid, done = stack.pop()
                if done:
                    order.append(nid)
                    continue
                if nid in seen:
                    continue
                seen.add(nid)
                stack.append((nid, True))
                stack.extend((i, False) for i in reversed(self._nodes[nid].inputs)
                             if i not in seen)
        return order

    def _eval_graph(self, feeds: Dict[str, Any], var_values: Dict[int, Any],
                    targets: Sequence[str], rng: Optional[torch.Generator] = None,
                    training: bool = False) -> Dict[str, Any]:
        """Topological interpretation over torch tensors."""
        cache: Dict[int, Any] = {}
        with device_scope(self.device):
            for nid in self._closure(targets):
                node = self._nodes[nid]
                if node.kind == "placeholder":
                    if node.name not in feeds:
                        raise KeyError(f"Missing placeholder feed: {node.name}")
                    out = self._feed(feeds[node.name])
                elif node.kind in ("variable", "constant"):
                    out = var_values.get(nid, self._values.get(nid))
                    if out is None:
                        raise KeyError(f"No value for {node.name}")
                else:
                    ins = [cache[i] for i in node.inputs]
                    if node.op == "getitem":
                        out = self._getitem(ins[0], node.attrs["item"])
                    elif node.op == "while_loop":
                        out = self._eval_while(node, ins, rng, training)
                    elif node.op == "cond":
                        out = self._eval_cond(node, ins, rng, training)
                    else:
                        attrs = self._device_attrs(node)
                        if node.op in _RANDOM_OPS:
                            attrs["rng"] = (_fold_in(rng, nid, self.device)
                                            if rng is not None else None)
                            if node.op == "dropout":
                                attrs["deterministic"] = not training
                        out = get_sd_op(node.op)(*ins, **attrs)
                cache[nid] = out
        return {t: cache[self._names[t]] for t in targets}

    def _device_attrs(self, node: Node) -> Dict[str, Any]:
        """``node``'s attrs as its op takes them, made once per device.
        Integer arrays that the op reads on the host (shapes, axes,
        paddings) become lists, so reading them costs no device copy and a
        capture can hold the op; other arrays (:data:`ops.TENSOR_ATTRS`,
        float tables) become tensors on the graph's device."""
        key = (node.id, self.device)
        attrs = self._op_attrs.get(key)
        if attrs is None:
            attrs = self._op_attrs[key] = {
                k: _op_attr(k, v, self.device) for k, v in node.attrs.items()}
        return dict(attrs)

    def _feed(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value if value.device == self.device else value.to(self.device)
        return self._tensor(value)

    @staticmethod
    def _getitem(x, item):
        if isinstance(x, (tuple, list)):
            return x[item]
        from .ops import general_index
        items = item if isinstance(item, tuple) else (item,)
        if all(i is None or isinstance(i, (int, slice)) for i in items) and Ellipsis not in items:
            return general_index(x, items)
        return x[item]

    def _eval_while(self, node: Node, ins, rng, training: bool):
        """Run a while_loop node: the host reads the predicate each
        iteration. Carry dtypes stay those of the initial values."""
        cond_sd, cond_outs = node.attrs["cond_graph"], node.attrs["cond_outputs"]
        body_sd, body_outs = node.attrs["body_graph"], node.attrs["body_outputs"]
        max_iters = node.attrs.get("max_iters")
        carry = tuple(ins)
        if max_iters is None and torch.is_grad_enabled() and any(
                isinstance(c, torch.Tensor) and c.requires_grad for c in carry):
            raise ValueError(
                "Reverse-mode differentiation does not work for a while_loop "
                "without max_iters; pass max_iters for the bounded, "
                "differentiable form")

        def pred(c):
            res = self._subgraph_call(cond_sd, cond_outs, c, rng, training)
            return bool(torch.as_tensor(res[0]).reshape(()))

        steps = 0
        while (max_iters is None or steps < int(max_iters)) and pred(carry):
            res = self._subgraph_call(body_sd, body_outs, carry, rng, training)
            carry = tuple(torch.as_tensor(r).to(c.dtype) for r, c in zip(res, carry))
            steps += 1
        return carry

    def _eval_cond(self, node: Node, ins, rng, training: bool):
        """Run one branch of a cond node; the false branch's outputs are
        cast to the true branch's dtypes (found by running the true branch
        on meta tensors, which computes nothing)."""
        t_sd, t_outs = node.attrs["true_graph"], node.attrs["true_outputs"]
        f_sd, f_outs = node.attrs["false_graph"], node.attrs["false_outputs"]
        pred, operands = ins[0], tuple(ins[1:])
        if bool(torch.as_tensor(pred).reshape(())):
            return tuple(self._subgraph_call(t_sd, t_outs, operands, rng, training))
        res = self._subgraph_call(f_sd, f_outs, operands, rng, training)
        dtypes = self._branch_dtypes(t_sd, t_outs, operands)
        return tuple(torch.as_tensor(r).to(dt) for r, dt in zip(res, dtypes))

    @staticmethod
    def _branch_dtypes(sub: "SameDiff", outs, operands) -> List[torch.dtype]:
        meta = torch.device("meta")
        feeds = {f"arg{i}": torch.empty_like(v, device=meta) for i, v in enumerate(operands)}
        values = {k: torch.empty_like(v, device=meta) for k, v in sub._values.items()}
        saved = sub.device
        sub.device = meta
        try:
            with torch.no_grad():
                res = sub._eval_graph(feeds, values, list(outs))
        finally:
            sub.device = saved
        return [res[o].dtype for o in outs]

    def output(self, feeds: Dict[str, Any], outputs: Sequence[str],
               training: bool = False) -> Dict[str, torch.Tensor]:
        """Execute (reference: SameDiff.output), without autograd."""
        with torch.no_grad():
            return self._eval_graph(feeds, dict(self._values), list(outputs), training=training)

    def batch_output(self, feeds, outputs):
        return self.output(feeds, outputs)

    def calculate_gradients(self, feeds: Dict[str, Any],
                            wrt: Sequence[str]) -> Dict[str, torch.Tensor]:
        """Reverse-mode gradients of the (summed) loss variable with respect
        to named variables (reference: SameDiff.calculateGradients)."""
        if self._loss_name is None:
            raise ValueError("No loss variable set (set_loss_variables)")
        wrt_ids = [self._names[w] for w in wrt]
        leaves = [self._values[i].detach().requires_grad_(True) for i in wrt_ids]
        var_values = dict(self._values)
        var_values.update(zip(wrt_ids, leaves))
        with torch.enable_grad():
            out = self._eval_graph(feeds, var_values, [self._loss_name], training=True)
            loss = torch.sum(out[self._loss_name])
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return {w: torch.zeros_like(v) if g is None else g
                for w, v, g in zip(wrt, leaves, grads)}

    # ------------------------------------------------------------- training
    def fit(self, iterator, training_config=None, epochs: int = 1, listeners=None):
        from .training import TrainingSession

        if self._training is None:
            self._training = TrainingSession(self, training_config, listeners=listeners)
        elif listeners:
            for l in listeners:
                self._training.listeners.add(l)
        return self._training.fit(iterator, epochs=epochs)

    # ------------------------------------------------- compile / serialization
    def host_ops(self, outputs: Sequence[str]) -> List[str]:
        """The ops of ``outputs``' closure that read device values on the
        host or draw from a key (control flow and :data:`ops.HOST_OPS`), by
        node name."""
        out = []
        for nid in self._closure(outputs):
            node = self._nodes[nid]
            if node.kind == "op" and (node.op in ("while_loop", "cond") or node.op in HOST_OPS):
                out.append(f"{node.name} ({node.op})")
        return out

    def compile(self, example_feeds: Dict[str, Any], outputs: Sequence[str]):
        """The JAX package's AOT compile as a callable ``(var_values, feeds)
        -> {name: tensor}``. On the card the interpretation of ``outputs``
        is captured once as a CUDA graph for the example feeds' shapes and
        dtypes (:class:`CompiledGraph`); otherwise, or where the closure
        holds an op that reads device values on the host, the callable
        interprets eagerly and says why (``graphed``, ``reason``)."""
        return CompiledGraph(self, example_feeds, list(outputs))

    def save(self, path: str, with_updater: bool = False) -> None:
        """Reference: sd.save(file, withUpdaterState) — the JAX package's zip."""
        graph = {"nodes": [_node_dict(n) for n in self._nodes.values()],
                 "loss": self._loss_name}
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("graph.json", json.dumps(graph))
            zf.writestr("values.npz", _npz_bytes(self._values))

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        sd = SameDiff(device)
        with zipfile.ZipFile(path) as zf:
            graph = json.loads(zf.read("graph.json"))
            values = _values_from_npz(zf.read("values.npz"), sd.device)
        _add_nodes(sd, graph["nodes"])
        sd._values = values
        sd._loss_name = graph.get("loss")
        return sd

    def summary(self) -> str:
        lines = [f"{'name':<32}{'kind':<12}{'op':<24}inputs"]
        for n in self._nodes.values():
            ins = ",".join(self._nodes[i].name for i in n.inputs)
            lines.append(f"{n.name:<32}{n.kind:<12}{n.op or '':<24}{ins}")
        return "\n".join(lines)


class CompiledGraph:
    """``SameDiff.compile``'s callable. ``graphed`` says whether it replays a
    CUDA graph; ``reason`` says why not. A graphed call copies the feeds into
    the captured inputs, checks that ``var_values`` holds the captured
    variable and constant tensors (the graph reads those buffers) and
    replays; an eager call interprets the graph with ``var_values``."""

    def __init__(self, sd: SameDiff, example_feeds: Dict[str, Any], outputs: List[str]) -> None:
        self.sd, self.outputs = sd, outputs
        self.feed_names = sorted(example_feeds)
        host = sd.host_ops(outputs)
        if sd.device.type != "cuda":
            self.graphed, self.reason = False, f"the graph lives on {sd.device}, not a card"
        elif host:
            self.graphed = False
            self.reason = "ops that read device values on the host or draw from a key: " + \
                ", ".join(host)
        else:
            self.graphed, self.reason = True, None
            self._capture(example_feeds)

    def _capture(self, example_feeds) -> None:
        from ..ops.cuda_graph import GraphedStep

        sd = self.sd
        self.values = {nid: sd._values[nid] for nid in sd._closure(self.outputs)
                       if nid in sd._values}
        inputs = [sd._feed(example_feeds[n]) for n in self.feed_names]

        def step(*feeds):
            with torch.no_grad():
                res = sd._eval_graph(dict(zip(self.feed_names, feeds)), self.values,
                                     self.outputs)
            return [res[o] for o in self.outputs]

        step(*inputs)  # eager once: kernel builds, library handles, workspaces
        torch.cuda.synchronize(sd.device)
        self._graph = GraphedStep(step, inputs)

    def __call__(self, var_values: Dict[int, Any], feeds: Dict[str, Any]) -> Dict[str, Any]:
        if not self.graphed:
            with torch.no_grad():
                return self.sd._eval_graph(feeds, dict(var_values), self.outputs)
        for nid, t in self.values.items():
            if var_values.get(nid) is not t:
                raise ValueError(
                    f"compiled graph: var_values[{nid}] ({self.sd._nodes[nid].name!r}) is not "
                    "the tensor captured in the graph; compile again after replacing values")
        outs = self._graph(*(self.sd._feed(feeds[n]) for n in self.feed_names))
        return dict(zip(self.outputs, outs))


# ---- serialization helpers (the JAX package's encodings) -------------------
def _node_dict(n: Node) -> Dict[str, Any]:
    return {"id": n.id, "name": n.name, "kind": n.kind, "op": n.op,
            "inputs": list(n.inputs), "attrs": _jsonable_attrs(n.attrs),
            "shape": None if n.shape is None else list(n.shape), "dtype": n.dtype}


def _add_nodes(sd: SameDiff, nodes) -> None:
    for nd in nodes:
        node = Node(
            id=nd["id"], name=nd["name"], kind=nd["kind"], op=nd.get("op"),
            inputs=tuple(nd.get("inputs", ())),
            attrs=_restore_attrs(nd.get("attrs", {}), sd.device),
            shape=None if nd.get("shape") is None else tuple(nd["shape"]),
            dtype=nd.get("dtype"))
        sd._nodes[node.id] = node
        sd._names[node.name] = node.id
        sd._next_id = max(sd._next_id, node.id + 1)


def _jsonable_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            arr = to_numpy(v)
            out[k] = {"@array": arr.tolist(), "dtype": str(arr.dtype)}
        elif isinstance(v, slice):
            out[k] = {"@slice": [v.start, v.stop, v.step]}
        elif isinstance(v, tuple):
            out[k] = {"@tuple": list(v)}
        elif isinstance(v, SameDiff):  # control-flow subgraph
            out[k] = {"@subgraph": _sd_to_dict(v)}
        elif isinstance(v, torch.dtype):
            out[k] = str(v).replace("torch.", "")
        else:
            out[k] = v
    return out


def _restore_attrs(attrs: Dict[str, Any], device) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "@array" in v:
            out[k] = np.array(v["@array"], dtype=v["dtype"])
        elif isinstance(v, dict) and "@slice" in v:
            out[k] = slice(*v["@slice"])
        elif isinstance(v, dict) and "@tuple" in v:
            out[k] = tuple(v["@tuple"])
        elif isinstance(v, dict) and "@subgraph" in v:
            out[k] = _sd_from_dict(v["@subgraph"], device)
        else:
            out[k] = v
    return out


def _sd_to_dict(sd: SameDiff) -> Dict[str, Any]:
    """Inline-JSON form of a (sub)graph, values included (npz in base64)."""
    return {"nodes": [_node_dict(n) for n in sd._nodes.values()],
            "loss": sd._loss_name,
            "values_npz_b64": base64.b64encode(_npz_bytes(sd._values)).decode("ascii")}


def _sd_from_dict(d: Dict[str, Any], device) -> SameDiff:
    sd = SameDiff(device)
    _add_nodes(sd, d["nodes"])
    if "values_npz_b64" in d:
        sd._values = _values_from_npz(base64.b64decode(d["values_npz_b64"]), sd.device)
    else:  # graphs saved by earlier revisions used inline JSON lists
        sd._values = {int(k): torch.as_tensor(np.array(v["data"], dtype=v["dtype"]),
                                              device=sd.device)
                      for k, v in d.get("values", {}).items()}
    sd._loss_name = d.get("loss")
    return sd


def _npz_bytes(values: Dict[int, Any]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{str(nid): to_numpy(v) for nid, v in values.items()})
    return buf.getvalue()


def _values_from_npz(payload: bytes, device) -> Dict[int, torch.Tensor]:
    z = np.load(io.BytesIO(payload))
    return {int(k): torch.as_tensor(z[k]).to(device) for k in z.files}
