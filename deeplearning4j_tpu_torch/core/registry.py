"""Typed op registry — the framework's custom-op extension point (port of
``deeplearning4j_tpu/core/registry.py``).

The reference's libnd4j keeps ~500 "declarable ops" in an ``OpRegistrator``,
each with a name, an execution kernel and a shape function. Here the
registry keeps:

* a stable *name -> implementation* mapping,
* abstract shape and dtype inference without running the op: the JAX
  package uses ``jax.eval_shape``; the port runs the op on ``device="meta"``
  tensors, which carry shapes and dtypes and no data,
* an optional custom VJP and an optional accelerated ("helper") variant,
  which ``DL4J_TPU_HELPERS=0`` switches off (``core/env.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch

from .dtypes import torch_dtype


class ShapeDtypeStruct(NamedTuple):
    """What :meth:`OpDef.abstract_eval` returns for each output tensor (the
    counterpart of ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def _to_meta(x: Any) -> Any:
    """Arrays, tensors and shape/dtype structs -> meta tensors; containers
    are mapped through; anything else (Python scalars, strings) as is."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if hasattr(x, "shape") and hasattr(x, "dtype"):  # numpy arrays, shape/dtype structs
        return torch.empty(tuple(x.shape), dtype=torch_dtype(x.dtype), device="meta")
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    return x


def _to_struct(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return ShapeDtypeStruct(tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return {k: _to_struct(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_struct(v) for v in x)
    return x


@dataclasses.dataclass
class OpDef:
    name: str
    fn: Callable[..., Any]
    shape_fn: Optional[Callable[..., Any]] = None
    vjp: Optional[Callable[..., Any]] = None
    helper: Optional[Callable[..., Any]] = None  # accelerated variant
    doc: str = ""
    namespace: str = "ops"

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        from .env import get_environment

        impl = self.fn
        if self.helper is not None and get_environment().allow_helpers:
            impl = self.helper
        return impl(*args, **kwargs)

    def abstract_eval(self, *args: Any, **kwargs: Any):
        """Shape/dtype inference without execution (reference:
        calculateOutputShape): ``shape_fn`` when given, else ``fn`` run on
        meta tensors, its outputs as :class:`ShapeDtypeStruct`."""
        if self.shape_fn is not None:
            return self.shape_fn(*args, **kwargs)
        return _to_struct(self.fn(*_to_meta(args), **_to_meta(kwargs)))


class OpRegistry:
    _instance: Optional["OpRegistry"] = None

    def __init__(self) -> None:
        self._ops: Dict[str, OpDef] = {}

    @classmethod
    def instance(cls) -> "OpRegistry":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def register(self, op: OpDef) -> OpDef:
        if op.name in self._ops:
            raise ValueError(f"Op already registered: {op.name}")
        self._ops[op.name] = op
        return op

    def get(self, name: str) -> OpDef:
        try:
            return self._ops[name]
        except KeyError:
            raise KeyError(f"Unknown op {name!r}") from None

    def has(self, name: str) -> bool:
        return name in self._ops

    def names(self, namespace: Optional[str] = None) -> Sequence[str]:
        if namespace is None:
            return sorted(self._ops)
        return sorted(n for n, o in self._ops.items() if o.namespace == namespace)


def register_op(
    name: str,
    *,
    shape_fn: Optional[Callable[..., Any]] = None,
    vjp: Optional[Callable[..., Any]] = None,
    helper: Optional[Callable[..., Any]] = None,
    namespace: str = "ops",
) -> Callable[[Callable[..., Any]], OpDef]:
    """Decorator: register ``fn`` under ``name`` and return the OpDef wrapper."""

    def deco(fn: Callable[..., Any]) -> OpDef:
        op = OpDef(
            name=name, fn=fn, shape_fn=shape_fn, vjp=vjp, helper=helper,
            doc=fn.__doc__ or "", namespace=namespace,
        )
        return OpRegistry.instance().register(op)

    return deco


def get_op(name: str) -> OpDef:
    return OpRegistry.instance().get(name)
