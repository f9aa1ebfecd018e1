"""Data types and input conversion (port of the parts of
``deeplearning4j_tpu/core/dtypes.py`` that the model path needs).

Also the port's device default: entry points run on ``cuda`` unless the
caller names another device. There is no silent CPU fallback: without a
card, the default raises and the caller must pass ``device="cpu"``.
"""

from __future__ import annotations

import enum
from typing import Optional, Union

import numpy as np
import torch

_TORCH_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}


class DataType(enum.Enum):
    """The reference's ``org.nd4j.linalg.api.buffer.DataType`` vocabulary,
    as in the JAX package, mapped onto torch dtypes (:attr:`torch`, where
    the JAX package has ``.jnp``)."""

    DOUBLE = "float64"
    FLOAT = "float32"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    LONG = "int64"
    INT = "int32"
    SHORT = "int16"
    BYTE = "int8"
    UBYTE = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    BOOL = "bool"
    UTF8 = "object"  # host-only; never reaches the device

    @property
    def np(self) -> np.dtype:
        """The numpy dtype. numpy has no bfloat16: its host copies are
        float32 (see :func:`to_numpy`)."""
        if self is DataType.BFLOAT16:
            return np.dtype(np.float32)
        return np.dtype(self.value)

    @property
    def torch(self) -> torch.dtype:
        if self is DataType.UTF8:
            raise ValueError("UTF8 is a host-only dtype")
        return getattr(torch, self.value)

    @property
    def is_floating(self) -> bool:
        return self in (DataType.DOUBLE, DataType.FLOAT, DataType.HALF, DataType.BFLOAT16)

    @property
    def is_integer(self) -> bool:
        return self in (
            DataType.LONG, DataType.INT, DataType.SHORT, DataType.BYTE,
            DataType.UBYTE, DataType.UINT16, DataType.UINT32, DataType.UINT64,
        )

    @classmethod
    def from_any(cls, d) -> "DataType":
        """A DataType, a dtype name, or a numpy or torch dtype."""
        if isinstance(d, DataType):
            return d
        if isinstance(d, torch.dtype):
            name = str(d).replace("torch.", "")
        elif isinstance(d, str):
            name = d
        else:
            name = np.dtype(d).name
        by_name = {"float64": cls.DOUBLE, "float32": cls.FLOAT, "float16": cls.HALF}
        if name in by_name:
            return by_name[name]
        for m in cls:
            if m.value == name or m.name == name.upper():
                return m
        raise ValueError(f"Unknown dtype: {d!r}")


def default_float_dtype() -> torch.dtype:
    """The process default float dtype (``DL4J_TPU_DTYPE``, or float64
    after ``Environment.enable_x64()``), as a torch dtype."""
    from .env import get_environment

    return torch_dtype(get_environment().default_dtype)


def torch_dtype(d: Union[str, torch.dtype, np.dtype, type]) -> torch.dtype:
    """A dtype name as the config DSL writes it ("float32", "bfloat16"...)
    or a numpy/torch dtype -> the torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    name = d if isinstance(d, str) else np.dtype(d).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"Unknown dtype: {d!r}") from None


def default_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device. Raises when no card is present and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def as_input(x, dtype: torch.dtype, keep_int: bool = False,
             device: Optional[torch.device] = None) -> torch.Tensor:
    """Convert a model input to a tensor on ``device`` at the model's float
    dtype. With ``keep_int`` (the input feeds an index-consuming layer),
    integer inputs keep their dtype: token ids must never pass through a
    float dtype, which represents large ids inexactly."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        arr = np.asarray(x)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if device is not None and t.device != device:
        t = t.to(device)
    if t.dtype == dtype:
        return t
    if keep_int and not t.is_floating_point():
        return t
    return t.to(dtype)


def as_input_np(x, dtype, keep_int: bool = False) -> np.ndarray:
    """Host-side twin of :func:`as_input` for code that keeps a batch on
    the host until it places it itself (the sharded loader and the
    distributed trainer): a numpy array at ``dtype`` (a torch or numpy
    dtype), integer inputs kept as they are under ``keep_int``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    want = torch.empty((), dtype=dtype).numpy().dtype if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype)
    if arr.dtype == want:
        return arr
    if keep_int and not np.issubdtype(arr.dtype, np.floating):
        return arr
    return arr.astype(want)


def cast_floats(tree, dtype):
    """Cast every floating-point tensor of a nested dict / list / tuple to
    ``dtype``, leaving integer and bool tensors and ``None`` untouched.

    This is the mixed-precision boundary cast: the model keeps float32
    master parameters and the forward and backward run in
    ``compute_dtype`` (bfloat16 on the card's tensor cores). The cast is
    differentiable, so gradients flow back to the master parameters in
    their own dtype."""
    want = torch_dtype(dtype)

    def cast(leaf):
        if isinstance(leaf, dict):
            return {k: cast(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(cast(v) for v in leaf)
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and leaf.dtype != want:
            return leaf.to(want)
        return leaf

    return cast(tree)


def promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under JAX's type promotion. torch's product refuses mixed
    float dtypes, which a ``compute_dtype`` model meets in the KV-cached
    decode: the cache holds the master dtype, so the attention output is
    promoted (see ``ops.decode_attention``) while the cast weights stay in
    ``compute_dtype``; ``jnp.matmul`` promotes both to the wider type."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def to_numpy(x):
    """A host numpy copy of a tensor (bfloat16, which numpy lacks, as
    float32); numpy arrays and ``None`` pass through."""
    if x is None or not isinstance(x, torch.Tensor):
        return None if x is None else np.asarray(x)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()
