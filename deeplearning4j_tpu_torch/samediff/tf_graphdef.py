"""A reader for TensorFlow's ``GraphDef`` protobuf, without TensorFlow or
protobuf.

The TF importer (``tf_import.py``) and the control-flow rewrite
(``tf_control_flow.py``) read a frozen graph through the attribute surface
of TF's generated classes: ``GraphDef.node`` and ``.library.function``;
``NodeDef.name/.op/.input/.attr``; ``AttrValue.s/.i/.f/.b/.type/.shape/
.tensor/.func/.list``; ``TensorShapeProto.dim[].size``; ``FunctionDef.
signature/.node_def/.ret``. This module decodes the protobuf wire format
(varints, fixed 32/64-bit words, length-delimited fields; packed and
unpacked repeated scalars) into plain Python classes with exactly that
surface, so the importer runs where TensorFlow is not installed.

Field numbers are TF's own (``tensorflow/core/framework/*.proto``; a test
holds every number below against TF's descriptors). Unknown fields are
skipped, as protobuf does.

Also here: :func:`make_ndarray` (``tensor_util.MakeNdarray``'s semantics),
the table from TF dtype enums to numpy and torch dtypes (in place of
``tf.dtypes.as_dtype``), and plain constructors, with which the V1-loop
rewrite builds nodes and functions.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

# ---- TF DataType enum (types.proto) -----------------------------------------
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8, DT_STRING = 1, 2, 3, 4, 5, 6, 7
DT_COMPLEX64, DT_INT64, DT_BOOL = 8, 9, 10
DT_BFLOAT16, DT_UINT16, DT_COMPLEX128, DT_HALF = 14, 17, 18, 19
DT_UINT32, DT_UINT64 = 22, 23

#: TF DataType enum -> (numpy dtype, torch dtype). bfloat16 has no numpy
#: dtype here: its values decode to float32 (exactly) and carry the torch dtype.
DTYPES: Dict[int, Tuple[np.dtype, torch.dtype]] = {
    DT_FLOAT: (np.dtype(np.float32), torch.float32),
    DT_DOUBLE: (np.dtype(np.float64), torch.float64),
    DT_INT32: (np.dtype(np.int32), torch.int32),
    DT_UINT8: (np.dtype(np.uint8), torch.uint8),
    DT_INT16: (np.dtype(np.int16), torch.int16),
    DT_INT8: (np.dtype(np.int8), torch.int8),
    DT_STRING: (np.dtype(object), None),
    DT_COMPLEX64: (np.dtype(np.complex64), torch.complex64),
    DT_INT64: (np.dtype(np.int64), torch.int64),
    DT_BOOL: (np.dtype(np.bool_), torch.bool),
    DT_BFLOAT16: (np.dtype(np.float32), torch.bfloat16),
    DT_UINT16: (np.dtype(np.uint16), torch.uint16),
    DT_COMPLEX128: (np.dtype(np.complex128), torch.complex128),
    DT_HALF: (np.dtype(np.float16), torch.float16),
    DT_UINT32: (np.dtype(np.uint32), torch.uint32),
    DT_UINT64: (np.dtype(np.uint64), torch.uint64),
}


def _ref_base(t: int) -> int:
    return t - 100 if t > 100 else t  # *_REF types carry the base type + 100


def numpy_dtype(t: int) -> np.dtype:
    try:
        return DTYPES[_ref_base(int(t))][0]
    except KeyError:
        raise TypeError(f"unsupported TF dtype enum {t}") from None


def torch_dtype_of(t: int) -> torch.dtype:
    dt = DTYPES.get(_ref_base(int(t)), (None, None))[1]
    if dt is None:
        raise TypeError(f"TF dtype enum {t} has no torch dtype")
    return dt


# ---- wire format -------------------------------------------------------------
VARINT, FIXED64, LEN, FIXED32 = 0, 1, 2, 5


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def fields(buf: bytes):
    """Yield (field number, wire type, value) of a message; a varint as an
    unsigned int, fixed words as raw bytes, LEN as a memory slice."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == VARINT:
            val, pos = _varint(buf, pos)
        elif wt == FIXED64:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wt == LEN:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wt == FIXED32:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {num})")
        yield num, wt, val


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _signed32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _varints(buf: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _varint(buf, pos)
        out.append(v)
    return out


def _repeated(wt: int, val, kind: str) -> list:
    """One occurrence of a repeated scalar field, packed (LEN) or not.
    ``kind``: "i64", "i32", "u", "bool", "f32", "f64"."""
    if kind in ("f32", "f64"):
        return [v[0] for v in struct.iter_unpack("<f" if kind == "f32" else "<d", bytes(val))]
    vals = _varints(bytes(val)) if wt == LEN else [val]
    if kind == "i64":
        return [_signed64(v) for v in vals]
    if kind == "i32":
        return [_signed32(v) for v in vals]
    if kind == "bool":
        return [bool(v) for v in vals]
    return vals


#: TF's field numbers, by message (a test holds them against TF's
#: descriptors); every parser below reads its numbers from here
FIELD_NUMBERS = {
    "tensorflow.GraphDef": {"node": 1, "library": 2, "versions": 4},
    "tensorflow.NodeDef": {"name": 1, "op": 2, "input": 3, "device": 4, "attr": 5},
    "tensorflow.AttrValue": {"list": 1, "s": 2, "i": 3, "f": 4, "b": 5, "type": 6,
                             "shape": 7, "tensor": 8, "placeholder": 9, "func": 10},
    "tensorflow.AttrValue.ListValue": {"s": 2, "i": 3, "f": 4, "b": 5, "type": 6,
                                       "shape": 7, "tensor": 8, "func": 9},
    "tensorflow.NameAttrList": {"name": 1, "attr": 2},
    "tensorflow.TensorProto": {"dtype": 1, "tensor_shape": 2, "tensor_content": 4,
                               "float_val": 5, "double_val": 6, "int_val": 7,
                               "string_val": 8, "scomplex_val": 9, "int64_val": 10,
                               "bool_val": 11, "dcomplex_val": 12, "half_val": 13,
                               "uint32_val": 16, "uint64_val": 17},
    "tensorflow.TensorShapeProto": {"dim": 2, "unknown_rank": 3},
    "tensorflow.TensorShapeProto.Dim": {"size": 1, "name": 2},
    "tensorflow.FunctionDefLibrary": {"function": 1},
    "tensorflow.FunctionDef": {"signature": 1, "node_def": 3, "ret": 4},
    "tensorflow.OpDef": {"name": 1, "input_arg": 2, "output_arg": 3},
    "tensorflow.OpDef.ArgDef": {"name": 1, "type": 3, "type_attr": 4},
    "tensorflow.VersionDef": {"producer": 1, "min_consumer": 2},
}
_F = FIELD_NUMBERS


# ---- message classes -----------------------------------------------------------
@dataclasses.dataclass
class Dim:
    size: int = 0
    name: str = ""


@dataclasses.dataclass
class TensorShapeProto:
    dim: List[Dim] = dataclasses.field(default_factory=list)
    unknown_rank: bool = False

    @classmethod
    def parse(cls, buf) -> "TensorShapeProto":
        out, f, fd = cls(), _F["tensorflow.TensorShapeProto"], _F["tensorflow.TensorShapeProto.Dim"]
        for num, wt, val in fields(buf):
            if num == f["dim"]:
                d = Dim()
                for n2, _, v2 in fields(val):
                    if n2 == fd["size"]:
                        d.size = _signed64(v2)
                    elif n2 == fd["name"]:
                        d.name = bytes(v2).decode()
                out.dim.append(d)
            elif num == f["unknown_rank"]:
                out.unknown_rank = bool(val)
        return out


_TENSOR_REPEATED = {  # field number -> (attribute, kind)
    _F["tensorflow.TensorProto"][attr]: (attr, kind) for attr, kind in (
        ("half_val", "i32"), ("float_val", "f32"), ("double_val", "f64"), ("int_val", "i32"),
        ("scomplex_val", "f32"), ("int64_val", "i64"), ("bool_val", "bool"),
        ("dcomplex_val", "f64"), ("uint32_val", "u"), ("uint64_val", "u"))}


@dataclasses.dataclass
class TensorProto:
    dtype: int = 0
    tensor_shape: TensorShapeProto = dataclasses.field(default_factory=TensorShapeProto)
    tensor_content: bytes = b""
    half_val: List[int] = dataclasses.field(default_factory=list)
    float_val: List[float] = dataclasses.field(default_factory=list)
    double_val: List[float] = dataclasses.field(default_factory=list)
    int_val: List[int] = dataclasses.field(default_factory=list)
    string_val: List[bytes] = dataclasses.field(default_factory=list)
    scomplex_val: List[float] = dataclasses.field(default_factory=list)
    int64_val: List[int] = dataclasses.field(default_factory=list)
    bool_val: List[bool] = dataclasses.field(default_factory=list)
    dcomplex_val: List[float] = dataclasses.field(default_factory=list)
    uint32_val: List[int] = dataclasses.field(default_factory=list)
    uint64_val: List[int] = dataclasses.field(default_factory=list)

    @classmethod
    def parse(cls, buf) -> "TensorProto":
        out, f = cls(), _F["tensorflow.TensorProto"]
        for num, wt, val in fields(buf):
            if num == f["dtype"]:
                out.dtype = val
            elif num == f["tensor_shape"]:
                out.tensor_shape = TensorShapeProto.parse(val)
            elif num == f["tensor_content"]:
                out.tensor_content = bytes(val)
            elif num == f["string_val"]:
                out.string_val.append(bytes(val))
            elif num in _TENSOR_REPEATED:
                attr, kind = _TENSOR_REPEATED[num]
                getattr(out, attr).extend(_repeated(wt, val, kind))
        return out


@dataclasses.dataclass
class NameAttrList:
    name: str = ""
    attr: Dict[str, "AttrValue"] = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, buf) -> "NameAttrList":
        out, f = cls(), _F["tensorflow.NameAttrList"]
        for num, _, val in fields(buf):
            if num == f["name"]:
                out.name = bytes(val).decode()
            elif num == f["attr"]:
                k, v = _map_entry(val, AttrValue.parse)
                out.attr[k] = v
        return out


@dataclasses.dataclass
class ListValue:
    s: List[bytes] = dataclasses.field(default_factory=list)
    i: List[int] = dataclasses.field(default_factory=list)
    f: List[float] = dataclasses.field(default_factory=list)
    b: List[bool] = dataclasses.field(default_factory=list)
    type: List[int] = dataclasses.field(default_factory=list)
    shape: List[TensorShapeProto] = dataclasses.field(default_factory=list)
    tensor: List[TensorProto] = dataclasses.field(default_factory=list)
    func: List[NameAttrList] = dataclasses.field(default_factory=list)

    @classmethod
    def parse(cls, buf) -> "ListValue":
        out, f = cls(), _F["tensorflow.AttrValue.ListValue"]
        for num, wt, val in fields(buf):
            if num == f["s"]:
                out.s.append(bytes(val))
            elif num == f["i"]:
                out.i.extend(_repeated(wt, val, "i64"))
            elif num == f["f"]:
                out.f.extend(_repeated(wt, val, "f32"))
            elif num == f["b"]:
                out.b.extend(_repeated(wt, val, "bool"))
            elif num == f["type"]:
                out.type.extend(_repeated(wt, val, "i32"))
            elif num == f["shape"]:
                out.shape.append(TensorShapeProto.parse(val))
            elif num == f["tensor"]:
                out.tensor.append(TensorProto.parse(val))
            elif num == f["func"]:
                out.func.append(NameAttrList.parse(val))
        return out


@dataclasses.dataclass
class AttrValue:
    s: bytes = b""
    i: int = 0
    f: float = 0.0
    b: bool = False
    type: int = 0
    shape: TensorShapeProto = dataclasses.field(default_factory=TensorShapeProto)
    tensor: TensorProto = dataclasses.field(default_factory=TensorProto)
    list: ListValue = dataclasses.field(default_factory=ListValue)
    func: NameAttrList = dataclasses.field(default_factory=NameAttrList)
    placeholder: str = ""

    @classmethod
    def parse(cls, buf) -> "AttrValue":
        out, f = cls(), _F["tensorflow.AttrValue"]
        for num, wt, val in fields(buf):
            if num == f["s"]:
                out.s = bytes(val)
            elif num == f["i"]:
                out.i = _signed64(val)
            elif num == f["f"]:
                out.f = struct.unpack("<f", bytes(val))[0]
            elif num == f["b"]:
                out.b = bool(val)
            elif num == f["type"]:
                out.type = val
            elif num == f["shape"]:
                out.shape = TensorShapeProto.parse(val)
            elif num == f["tensor"]:
                out.tensor = TensorProto.parse(val)
            elif num == f["list"]:
                out.list = ListValue.parse(val)
            elif num == f["func"]:
                out.func = NameAttrList.parse(val)
            elif num == f["placeholder"]:
                out.placeholder = bytes(val).decode()
        return out


def _map_entry(buf, parse_value):
    """A map field's entry: key 1, value 2 (protobuf's map encoding)."""
    key, value = "", None
    for num, _, val in fields(buf):
        if num == 1:
            key = bytes(val).decode()
        elif num == 2:
            value = parse_value(val)
    return key, value if value is not None else parse_value(b"")


@dataclasses.dataclass
class NodeDef:
    name: str = ""
    op: str = ""
    input: List[str] = dataclasses.field(default_factory=list)
    device: str = ""
    attr: Dict[str, AttrValue] = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, buf) -> "NodeDef":
        out, f = cls(), _F["tensorflow.NodeDef"]
        for num, _, val in fields(buf):
            if num == f["name"]:
                out.name = bytes(val).decode()
            elif num == f["op"]:
                out.op = bytes(val).decode()
            elif num == f["input"]:
                out.input.append(bytes(val).decode())
            elif num == f["device"]:
                out.device = bytes(val).decode()
            elif num == f["attr"]:
                k, v = _map_entry(val, AttrValue.parse)
                out.attr[k] = v
        return out

    def copy(self, **changes) -> "NodeDef":
        """A copy sharing the attr values, with ``changes`` applied."""
        kw = dict(name=self.name, op=self.op, input=list(self.input), device=self.device,
                  attr=dict(self.attr))
        kw.update(changes)
        return NodeDef(**kw)


@dataclasses.dataclass
class ArgDef:
    name: str = ""
    type: int = 0
    type_attr: str = ""

    @classmethod
    def parse(cls, buf) -> "ArgDef":
        out, f = cls(), _F["tensorflow.OpDef.ArgDef"]
        for num, _, val in fields(buf):
            if num == f["name"]:
                out.name = bytes(val).decode()
            elif num == f["type"]:
                out.type = val
            elif num == f["type_attr"]:
                out.type_attr = bytes(val).decode()
        return out


@dataclasses.dataclass
class OpDef:
    name: str = ""
    input_arg: List[ArgDef] = dataclasses.field(default_factory=list)
    output_arg: List[ArgDef] = dataclasses.field(default_factory=list)

    @classmethod
    def parse(cls, buf) -> "OpDef":
        out, f = cls(), _F["tensorflow.OpDef"]
        for num, _, val in fields(buf):
            if num == f["name"]:
                out.name = bytes(val).decode()
            elif num == f["input_arg"]:
                out.input_arg.append(ArgDef.parse(val))
            elif num == f["output_arg"]:
                out.output_arg.append(ArgDef.parse(val))
        return out


@dataclasses.dataclass
class FunctionDef:
    signature: OpDef = dataclasses.field(default_factory=OpDef)
    node_def: List[NodeDef] = dataclasses.field(default_factory=list)
    ret: Dict[str, str] = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, buf) -> "FunctionDef":
        out, f = cls(), _F["tensorflow.FunctionDef"]
        for num, _, val in fields(buf):
            if num == f["signature"]:
                out.signature = OpDef.parse(val)
            elif num == f["node_def"]:
                out.node_def.append(NodeDef.parse(val))
            elif num == f["ret"]:
                k, v = _map_entry(val, lambda b: bytes(b).decode())
                out.ret[k] = v
        return out


@dataclasses.dataclass
class FunctionDefLibrary:
    function: List[FunctionDef] = dataclasses.field(default_factory=list)

    @classmethod
    def parse(cls, buf) -> "FunctionDefLibrary":
        out, f = cls(), _F["tensorflow.FunctionDefLibrary"]
        for num, _, val in fields(buf):
            if num == f["function"]:
                out.function.append(FunctionDef.parse(val))
        return out


@dataclasses.dataclass
class VersionDef:
    producer: int = 0
    min_consumer: int = 0

    @classmethod
    def parse(cls, buf) -> "VersionDef":
        out, f = cls(), _F["tensorflow.VersionDef"]
        for num, _, val in fields(buf):
            if num == f["producer"]:
                out.producer = _signed32(val)
            elif num == f["min_consumer"]:
                out.min_consumer = _signed32(val)
        return out


@dataclasses.dataclass
class GraphDef:
    node: List[NodeDef] = dataclasses.field(default_factory=list)
    library: FunctionDefLibrary = dataclasses.field(default_factory=FunctionDefLibrary)
    versions: VersionDef = dataclasses.field(default_factory=VersionDef)

    @classmethod
    def parse(cls, buf) -> "GraphDef":
        out, f = cls(), _F["tensorflow.GraphDef"]
        buf = memoryview(bytes(buf))
        for num, _, val in fields(buf):
            if num == f["node"]:
                out.node.append(NodeDef.parse(val))
            elif num == f["library"]:
                out.library = FunctionDefLibrary.parse(val)
            elif num == f["versions"]:
                out.versions = VersionDef.parse(val)
        return out

    FromString = parse


def read_graph_def(path) -> GraphDef:
    """A ``GraphDef`` from a file of its serialized bytes (gzipped when the
    name ends in ``.gz``)."""
    path = path.decode() if isinstance(path, bytes) else str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return GraphDef.parse(f.read())


def as_graph_def(obj) -> GraphDef:
    """A path, the port's own ``GraphDef``, or any object with
    ``SerializeToString()`` (a TF GraphDef) -> the port's ``GraphDef``."""
    if isinstance(obj, (str, bytes)):
        return read_graph_def(obj)
    if isinstance(obj, GraphDef):
        return obj
    if hasattr(obj, "SerializeToString"):
        return GraphDef.parse(obj.SerializeToString())
    raise TypeError(f"not a GraphDef or a path: {type(obj).__name__}")


# ---- tensor_util.MakeNdarray ---------------------------------------------------
def make_ndarray(t: TensorProto) -> np.ndarray:
    """``tensor_util.MakeNdarray``: ``tensor_content`` when present, else the
    typed value list, a short list padded with its last value, an empty
    one as zeros. bfloat16 decodes to float32 (exact)."""
    shape = [d.size for d in t.tensor_shape.dim]
    n = int(np.prod(shape, dtype=np.int64))
    base = _ref_base(int(t.dtype))
    dtype = numpy_dtype(base)
    if base == DT_BFLOAT16:
        if t.tensor_content:
            bits = np.frombuffer(t.tensor_content, dtype=np.uint16)
        else:
            bits = np.asarray(t.half_val, dtype=np.uint32).astype(np.uint16)
        values = (bits.astype(np.uint32) << 16).view(np.float32)
    elif t.tensor_content:
        return np.frombuffer(t.tensor_content, dtype=dtype).copy().reshape(shape)
    elif base == DT_STRING:
        vals = list(t.string_val)
        if n > len(vals):
            vals.extend([vals[-1] if vals else b""] * (n - len(vals)))
        return np.array(vals, dtype=object).reshape(shape)
    elif base == DT_HALF:
        values = np.asarray(t.half_val, dtype=np.uint32).astype(np.uint16).view(np.float16)
    elif base == DT_FLOAT:
        values = np.asarray(t.float_val, dtype=np.float32)
    elif base == DT_DOUBLE:
        values = np.asarray(t.double_val, dtype=np.float64)
    elif base in (DT_INT32, DT_UINT8, DT_UINT16, DT_INT16, DT_INT8):
        values = np.asarray(t.int_val, dtype=np.int64).astype(dtype)
    elif base == DT_INT64:
        values = np.asarray(t.int64_val, dtype=np.int64)
    elif base == DT_UINT32:
        values = np.asarray(t.uint32_val, dtype=np.uint32)
    elif base == DT_UINT64:
        values = np.asarray(t.uint64_val, dtype=np.uint64)
    elif base in (DT_COMPLEX64, DT_COMPLEX128):
        raw = np.asarray(t.scomplex_val if base == DT_COMPLEX64 else t.dcomplex_val)
        values = (raw[0::2] + 1j * raw[1::2]).astype(dtype)
    elif base == DT_BOOL:
        values = np.asarray(t.bool_val, dtype=np.bool_)
    else:
        raise TypeError(f"unsupported TF dtype enum {t.dtype}")
    if values.size == 0:
        return np.zeros(shape, values.dtype)
    if values.size != n:
        values = np.pad(values, (0, n - values.size), "edge")
    return values.reshape(shape)
