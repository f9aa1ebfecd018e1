"""A reader for ONNX's ``ModelProto``, without protobuf or the ``onnx``
package.

The ONNX importer (``modelimport/onnx.py``) reads a model through the
attribute surface of protoc's generated classes (the JAX package's
``onnx_proto/onnx_pb2.py``): ``ModelProto.graph``; ``GraphProto.node/
.initializer/.input``; ``NodeProto.op_type/.input/.output/.attribute``;
``AttributeProto.f/.i/.s/.t/.ints/.floats``; ``TensorProto.dims/.data_type/
.raw_data`` and the typed data fields; ``ValueInfoProto.type.tensor_type.
elem_type/.shape.dim[].dim_value``; and ``HasField("dim_value")`` and
``HasField("shape")``. This module decodes the wire format into plain
Python classes with that surface, through the varint and field primitives
of :mod:`..samediff.tf_graphdef`.

Field numbers, labels and types are the vendored schema's
(``deeplearning4j_tpu/modelimport/onnx_proto/onnx.proto``, the published
ONNX numbers), all in :data:`SCHEMA`; a test holds it against
``onnx_pb2``'s descriptors. Repeated scalars are read packed or unpacked.
``HasField`` answers for singular message fields and ``oneof`` members
(``dim_value`` against ``dim_param``), as protobuf's proto3 presence does,
and raises ``ValueError`` for a field without presence. Unknown fields are
skipped, as protobuf does.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

from ...samediff.tf_graphdef import FIXED32, FIXED64, LEN, _repeated, _signed32, _signed64, fields

PACKAGE = "dl4jtpu.onnx"

#: message -> ((field, number, type), ...); "repeated " marks a repeated
#: field, a capitalised type is a message of this schema
SCHEMA: Dict[str, Tuple[Tuple[str, int, str], ...]] = {
    "AttributeProto": (
        ("name", 1, "string"), ("ref_attr_name", 21, "string"), ("doc_string", 13, "string"),
        ("type", 20, "enum"), ("f", 2, "float"), ("i", 3, "int64"), ("s", 4, "bytes"),
        ("t", 5, "TensorProto"), ("g", 6, "GraphProto"), ("floats", 7, "repeated float"),
        ("ints", 8, "repeated int64"), ("strings", 9, "repeated bytes"),
        ("tensors", 10, "repeated TensorProto"), ("graphs", 11, "repeated GraphProto")),
    "ValueInfoProto": (("name", 1, "string"), ("type", 2, "TypeProto"),
                       ("doc_string", 3, "string")),
    "NodeProto": (
        ("input", 1, "repeated string"), ("output", 2, "repeated string"), ("name", 3, "string"),
        ("op_type", 4, "string"), ("domain", 7, "string"),
        ("attribute", 5, "repeated AttributeProto"), ("doc_string", 6, "string")),
    "ModelProto": (
        ("ir_version", 1, "int64"), ("opset_import", 8, "repeated OperatorSetIdProto"),
        ("producer_name", 2, "string"), ("producer_version", 3, "string"),
        ("domain", 4, "string"), ("model_version", 5, "int64"), ("doc_string", 6, "string"),
        ("graph", 7, "GraphProto"), ("functions", 25, "repeated FunctionProto")),
    "GraphProto": (
        ("node", 1, "repeated NodeProto"), ("name", 2, "string"),
        ("initializer", 5, "repeated TensorProto"), ("doc_string", 10, "string"),
        ("input", 11, "repeated ValueInfoProto"), ("output", 12, "repeated ValueInfoProto"),
        ("value_info", 13, "repeated ValueInfoProto")),
    "TensorProto": (
        ("dims", 1, "repeated int64"), ("data_type", 2, "int32"),
        ("float_data", 4, "repeated float"), ("int32_data", 5, "repeated int32"),
        ("string_data", 6, "repeated bytes"), ("int64_data", 7, "repeated int64"),
        ("name", 8, "string"), ("doc_string", 12, "string"), ("raw_data", 9, "bytes"),
        ("double_data", 10, "repeated double"), ("uint64_data", 11, "repeated uint64")),
    "TensorShapeProto": (("dim", 1, "repeated TensorShapeProto.Dimension"),),
    "TensorShapeProto.Dimension": (("dim_value", 1, "int64"), ("dim_param", 2, "string"),
                                   ("denotation", 3, "string")),
    "TypeProto": (("tensor_type", 1, "TypeProto.Tensor"), ("denotation", 6, "string")),
    "TypeProto.Tensor": (("elem_type", 1, "int32"), ("shape", 2, "TensorShapeProto")),
    "OperatorSetIdProto": (("domain", 1, "string"), ("version", 2, "int64")),
    "FunctionProto": (
        ("name", 1, "string"), ("input", 4, "repeated string"), ("output", 5, "repeated string"),
        ("attribute", 6, "repeated string"), ("node", 7, "repeated NodeProto"),
        ("doc_string", 8, "string"), ("opset_import", 9, "repeated OperatorSetIdProto"),
        ("domain", 10, "string")),
}

#: the schema's ``oneof`` groups: member -> group
ONEOFS = {"TensorShapeProto.Dimension": {"dim_value": "value", "dim_param": "value"}}

#: full message name -> {field: number}, as protobuf's descriptors name them
FIELD_NUMBERS = {f"{PACKAGE}.{m}": {name: num for name, num, _ in fs} for m, fs in SCHEMA.items()}

# scalar type -> (default, the kind ``_repeated`` decodes)
_SCALARS = {"int64": (0, "i64"), "int32": (0, "i32"), "enum": (0, "i32"), "uint64": (0, "u"),
            "float": (0.0, "f32"), "double": (0.0, "f64"), "string": ("", None),
            "bytes": (b"", None)}
_CLASSES: Dict[str, type] = {}


class _Message:
    """A message of :data:`SCHEMA`: each field an attribute under its
    proto name, at its proto3 default until read."""

    _SPEC = ""  # key in SCHEMA

    def __init__(self, **values) -> None:
        object.__setattr__(self, "_present", set())
        for name, _, typ in SCHEMA[self._SPEC]:
            base = typ.split()[-1]
            object.__setattr__(self, name, [] if typ.startswith("repeated ") else
                               _SCALARS[base][0] if base in _SCALARS else _CLASSES[base]())
        for k, v in values.items():
            setattr(self, k, v)

    def __setattr__(self, name, value) -> None:
        object.__setattr__(self, name, value)
        if name in _PRESENCE[self._SPEC]:
            group = ONEOFS.get(self._SPEC, {})
            self._present.difference_update(
                o for o, g in group.items() if g == group.get(name, name + "/"))
            self._present.add(name)

    def HasField(self, name: str) -> bool:
        if name not in _PRESENCE[self._SPEC]:
            raise ValueError(f'Protocol message {self._SPEC} has no "{name}" field with '
                             "presence")
        return name in self._present

    @classmethod
    def FromString(cls, buf) -> "_Message":
        out = cls()
        by_number = _BY_NUMBER[cls._SPEC]
        for num, wt, val in fields(memoryview(buf) if isinstance(buf, (bytes, bytearray)) else buf):
            if num not in by_number:
                continue  # unknown field: skipped, as protobuf does
            name, typ = by_number[num]
            repeated, base = typ.startswith("repeated "), typ.split()[-1]
            if base in ("string", "bytes") or base in _CLASSES:
                if wt != LEN:
                    raise ValueError(f"{cls._SPEC}.{name}: wire type {wt}, expected {LEN}")
                value = (bytes(val).decode() if base == "string" else bytes(val)
                         if base == "bytes" else _CLASSES[base].FromString(val))
                if repeated:
                    getattr(out, name).append(value)
                else:
                    setattr(out, name, value)
                continue
            kind = _SCALARS[base][1]
            if kind in ("f32", "f64") and wt not in (LEN, FIXED32 if kind == "f32" else FIXED64):
                raise ValueError(f"{cls._SPEC}.{name}: wire type {wt} for a {base}")
            values = _repeated(wt, val, kind)
            if repeated:
                getattr(out, name).extend(values)
            elif values:
                setattr(out, name, values[-1])  # the last occurrence wins
        return out


_BY_NUMBER = {m: {num: (name, typ) for name, num, typ in fs} for m, fs in SCHEMA.items()}
#: the fields ``HasField`` answers for: singular messages and oneof members
_PRESENCE = {m: frozenset(name for name, _, typ in fs if not typ.startswith("repeated ")
                          and (typ not in _SCALARS or name in ONEOFS.get(m, {})))
             for m, fs in SCHEMA.items()}


def _message(spec: str, **enums) -> type:
    cls = type(spec.replace(".", ""), (_Message,), {"_SPEC": spec, **enums})
    _CLASSES[spec] = cls
    return cls


AttributeProto = _message(
    "AttributeProto", UNDEFINED=0, FLOAT=1, INT=2, STRING=3, TENSOR=4, GRAPH=5, SPARSE_TENSOR=11,
    FLOATS=6, INTS=7, STRINGS=8, TENSORS=9, GRAPHS=10)
ValueInfoProto = _message("ValueInfoProto")
NodeProto = _message("NodeProto")
ModelProto = _message("ModelProto")
GraphProto = _message("GraphProto")
TensorProto = _message(
    "TensorProto", UNDEFINED=0, FLOAT=1, UINT8=2, INT8=3, UINT16=4, INT16=5, INT32=6, INT64=7,
    STRING=8, BOOL=9, FLOAT16=10, DOUBLE=11, UINT32=12, UINT64=13, COMPLEX64=14,
    COMPLEX128=15, BFLOAT16=16)
TensorShapeProto = _message("TensorShapeProto")
TensorShapeProto.Dimension = _message("TensorShapeProto.Dimension")
TypeProto = _message("TypeProto")
TypeProto.Tensor = _message("TypeProto.Tensor")
OperatorSetIdProto = _message("OperatorSetIdProto")
FunctionProto = _message("FunctionProto")

__all__ = ["AttributeProto", "FIELD_NUMBERS", "FunctionProto", "GraphProto", "ModelProto",
           "NodeProto", "OperatorSetIdProto", "SCHEMA", "TensorProto", "TensorShapeProto",
           "TypeProto", "ValueInfoProto"]
