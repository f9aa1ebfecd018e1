"""The port's ONNX wire-format reader (``modelimport/onnx_proto/onnx_wire.py``)
against the vendored protoc bindings (``onnx_pb2``).

* Every field of :data:`onnx_wire.SCHEMA` has ``onnx_pb2``'s number, label
  and type, and the table covers every field of every message.
* Messages serialized by ``onnx_pb2`` read back field by field: scalars,
  strings and bytes (``raw_data``), nested and repeated messages, repeated
  scalars packed and unpacked, negative varints, unknown fields skipped.
* ``HasField`` keeps proto3 presence: a singular message field (``shape``)
  and the ``dim_value`` / ``dim_param`` oneof, and refuses a field without
  presence as protobuf does.
"""

import struct

import numpy as np
import pytest

from deeplearning4j_tpu.modelimport.onnx_proto import onnx_pb2 as P

from deeplearning4j_tpu_torch.modelimport.onnx_proto import onnx_wire as W

_TYPES = {1: "double", 2: "float", 3: "int64", 4: "uint64", 5: "int32", 9: "string",
          11: "message", 12: "bytes", 13: "uint32", 14: "enum"}


def _descriptor(message: str):
    desc = P.DESCRIPTOR.message_types_by_name[message.split(".")[0]]
    for part in message.split(".")[1:]:
        desc = desc.nested_types_by_name[part]
    return desc


@pytest.mark.parametrize("message", sorted(W.SCHEMA))
def test_schema_matches_onnx_pb2_descriptors(message):
    desc = _descriptor(message)
    ours = {name: (num, typ) for name, num, typ in W.SCHEMA[message]}
    assert sorted(ours) == sorted(f.name for f in desc.fields)
    for f in desc.fields:
        num, typ = ours[f.name]
        assert num == f.number, (message, f.name)
        repeated = f.is_repeated if hasattr(f, "is_repeated") else f.label == f.LABEL_REPEATED
        assert typ.startswith("repeated ") == repeated, (message, f.name)
        base = typ.split()[-1]
        kind = _TYPES[f.type]
        if kind == "message":
            assert base == f.message_type.full_name[len(W.PACKAGE) + 1:], (message, f.name)
        else:
            assert base == kind, (message, f.name)
    assert W.FIELD_NUMBERS[f"{W.PACKAGE}.{message}"] == {f.name: f.number for f in desc.fields}


def test_oneofs_match_descriptors():
    desc = _descriptor("TensorShapeProto.Dimension")
    assert {f.name: o.name for o in desc.oneofs for f in o.fields} == \
        W.ONEOFS["TensorShapeProto.Dimension"]


def _model():
    m = P.ModelProto()
    m.ir_version, m.producer_name, m.model_version = 8, "wire-test", -3
    op = m.opset_import.add()
    op.domain, op.version = "", 17
    g = m.graph
    g.name, g.doc_string = "g", "ünïcode doc"
    t = g.initializer.add()
    t.name, t.data_type = "w", 1
    t.dims.extend([2, 3])
    t.raw_data = np.arange(6, dtype=np.float32).tobytes()
    t2 = g.initializer.add()
    t2.name, t2.data_type = "typed", 7
    t2.dims.extend([3])
    t2.int64_data.extend([-5, 0, 2 ** 40])
    t2.float_data.extend([1.5, -2.25])
    t2.double_data.extend([1e-300, -3.0])
    t2.int32_data.extend([-7, 8])
    t2.uint64_data.extend([2 ** 63 + 5])
    t2.string_data.extend([b"a", b"\x00b"])
    vi = g.input.add()
    vi.name = "x"
    tt = vi.type.tensor_type
    tt.elem_type = 7
    tt.shape.dim.add().dim_value = 16
    tt.shape.dim.add().dim_param = "seq"
    tt.shape.dim.add().dim_value = 0  # set to its default: still present (a oneof)
    tt.shape.dim.add()  # neither
    out = g.output.add()
    out.name = "y"  # no type at all
    n = g.node.add()
    n.op_type, n.name, n.domain = "Conv", "conv0", "ai.onnx"
    n.input.extend(["x", "w", ""])
    n.output.extend(["y"])
    a = n.attribute.add()
    a.name, a.type = "pads", P.AttributeProto.INTS
    a.ints.extend([1, -1, 0, 2 ** 33])
    a2 = n.attribute.add()
    a2.name, a2.type, a2.f, a2.i, a2.s = "mixed", P.AttributeProto.FLOAT, -0.5, -9, b"bytes"
    a2.floats.extend([0.25, -1.0])
    a2.strings.extend([b"p", b"q"])
    a2.t.CopyFrom(t)
    a2.g.name = "sub"
    a2.g.node.add().op_type = "Relu"
    return m


def _same(ours, theirs, path="m"):
    for name, _, typ in W.SCHEMA[ours._SPEC]:
        a, b = getattr(ours, name), getattr(theirs, name)
        base = typ.split()[-1]
        if typ.startswith("repeated "):
            assert len(a) == len(b), f"{path}.{name}"
            for i, (x, y) in enumerate(zip(a, b)):
                if base in W._CLASSES:
                    _same(x, y, f"{path}.{name}[{i}]")
                else:
                    assert x == y, f"{path}.{name}[{i}]"
        elif base in W._CLASSES:
            _same(a, b, f"{path}.{name}")
            assert a.__class__ is W._CLASSES[base]
        elif base == "float":
            assert a == struct.unpack("<f", struct.pack("<f", b))[0], f"{path}.{name}"
        else:
            assert a == b and type(a) is type(b), f"{path}.{name}"


def test_model_reads_field_by_field():
    m = _model()
    ours = W.ModelProto.FromString(m.SerializeToString())
    _same(ours, m)
    assert np.array_equal(np.frombuffer(ours.graph.initializer[0].raw_data, np.float32),
                          np.arange(6, dtype=np.float32))
    assert ours.graph.initializer[1].uint64_data == [2 ** 63 + 5]
    assert ours.graph.node[0].attribute[0].ints == [1, -1, 0, 2 ** 33]
    assert W.AttributeProto.INTS == P.AttributeProto.INTS == 7
    assert W.TensorProto.FLOAT16 == P.TensorProto.FLOAT16 == 10


def test_has_field_presence():
    m = _model()
    ours = W.ModelProto.FromString(m.SerializeToString())
    dims = ours.graph.input[0].type.tensor_type.shape.dim
    theirs = m.graph.input[0].type.tensor_type.shape.dim
    for field in ("dim_value", "dim_param"):
        assert [d.HasField(field) for d in dims] == [d.HasField(field) for d in theirs]
    assert [d.HasField("dim_value") for d in dims] == [True, False, True, False]
    assert ours.graph.input[0].type.tensor_type.HasField("shape")
    assert not ours.graph.output[0].type.tensor_type.HasField("shape")
    assert ours.graph.output[0].HasField("type") == m.graph.output[0].HasField("type") is False
    assert ours.HasField("graph") and ours.graph.node[0].attribute[1].HasField("t")
    for msg, field in ((dims[0], "denotation"), (ours, "ir_version"), (ours.graph, "node")):
        with pytest.raises(ValueError):
            msg.HasField(field)
    d = W.TensorShapeProto.Dimension()
    d.dim_value = 3
    d.dim_param = "n"  # a oneof: setting one member clears the other's presence
    assert not d.HasField("dim_value") and d.HasField("dim_param")


def _key(num, wt):
    return bytes(_varint((num << 3) | wt))


def _varint(v):
    v &= (1 << 64) - 1
    out = []
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return out


def test_repeated_scalars_packed_and_unpacked():
    ints = [3, -1, 2 ** 40]
    floats = [0.5, -2.0]
    unpacked = b"".join(_key(8, 0) + bytes(_varint(v)) for v in ints)
    unpacked += b"".join(_key(7, 5) + struct.pack("<f", v) for v in floats)
    packed_ints = b"".join(bytes(_varint(v)) for v in ints)
    packed = _key(8, 2) + bytes(_varint(len(packed_ints))) + packed_ints
    packed_f = struct.pack("<2f", *floats)
    packed += _key(7, 2) + bytes(_varint(len(packed_f))) + packed_f
    unknown = _key(99, 0) + bytes(_varint(5)) + _key(98, 2) + bytes(_varint(2)) + b"zz"
    for buf in (unpacked, packed, unknown + packed + unknown):
        ours, theirs = W.AttributeProto.FromString(buf), P.AttributeProto.FromString(buf)
        assert ours.ints == list(theirs.ints) == ints
        assert ours.floats == list(theirs.floats) == floats
    doubles = [1.0, -0.125]
    unpacked_d = b"".join(_key(10, 1) + struct.pack("<d", v) for v in doubles)
    unpacked_d += b"".join(_key(4, 5) + struct.pack("<f", v) for v in floats)
    ours, theirs = W.TensorProto.FromString(unpacked_d), P.TensorProto.FromString(unpacked_d)
    assert ours.double_data == list(theirs.double_data) == doubles
    assert ours.float_data == list(theirs.float_data) == floats


def test_singular_scalar_last_occurrence_wins():
    buf = _key(3, 0) + bytes(_varint(4)) + _key(3, 0) + bytes(_varint(-2))
    assert W.AttributeProto.FromString(buf).i == P.AttributeProto.FromString(buf).i == -2
