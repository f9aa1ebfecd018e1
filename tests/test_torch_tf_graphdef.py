"""The port's GraphDef reader (``samediff/tf_graphdef.py``) against
TensorFlow's own parse.

* Every field number the reader uses equals TF's descriptor's.
* TF-built graphs (a tiny frozen BERT, functional While/If with library
  functions, a V1 while loop) decode field by field as TF's parse does:
  names, ops, inputs, every attr's value (tensors through
  ``tensor_util.MakeNdarray`` against :func:`make_ndarray`), and the
  library's signatures, bodies and returns.
* Constants of every dtype, splat and short value lists, ``half_val`` for
  f16/bf16, strings, negative int32 varints, and repeated scalars both
  packed and unpacked, decode to TF's arrays.
* The committed BERT-base skeleton decodes to 1,649 nodes with the op set
  of ``bench.py``'s frozen graph.
"""

import gzip

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from tensorflow.core.framework import (attr_value_pb2, function_pb2, graph_pb2,  # noqa: E402
                                       node_def_pb2, op_def_pb2, tensor_pb2,
                                       tensor_shape_pb2, versions_pb2)
from tensorflow.python.framework import tensor_util  # noqa: E402
from tensorflow.python.framework.convert_to_constants import (  # noqa: E402
    convert_variables_to_constants_v2,
)

from deeplearning4j_tpu_torch.samediff import tf_graphdef as g  # noqa: E402
from deeplearning4j_tpu_torch.tools import bert_skeleton  # noqa: E402

_DESCRIPTORS = {
    "tensorflow.GraphDef": graph_pb2.GraphDef,
    "tensorflow.NodeDef": node_def_pb2.NodeDef,
    "tensorflow.AttrValue": attr_value_pb2.AttrValue,
    "tensorflow.AttrValue.ListValue": attr_value_pb2.AttrValue.ListValue,
    "tensorflow.NameAttrList": attr_value_pb2.NameAttrList,
    "tensorflow.TensorProto": tensor_pb2.TensorProto,
    "tensorflow.TensorShapeProto": tensor_shape_pb2.TensorShapeProto,
    "tensorflow.TensorShapeProto.Dim": tensor_shape_pb2.TensorShapeProto.Dim,
    "tensorflow.FunctionDefLibrary": function_pb2.FunctionDefLibrary,
    "tensorflow.FunctionDef": function_pb2.FunctionDef,
    "tensorflow.OpDef": op_def_pb2.OpDef,
    "tensorflow.OpDef.ArgDef": op_def_pb2.OpDef.ArgDef,
    "tensorflow.VersionDef": versions_pb2.VersionDef,
}


@pytest.mark.parametrize("message", sorted(g.FIELD_NUMBERS))
def test_field_numbers_match_tf_descriptors(message):
    desc = _DESCRIPTORS[message].DESCRIPTOR
    assert desc.full_name == message
    for field, number in g.FIELD_NUMBERS[message].items():
        assert desc.fields_by_name[field].number == number, (message, field)


def test_dtype_table_matches_tf():
    for enum, (np_dt, _) in g.DTYPES.items():
        tf_dt = tf.dtypes.as_dtype(enum)
        if enum == g.DT_BFLOAT16:
            assert tf_dt.name == "bfloat16"
        elif enum == g.DT_STRING:
            assert tf_dt == tf.string
        else:
            assert np.dtype(tf_dt.as_numpy_dtype) == np_dt, tf_dt


# ---- field-by-field comparison -------------------------------------------------
def _same_array(ours, theirs):
    if theirs.dtype.name == "bfloat16":
        theirs = theirs.astype(np.float32)
    assert ours.shape == theirs.shape
    if theirs.dtype == object:
        assert ours.dtype == object and list(ours.ravel()) == list(theirs.ravel())
    else:
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def _same_shape(ours, theirs):
    assert [d.size for d in ours.dim] == [d.size for d in theirs.dim]
    assert ours.unknown_rank == theirs.unknown_rank


def _same_attr(ours, theirs, where):
    kind = theirs.WhichOneof("value")
    if kind == "s":
        assert ours.s == theirs.s, where
    elif kind in ("i", "f", "b", "type"):
        assert getattr(ours, kind) == pytest.approx(getattr(theirs, kind)), where
    elif kind == "shape":
        _same_shape(ours.shape, theirs.shape)
    elif kind == "tensor":
        _same_array(g.make_ndarray(ours.tensor), tensor_util.MakeNdarray(theirs.tensor))
    elif kind == "func":
        assert ours.func.name == theirs.func.name, where
        assert sorted(ours.func.attr) == sorted(theirs.func.attr), where
    elif kind == "list":
        for f in ("s", "i", "b", "type"):
            assert list(getattr(ours.list, f)) == list(getattr(theirs.list, f)), where
        np.testing.assert_array_equal(np.float32(ours.list.f), np.float32(theirs.list.f))
        assert len(ours.list.shape) == len(theirs.list.shape), where
        for a, b in zip(ours.list.shape, theirs.list.shape):
            _same_shape(a, b)
    elif kind == "placeholder":
        assert ours.placeholder == theirs.placeholder, where


def _same_nodes(ours, theirs):
    assert [n.name for n in ours] == [n.name for n in theirs]
    for a, b in zip(ours, theirs):
        assert (a.op, list(a.input), a.device) == (b.op, list(b.input), b.device), b.name
        assert sorted(a.attr) == sorted(b.attr), b.name
        for k in b.attr:
            _same_attr(a.attr[k], b.attr[k], f"{b.name}.{k}")


def _same_graph(gd_tf):
    ours = g.as_graph_def(gd_tf)
    _same_nodes(ours.node, gd_tf.node)
    assert ours.versions.producer == gd_tf.versions.producer
    fns = {f.signature.name: f for f in gd_tf.library.function}
    assert [f.signature.name for f in ours.library.function] == list(fns)
    for f in ours.library.function:
        t = fns[f.signature.name]
        assert [a.name for a in f.signature.input_arg] == [a.name for a in t.signature.input_arg]
        assert [a.name for a in f.signature.output_arg] == [a.name for a in t.signature.output_arg]
        assert [a.type for a in f.signature.input_arg] == [a.type for a in t.signature.input_arg]
        assert f.ret == dict(t.ret)
        _same_nodes(f.node_def, t.node_def)
    return ours


def _frozen(fn, *specs):
    cf = tf.function(fn).get_concrete_function(*specs)
    # keep While/If functional (the default lowers them to V1 frames)
    return convert_variables_to_constants_v2(cf, lower_control_flow=False).graph.as_graph_def()


def test_tiny_bert_graph_decodes_as_tf():
    pytest.importorskip("transformers")
    from test_bert_import import make_frozen_bert

    gd = make_frozen_bert().graph.as_graph_def()
    ours = _same_graph(gd)
    assert len(ours.node) == len(gd.node) > 200


def test_functional_while_and_if_decode_as_tf():
    def fn(x):
        def body(i, acc):
            return i + 1, tf.cond(tf.reduce_sum(acc) > 0.0, lambda: acc * 1.5, lambda: -acc)

        _, out = tf.while_loop(lambda i, acc: i < 4, body, [tf.constant(0), x])
        return out

    gd = _frozen(fn, tf.TensorSpec((3,), tf.float32))
    assert {n.op for n in gd.node} & {"While", "StatelessWhile"}
    assert len(gd.library.function) >= 2
    _same_graph(gd)


def test_v1_while_loop_decodes_as_tf():
    tf.compat.v1.disable_control_flow_v2()
    try:
        with tf.Graph().as_default() as graph:
            x = tf.compat.v1.placeholder(tf.float32, (3,), name="x")
            _, out = tf.compat.v1.while_loop(lambda i, a: i < 6, lambda i, a: (i + 1, a * 2.0),
                                             [tf.constant(0), x])
            tf.identity(out, name="result")
            gd = graph.as_graph_def()
    finally:
        tf.compat.v1.enable_control_flow_v2()
    assert any(n.op == "Enter" for n in gd.node)
    _same_graph(gd)


# ---- constants of every dtype ---------------------------------------------------
_CONSTS = {
    "float32": np.array([[1.5, -2.25], [3.0, 1e-30]], np.float32),
    "float64": np.array([1.0 / 3, -7.0], np.float64),
    "float16": np.array([0.5, -65504.0, 1e-4], np.float16),
    "int32": np.array([-1, -2147483648, 2147483647, 0], np.int32),
    "int64": np.array([-(2 ** 62), 5], np.int64),
    "int16": np.array([-300, 7], np.int16),
    "int8": np.array([-128, 127], np.int8),
    "uint8": np.array([0, 255], np.uint8),
    "uint16": np.array([65535, 1], np.uint16),
    "uint32": np.array([4294967295, 3], np.uint32),
    "uint64": np.array([2 ** 64 - 1, 2], np.uint64),
    "bool": np.array([True, False, True]),
    "complex64": np.array([1 + 2j, -3.5j], np.complex64),
    "complex128": np.array([1e-3 - 1j], np.complex128),
}


_VAL_FIELD = {"float32": "float_val", "float64": "double_val", "int32": "int_val",
              "int16": "int_val", "int8": "int_val", "uint8": "int_val", "uint16": "int_val",
              "int64": "int64_val", "uint32": "uint32_val", "uint64": "uint64_val",
              "bool": "bool_val", "complex64": "scomplex_val", "complex128": "dcomplex_val",
              "float16": "half_val"}


@pytest.mark.parametrize("name", sorted(_CONSTS))
@pytest.mark.parametrize("form", ["content", "values"])
def test_const_of_every_dtype(name, form):
    arr = _CONSTS[name]
    proto = tensor_util.make_tensor_proto(arr)
    if form == "values":  # the typed value list instead of tensor_content
        proto.tensor_content = b""
        if arr.dtype.kind == "c":
            vals = np.stack([arr.real, arr.imag], -1).ravel().tolist()
        elif name == "float16":
            vals = arr.view(np.uint16).astype(int).tolist()
        else:
            vals = arr.ravel().tolist()
        field = getattr(proto, _VAL_FIELD[name])
        del field[:]
        field.extend(vals)
    ours = g.TensorProto.parse(proto.SerializeToString())
    _same_array(g.make_ndarray(ours), tensor_util.MakeNdarray(proto))


@pytest.mark.parametrize("dtype", [tf.float16, tf.bfloat16])
def test_half_val(dtype):
    vals = [0.5, -2.0, 3.140625]
    proto = tensor_util.make_tensor_proto(vals, dtype=dtype, shape=[3])
    proto.tensor_content = b""
    del proto.half_val[:]
    raw = tf.constant(vals, dtype=dtype).numpy().view(np.uint16)
    proto.half_val.extend(int(v) for v in raw)
    ours = g.make_ndarray(g.TensorProto.parse(proto.SerializeToString()))
    _same_array(ours, tensor_util.MakeNdarray(proto))


def test_splat_and_short_value_lists():
    splat = tensor_util.make_tensor_proto(1.5, dtype=tf.float32, shape=[3, 4])
    assert len(splat.float_val) == 1
    short = tensor_pb2.TensorProto(dtype=tf.int32.as_datatype_enum,
                                   tensor_shape=tf.TensorShape([5]).as_proto())
    short.int_val.extend([-4, 9])
    empty = tensor_pb2.TensorProto(dtype=tf.float64.as_datatype_enum,
                                   tensor_shape=tf.TensorShape([2, 2]).as_proto())
    for proto in (splat, short, empty):
        ours = g.make_ndarray(g.TensorProto.parse(proto.SerializeToString()))
        _same_array(ours, tensor_util.MakeNdarray(proto))


def test_strings():
    proto = tensor_util.make_tensor_proto([b"a", b"", "café".encode()], dtype=tf.string)
    ours = g.make_ndarray(g.TensorProto.parse(proto.SerializeToString()))
    _same_array(ours, tensor_util.MakeNdarray(proto))
    short = tensor_util.make_tensor_proto(b"xy", dtype=tf.string, shape=[3])
    _same_array(g.make_ndarray(g.TensorProto.parse(short.SerializeToString())),
                tensor_util.MakeNdarray(short))


def _key(field, wire):
    return bytes([(field << 3) | wire])


def _varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def test_negative_int32_varints_packed_and_unpacked():
    vals = [-1, 3, -2147483648]
    shape = tf.TensorShape([3]).as_proto().SerializeToString()
    head = _key(1, 0) + _varint(tf.int32.as_datatype_enum) + _key(2, 2) + _varint(len(shape)) + shape
    packed_body = b"".join(_varint(v) for v in vals)
    packed = head + _key(7, 2) + _varint(len(packed_body)) + packed_body
    unpacked = head + b"".join(_key(7, 0) + _varint(v) for v in vals)
    for raw in (packed, unpacked):
        theirs = tensor_pb2.TensorProto.FromString(raw)
        assert list(theirs.int_val) == vals
        _same_array(g.make_ndarray(g.TensorProto.parse(raw)), tensor_util.MakeNdarray(theirs))


def test_unpacked_floats_and_list_ints():
    import struct

    vals = [1.25, -0.5]
    shape = tf.TensorShape([2]).as_proto().SerializeToString()
    raw = (_key(1, 0) + _varint(tf.float32.as_datatype_enum) + _key(2, 2) + _varint(len(shape))
           + shape + b"".join(_key(5, 5) + struct.pack("<f", v) for v in vals))
    theirs = tensor_pb2.TensorProto.FromString(raw)
    _same_array(g.make_ndarray(g.TensorProto.parse(raw)), tensor_util.MakeNdarray(theirs))
    lst = b"".join(_key(3, 0) + _varint(v) for v in (-7, 2)) + _key(4, 5) + struct.pack("<f", 0.5)
    attr = _key(1, 2) + _varint(len(lst)) + lst
    ours, theirs = g.AttrValue.parse(attr), attr_value_pb2.AttrValue.FromString(attr)
    assert list(ours.list.i) == list(theirs.list.i) == [-7, 2]
    assert list(ours.list.f) == list(theirs.list.f) == [0.5]


def test_committed_skeleton_decodes():
    gd = g.read_graph_def(bert_skeleton.SKELETON)
    assert len(gd.node) == 1649
    ops = {}
    for n in gd.node:
        ops[n.op] = ops.get(n.op, 0) + 1
    assert ops == {"AddV2": ops["AddV2"], "All": 1, "Assert": 1, "BatchMatMulV2": 24,
                   "BiasAdd": 72, "Cast": 1, "Const": 582, "Erfc": 12, "ExpandDims": 1,
                   "Fill": 2, "GatherV2": 3, "Identity": 234, "Less": 1, "MatMul": 72,
                   "Mean": 50, "Mul": 112, "Neg": 12, "NoOp": 1, "Placeholder": 1,
                   "Range": 1, "RealDiv": ops["RealDiv"], "Reshape": 193, "Rsqrt": 25,
                   "Softmax": 12, "SquaredDifference": 25, "StopGradient": 25, "Sub": 26,
                   "Transpose": 48}
    assert len(bert_skeleton.emptied(gd)) == 75
    # the same bytes through TF's parse
    theirs = graph_pb2.GraphDef.FromString(gzip.open(bert_skeleton.SKELETON).read())
    _same_graph(theirs)
