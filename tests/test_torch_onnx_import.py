"""ONNX import: the port against the JAX package.

Every scenario of ``tests/test_onnx_import.py`` is built here with that
file's ModelProto builder (the vendored protoc bindings), imported by both
packages' ``OnnxGraphMapper`` (the port on the CPU, through its own wire
reader) and run on the same feeds: the port's outputs equal JAX's within
1e-5 (the same float32 arithmetic in another order; integer outputs
exactly) and the independent torch reference within that test's
tolerance, and each refused model raises the same error in both. Also:
``ONNX_OP_RULES`` has the JAX package's 127 names, ``tensor_to_numpy``
decodes every typed field as JAX's does (and raises where it raises),
``outputs=`` prunes to the same closure, and ``Constant`` nodes fold.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.modelimport import onnx as jax_onnx
from deeplearning4j_tpu.modelimport.onnx_proto import onnx_pb2 as P

from deeplearning4j_tpu_torch.modelimport import onnx as port_onnx
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxGraphMapper, tensor_to_numpy
from deeplearning4j_tpu_torch.modelimport.onnx_proto import onnx_wire

from test_onnx_import import (  # noqa: E402  (the JAX test's fixtures and references)
    _bert_style_fixture, _resnet_style_fixture, _torch_bert_style, _torch_resnet_style,
    make_attr, make_model, make_node, make_tensor, make_vi,
)

TOL = 1e-5


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def both(model, feeds, outputs, tol=TOL, import_outputs=None, jax_dtype=True):
    """Import ``model`` in both packages, run ``outputs`` on ``feeds``;
    the port's within ``tol`` of JAX's, in JAX's dtype unless
    ``jax_dtype`` is False. Returns the port's {name: array} and its
    SameDiff."""
    jsd = jax_onnx.OnnxGraphMapper.import_model(model, outputs=import_outputs)
    psd = OnnxGraphMapper.import_model(model, outputs=import_outputs, device="cpu")
    ref = {k: np.asarray(v) for k, v in jsd.output(feeds, list(outputs)).items()}
    got = {k: _np(v) for k, v in psd.output(feeds, list(outputs)).items()}
    for k in outputs:
        assert got[k].shape == ref[k].shape and (got[k].dtype == ref[k].dtype or not jax_dtype), k
        if np.issubdtype(ref[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    return got, psd


def run_single(op, inputs, outputs=("y",), input_arrays=None, opset=17, **attrs):
    arrays = dict(input_arrays or {})
    inits = [make_tensor(k, v) for k, v in arrays.items() if k not in ("x",)]
    vis = [make_vi("x", arrays["x"].dtype, arrays["x"].shape)]
    model = make_model([make_node(op, list(inputs), list(outputs), **attrs)],
                       inputs=vis, outputs=[], initializers=inits, opset=opset)
    return both(model, {"x": arrays["x"]}, outputs)[0]


def same_error(model, exc, match):
    with pytest.raises(exc, match=match) as jerr:
        jax_onnx.OnnxGraphMapper.import_model(model)
    with pytest.raises(exc, match=match) as perr:
        OnnxGraphMapper.import_model(model, device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_same_rules_as_jax():
    assert sorted(port_onnx.ONNX_OP_RULES) == sorted(jax_onnx.ONNX_OP_RULES)
    assert len(port_onnx.ONNX_OP_RULES) == 127
    assert port_onnx._SIMPLE == jax_onnx._SIMPLE and port_onnx._SIMPLE_T3 == jax_onnx._SIMPLE_T3


def test_tensor_roundtrip():
    arr = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    t = onnx_wire.TensorProto.FromString(make_tensor("x", arr).SerializeToString())
    np.testing.assert_array_equal(tensor_to_numpy(t), arr)


@pytest.mark.parametrize("dtype,field", [
    (1, "float_data"), (11, "double_data"), (6, "int32_data"), (3, "int32_data"),
    (9, "int32_data"), (2, "int32_data"), (7, "int64_data"), (13, "uint64_data"),
    (12, "uint64_data"), (1, "raw"), (7, "raw"), (10, "raw")])
def test_tensor_to_numpy_matches_jax(dtype, field):
    rs = np.random.RandomState(dtype)
    npdt = np.dtype(jax_onnx._ONNX_DTYPES[dtype])
    vals = (rs.randn(2, 3) * 10).astype(npdt) if npdt.kind == "f" else \
        rs.randint(0, 2 if npdt == np.bool_ else 100, (2, 3)).astype(npdt)
    t = P.TensorProto()
    t.data_type, t.name = dtype, "t"
    t.dims.extend([2, 3])
    if field == "raw":
        t.raw_data = vals.tobytes()
    else:
        getattr(t, field).extend(vals.reshape(-1).tolist())
    ref = jax_onnx.tensor_to_numpy(t)
    got = tensor_to_numpy(onnx_wire.TensorProto.FromString(t.SerializeToString()))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    got[0, 0] = got[0, 1]  # writable: the tensor does not alias the message


@pytest.mark.parametrize("dtype,match", [(10, "no data field for dtype 10"),
                                         (8, "dtype 8 unsupported")])
def test_tensor_to_numpy_raises_as_jax(dtype, match):
    t = P.TensorProto()
    t.data_type = dtype
    t.dims.extend([2])
    t.int32_data.extend([1, 2])
    with pytest.raises(NotImplementedError, match=match):
        jax_onnx.tensor_to_numpy(t)
    with pytest.raises(NotImplementedError, match=match):
        tensor_to_numpy(onnx_wire.TensorProto.FromString(t.SerializeToString()))


def test_onnx_resnet_style_golden():
    rng = np.random.RandomState(0)
    model_bytes, params = _resnet_style_fixture(rng)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    got, _ = both(model_bytes, {"x": x}, ["y"], import_outputs=["y"])
    np.testing.assert_allclose(got["y"], _torch_resnet_style(params, x), rtol=1e-4, atol=1e-4)


def test_onnx_resnet_style_full_graph_compiles():
    rng = np.random.RandomState(1)
    model_bytes, params = _resnet_style_fixture(rng)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    sd = OnnxGraphMapper.import_model(model_bytes, outputs=["y"], device="cpu")
    compiled = sd.compile({"x": x}, ["y"])
    assert not compiled.graphed and "not a card" in compiled.reason
    out = compiled(dict(sd._values), {"x": x})
    np.testing.assert_allclose(_np(out["y"]), _torch_resnet_style(params, x), rtol=1e-4,
                               atol=1e-4)


def test_onnx_bert_style_golden():
    rng = np.random.RandomState(2)
    model_bytes, params = _bert_style_fixture(rng)
    ids = rng.randint(0, 100, (2, 8)).astype(np.int64)
    got, _ = both(model_bytes, {"ids": ids}, ["out"], import_outputs=["out"])
    np.testing.assert_allclose(got["out"], _torch_bert_style(params, ids), rtol=1e-4, atol=1e-4)


def test_onnx_bert_style_full_graph_compiles():
    rng = np.random.RandomState(3)
    model_bytes, params = _bert_style_fixture(rng)
    ids = rng.randint(0, 100, (2, 8)).astype(np.int64)
    sd = OnnxGraphMapper.import_model(model_bytes, outputs=["out"], device="cpu")
    compiled = sd.compile({"ids": ids}, ["out"])
    np.testing.assert_allclose(_np(compiled(dict(sd._values), {"ids": ids})["out"]),
                               _torch_bert_style(params, ids), rtol=1e-4, atol=1e-4)
    assert sd.host_ops(["out"]) == []  # nothing stops the card from capturing it


@pytest.mark.parametrize("source", ["bytes", "port ModelProto", "protoc ModelProto", "path"])
def test_import_model_sources(tmp_path, source):
    model_bytes, params = _bert_style_fixture(np.random.RandomState(2))
    ids = np.random.RandomState(5).randint(0, 100, (2, 8)).astype(np.int64)
    if source == "port ModelProto":
        model = onnx_wire.ModelProto.FromString(model_bytes)
    elif source == "protoc ModelProto":
        model = P.ModelProto.FromString(model_bytes)
    elif source == "path":
        model = str(tmp_path / "m.onnx")
        (tmp_path / "m.onnx").write_bytes(model_bytes)
    else:
        model = model_bytes
    sd = OnnxGraphMapper.import_model(model, outputs=["out"], device="cpu")
    np.testing.assert_allclose(_np(sd.output({"ids": ids}, ["out"])["out"]),
                               _torch_bert_style(params, ids), rtol=1e-4, atol=1e-4)


def test_outputs_prune_to_the_same_closure():
    model_bytes, _ = _resnet_style_fixture(np.random.RandomState(0))
    jsd = jax_onnx.OnnxGraphMapper.import_model(model_bytes, outputs=["r0"])
    psd = OnnxGraphMapper.import_model(model_bytes, outputs=["r0"], device="cpu")
    assert sorted(psd._names) == sorted(jsd._names)
    assert "gap" not in psd._names and "r0" in psd._names


def test_placeholder_shapes_and_dtypes_as_jax():
    vi = make_vi("x", np.float32, (2, 3))
    vi.type.tensor_type.shape.dim[0].dim_param = "batch"  # symbolic: no dim_value
    vi2 = make_vi("n", np.int64, ())
    vi2.type.tensor_type.ClearField("shape")
    m = make_model([make_node("Identity", ["x"], ["y"])], inputs=[vi, vi2], outputs=[],
                   initializers=[])
    jsd = jax_onnx.OnnxGraphMapper.import_model(m)
    psd = OnnxGraphMapper.import_model(m, device="cpu")
    for name in ("x", "n"):
        jn, pn = jsd._nodes[jsd._names[name]], psd._nodes[psd._names[name]]
        assert (pn.shape, pn.dtype) == (jn.shape, jn.dtype)
    assert psd._nodes[psd._names["x"]].shape == (None, 3)


@pytest.mark.parametrize("kind", ["value", "value_float", "value_int", "value_floats",
                                  "value_ints"])
def test_constant_nodes_fold(kind):
    value = {"value": np.asarray([[1.5, -2.0]], np.float32), "value_float": 0.25,
             "value_int": 3, "value_floats": [0.5, 1.5], "value_ints": [4, -1]}[kind]
    n = make_node("Constant", [], ["c"])
    n.attribute.append(make_attr(kind, value))
    m = make_model([n, make_node("Identity", ["c"], ["y"])],
                   inputs=[make_vi("x", np.float32, (1,))], outputs=[], initializers=[])
    got, psd = both(m, {"x": np.zeros(1, np.float32)}, ["y"])
    assert "c" in psd._names


def test_onnx_gemm_transB():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 6).astype(np.float32)
    w = rng.randn(4, 6).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    out = run_single("Gemm", ["x", "w", "b"], input_arrays={"x": x, "w": w, "b": b},
                     alpha=1.0, beta=1.0, transB=1)["y"]
    np.testing.assert_allclose(out, x @ w.T + b, rtol=1e-5, atol=1e-5)


def test_onnx_slice_and_reduce():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 10, 6).astype(np.float32)
    arrays = {"starts": np.asarray([2], np.int64), "ends": np.asarray([9], np.int64),
              "axes": np.asarray([1], np.int64), "steps": np.asarray([2], np.int64)}
    model = make_model(
        [make_node("Slice", ["x", "starts", "ends", "axes", "steps"], ["s"]),
         make_node("ReduceMean", ["s"], ["y"], axes=[2], keepdims=0)],
        inputs=[make_vi("x", np.float32, x.shape)], outputs=[],
        initializers=[make_tensor(k, v) for k, v in arrays.items()])
    out = both(model, {"x": x}, ["y"])[0]["y"]
    np.testing.assert_allclose(out, x[:, 2:9:2].mean(axis=2), rtol=1e-5, atol=1e-6)


def test_onnx_grouped_conv():
    rng = np.random.RandomState(6)
    x = rng.randn(1, 4, 8, 8).astype(np.float32)
    w = rng.randn(4, 2, 3, 3).astype(np.float32)
    out = run_single("Conv", ["x", "w"], input_arrays={"x": x, "w": w},
                     kernel_shape=[3, 3], pads=[1, 1, 1, 1], group=2)["y"]
    expected = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1, groups=2).numpy()
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-5)


def test_onnx_maxpool_explicit_pads():
    x = np.random.RandomState(7).randn(1, 3, 9, 9).astype(np.float32)
    out = run_single("MaxPool", ["x"], input_arrays={"x": x},
                     kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])["y"]
    np.testing.assert_allclose(out, F.max_pool2d(torch.from_numpy(x), 3, 2, padding=1).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("include_pad", [0, 1])
def test_onnx_avgpool_explicit_pads(include_pad):
    x = np.random.RandomState(8).randn(1, 2, 8, 8).astype(np.float32)
    out = run_single("AveragePool", ["x"], input_arrays={"x": x},
                     kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
                     count_include_pad=include_pad)["y"]
    expected = F.avg_pool2d(torch.from_numpy(x), 3, 2, padding=1,
                            count_include_pad=bool(include_pad)).numpy()
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-6)


def test_onnx_float_range():
    model = make_model(
        [make_node("Range", ["r_start", "r_limit", "r_delta"], ["y"])],
        inputs=[make_vi("x", np.float32, (1,))], outputs=[],
        initializers=[make_tensor("r_start", np.asarray(0.0, np.float32)),
                      make_tensor("r_limit", np.asarray(1.0, np.float32)),
                      make_tensor("r_delta", np.asarray(0.25, np.float32))])
    # JAX's range of Python floats is float64 under the tests' x64 mode;
    # the port's is float32, the dtype of ONNX's inputs
    out = both(model, {"x": np.zeros(1, np.float32)}, ["y"], jax_dtype=False)[0]["y"]
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, np.arange(0.0, 1.0, 0.25, dtype=np.float32))


def test_onnx_unknown_op_message():
    model = make_model([make_node("TotallyMadeUpOp", ["x"], ["y"])],
                       inputs=[make_vi("x", np.float32, (2,))], outputs=[], initializers=[])
    same_error(model, NotImplementedError, "TotallyMadeUpOp")


def test_reduce_family():
    x = np.random.RandomState(10).randn(3, 5).astype(np.float32)
    for op, ref in [("ReduceL2", np.linalg.norm(x, axis=1)), ("ReduceL1", np.abs(x).sum(1)),
                    ("ReduceLogSumExp", np.log(np.exp(x).sum(1))),
                    ("ReduceSumSquare", (x ** 2).sum(1))]:
        got = run_single(op, ["x"], input_arrays={"x": x}, axes=[1], keepdims=0)["y"]
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=op)


def test_conv_transpose_vs_torch():
    rng = np.random.RandomState(11)
    x = rng.randn(1, 3, 5, 5).astype(np.float32) * 0.5
    w = rng.randn(3, 4, 3, 3).astype(np.float32) * 0.2
    got = run_single("ConvTranspose", ["x", "w"], input_arrays={"x": x, "w": w},
                     strides=[2, 2], kernel_shape=[3, 3])["y"]
    ref = F.conv_transpose2d(torch.tensor(x), torch.tensor(w), stride=2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_instance_and_group_norm_vs_torch():
    rng = np.random.RandomState(12)
    x = rng.randn(2, 6, 4, 4).astype(np.float32)
    g = rng.rand(6).astype(np.float32) + 0.5
    b = rng.randn(6).astype(np.float32) * 0.1
    got = run_single("InstanceNormalization", ["x", "g", "b"],
                     input_arrays={"x": x, "g": g, "b": b}, epsilon=1e-5)["y"]
    ref = F.instance_norm(torch.tensor(x), weight=torch.tensor(g), bias=torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    got = run_single("GroupNormalization", ["x", "g", "b"],
                     input_arrays={"x": x, "g": g, "b": b}, num_groups=3, epsilon=1e-5)["y"]
    ref = F.group_norm(torch.tensor(x), 3, weight=torch.tensor(g), bias=torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_lrn_vs_torch():
    x = np.random.RandomState(13).randn(1, 8, 4, 4).astype(np.float32)
    got = run_single("LRN", ["x"], input_arrays={"x": x}, size=3, alpha=3e-4, beta=0.75,
                     bias=1.0)["y"]
    ref = F.local_response_norm(torch.tensor(x), 3, alpha=3e-4, beta=0.75, k=1.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_topk_onehot_cumsum_trilu():
    rng = np.random.RandomState(14)
    x = rng.randn(3, 7).astype(np.float32)
    got = run_single("TopK", ["x", "k"], outputs=("y", "yi"),
                     input_arrays={"x": x, "k": np.asarray([4], np.int64)})
    np.testing.assert_allclose(got["y"], np.sort(x, axis=1)[:, ::-1][:, :4], rtol=1e-6)
    np.testing.assert_array_equal(got["yi"], np.argsort(-x, axis=1)[:, :4])
    ids = np.asarray([0, 2, 1], np.int64)
    got = run_single("OneHot", ["x", "d", "v"],
                     input_arrays={"x": ids, "d": np.asarray([4], np.int64),
                                   "v": np.asarray([0.0, 1.0], np.float32)})["y"]
    np.testing.assert_allclose(got, np.eye(4, dtype=np.float32)[ids])
    x2 = rng.randn(2, 5).astype(np.float32)
    got = run_single("CumSum", ["x", "ax"],
                     input_arrays={"x": x2, "ax": np.asarray([1], np.int64)})["y"]
    np.testing.assert_allclose(got, np.cumsum(x2, axis=1), rtol=1e-5)
    m = rng.randn(4, 4).astype(np.float32)
    np.testing.assert_allclose(run_single("Trilu", ["x"], input_arrays={"x": m}, upper=0)["y"],
                               np.tril(m))


def test_scatter_gather_elements():
    data = np.zeros((4, 3), np.float32)
    idx = np.asarray([[0], [2]], np.int64)
    upd = np.asarray([[9.0, 8.0, 7.0], [1.0, 2.0, 3.0]], np.float32)
    got = run_single("ScatterND", ["x", "i", "u"], input_arrays={"x": data, "i": idx, "u": upd})
    ref = data.copy()
    ref[0], ref[2] = upd[0], upd[1]
    np.testing.assert_allclose(got["y"], ref)
    x = np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32)
    gidx = np.asarray([[0, 0], [1, 0]], np.int64)
    got = run_single("GatherElements", ["x", "i"], input_arrays={"x": x, "i": gidx}, axis=1)
    np.testing.assert_allclose(got["y"], [[1.0, 1.0], [4.0, 3.0]])


def test_quantize_dequantize_and_space_depth():
    x = np.asarray([[0.31, 0.12], [0.7, 0.05]], np.float32)
    scale, zp = np.asarray([0.1], np.float32), np.asarray([0], np.int32)
    q = run_single("QuantizeLinear", ["x", "s", "z"], input_arrays={"x": x, "s": scale, "z": zp})
    dq = run_single("DequantizeLinear", ["x", "s", "z"],
                    input_arrays={"x": q["y"].astype(np.int32), "s": scale, "z": zp})["y"]
    np.testing.assert_allclose(dq, x, atol=0.06)
    img = np.random.RandomState(15).randn(1, 8, 2, 2).astype(np.float32)
    got = run_single("DepthToSpace", ["x"], input_arrays={"x": img}, blocksize=2)["y"]
    n, c, h, w = img.shape
    ref = img.reshape(n, 2, 2, c // 4, h, w).transpose(0, 3, 4, 1, 5, 2).reshape(
        n, c // 4, h * 2, w * 2)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_mean_shrink_mvn():
    rng = np.random.RandomState(16)
    a, b = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(np.float32)
    model = make_model([make_node("Mean", ["x", "b"], ["y"])],
                       inputs=[make_vi("x", np.float32, a.shape)], outputs=[],
                       initializers=[make_tensor("b", b)])
    np.testing.assert_allclose(both(model, {"x": a}, ["y"])[0]["y"], (a + b) / 2, rtol=1e-6)
    x = np.asarray([-1.0, -0.3, 0.0, 0.4, 2.0], np.float32)
    got = run_single("Shrink", ["x"], input_arrays={"x": x}, lambd=0.5, bias=0.0)["y"]
    np.testing.assert_allclose(got, F.hardshrink(torch.tensor(x), 0.5).numpy())
    got = run_single("Shrink", ["x"], input_arrays={"x": x}, lambd=0.5, bias=0.2)["y"]
    np.testing.assert_allclose(got, np.where(x < -0.5, x + 0.2, np.where(x > 0.5, x - 0.2, 0.0)),
                               rtol=1e-6)
    x4 = rng.randn(2, 3, 4, 4).astype(np.float32)
    got = run_single("MeanVarianceNormalization", ["x"], input_arrays={"x": x4})["y"]
    mu, sd = x4.mean(axis=(0, 2, 3), keepdims=True), x4.std(axis=(0, 2, 3), keepdims=True)
    np.testing.assert_allclose(got, (x4 - mu) / sd, rtol=1e-4, atol=1e-4)


def test_new_simple_activations_vs_torch():
    x = np.random.RandomState(17).randn(2, 6).astype(np.float32)
    for op, ref_fn in [("Celu", F.celu), ("HardSwish", F.hardswish), ("Mish", F.mish)]:
        got = run_single(op, ["x"], input_arrays={"x": x.copy()})["y"]
        np.testing.assert_allclose(got, ref_fn(torch.tensor(x)).numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=op)


def test_mod_fmod_and_reverse_sequence():
    x, y = np.asarray([-3.5, 3.5], np.float32), np.asarray([2.0, -2.0], np.float32)
    np.testing.assert_allclose(
        run_single("Mod", ["x", "m"], input_arrays={"x": x, "m": y}, fmod=1)["y"], np.fmod(x, y))
    np.testing.assert_allclose(
        run_single("Mod", ["x", "m"], input_arrays={"x": x, "m": y})["y"], np.mod(x, y))
    seq = np.random.RandomState(18).randn(5, 2, 3).astype(np.float32)
    lens = np.asarray([3, 5], np.int64)
    got = run_single("ReverseSequence", ["x", "l"], input_arrays={"x": seq, "l": lens})["y"]
    ref = seq.copy()
    for b, n in enumerate(lens):
        ref[:n, b] = seq[:n, b][::-1]
    np.testing.assert_allclose(got, ref)


def test_conv_transpose_rejects_ambiguous_pads():
    rng = np.random.RandomState(19)
    x = rng.randn(1, 2, 4, 4).astype(np.float32)
    w = rng.randn(2, 3, 3, 3).astype(np.float32)
    model = make_model([make_node("ConvTranspose", ["x", "w"], ["y"], strides=[2, 2],
                                  kernel_shape=[3, 3], pads=[1, 1, 1, 1])],
                       inputs=[make_vi("x", np.float32, x.shape)], outputs=[],
                       initializers=[make_tensor("w", w)])
    same_error(model, NotImplementedError, "pads")


def test_quantize_signed_int8():
    x = np.asarray([[-1.0, 0.5]], np.float32)
    q = run_single("QuantizeLinear", ["x", "s", "z"],
                   input_arrays={"x": x, "s": np.asarray([0.1], np.float32),
                                 "z": np.asarray([0], np.int8)})["y"]
    np.testing.assert_array_equal(q, [[-10, 5]])
