"""TF GraphDef import: the port against the JAX package and TensorFlow.

Each graph of ``tests/test_tf_import.py`` (31) and ``tests/test_control_flow.py``
(12) is built and frozen in-process, imported by both packages' ``TFGraphMapper``
(the port on the CPU through its own GraphDef reader) and run on the same
feeds; the port's output is held to TF's and to the JAX package's at those
tests' tolerances. Then:

* ``tests/test_bert_import.py``'s tiny frozen BERT: the port against JAX and
  TF within 1e-4; its fine-tune recipe: the loss falls in the port, and the
  port's first loss equals JAX's (the same imported weights and ``cls_W``).
* The committed BERT-base skeleton (full width, seed 0): the port imports
  its closure on the CPU and runs the [16, 128] forward, whose first two
  positions agree with the JAX package's golden within 2e-4 and whose mean
  and mean |x| agree within 1e-6.
* A subprocess in which ``jax``, ``tensorflow``, ``google.protobuf`` and the
  JAX package are unimportable imports ``deeplearning4j_tpu_torch.samediff``,
  reads the skeleton and imports it.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from tensorflow.python.framework.convert_to_constants import (  # noqa: E402
    convert_variables_to_constants_v2,
)

from deeplearning4j_tpu.samediff import SameDiff as JSameDiff  # noqa: E402
from deeplearning4j_tpu.samediff import TrainingConfig as JConfig  # noqa: E402
from deeplearning4j_tpu.samediff.tf_import import TFGraphMapper as JMapper  # noqa: E402
from deeplearning4j_tpu.train.updaters import Adam as JAdam  # noqa: E402

from deeplearning4j_tpu_torch.samediff import SameDiff, TrainingConfig  # noqa: E402
from deeplearning4j_tpu_torch.samediff.tf_import import TFGraphMapper  # noqa: E402
from deeplearning4j_tpu_torch.tools import bert_skeleton  # noqa: E402
from deeplearning4j_tpu_torch.train.updaters import Adam  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def freeze(fn, *specs):
    cf = tf.function(fn).get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(cf)
    gd = frozen.graph.as_graph_def()
    return gd, [t.name.split(":")[0] for t in frozen.inputs], [t.name for t in frozen.outputs], frozen


def import_and_compare(fn, feeds_np, rtol=1e-5, atol=1e-6):
    """TF, the JAX package and the port on one frozen graph."""
    specs = [tf.TensorSpec(v.shape, tf.as_dtype(v.dtype)) for v in feeds_np.values()]
    gd, in_names, out_names, frozen = freeze(fn, *specs)
    tf_out = frozen(**{t.name.split(":")[0]: tf.constant(v)
                       for t, v in zip(frozen.inputs, feeds_np.values())})
    if isinstance(tf_out, (list, tuple)):
        tf_out = tf_out[0]
    feeds = dict(zip(in_names, feeds_np.values()))
    target = out_names[0].split(":")[0]
    jax_out = np.asarray(JMapper.import_graph(gd, outputs=out_names).output(feeds, [target])[target])
    sd = TFGraphMapper.import_graph(gd, outputs=out_names, device="cpu")
    ours = _np(sd.output(feeds, [target])[target])
    np.testing.assert_allclose(ours, tf_out.numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(ours, jax_out, rtol=rtol, atol=atol)
    assert ours.dtype == jax_out.dtype


def _c(rng, *shape, scale=1.0):
    return tf.constant(rng.normal(size=shape).astype(np.float32) * scale)


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ---- the graphs of tests/test_tf_import.py -------------------------------------
def g_mlp(rng):
    w1, b1, w2 = _c(rng, 8, 16), _c(rng, 16), _c(rng, 16, 4)
    return (lambda x: tf.nn.softmax(tf.matmul(tf.nn.relu(tf.matmul(x, w1) + b1), w2)),
            {"x": _f32(rng, 5, 8)}, 1e-5, 1e-6)


def g_reductions_and_shapes(rng):
    def fn(x):
        y = tf.transpose(tf.reshape(x, [2, 3, 4]), [0, 2, 1])
        return tf.squeeze(tf.reduce_mean(y, axis=2, keepdims=True), axis=2)
    return fn, {"x": _f32(rng, 2, 12)}, 1e-5, 1e-6


def g_strided_slice_and_concat(rng):
    return (lambda x: tf.concat([x[:, 1:3], x[:, :2]], axis=1), {"x": _f32(rng, 4, 6)},
            1e-5, 1e-6)


def g_gather_embedding(rng):
    table = _c(rng, 30, 8)
    return (lambda ids: tf.gather(table, ids),
            {"ids": rng.integers(0, 30, size=(4, 7)).astype(np.int32)}, 1e-5, 1e-6)


def g_layernorm_decomposition(rng):
    gamma, beta = _c(rng, 16), _c(rng, 16)

    def fn(x):
        mean = tf.reduce_mean(x, axis=-1, keepdims=True)
        var = tf.reduce_mean(tf.math.squared_difference(x, mean), axis=-1, keepdims=True)
        return (x - mean) * tf.math.rsqrt(var + 1e-6) * gamma + beta
    return fn, {"x": _f32(rng, 3, 16)}, 1e-4, 1e-5


def g_gelu_erf_decomposition(rng):
    return (lambda x: 0.5 * x * (1.0 + tf.math.erf(x / tf.sqrt(2.0))), {"x": _f32(rng, 4, 8)},
            1e-5, 1e-6)


def g_conv2d_maxpool(rng):
    w = _c(rng, 3, 3, 2, 4, scale=0.1)

    def fn(x):
        y = tf.nn.relu(tf.nn.conv2d(x, w, strides=1, padding="SAME"))
        return tf.nn.max_pool2d(y, 2, 2, padding="VALID")
    return fn, {"x": _f32(rng, 2, 8, 8, 2)}, 1e-4, 1e-5


def g_onehot_and_cast(rng):
    return (lambda ids: tf.cast(tf.one_hot(ids, depth=5), tf.float32) * 2.0,
            {"ids": rng.integers(0, 5, size=(6,)).astype(np.int32)}, 1e-5, 1e-6)


def g_einsum(rng):
    return (lambda x: tf.einsum("bi,ij->bj", x, tf.reshape(tf.range(24, dtype=tf.float32), (4, 6))),
            {"x": _f32(rng, 3, 4)}, 1e-4, 1e-4)


def g_mini_self_attention(rng):
    d, h = 16, 4
    wq, wk, wv, wo = (_c(rng, d, d, scale=0.1) for _ in range(4))

    def attn(x):
        b, t = 2, 6
        q, k, v = (tf.transpose(tf.reshape(tf.matmul(tf.reshape(x, [-1, d]), w), [b, t, h, d // h]),
                                [0, 2, 1, 3]) for w in (wq, wk, wv))
        scores = tf.matmul(q, k, transpose_b=True) / tf.sqrt(tf.cast(d // h, tf.float32))
        o = tf.reshape(tf.transpose(tf.matmul(tf.nn.softmax(scores, axis=-1), v), [0, 2, 1, 3]),
                       [b, t, d])
        return tf.matmul(tf.reshape(o, [-1, d]), wo)
    return attn, {"x": _f32(rng, 2, 6, 16)}, 1e-4, 1e-5


def g_special_math_ops(rng):
    return (lambda x: tf.math.lgamma(x) + tf.math.digamma(x) + tf.math.xlogy(x, x + 1.0)
            + tf.math.atan2(x, x + 2.0),
            {"x": (rng.random(size=(3, 4)) + 0.5).astype(np.float32)}, 1e-4, 1e-5)


def g_depthwise_conv(rng):
    w = _c(rng, 3, 3, 2, 2, scale=0.2)
    return (lambda x: tf.nn.depthwise_conv2d(x, w, strides=[1, 1, 1, 1], padding="SAME"),
            {"x": _f32(rng, 1, 6, 6, 2)}, 1e-4, 1e-5)


def g_conv2d_transpose(rng):
    w = _c(rng, 3, 3, 4, 2, scale=0.2)
    return (lambda x: tf.nn.conv2d_transpose(x, w, output_shape=[1, 8, 8, 4],
                                             strides=[1, 2, 2, 1], padding="SAME"),
            {"x": _f32(rng, 1, 4, 4, 2)}, 1e-4, 1e-5)


def g_resize_and_space_depth(rng):
    def f(x):
        y = tf.nn.space_to_depth(tf.image.resize(x, [8, 8], method="nearest"), 2)
        return tf.nn.depth_to_space(y, 2)
    return f, {"x": _f32(rng, 1, 4, 4, 3)}, 1e-5, 1e-6


def g_segment_ops(rng):
    ids = tf.constant(np.asarray([0, 0, 1, 2, 2], np.int32))
    return lambda x: tf.math.segment_sum(x, ids), {"x": _f32(rng, 5, 3)}, 1e-5, 1e-6


def g_unsorted_segment(rng):
    ids = tf.constant(np.asarray([2, 0, 1, 0], np.int32))
    return (lambda x: tf.math.unsorted_segment_sum(x, ids, num_segments=3),
            {"x": _f32(rng, 4, 2)}, 1e-5, 1e-6)


def g_top_k_values(rng):
    return lambda x: tf.math.top_k(x, k=3)[0], {"x": _f32(rng, 4, 10)}, 1e-5, 1e-6


def g_scatter_nd(rng):
    idx = tf.constant(np.asarray([[0], [2]], np.int32))
    return lambda u: tf.scatter_nd(idx, u, [4, 3]), {"u": _f32(rng, 2, 3)}, 1e-5, 1e-6


def g_tensor_scatter_and_band_part(rng):
    idx = tf.constant(np.asarray([[0, 0], [1, 2]], np.int32))
    return (lambda x, u: tf.linalg.band_part(tf.tensor_scatter_nd_add(x, idx, u), 1, 1),
            {"x": _f32(rng, 3, 3), "u": _f32(rng, 2)}, 1e-5, 1e-6)


def g_linalg_ops(rng):
    def f(x):
        s = tf.matmul(x, x, transpose_b=True) + 4.0 * tf.eye(4)
        return tf.linalg.det(s) + tf.reduce_sum(tf.linalg.cholesky(s)) \
            + tf.reduce_sum(tf.linalg.inv(s))
    return f, {"x": _f32(rng, 4, 4)}, 1e-3, 1e-3


def g_reverse_roll_cumprod(rng):
    return (lambda x: tf.math.cumprod(tf.roll(tf.reverse(x, axis=[1]), shift=2, axis=1), axis=1,
                                      exclusive=True),
            {"x": (rng.random(size=(2, 5)) + 0.5).astype(np.float32)}, 1e-5, 1e-6)


def g_lrn(rng):
    return (lambda x: tf.nn.local_response_normalization(x, depth_radius=2, bias=1.0,
                                                         alpha=1e-3, beta=0.75),
            {"x": _f32(rng, 1, 4, 4, 8)}, 1e-4, 1e-5)


def g_fft_real_imag(rng):
    def f(x):
        c = tf.signal.fft(tf.complex(x, tf.zeros_like(x)))
        return tf.math.real(c) + tf.math.imag(c)
    return f, {"x": _f32(rng, 2, 8)}, 1e-3, 1e-4


def g_clip_and_bitshift(rng):
    return lambda x: tf.clip_by_value(x, -0.5, 0.5), {"x": _f32(rng, 3, 3)}, 1e-5, 1e-6


def g_qr_svd_eigh_multi_output(rng):
    def f(x):
        s_mat = tf.matmul(x, x, transpose_b=True) + 4.0 * tf.eye(4)
        q, r = tf.linalg.qr(x)
        s, u, v = tf.linalg.svd(x)
        w, vec = tf.linalg.eigh(s_mat)
        recon = tf.matmul(tf.matmul(u, tf.linalg.diag(s)), v, transpose_b=True)
        return tf.reduce_sum(q * 0.0) + tf.reduce_sum(recon) + tf.reduce_sum(w) \
            + tf.reduce_sum(vec * 0.0) + tf.reduce_sum(tf.matmul(q, r))
    return f, {"x": _f32(rng, 4, 4)}, 1e-3, 1e-3


def g_conv2d_transpose_odd_size(rng):
    w = _c(rng, 3, 3, 2, 4, scale=0.2)
    return (lambda g: tf.nn.conv2d_transpose(g, tf.transpose(w, [0, 1, 2, 3]) * 1.0,
                                             output_shape=[1, 5, 5, 2], strides=[1, 2, 2, 1],
                                             padding="SAME"),
            {"g": _f32(rng, 1, 3, 3, 4)}, 1e-4, 1e-5)


def g_dilated_depthwise_conv(rng):
    w = _c(rng, 3, 3, 2, 1, scale=0.2)
    return (lambda x: tf.nn.depthwise_conv2d(x, w, strides=[1, 1, 1, 1], padding="SAME",
                                             dilations=[2, 2]),
            {"x": _f32(rng, 1, 8, 8, 2)}, 1e-4, 1e-5)


def g_bincount_weighted(rng):
    arr = tf.constant(np.asarray([0, 1, 1, 3], np.int32))
    return (lambda w: tf.raw_ops.DenseBincount(input=arr, size=tf.constant(5, tf.int32),
                                               weights=w, binary_output=False),
            {"w": _f32(rng, 4)}, 1e-5, 1e-6)


def g_batched_matrix_diag_part(rng):
    return lambda x: tf.linalg.diag_part(x), {"x": _f32(rng, 3, 4, 4)}, 1e-5, 1e-6


def g_resize_bicubic_keys_kernel(rng):
    # TF's bicubic kernel is a 1024-entry LUT: ~4e-4 quantization noise
    return (lambda x: tf.image.resize(x, [7, 9], method="bicubic"),
            {"x": rng.random(size=(1, 4, 6, 2)).astype(np.float32)}, 1e-3, 1e-3)


GRAPHS = {name[2:]: fn for name, fn in list(globals().items()) if name.startswith("g_")}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_tf_and_jax(name):
    fn, feeds, rtol, atol = GRAPHS[name](np.random.default_rng(sorted(GRAPHS).index(name)))
    import_and_compare(fn, feeds, rtol=rtol, atol=atol)


def test_resize_rejects_corner_origin():
    def f(x):
        return tf.raw_ops.ResizeBilinear(images=x, size=tf.constant([8, 8], tf.int32),
                                         align_corners=False, half_pixel_centers=False)

    gd, _, out_names, _ = freeze(f, tf.TensorSpec((1, 4, 4, 1), tf.float32))
    with pytest.raises(NotImplementedError, match="corner-origin"):
        JMapper.import_graph(gd, outputs=out_names)
    with pytest.raises(NotImplementedError, match="corner-origin"):
        TFGraphMapper.import_graph(gd, outputs=out_names, device="cpu")


def test_thirty_one_graphs():
    assert len(GRAPHS) + 1 == 31


# ---- the graphs of tests/test_control_flow.py ----------------------------------
def _native_while(S, dev, limit, body_op):
    sd = S.create(**dev)
    x = sd.placeholder("x")
    outs = sd.while_loop(
        [sd.constant(np.int32(0)), x],
        lambda s, i, acc: s._op("lt", i, s.constant(np.int32(limit))),
        lambda s, i, acc: [s._op("add", i, s.constant(np.int32(1))), body_op(s, acc)])
    return sd, outs


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_native_while_loop(pkg):
    S, dev = (JSameDiff, {}) if pkg == "jax" else (SameDiff, {"device": "cpu"})
    sd, outs = _native_while(S, dev, 5, lambda s, a: s._op("mul", a, s.constant(np.float32(2.0))))
    res = sd.output({"x": np.float32(3.0)}, [outs[0].name, outs[1].name])
    assert int(res[outs[0].name]) == 5
    assert float(res[outs[1].name]) == pytest.approx(96.0)
    assert _np(res[outs[1].name]).dtype == np.float32


def test_native_if_cond_both_branches():
    for S, dev in ((JSameDiff, {}), (SameDiff, {"device": "cpu"})):
        sd = S.create(**dev)
        p, a = sd.placeholder("p", dtype="bool"), sd.placeholder("a")
        outs = sd.ifCond(p, [a], lambda s, x: s._op("mul", x, s.constant(np.float32(10.0))),
                         lambda s, x: s._op("neg", x))
        name = outs[0].name
        assert float(sd.output({"p": True, "a": np.float32(2.0)}, [name])[name]) == 20.0
        assert float(sd.output({"p": False, "a": np.float32(2.0)}, [name])[name]) == -2.0


def test_native_while_save_load_roundtrip(tmp_path):
    """Saved by either package, loaded by the other."""
    body = lambda s, a: s._op("add", a, a)  # noqa: E731
    for save_pkg in ("jax", "port"):
        if save_pkg == "jax":
            sd, outs = _native_while(JSameDiff, {}, 4, body)
        else:
            sd, outs = _native_while(SameDiff, {"device": "cpu"}, 4, body)
        path = str(tmp_path / f"loop_{save_pkg}.sdz")
        sd.save(path)
        loaded = SameDiff.load(path, device="cpu") if save_pkg == "jax" else JSameDiff.load(path)
        got = loaded.output({"x": np.float32(1.5)}, [outs[1].name])[outs[1].name]
        assert float(got) == pytest.approx(1.5 * 16)


def test_native_while_under_compile():
    sd, outs = _native_while(SameDiff, {"device": "cpu"}, 3, lambda s, a: s._op("mul", a, a))
    compiled = sd.compile({"x": np.float32(1.1)}, [outs[1].name])
    assert not compiled.graphed and compiled.reason  # on the CPU, and a host loop
    got = compiled(dict(sd._values), {"x": np.float32(1.1)})[outs[1].name]
    assert float(got) == pytest.approx(1.1 ** 8, rel=1e-5)


def _frozen(fn, *specs):
    return convert_variables_to_constants_v2(tf.function(fn).get_concrete_function(*specs))


def _tf_run(frozen, *args):
    out = frozen(*(tf.constant(a) for a in args))
    return (out[0] if isinstance(out, (list, tuple)) else out).numpy()


def _both(gd, in_names, out_name, feeds):
    jax_out = np.asarray(JMapper.import_graph(gd, outputs=[out_name]).output(
        dict(zip(in_names, feeds)), [out_name])[out_name])
    sd = TFGraphMapper.import_graph(gd, outputs=[out_name], device="cpu")
    return _np(sd.output(dict(zip(in_names, feeds)), [out_name])[out_name]), jax_out


def _import_and_run(frozen, feeds):
    gd = frozen.graph.as_graph_def()
    return _both(gd, [t.name.split(":")[0] for t in frozen.inputs],
                 frozen.outputs[0].name.split(":")[0], feeds)


def test_tf2_while_loop_import_matches_tf():
    def fn(x):
        _, out = tf.while_loop(lambda i, acc: i < 7, lambda i, acc: (i + 1, acc * 1.5 + 0.25),
                               [tf.constant(0), x])
        return out

    frozen = _frozen(fn, tf.TensorSpec((3,), tf.float32))
    x = np.asarray([1.0, -2.0, 0.5], np.float32)
    ours, jax_out = _import_and_run(frozen, [x])
    np.testing.assert_allclose(ours, _tf_run(frozen, x), rtol=1e-6)
    np.testing.assert_allclose(ours, jax_out, rtol=1e-6)


def test_tf2_cond_import_matches_tf():
    def fn(x):
        return tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0 + 1.0, lambda: -x)

    frozen = _frozen(fn, tf.TensorSpec((4,), tf.float32))
    for x in (np.asarray([1, 2, 3, 4], np.float32), np.asarray([-1, -2, -3, -4], np.float32)):
        ours, jax_out = _import_and_run(frozen, [x])
        np.testing.assert_allclose(ours, _tf_run(frozen, x), rtol=1e-6)
        np.testing.assert_allclose(ours, jax_out, rtol=1e-6)


def test_tf2_while_with_matmul_state():
    w = np.random.RandomState(0).randn(4, 4).astype(np.float32) * 0.3

    def fn(x):
        _, out = tf.while_loop(lambda i, h: i < 5, lambda i, h: (i + 1, tf.tanh(h @ tf.constant(w))),
                               [tf.constant(0), x])
        return out

    frozen = _frozen(fn, tf.TensorSpec((2, 4), tf.float32))
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    ours, jax_out = _import_and_run(frozen, [x])
    np.testing.assert_allclose(ours, _tf_run(frozen, x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours, jax_out, rtol=1e-5, atol=1e-6)


def _v1_graph(build):
    tf.compat.v1.disable_control_flow_v2()
    try:
        with tf.Graph().as_default() as g:
            x, out = build()
            out = tf.identity(out, name="result")
            gd = g.as_graph_def()
            with tf.compat.v1.Session(graph=g) as sess:
                run = lambda xv: sess.run(out, {x: xv})  # noqa: E731
                yield gd, run
    finally:
        tf.compat.v1.enable_control_flow_v2()


def test_v1_while_loop_frames_import_matches_tf():
    def build():
        x = tf.compat.v1.placeholder(tf.float32, (3,), name="x")
        _, out = tf.compat.v1.while_loop(lambda i, acc: i < 6, lambda i, acc: (i + 1, acc * 2.0),
                                         [tf.constant(0, name="i0"), x], name="loop")
        return x, out

    xv = np.asarray([1.0, -0.5, 3.0], np.float32)
    for gd, run in _v1_graph(build):
        expected = run(xv)
    assert any(n.op == "Enter" for n in gd.node)
    ours, jax_out = _both(gd, ["x"], "result", [xv])
    np.testing.assert_allclose(ours, expected, rtol=1e-6)
    np.testing.assert_allclose(ours, jax_out, rtol=1e-6)


def test_v1_cond_switch_merge_import_matches_tf():
    def build():
        x = tf.compat.v1.placeholder(tf.float32, (4,), name="x")
        return x, tf.compat.v1.cond(tf.reduce_sum(x) > 0.0, lambda: x * 3.0, lambda: x - 1.0)

    xs = [np.asarray([1, 1, 1, 1], np.float32), np.asarray([-1, -1, -1, -1], np.float32)]
    for gd, run in _v1_graph(build):
        expected = [run(xv) for xv in xs]
    assert any(n.op == "Switch" for n in gd.node)
    for xv, exp in zip(xs, expected):
        ours, jax_out = _both(gd, ["x"], "result", [xv])
        np.testing.assert_allclose(ours, exp, rtol=1e-6)
        np.testing.assert_allclose(ours, jax_out, rtol=1e-6)


def _bounded(S, dev, max_iters, body, cond, x0):
    sd = S.create(**dev)
    x = sd.var("x", np.asarray([x0], np.float32))
    i0 = sd.constant(np.asarray(0, np.int32), name="i0")
    outs = sd.while_loop([i0, x], cond, lambda s, i, a: [
        s.math.add(i, s.constant(np.asarray(1, np.int32))), body(s, a)], max_iters=max_iters)
    sd.set_loss_variables(sd.math.reduce_sum(outs[1]).name)
    return sd, outs[1]


def test_bounded_while_is_differentiable():
    cond = lambda s, i, a: s.math.lt(i, s.constant(np.asarray(3, np.int32)))  # noqa: E731
    body = lambda s, a: s.math.mul(a, a)  # noqa: E731
    grads = {}
    for pkg, S, dev in (("jax", JSameDiff, {}), ("port", SameDiff, {"device": "cpu"})):
        sd_b, y_b = _bounded(S, dev, 8, body, cond, 2.0)
        sd_u, y_u = _bounded(S, dev, None, body, cond, 2.0)
        vb = float(_np(sd_b.output({}, [y_b.name])[y_b.name])[0])
        vu = float(_np(sd_u.output({}, [y_u.name])[y_u.name])[0])
        assert vb == vu == 256.0
        grads[pkg] = float(_np(list(sd_b.calculate_gradients({}, ["x"]).values())[0])[0])
        with pytest.raises(ValueError, match="Reverse-mode"):
            sd_u.calculate_gradients({}, ["x"])
    assert grads["port"] == grads["jax"] == pytest.approx(8 * 2.0 ** 7, rel=1e-5)


def test_bounded_while_gradient_safe_past_exit():
    cond = lambda s, i, a: s.math.gt(  # noqa: E731
        s.math.reduce_sum(a), s.constant(np.asarray(1.1, np.float32)))
    got = {}
    for pkg, S, dev in (("jax", JSameDiff, {}), ("port", SameDiff, {"device": "cpu"})):
        sd, _ = _bounded(S, dev, 50, lambda s, a: s.math.sqrt(a), cond, 9.0)
        got[pkg] = _np(list(sd.calculate_gradients({}, ["x"]).values())[0])
        assert np.all(np.isfinite(got[pkg])), got
    np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-5)


def test_unbounded_while_greedy_decode_import_matches_tf():
    V, L, EOS = 13, 16, 0
    rng = np.random.RandomState(42)
    w = (rng.randn(V, V) * 2.0).astype(np.float32)
    w[:, EOS] -= 1.0

    def fn(start):
        def body(i, tok, buf):
            nxt = tf.cast(tf.argmax(tf.one_hot(tok, V) @ tf.constant(w), axis=-1), tf.int32)
            return i + 1, nxt, buf + tf.one_hot(i, L, dtype=tf.int32)[None, :] * nxt[:, None]

        _, _, buf = tf.while_loop(lambda i, tok, buf: tf.logical_and(i < L, tok[0] != EOS), body,
                                  [tf.constant(0), start, tf.zeros([1, L], tf.int32)])
        return buf

    frozen = _frozen(fn, tf.TensorSpec((1,), tf.int32))
    lens = set()
    for start in range(1, V, 3):
        x = np.asarray([start], np.int32)
        expected = _tf_run(frozen, x)
        ours, jax_out = _import_and_run(frozen, [x])
        np.testing.assert_array_equal(ours, expected)
        np.testing.assert_array_equal(ours, jax_out)
        lens.add(int((expected != 0).sum()))
    assert len(lens) > 1


# ---- BERT --------------------------------------------------------------------
def _tiny_bert(**kw):
    pytest.importorskip("transformers")
    sys.path.insert(0, str(ROOT / "tests"))
    from test_bert_import import make_frozen_bert

    return make_frozen_bert(**kw)


def test_tiny_bert_matches_jax_and_tf():
    frozen = _tiny_bert()
    gd = frozen.graph.as_graph_def()
    ids = np.random.default_rng(0).integers(0, 500, size=(2, 16)).astype(np.int32)
    tf_out = frozen(tf.constant(ids))
    tf_out = (tf_out[0] if isinstance(tf_out, (list, tuple)) else tf_out).numpy()
    ours, jax_out = _both(gd, [frozen.inputs[0].name.split(":")[0]],
                          frozen.outputs[0].name.split(":")[0], [ids])
    assert ours.shape == tf_out.shape == (2, 16, 64)
    np.testing.assert_allclose(ours, tf_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours, jax_out, rtol=1e-4, atol=1e-4)


def _finetune_graph(S, dev, gd, in_name, out_name, w0, lr):
    imp = JMapper.import_graph(gd, outputs=[out_name]) if S is JSameDiff else \
        TFGraphMapper.import_graph(gd, outputs=[out_name], **dev)
    converted = imp.convert_to_variables()
    pooled = imp._op("reduce_mean", imp.get_variable(out_name), axis=[1])
    logits = imp._op("matmul", pooled, imp.var("cls_W", w0), name="logits")
    labels = imp.placeholder("labels", dtype="float32")
    imp._op("reduce_mean", imp._op("softmax_cross_entropy", labels, logits), name="loss")
    imp.set_loss_variables("loss")
    cfg = (JConfig if S is JSameDiff else TrainingConfig)(
        updater=(JAdam if S is JSameDiff else Adam)(lr), data_set_feature_mapping=[in_name],
        data_set_label_mapping=["labels"])
    return imp, converted, cfg


def test_imported_bert_fine_tunes_and_first_loss_equals_jax():
    frozen = _tiny_bert(batch=4, seq=8, hidden=32, layers=1, heads=2, vocab=100)
    gd = frozen.graph.as_graph_def()
    in_name = frozen.inputs[0].name.split(":")[0]
    out_name = frozen.outputs[0].name.split(":")[0]
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, (4, 8)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
    w0 = (rng.normal(size=(32, 2)) * 0.01).astype(np.float32)
    jsd, jconv, jcfg = _finetune_graph(JSameDiff, {}, gd, in_name, out_name, w0, 5e-3)
    sd, conv, cfg = _finetune_graph(SameDiff, {"device": "cpu"}, gd, in_name, out_name, w0, 5e-3)
    assert conv == jconv and len(conv) > 5
    probe = max(conv, key=lambda n: sd._values[sd._names[n]].numel())
    before = _np(sd._values[sd._names[probe]]).copy()
    jfirst = jsd.fit([(ids, y)], jcfg, epochs=1).loss_curve[0]
    losses = sd.fit([(ids, y)] * 8, cfg, epochs=6).loss_curve
    assert losses[0] == pytest.approx(jfirst, rel=1e-5)
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    assert not np.allclose(before, _np(sd._values[sd._names[probe]]))


def test_bert_base_skeleton_forward_matches_jax_golden():
    gd, i, o = bert_skeleton.load_bert_base(0)
    sd = TFGraphMapper.import_graph(gd, outputs=[o], device="cpu")
    assert len(sd._nodes) == 1635 and sd.host_ops([o]) == []
    out = sd.output({i: bert_skeleton.bench_ids()}, [o])[o]
    gold = bert_skeleton.golden()
    assert tuple(out.shape) == (16, 128, 768)
    assert float((out[:, :2] - torch_from(gold["first2"])).abs().max()) <= 2e-4
    assert float(out.double().mean()) == pytest.approx(float(gold["mean"]), abs=1e-6)
    assert float(out.double().abs().mean()) == pytest.approx(float(gold["mean_abs"]), abs=1e-6)


def torch_from(a):
    import torch

    return torch.from_numpy(a)


def test_samediff_imports_without_jax_tensorflow_or_protobuf():
    code = textwrap.dedent(f"""
        import sys
        for name in list(sys.modules):
            if name.split(".")[0] in ("jax", "jaxlib", "tensorflow", "deeplearning4j_tpu") \\
                    or name.startswith("google.protobuf"):
                del sys.modules[name]
        for name in ("jax", "jaxlib", "tensorflow", "google.protobuf", "deeplearning4j_tpu",
                     "optax"):
            sys.modules[name] = None  # import raises ImportError
        sys.path.insert(0, {str(ROOT)!r})
        from deeplearning4j_tpu_torch.samediff import SameDiff
        from deeplearning4j_tpu_torch.samediff.tf_import import TFGraphMapper
        from deeplearning4j_tpu_torch.tools import bert_skeleton
        gd, i, o = bert_skeleton.load_bert_base(0)
        sd = TFGraphMapper.import_graph(gd, outputs=[o], device="cpu")
        bad = [m for m in sys.modules if sys.modules[m] is not None and
               m.split(".")[0] in ("jax", "tensorflow", "deeplearning4j_tpu")]
        print(len(gd.node), len(sd._nodes), bad)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-3:] == ["1649", "1635", "[]"], res.stdout
