"""The port's SameDiff engine against the JAX package's: the 14 scenarios of
``tests/test_samediff.py`` built in both packages on the same seeded numpy
values (build, execute, operators, gradients by ``calculate_gradients``,
training, save/load, compile), and a graph saved by either package loaded
by the other. Float64 graphs agree to 1e-10, float32 ones to 1e-6 relative;
``fit`` with ``Sgd`` (a deterministic updater) gives the JAX package's loss
at every step.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.samediff import TrainingConfig as JConfig
from deeplearning4j_tpu.train.updaters import Sgd as JSgd

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.samediff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.train.updaters import Adam, Sgd

PKGS = {"jax": (lambda: JSameDiff.create()), "port": (lambda: SameDiff.create(device="cpu"))}


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _both(build, feeds, names, rtol=1e-10, atol=0.0):
    """Build with each package, run, and hold the port to JAX."""
    outs = {}
    for pkg, make in PKGS.items():
        sd = make()
        build(sd)
        res = sd.output(feeds, names)
        outs[pkg] = {n: _np(res[n]) for n in names}
    for n in names:
        assert outs["port"][n].shape == outs["jax"][n].shape, n
        assert outs["port"][n].dtype == outs["jax"][n].dtype, n
        np.testing.assert_allclose(outs["port"][n], outs["jax"][n], rtol=rtol, atol=atol)
    return outs["port"]


class TestBasic:
    def test_arith_and_eval(self):
        def build(sd):
            x = sd.placeholder("x", (None, 3))
            w = sd.var("w", np.ones((3, 2), np.float32))
            b = sd.var("b", np.zeros((2,), np.float32))
            (x @ w + b).rename("y")

        out = _both(build, {"x": np.ones((4, 3), np.float32)}, ["y"])
        np.testing.assert_allclose(out["y"], 3.0)
        sd = SameDiff.create(device="cpu")
        build(sd)
        np.testing.assert_allclose(sd.get_variable("y").eval({"x": np.ones((4, 3), np.float32)}),
                                   3.0)

    def test_namespaced_ops(self):
        out = _both(lambda sd: sd.nn.softmax(sd.placeholder("x", (2, 4))).rename("sm"),
                    {"x": np.zeros((2, 4), np.float32)}, ["sm"])
        np.testing.assert_allclose(out["sm"], 0.25)

    def test_reductions_and_chaining(self):
        out = _both(lambda sd: sd.placeholder("x", (2, 3)).mul(2.0).sum().rename("total"),
                    {"x": np.ones((2, 3), np.float32)}, ["total"])
        assert float(out["total"]) == pytest.approx(12.0)

    def test_multi_output_reuse(self):
        def build(sd):
            a = (sd.placeholder("x", (2, 2)) + 1.0).rename("a")
            (a * a).rename("b")

        out = _both(build, {"x": np.zeros((2, 2), np.float32)}, ["a", "b"])
        np.testing.assert_allclose(out["a"], 1.0)
        np.testing.assert_allclose(out["b"], 1.0)


class TestGradients:
    def test_simple_grad(self):
        grads = {}
        for pkg, make in PKGS.items():
            sd = make()
            x = sd.placeholder("x", (3,))
            w = sd.var("w", np.array([1.0, 2.0, 3.0], np.float32))
            (x * w).sum().rename("loss")
            sd.set_loss_variables("loss")
            grads[pkg] = _np(sd.calculate_gradients(
                {"x": np.array([1.0, 1.0, 2.0], np.float32)}, ["w"])["w"])
        np.testing.assert_allclose(grads["port"], [1.0, 1.0, 2.0])
        np.testing.assert_allclose(grads["port"], grads["jax"])

    def test_matmul_grad_matches_numeric_and_jax(self):
        w0 = np.random.default_rng(0).normal(size=(3, 2)).astype(np.float64)
        feeds = {"x": np.random.default_rng(1).normal(size=(4, 3))}
        grads = {}
        for pkg, make in PKGS.items():
            sd = make()
            x = sd.placeholder("x", (4, 3))
            w = sd.var("w", w0)
            sd.nn.softmax(x @ w).sum().rename("loss")
            sd.set_loss_variables("loss")
            grads[pkg] = _np(sd.calculate_gradients(feeds, ["w"])["w"])
        np.testing.assert_allclose(grads["port"], grads["jax"], rtol=1e-10, atol=1e-12)
        # numeric check of the port's gradient
        sd = SameDiff.create(device="cpu")
        x = sd.placeholder("x", (4, 3))
        sd.nn.softmax(x @ sd.var("w", w0)).sum().rename("loss")
        import torch

        eps, num, wv = 1e-6, np.zeros_like(w0), w0.copy()
        for i in range(3):
            for j in range(2):
                for sgn in (1, -1):
                    wv[i, j] += sgn * eps
                    sd._values[sd._names["w"]] = torch.from_numpy(wv.copy())
                    num[i, j] += sgn * float(_np(sd.output(feeds, ["loss"])["loss"]).sum()) / (2 * eps)
                    wv[i, j] -= sgn * eps
        np.testing.assert_allclose(grads["port"], num, rtol=1e-4, atol=1e-6)


def _regression(make, updater, it, epochs):
    sd = make()
    x = sd.placeholder("x", (None, 3))
    label = sd.placeholder("label", (None, 1))
    w = sd.var("w", np.zeros((3, 1), np.float32))
    b = sd.var("b", np.zeros((1,), np.float32))
    pred = (x @ w + b).rename("pred")
    sd.loss.mean_squared_error(label, pred).rename("loss")
    sd.set_loss_variables("loss")
    return sd, sd.fit(it, updater, epochs=epochs)


class TestTraining:
    def _data(self):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(128, 3)).astype(np.float32)
        true_w = np.array([[1.5], [-2.0], [0.5]], np.float32)
        return X, X @ true_w + 0.01 * rng.normal(size=(128, 1)).astype(np.float32), true_w

    def test_linear_regression_converges(self):
        X, Y, true_w = self._data()
        cfg = TrainingConfig(updater=Adam(1e-1), data_set_feature_mapping=("x",),
                             data_set_label_mapping=("label",))
        sd, hist = _regression(PKGS["port"], cfg, ListDataSetIterator(DataSet(X, Y), batch=32), 50)
        assert hist.loss_curve[-1] < 0.01
        np.testing.assert_allclose(_np(sd._values[sd._names["w"]]), true_w, atol=0.1)

    def test_fit_loss_equals_jax_step_by_step(self):
        X, Y, _ = self._data()
        jcfg = JConfig(updater=JSgd(0.05), data_set_feature_mapping=("x",),
                       data_set_label_mapping=("label",))
        cfg = TrainingConfig(updater=Sgd(0.05), data_set_feature_mapping=("x",),
                             data_set_label_mapping=("label",))
        jsd, jh = _regression(PKGS["jax"], jcfg, JList(JDataSet(X, Y), batch=32), 3)
        sd, h = _regression(PKGS["port"], cfg, ListDataSetIterator(DataSet(X, Y), batch=32), 3)
        assert len(h.loss_curve) == len(jh.loss_curve) == 12
        np.testing.assert_allclose(h.loss_curve, jh.loss_curve, rtol=1e-5)
        np.testing.assert_allclose(_np(sd._values[sd._names["w"]]),
                                   np.asarray(jsd._values[jsd._names["w"]]), rtol=1e-5, atol=1e-6)

    def test_loss_curve_survives_midfit_exception(self):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(8, 3)).astype(np.float32)
        Y = rng.normal(size=(8, 1)).astype(np.float32)
        sd = SameDiff.create(device="cpu")
        x = sd.placeholder("x", (None, 3))
        label = sd.placeholder("label", (None, 1))
        sd.loss.mean_squared_error(label, (x @ sd.var("w", np.zeros((3, 1), np.float32)))
                                   .rename("pred")).rename("loss")
        sd.set_loss_variables("loss")
        cfg = TrainingConfig(updater=Adam(1e-2), data_set_feature_mapping=("x",),
                             data_set_label_mapping=("label",))

        class ExplodingIterator:
            def __iter__(self):
                def gen():
                    for _ in range(3):
                        yield DataSet(X, Y)
                    raise KeyboardInterrupt("data source died")

                return gen()

        with pytest.raises(KeyboardInterrupt):
            sd.fit(ExplodingIterator(), cfg, epochs=1)
        hist = sd._training.last_history
        assert hist is not None and len(hist.loss_curve) == 3
        assert all(np.isfinite(v) for v in hist.loss_curve)


def _softmax_graph(sd, w0):
    x = sd.placeholder("x", (None, 3))
    sd.nn.softmax(x @ sd.var("w", w0)).rename("y")


class TestSerde:
    @pytest.mark.parametrize("saver", ["jax", "port"])
    def test_save_load_round_trip_across_packages(self, tmp_path, saver):
        w0 = np.random.default_rng(2).normal(size=(3, 2)).astype(np.float32)
        feeds = {"x": np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)}
        sd = PKGS[saver]()
        _softmax_graph(sd, w0)
        before = _np(sd.output(feeds, ["y"])["y"])
        path = str(tmp_path / "graph.sdz")
        sd.save(path)
        for loaded in (JSameDiff.load(path), SameDiff.load(path, device="cpu")):
            np.testing.assert_allclose(_np(loaded.get_variable("y").eval(feeds)), before,
                                       rtol=1e-6)

    def test_aot_compile(self):
        def build(sd):
            x = sd.placeholder("x", (4, 3))
            (x @ sd.var("w", np.ones((3, 2), np.float32))).rename("y")

        feeds = {"x": np.ones((4, 3), np.float32)}
        sd = SameDiff.create(device="cpu")
        build(sd)
        compiled = sd.compile(feeds, ["y"])
        assert not compiled.graphed and "cpu" in compiled.reason
        np.testing.assert_allclose(_np(compiled(dict(sd._values), feeds)["y"]), 3.0)


class TestOpsCoverage:
    def test_shape_ops(self):
        def build(sd):
            r = sd.math.reshape(sd.placeholder("x", (2, 6)), shape=[2, 2, 3]).rename("r")
            sd.math.transpose(r, perm=[0, 2, 1]).rename("t")

        out = _both(build, {"x": np.arange(12, dtype=np.float32).reshape(2, 6)}, ["t"])
        assert out["t"].shape == (2, 3, 2)

    def test_gather_onehot(self):
        def build(sd):
            idx = sd.placeholder("idx", (3,), dtype="int32")
            table = sd.var("table", np.arange(12, dtype=np.float32).reshape(4, 3))
            sd.math.gather(table, idx, axis=0).rename("g")
            sd.math.one_hot(idx, depth=4).rename("oh")

        out = _both(build, {"idx": np.array([0, 2, 3], np.int32)}, ["g", "oh"])
        np.testing.assert_allclose(out["g"][1], [6, 7, 8])
        assert out["oh"].shape == (3, 4)

    def test_strided_slice(self):
        out = _both(lambda sd: sd.math.strided_slice(
            sd.placeholder("x", (4, 5)), begin=[1, 0], end=[3, 4], strides=[1, 2]).rename("s"),
            {"x": np.arange(20, dtype=np.float32).reshape(4, 5)}, ["s"])
        np.testing.assert_allclose(out["s"], [[5, 7], [10, 12]])

    def test_layer_norm_and_erf(self):
        def build(sd):
            x = sd.placeholder("x", (2, 8))
            sd.nn.layer_norm(x).rename("ln")
            sd.math.erf(x).rename("e")

        out = _both(build, {"x": np.random.default_rng(4).normal(size=(2, 8)).astype(np.float32)},
                    ["ln", "e"], rtol=1e-6, atol=1e-7)
        assert abs(float(out["ln"].mean())) < 1e-5


def test_device_default_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SameDiff.create()


def test_getitem_and_operators_match_jax():
    def build(sd):
        x = sd.placeholder("x", (4, 5))
        y = (2.0 - x) / (x * x + 1.0)
        (y[1:3] ** 2).rename("a")
        (-y[:, ::2]).rename("b")
        y[::-1].rename("c")
        (x.std(1) + x.max(0).mean() - x.min()).rename("d")
        x.norm2(0).rename("e")
        x.reshape(2, 10).transpose().rename("f")

    _both(build, {"x": np.random.default_rng(5).normal(size=(4, 5))}, list("abcdef"))


def test_integer_array_attrs_are_host_values_and_match_jax():
    """A native graph may pass a shape, axes, a perm or paddings as an
    integer ndarray, as the JAX package's SameDiff accepts. The port holds
    them on the host (lists), so an op reads them with no device copy."""
    def build(sd):
        x = sd.placeholder("x", (2, 6))
        r = sd.math.reshape(x, shape=np.array([2, 2, 3])).rename("r")
        sd.math.transpose(r, perm=np.array([0, 2, 1])).rename("t")
        sd._op("reduce_mean", x, axis=np.array([1]), name="m")
        sd._op("pad", x, paddings=np.array([[0, 1], [2, 0]]), name="p")

    _both(build, {"x": np.random.default_rng(6).normal(size=(2, 6))}, ["r", "t", "m", "p"])
    sd = SameDiff.create(device="cpu")
    build(sd)
    for name, attr in [("r", "shape"), ("t", "perm"), ("m", "axis"), ("p", "paddings")]:
        value = sd._device_attrs(sd._nodes[sd._names[name]])[attr]
        assert isinstance(value, list), (name, type(value))


def test_dropout_is_no_host_op_and_draws_on_the_graph_device():
    import torch

    sd = SameDiff.create(device="cpu")
    x = sd.placeholder("x", (64, 64))
    sd.nn.dropout(x, rate=0.25).rename("d")
    sd._op("reduce_sum", sd._op("square", sd.get_variable("d")), name="loss")
    sd.set_loss_variables("loss")
    assert sd.host_ops(["d"]) == []
    feeds = {"x": np.ones((64, 64), np.float32)}
    np.testing.assert_array_equal(_np(sd.output(feeds, ["d"])["d"]), 1.0)  # inference
    d = sd._eval_graph(feeds, dict(sd._values), ["d"], rng=torch.Generator().manual_seed(3),
                       training=True)["d"]
    assert d.device == sd.device and abs(float((d == 0).double().mean()) - 0.25) < 0.05
    np.testing.assert_allclose(_np(d[d != 0]), 1 / 0.75, rtol=1e-6)
