"""The port's evaluation classes and the networks' ``evaluate`` against the
JAX package.

The seven classes are the JAX package's numpy code, so on the same labels,
predictions and masks every reported number must be equal (to 1e-12, the
summation order being the same). ``MultiLayerNetwork.evaluate``,
``evaluate_regression`` and ``ComputationGraph.evaluate`` of a model carried
over through the JAX zip, in float64, must give JAX's confusion matrix
exactly, over an iterator, a DataSet and a (features, labels) pair; and the
``EvaluativeListener``'s default path runs the model's own ``evaluate``."""

import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.mnist import MnistDataSetIterator as JaxMnist
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo import LeNet as JaxLeNet
from deeplearning4j_tpu.train import evaluation as jev

from deeplearning4j_tpu_torch.core.listeners import EvaluativeListener
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.model import restore_computation_graph, restore_multi_layer_network
from deeplearning4j_tpu_torch.train import evaluation as pev

TOL = 1e-12


def _probs(rs, n, k):
    z = rs.randn(n, k)
    e = np.exp(z - z.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


def _close(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                   rtol=TOL, atol=TOL, equal_nan=True)


def _feed(cls_name, batches, **kw):
    j, p = getattr(jev, cls_name)(**kw), getattr(pev, cls_name)(**kw)
    for args in batches:
        j.eval(*args[:2], mask=args[2] if len(args) > 2 else None)
        p.eval(*args[:2], mask=args[2] if len(args) > 2 else None)
    return j, p


def test_evaluation_matches_jax():
    rs = np.random.RandomState(0)
    k = 4
    batches = []
    for n in (16, 9):
        labels = np.eye(k)[rs.randint(0, k, n)]
        batches.append((labels, _probs(rs, n, k), (rs.rand(n) > 0.2).astype(np.float64)))
    j, p = _feed("Evaluation", batches, top_n=2)
    np.testing.assert_array_equal(p.confusion, j.confusion)
    for name in ("accuracy", "top_n_accuracy", "matthews_correlation"):
        _close(getattr(j, name)(), getattr(p, name)())
    for name in ("precision", "recall", "f1"):
        _close(getattr(j, name)(), getattr(p, name)())
        for c in range(k):
            _close(getattr(j, name)(c), getattr(p, name)(c))
    _close(j.false_positive_rate(1), p.false_positive_rate(1))
    assert p.stats() == j.stats()


def test_evaluation_binary_and_roc_binary_match_jax():
    rs = np.random.RandomState(1)
    batches = [((rs.rand(12, 3) > 0.5).astype(np.float64), rs.rand(12, 3),
                (rs.rand(12, 3) > 0.1).astype(np.float64)) for _ in range(2)]
    j, p = _feed("EvaluationBinary", batches)
    for i in range(3):
        for name in ("accuracy", "precision", "recall", "f1"):
            _close(getattr(j, name)(i), getattr(p, name)(i))
    j, p = _feed("ROCBinary", batches)
    for i in range(3):
        _close(j.calculate_auc(i), p.calculate_auc(i))
    _close(j.calculate_average_auc(), p.calculate_average_auc())


@pytest.mark.parametrize("n_batches", [1, 3])
def test_roc_and_roc_multiclass_match_jax(n_batches):
    rs = np.random.RandomState(2)
    binary = [((rs.rand(20) > 0.5).astype(np.float64), rs.rand(20)) for _ in range(n_batches)]
    j, p = _feed("ROC", binary)
    _close(j.calculate_auc(), p.calculate_auc())
    _close(j.calculate_auprc(), p.calculate_auprc())
    multi = [(np.eye(3)[rs.randint(0, 3, 15)], _probs(rs, 15, 3)) for _ in range(n_batches)]
    j, p = _feed("ROCMultiClass", multi)
    for c in range(3):
        _close(j.calculate_auc(c), p.calculate_auc(c))
        _close(j.calculate_auprc(c), p.calculate_auprc(c))
    _close(j.calculate_average_auc(), p.calculate_average_auc())


def test_regression_evaluation_matches_jax():
    rs = np.random.RandomState(3)
    batches = [(rs.randn(10, 2), rs.randn(10, 2)) for _ in range(3)]
    j, p = _feed("RegressionEvaluation", batches)
    for col in (0, 1):
        for name in ("mean_squared_error", "mean_absolute_error", "root_mean_squared_error",
                     "r_squared", "pearson_correlation"):
            _close(getattr(j, name)(col), getattr(p, name)(col))
    assert p.stats() == j.stats()


def test_evaluation_calibration_matches_jax():
    rs = np.random.RandomState(4)
    batches = [(np.eye(3)[rs.randint(0, 3, 30)], _probs(rs, 30, 3)) for _ in range(2)]
    j, p = _feed("EvaluationCalibration", batches, reliability_bins=5, histogram_bins=6)
    _close(j.expected_calibration_error(), p.expected_calibration_error())
    for c in (None, 0, 2):
        _close(j.get_reliability_info(c), p.get_reliability_info(c))
        _close(j.get_residual_plot(c), p.get_residual_plot(c))
    _close(j.get_probability_histogram(1), p.get_probability_histogram(1))
    assert p.stats() == j.stats()


# ---------------------------------------------------------------------------
# the networks' evaluate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lenet_pair(tmp_path_factory):
    jm = JaxLeNet(seed=3, dtype="float64").init()
    path = str(tmp_path_factory.mktemp("lenet") / "lenet.zip")
    jax_write(jm, path)
    return jm, restore_multi_layer_network(path, device="cpu")


def test_multilayer_evaluate_matches_jax(lenet_pair):
    jm, pm = lenet_pair
    kw = dict(train=False, num_examples=48, seed=5)
    want = jm.evaluate(JaxMnist(16, **kw))
    got = pm.evaluate(MnistDataSetIterator(16, **kw))
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert int(got.confusion.sum()) == 48 and got.accuracy() == want.accuracy()
    # a DataSet, and a (features, labels) pair
    x, y = MnistDataSetIterator(48, **kw).data.features, MnistDataSetIterator(48, **kw).data.labels
    np.testing.assert_array_equal(pm.evaluate(DataSet(x, y)).confusion,
                                  jm.evaluate(JaxDataSet(x, y)).confusion)
    np.testing.assert_array_equal(pm.evaluate(x, y).confusion, want.confusion)
    reg_j, reg_p = jm.evaluate_regression(x, y), pm.evaluate_regression(x, y)
    for col in (0, 9):
        np.testing.assert_allclose(reg_p.mean_squared_error(col), reg_j.mean_squared_error(col),
                                   rtol=1e-10)


def test_graph_evaluate_matches_jax(tmp_path):
    from deeplearning4j_tpu.nn import Activation as JAct
    from deeplearning4j_tpu.nn import InputType as JIT
    from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
    from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOut

    conf = (JConf.builder().seed(2).data_type("float64").graph_builder().add_inputs("in")
            .add_layer("d", JDense(n_out=6, activation=JAct.TANH), "in")
            .add_layer("out", JOut(n_out=3), "d")
            .set_outputs("out").set_input_types(JIT.feed_forward(4)).build())
    jm = JaxCG(conf).init()
    path = str(tmp_path / "g.zip")
    jax_write(jm, path)
    pm = restore_computation_graph(path, device="cpu")
    rs = np.random.RandomState(6)
    batches = [DataSet(rs.randn(8, 4), np.eye(3)[rs.randint(0, 3, 8)]) for _ in range(3)]
    jbatches = [JaxDataSet(d.features, d.labels) for d in batches]
    got, want = pm.evaluate(batches), jm.evaluate(jbatches)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert int(got.confusion.sum()) == 24


def test_evaluative_listener_default_path(lenet_pair):
    _, pm = lenet_pair
    logs = []
    it = MnistDataSetIterator(16, train=False, num_examples=32, seed=5)
    lst = EvaluativeListener(it, log_fn=logs.append)
    lst.on_epoch_end(pm)
    assert len(lst.history) == 1 and int(lst.history[0].confusion.sum()) == 32
    assert logs and logs[0].startswith("EvaluativeListener: accuracy=")
    # the evaluation_factory path through the listener's own loop
    lst2 = EvaluativeListener(it, evaluation_factory=lambda: pev.Evaluation(num_classes=10),
                              log_fn=logs.append)
    lst2.on_epoch_end(pm)
    np.testing.assert_array_equal(lst2.history[0].confusion, lst.history[0].confusion)
