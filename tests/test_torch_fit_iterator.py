"""Training from iterators in the port against the JAX package, in float64.

The same network goes through the JAX model zip; both packages then train
from iterators over the same seeded numpy data, and every iteration's score
and the final parameters must agree to 1e-10: ``Solver.fit_iterator``
(shuffled, two epochs), its mid-epoch resume from ``state_dict`` (the
resumed port run lands on JAX's uninterrupted parameters),
``MultiLayerNetwork.fit(iterator)`` (the JAX package reads the iterator once
and repeats those batches when their shapes are uniform, and re-reads it
when they are ragged), ``GraphSolver.fit_iterator`` over DataSets and
MultiDataSets, and LeNet from ``MnistDataSetIterator``. Also the
normalizer entry of the model zip, read and written across the packages."""

import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.core.listeners import CollectScoresListener as JaxScores
from deeplearning4j_tpu.data import normalizers as jnorm
from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.data.mnist import MnistDataSetIterator as JaxMnist
from deeplearning4j_tpu.model.serializer import read_normalizer as jax_read_normalizer
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo import LeNet as JaxLeNet
from deeplearning4j_tpu.nn import Activation, InputType, LossFunction, NeuralNetConfiguration
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.vertices import MergeVertex
from deeplearning4j_tpu.train.graph_solver import GraphSolver as JaxGraphSolver
from deeplearning4j_tpu.train.solver import Solver as JaxSolver
from deeplearning4j_tpu.train.updaters import Adam

from deeplearning4j_tpu_torch.core.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.data import normalizers as pnorm
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator, ListDataSetIterator
from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.model import (read_normalizer, restore_computation_graph,
                                            restore_multi_layer_network, write_model)
from deeplearning4j_tpu_torch.train import Solver
from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver

TOL = 1e-10


def _mln_conf():
    return (NeuralNetConfiguration.builder().seed(1).data_type("float64")
            .updater(Adam(0.01)).list()
            .layer(DenseLayer(n_out=6, activation=Activation.TANH))
            .layer(OutputLayer(n_out=2, loss=LossFunction.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(3)).build())


def _pair(tmp_path, jm):
    path = str(tmp_path / "m.zip")
    jax_write(jm, path)
    if isinstance(jm, JaxCG):
        return restore_computation_graph(path, device="cpu")
    return restore_multi_layer_network(path, device="cpu")


def _data(n=16):
    rs = np.random.RandomState(0)
    x = rs.randn(n, 3)
    y = np.eye(2)[rs.randint(0, 2, n)]
    return x, y


def _its(n=16, batch=4):
    x, y = _data(n)
    return (JList(JDS(x, y), batch, shuffle=True, seed=5),
            ListDataSetIterator(DataSet(x, y), batch, shuffle=True, seed=5))


def _flat_err(jm, pm):
    want, _ = ravel_pytree(jm.params)
    return float(np.abs(np.asarray(want) - pm.params_flat()).max())


def _with_scores(jm, pm):
    js, ps = JaxScores(), CollectScoresListener()
    jm.add_listeners(js)
    pm.add_listeners(ps)
    return js, ps


def _assert_scores(js, ps):
    assert ps.iterations == js.iterations
    np.testing.assert_allclose(ps.scores, js.scores, rtol=0, atol=TOL)


def test_solver_fit_iterator_scores_match_jax(tmp_path):
    jm = JaxMLN(_mln_conf()).init()
    pm = _pair(tmp_path, jm)
    js, ps = _with_scores(jm, pm)
    jit_, pit = _its()
    jscore = JaxSolver(jm).fit_iterator(jit_, epochs=2)
    pscore = Solver(pm).fit_iterator(pit, epochs=2)
    assert (pm.iteration_count, pm.epoch_count) == (jm.iteration_count, jm.epoch_count) == (8, 2)
    assert len(ps.scores) == 8
    _assert_scores(js, ps)
    assert abs(pscore - jscore) <= TOL
    assert _flat_err(jm, pm) <= TOL


def test_solver_fit_iterator_mid_epoch_resume_matches_jax(tmp_path):
    jm = JaxMLN(_mln_conf()).init()
    pm = _pair(tmp_path, jm)
    JaxSolver(jm).fit_iterator(_its()[0], epochs=3)
    # the port run: one epoch, two batches into the second, then a fresh
    # iterator repositioned by state_dict finishes epochs 2 and 3
    solver = Solver(pm)
    it = _its()[1]
    solver.fit_iterator(it, epochs=1)
    it.reset()
    for _ in range(2):
        ds = it.next()
        solver.fit_batch(ds.features, ds.labels)
        pm.iteration_count += 1
    state = it.state_dict()
    assert state == {"epoch": 2, "batches": 2}
    it2 = _its()[1]
    it2.load_state_dict(state)
    solver.fit_iterator(it2, epochs=2)
    assert (pm.iteration_count, pm.epoch_count) == (12, 3)
    assert _flat_err(jm, pm) <= TOL


@pytest.mark.parametrize("n", [16, 14], ids=["uniform", "ragged"])
def test_network_fit_iterator_epochs_match_jax(tmp_path, n):
    """Without listeners: uniform batches are read once and repeated each
    epoch, ragged ones re-read (reshuffled) per epoch, in both packages."""
    jm = JaxMLN(_mln_conf()).init()
    pm = _pair(tmp_path, jm)
    jit_, pit = _its(n)
    jm.fit(jit_, epochs=2)
    pm.fit(pit, epochs=2)
    assert pm.iteration_count == jm.iteration_count == 8
    assert abs(pm.score_value - float(jm.score_value)) <= TOL
    assert _flat_err(jm, pm) <= TOL
    # a DataSet trains as one batch
    x, y = _data(6)
    jm.fit(JDS(x, y))
    pm.fit(DataSet(x, y))
    assert _flat_err(jm, pm) <= TOL


def _graph_conf():
    return (NeuralNetConfiguration.builder().seed(2).data_type("float64").updater(Adam(1e-2))
            .graph_builder().add_inputs("a", "b")
            .add_layer("da", DenseLayer(n_out=5, activation=Activation.TANH), "a")
            .add_layer("db", DenseLayer(n_out=5, activation=Activation.TANH), "b")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("out", OutputLayer(n_out=2), "m")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(3), InputType.feed_forward(2)).build())


class _ListIter(DataSetIterator):
    """A restartable iterator over a fixed list of batches (either
    package's MultiDataSet: the solvers only call has_next/next/reset)."""

    def __init__(self, items):
        self.items, self.i = items, 0

    def has_next(self):
        return self.i < len(self.items)

    def next(self):
        self.i += 1
        return self.items[self.i - 1]

    def reset(self):
        self.i = 0


def test_graph_solver_fit_iterator_multidataset_matches_jax(tmp_path):
    jm = JaxCG(_graph_conf()).init()
    pm = _pair(tmp_path, jm)
    js, ps = _with_scores(jm, pm)
    rs = np.random.RandomState(3)
    raw = [(rs.randn(4, 3), rs.randn(4, 2), np.eye(2)[rs.randint(0, 2, 4)]) for _ in range(3)]
    jscore = JaxGraphSolver(jm).fit_iterator(
        _ListIter([JMDS((a, b), (y,)) for a, b, y in raw]), epochs=2)
    pscore = GraphSolver(pm).fit_iterator(
        _ListIter([MultiDataSet((a, b), (y,)) for a, b, y in raw]), epochs=2)
    assert pm.iteration_count == jm.iteration_count == 6
    _assert_scores(js, ps)
    assert abs(pscore - float(jscore)) <= TOL
    assert _flat_err(jm, pm) <= TOL


def test_graph_solver_fit_iterator_dataset_matches_jax(tmp_path):
    conf = (NeuralNetConfiguration.builder().seed(2).data_type("float64").updater(Adam(1e-2))
            .graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_out=6, activation=Activation.TANH), "in")
            .add_layer("out", OutputLayer(n_out=2), "d")
            .set_outputs("out").set_input_types(InputType.feed_forward(3)).build())
    jm = JaxCG(conf).init()
    pm = _pair(tmp_path, jm)
    js, ps = _with_scores(jm, pm)
    jit_, pit = _its()
    JaxGraphSolver(jm).fit_iterator(jit_, epochs=2)
    GraphSolver(pm).fit_iterator(pit, epochs=2)
    assert pm.epoch_count == 2 and len(ps.scores) == 8
    _assert_scores(js, ps)
    assert _flat_err(jm, pm) <= TOL
    # ComputationGraph.fit takes DataSets too
    x, y = _data(6)
    jm.fit(JDS(x, y))
    pm.fit(DataSet(x, y))
    assert _flat_err(jm, pm) <= TOL


def test_lenet_from_mnist_iterator_matches_jax(tmp_path):
    """The bench recipe at test size: LeNet fit from MnistDataSetIterator,
    then evaluated, in float64."""
    jm = JaxLeNet(seed=42, dtype="float64").init()
    pm = _pair(tmp_path, jm)
    js, ps = _with_scores(jm, pm)
    kw = dict(train=True, num_examples=48, seed=7)
    jm.fit(JaxMnist(16, **kw), epochs=1)
    pm.fit(MnistDataSetIterator(16, **kw), epochs=1)
    _assert_scores(js, ps)
    assert len(ps.scores) == 3
    assert _flat_err(jm, pm) <= 1e-9
    # one batch: Evaluation() sizes its matrix from the first batch it sees
    ev_kw = dict(train=False, num_examples=64, seed=7)
    np.testing.assert_array_equal(pm.evaluate(MnistDataSetIterator(64, **ev_kw)).confusion,
                                  jm.evaluate(JaxMnist(64, **ev_kw)).confusion)


@pytest.mark.parametrize("kind", ["NormalizerStandardize", "NormalizerMinMaxScaler",
                                  "ImagePreProcessingScaler", "VGG16ImagePreProcessor"])
def test_normalizer_in_the_model_zip_across_packages(tmp_path, kind):
    x, y = _data(12)
    x = np.abs(x) * 60.0
    if kind == "VGG16ImagePreProcessor":
        x4 = np.abs(np.random.RandomState(1).randn(4, 3, 2, 2)) * 60.0
        fit_on = (JDS(x4, y[:4]), DataSet(x4, y[:4]))
    else:
        fit_on = (JDS(x, y), DataSet(x, y))
    jn, pn = getattr(jnorm, kind)(), getattr(pnorm, kind)()
    jn.fit(fit_on[0])
    pn.fit(fit_on[1])
    jm = JaxMLN(_mln_conf()).init()
    jpath = str(tmp_path / "jax.zip")
    jax_write(jm, jpath, normalizer=jn)
    got = read_normalizer(jpath)
    assert type(got).__name__ == kind
    for k, v in jn.state_dict().items():
        np.testing.assert_array_equal(np.asarray(got.state_dict()[k]), np.asarray(v))
    # and the port's zip back into the JAX package
    pm = restore_multi_layer_network(jpath, device="cpu")
    ppath = str(tmp_path / "port.zip")
    write_model(pm, ppath, normalizer=pn)
    back = jax_read_normalizer(ppath)
    assert type(back).__name__ == kind
    got_ds = JDS(fit_on[0].features.copy(), fit_on[0].labels)
    want_ds = JDS(fit_on[0].features.copy(), fit_on[0].labels)
    back.transform(got_ds)
    jn.transform(want_ds)
    np.testing.assert_array_equal(got_ds.features, want_ds.features)
    write_model(pm, str(tmp_path / "plain.zip"))
    assert read_normalizer(str(tmp_path / "plain.zip")) is None
