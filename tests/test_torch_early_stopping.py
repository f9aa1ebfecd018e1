"""Early stopping in the port (``deeplearning4j_tpu_torch/train/
early_stopping.py``) against the JAX package, in float64: one network
(the JAX package's, carried over by its zip) trains under the same
configuration in both packages on the same seeded batches, and the result
must agree: ``score_vs_epoch`` to 1e-10, and the same ``best_model_epoch``,
``termination_reason``, ``termination_details`` and ``total_epochs``. The
best model is a deep copy (one more step on the live model leaves it
unchanged), and the ``model_saver_path`` zip restores in the JAX package
with the best model's parameters. (The JAX package's best model shares the
live model's arrays, which its donated train step deletes once training
goes on, so its best parameters are read from its saver's zip.)"""

import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.model.serializer import restore_model as jax_restore
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import LossFunction as JLoss
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.train import early_stopping as jes
from deeplearning4j_tpu.train.updaters import Sgd as JSgd

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.model import restore_multi_layer_network
from deeplearning4j_tpu_torch.train import early_stopping as pes

TOL = 1e-10


def _jax_model(lr):
    conf = (JNNC.builder().seed(4).data_type("float64").updater(JSgd(lr)).list()
            .layer(JDense(n_out=6, activation=JAct.TANH))
            .layer(JOut(n_out=3, loss=JLoss.MCXENT, activation=JAct.SOFTMAX))
            .set_input_type(JIT.feed_forward(4)).build())
    return JaxMLN(conf).init()


def _data(seed, n):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4)
    return x, np.eye(3)[(x[:, 0] + 0.5 * x[:, 1] > 0).astype(int) + (x[:, 2] > 1)]


def _config(mod, kind, held_out, saver):
    if kind == "max_epochs":
        calc = mod.DataSetLossCalculator(held_out)
        epoch = [mod.MaxEpochsTerminationCondition(4)]
        iteration = []
    elif kind == "no_improvement":
        calc = mod.DataSetLossCalculator(held_out)
        epoch = [mod.MaxEpochsTerminationCondition(30),
                 mod.ScoreImprovementEpochTerminationCondition(1)]
        iteration = []
    elif kind == "exploding_score":
        calc = mod.DataSetLossCalculator(held_out)
        epoch = [mod.MaxEpochsTerminationCondition(5)]
        iteration = [mod.MaxScoreIterationTerminationCondition(0.5)]
    else:  # accuracy, evaluated every other epoch
        calc = mod.ClassificationScoreCalculator(held_out)
        epoch = [mod.MaxEpochsTerminationCondition(5),
                 mod.MaxTimeTerminationCondition(3600.0)]
        iteration = []
    return mod.EarlyStoppingConfiguration(
        score_calculator=calc, epoch_termination_conditions=epoch,
        iteration_termination_conditions=iteration,
        evaluate_every_n_epochs=2 if kind == "accuracy" else 1, model_saver_path=saver)


# kind -> learning rate: "no_improvement" overshoots so a held-out epoch
# fails to improve before the 30-epoch cap
CASES = {"max_epochs": 0.5, "no_improvement": 40.0, "exploding_score": 0.5, "accuracy": 0.5}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_early_stopping_matches_jax(tmp_path, kind):
    jm = _jax_model(CASES[kind])
    start = str(tmp_path / "start.zip")
    jax_write(jm, start)
    pm = restore_multi_layer_network(start, device="cpu")
    x, y = _data(0, 32)
    xv, yv = _data(1, 16)
    jres = jes.EarlyStoppingTrainer(
        _config(jes, kind, JList(JDS(xv, yv), 8), str(tmp_path / "jbest.zip")), jm,
        JList(JDS(x, y), 8)).fit()
    pres = pes.EarlyStoppingTrainer(
        _config(pes, kind, ListDataSetIterator(DataSet(xv, yv), 8), str(tmp_path / "best.zip")),
        pm, ListDataSetIterator(DataSet(x, y), 8)).fit()
    assert sorted(pres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        assert abs(pres.score_vs_epoch[e] - float(s)) <= TOL, (e, pres.score_vs_epoch[e], s)
    assert (pres.best_model_epoch, pres.termination_reason, pres.termination_details,
            pres.total_epochs) == (jres.best_model_epoch, jres.termination_reason,
                                   jres.termination_details, jres.total_epochs)
    if kind == "no_improvement":
        assert pres.termination_details == "ScoreImprovementEpochTerminationCondition"
        assert pres.total_epochs < 30
    if kind == "exploding_score":
        assert pres.termination_reason == "IterationTerminationCondition"
    np.testing.assert_allclose(pres.best_model_score, float(jres.best_model_score),
                               rtol=0, atol=TOL)
    best = pres.best_model.params_flat().copy()
    if pres.best_model is pm:
        jbest = np.asarray(ravel_pytree(jm.params)[0])
    else:
        # the JAX best model's clone shares the live model's arrays, which
        # its donated train step then deletes: read JAX's best from its
        # saver's zip instead
        jbest = np.asarray(ravel_pytree(jax_restore(str(tmp_path / "jbest.zip")).params)[0])
    np.testing.assert_allclose(best, jbest, rtol=0, atol=TOL)
    if pres.best_model is not pm:
        # the best model is a deep copy: more training leaves it unchanged
        for lname, lp in pres.best_model.params.items():
            for k, p in lp.items():
                assert p.data_ptr() != pm.params[lname][k].data_ptr()
        pm.fit(x, y)
        np.testing.assert_array_equal(pres.best_model.params_flat(), best)
        # the saver's zip is the best model's, and the JAX package reads it
        saved = jax_restore(str(tmp_path / "best.zip"))
        np.testing.assert_array_equal(np.asarray(ravel_pytree(saved.params)[0]), best)
