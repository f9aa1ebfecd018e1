"""The port's arbiter (``deeplearning4j_tpu_torch/arbiter``, a copy of the
JAX package's host code) against the JAX package's: the same spaces and
seeds give the same candidates, exactly; the runner scores the port's
models, survives a failing candidate, takes ``float()`` of a tensor score
and picks the best."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import arbiter as jarb

from deeplearning4j_tpu_torch import arbiter as tarb


def _spaces(pkg):
    return {"lr": pkg.ContinuousParameterSpace(1e-4, 1e-1, log_scale=True),
            "width": pkg.IntegerParameterSpace(2, 9),
            "act": pkg.DiscreteParameterSpace(["relu", "tanh", "sigmoid"]),
            "drop": pkg.ContinuousParameterSpace(0.0, 0.5),
            "seed": pkg.FixedValue(7)}


@pytest.mark.parametrize("kind", ["random", "grid"])
def test_generators_match_jax(kind):
    if kind == "random":
        j = list(jarb.RandomSearchGenerator(_spaces(jarb), num_candidates=12, seed=3))
        t = list(tarb.RandomSearchGenerator(_spaces(tarb), num_candidates=12, seed=3))
    else:
        j = list(jarb.GridSearchGenerator(_spaces(jarb), discretization=3))
        t = list(tarb.GridSearchGenerator(_spaces(tarb), discretization=3))
    assert len(t) == len(j) > 10
    assert t == j


def test_runner_scores_port_models_and_survives_a_failure():
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.train.updaters import Adam

    rs = np.random.RandomState(0)
    x = rs.randn(64, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0] > 0).astype(int)]

    def factory(hp):
        if hp["width"] == 3:
            raise RuntimeError("planted failure")
        conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(hp["lr"])).list()
                .layer(DenseLayer(n_in=4, n_out=hp["width"]))
                .layer(OutputLayer(n_in=hp["width"], n_out=2)).build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        net.fit(x, y, epochs=3)
        return net

    def score(net, hp):  # a 0-dim tensor, as a card-side loss would be
        return torch.as_tensor(net.score(x, y))

    spaces = {"lr": tarb.ContinuousParameterSpace(1e-3, 1e-1, log_scale=True),
              "width": tarb.DiscreteParameterSpace([3, 4, 8])}
    gen = tarb.RandomSearchGenerator(spaces, num_candidates=6, seed=2)
    assert [hp["width"] for hp in gen].count(3) >= 1
    runner = tarb.LocalOptimizationRunner(tarb.OptimizationConfiguration(
        candidate_generator=gen, model_factory=factory, score_function=score))
    best = runner.execute()
    assert runner.num_candidates_completed() == 6
    failed = [r for r in runner.results if r.error]
    assert failed and all("planted" in r.error and r.score == float("inf") for r in failed)
    ok = [r for r in runner.results if not r.error]
    assert best.score == min(r.score for r in ok) and isinstance(best.score, float)
    assert all(r.duration_s > 0 for r in runner.results)
