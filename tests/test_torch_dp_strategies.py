"""The port's ``DistributedTrainer`` against the JAX package's, strategy by
strategy, on two gloo ranks (``tests/torch_dp_workers.py``) against the
JAX trainer at ``make_mesh(data=2)``.

The MLP's weights cross through the JAX model zip; each rank feeds its
block of rows of the same seeded global batches. Float64 without dropout;
params and scores to 1e-10 after 3 steps, the ranks bit for bit equal to
each other. Covered: each of the five strategies (the parameter average
taken at ``sync_to_model``), gradient normalization after the exchange,
ZeRO-1 left off; and ``BucketedAllReduceSync`` bit for bit equal to
``SyncAllReduce`` at two ranks.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf import GradientNormalization as JGN
from deeplearning4j_tpu.train import updaters as jupd

from torch_dp_helpers import (STEPS, TOL, batches, check_ranks_equal, jax_fit, max_err, mlp,
                              result, run_world, zip_of)

WORLD = 2
GLOBAL_BATCH = 8
CLIP = dict(gradient_normalization=JGN.CLIP_L2_PER_LAYER, gradient_normalization_threshold=0.05)

CASES = {
    "sync": dict(strategy="SyncAllReduce"),
    "bucketed": dict(strategy="BucketedAllReduceSync", kw=dict(bucket_bytes=128)),
    "threshold": dict(strategy="ThresholdCompressedSync",
                      kw=dict(threshold=0.02, target_density=0.3)),
    "topk": dict(strategy="TopKCompressedSync", kw=dict(density=0.25)),
    "param_avg": dict(strategy="ParameterAveragingSync", kw=dict(frequency=2)),
    "adam_sync": dict(strategy="SyncAllReduce", updater=lambda: jupd.Adam(0.05)),
    "clip_sync": dict(strategy="SyncAllReduce", conf=CLIP),
    "clip_bucketed": dict(strategy="BucketedAllReduceSync", kw=dict(bucket_bytes=64), conf=CLIP),
}


def _model(c):
    return mlp(updater=c["updater"]() if "updater" in c else None, **c.get("conf", {}))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp_strategies"))
    data = f"{d}/data.npz"
    batches(data, STEPS, GLOBAL_BATCH, (6,), 3, seed=1)
    cases = [dict(name=n, zip=zip_of(_model(c), d, n), data=data, steps=STEPS,
                  strategy=c["strategy"], strategy_kwargs=c.get("kw", {}))
             for n, c in CASES.items()]
    run_world(cases, WORLD, d)
    return d


@pytest.mark.parametrize("name", list(CASES))
def test_strategy_matches_jax(world, name):
    c = CASES[name]
    r0 = check_ranks_equal(world, name, WORLD)
    with np.load(f"{world}/data.npz") as z:
        x, y = z["x"], z["y"]
    t, params, scores = jax_fit(_model(c), WORLD, x, y, name=c["strategy"], kw=c.get("kw"))
    assert max_err(r0["params"], params) <= TOL
    assert max_err(r0["scores"], scores) <= TOL
    comp = t.compression_stats()
    if c["strategy"] in ("ThresholdCompressedSync", "TopKCompressedSync"):
        # the world-mean density (float32 in both) and the adapted threshold
        assert abs(float(r0["density"]) - comp["density"]) <= 1e-7
        if "threshold" in comp:
            assert float(r0["threshold"]) == pytest.approx(comp["threshold"], rel=1e-6)


def test_bucketed_equals_sync_bit_for_bit(world):
    """Two ranks: a + b does not depend on how the buffers are packed."""
    a, b = result(world, "sync", 0), result(world, "bucketed", 0)
    assert np.array_equal(a["params"], b["params"])
    assert np.array_equal(a["scores"], b["scores"])


def test_parameter_averaging_diverges_between_syncs(world):
    """Between sync points the replicas train on their own rows (the
    trainer's ``sync_to_model`` takes the final average), so the averaged
    run is not the all-reduced one."""
    assert max_err(result(world, "param_avg", 0)["params"],
                   result(world, "sync", 0)["params"]) > 1e-6
