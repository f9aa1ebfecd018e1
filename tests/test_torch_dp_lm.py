"""The port's ``DistributedTrainer`` on the main path's model and its feeding
paths, on two gloo ranks against the JAX trainer at ``make_mesh(data=2)``:

* a 2-block, 16-wide ``TransformerLM`` (float64, Adam) under
  ``SyncAllReduce`` and ``BucketedAllReduceSync``: every attention layer
  goes through the port's ``flash_attention`` seam, whose plain version
  runs for CPU tensors (B1-B3 on the card);
* ``fit``'s carry: local batches of 3, 3 and 2 rows per rank (global 6, 6
  and 4) train three steps, as the JAX trainer's re-chunking does on the
  global batches, and drop no row (one shard per rank: the JAX
  multi-process contract); a ragged stream (3, 2, 3) carries its short
  batch into the next and trains every row;
* ``fit_iterator`` through a ``ShardedDataSetIterator``: each rank's local
  blocks, copied to its device, train as ``fit_batch`` on the global
  batches does.

Params and scores to 1e-10 after 3 steps, ranks bit for bit equal.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.model.zoo import TransformerLM as JaxLM
from deeplearning4j_tpu.train import updaters as jupd

from torch_dp_helpers import (STEPS, TOL, batches, check_ranks_equal, jax_fit, jax_trainer,
                              max_err, mlp, result, run_world, zip_of)

WORLD = 2
VOCAB, T, LM_BATCH = 23, 12, 4


def _lm():
    return JaxLM(vocab_size=VOCAB, hidden=16, n_layers=2, n_heads=2, max_len=T, seed=9,
                 updater=jupd.Adam(0.01), dtype="float64").init()


LM_CASES = {"lm_sync": ("SyncAllReduce", {}),
            "lm_bucketed": ("BucketedAllReduceSync", dict(bucket_bytes=2048))}
ALIGNED, RAGGED = [6, 6, 4], [6, 4, 6]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp_lm"))
    batches(f"{d}/lm.npz", STEPS, LM_BATCH, (T,), None, seed=6, int_inputs=VOCAB)
    batches(f"{d}/ff.npz", STEPS, 8, (6,), 3, seed=7)
    rs = np.random.RandomState(8)
    np.savez(f"{d}/rows.npz", x=rs.randn(16, 6), y=np.eye(3)[rs.randint(0, 3, 16)])
    cases = [dict(name=n, zip=zip_of(_lm(), d, n), data=f"{d}/lm.npz", steps=STEPS,
                  strategy=s, strategy_kwargs=kw) for n, (s, kw) in LM_CASES.items()]
    cases += [dict(name=n, zip=zip_of(mlp(), d, n), data=f"{d}/rows.npz", mode="fit",
                   batches=b) for n, b in (("fit_aligned", ALIGNED), ("fit_ragged", RAGGED))]
    cases.append(dict(name="sharded", zip=zip_of(mlp(), d, "sharded"), data=f"{d}/ff.npz",
                      mode="sharded", global_batch=8))
    run_world(cases, WORLD, d)
    return d


@pytest.mark.parametrize("name", list(LM_CASES))
def test_transformer_lm_matches_jax(world, name):
    strat, kw = LM_CASES[name]
    r0 = check_ranks_equal(world, name, WORLD)
    with np.load(f"{world}/lm.npz") as z:
        x, y = z["x"], z["y"]
    _, params, scores = jax_fit(_lm(), WORLD, x, y, name=strat, kw=kw)
    assert max_err(r0["params"], params) <= TOL
    assert max_err(r0["scores"], scores) <= TOL


def test_bucketed_lm_equals_sync(world):
    assert np.array_equal(result(world, "lm_sync", 0)["params"],
                          result(world, "lm_bucketed", 0)["params"])


def test_fit_carry_matches_jax(world):
    r0 = check_ranks_equal(world, "fit_aligned", WORLD)
    with np.load(f"{world}/rows.npz") as z:
        x, y = z["x"], z["y"]
    from deeplearning4j_tpu.data.dataset import DataSet as JDS
    from jax.flatten_util import ravel_pytree

    jm = mlp()
    t = jax_trainer(jm, WORLD)
    offs = np.cumsum([0] + ALIGNED)
    t.fit([JDS(x[a:b], y[a:b]) for a, b in zip(offs[:-1], offs[1:])])
    assert int(r0["iteration_count"]) == jm.iteration_count == 3
    assert int(r0["dropped_rows"]) == t.dropped_rows == 0
    assert max_err(r0["params"], np.asarray(ravel_pytree(jm.params)[0])) <= TOL
    assert abs(float(r0["scores"][0]) - jm.score_value) <= TOL


def test_fit_carries_a_short_batch(world):
    r0 = check_ranks_equal(world, "fit_ragged", WORLD)
    # local 3, 2, 3 rows: emit 3, carry 2 into the next (5: emit 3, carry
    # 2), then the tail of 2: three steps, every row trained, none dropped
    assert int(r0["iteration_count"]) == 3
    assert int(r0["dropped_rows"]) == 0 and int(r0["warned"]) == 0


def test_sharded_iterator_feeds_the_trainer(world):
    r0 = check_ranks_equal(world, "sharded", WORLD)
    assert int(r0["global_batch_size"]) == 8
    with np.load(f"{world}/ff.npz") as z:
        x, y = z["x"], z["y"]
    _, params, scores = jax_fit(mlp(), WORLD, x, y)
    assert max_err(r0["params"], params) <= TOL
    assert abs(float(r0["scores"][0]) - scores[-1]) <= TOL
