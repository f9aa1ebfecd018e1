"""The port's ``ShardedEmbeddingTable`` against the JAX package's
(``parallel/sharded_embedding.py``): the seeded table, lookups (repeated
ids included) and a sparse update whose repeated ids accumulate, over
four gloo CPU ranks spawned once for the module
(``deeplearning4j_tpu_torch/tools/parallel_cases.py``) against the JAX
table row-sharded over eight virtual devices. Both tables are float32.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.parallel import ShardedEmbeddingTable as JTable
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmesh

from deeplearning4j_tpu_torch.tools.parallel_cases import result, run_world

WORLD = 4

#: name: (vocab, dim, seed, ids)
CASES = {
    "padded": (30, 8, 1, [0, 7, 29, 7]),         # 30 rows pad to 32
    "even": (64, 16, 0, [63, 0, 31, 32, 32, 5]),  # 16 rows a rank
    "wide": (1000, 32, 3, list(range(0, 1000, 37)) + [999, 999, 0]),
}


def _deltas(name):
    v, d, _, ids = CASES[name]
    return np.random.RandomState(len(ids)).randn(len(ids), d).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded_table"))
    cases = []
    for name, (v, dim, seed, ids) in CASES.items():
        np.savez(f"{d}/{name}.npz", ids=np.asarray(ids, np.int64), deltas=_deltas(name))
        cases.append(dict(name=name, kind="table", mesh={"model": WORLD}, vocab=v, dim=dim,
                          seed=seed, data=f"{d}/{name}.npz"))
    run_world(cases, WORLD, d)
    return d


def _jax_table(name):
    v, dim, seed, _ = CASES[name]
    return JTable(v, dim, jmesh(model=8), seed=seed)


@pytest.mark.parametrize("name", list(CASES))
def test_table_matches_jax(world, name):
    t = _jax_table(name)
    for r in range(WORLD):
        got = result(world, name, r)
        assert np.array_equal(got["table"], t.to_numpy()), r
        assert int(got["shards"]) == WORLD
        assert int(got["padded"]) == -(-CASES[name][0] // WORLD) * WORLD
        assert int(got["local_rows"]) * WORLD == int(got["padded"])


@pytest.mark.parametrize("name", list(CASES))
def test_lookup_matches_jax(world, name):
    t = _jax_table(name)
    ids = np.asarray(CASES[name][3], np.int32)
    want = np.asarray(t.lookup(ids))
    for r in range(WORLD):
        assert np.array_equal(result(world, name, r)["lookup"], want), r


@pytest.mark.parametrize("name", list(CASES))
def test_sparse_update_matches_jax(world, name):
    t = _jax_table(name)
    ids = np.asarray(CASES[name][3], np.int32)
    dense = t.to_numpy().copy()
    t.add_sparse(ids, _deltas(name))
    np.add.at(dense, ids, _deltas(name))  # repeated ids accumulate
    for r in range(WORLD):
        got = result(world, name, r)["table_after"]
        np.testing.assert_allclose(got, np.asarray(t.to_numpy()), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got, dense, rtol=1e-6, atol=1e-7)
