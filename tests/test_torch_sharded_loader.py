"""The port's sharded per-rank loader (``deeplearning4j_tpu_torch/data/
sharded.py``) against the JAX package's (``tests/test_sharded_loader.py``),
in one process on the CPU:

* ``shard_paths``: the same partition as the JAX function for every
  (length, index, count), the same errors;
* a cursor saved at width 4 restores at width 2 (and 2 at 4) with the
  global consumed sequence non-overlapping and non-skipping: the cursor
  counts global steps, and equal per-rank consumption of a round-robin
  partition is a global prefix;
* ``ShardedDataSetIterator``'s state carries the GLOBAL batch (the same
  state dict as the JAX iterator's) and refuses a restore that changes
  it; ``reshard`` carries the cursor onto a new layout or rolls back;
* a batch is placed on the rank's device as it is (``feature_fn`` applied
  first), and a process count that is not the data axis's width raises.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import DataSet as JDS
from deeplearning4j_tpu.data import ListDataSetIterator as JList
from deeplearning4j_tpu.data import ShardedDataSetIterator as JSharded
from deeplearning4j_tpu.data import shard_paths as jax_shard_paths

from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator, ShardedDataSetIterator,
                                           shard_paths)

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [0, 1, 7, 32])
@pytest.mark.parametrize("count", [1, 2, 3, 8])
def test_shard_paths_matches_jax(n, count):
    paths = [f"f{i:03d}" for i in range(n)]
    shards = [shard_paths(paths, i, count) for i in range(count)]
    assert shards == [jax_shard_paths(paths, i, count) for i in range(count)]
    assert sorted(p for s in shards for p in s) == paths
    assert max(map(len, shards)) - min(map(len, shards)) <= 1


@pytest.mark.parametrize("args", [(["a"], 0, 0), (["a"], 2, 2), (["a"], -1, 2)])
def test_shard_paths_invalid_args(args):
    with pytest.raises(ValueError):
        shard_paths(*args)
    with pytest.raises(ValueError):
        jax_shard_paths(*args)


def _rows(n=32):
    x = np.arange(n * 4, dtype=np.float64).reshape(n, 4)
    y = np.eye(2)[np.arange(n) % 2]
    return x, y


def _rank_iter(index, count, local_batch, n=32):
    """Rank ``index``'s iterator over its round-robin share of the rows."""
    x, y = _rows(n)
    mine = shard_paths(list(range(n)), index, count)
    return ShardedDataSetIterator(ListDataSetIterator(DataSet(x[mine], y[mine]), local_batch),
                                  (CPU, count), process_count=count)


def _ids(ds):
    return [int(v) // 4 for v in np.asarray(ds.features)[:, 0]]


@pytest.mark.parametrize("widths", [(4, 2), (2, 4)])
def test_cursor_survives_a_resize(widths):
    old, new = widths
    global_batch, steps = 8, 2
    consumed, states = [], []
    for i in range(old):
        it = _rank_iter(i, old, global_batch // old)
        for _ in range(steps):
            consumed += _ids(it.next())
        states.append(it.state_dict())
    assert sorted(consumed) == list(range(steps * global_batch))
    assert all(s == states[0] for s in states)  # it counts global steps
    remaining = []
    for j in range(new):
        it = _rank_iter(j, new, global_batch // new)
        it.load_state_dict(states[j % old])
        while it.has_next():
            remaining += _ids(it.next())
    assert sorted(remaining) == list(range(steps * global_batch, 32))


def test_state_dict_carries_the_global_batch_as_jax_does():
    x, y = _rows()
    it = ShardedDataSetIterator(ListDataSetIterator(DataSet(x, y), 4), (CPU, 2),
                                process_count=2)
    jit = JSharded(JList(JDS(x, y), 4), None, process_count=2)
    it.next()
    jit.underlying.next()  # the JAX iterator's cursor, without a mesh placement
    assert it.state_dict() == jit.state_dict()
    assert it.state_dict()["global_batch"] == 8 == it.batch_size()
    assert it.local_batch_size() == 4
    it.load_state_dict(it.state_dict())


def test_load_refuses_a_changed_global_batch():
    x, y = _rows()
    st = ShardedDataSetIterator(ListDataSetIterator(DataSet(x, y), 8), (CPU, 1),
                                process_count=1).state_dict()
    it4 = ShardedDataSetIterator(ListDataSetIterator(DataSet(x, y), 4), (CPU, 1),
                                 process_count=1)
    with pytest.raises(ValueError, match="global batch"):
        it4.load_state_dict(st)
    it4.load_state_dict(it4.underlying.state_dict())  # a state without one loads


def test_reshard_carries_the_cursor_and_rolls_back():
    x, y = _rows()
    it = ShardedDataSetIterator(ListDataSetIterator(DataSet(x, y), 8), (CPU, 1),
                                process_count=1)
    first = [it.next().features for _ in range(2)]
    closed = []
    it.underlying.close = lambda *a, **kw: closed.append(True)
    new = ListDataSetIterator(DataSet(x, y), 8)
    with pytest.raises(ValueError, match="global batch"):
        it.reshard(ListDataSetIterator(DataSet(x, y), 4))
    assert closed == []
    it.reshard(new, (CPU, 1))
    assert it.underlying is new and closed == [True]
    rest = []
    while it.has_next():
        rest.append(it.next().features)
    np.testing.assert_array_equal(torch.cat(first + rest).numpy(), x)


def test_placement_and_feature_fn():
    x = (np.arange(16 * 4).reshape(16, 4) % 255).astype(np.uint8)
    y = np.eye(2)[np.arange(16) % 2]
    it = ShardedDataSetIterator(ListDataSetIterator(DataSet(x, y), 8), (CPU, 2),
                                process_count=2,
                                feature_fn=lambda a: a.astype(np.float32) / 255.0)
    ds = it.next().wait_ready()
    assert isinstance(ds.features, torch.Tensor) and ds.features.dtype == torch.float32
    assert ds.features.device == CPU
    np.testing.assert_allclose(ds.features.numpy(), x[:8].astype(np.float32) / 255.0)


def test_a_process_count_off_the_data_axis_raises():
    x, y = _rows(16)
    it = ShardedDataSetIterator(ListDataSetIterator(DataSet(x, y), 16), (CPU, 2),
                                process_count=4)
    with pytest.raises(ValueError, match="local batch"):
        it.next()
