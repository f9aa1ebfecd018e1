"""The port's datasets and iterators against the JAX package.

Both packages draw shuffles with numpy, so for a seed the port's batches are
the JAX package's, element for element: held here for ``DataSet``,
``ListDataSetIterator`` (order, epochs, ``state_dict`` mid-epoch resume),
``MultipleEpochsIterator``, ``MappedDataSetIterator``,
``AsyncDataSetIterator`` (resume past the prefetch run-ahead, ``close``,
``reset``, the device-buffer ring and ``stats()``, on CPU tensors),
``MnistDataSetIterator`` (byte-equal digits) and the normalizers. The card's
copy path (streams and events) is ``tests/test_torch_data_cuda.py``."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.data import iterators as jit_
from deeplearning4j_tpu.data import normalizers as jnorm
from deeplearning4j_tpu.data.mnist import MnistDataSetIterator as JaxMnist
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry

from deeplearning4j_tpu_torch.data import dataset as pds
from deeplearning4j_tpu_torch.data import iterators as pit
from deeplearning4j_tpu_torch.data import normalizers as pnorm
from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator as PortMnist
from deeplearning4j_tpu_torch.obs import MetricsRegistry

PKGS = {"jax": (jds, jit_), "port": (pds, pit)}


def _data(n=20, f=3, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, n)]
    return x, y


def _consume(it, n):
    """n batches with fit_iterator's epoch discipline: reset only when
    exhausted."""
    out = []
    for _ in range(n):
        if not it.has_next():
            it.reset()
        out.append(np.asarray(it.next().features))
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for i, (x1, x2) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x1, x2, err_msg=f"batch {i}")


def _list_it(pkg, shuffle=True, n=20, seed=3, batch=4):
    ds, it = PKGS[pkg]
    x, y = _data(n)
    return it.ListDataSetIterator(ds.DataSet(x, y), batch, shuffle=shuffle, seed=seed)


# ---------------------------------------------------------------------------
# DataSet
# ---------------------------------------------------------------------------


def test_dataset_ops_match_jax():
    x, y = _data(10)
    m = (np.arange(10) % 3 > 0).astype(np.float32)[:, None]
    jd, pd_ = jds.DataSet(x.copy(), y.copy(), m.copy()), pds.DataSet(x.copy(), y.copy(), m.copy())
    jd.shuffle(seed=4)
    pd_.shuffle(seed=4)
    np.testing.assert_array_equal(jd.features, pd_.features)
    np.testing.assert_array_equal(jd.features_mask, pd_.features_mask)
    for a, b in zip(jd.batch_by(3), pd_.batch_by(3)):
        np.testing.assert_array_equal(a.labels, b.labels)
    jtr, jte = jd.split_test_and_train(7)
    ptr, pte = pd_.split_test_and_train(7)
    assert (ptr.num_examples(), pte.num_examples()) == (jtr.num_examples(), jte.num_examples())
    merged = pds.DataSet.merge([ptr, pte])
    np.testing.assert_array_equal(merged.features, pd_.features)


def test_dataset_to_device_and_wait_ready_without_event():
    x, y = _data(4)
    d = pds.DataSet(x, y).to("cpu")
    assert isinstance(d.features, torch.Tensor) and d.features_mask is None
    np.testing.assert_array_equal(d.features.numpy(), x)
    assert d.ready is None and d.wait_ready() is d
    # device_put_dataset to the CPU gives tensors and no event
    put = pit.device_put_dataset(pds.DataSet(x, y), "cpu")
    assert put.ready is None and torch.equal(put.labels, torch.from_numpy(y))


# ---------------------------------------------------------------------------
# ListDataSetIterator and the wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle", [True, False])
def test_list_iterator_order_matches_jax(shuffle):
    _equal(_consume(_list_it("jax", shuffle), 13), _consume(_list_it("port", shuffle), 13))
    assert _list_it("port").batch_size() == 4


@pytest.mark.parametrize("consumed", [0, 3, 5, 7, 12])
def test_list_iterator_resume_matches_jax(consumed):
    states = {}
    for pkg in PKGS:
        it = _list_it(pkg)
        _consume(it, consumed)
        states[pkg] = it.state_dict()
    assert states["port"] == states["jax"]
    json.loads(json.dumps(states["port"]))
    full = _consume(_list_it("jax"), 15)
    resumed = _list_it("port")
    resumed.load_state_dict(states["jax"])
    _equal(full[consumed:], _consume(resumed, 15 - consumed))


def test_multiple_epochs_and_mapped_match_jax():
    streams = {}
    for pkg, (ds, it) in PKGS.items():
        x, y = _data()
        multi = it.MultipleEpochsIterator(
            it.ListDataSetIterator(ds.DataSet(x, y), 4, shuffle=True, seed=1), epochs=3)
        mapped = it.MappedDataSetIterator(multi, feature_fn=lambda f: f * 2.0,
                                          label_fn=lambda l: l + 1.0)
        got = []
        while mapped.has_next():
            d = mapped.next()
            got.append(np.concatenate([np.asarray(d.features), np.asarray(d.labels)], 1))
        streams[pkg] = got
        assert len(got) == 15 and mapped.batch_size() == 4
        assert multi.state_dict()["multi_epoch"] == 2
    _equal(streams["jax"], streams["port"])


def test_multiple_epochs_resume_matches_jax():
    x, y = _data()
    its = {}
    for pkg, (ds, it) in PKGS.items():
        its[pkg] = it.MultipleEpochsIterator(
            it.ListDataSetIterator(ds.DataSet(x, y), 4, shuffle=True, seed=1), epochs=3)
        for _ in range(7):
            its[pkg].next()
    state = its["jax"].state_dict()
    assert its["port"].state_dict() == state
    fresh = pit.MultipleEpochsIterator(
        pit.ListDataSetIterator(pds.DataSet(x, y), 4, shuffle=True, seed=1), epochs=3)
    fresh.load_state_dict(state)
    _equal([np.asarray(its["jax"].next().features) for _ in range(4)],
           [np.asarray(fresh.next().features) for _ in range(4)])


def test_base_iterator_raises_clearly():
    class Bare(pit.DataSetIterator):
        pass

    with pytest.raises(NotImplementedError, match="Bare"):
        Bare().state_dict()
    with pytest.raises(NotImplementedError, match="Bare"):
        Bare().load_state_dict({})


# ---------------------------------------------------------------------------
# AsyncDataSetIterator on CPU tensors
# ---------------------------------------------------------------------------


def _to_cpu(ds):
    return pit.device_put_dataset(ds, "cpu")


def _async(reg=None, n=32, **kw):
    x, y = _data(n)
    return pit.AsyncDataSetIterator(
        pit.ListDataSetIterator(pds.DataSet(x, y), 4, shuffle=True, seed=9),
        registry=reg if reg is not None else MetricsRegistry(), **kw)


def test_async_stream_equals_jax_list_order():
    it = _async(queue_size=6, device_put_fn=_to_cpu, device_buffers=2)
    got = _consume(it, 12)
    it.close()
    x, y = _data(32)
    want = _consume(jit_.ListDataSetIterator(jds.DataSet(x, y), 4, shuffle=True, seed=9), 12)
    _equal(want, got)


def test_async_batches_are_tensors_on_the_put_device():
    it = _async(device_put_fn=_to_cpu, device_buffers=1)
    d = it.next()
    assert isinstance(d.features, torch.Tensor) and d.features.device.type == "cpu"
    assert d.ready is None
    it.close()


def test_async_resume_ignores_runahead():
    full = _consume(_async(queue_size=6), 16)
    it1 = _async(queue_size=6)
    got = _consume(it1, 3)
    deadline = time.monotonic() + 5.0
    while it1.stats()["queue_depth"] < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    state = it1.state_dict()
    assert state["batches"] == 3
    it1.close()
    it2 = _async(queue_size=6)
    it2.load_state_dict(state)
    _equal(full[:3], got)
    _equal(full[3:], _consume(it2, 13))
    it2.close()


def test_async_close_joins_parked_producer_and_reset_restarts():
    it = _async(queue_size=2, device_put_fn=_to_cpu, device_buffers=1)
    first = np.asarray(it.next().features)
    time.sleep(0.1)  # the producer parks on the full ring / queue
    t = it._thread
    assert t is not None and t.is_alive()
    it.close()
    assert not t.is_alive()
    it.close()  # idempotent
    it.reset()
    again = np.asarray(it.next().features)
    assert first.shape == again.shape
    it.close()
    assert not any(th.name.startswith(f"dsi-{it.name}") and th.is_alive()
                   for th in threading.enumerate())


def test_async_ring_bounds_device_batches():
    """With device_buffers=2 the producer never holds more than 2 put
    batches beyond the consumer's, whatever the queue size."""
    puts = []

    def counting_put(ds):
        puts.append(time.monotonic())
        return _to_cpu(ds)

    it = _async(queue_size=8, device_put_fn=counting_put, device_buffers=2)
    it.next()
    time.sleep(0.2)
    # consumer holds 1 + the lookahead item; the ring allows 2 more in flight
    assert len(puts) <= 4, len(puts)
    assert it.stats()["device_buffers"] == 2
    it.close()


def test_async_stats_and_series_match_jax_names():
    preg, jreg = MetricsRegistry(), JaxRegistry()
    p = _async(preg, name="p")
    x, y = _data(32)
    j = jit_.AsyncDataSetIterator(
        jit_.ListDataSetIterator(jds.DataSet(x, y), 4, shuffle=True, seed=9),
        registry=jreg, name="j")
    for it in (p, j):
        while it.has_next():
            it.next()
    ps, js = p.stats(), j.stats()
    assert set(ps) == set(js)
    for k in ("batches", "fetches", "queue_capacity", "device_buffers"):
        assert ps[k] == js[k], k
    assert ps["batches"] == 8 and 0.0 <= ps["prefetch_hit_rate"] <= 1.0
    assert ps["consumer_starvation_s"] >= 0.0 and ps["producer_blocked_s"] >= 0.0
    def data_series(reg):
        return {f.name for f in reg.collect() if f.name.startswith("dl4j_tpu_data_")}

    assert data_series(preg) == data_series(jreg) and len(data_series(preg)) == 7
    p.close()
    j.close()


def test_async_propagates_producer_error():
    class Boom(pit.DataSetIterator):
        def has_next(self):
            return True

        def next(self):
            raise ValueError("bad batch")

        def reset(self):
            pass

    it = pit.AsyncDataSetIterator(Boom(), registry=MetricsRegistry())
    with pytest.raises(ValueError, match="bad batch"):
        it.has_next()
    it.close()


# ---------------------------------------------------------------------------
# MNIST and the normalizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False])
def test_mnist_digits_byte_equal_to_jax(train):
    kw = dict(train=train, num_examples=96, seed=11)
    j, p = JaxMnist(32, **kw), PortMnist(32, **kw)
    assert p.provenance == j.provenance
    assert p.data.features.tobytes() == j.data.features.tobytes()
    assert p.data.labels.tobytes() == j.data.labels.tobytes()
    _equal(_consume(j, 4), _consume(p, 4))


@pytest.mark.parametrize("kind", ["NormalizerStandardize", "NormalizerMinMaxScaler",
                                  "ImagePreProcessingScaler", "VGG16ImagePreProcessor"])
def test_normalizers_match_jax(kind):
    rs = np.random.RandomState(2)
    if kind == "VGG16ImagePreProcessor":
        x = rs.uniform(0, 255, (6, 3, 4, 4)).astype(np.float32)
    else:
        x = rs.uniform(0, 255, (12, 5)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, x.shape[0])]
    j, p = getattr(jnorm, kind)(), getattr(pnorm, kind)()
    j.fit(jit_.ListDataSetIterator(jds.DataSet(x, y), 4))
    p.fit(pit.ListDataSetIterator(pds.DataSet(x, y), 4))
    jd, pd_ = jds.DataSet(x.copy(), y), pds.DataSet(x.copy(), y)
    j.transform(jd)
    p.transform(pd_)
    np.testing.assert_array_equal(jd.features, pd_.features)
    js, ps = j.state_dict(), p.state_dict()
    assert set(js) == set(ps)
    for k in js:
        np.testing.assert_array_equal(np.asarray(js[k]), np.asarray(ps[k]))
    p.revert(pd_)
    np.testing.assert_allclose(pd_.features, x, rtol=1e-5, atol=1e-3)
