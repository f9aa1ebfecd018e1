"""The copy to the card of ``data.device_put_dataset`` and the async
iterator's device ring. These tests need a CUDA device and skip without
one. Where there is one (and, as on the chip machine, no JAX for
``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_data_cuda.py

Held here: the copies run on the copy stream (not the consumer's), from
pinned host memory, and end with the batch's event; the consumer's stream
waits on that event, so a batch whose copy was held back on the copy stream
(a sleep kernel queued before it) is still read whole; the tensors are
recorded on the consumer's stream; and a whole epoch through
``AsyncDataSetIterator(device_buffers=2)`` and ``MappedDataSetIterator``
arrives on the card bit-equal to the host batches."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (AsyncDataSetIterator, ListDataSetIterator,
                                                     MappedDataSetIterator, _copy_stream,
                                                     device_put_dataset)
from deeplearning4j_tpu_torch.obs import MetricsRegistry

pytestmark = pytest.mark.cuda

SLEEP_CYCLES = 200_000_000  # cycles of a sleep kernel: far longer than the copies


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the copy stream and its events exist only on the card")
    return torch.device("cuda")


def _host(n=64, f=4096, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (n, f)).astype(np.uint8), np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)]


def _held_back(cuda, ds_host):
    """device_put_dataset of ``ds_host`` while a sleep kernel holds the copy
    stream back (after a first put of the same sizes, so that the pinned
    staging buffers come from the pinned allocator's cache)."""
    device_put_dataset(ds_host).wait_ready()
    torch.cuda.synchronize()
    stream = _copy_stream(cuda)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(SLEEP_CYCLES)
    return stream, device_put_dataset(ds_host)


def test_copy_runs_on_the_copy_stream_and_ends_with_the_event(cuda):
    x, y = _host()
    stream, ds = _held_back(cuda, DataSet(x, y))
    assert stream != torch.cuda.current_stream(cuda)
    assert ds.features.is_cuda and ds.labels.is_cuda, (ds.features.device, ds.labels.device)
    assert ds.features.dtype == torch.uint8, ds.features.dtype
    assert isinstance(ds.ready, torch.cuda.Event), type(ds.ready)
    assert not stream.query(), "the sleep kernel ended before the host checked"
    assert not ds.ready.query(), "the copy's event completed before the copy stream ran it"
    ds.wait_ready()
    assert ds.ready is None
    # the consumer's reads are ordered after the copy: whole batch, exact
    total = ds.features.to(torch.int64).sum()
    assert int(total) == int(x.astype(np.int64).sum())
    np.testing.assert_array_equal(ds.features.cpu().numpy(), x)
    np.testing.assert_array_equal(ds.labels.cpu().numpy(), y)


def test_wait_ready_orders_the_consumer_stream_not_the_host(cuda):
    x, y = _host(seed=1)
    stream, ds = _held_back(cuda, DataSet(x, y))
    consumer = torch.cuda.Stream(cuda)
    with torch.cuda.stream(consumer):
        ds.wait_ready()                      # returns at once: the host does not block
        assert not stream.query()
        done = torch.cuda.Event()
        out = ds.features.float().mean()
        done.record(consumer)
    done.synchronize()
    np.testing.assert_allclose(float(out), float(x.astype(np.float64).mean()), rtol=1e-6)
    assert stream.query()                    # the consumer finished only after the copy


def test_tensors_are_recorded_on_the_consumer_stream(cuda, monkeypatch):
    x, y = _host(seed=2)
    ds = device_put_dataset(DataSet(x, y))
    seen = []
    orig = torch.Tensor.record_stream

    def spy(self, s):
        seen.append((self.data_ptr(), s))
        return orig(self, s)

    monkeypatch.setattr(torch.Tensor, "record_stream", spy)
    ds.wait_ready()
    cur = torch.cuda.current_stream(cuda)
    assert {p for p, _ in seen} == {ds.features.data_ptr(), ds.labels.data_ptr()}
    assert all(s == cur for _, s in seen)


def test_pinned_staging_copies_are_asynchronous(cuda):
    x, _ = _host(n=256, f=65536, seed=3)     # 16 MiB
    _, ds = _held_back(cuda, DataSet(x, x[:, :1]))
    # the host returned while the copy still waits behind the sleep: a
    # copy from pageable memory would have blocked the host until it ended
    assert not ds.ready.query()
    ds.wait_ready()
    torch.cuda.synchronize()
    assert torch.equal(ds.features.cpu(), torch.from_numpy(x))


def test_async_epoch_through_the_ring_is_bit_equal(cuda):
    x, y = _host(n=96, f=3 * 16 * 16, seed=4)
    base = ListDataSetIterator(DataSet(x, y), 16, shuffle=True, seed=7)
    # the epoch the async iterator reads: the freshly built iterator's
    # (iterating with ``for`` would reset() and draw the next epoch's order)
    ref = ListDataSetIterator(DataSet(x, y), 16, shuffle=True, seed=7)
    want = []
    while ref.has_next():
        b = ref.next()
        want.append((b.features, b.labels))

    def slow_put(ds):
        with torch.cuda.stream(_copy_stream(cuda)):
            torch.cuda._sleep(SLEEP_CYCLES // 10)
        return device_put_dataset(ds)

    def prep(f):                              # on the consumer's stream, after the wait
        return f.reshape(-1, 3, 16, 16).float() / 255.0

    it = MappedDataSetIterator(
        AsyncDataSetIterator(base, device_put_fn=slow_put, device_buffers=2,
                             registry=MetricsRegistry()),
        feature_fn=prep)
    got = []
    while it.has_next():
        ds = it.next()
        assert ds.features.is_cuda and ds.features.dtype == torch.float32
        got.append((ds.features, ds.labels))
    assert len(got) == len(want) == 6
    for (gf, gl), (wf, wl) in zip(got, want):
        np.testing.assert_array_equal((gf * 255.0).round().to(torch.uint8).cpu().numpy()
                                      .reshape(wf.shape), wf)
        np.testing.assert_array_equal(gl.cpu().numpy(), wl)
    stats = it.underlying.stats()
    assert stats["batches"] == 6 and stats["device_buffers"] == 2
    it.underlying.close()
