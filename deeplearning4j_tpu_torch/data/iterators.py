"""Dataset iterators with async prefetch (port of
``deeplearning4j_tpu/data/iterators.py``).

Reference: org.nd4j.linalg.dataset.api.iterator.DataSetIterator and
AsyncDataSetIterator (background prefetch thread + bounded queue — the
I/O↔compute overlap boundary in SURVEY.md §3.1).

The iterators are the JAX package's numpy code, with the same shuffle order
for a seed and the same ``state_dict`` positions. What differs is the copy to
the card: JAX's ``device_put`` is asynchronous and ordered for free, while
here :func:`device_put_dataset` stages each batch in pinned host memory,
issues the copies on a CUDA stream of its own from the prefetch thread, and
records an event; the consumer's stream waits on that event
(:meth:`DataSet.wait_ready`, called by :meth:`AsyncDataSetIterator.next`)
before the step reads the batch.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core.dtypes import default_device
from .dataset import DataSet
from ..obs.metrics import MetricsRegistry, get_registry

_prefetch_seq = itertools.count()


class DataSetIterator:
    """Base iterator protocol (reference: DataSetIterator).

    **Iterator-state protocol** (exact mid-epoch resume;
    train/checkpoint.py captures it in the checkpoint sidecar): a
    stateful iterator implements :meth:`state_dict` — a small JSON-able
    dict with at least ``{"epoch": int, "batches": int}`` describing the
    CONSUMER position (batches handed out this epoch, NOT any prefetch
    run-ahead) — and :meth:`load_state_dict`, which repositions a freshly
    built identical iterator so the next ``next()`` yields exactly the
    first batch the snapshotted consumer had not yet received. Wrappers
    delegate; iterators without a deterministic position (plain
    generators) keep the base behavior and raise."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch_size(self) -> int:
        raise NotImplementedError

    def state_dict(self) -> dict:
        raise NotImplementedError(
            f"{type(self).__name__} does not support iterator-state "
            "checkpointing (state_dict)")

    def load_state_dict(self, state: dict) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support iterator-state "
            "checkpointing (load_state_dict)")


class ListDataSetIterator(DataSetIterator):
    """Iterate over an in-memory DataSet in minibatches (reference:
    ListDataSetIterator / IteratorDataSetIterator)."""

    def __init__(self, data: DataSet, batch: int, shuffle: bool = False, seed: int = 0) -> None:
        self.data = data
        self.batch = batch
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._order = np.arange(data.num_examples())
        self._pos = 0
        self.reset()

    def reset(self) -> None:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            self._order = rng.permutation(self.data.num_examples())
            self._epoch += 1
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < self.data.num_examples()

    def next(self) -> DataSet:
        idx = self._order[self._pos : self._pos + self.batch]
        self._pos += self.batch
        d = self.data
        return DataSet(
            d.features[idx], d.labels[idx],
            None if d.features_mask is None else d.features_mask[idx],
            None if d.labels_mask is None else d.labels_mask[idx],
        )

    def batch_size(self) -> int:
        return self.batch

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "batches": self._pos // self.batch}

    def load_state_dict(self, state: dict) -> None:
        # the active epoch's order was drawn with seed + (_epoch - 1)
        # (reset() draws, THEN increments _epoch) — regenerate it rather
        # than storing the permutation itself
        self._epoch = int(state["epoch"])
        self._pos = int(state["batches"]) * self.batch
        if self.shuffle and self._epoch > 0:
            rng = np.random.default_rng(self.seed + self._epoch - 1)
            self._order = rng.permutation(self.data.num_examples())
        else:
            self._order = np.arange(self.data.num_examples())


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded queue (reference:
    AsyncDataSetIterator; queue_size = reference's default 8). Optionally
    applies ``device_put_fn`` on the worker thread so batches land on device
    before the consumer asks for them.

    Observability (obs/): ``dl4j_tpu_data_*`` series with an ``instance``
    label — prefetch queue depth + high-water mark, producer blocked time
    (queue full: compute is the bottleneck, good) and consumer starvation
    time (queue empty: INPUT is the bottleneck — the I/O↔compute overlap
    signal fleet reports scrape). :meth:`stats` is the
    per-instance view over the same children.

    Shutdown: a consumer abandoning iteration mid-epoch calls
    :meth:`close` (``reset`` does it implicitly) which stops and JOINS the
    prefetch thread instead of leaking it behind a full queue. ``close``
    is idempotent and safe to call concurrently (including while the
    producer is parked on a full queue).

    Device buffer ring: with ``device_put_fn`` set, each batch's H2D
    transfer is dispatched on the prefetch thread AT ENQUEUE TIME
    (:func:`device_put_dataset` copies on its own stream, so the copy for
    step N+1 overlaps compute for step N — true double buffering; the
    consumer's stream waits on the batch's event in :meth:`next`). ``device_buffers=N`` bounds the
    ring: at most N batches may be resident/in-flight in device memory
    beyond the one the consumer holds, independent of the (host-side)
    ``queue_size`` — deep host prefetch without unbounded device memory. A slot is
    acquired before the transfer starts and released when the consumer
    dequeues the batch.
    """

    _SENTINEL = object()

    def __init__(
        self,
        underlying: DataSetIterator,
        queue_size: int = 8,
        device_put_fn: Optional[Callable[[DataSet], DataSet]] = None,
        registry: Optional[MetricsRegistry] = None,
        name: Optional[str] = None,
        device_buffers: Optional[int] = None,
    ) -> None:
        if device_buffers is not None and device_buffers < 1:
            raise ValueError(
                f"device_buffers must be >= 1, got {device_buffers}")
        self.underlying = underlying
        self.queue_size = queue_size
        self.device_put_fn = device_put_fn
        self.device_buffers = device_buffers
        self.name = name or f"prefetch-{next(_prefetch_seq)}"
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._next_item = None
        self._started = False
        self._stop = threading.Event()
        self._close_lock = threading.Lock()
        self._hits = 0  # dequeues served without waiting
        self._consumed = 0  # batches handed to the consumer this epoch
        self._dev_slots = self._make_ring()
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        inst = self.name
        self._g_depth = reg.gauge(
            "dl4j_tpu_data_prefetch_queue_depth",
            "Prefetched batches waiting for the consumer",
            ("instance",)).labels(inst)
        self._g_hwm = reg.gauge(
            "dl4j_tpu_data_prefetch_queue_high_water",
            "Prefetch queue depth high-water mark", ("instance",)).labels(inst)
        self._c_batches = reg.counter(
            "dl4j_tpu_data_prefetch_batches_total",
            "Batches produced by the prefetch thread", ("instance",)).labels(inst)
        self._c_blocked = reg.counter(
            "dl4j_tpu_data_producer_blocked_seconds_total",
            "Time the prefetch thread waited on a full queue "
            "(compute-bound — the healthy direction)", ("instance",)).labels(inst)
        self._c_starved = reg.counter(
            "dl4j_tpu_data_consumer_starvation_seconds_total",
            "Time the consumer waited on an empty queue "
            "(input-bound — the I/O bottleneck signal)", ("instance",)).labels(inst)
        # prefetch-starvation open item (ROADMAP): depth means nothing
        # without capacity, and the StepProfiler's data-wait story needs
        # the per-dequeue wait distribution, not just its total
        self._g_capacity = reg.gauge(
            "dl4j_tpu_data_prefetch_queue_capacity",
            "Prefetch queue capacity (bounded queue size)",
            ("instance",)).labels(inst)
        self._g_capacity.set(queue_size)
        self._h_wait = reg.histogram(
            "dl4j_tpu_data_fetch_wait_seconds",
            "Consumer-visible wait per dequeue (0 when a batch was "
            "already prefetched)", ("instance",)).labels(inst)

    def _make_ring(self) -> Optional[threading.Semaphore]:
        if self.device_buffers is None or self.device_put_fn is None:
            return None
        return threading.Semaphore(self.device_buffers)

    def _acquire_slot(self, stop: threading.Event) -> bool:
        """Take a device-ring slot; gives up when ``stop`` is set so an
        abandoned consumer never parks the thread on a full ring."""
        sem = self._dev_slots
        while not stop.is_set():
            if sem.acquire(timeout=0.05):
                return True
        return False

    def _put(self, item, stop: threading.Event) -> bool:
        """Bounded put that gives up when ``stop`` is set (an abandoned
        consumer never drains the queue, so a plain put() would park the
        thread forever). Returns False when aborted."""
        q = self._queue
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            pass
        t0 = time.perf_counter()
        try:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False
        finally:
            self._c_blocked.inc(time.perf_counter() - t0)

    def _worker(self, stop: threading.Event) -> None:
        try:
            while not stop.is_set() and self.underlying.has_next():
                item = self.underlying.next()
                if self.device_put_fn is not None:
                    if (self._dev_slots is not None
                            and not self._acquire_slot(stop)):
                        return
                    # async dispatch: the H2D copy starts NOW, on this
                    # thread, and overlaps the consumer's compute
                    item = self.device_put_fn(item)
                if not self._put(item, stop):
                    return
                self._c_batches.inc()
                depth = self._queue.qsize()
                self._g_depth.set(depth)
                self._g_hwm.set_max(depth)
        except BaseException as e:  # propagate to consumer
            self._error = e
        finally:
            self._put(self._SENTINEL, stop)

    def _ensure_started(self) -> None:
        if not self._started:
            self._thread = threading.Thread(
                target=self._worker, args=(self._stop,),
                name=f"dsi-{self.name}", daemon=True)
            self._thread.start()
            self._started = True
            self._advance()

    def _advance(self) -> None:
        q = self._queue
        try:
            item = q.get_nowait()
            self._hits += 1
            self._h_wait.observe(0.0)
        except queue.Empty:
            t0 = time.perf_counter()
            item = q.get()
            waited = time.perf_counter() - t0
            self._c_starved.inc(waited)
            self._h_wait.observe(waited)
        self._g_depth.set(q.qsize())
        if item is not self._SENTINEL and self._dev_slots is not None:
            self._dev_slots.release()  # consumer owns the batch now
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            self._next_item = None
        else:
            self._next_item = item

    def has_next(self) -> bool:
        self._ensure_started()
        return self._next_item is not None

    def next(self) -> DataSet:
        self._ensure_started()
        if self._next_item is None:
            raise StopIteration
        item = self._next_item
        self._advance()
        self._consumed += 1
        if isinstance(item, DataSet):
            item.wait_ready()
        return item

    def close(self, timeout: float = 5.0) -> None:
        """Stop and join the prefetch thread WITHOUT consuming the rest of
        the epoch. Safe to call any time, idempotent, and safe to call
        CONCURRENTLY — including while the producer is parked on a full
        queue or a full device ring (both park-points poll ``_stop``).
        The old behavior (drain-to-exhaustion on reset) both leaked the
        thread behind a full queue and forced the whole underlying epoch
        to be produced."""
        self._stop.set()
        with self._close_lock:
            t = self._thread
            if t is not None:
                deadline = time.monotonic() + timeout
                while t.is_alive() and time.monotonic() < deadline:
                    try:
                        self._queue.get_nowait()  # unblock a parked put
                    except queue.Empty:
                        pass
                    t.join(timeout=0.05)
            self._thread = None
            self._started = False
            self._next_item = None
            self._g_depth.set(0)

    def reset(self) -> None:
        self.close()
        with self._close_lock:
            self.underlying.reset()
            self._reinit_pipeline()

    def _reinit_pipeline(self) -> None:
        self._queue = queue.Queue(maxsize=self.queue_size)
        self._stop = threading.Event()
        self._error = None
        self._started = False
        self._next_item = None
        self._consumed = 0
        self._dev_slots = self._make_ring()

    def state_dict(self) -> dict:
        """Consumer-position snapshot: the underlying iterator's epoch
        identity with ``batches`` overridden by the batches actually
        HANDED OUT — the prefetch thread's run-ahead (queued batches and
        the lookahead item) is deliberately not counted, so a resume
        re-produces exactly the batches the consumer never saw. Requires
        an underlying whose epoch only advances via ``reset()`` (the
        whole iterator family here; do not stack the async wrapper ON
        TOP of :class:`MultipleEpochsIterator` if you need resume)."""
        st = dict(self.underlying.state_dict())
        st["batches"] = self._consumed
        return st

    def load_state_dict(self, state: dict) -> None:
        self.close()
        with self._close_lock:
            self.underlying.load_state_dict(state)
            self._reinit_pipeline()
            self._consumed = int(state["batches"])

    def stats(self) -> dict:
        """Per-instance view over the registry children (one source of
        truth; see README "Observability"). All derived ratios are
        guarded against the zero-fetch case (stats() before any next())."""
        waits = int(self._h_wait.count)
        return {
            "queue_depth": self._queue.qsize(),
            "queue_capacity": self.queue_size,
            "queue_high_water": int(self._g_hwm.value),
            "device_buffers": self.device_buffers,
            "batches": int(self._c_batches.value),
            "producer_blocked_s": float(self._c_blocked.value),
            "consumer_starvation_s": float(self._c_starved.value),
            "fetches": waits,
            "mean_fetch_wait_s": (float(self._h_wait.sum) / waits
                                  if waits > 0 else 0.0),
            # share of dequeues served without blocking: 1.0 means the
            # prefetcher fully hid the input pipeline
            "prefetch_hit_rate": (self._hits / waits if waits > 0 else None),
        }

    def batch_size(self) -> int:
        return self.underlying.batch_size()


_copy_streams: dict = {}
_copy_streams_lock = threading.Lock()


def _copy_stream(device: torch.device):
    """The side stream that carries the prefetch copies to ``device`` (one
    per device, shared by every prefetch thread; ``cuda`` names the current
    device)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _copy_streams_lock:
        st = _copy_streams.get(device)
        if st is None:
            st = _copy_streams[device] = torch.cuda.Stream(device)
        return st


def device_put_dataset(ds: DataSet, device=None) -> DataSet:
    """Standard ``device_put_fn`` for :class:`AsyncDataSetIterator`: moves
    features, labels and masks to ``device`` (default: the current CUDA
    device; pass ``"cpu"`` to get CPU tensors) on the calling thread, which
    is the prefetch thread when the async iterator calls it.

    To the card, each array is staged in pinned host memory and copied with
    ``non_blocking=True`` on a dedicated copy stream, so the copy of batch
    N+1 overlaps the step on batch N. The returned batch carries the CUDA
    event recorded after its copies (``ds.ready``); the consumer waits on it
    with :meth:`DataSet.wait_ready` before reading the batch, which also
    records the consumer's stream on each tensor so the caching allocator
    does not hand their memory to another allocation while the consumer's
    work is still queued. (The pinned staging buffers are safe to drop at
    once: the pinned allocator keeps each one until its copy has ended.)"""
    device = default_device(device)
    if device.type != "cuda":
        return ds.to(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = _copy_stream(device)
    # no wait on another stream: the sources are host memory, and waiting on
    # the device's default stream would queue the copy behind the step it
    # should overlap
    with torch.cuda.stream(stream):
        out = []
        for a in ds.arrays():
            if a is None:
                out.append(None)
                continue
            host = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            if host.device.type == "cpu" and not host.is_pinned():
                host = host.pin_memory()
            out.append(host.to(device, non_blocking=True))
        ready = torch.cuda.Event()
        ready.record(stream)
    res = DataSet(*out)
    res.ready = ready
    return res


class MultipleEpochsIterator(DataSetIterator):
    """Repeats an iterator for N epochs (reference: MultipleEpochsIterator)."""

    def __init__(self, underlying: DataSetIterator, epochs: int) -> None:
        self.underlying = underlying
        self.epochs = epochs
        self._epoch = 0

    def reset(self) -> None:
        self.underlying.reset()
        self._epoch = 0

    def has_next(self) -> bool:
        if self.underlying.has_next():
            return True
        if self._epoch + 1 < self.epochs:
            self._epoch += 1
            self.underlying.reset()
            return self.underlying.has_next()
        return False

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.underlying.next()

    def batch_size(self) -> int:
        return self.underlying.batch_size()

    def state_dict(self) -> dict:
        st = dict(self.underlying.state_dict())
        st["multi_epoch"] = self._epoch
        return st

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state.get("multi_epoch", 0))
        self.underlying.load_state_dict(state)


class MappedDataSetIterator(DataSetIterator):
    """Applies ``feature_fn`` (and optionally ``label_fn``) to each batch —
    the composition point for ON-DEVICE preprocessing: pass a function of
    torch tensors (cast/normalize/augment) and wrap an AsyncDataSetIterator
    whose device_put already landed the raw (e.g. uint8) batch on the card.
    The augment work queues on the consumer's stream ahead of the train
    step, so the host stays on the cheap byte path end to end."""

    def __init__(self, underlying: DataSetIterator, feature_fn,
                 label_fn=None) -> None:
        self.underlying = underlying
        self.feature_fn = feature_fn
        self.label_fn = label_fn

    def has_next(self) -> bool:
        return self.underlying.has_next()

    def next(self) -> DataSet:
        ds = self.underlying.next()
        return DataSet(
            self.feature_fn(ds.features),
            ds.labels if self.label_fn is None else self.label_fn(ds.labels),
            ds.features_mask, ds.labels_mask,
        )

    def reset(self) -> None:
        self.underlying.reset()

    def batch_size(self) -> int:
        return self.underlying.batch_size()

    def state_dict(self) -> dict:
        return self.underlying.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.underlying.load_state_dict(state)
