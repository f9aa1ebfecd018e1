#!/usr/bin/env python
"""Input-pipeline contract of the port: the counterpart of the JAX
package's ``tools/check_input_pipeline_contract.py``, with its gates in its
order and its threshold (``DATA_WAIT_SHARE_MAX``).

Asserts the lifecycle + overlap contract of the prefetch tier:

  * THREAD HYGIENE: ``AsyncDataSetIterator.close()``/``reset()`` stop
    and join the prefetch thread: no ``dsi-*`` thread survives, even
    when the producer is parked on a full queue or a full device ring,
    when close() races close() from several threads, or when close()
    runs concurrently with a producer that is mid-``put``.
  * STARVATION GAUGE: when the consumer outruns the producer, the
    ``consumer_starvation_s`` counter and the per-dequeue fetch-wait
    histogram both fire, and ``stats()`` derived ratios are safe at zero
    fetches.
  * DOUBLE-BUFFER OVERLAP: with a fast producer and the device ring
    (``device_put_dataset`` at enqueue + ``device_buffers``), the
    ``StepProfiler`` ``data_wait`` share of a synthetic train loop stays
    below a threshold: the prefetcher hides the input pipeline. On the card
    each batch is staged in pinned memory and copied on the copy stream
    while the previous step runs.

Run ``python -m deeplearning4j_tpu_torch.tools.check_input_pipeline_contract
[--device cpu] [--model tiny|lm]``: on the card unless ``--device`` says
otherwise; ``tiny`` runs the JAX harness's batches ([4, 4] and [8, 512]
float32), ``lm`` batches at the shape of ``chip_smoke.py``'s "ResNet-50 from
files" phase, [128, 3, 224, 224] uint8 (19.3 MB each), through
``device_put_dataset`` with ``device_buffers=2``; the step chains 64
``tanh(h @ w)`` over the batch's last axis either way. It prints each gate
as it passes and exits non-zero on the first that fails.
"""

from __future__ import annotations

import functools
import sys
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.tools.contract_common import cli

DATA_WAIT_SHARE_MAX = 0.25
# the batch of chip_smoke.py's "ResNet-50 from files" phase: 128 images of
# 224 x 224 x 3 bytes
LM_BATCH = (128, 3, 224, 224)


def _dsi_threads():
    return [t for t in threading.enumerate() if t.name.startswith("dsi-")]


class _SlowIterator:
    """DataSetIterator producing one batch (``shape`` features of
    ``dtype``, [batch, 2] float32 labels) with a per-batch delay."""

    def __init__(self, n_batches: int, delay_s: float = 0.0,
                 shape=(4, 4), dtype=np.float32) -> None:
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        self.n_batches = n_batches
        self.delay_s = delay_s
        self.batch = shape[0]
        self._i = 0
        self._ds = DataSet(np.ones(shape, dtype), np.ones((shape[0], 2), np.float32))

    def has_next(self) -> bool:
        return self._i < self.n_batches

    def next(self):
        if self.delay_s:
            time.sleep(self.delay_s)
        self._i += 1
        return self._ds

    def reset(self) -> None:
        self._i = 0

    def batch_size(self) -> int:
        return self.batch


def check_thread_hygiene(log, put, small) -> None:
    from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator
    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    assert not _dsi_threads(), "pre-existing dsi thread"

    # close() with the producer parked on a FULL queue
    it = AsyncDataSetIterator(_SlowIterator(1000, **small), queue_size=1, registry=reg)
    assert it.has_next() and it.next() is not None
    time.sleep(0.05)  # let the producer park on the full queue
    it.close()
    assert not _dsi_threads(), "thread leaked after close() on full queue"
    it.close()  # idempotent
    assert not _dsi_threads()

    # reset() joins too, and the iterator is reusable afterwards
    it = AsyncDataSetIterator(_SlowIterator(1000, **small), queue_size=1, registry=reg)
    it.next()
    it.reset()
    assert not _dsi_threads(), "thread leaked after reset()"
    assert it.has_next() and it.next() is not None  # restartable
    it.close()
    assert not _dsi_threads()

    # close() racing close() from several threads while the producer is
    # parked on a full DEVICE RING
    it = AsyncDataSetIterator(
        _SlowIterator(1000, **small), queue_size=4,
        device_put_fn=put, device_buffers=1, registry=reg)
    it.next()
    time.sleep(0.05)  # producer parks on the ring slot
    errs = []

    def closer():
        try:
            it.close()
        except BaseException as e:  # pragma: no cover - the failure mode
            errs.append(e)

    threads = [threading.Thread(target=closer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not errs, f"concurrent close() raised: {errs}"
    assert not _dsi_threads(), "thread leaked after concurrent close()"
    log("thread hygiene: close/reset join the producer in every race")


def check_starvation_gauge(log, small) -> None:
    from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator
    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    it = AsyncDataSetIterator(
        _SlowIterator(6, delay_s=0.03, **small), queue_size=2, registry=reg)

    # zero-fetch guard: stats() before any next() must not divide by zero
    s0 = it.stats()
    assert s0["fetches"] == 0
    assert s0["mean_fetch_wait_s"] == 0.0
    assert s0["prefetch_hit_rate"] is None

    n = 0
    while it.has_next():
        it.next()
        n += 1
    assert n == 6
    s = it.stats()
    assert s["consumer_starvation_s"] > 0.0, (
        f"consumer outran a 30ms/batch producer but starvation gauge "
        f"stayed zero: {s}")
    assert s["fetches"] > 0 and s["mean_fetch_wait_s"] > 0.0, s
    it.close()
    log(f"starvation gauge fires: {s['consumer_starvation_s']*1e3:.1f}ms "
        f"starved over {s['fetches']} fetches, "
        f"hit rate {s['prefetch_hit_rate']}")


def check_double_buffer_overlap(log, put, device, big) -> None:
    import torch

    from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator
    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.obs.step_profiler import StepProfiler

    # fast producer + device ring: the double buffer must keep the
    # consumer's data_wait share of the step negligible. The step does
    # real work (chained matmuls) so the share compares against a
    # realistic compute phase, not dispatch overhead.
    base = _SlowIterator(24, delay_s=0.0, **big)
    it = AsyncDataSetIterator(
        base, queue_size=4, device_put_fn=put,
        device_buffers=2, registry=MetricsRegistry())
    width = big["shape"][-1]
    on_card = torch.device(device).type == "cuda"
    w = torch.eye(width, device=device) * 0.5

    def step(x, acc):
        h = x.to(torch.float32).reshape(-1, width)
        for _ in range(64):
            h = torch.tanh(h @ w)
        return acc + torch.sum(h)

    def fence_device():
        if on_card:
            torch.cuda.synchronize()

    prof = StepProfiler(sync_every=2, registry=MetricsRegistry())
    acc = torch.zeros((), device=device)
    # first-call work outside the profiled loop
    acc = step(torch.ones(big["shape"], device=device), acc)
    fence_device()
    t0 = time.perf_counter()
    n = 0
    while it.has_next():
        fence = prof.begin_step()
        with prof.phase("data_wait"):
            ds = it.next()
        with prof.phase("compute", sampled=fence):
            acc = step(ds.features, acc)
            if fence:
                fence_device()
        prof.end_step()
        n += 1
    fence_device()
    dt = time.perf_counter() - t0
    it.close()
    share = prof.stats()["share"]["data_wait"]
    assert share < DATA_WAIT_SHARE_MAX, (
        f"double-buffered fast producer should hide the input pipeline; "
        f"data_wait share {share} >= {DATA_WAIT_SHARE_MAX}: {prof.stats()}")
    log(f"double buffer: data_wait share {share:.4f} "
        f"< {DATA_WAIT_SHARE_MAX} on a fast-producer run")
    mb = np.prod(big["shape"]) * np.dtype(big["dtype"]).itemsize / 1e6
    log(f"  {n} batches of {list(big['shape'])} {np.dtype(big['dtype']).name} "
        f"({mb:.1f} MB) in {dt * 1e3:.1f} ms, {n * mb / dt / 1e3:.2f} GB/s through the ring")


def main(device: str = "cuda", model="tiny", log=print) -> int:
    from deeplearning4j_tpu_torch.data.iterators import device_put_dataset

    put = functools.partial(device_put_dataset, device=device)
    if model == "tiny":
        small = dict(shape=(4, 4), dtype=np.float32)
        big = dict(shape=(8, 512), dtype=np.float32)
    else:
        small = big = dict(shape=LM_BATCH, dtype=np.uint8)
    check_thread_hygiene(log, put, small)
    check_starvation_gauge(log, small)
    check_double_buffer_overlap(log, put, device, big)
    log("input-pipeline contract OK")
    return 0


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
