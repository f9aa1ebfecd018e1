"""StepProfiler — per-phase training step-time attribution (port of
``deeplearning4j_tpu/obs/step_profiler.py``).

A step's wall time splits into

* ``data_wait`` — time the training loop blocked waiting for the next
  batch (an ``AsyncDataSetIterator`` dequeue, file decode on a sync
  iterator, ...),
* ``h2d`` — host-to-device transfer of the batch,
* ``compute`` — the forward, backward and update on the device,
* ``host`` — host-side bookkeeping after the step (state write-back,
  listeners, score fetch).

CUDA runs asynchronously: timing the step measures the host's launches
while the card runs behind them, and fencing every step would serialize
the pipeline the profiler is meant to diagnose. So ``compute`` (and
``h2d``) are **fenced only every ``sync_every`` steps** with
``torch.cuda.synchronize(device)`` (:func:`fence`; nothing on the CPU,
which runs synchronously): sampled steps pay one synchronization and give a
true device-time measurement; the other steps run undisturbed and feed the
cheap phases only. The breakdown extrapolates the sampled mean across all
steps.

Metrics: phase latencies land in
``dl4j_tpu_training_step_phase_seconds{instance=,phase=}``; :meth:`stats`
is the per-instance view.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Optional

import torch

from .metrics import MetricsRegistry, get_registry

PHASES = ("data_wait", "h2d", "compute", "host")

# sub-ms tiny-model steps up to multi-second pod steps
_PHASE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_profiler_seq = itertools.count()


def fence(device: torch.device) -> None:
    """Wait for the work queued on ``device``: a sampled step's fence.
    Nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Phase:
    """Context manager timing one phase occurrence."""

    __slots__ = ("_prof", "_name", "_sampled", "_t0")

    def __init__(self, prof: "StepProfiler", name: str, sampled: bool) -> None:
        self._prof = prof
        self._name = name
        self._sampled = sampled
        self._t0 = 0.0

    def __enter__(self) -> "_Phase":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._prof.record(self._name, time.perf_counter() - self._t0,
                          sampled=self._sampled)


class StepProfiler:
    """Attributes training step wall time to ``data_wait`` / ``h2d`` /
    ``compute`` / ``host`` phases.

    Pass one to ``Solver(model, profiler=...)`` / ``GraphSolver`` and wrap
    the data source with :meth:`wrap_iterator`; every phase both feeds the
    metrics registry and accumulates into the :meth:`stats` breakdown.
    ``sync_every=N`` fences device work on every Nth step (N=0 never
    fences: device phases then measure the host's launches only, which is
    stated in ``stats()['fenced']``).
    """

    def __init__(self, *, sync_every: int = 10,
                 registry: Optional[MetricsRegistry] = None,
                 name: Optional[str] = None) -> None:
        if sync_every < 0:
            raise ValueError(f"sync_every must be >= 0, got {sync_every}")
        self.sync_every = int(sync_every)
        self.name = name or f"profiler-{next(_profiler_seq)}"
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        hist = reg.histogram(
            "dl4j_tpu_training_step_phase_seconds",
            "Training step time by phase (data_wait=input pipeline, "
            "h2d=host-to-device transfer, compute=device step [fenced on "
            "sampled steps only], host=post-dispatch bookkeeping)",
            ("instance", "phase"), buckets=_PHASE_BUCKETS)
        self._hist = {p: hist.labels(self.name, p) for p in PHASES}
        self._totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._counts: Dict[str, int] = {p: 0 for p in PHASES}
        # phases measured on fenced steps, tracked separately so the
        # extrapolation never mixes launch-only and fenced samples.
        # "host" is here too: on unfenced steps the device is still
        # executing in the background, and the bookkeeping's wall time
        # absorbs waits on it; only the post-fence samples are honest.
        self._sampled_totals = {"h2d": 0.0, "compute": 0.0, "host": 0.0}
        self._sampled_counts = {"h2d": 0, "compute": 0, "host": 0}
        self.steps = 0
        self.sampled_steps = 0
        self._step_open = False
        self._step_sampled = False

    # ---- step lifecycle ----------------------------------------------
    def begin_step(self) -> bool:
        """Start a step; returns True when this step should fence device
        work (:func:`fence`) so compute/h2d are real."""
        self._step_open = True
        self._step_sampled = (self.sync_every > 0
                              and self.steps % self.sync_every == 0)
        return self._step_sampled

    def end_step(self) -> None:
        if not self._step_open:
            return
        self._step_open = False
        self.steps += 1
        if self._step_sampled:
            self.sampled_steps += 1

    # ---- recording ----------------------------------------------------
    def phase(self, name: str, *, sampled: bool = False) -> _Phase:
        """``with profiler.phase("h2d"): ...`` — times the block into the
        phase. ``sampled=True`` marks a fenced device measurement."""
        if name not in self._totals:
            raise ValueError(f"unknown phase {name!r}; expected one of {PHASES}")
        return _Phase(self, name, sampled)

    def record(self, name: str, seconds: float, *, sampled: bool = False) -> None:
        self._totals[name] += seconds
        self._counts[name] += 1
        if sampled and name in self._sampled_totals:
            self._sampled_totals[name] += seconds
            self._sampled_counts[name] += 1
        self._hist[name].observe(seconds)

    def record_data_wait(self, seconds: float) -> None:
        self.record("data_wait", seconds)

    # ---- iterator instrumentation ------------------------------------
    def wrap_iterator(self, iterator):
        """Wrap a ``DataSetIterator`` (or any iterable) so the time the
        consumer blocks in ``next()`` is attributed to ``data_wait``."""
        return _ProfiledIterator(iterator, self)

    # ---- breakdown ----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Per-phase breakdown.

        ``per_step_ms`` uses fenced (sampled) means for the device phases
        and all-step means for the host phases; ``share`` normalizes those
        attributed per-step costs — the number that must *explain* an
        e2e/synthetic throughput ratio, not just restate totals.
        """
        steps = max(self.steps, 1)
        per_step_ms: Dict[str, float] = {}
        for p in PHASES:
            if p in self._sampled_totals and self._sampled_counts[p] > 0:
                mean = self._sampled_totals[p] / self._sampled_counts[p]
            else:
                mean = self._totals[p] / steps
            per_step_ms[p] = mean * 1e3
        total_ms = sum(per_step_ms.values())
        share = {p: (v / total_ms if total_ms > 0 else 0.0)
                 for p, v in per_step_ms.items()}
        # the step time were the input pipeline free (data already on the
        # device)
        excl_input_ms = per_step_ms["compute"] + per_step_ms["host"]
        return {
            "steps": self.steps,
            "sampled_steps": self.sampled_steps,
            "fenced": self.sync_every > 0,
            "seconds_total": {p: self._totals[p] for p in PHASES},
            "per_step_ms": {p: round(v, 4) for p, v in per_step_ms.items()},
            "share": {p: round(v, 4) for p, v in share.items()},
            "step_time_ms_est": round(total_ms, 4),
            "step_time_ms_excl_input": round(excl_input_ms, 4),
            "input_bound_share": round(
                share["data_wait"] + share["h2d"], 4),
        }

    def samples_per_sec_excl_input(self, batch_size: int) -> Optional[float]:
        """Projected throughput with the input pipeline (data_wait + h2d)
        taken out of the step. None until a step with nonzero compute/host
        time has been recorded."""
        excl_ms = self.stats()["step_time_ms_excl_input"]
        if excl_ms <= 0:
            return None
        return batch_size / (excl_ms / 1e3)


class _ProfiledIterator:
    """DataSetIterator/iterable proxy attributing ``next()`` wall time to
    the profiler's ``data_wait`` phase."""

    def __init__(self, underlying, profiler: StepProfiler) -> None:
        self.underlying = underlying
        self.profiler = profiler

    # DataSetIterator protocol --------------------------------------------
    def has_next(self) -> bool:
        return self.underlying.has_next()

    def next(self):
        t0 = time.perf_counter()
        try:
            return self.underlying.next()
        finally:
            self.profiler.record_data_wait(time.perf_counter() - t0)

    def reset(self) -> None:
        self.underlying.reset()

    def batch_size(self) -> int:
        return self.underlying.batch_size()

    def stats(self) -> dict:
        s = getattr(self.underlying, "stats", None)
        return s() if callable(s) else {}

    def close(self, *a, **kw) -> None:
        c = getattr(self.underlying, "close", None)
        if callable(c):
            c(*a, **kw)

    # plain-iterable protocol ---------------------------------------------
    def __iter__(self):
        self._it = iter(self.underlying)
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self._it)  # StopIteration is not a wait to attribute
        self.profiler.record_data_wait(time.perf_counter() - t0)
        return item
