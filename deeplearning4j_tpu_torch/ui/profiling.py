"""Profiling + numerics tripwires (port of ``deeplearning4j_tpu/ui/profiling.py``).

Reference (SURVEY.md §5.1): SameDiff ProfilingListener writes Chrome
trace-event JSON; OpProfiler/PerformanceTracker time per-op work;
ProfilerConfig checkForNAN/INF ("NaN panic") throws on the first bad
value. Here: iteration-phase trace events (host view), ``torch.profiler``
traces (device view, perfetto), a dispatch mode that checks every op's
output for NaN, plus a listener-level score tripwire.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.listeners import TrainingListener


class ProfilingListener(TrainingListener):
    """Emits Chrome trace-event JSON (load in chrome://tracing or
    ui.perfetto.dev). Each iteration is a complete event on the training
    track; epochs are nested spans."""

    def __init__(self, path: str, flush_every: int = 50) -> None:
        self.path = path
        self.flush_every = max(1, flush_every)
        self._events: List[dict] = []
        self._iter_start: Optional[float] = None
        self._epoch_start: Optional[float] = None
        self._epoch = 0
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def on_epoch_start(self, model: Any) -> None:
        now = self._now_us()
        self._epoch_start = now
        # iteration 1's span starts here (it includes the first call's
        # set-up: kernel builds, allocator growth — a fabricated 1us
        # duration would hide it) and inter-epoch time is not charged to the
        # next iteration
        self._iter_start = now

    def on_epoch_end(self, model: Any) -> None:
        if self._epoch_start is not None:
            self._events.append({
                "name": f"epoch {self._epoch}", "ph": "X", "pid": 0,
                "tid": 0, "ts": self._epoch_start,
                "dur": self._now_us() - self._epoch_start,
                "cat": "epoch",
            })
        self._epoch += 1
        self.flush()

    def iteration_done(self, model: Any, iteration: int, epoch: int,
                       score: float) -> None:
        now = self._now_us()
        start = self._iter_start if self._iter_start is not None else now
        self._events.append({
            "name": "iteration", "ph": "X", "pid": 0, "tid": 1,
            "ts": start, "dur": max(now - start, 1.0), "cat": "train",
            "args": {"iteration": iteration, "epoch": epoch,
                     "score": float(score)},
        })
        self._iter_start = now
        # periodic flush: a run that dies mid-epoch still leaves a trace
        if len(self._events) % self.flush_every == 0:
            self.flush()

    def flush(self) -> None:
        with open(self.path, "w") as f:
            json.dump({"traceEvents": self._events,
                       "displayTimeUnit": "ms"}, f)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Device-level profiling via ``torch.profiler`` (the CUDA activity
    when a card is present): on exit writes the Chrome trace
    ``<log_dir>/trace.json`` (perfetto readable) — the deep view the
    host-side listener can't see."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _NanCheckMode(TorchDispatchMode):
    """Runs every op, then raises ``FloatingPointError`` if a floating
    output holds a NaN. Autograd's backward ops dispatch through it too."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"invalid value (nan) encountered in {func}")
        return out


_nan_mode: Optional[_NanCheckMode] = None


def enable_debug_nans(enable: bool = True) -> None:
    """Global NaN panic (reference: ProfilerConfig.checkForNAN): raises
    ``FloatingPointError`` at the op that produced the first NaN, in the
    forward or the backward. Each op's outputs are checked on the host, a
    device sync per op: debugging only."""
    global _nan_mode
    if enable and _nan_mode is None:
        _nan_mode = _NanCheckMode()
        _nan_mode.__enter__()
    elif not enable and _nan_mode is not None:
        mode, _nan_mode = _nan_mode, None
        mode.__exit__(None, None, None)


class NanPanicListener(TrainingListener):
    """Listener-level tripwire: raises the moment the training score goes
    non-finite, with context (reference: the executioner's checkForNAN at
    the op level; this is the cheap always-on variant)."""

    def iteration_done(self, model: Any, iteration: int, epoch: int,
                       score: float) -> None:
        import math

        if not math.isfinite(score):
            raise FloatingPointError(
                f"NaN panic: non-finite score {score} at iteration "
                f"{iteration} (epoch {epoch}). Enable "
                f"ui.enable_debug_nans() to locate the producing op.")
