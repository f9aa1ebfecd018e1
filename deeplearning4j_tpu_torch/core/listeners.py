"""Listener bus — the framework's metrics/observability spine (a copy of
``deeplearning4j_tpu/core/listeners.py``, which uses no framework).

Mirrors the reference's ``TrainingListener`` SPI (canonical:
org.deeplearning4j.optimize.api.TrainingListener) which is DL4J's single
metrics bus: ScoreIterationListener, PerformanceListener, EvaluativeListener,
CheckpointListener and StatsListener all hang off it.

Listeners are host-side: they observe per-iteration scalars after the
training step returns. Anything that would force a device sync (the score,
histograms over params) only materializes when a listener that needs it is
attached. A listener that needs a module the port has not ported yet raises
when it is used, not when it is imported.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence


class TrainingListener:
    """Base class; override any subset of hooks."""

    # model is the Sequential/Graph (or SameDiff equivalent) driving training.
    def on_epoch_start(self, model: Any) -> None: ...
    def on_epoch_end(self, model: Any) -> None: ...
    def on_forward_pass(self, model: Any, activations: Any) -> None: ...
    def on_gradient_calculation(self, model: Any, gradients: Any) -> None: ...
    def iteration_done(self, model: Any, iteration: int, epoch: int, score: float) -> None: ...

    # Whether this listener needs per-iteration access to params/grads pytrees
    # (forces them to be fetched; keep False for scalar-only listeners).
    requires_arrays: bool = False

    # Whether this listener needs the per-iteration score. Loops that keep
    # the loss on device (samediff TrainingSession, DistributedTrainer)
    # only pay the per-step device→host fetch when some attached listener
    # requires it; otherwise they pass NaN. MetricsListener (obs/) sets
    # this False — step latency and examples/sec need no loss value.
    requires_score: bool = True


class ListenerBus:
    def __init__(self, listeners: Optional[Sequence[TrainingListener]] = None) -> None:
        self.listeners: List[TrainingListener] = list(listeners or [])

    def add(self, listener: TrainingListener) -> None:
        self.listeners.append(listener)

    def remove(self, listener: TrainingListener) -> None:
        self.listeners.remove(listener)

    def clear(self) -> None:
        self.listeners.clear()

    @property
    def requires_arrays(self) -> bool:
        return any(l.requires_arrays for l in self.listeners)

    @property
    def requires_score(self) -> bool:
        return any(getattr(l, "requires_score", True) for l in self.listeners)

    def epoch_start(self, model: Any) -> None:
        for l in self.listeners:
            l.on_epoch_start(model)

    def epoch_end(self, model: Any) -> None:
        for l in self.listeners:
            l.on_epoch_end(model)

    def iteration_done(self, model: Any, iteration: int, epoch: int, score: float) -> None:
        for l in self.listeners:
            l.iteration_done(model, iteration, epoch, score)

    def gradient_calculation(self, model: Any, gradients: Any) -> None:
        for l in self.listeners:
            l.on_gradient_calculation(model, gradients)


class ScoreIterationListener(TrainingListener):
    """Logs the loss every N iterations (reference: ScoreIterationListener)."""

    def __init__(self, print_every: int = 10, log_fn=print) -> None:
        self.print_every = max(1, print_every)
        self.log_fn = log_fn

    def iteration_done(self, model: Any, iteration: int, epoch: int, score: float) -> None:
        if iteration % self.print_every == 0:
            self.log_fn(f"Score at iteration {iteration} is {score}")


class PerformanceListener(TrainingListener):
    """Samples/sec + batches/sec per iteration (reference: PerformanceListener)."""

    def __init__(self, frequency: int = 10, log_fn=print) -> None:
        self.frequency = max(1, frequency)
        self.log_fn = log_fn
        self._last_time: Optional[float] = None
        self._last_iter: Optional[int] = None
        self.history: List[Dict[str, float]] = []

    def iteration_done(self, model: Any, iteration: int, epoch: int, score: float) -> None:
        now = time.perf_counter()
        if self._last_time is not None and iteration > self._last_iter:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            batch = getattr(model, "last_batch_size", None)
            rec = {
                "iteration": iteration,
                "batches_per_sec": iters / dt if dt > 0 else float("inf"),
            }
            if batch:
                rec["samples_per_sec"] = iters * batch / dt if dt > 0 else float("inf")
            self.history.append(rec)
            if iteration % self.frequency == 0:
                msg = ", ".join(f"{k}={v:.2f}" for k, v in rec.items() if k != "iteration")
                self.log_fn(f"iteration {iteration}: {msg}, score={score:.5f}")
        self._last_time = now
        self._last_iter = iteration


class CollectScoresListener(TrainingListener):
    """Accumulates (iteration, score) pairs in memory (reference: CollectScoresIterationListener)."""

    def __init__(self) -> None:
        self.scores: List[float] = []
        self.iterations: List[int] = []

    def iteration_done(self, model: Any, iteration: int, epoch: int, score: float) -> None:
        self.iterations.append(iteration)
        self.scores.append(float(score))


class EvaluativeListener(TrainingListener):
    """Periodic evaluation during training (reference: EvaluativeListener):
    every N iterations (or each epoch end) runs the given evaluation over an
    iterator and logs/stores the result."""

    def __init__(self, iterator, frequency: int = 0, *,
                 evaluation_factory=None, log_fn=print) -> None:
        """frequency > 0: every N iterations; 0: each epoch end."""
        self.iterator = iterator
        self.frequency = int(frequency)
        self.evaluation_factory = evaluation_factory
        self.log_fn = log_fn
        self.history: List[Any] = []

    def _evaluate(self, model) -> None:
        from .dtypes import to_numpy

        if self.evaluation_factory is None and hasattr(model, "evaluate"):
            # single eval path: the model's own evaluate() loop (no second
            # implementation to drift from)
            ev = model.evaluate(self.iterator)
            self.history.append(ev)
            acc = getattr(ev, "accuracy", None)
            if callable(acc):
                self.log_fn(f"EvaluativeListener: accuracy={ev.accuracy():.4f}")
            return
        if self.evaluation_factory is None:
            from ..train.evaluation import Evaluation

            ev = Evaluation()  # self-sizes on first eval() call
        else:
            ev = self.evaluation_factory()
        saw_data = False
        for batch in self.iterator:
            feats = batch.features
            fmask = getattr(batch, "features_mask", None)
            lmask = getattr(batch, "labels_mask", None)
            if isinstance(feats, (list, tuple)):  # graph model, MultiDataSet
                out = model.output(*feats, masks=fmask)
                if isinstance(out, tuple):
                    out = out[0]
                labels = batch.labels[0]
                if lmask is not None:
                    lmask = lmask[0]
            else:
                out = model.output(feats, mask=fmask)
                labels = batch.labels
            ev.eval(to_numpy(labels), to_numpy(out), mask=to_numpy(lmask))
            saw_data = True
        if not saw_data:
            # exhausted one-shot iterable (plain generator): warn, don't
            # record a vacuous evaluation
            self.log_fn("EvaluativeListener: iterator yielded no batches — "
                        "pass a restartable iterator for repeated eval")
            return
        self.history.append(ev)
        acc = getattr(ev, "accuracy", None)
        if callable(acc):
            self.log_fn(f"EvaluativeListener: accuracy={ev.accuracy():.4f}")

    def iteration_done(self, model: Any, iteration: int, epoch: int, score: float) -> None:
        if self.frequency > 0 and iteration % self.frequency == 0:
            self._evaluate(model)

    def on_epoch_end(self, model: Any) -> None:
        if self.frequency <= 0:
            self._evaluate(model)
