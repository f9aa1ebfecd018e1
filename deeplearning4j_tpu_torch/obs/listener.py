"""MetricsListener — the training-loop → metrics-registry bridge (port of
``deeplearning4j_tpu/obs/listener.py``, same metric names).

Built on the :class:`~deeplearning4j_tpu_torch.core.listeners.TrainingListener`
SPI (the framework's one metrics bus), so it attaches to anything that
drives a ``ListenerBus``, such as ``MultiLayerNetwork.fit``.

It declares ``requires_score = False``: step latency and examples/sec need
no loss value, so attaching ONLY this listener must not force a per-step
device→host loss fetch. Loops that honor ``ListenerBus.requires_score``
pass NaN instead, and the score gauge simply skips NaN. The MoE routing
counters are read from the network's state tensors (copied to the host
once per step).
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..core.listeners import TrainingListener
from .metrics import MetricsRegistry, get_registry

# Training steps range from sub-ms (tiny CPU tests) to seconds (pod-scale
# BERT), so the default latency buckets fit; examples/sec is derived by
# the scraper as rate(examples_total)/rate(step_latency_count).
_STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class MetricsListener(TrainingListener):
    """Feeds ``dl4j_tpu_training_*`` series from iteration callbacks.

    Series: ``iterations_total``, ``examples_total`` (from the model's
    ``last_batch_size``), ``epochs_total``, ``step_latency_seconds``
    (wall time between consecutive ``iteration_done`` calls — the full
    step including data wait, which is the fleet-level signal), and a
    ``score`` gauge updated whenever a real (non-NaN) score arrives.
    """

    requires_score = False

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._iterations = reg.counter(
            "dl4j_tpu_training_iterations_total",
            "Completed training iterations (optimizer steps)")
        self._examples = reg.counter(
            "dl4j_tpu_training_examples_total",
            "Training examples consumed (rows across all iterations)")
        self._epochs = reg.counter(
            "dl4j_tpu_training_epochs_total", "Completed training epochs")
        self._step_latency = reg.histogram(
            "dl4j_tpu_training_step_latency_seconds",
            "Wall time between consecutive training iterations",
            buckets=_STEP_BUCKETS)
        self._score = reg.gauge(
            "dl4j_tpu_training_score", "Most recent training score (loss)")
        self._last_t: Optional[float] = None

    def on_epoch_start(self, model: Any) -> None:
        # epoch boundaries include eval/checkpoint time; don't let that
        # masquerade as one huge training step
        self._last_t = None

    def on_epoch_end(self, model: Any) -> None:
        self._epochs.inc()
        self._last_t = None

    def iteration_done(self, model: Any, iteration: int, epoch: int,
                       score: float) -> None:
        now = time.perf_counter()
        if self._last_t is not None:
            self._step_latency.observe(now - self._last_t)
        self._last_t = now
        self._iterations.inc()
        batch = getattr(model, "last_batch_size", None)
        if batch:
            self._examples.inc(batch)
        if score == score:  # skip NaN (loop ran with requires_score=False)
            self._score.set(float(score))


def _host(x) -> np.ndarray:
    """A state leaf as a float64 numpy array (torch tensors copied off the
    device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def record_moe_metrics(state: Optional[Mapping[str, Any]],
                       registry: Optional[MetricsRegistry] = None) -> int:
    """Feed MoE routing observability from a model ``state`` dict
    (``layer_name -> layer state``) into the registry.

    Every :class:`~deeplearning4j_tpu_torch.nn.layers.MixtureOfExpertsLayer`
    refreshes ``state["expert_tokens"]`` ([E] assignments kept per expert),
    ``state["dropped_tokens"]`` (capacity-overflow drops) and
    ``state["capacity_slots"]`` (total buffer slots E·C) per forward;
    this turns the latest per-batch values into

    * ``dl4j_tpu_moe_expert_tokens_total{layer=,expert=}`` (counter)
    * ``dl4j_tpu_moe_dropped_tokens_total{layer=}`` (counter)
    * ``dl4j_tpu_moe_capacity_slots{layer=}`` (gauge — alert when the
      kept-token total approaches it: capacity_factor is too tight)
    * ``dl4j_tpu_moe_drop_share{layer=}`` (gauge — dropped/(kept+dropped)
      for THIS batch; the capacity_factor tuning signal)
    * ``dl4j_tpu_moe_expert_load_cv{layer=}`` (gauge — std/mean of the
      per-expert kept counts; 0 = perfectly balanced router, rising CV
      means the aux loss is losing to expert collapse)

    Call once per completed step (that is what
    :class:`MoEMetricsListener` does). Returns the number of MoE layer
    states seen, so callers can assert wiring.
    """
    reg = registry if registry is not None else get_registry()
    tok = reg.counter(
        "dl4j_tpu_moe_expert_tokens_total",
        "MoE (token, slot) assignments kept per expert (post capacity "
        "drop)", ("layer", "expert"))
    drop = reg.counter(
        "dl4j_tpu_moe_dropped_tokens_total",
        "MoE (token, slot) assignments dropped by capacity overflow",
        ("layer",))
    slots = reg.gauge(
        "dl4j_tpu_moe_capacity_slots",
        "MoE expert-buffer slots (num_experts × capacity) per layer",
        ("layer",))
    share = reg.gauge(
        "dl4j_tpu_moe_drop_share",
        "Share of this batch's MoE assignments dropped by capacity "
        "overflow: dropped / (kept + dropped)", ("layer",))
    load_cv = reg.gauge(
        "dl4j_tpu_moe_expert_load_cv",
        "Coefficient of variation (std/mean) of per-expert kept token "
        "counts this batch — 0 is perfect balance", ("layer",))
    seen = 0
    for lname, lstate in (state or {}).items():
        if not isinstance(lstate, Mapping) or "expert_tokens" not in lstate:
            continue
        seen += 1
        counts = _host(lstate["expert_tokens"])
        for e_idx, c in enumerate(counts.tolist()):
            tok.labels(lname, str(e_idx)).inc(c)
        kept = float(counts.sum())
        mean = counts.mean() if counts.size else 0.0
        load_cv.labels(lname).set(
            float(counts.std() / mean) if mean > 0 else 0.0)
        if "capacity_slots" in lstate:
            slots.labels(lname).set(
                float(_host(lstate["capacity_slots"])))
        if "dropped_tokens" in lstate:
            dropped = float(_host(lstate["dropped_tokens"]))
            drop.labels(lname).inc(dropped)
            total = kept + dropped
            share.labels(lname).set(dropped / total if total > 0 else 0.0)
    return seen


class MoEMetricsListener(TrainingListener):
    """Per-iteration MoE routing telemetry: expert load + capacity drops.

    Reads ``model.state`` after each iteration and feeds
    :func:`record_moe_metrics`. ``MultiLayerNetwork`` training loops
    write the post-step state back onto the model every iteration, so
    the default works there directly. ``sync_arrays=True`` declares
    ``requires_arrays`` for loops that keep the live state elsewhere, as
    the JAX package's ``DistributedTrainer`` does.
    """

    requires_score = False

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 sync_arrays: bool = False) -> None:
        self.registry = registry if registry is not None else get_registry()
        self.requires_arrays = bool(sync_arrays)

    def iteration_done(self, model: Any, iteration: int, epoch: int,
                       score: float) -> None:
        record_moe_metrics(getattr(model, "state", None), self.registry)
