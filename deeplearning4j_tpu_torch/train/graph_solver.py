"""GraphSolver — training machinery for ComputationGraph (port of
``deeplearning4j_tpu/train/graph_solver.py``).

Reference: ComputationGraph.fit() shares the Solver machinery with
MultiLayerNetwork. Here the GraphSolver reuses the port's LayerOptimizers
and gradient normalization from ``solver.py``, over tuples of inputs and
labels (a MultiDataSet's shape). One step is the graph's ``loss_pure``,
``torch.autograd.grad``, gradient normalization, the per-vertex update in
place and the state write-back (batch norm's running statistics).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from ..data.dataset import DataSet, MultiDataSet
from ..nn.sequential import grads_of
from ..obs.step_profiler import fence
from .solver import LayerOptimizers, _normalize_gradients


class GraphSolver:
    def __init__(self, model, *, optimize=None, profiler=None) -> None:
        """``optimize=`` applies training-safe graph rewrite passes in place
        before the updater state is built (see :class:`Solver`;
        ``applied_rewrites`` names the passes that matched). ``profiler=``
        attaches a :class:`~deeplearning4j_tpu_torch.obs.step_profiler.
        StepProfiler`, as in :class:`Solver`."""
        self.model = model
        model.migrate_state()
        self.applied_rewrites = []
        if optimize:
            from ..nn.rewrite import rewrite_model_inplace

            self.applied_rewrites = rewrite_model_inplace(model, optimize, context="training")
        self.profiler = profiler
        self.optim = LayerOptimizers(model)
        self.opt_state = self.optim.init(model.params)

    def fit_batch(self, xs: Tuple, ys: Tuple, masks: Optional[Tuple] = None,
                  label_masks: Optional[Tuple] = None) -> torch.Tensor:
        """One training step over a tuple of inputs and a tuple of labels
        (and, optionally, per-input masks and per-output label masks).
        Returns the score as a 0-dim tensor on the model's device."""
        model = self.model
        # StepProfiler phases, as in Solver.fit_batch
        prof = self.profiler
        fenced = prof.begin_step() if prof is not None else False
        timed = prof is not None and (fenced or prof.sync_every == 0)
        t0 = time.perf_counter() if prof is not None else 0.0
        xs = model._as_inputs(model._as_tuple(xs))
        ys = model._as_labels(model._as_tuple(ys))
        if timed:
            if fenced:
                fence(model.device)
            prof.record("h2d", time.perf_counter() - t0, sampled=fenced)
            t0 = time.perf_counter()
        score, new_state = model.loss_pure(
            model.params, model.state, xs, ys, rng=model._next_generator(),
            masks=model._as_masks(masks), label_masks=model._as_masks(label_masks),
            train=True)
        grads = grads_of(score, model.params)
        conf = model.conf
        grads = _normalize_gradients(grads, conf.gradient_normalization,
                                     conf.gradient_normalization_threshold)
        with torch.no_grad():
            self.opt_state = self.optim.update(grads, self.opt_state, model.params)
        if timed:
            if fenced:
                fence(model.device)
            prof.record("compute", time.perf_counter() - t0, sampled=fenced)
        th = time.perf_counter() if prof is not None else 0.0
        # the state keeps values only: an MoE layer's aux term carries this
        # step's graph, which must not stay alive until the next step
        model.state = {l: {k: v.detach() for k, v in st.items()}
                       for l, st in new_state.items()}
        model.last_batch_size = int(xs[0].shape[0])
        if model.listeners.requires_arrays:
            model.listeners.gradient_calculation(model, grads)
        if prof is not None:
            prof.record("host", time.perf_counter() - th, sampled=fenced)
            prof.end_step()
        return score.detach()

    def fit_iterator(self, iterator, *, epochs: int = 1) -> float:
        """DataSet/MultiDataSet iterator training with exact mid-epoch
        resume semantics — see :meth:`Solver.fit_iterator`: consumption
        starts at the iterator's CURRENT position, reset() only when
        exhausted. Masks are not read (as in the JAX package)."""
        model = self.model
        sync = bool(model.listeners.listeners)
        last = None
        for _ in range(epochs):
            if not iterator.has_next():
                iterator.reset()
            model.listeners.epoch_start(model)
            while iterator.has_next():
                xs, ys = _multi_batch(iterator.next(), model._as_tuple)
                score = self.fit_batch(xs, ys)
                last = score
                model.iteration_count += 1
                if sync:
                    model.score_value = float(score)
                    model.listeners.iteration_done(
                        model, model.iteration_count, model.epoch_count, model.score_value)
            model.listeners.epoch_end(model)
            model.epoch_count += 1
        if last is not None:
            model.score_value = float(last)
        return model.score_value

    def fit(self, data, labels=None, *, epochs: int = 1) -> None:
        """Train on ``(features, labels)`` tuples, a DataSet or MultiDataSet,
        or an iterable of those or of ``(features, labels)`` pairs, for
        ``epochs`` passes over the batches, which are read once."""
        model = self.model
        # Without listeners the per-iteration score stays a device scalar:
        # fetching it would wait for the device every step.
        sync_every_iter = bool(model.listeners.listeners)
        as_tuple = model._as_tuple
        if labels is not None:
            batches = [(as_tuple(data), as_tuple(labels))]
        else:
            if isinstance(data, (DataSet, MultiDataSet)):
                data = [data]
            batches = [_multi_batch(item, as_tuple) for item in data]
        last_score = None
        for _ in range(epochs):
            model.listeners.epoch_start(model)
            for xs, ys in batches:
                score = self.fit_batch(xs, ys)
                last_score = score
                model.iteration_count += 1
                if sync_every_iter:
                    model.score_value = float(score)
                    model.listeners.iteration_done(
                        model, model.iteration_count, model.epoch_count, model.score_value)
            model.listeners.epoch_end(model)
            model.epoch_count += 1
        if last_score is not None:
            model.score_value = float(last_score)


def _multi_batch(item, as_tuple):
    """(inputs tuple, labels tuple) of a MultiDataSet, a DataSet or a
    (features, labels) pair; an asynchronously copied DataSet is waited for
    on the current stream first."""
    if isinstance(item, MultiDataSet):
        return tuple(item.features), tuple(item.labels)
    if isinstance(item, DataSet):
        item.wait_ready()
        return (item.features,), (item.labels,)
    return as_tuple(item[0]), as_tuple(item[1])
