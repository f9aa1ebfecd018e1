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

from typing import Optional, Tuple

import torch

from ..nn.sequential import grads_of
from .solver import LayerOptimizers, _normalize_gradients


class GraphSolver:
    def __init__(self, model, *, optimize=None, profiler=None) -> None:
        """``optimize=`` (training-safe graph rewrites) and ``profiler=``
        (step-phase attribution) need modules that are not ported yet and
        raise."""
        if optimize:
            raise NotImplementedError("GraphSolver(optimize=) needs nn/rewrite, which is "
                                      "not ported yet")
        if profiler is not None:
            raise NotImplementedError("GraphSolver(profiler=) needs obs/step_profiler.py, "
                                      "which is not ported yet")
        self.model = model
        model.migrate_state()
        self.optim = LayerOptimizers(model)
        self.opt_state = self.optim.init(model.params)

    def fit_batch(self, xs: Tuple, ys: Tuple, masks: Optional[Tuple] = None,
                  label_masks: Optional[Tuple] = None) -> torch.Tensor:
        """One training step over a tuple of inputs and a tuple of labels
        (and, optionally, per-input masks and per-output label masks).
        Returns the score as a 0-dim tensor on the model's device."""
        model = self.model
        xs = model._as_inputs(model._as_tuple(xs))
        ys = model._as_labels(model._as_tuple(ys))
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
        # the state keeps values only: an MoE layer's aux term carries this
        # step's graph, which must not stay alive until the next step
        model.state = {l: {k: v.detach() for k, v in st.items()}
                       for l, st in new_state.items()}
        model.last_batch_size = int(xs[0].shape[0])
        if model.listeners.requires_arrays:
            model.listeners.gradient_calculation(model, grads)
        return score.detach()

    def fit_iterator(self, iterator, *, epochs: int = 1) -> float:
        raise NotImplementedError("fit_iterator needs data/* (MultiDataSetIterator), "
                                  "which is not ported yet")

    def fit(self, data, labels=None, *, epochs: int = 1) -> None:
        """Train on ``(features, labels)`` tuples, or an iterable of
        ``(features, labels)`` pairs, for ``epochs`` passes."""
        model = self.model
        # Without listeners the per-iteration score stays a device scalar:
        # fetching it would wait for the device every step.
        sync_every_iter = bool(model.listeners.listeners)
        if labels is not None:
            batches = [(data, labels)]
        else:
            batches = [(item[0], item[1]) for item in data]
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
