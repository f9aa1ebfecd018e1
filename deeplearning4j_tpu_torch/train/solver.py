"""Solver — the training-step machinery (port of
``deeplearning4j_tpu/train/solver.py``).

Reference: org.deeplearning4j.optimize.{Solver, solvers.StochasticGradientDescent},
MultiLayerUpdater/UpdaterBlock, gradient normalization.

One step is forward, ``loss_pure``, ``torch.autograd.grad``, gradient
normalization, the per-layer update and the state write-back, as the JAX
package's jitted step is. PyTorch runs eagerly, so there is no compiled
step to cache and no buffer to donate: parameters and updater moments are
updated in place under ``torch.no_grad()``, and the JAX package's
``lax.scan`` fast path (:meth:`Solver.fit_scan`) is the same Python loop as
:meth:`Solver.fit`.

Per-layer updater overrides (reference: UpdaterBlock boundaries) are
honored: each layer gets its own transformation chain; frozen layers get
``set_to_zero``. Decoupled weight decay applies to weight params only.

Dropout draws from a CPU ``torch.Generator`` that the model seeds from the
config's seed and advances once per step (one fresh generator per step).
It cannot give the JAX package's threefry bits: dropout masks differ
between the packages, and only their distribution is comparable.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.dtypes import as_input
from ..nn.conf import BackpropType, GradientNormalization
from ..nn.sequential import _as_batches, grads_of
from .updaters import (
    GradientTransformation,
    Sgd,
    add_decayed_weights,
    apply_updates,
    chain,
    set_to_zero,
    updater_from_any,
)

Grads = Dict[str, Dict[str, torch.Tensor]]


def _sq_norm(gs) -> torch.Tensor:
    return sum(torch.sum(torch.square(g)) for g in gs)


def _normalize_gradients(grads: Grads, mode: GradientNormalization,
                         threshold: float) -> Grads:
    """Reference: GradientNormalization applied before the updater."""
    eps = 1e-8
    if mode is GradientNormalization.NONE:
        return grads
    if mode is GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        out = {}
        for lname, lg in grads.items():
            norm = torch.sqrt(_sq_norm(lg.values()) + eps) if lg else None
            out[lname] = {k: g / norm for k, g in lg.items()}
        return out
    if mode is GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return {l: {k: g / (torch.linalg.vector_norm(g) + eps) for k, g in lg.items()}
                for l, lg in grads.items()}
    if mode is GradientNormalization.CLIP_ELEMENT_WISE_ABSOLUTE_VALUE:
        return {l: {k: torch.clamp(g, -threshold, threshold) for k, g in lg.items()}
                for l, lg in grads.items()}
    if mode is GradientNormalization.CLIP_L2_PER_LAYER:
        out = {}
        for lname, lg in grads.items():
            if not lg:  # a layer without params
                out[lname] = {}
                continue
            norm = torch.sqrt(_sq_norm(lg.values()) + eps)
            scale = torch.clamp_max(threshold / norm, 1.0)
            out[lname] = {k: g * scale for k, g in lg.items()}
        return out
    if mode is GradientNormalization.CLIP_L2_PER_PARAM_TYPE:
        def clip(g):
            norm = torch.linalg.vector_norm(g) + eps
            return g * torch.clamp_max(threshold / norm, 1.0)

        return {l: {k: clip(g) for k, g in lg.items()} for l, lg in grads.items()}
    raise ValueError(f"Unhandled normalization {mode}")


class LayerOptimizers:
    """Per-layer transformation chains (reference: UpdaterBlock boundaries)."""

    def __init__(self, model) -> None:
        conf = model.conf
        self.txs: Dict[str, GradientTransformation] = {}
        self.updaters: Dict[str, Any] = {}  # the updater config of each non-frozen layer
        global_updater = updater_from_any(conf.updater) if conf.updater is not None else Sgd()
        for name, layer in model.named_param_layers():
            if layer.frozen:
                self.txs[name] = set_to_zero()
                continue
            updater = (updater_from_any(layer.updater) if layer.updater is not None
                       else global_updater)
            self.updaters[name] = updater
            parts = []
            wd = layer.weight_decay
            if wd:
                weight_names = set(layer.weight_param_names())
                parts.append(add_decayed_weights(
                    wd, {k: (k in weight_names) for k in layer.trainable_param_names()}))
            parts.append(updater.to_transform())
            self.txs[name] = chain(*parts) if len(parts) > 1 else parts[0]

    def init(self, params) -> Dict[str, Any]:
        return {name: tx.init(params[name]) for name, tx in self.txs.items()}

    def update(self, grads: Grads, opt_state, params) -> Dict[str, Any]:
        """Apply one step to ``params`` in place; returns the new state. The
        caller holds ``torch.no_grad()``."""
        new_opt = {}
        for name, p in params.items():
            if name in self.txs:
                updates, new_opt[name] = self.txs[name].update(grads[name], opt_state[name], p)
                apply_updates(p, updates)
        return new_opt


class Solver:
    def __init__(self, model, *, optimize=None, profiler=None) -> None:
        """``optimize=`` (training-safe graph rewrites) and ``profiler=``
        (step-phase attribution) need modules that are not ported yet and
        raise."""
        if optimize:
            raise NotImplementedError("Solver(optimize=) needs nn/rewrite, which is "
                                      "not ported yet")
        if profiler is not None:
            raise NotImplementedError("Solver(profiler=) needs obs/step_profiler.py, "
                                      "which is not ported yet")
        self.model = model
        self.optim = LayerOptimizers(model)
        self.opt_state = self.optim.init(model.params)

    def fit_batch(self, x, y, mask=None, label_mask=None,
                  rnn_state=None) -> Tuple[torch.Tensor, Optional[dict]]:
        """One training step. Returns ``(score, None)``: the score is a 0-dim
        tensor on the model's device, read only when the caller asks."""
        if rnn_state is not None:
            raise NotImplementedError("stateful (TBPTT) steps need nn/layers/recurrent.py, "
                                      "which is not ported yet")
        model = self.model
        x = model._input(x)
        y = as_input(y, model.dtype, True, model.device)
        score, (new_state, _) = model.loss_pure(
            model.params, model.state, x, y, rng=model._next_generator(),
            mask=model._mask(mask), label_mask=model._mask(label_mask), train=True)
        grads = grads_of(score, model.params)
        score = score.detach()
        conf = model.conf
        grads = _normalize_gradients(grads, conf.gradient_normalization,
                                     conf.gradient_normalization_threshold)
        with torch.no_grad():
            self.opt_state = self.optim.update(grads, self.opt_state, model.params)
        # the state keeps values only: an MoE layer's aux term carries this
        # step's graph, which must not stay alive until the next step
        model.state = {l: {k: v.detach() for k, v in st.items()}
                       for l, st in new_state.items()}
        model.last_batch_size = int(x.shape[0])
        if model.listeners.requires_arrays:
            model.listeners.gradient_calculation(model, grads)
        return score, None

    def fit_scan(self, features, labels) -> torch.Tensor:
        """Multi-step training over a stack of batches ([n_batches, batch,
        ...]). The JAX package compiles this into one ``lax.scan``; here it is
        the same loop as :meth:`fit` with no listeners. Returns the last
        score."""
        model = self.model
        score = None
        for xb, yb in zip(features, labels):
            score, _ = self.fit_batch(xb, yb)
        model.iteration_count += len(features)
        model.last_batch_size = int(np.shape(features)[1])
        return score

    def fit_iterator(self, iterator, *, epochs: int = 1) -> float:
        raise NotImplementedError("fit_iterator needs data/* (DataSetIterator), "
                                  "which is not ported yet")

    def fit(self, data, labels=None, *, epochs: int = 1, mask=None, label_mask=None) -> None:
        model = self.model
        # Without listeners the per-iteration score stays a device scalar:
        # fetching it would wait for the device every step.
        sync_every_iter = bool(model.listeners.listeners)
        last_score = None
        for _ in range(epochs):
            model.listeners.epoch_start(model)
            for feats, labs, msk, lmsk in _as_batches(data, labels, mask):
                if label_mask is not None:
                    lmsk = label_mask
                if (model.conf.backprop_type is BackpropType.TRUNCATED_BPTT
                        and getattr(feats, "ndim", 0) == 3
                        and feats.shape[2] > model.conf.tbptt_fwd_length):
                    raise NotImplementedError("truncated BPTT needs "
                                              "nn/layers/recurrent.py, which is not "
                                              "ported yet")
                score, _ = self.fit_batch(feats, labs, msk, lmsk)
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
