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
:meth:`Solver.fit`. Under truncated BPTT, :meth:`Solver.fit` cuts each
sequence batch into windows and carries the recurrent state across them.

Per-layer updater overrides (reference: UpdaterBlock boundaries) are
honored: each layer gets its own transformation chain; frozen layers get
``set_to_zero``. Decoupled weight decay applies to weight params only.

Dropout draws from a CPU ``torch.Generator`` that the model seeds from the
config's seed and advances once per step (one fresh generator per step).
It cannot give the JAX package's threefry bits: dropout masks differ
between the packages, and only their distribution is comparable.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.dtypes import as_input
from ..obs.step_profiler import fence
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
        """``optimize=`` applies training-safe graph rewrite passes before
        the updater state is built (``True``/``"training"`` -> the default
        set: space-to-depth stem + BN affine precompute; or an explicit
        pass list — inference-only passes are rejected). The model is
        rewritten in place to a numerically equivalent form; rewrites are
        in-memory only and never serialized (``nn/rewrite``); the names of
        the passes that matched are ``applied_rewrites``.

        ``profiler=`` attaches a :class:`~deeplearning4j_tpu_torch.obs.
        step_profiler.StepProfiler`: each ``fit_batch`` attributes its time
        to the h2d / compute / host phases, fencing the card only on the
        profiler's sampled steps, and ``fit`` reads its batches step by
        step (the JAX package's whole-epoch scan has no steps to
        attribute). Without one, a step does nothing more."""
        self.model = model
        self.applied_rewrites = []
        if optimize:
            from ..nn.rewrite import rewrite_model_inplace

            self.applied_rewrites = rewrite_model_inplace(model, optimize, context="training")
        self.profiler = profiler
        self.optim = LayerOptimizers(model)
        self.opt_state = self.optim.init(model.params)

    def fit_batch(self, x, y, mask=None, label_mask=None,
                  rnn_state=None) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
        """One training step. Returns ``(score, new_rnn_state)``: the score is
        a 0-dim tensor on the model's device, read only when the caller
        asks. With ``rnn_state`` (a TBPTT window; ``{}`` for the first) the
        recurrent layers start from that carry, and the returned carry is
        where this step left them, detached from its graph."""
        model = self.model
        # StepProfiler phases: the card is fenced only on sampled steps
        prof = self.profiler
        fenced = prof.begin_step() if prof is not None else False
        timed = prof is not None and (fenced or prof.sync_every == 0)
        t0 = time.perf_counter() if prof is not None else 0.0
        x = model._input(x)
        y = as_input(y, model.dtype, True, model.device)
        if timed:
            if fenced:
                fence(model.device)
            prof.record("h2d", time.perf_counter() - t0, sampled=fenced)
            t0 = time.perf_counter()
        score, (new_state, new_rnn) = model.loss_pure(
            model.params, model.state, x, y, rng=model._next_generator(),
            mask=model._mask(mask), label_mask=model._mask(label_mask),
            rnn_state=rnn_state, train=True)
        grads = grads_of(score, model.params)
        score = score.detach()
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
        model.last_batch_size = int(x.shape[0])
        if model.listeners.requires_arrays:
            model.listeners.gradient_calculation(model, grads)
        new_rnn = {l: {k: v.detach() for k, v in st.items()} for l, st in new_rnn.items()}
        if prof is not None:
            # on sampled steps the card is idle after the fence, so this
            # host time is honest
            prof.record("host", time.perf_counter() - th, sampled=fenced)
            prof.end_step()
        return score, new_rnn

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
        """Train from a ``DataSetIterator`` WITHOUT resetting away its
        current position: consumption starts wherever the iterator stands,
        so an iterator repositioned by ``load_state_dict()`` resumes
        exactly mid-epoch, and finishing the interrupted epoch counts as
        the first of ``epochs``. An exhausted iterator is reset() at each
        epoch top (the normal fresh-epoch path). Listeners fire per
        iteration and per epoch exactly as in :meth:`fit`."""
        model = self.model
        sync = bool(model.listeners.listeners)
        last = None
        for _ in range(epochs):
            if not iterator.has_next():
                iterator.reset()
            model.listeners.epoch_start(model)
            while iterator.has_next():
                ds = iterator.next().wait_ready()
                score, _ = self.fit_batch(ds.features, ds.labels,
                                          ds.features_mask, ds.labels_mask)
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

    def fit(self, data, labels=None, *, epochs: int = 1, mask=None, label_mask=None) -> None:
        model = self.model
        # Without listeners the per-iteration score stays a device scalar:
        # fetching it would wait for the device every step.
        sync_every_iter = bool(model.listeners.listeners)
        # The JAX package's scan fast path (no listeners, no masks, standard
        # backprop) collects the batches once, dropping masked ones, and when
        # their shapes are uniform trains every epoch on that one list; an
        # iterator is then read once, not reset per epoch. The port keeps
        # that order by looping over the list. With ragged shapes JAX falls
        # back to reading the iterator again every epoch, and so does the port.
        # A step profiler needs per-step boundaries, so it opts out.
        source = None
        if (not sync_every_iter and self.profiler is None and mask is None
                and label_mask is None
                and model.conf.backprop_type is not BackpropType.TRUNCATED_BPTT):
            batches = [(f, l, None, None) for f, l, m, lm in _as_batches(data, labels, mask)
                       if m is None and lm is None]
            shapes = {(tuple(np.shape(f)), tuple(np.shape(l))) for f, l, _, _ in batches}
            if batches and len(shapes) == 1:
                source = batches
        last_score = None
        for _ in range(epochs):
            model.listeners.epoch_start(model)
            for feats, labs, msk, lmsk in (
                    source if source is not None else _as_batches(data, labels, mask)):
                if label_mask is not None:
                    lmsk = label_mask
                if (model.conf.backprop_type is BackpropType.TRUNCATED_BPTT
                        and getattr(feats, "ndim", 0) == 3
                        and feats.shape[2] > model.conf.tbptt_fwd_length):
                    score = self._fit_tbptt(feats, labs, msk, lmsk)
                else:
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

    def _fit_tbptt(self, feats, labs, msk, lmsk) -> torch.Tensor:
        """Truncated BPTT (reference: doTruncatedBPTT): windows of
        ``tbptt_fwd_length`` steps (the last may be shorter), one update
        each; the recurrent carry passes from window to window, detached,
        and starts from zeros in every batch. ``tbptt_back_length`` is not
        read, as in the JAX package: the gradient spans the window."""
        model = self.model
        feats = model._input(feats)
        labs = as_input(labs, model.dtype, True, model.device)
        t_total = feats.shape[2]
        length = model.conf.tbptt_fwd_length
        rnn_state: dict = {}
        last_score = None
        for start in range(0, t_total, length):
            end = min(start + length, t_total)
            lw = labs[:, :, start:end] if labs.ndim == 3 else labs
            mw = None if msk is None else msk[:, start:end]
            lmw = None if lmsk is None else lmsk[:, start:end]
            last_score, rnn_state = self.fit_batch(feats[:, :, start:end], lw, mw, lmw,
                                                   rnn_state=rnn_state)
        return last_score
