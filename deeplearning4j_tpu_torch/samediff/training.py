"""SameDiff training session (port of ``deeplearning4j_tpu/samediff/training.py``).

Reference: org.nd4j.autodiff.samediff.internal.TrainingSession +
org.nd4j.autodiff.samediff.TrainingConfig. A step interprets the graph
with the variables as autograd leaves, takes the gradients of the summed
loss, and applies the updater's transformation (``train/updaters.py``, the
port's counterpart of ``to_optax()``) to the variables in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.config import register_config
from ..train.updaters import Adam, IUpdater, apply_updates, updater_from_any


@register_config
@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """Reference: TrainingConfig.Builder — updater + placeholder mappings."""

    updater: Optional[IUpdater] = None
    data_set_feature_mapping: tuple = ()
    data_set_label_mapping: tuple = ()
    l1: float = 0.0
    l2: float = 0.0
    minimize: bool = True


@dataclasses.dataclass
class History:
    """Reference: org.nd4j.autodiff.listeners.records.History."""

    loss_curve: List[float] = dataclasses.field(default_factory=list)


class TrainingSession:
    def __init__(self, sd, config: Optional[TrainingConfig], listeners=None) -> None:
        from ..core.listeners import ListenerBus

        self.sd = sd
        self.config = config or TrainingConfig(updater=Adam(1e-3))
        self.updater = updater_from_any(self.config.updater or Adam(1e-3))
        self.tx = self.updater.to_transform()
        # trainable values keyed by node name (the transformation's tree keys)
        self.var_ids = {n.name: n.id for n in sd._nodes.values() if n.kind == "variable"}
        self.opt_state = None
        # the most recent fit()'s History — still holds the flushed loss
        # curve when fit() is interrupted mid-run
        self.last_history: Optional[History] = None
        # the per-step score is read on the host only when a listener
        # declares requires_score; otherwise the losses stay on the device
        # and are read once an epoch
        self.listeners = ListenerBus(listeners)
        self.iteration_count = 0
        self.epoch_count = 0
        self.last_batch_size: Optional[int] = None

    def step(self, params, feeds, rng) -> torch.Tensor:
        """One forward, backward and in-place update; returns the loss."""
        sd, cfg = self.sd, self.config
        loss_name = sd._loss_name
        if loss_name is None:
            raise ValueError("SameDiff has no loss variable (set_loss_variables)")
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        values = dict(sd._values)
        values.update({self.var_ids[k]: v for k, v in leaves.items()})
        with torch.enable_grad():
            out = sd._eval_graph(feeds, values, [loss_name], rng=rng, training=True)
            loss = torch.sum(out[loss_name])
            if cfg.l2:
                for v in leaves.values():
                    loss = loss + 0.5 * cfg.l2 * torch.sum(torch.square(v))
            if cfg.l1:
                for v in leaves.values():
                    loss = loss + cfg.l1 * torch.sum(torch.abs(v))
            if not cfg.minimize:
                loss = -loss
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(params.items(), grads)}
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(grads, self.opt_state, params)
            apply_updates(params, updates)
        return loss.detach()

    def fit(self, iterator, epochs: int = 1) -> History:
        from ..data.dataset import DataSet, MultiDataSet

        sd, cfg = self.sd, self.config
        params = {k: sd._values[i] for k, i in self.var_ids.items()}
        if self.opt_state is None:
            self.opt_state = self.tx.init(params)
        history = History()
        self.last_history = history
        device_losses: List[torch.Tensor] = []

        def flush_losses():
            if device_losses:  # one stacked read for the whole list
                history.loss_curve.extend(
                    torch.stack(device_losses).double().cpu().numpy().tolist())
                device_losses.clear()

        bus = self.listeners
        use_listeners = bool(bus.listeners)
        need_score = use_listeners and bus.requires_score
        try:
            for _ in range(epochs):
                if use_listeners:
                    bus.epoch_start(self)
                for item in iterator:
                    if isinstance(item, MultiDataSet):
                        feats, labs = list(item.features), list(item.labels)
                    elif isinstance(item, DataSet):
                        feats, labs = [item.features], [item.labels]
                    else:
                        feats, labs = [item[0]], [item[1]]
                    feeds = {}
                    feeds.update(zip(cfg.data_set_feature_mapping, feats))
                    feeds.update(zip(cfg.data_set_label_mapping, labs))
                    loss = self.step(params, feeds, sd._rng.next_key())
                    device_losses.append(loss)
                    if use_listeners:
                        self.iteration_count += 1
                        if feats:
                            shp = np.shape(feats[0])
                            self.last_batch_size = int(shp[0]) if shp else None
                        bus.iteration_done(self, self.iteration_count, self.epoch_count,
                                           float(loss) if need_score else float("nan"))
                flush_losses()
                if use_listeners:
                    bus.epoch_end(self)
                self.epoch_count += 1
        finally:
            # an exception mid-epoch must not lose the curve recorded so far
            flush_losses()
        return history
