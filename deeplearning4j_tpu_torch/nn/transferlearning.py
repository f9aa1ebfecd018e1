"""Transfer learning (port of ``deeplearning4j_tpu/nn/transferlearning.py``).

Reference: org.deeplearning4j.nn.transferlearning.{TransferLearning.Builder,
FineTuneConfiguration}: freeze layers below a feature-extraction boundary,
replace or append output layers, override training hyperparameters, keep
the pretrained weights of retained layers. A frozen layer's updater is
``set_to_zero`` (``train/solver.py::LayerOptimizers``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from ..core.config import register_config
from .activations import Activation
from .layers.base import Layer
from .sequential import MultiLayerNetwork
from .weights import WeightInit


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class FineTuneConfiguration:
    """Hyperparameter overrides applied to all non-frozen layers
    (reference: FineTuneConfiguration)."""

    updater: Optional[Any] = None
    activation: Optional[Activation] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    seed: Optional[int] = None

    def apply_to(self, layer: Layer) -> Layer:
        updates = {}
        if self.updater is not None:
            updates["updater"] = self.updater
        if self.activation is not None and layer.activation is not None:
            updates["activation"] = self.activation
        if self.l1 is not None:
            updates["l1"] = self.l1
        if self.l2 is not None:
            updates["l2"] = self.l2
        if self.dropout is not None:
            updates["dropout"] = self.dropout
        return dataclasses.replace(layer, **updates) if updates else layer


class TransferLearningBuilder:
    """Reference: TransferLearning.Builder over a trained MultiLayerNetwork.
    The new network lives on the old one's device."""

    def __init__(self, model: MultiLayerNetwork) -> None:
        if not model._initialized:
            raise ValueError("Transfer learning requires an initialized model")
        self.model = model
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._n_removed = 0
        self._added: List[Layer] = []
        self._replaced_n_out: dict = {}

    def fine_tune_configuration(self, cfg: FineTuneConfiguration) -> "TransferLearningBuilder":
        self._fine_tune = cfg
        return self

    def set_feature_extractor(self, layer_index: int) -> "TransferLearningBuilder":
        """Freeze layers [0..layer_index] (reference: setFeatureExtractor)."""
        self._freeze_until = layer_index
        return self

    def remove_output_layer(self) -> "TransferLearningBuilder":
        self._n_removed += 1
        return self

    def remove_layers_from_output(self, n: int) -> "TransferLearningBuilder":
        self._n_removed += n
        return self

    def n_out_replace(self, layer_index: int, n_out: int,
                      weight_init: WeightInit = WeightInit.XAVIER) -> "TransferLearningBuilder":
        """Change a layer's nOut, re-initializing it and the next layer's nIn
        (reference: nOutReplace)."""
        self._replaced_n_out[layer_index] = (n_out, weight_init)
        return self

    def add_layer(self, layer: Layer) -> "TransferLearningBuilder":
        self._added.append(layer)
        return self

    def build(self) -> MultiLayerNetwork:
        old_conf = self.model.conf
        layers = list(old_conf.layers)
        layers = layers[:len(layers) - self._n_removed]
        reinit: set = set()

        for idx, (n_out, winit) in self._replaced_n_out.items():
            layers[idx] = dataclasses.replace(layers[idx], n_out=n_out, weight_init=winit)
            reinit.add(idx)
            # fix the next param layer's n_in
            for j in range(idx + 1, len(layers)):
                if hasattr(layers[j], "n_in"):
                    layers[j] = dataclasses.replace(layers[j], n_in=n_out)
                    reinit.add(j)
                    break

        if self._freeze_until is not None:
            for i in range(min(self._freeze_until + 1, len(layers))):
                layers[i] = dataclasses.replace(layers[i], frozen=True)

        if self._fine_tune is not None:
            for i in range(len(layers)):
                if not layers[i].frozen:
                    layers[i] = self._fine_tune.apply_to(layers[i])

        n_old = len(layers)
        # added layers: resolve shapes from the last retained layer's output
        if self._added:
            cur = old_conf.input_type
            if cur is not None:
                for l in layers:
                    cur = l.with_input(cur).output_type(cur)
                for add in self._added:
                    add = add.with_input(cur)
                    layers.append(add)
                    cur = add.output_type(cur)
            else:
                layers.extend(self._added)

        ft = self._fine_tune
        new_conf = dataclasses.replace(
            old_conf,
            layers=tuple(layers),
            seed=ft.seed if ft and ft.seed is not None else old_conf.seed,
            updater=ft.updater if ft and ft.updater is not None else old_conf.updater,
        )
        new_model = MultiLayerNetwork(new_conf, device=self.model.device).init()
        # carry over pretrained params for retained, un-reinitialized layers
        old_params, new_params = self.model.params, new_model.params
        with torch.no_grad():
            for i in range(n_old):
                if i in reinit:
                    continue
                old_name, new_name = old_conf.layer_name(i), new_conf.layer_name(i)
                old_p, new_p = old_params.get(old_name, {}), new_params.get(new_name, {})
                if old_p and all(k in new_p and new_p[k].shape == v.shape
                                 for k, v in old_p.items()):
                    for k, v in old_p.items():
                        new_p[k].copy_(v)
                old_s = self.model.state.get(old_name)
                if old_s and new_model.state.get(new_name):
                    new_model.state[new_name] = {k: v.clone() for k, v in old_s.items()}
        return new_model


class TransferLearning:
    Builder = TransferLearningBuilder
