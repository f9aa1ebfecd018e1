"""ComputationGraph configuration (port of ``deeplearning4j_tpu/nn/graph_conf.py``).

Reference: org.deeplearning4j.nn.conf.ComputationGraphConfiguration +
GraphBuilder (reached via ``NeuralNetConfiguration.builder().graph_builder()``).
Same construction surface: add_inputs, add_layer(name, layer, *inputs),
add_vertex(name, vertex, *inputs), set_outputs, set_input_types; build()
puts the vertices in topological order (raising on a cycle or an undefined
input), runs shape inference, fills nIn and attaches a preprocessor to a
layer vertex at a format boundary. The JSON is the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.config import register_config
from .conf import (
    BackpropType,
    GradientNormalization,
    NeuralNetConfigurationBuilder,
    WorkspaceMode,
    _needs,
    _preprocessor_for,
)
from .input_type import ConvolutionalFlatType, FeedForwardType, InputType
from .layers.base import Layer
from .vertices import GraphVertex


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class VertexSpec:
    """One node: either a layer or a function vertex, with named inputs.
    ``preprocessor`` is auto-inserted format conversion (reference:
    InputPreProcessor attached to a layer vertex)."""

    name: str = ""
    layer: Optional[Layer] = None
    vertex: Optional[GraphVertex] = None
    inputs: Tuple[str, ...] = ()
    preprocessor: Optional[Layer] = None


@register_config
@dataclasses.dataclass(frozen=True, kw_only=True)
class ComputationGraphConfiguration:
    network_inputs: Tuple[str, ...] = ()
    network_outputs: Tuple[str, ...] = ()
    vertices: Tuple[VertexSpec, ...] = ()  # in topological order after build()
    input_types: Tuple[InputType, ...] = ()
    seed: int = 0
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    updater: Optional[object] = None
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    gradient_normalization: GradientNormalization = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0
    gradient_checkpointing: bool = False
    training_workspace_mode: WorkspaceMode = WorkspaceMode.ENABLED
    inference_workspace_mode: WorkspaceMode = WorkspaceMode.ENABLED

    def spec(self, name: str) -> VertexSpec:
        for v in self.vertices:
            if v.name == name:
                return v
        raise KeyError(name)


class GraphBuilder:
    """Reference: ComputationGraphConfiguration.GraphBuilder."""

    def __init__(self, parent: NeuralNetConfigurationBuilder) -> None:
        self._parent = parent
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._specs: Dict[str, VertexSpec] = {}
        self._input_types: List[InputType] = []
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    addInputs = add_inputs

    def _add(self, name: str, spec: VertexSpec) -> "GraphBuilder":
        if name in self._specs or name in self._inputs:
            raise ValueError(f"Duplicate vertex name {name!r}")
        self._specs[name] = spec
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        return self._add(name, VertexSpec(name=name, layer=layer, inputs=tuple(inputs)))

    addLayer = add_layer

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str) -> "GraphBuilder":
        return self._add(name, VertexSpec(name=name, vertex=vertex, inputs=tuple(inputs)))

    addVertex = add_vertex

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    setOutputs = set_outputs

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    setInputTypes = set_input_types

    def backprop_type(self, t: BackpropType) -> "GraphBuilder":
        self._backprop_type = t
        return self

    def tbptt_fwd_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd = n
        return self

    def tbptt_back_length(self, n: int) -> "GraphBuilder":
        self._tbptt_back = n
        return self

    def _topo_sort(self) -> List[VertexSpec]:
        """Kahn-style passes in insertion order: each pass places every
        vertex whose inputs are all placed; a pass that places none means a
        cycle or an input that names no vertex."""
        order: List[VertexSpec] = []
        placed = set(self._inputs)
        remaining = dict(self._specs)
        while remaining:
            progressed = False
            for name in list(remaining):
                spec = remaining[name]
                if all(i in placed for i in spec.inputs):
                    order.append(spec)
                    placed.add(name)
                    del remaining[name]
                    progressed = True
            if not progressed:
                raise ValueError(
                    f"Graph has a cycle or undefined inputs among: {sorted(remaining)}")
        return order

    def build(self) -> ComputationGraphConfiguration:
        p = self._parent
        if not self._inputs:
            raise ValueError("Graph needs at least one input (add_inputs)")
        if not self._outputs:
            raise ValueError("Graph needs outputs (set_outputs)")
        for out in self._outputs:
            if out not in self._specs:
                raise ValueError(f"Output {out!r} is not a vertex")
        order = self._topo_sort()

        if self._input_types:
            if len(self._input_types) != len(self._inputs):
                raise ValueError("One InputType per network input required")
            types: Dict[str, InputType] = dict(zip(self._inputs, self._input_types))
            resolved: List[VertexSpec] = []
            for spec in order:
                in_types = [types[i] for i in spec.inputs]
                if spec.layer is not None:
                    layer = p._apply_global_defaults(spec.layer)
                    need = _needs(layer)
                    cur = in_types[0]
                    pre = _preprocessor_for(cur, need)
                    if pre is not None:
                        cur = pre.output_type(cur)
                    if isinstance(cur, ConvolutionalFlatType) and need in ("ff", "any"):
                        cur = FeedForwardType(size=cur.flat_size())
                    layer = layer.with_input(cur)
                    out_t = layer.output_type(cur)
                    spec = dataclasses.replace(spec, layer=layer, preprocessor=pre)
                else:
                    out_t = spec.vertex.output_type(*in_types)
                types[spec.name] = out_t
                resolved.append(spec)
            order = resolved
        else:
            order = [dataclasses.replace(s, layer=p._apply_global_defaults(s.layer))
                     if s.layer is not None else s for s in order]

        return ComputationGraphConfiguration(
            network_inputs=tuple(self._inputs),
            network_outputs=tuple(self._outputs),
            vertices=tuple(order),
            input_types=tuple(self._input_types),
            seed=p._seed,
            dtype=p._dtype,
            compute_dtype=p._compute_dtype,
            updater=p._updater,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            gradient_normalization=p._grad_norm,
            gradient_normalization_threshold=p._grad_norm_threshold,
            gradient_checkpointing=p._grad_ckpt,
            training_workspace_mode=p._train_ws,
            inference_workspace_mode=p._infer_ws,
        )
