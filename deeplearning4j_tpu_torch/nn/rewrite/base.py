"""Pattern-match-and-rewrite pass framework over network configs + params
(port of ``deeplearning4j_tpu/nn/rewrite/base.py``).

Graph-level rewriting before execution is the standard systems answer to
model-shaped inefficiency (TensorFlow's Grappler, PAPERS.md): a pass
pattern-matches a structural idiom in a ``MultiLayerConfiguration`` or
``ComputationGraphConfiguration`` and returns a transformed
``(config, params, state)`` triple that is **numerically equivalent** —
weight transforms are exact (float64 host math, pad+reshape), and a pass
that finds no match returns its inputs untouched (the same config, params
and state objects), so running the pipeline on BERT/LSTM/MoE graphs is a
provable no-op.

Two pass sets, threaded through the stack:

* the training set (``training_safe = True``) — applied by
  ``Solver``/``GraphSolver`` through ``optimize=`` before the updater state
  is built: space-to-depth stem, BN affine precompute;
* the inference set — applied by ``ModelManager.deploy`` before warmup, so
  every swapped-in version serves the rewritten graph (adds conv+BN
  folding, which freezes BN statistics into conv weights and therefore
  must never run under training), plus weight quantization for
  ``"inference:int8"`` / ``"inference:fp8"``.

Rewrites are **in memory only**: serialized artifacts and the
``ModelStore`` always hold the un-rewritten model. Params are
``{layer: {param: tensor}}`` as ``model.params`` gives them; a rewritten
model registers the parameters a pass left alone as the same
``nn.Parameter`` objects (JAX's rewritten model shares its unchanged
arrays the same way), and the tensors a pass made on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..conf import MultiLayerConfiguration
from ..graph_conf import ComputationGraphConfiguration
from ..layers.base import LayerModule

Params = Dict[str, Dict[str, Any]]
State = Dict[str, Dict[str, Any]]
# (config, params, state, changed)
PassResult = Tuple[Any, Params, State, bool]


class RewritePass:
    """One pattern-match-and-rewrite transform.

    Subclasses implement ``apply_sequential`` and/or ``apply_graph``; both
    take (config, params, state) and return (config, params, state,
    changed). The contract:

    * **Equivalence** — the rewritten model's forward (and, for
      ``training_safe`` passes, backward) matches the original to float
      tolerance for every input.
    * **Exact no-op on non-matching graphs** — when the pattern is
      absent, return the *same* config/params/state objects with
      ``changed=False``.
    * **Params travel with the config** — any layer rename, insertion or
      removal remaps the params/state dicts in the same call, so the
      triple is always self-consistent.
    """

    name: str = "rewrite"
    #: True when training through the rewritten graph is equivalent to
    #: training through the original (exact reparametrization). Inference
    #: -only passes (conv+BN fold) freeze statistics and must never be
    #: applied by a Solver.
    training_safe: bool = False

    def apply(self, conf: Any, params: Params, state: State) -> PassResult:
        if isinstance(conf, MultiLayerConfiguration):
            return self.apply_sequential(conf, params, state)
        if isinstance(conf, ComputationGraphConfiguration):
            return self.apply_graph(conf, params, state)
        return conf, params, state, False

    def apply_sequential(self, conf: MultiLayerConfiguration,
                         params: Params, state: State) -> PassResult:
        return conf, params, state, False

    def apply_graph(self, conf: ComputationGraphConfiguration,
                    params: Params, state: State) -> PassResult:
        return conf, params, state, False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(name={self.name!r})"


# ---------------------------------------------------------------------------
# sequential-config plumbing: inserting/removing layers shifts the implicit
# ``layer_{i}`` names of unnamed layers, so params/state must be remapped in
# lockstep with the layer list.
# ---------------------------------------------------------------------------

def remap_sequential(
    conf: MultiLayerConfiguration,
    new_layers: Sequence,
    index_map: Dict[int, int],
    params: Params,
    state: State,
    param_overrides: Optional[Dict[int, Dict[str, Any]]] = None,
) -> Tuple[MultiLayerConfiguration, Params, State]:
    """Rebuild (config, params, state) for an edited sequential layer list.

    ``index_map`` maps old layer index -> new layer index (dropped layers
    absent); ``param_overrides`` maps *old* index -> replacement param dict
    (e.g. the transformed stem kernel). Inserted layers get empty
    params/state entries via the new config's own naming."""
    new_conf = dataclasses.replace(conf, layers=tuple(new_layers))
    new_params: Params = {}
    new_state: State = {}
    mapped_new = set()
    overrides = param_overrides or {}
    for old_i, new_i in index_map.items():
        old_name = conf.layer_name(old_i)
        new_name = new_conf.layer_name(new_i)
        mapped_new.add(new_name)
        if old_i in overrides:
            new_params[new_name] = dict(overrides[old_i])
        elif old_name in params:
            new_params[new_name] = params[old_name]
        if old_name in state:
            new_state[new_name] = state[old_name]
    for i in range(len(new_layers)):
        name = new_conf.layer_name(i)
        if name not in mapped_new:
            new_params.setdefault(name, {})
            new_state.setdefault(name, {})
    return new_conf, new_params, new_state


def unique_vertex_name(conf: ComputationGraphConfiguration, base: str) -> str:
    taken = set(conf.network_inputs) | {v.name for v in conf.vertices}
    name = base
    i = 0
    while name in taken:
        i += 1
        name = f"{base}{i}"
    return name


# ---------------------------------------------------------------------------
# pass pipelines
# ---------------------------------------------------------------------------

def training_passes() -> List[RewritePass]:
    """Default training-safe pipeline (the ``optimize="training"`` set)."""
    from .passes import BatchNormAffinePass, SpaceToDepthStemPass

    return [SpaceToDepthStemPass(), BatchNormAffinePass()]


def inference_passes(quantize: Optional[str] = None,
                     act_ranges=None) -> List[RewritePass]:
    """Default inference pipeline (the ``ModelManager.deploy`` set):
    stem rewrite, then conv+BN fold, then affine precompute for any BN
    the fold could not consume. ``quantize="int8"``/``"fp8"`` appends the
    post-training weight-quantization pass AFTER the folds (so the folded
    conv weights are what gets quantized); ``act_ranges`` (a
    :func:`~.quantize.calibrate` result) turns on the calibrated
    activation-quantization variant for the named Dense layers."""
    from .passes import BatchNormAffinePass, ConvBatchNormFoldPass, SpaceToDepthStemPass

    passes: List[RewritePass] = [SpaceToDepthStemPass(),
                                 ConvBatchNormFoldPass(),
                                 BatchNormAffinePass()]
    if quantize is not None:
        passes += quantization_passes(quantize, act_ranges=act_ranges)
    return passes


def quantization_passes(dtype: str = "int8",
                        act_ranges=None) -> List[RewritePass]:
    """The post-training quantization set on its own (inference-only)."""
    from .quantize import QuantizeWeightsPass

    return [QuantizeWeightsPass(dtype, act_ranges=act_ranges)]


def resolve_passes(
    spec: Union[None, bool, str, RewritePass, Sequence[RewritePass]],
    *,
    context: str = "inference",
) -> List[RewritePass]:
    """Normalize an ``optimize=`` argument into a pass list.

    ``True``/``"training"`` -> the training-safe set; ``"inference"`` ->
    the inference set; ``"inference:int8"``/``"inference:fp8"`` -> the
    inference set plus post-training weight quantization; a pass or list
    of passes is taken verbatim. In a ``context="training"`` resolution,
    inference-only passes are rejected — folding BN into a conv that is
    about to be *trained* silently changes semantics, so it is an error,
    not a warning."""
    if not spec:
        return []
    if spec is True:
        spec = context
    if isinstance(spec, str):
        if spec == "training":
            passes = training_passes()
        elif spec == "inference":
            passes = inference_passes()
        elif spec.startswith("inference:"):
            passes = inference_passes(quantize=spec.split(":", 1)[1])
        else:
            raise ValueError(
                f"Unknown rewrite pipeline {spec!r}; expected 'training', "
                f"'inference', or a list of RewritePass instances")
    elif isinstance(spec, RewritePass):
        passes = [spec]
    else:
        passes = list(spec)
    if context == "training":
        bad = [p.name for p in passes if not p.training_safe]
        if bad:
            raise ValueError(
                f"Pass(es) {bad} are inference-only and cannot be applied "
                f"at training time (optimize=); use them via "
                f"ModelManager/rewrite_model for serving instead")
    return passes


def apply_passes(
    conf: Any, params: Params, state: State,
    passes: Sequence[RewritePass],
) -> Tuple[Any, Params, State, List[str]]:
    """Run ``passes`` in order; returns the transformed triple plus the
    names of passes that actually changed the graph."""
    applied: List[str] = []
    for p in passes:
        conf, params, state, changed = p.apply(conf, params, state)
        if changed:
            applied.append(p.name)
    return conf, params, state, applied


# ---------------------------------------------------------------------------
# model-level entry points
# ---------------------------------------------------------------------------

def _layer_names(conf: Any):
    if isinstance(conf, MultiLayerConfiguration):
        return [(conf.layer_name(i), l) for i, l in enumerate(conf.layers)]
    return [(s.name, s.layer) for s in conf.vertices if s.layer is not None]


def _install(model, conf: Any, params: Params, state: State) -> None:
    """Point ``model`` at the rewritten triple, re-establishing what
    ``init()`` builds: one :class:`LayerModule` per layer (the old ones are
    dropped, so no module holds a parameter of the old graph), a state
    entry and the persistent-key map per layer, an empty transient carry,
    and no trainer (its updater state was built over the old params). A
    decode graph captured over the old params lives in its
    ``GenerationSession`` or ``DecodeEngine``, which must be built anew
    for the rewritten model."""
    full_state: State = {}
    persistent: Dict[str, Tuple[str, ...]] = {}
    names = _layer_names(conf)
    for name, _layer in names:
        st = dict(state.get(name, {}))
        full_state[name] = st
        persistent[name] = tuple(st.keys())
    for name in [n for n, m in model._modules.items() if isinstance(m, LayerModule)]:
        del model._modules[name]
    for name, layer in names:
        model.add_module(name, LayerModule(layer, params.get(name, {})))
    model.conf = conf
    if isinstance(conf, MultiLayerConfiguration):
        model.layers = conf.layers
        model.rnn_state = {}
    else:
        model._consumed = {i for s in conf.vertices for i in s.inputs}
        model.output_weights = {n: model.output_weights.get(n, 1.0)
                                for n in conf.network_outputs}
    model.state = full_state
    model._persistent_keys = persistent
    model._trainer = None
    model._initialized = True


def rewrite_model(model, passes: Union[str, Sequence[RewritePass]] = "inference",
                  *, context: str = "inference"):
    """Apply ``passes`` to a **copy** of ``model``; returns
    ``(new_model, applied_pass_names)``. When nothing matched, the
    original model object is returned unchanged (zero cost). The original
    model's config, modules and state are never changed — this is the
    serving entry point (``ModelManager`` rewrites the loaded copy; the
    store artifact stays un-rewritten). The copy lives on the original's
    device."""
    model._check_init()
    plist = resolve_passes(passes, context=context)
    conf, params, state, applied = apply_passes(
        model.conf, model.params, model.state, plist)
    if not applied:
        return model, []
    new = type(model)(conf, device=model.device)
    _install(new, conf, params, state)
    return new, applied


def rewrite_model_inplace(
    model, passes: Union[str, Sequence[RewritePass]] = "training",
    *, context: str = "training",
) -> List[str]:
    """Apply ``passes`` to ``model`` in place (the ``Solver``/
    ``GraphSolver`` ``optimize=`` path, where the caller keeps training
    the same model object). Returns the applied pass names."""
    model._check_init()
    plist = resolve_passes(passes, context=context)
    conf, params, state, applied = apply_passes(
        model.conf, model.params, model.state, plist)
    if applied:
        _install(model, conf, params, state)
    return applied
