"""Model serialization (port of ``deeplearning4j_tpu/model/serializer.py``).

Reads and writes the JAX package's model zip:

  configuration.json   — core.config JSON of the MultiLayerConfiguration
                         or ComputationGraphConfiguration
  coefficients.npy     — flat float param vector in ``ravel_pytree`` order
  state.npz            — non-trainable state leaves (``leaf_0..``), layers
                         and keys sorted as strings (batch norm's mean and
                         var; an MoE layer's aux_load_balance,
                         capacity_slots, dropped_tokens, expert_tokens)
  updaterState.npz     — updater state leaves (optional)
  meta.json            — model class + framework

``coefficients.npy`` is one flat vector in the order JAX flattens the
``{layer_name: {param_name: array}}`` dict: keys sorted as strings at both
levels, so ``layer_10`` precedes ``layer_2``, a graph's ``fc`` precedes
``s0b0_a_bn`` and ``s0b10`` precedes ``s0b2``, and, within a layer, ``W1``
precedes ``b1`` (upper case sorts first). ``params_flat`` /
``set_params_flat`` of ``MultiLayerNetwork`` and ``ComputationGraph``
keep that order. Zips this module writes name the
JAX framework, so the JAX package restores them as its own.

``updaterState.npz`` holds ``leaf_0..leaf_n`` in the order JAX flattens the
``{layer: optax state}`` dict: layers sorted as strings, then each chain's
states in order, each state's fields in order, and each ``{param: array}``
dict sorted by name (for Adam: count, mu by param, nu by param, then the
learning-rate schedule's count when the rate is a schedule). The port's
updater states keep optax's layout (``train/updaters.py``), so a zip a JAX
``Solver`` wrote resumes in the port and the reverse, for all 13 updaters
(an ``EmptyState`` has no leaves; a schedule adds its count; Lars and Lamb
keep their dicts of count, moments, trust and gnorm).
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from .. import __version__
from ..core.config import from_json, to_json
from ..nn.graph import ComputationGraph
from ..nn.sequential import MultiLayerNetwork

_CONF = "configuration.json"
_COEFF = "coefficients.npy"
_STATE = "state.npz"
_UPDATER = "updaterState.npz"
_NORM = "normalizer.npz"
_META = "meta.json"

_FRAMEWORK = "deeplearning4j_tpu"  # the zip format's name, shared by both packages
_PORT_FRAMEWORK = "deeplearning4j_tpu_torch"
_KNOWN_MODEL_CLASSES = ("MultiLayerNetwork", "ComputationGraph")

Device = Optional[Union[str, torch.device]]
Model = Union[MultiLayerNetwork, ComputationGraph]


def _check_meta(meta: dict, path: str) -> None:
    cls_name = meta.get("model_class")
    if cls_name not in _KNOWN_MODEL_CLASSES:
        raise ValueError(
            f"{path}: unknown model_class {cls_name!r} in meta.json "
            f"(expected one of {_KNOWN_MODEL_CLASSES})")
    framework = meta.get("framework")
    if framework not in (None, _FRAMEWORK, _PORT_FRAMEWORK):
        raise ValueError(f"{path}: artifact written by framework {framework!r}, "
                         f"not {_FRAMEWORK!r}")


def _state_leaves(tree: Any) -> List[np.ndarray]:
    """The leaves of an updater or layer state in JAX's tree-flatten order: dicts by
    sorted key, tuples (and optax's NamedTuple states) in order; step
    counts are int32 scalars."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _state_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for item in tree for leaf in _state_leaves(item)]
    if isinstance(tree, int):
        return [np.asarray(tree, np.int32)]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return [(t.float() if t.dtype == torch.bfloat16 else t).numpy()]
    raise TypeError(f"unexpected updater state node {type(tree).__name__}")


def _fill_state(template: Any, leaves: Iterator[np.ndarray]) -> Any:
    """``template`` with its leaves taken in order from ``leaves``: tensors
    are overwritten in place, counts replaced. A leaf of another shape
    raises."""
    if isinstance(template, dict):
        filled = {k: _fill_state(template[k], leaves) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, tuple):
        items = [_fill_state(item, leaves) for item in template]
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    if isinstance(template, int):
        return int(next(leaves))
    arr = np.asarray(next(leaves))
    if arr.shape != tuple(template.shape):
        raise ValueError(f"state leaf of shape {arr.shape}, model expects "
                         f"{tuple(template.shape)}")
    if arr.dtype not in (np.float16, np.float32, np.float64):
        arr = arr.astype(np.float32)  # e.g. ml_dtypes bfloat16
    with torch.no_grad():
        template.copy_(torch.tensor(arr, dtype=template.dtype))
    return template


def load_jax_params(model, params_np: Dict[str, Any]):
    """Load the JAX package's parameters, given as numpy arrays, into a port
    model built from the same configuration: a network's
    ``{layer_name: {param_name: array}}`` (a graph's keyed by vertex), or a
    flat ``{param_name: array}`` where the model's ``params`` is flat (the
    A3C agent's). Returns ``model``."""
    if hasattr(model, "_check_init"):
        model._check_init()
    mine = model.params
    if set(params_np) - set(mine):
        raise KeyError(f"unknown layers {sorted(set(params_np) - set(mine))}")
    with torch.no_grad():
        for lname, lparams in mine.items():
            if isinstance(lparams, torch.Tensor):
                if lname not in params_np:
                    raise KeyError(f"param {lname} is missing")
                _copy_param(lname, lparams, params_np[lname])
                continue
            given = params_np.get(lname, {})
            if set(given) != set(lparams):
                raise KeyError(f"{lname}: params {sorted(given)} do not match "
                               f"the model's {sorted(lparams)}")
            for pname, p in lparams.items():
                _copy_param(f"{lname}.{pname}", p, given[pname])
    return model


def _copy_param(name: str, p: torch.Tensor, arr) -> None:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(p.shape):
        raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
    if arr.dtype not in (np.float16, np.float32, np.float64):
        arr = arr.astype(np.float32)  # e.g. ml_dtypes bfloat16
    p.copy_(torch.tensor(arr).to(device=p.device, dtype=p.dtype))


def restore_multi_layer_network(path: str, device: Device = None,
                                load_updater: bool = False) -> MultiLayerNetwork:
    """Reference: ModelSerializer.restoreMultiLayerNetwork. Builds the
    network from the zip's configuration on ``device`` (default: the
    current CUDA device) and loads its coefficients; with ``load_updater``
    also its ``Solver`` and the updater state the zip carries."""
    return _restore(path, MultiLayerNetwork, device, load_updater)


def restore_computation_graph(path: str, device: Device = None,
                              load_updater: bool = False) -> ComputationGraph:
    """Reference: ModelSerializer.restoreComputationGraph; as
    :func:`restore_multi_layer_network`, with a ``GraphSolver``."""
    return _restore(path, ComputationGraph, device, load_updater)


def _restore(path: str, cls, device: Device, load_updater: bool) -> Model:
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if _META in names:
            _check_meta(json.loads(zf.read(_META)), path)
        conf = from_json(zf.read(_CONF).decode())
        model = cls(conf, device=device).init()
        flat = np.load(io.BytesIO(zf.read(_COEFF)))
        if int(flat.size) != model.num_params():
            raise ValueError(
                f"{path}: coefficient vector has {int(flat.size)} values but the "
                f"stored configuration expects {model.num_params()} params")
        model.set_params_flat(flat)
        if _STATE in names:
            z = np.load(io.BytesIO(zf.read(_STATE)))
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
            n_expected = len(_state_leaves(model.state))
            if len(leaves) != n_expected:
                raise ValueError(f"{path}: checkpoint has {len(leaves)} state leaves, "
                                 f"model expects {n_expected}")
            model.state = _fill_state(model.state, iter(leaves))
        if load_updater:
            if _UPDATER not in names:
                raise ValueError(f"{path}: load_updater=True but the artifact has no "
                                 "updater state (it was saved with save_updater=False)")
            if cls is ComputationGraph:
                from ..train.graph_solver import GraphSolver as trainer_cls
            else:
                from ..train.solver import Solver as trainer_cls

            trainer = trainer_cls(model)
            z = np.load(io.BytesIO(zf.read(_UPDATER)))
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
            n_expected = len(_state_leaves(trainer.opt_state))
            if len(leaves) != n_expected:
                raise ValueError(f"{path}: checkpoint has {len(leaves)} updater state "
                                 f"leaves, model expects {n_expected}")
            trainer.opt_state = _fill_state(trainer.opt_state, iter(leaves))
            model._trainer = trainer
    return model


def restore_model(path: str, device: Device = None, load_updater: bool = False) -> Model:
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(_META))
    _check_meta(meta, path)
    if meta["model_class"] == "ComputationGraph":
        return restore_computation_graph(path, device, load_updater)
    return restore_multi_layer_network(path, device, load_updater)


def write_model(model: Model, path: str, save_updater: bool = False,
                normalizer=None, *, class_name: Optional[str] = None) -> None:
    """Reference: ModelSerializer.writeModel(model, file, saveUpdater[,
    normalizer]), in the JAX package's layout. With ``save_updater`` and a
    model that has trained, the updater state goes in too; a
    ``data.normalizers`` normalizer goes in as ``normalizer.npz`` (its
    ``state_dict``). Atomic: the zip is assembled in a temp file beside
    ``path`` and then renamed onto it.

    ``class_name=`` names the model class in ``meta.json`` when ``model``
    is not the network itself: the checkpoint writer
    (``train/checkpoint.py``) serializes a host snapshot of it.

    The arrays (``coefficients.npy`` and the ``.npz`` members) are stored
    uncompressed and the JSON members deflated. The members and their
    formats are the JAX package's, and a zip reader reads either method;
    deflating float noise saved 12-15% of the bytes at about 20 MB/s on one
    core (86-90 s for a GPT-2-small checkpoint), which bounded how often a
    large model could save."""
    model._check_init()
    trainer = model._trainer if save_updater else None
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp_path = tempfile.mkstemp(dir=dirname, prefix=".tmp-",
                                    suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as zf:
                zf.writestr(_CONF, to_json(model.conf))
                buf = io.BytesIO()
                np.save(buf, model.params_flat())
                zf.writestr(_COEFF, buf.getvalue(), compress_type=zipfile.ZIP_STORED)
                buf = io.BytesIO()
                np.savez(buf, **{f"leaf_{i}": leaf for i, leaf in
                                 enumerate(_state_leaves(model.state))})
                zf.writestr(_STATE, buf.getvalue(), compress_type=zipfile.ZIP_STORED)
                if trainer is not None:
                    buf = io.BytesIO()
                    np.savez(buf, **{f"leaf_{i}": leaf for i, leaf in
                                     enumerate(_state_leaves(trainer.opt_state))})
                    zf.writestr(_UPDATER, buf.getvalue(), compress_type=zipfile.ZIP_STORED)
                if normalizer is not None:
                    buf = io.BytesIO()
                    np.savez(buf, **normalizer.state_dict())
                    zf.writestr(_NORM, buf.getvalue(), compress_type=zipfile.ZIP_STORED)
                zf.writestr(_META, json.dumps({
                    "model_class": class_name or type(model).__name__,
                    "framework": _FRAMEWORK,
                    "writer": f"{_PORT_FRAMEWORK} {__version__}",
                }))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise


def read_normalizer(path: str):
    """The normalizer a model zip carries (``normalizer.npz``, written by
    either package), or None when it has none."""
    from ..data.normalizers import (
        ImagePreProcessingScaler,
        NormalizerMinMaxScaler,
        NormalizerStandardize,
        VGG16ImagePreProcessor,
    )

    kinds = {
        "standardize": NormalizerStandardize,
        "minmax": NormalizerMinMaxScaler,
        "image": ImagePreProcessingScaler,
        "vgg16": VGG16ImagePreProcessor,
    }
    with zipfile.ZipFile(path) as zf:
        if _NORM not in zf.namelist():
            return None
        z = np.load(io.BytesIO(zf.read(_NORM)))
        d = {k: z[k] for k in z.files}
    norm = kinds[str(d["kind"])]()
    norm.load_state_dict(d)
    return norm
