"""Model serialization (port of ``deeplearning4j_tpu/model/serializer.py``).

Reads and writes the JAX package's model zip:

  configuration.json   — core.config JSON of the MultiLayerConfiguration
  coefficients.npy     — flat float param vector in ``ravel_pytree`` order
  state.npz            — non-trainable state leaves (``leaf_0..``), layers
                         and keys sorted as strings (an MoE layer's
                         aux_load_balance, capacity_slots, dropped_tokens,
                         expert_tokens)
  updaterState.npz     — updater state leaves (optional)
  meta.json            — model class + framework

``coefficients.npy`` is one flat vector in the order JAX flattens the
``{layer_name: {param_name: array}}`` dict: keys sorted as strings at both
levels, so ``layer_10`` precedes ``layer_2`` and, within a layer, ``W1``
precedes ``b1`` (upper case sorts first). ``MultiLayerNetwork.params_flat``
/ ``set_params_flat`` keep that order. Zips this module writes name the
JAX framework, so the JAX package restores them as its own.

``updaterState.npz`` holds ``leaf_0..leaf_n`` in the order JAX flattens the
``{layer: optax state}`` dict: layers sorted as strings, then each chain's
states in order, each state's fields in order, and each ``{param: array}``
dict sorted by name (for Adam: count, mu by param, nu by param, then the
learning-rate schedule's count when the rate is a schedule). The port's
updater states keep optax's layout (``train/updaters.py``), so a zip a JAX
``Solver`` wrote resumes in the port and the reverse. Only Adam and AdamW
states are carried so far; any other updater raises.
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
from ..nn.sequential import MultiLayerNetwork

_CONF = "configuration.json"
_COEFF = "coefficients.npy"
_STATE = "state.npz"
_UPDATER = "updaterState.npz"
_META = "meta.json"

_FRAMEWORK = "deeplearning4j_tpu"  # the zip format's name, shared by both packages
_PORT_FRAMEWORK = "deeplearning4j_tpu_torch"
_KNOWN_MODEL_CLASSES = ("MultiLayerNetwork", "ComputationGraph")

Device = Optional[Union[str, torch.device]]


def _check_meta(meta: dict, path: str) -> None:
    cls_name = meta.get("model_class")
    if cls_name not in _KNOWN_MODEL_CLASSES:
        raise ValueError(
            f"{path}: unknown model_class {cls_name!r} in meta.json "
            f"(expected one of {_KNOWN_MODEL_CLASSES})")
    if cls_name != "MultiLayerNetwork":
        raise NotImplementedError(f"{path}: {cls_name} is not ported yet")
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


def _check_carried_updaters(trainer) -> None:
    from ..train.updaters import Adam, AdamW

    for name, updater in trainer.optim.updaters.items():
        if type(updater) not in (Adam, AdamW):
            raise NotImplementedError(
                f"{name}: carrying {type(updater).__name__} updater state through "
                "the model zip is not ported yet (Adam and AdamW are)")


def load_jax_params(model: MultiLayerNetwork,
                    params_np: Dict[str, Dict[str, np.ndarray]]) -> MultiLayerNetwork:
    """Load the JAX package's parameters, given as numpy arrays
    (``{layer_name: {param_name: array}}``), into a port model built from
    the same configuration. Returns ``model``."""
    model._check_init()
    mine = model.params
    if set(params_np) - set(mine):
        raise KeyError(f"unknown layers {sorted(set(params_np) - set(mine))}")
    with torch.no_grad():
        for lname, lparams in mine.items():
            given = params_np.get(lname, {})
            if set(given) != set(lparams):
                raise KeyError(f"{lname}: params {sorted(given)} do not match "
                               f"the model's {sorted(lparams)}")
            for pname, p in lparams.items():
                arr = np.asarray(given[pname])
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(f"{lname}.{pname}: shape {arr.shape} != "
                                     f"{tuple(p.shape)}")
                if arr.dtype not in (np.float16, np.float32, np.float64):
                    arr = arr.astype(np.float32)  # e.g. ml_dtypes bfloat16
                p.copy_(torch.tensor(arr).to(device=p.device, dtype=p.dtype))
    return model


def restore_multi_layer_network(path: str, device: Device = None,
                                load_updater: bool = False) -> MultiLayerNetwork:
    """Reference: ModelSerializer.restoreMultiLayerNetwork. Builds the
    network from the zip's configuration on ``device`` (default: the
    current CUDA device) and loads its coefficients; with ``load_updater``
    also its ``Solver`` and the updater state the zip carries."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if _META in names:
            _check_meta(json.loads(zf.read(_META)), path)
        conf = from_json(zf.read(_CONF).decode())
        model = MultiLayerNetwork(conf, device=device).init()
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
            from ..train.solver import Solver

            trainer = Solver(model)
            _check_carried_updaters(trainer)
            z = np.load(io.BytesIO(zf.read(_UPDATER)))
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
            n_expected = len(_state_leaves(trainer.opt_state))
            if len(leaves) != n_expected:
                raise ValueError(f"{path}: checkpoint has {len(leaves)} updater state "
                                 f"leaves, model expects {n_expected}")
            trainer.opt_state = _fill_state(trainer.opt_state, iter(leaves))
            model._trainer = trainer
    return model


def restore_model(path: str, device: Device = None,
                  load_updater: bool = False) -> MultiLayerNetwork:
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read(_META))
    _check_meta(meta, path)
    return restore_multi_layer_network(path, device, load_updater)


def write_model(model: MultiLayerNetwork, path: str, save_updater: bool = False) -> None:
    """Reference: ModelSerializer.writeModel, in the JAX package's layout.
    With ``save_updater`` and a model that has trained, the updater state
    goes in too. Atomic: the zip is assembled in a temp file beside
    ``path`` and then renamed onto it."""
    model._check_init()
    trainer = model._trainer if save_updater else None
    if trainer is not None:
        _check_carried_updaters(trainer)
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp_path = tempfile.mkstemp(dir=dirname, prefix=".tmp-",
                                    suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as zf:
                zf.writestr(_CONF, to_json(model.conf))
                buf = io.BytesIO()
                np.save(buf, model.params_flat())
                zf.writestr(_COEFF, buf.getvalue())
                buf = io.BytesIO()
                np.savez(buf, **{f"leaf_{i}": leaf for i, leaf in
                                 enumerate(_state_leaves(model.state))})
                zf.writestr(_STATE, buf.getvalue())
                if trainer is not None:
                    buf = io.BytesIO()
                    np.savez(buf, **{f"leaf_{i}": leaf for i, leaf in
                                     enumerate(_state_leaves(trainer.opt_state))})
                    zf.writestr(_UPDATER, buf.getvalue())
                zf.writestr(_META, json.dumps({
                    "model_class": type(model).__name__,
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
