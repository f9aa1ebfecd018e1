"""Checkpoints of a distributed trainer with ``torch.distributed.checkpoint``
(port of ``deeplearning4j_tpu/train/orbax_checkpoint.py``).

The JAX module writes with orbax, a JAX library; the port writes the same
sections with ``torch.distributed.checkpoint`` (DCP):

* every tensor at its GLOBAL shape (a ZeRO-1 trainer's updater slices are
  all-gathered first), so a checkpoint restores onto any data-axis width,
  sliced or replicated: the elastic-resize path;
* async save: ``save`` gathers and copies to the host on the calling
  thread (every rank calls it), then rank 0 writes in a background thread
  while training goes on; ``wait()`` joins the write on every rank;
* the config-JSON sidecar (``configuration.json``, rank 0) and a
  ``meta.json`` per step with the JAX module's fields (iteration, zero1,
  data_axis, pipeline_stages, the dropout stream's position) and the saved
  layout.

A ``PipelineParallelTrainer`` checkpoints at global shapes too (its
``params`` and ``opt_state`` gather every stage's blocks), so a checkpoint
restores into ``Solver``, ``DistributedTrainer`` and a differently staged
pipeline trainer, each way round.

A step is ``<directory>/<step>/``; its ``meta.json`` is written last, so a
step without one is an unfinished write and is not restored. The on-disk
format is the port's own: a checkpoint does not cross to the JAX package
(the model zip does, ``model/serializer.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.config import to_json

_META = "meta.json"


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _flatten(node, prefix: str, out: Dict[str, Any]) -> Dict[str, Any]:
    """``{"section/path/to/leaf": leaf}`` in tree order (dicts, tuples and
    NamedTuples, lists); host scalars are kept as they are."""
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = node
    return out


def _unflatten(template, prefix: str, values: Dict[str, Any]):
    """``template``'s structure with each leaf taken from ``values`` (by
    key) where present, else the template's own."""
    if isinstance(template, dict):
        return {k: _unflatten(v, f"{prefix}/{k}", values) for k, v in template.items()}
    if isinstance(template, tuple):
        items = [_unflatten(v, f"{prefix}/{i}", values) for i, v in enumerate(template)]
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    if isinstance(template, list):
        return [_unflatten(v, f"{prefix}/{i}", values) for i, v in enumerate(template)]
    return values.get(prefix, template)


def _as_saved(leaf) -> torch.Tensor:
    """A leaf as DCP stores it: tensors on the host, host scalars as 0-dim
    tensors."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.tensor(leaf)


def _check_section_compat(name: str, live: List[Tuple[str, tuple]],
                          saved: List[Tuple[str, tuple]], step, meta_hint: str) -> None:
    """Clear incompatibility errors before DCP's own. Sharded and replicated
    (ZeRO-1) layouts interchange freely, since every leaf is saved at its
    global shape; a different leaf count or global shape means another
    model, updater or strategy, which no reshard fixes."""
    if len(live) != len(saved):
        raise ValueError(
            f"checkpoint step {step} is incompatible with the live trainer: "
            f"'{name}' holds {len(saved)} saved leaves vs {len(live)} "
            f"live ({meta_hint}). ZeRO-1 sharded and replicated layouts "
            f"interchange freely (leaves are saved at global shape), so this "
            f"is a different model, updater or strategy; rebuild the "
            f"trainer to match the checkpoint.")
    bad = [(i, tuple(s), tuple(t)) for i, ((_, s), (_, t)) in enumerate(zip(saved, live))
           if tuple(s) != tuple(t)]
    if bad:
        i, s, t = bad[0]
        raise ValueError(
            f"checkpoint step {step} is incompatible with the live trainer: "
            f"'{name}' leaf {i} was saved with global shape {s} but the live "
            f"trainer expects {t} ({len(bad)} mismatched leaves total; "
            f"{meta_hint}). Global shapes do not depend on the mesh, so the "
            f"model or updater configuration differs from the one checkpointed.")


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class OrbaxCheckpointer:
    """``OrbaxCheckpointer(dir).save(step, trainer)`` / ``restore(trainer)``.

    ``max_to_keep`` keeps the last K steps (as ``CheckpointListener``'s
    keep-last-K); ``async_save=True`` lets ``save`` return once the arrays
    are on the host (``wait()`` joins the write). Every rank of the trainer
    calls ``save``, ``wait`` and ``restore``; rank 0 writes, every rank
    reads (the directory is shared)."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 async_save: bool = True) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.async_save = bool(async_save)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- save ---------------------------------------------------------------
    def _sections(self, trainer) -> Dict[str, Any]:
        """The trainer's trees at global shapes (a collective under ZeRO-1)."""
        gathered = getattr(trainer, "gathered_updater_state", None)
        return {
            "params": trainer.params,
            "opt_state": gathered() if callable(gathered) else trainer.opt_state,
            "state": trainer.state,
            # strategy state (thresholds, residuals) must survive a restart,
            # or compressed sync resumes cold
            "strat_state": getattr(trainer, "strat_state", {}),
        }

    def save(self, step: int, trainer: Any, *, extra: Optional[Dict] = None) -> None:
        """Checkpoint a DistributedTrainer-like object (``params``,
        ``opt_state``, ``state``, ``iteration``), a ``Solver``, or a bare
        tree of tensors."""
        self.wait_write()
        if _is_solver(trainer):
            trainer = _SolverView(trainer)
        if hasattr(trainer, "params"):
            sections = self._sections(trainer)
            meta: Dict[str, Any] = {"iteration": int(getattr(trainer, "iteration", step))}
            if hasattr(trainer, "zero1"):
                meta["zero1"] = bool(trainer.zero1)
            if hasattr(trainer, "n_data_shards"):
                meta["data_axis"] = int(trainer.n_data_shards)
            if hasattr(trainer, "n_stages"):  # pipeline-parallel layout
                meta["pipeline_stages"] = int(trainer.n_stages)
            model = getattr(trainer, "model", None)
            rng = getattr(model, "_rng", None)
            if rng is not None:  # resume the exact dropout stream
                st = rng.state_dict()
                meta["rng_seed"], meta["rng_count"] = int(st["seed"]), int(st["count"])
            conf = getattr(model, "conf", None)
        else:
            sections = {"params": trainer}
            meta, conf = {}, None
        if extra:
            meta.update(extra)
        flat: Dict[str, Any] = {}
        layout: Dict[str, List] = {}
        for name, tree in sections.items():
            part = _flatten(tree, name, {})
            layout[name] = [[k, list(getattr(v, "shape", ()))] for k, v in part.items()]
            flat.update(part)
        meta["layout"] = layout
        host = {k: _as_saved(v) for k, v in flat.items()}  # landed before training goes on
        if _rank() != 0:
            return
        conf_json = to_json(conf) if conf is not None else None
        if self.async_save:
            self._writer = threading.Thread(target=self._write, args=(step, host, meta, conf_json),
                                            name="orbax-checkpoint-writer", daemon=True)
            self._writer.start()
        else:
            self._write(step, host, meta, conf_json)
            self._raise_error()

    def _write(self, step: int, host: Dict[str, torch.Tensor], meta: dict,
               conf_json: Optional[str]) -> None:
        try:
            path = os.path.join(self.directory, str(int(step)))
            if os.path.isdir(path):
                shutil.rmtree(path)
            _dcp().save(host, checkpoint_id=path, no_dist=True)
            tmp = os.path.join(path, _META + ".tmp")
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, os.path.join(path, _META))
            if conf_json is not None:
                # the config-JSON sidecar (rank 0 only: ranks must not race it)
                tmp = os.path.join(self.directory, "configuration.json.tmp")
                with open(tmp, "w") as f:
                    f.write(conf_json)
                os.replace(tmp, os.path.join(self.directory, "configuration.json"))
            for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        except BaseException as e:  # raised on the caller's thread by wait()
            self._error = e

    def _raise_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write under {self.directory} failed") from err

    def wait_write(self) -> None:
        """Join this rank's write in flight, if any (no collective)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_error()

    def wait(self) -> None:
        """Join any in-flight async save; every rank calls it, and on return
        the checkpoint is on disk for all of them."""
        self.wait_write()
        _barrier()

    # ---- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """The finished steps, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, _META)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _meta(self, step: int) -> dict:
        with open(os.path.join(self.directory, str(int(step)), _META)) as f:
            return json.load(f)

    @staticmethod
    def _meta_hint(meta: dict) -> str:
        hint = (f"saved zero1={meta.get('zero1')}, data_axis={meta.get('data_axis')}, "
                f"iteration={meta.get('iteration')}")
        if meta.get("pipeline_stages"):
            hint += f", pipeline_stages={meta['pipeline_stages']}"
        return hint

    def _read(self, step: int, template: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Fill ``template`` (host tensors at the saved shapes) from ``step``."""
        path = os.path.join(self.directory, str(int(step)))
        try:
            _dcp().load(template, checkpoint_id=path, no_dist=True)
        except Exception as e:
            raise ValueError(f"checkpoint step {step} under {self.directory} does not match "
                             f"the live trainer's structure: {e}") from e
        return template

    def restore(self, trainer: Any, step: Optional[int] = None) -> Dict:
        """Restore in place onto the trainer: parameters copied into the
        live ones, the state, the updater state cut to this rank's ZeRO-1
        slices (``load_updater_state``), the strategy state, the iteration
        and the dropout stream. Returns the step's meta.

        **Layout independence (ZeRO-1):** arrays are saved at global shapes,
        so a checkpoint of a ``zero1=True`` trainer restores into a
        replicated one and the other way round, at any data-axis width. A
        different structure (model, updater or strategy) fails with a clear
        ``ValueError``.

        **Strategy-state migration:** ``strat_state`` keys are reconciled by
        name: keys both sides keep are restored, keys only the live
        strategy has keep their fresh values, and saved keys the live
        strategy lacks are not read (so a threshold-compressed checkpoint
        resumes under top-k with its residuals)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        meta = self._meta(step)
        layout = meta.get("layout", {})
        if _is_solver(trainer):
            trainer = _SolverView(trainer)
        if not hasattr(trainer, "params"):
            flat = _flatten(trainer, "params", {})
            tmpl = {k: torch.empty(tuple(v.shape), dtype=v.dtype) for k, v in flat.items()}
            got = self._read(step, tmpl)
            return _unflatten(trainer, "params", got)
        hint = self._meta_hint(meta)
        gathered = getattr(trainer, "gathered_updater_state", None)
        live = {
            "params": trainer.params,
            "opt_state": gathered() if callable(gathered) else trainer.opt_state,
            "state": trainer.state,
        }
        tmpl: Dict[str, torch.Tensor] = {}
        for name, tree in live.items():
            part = _flatten(tree, name, {})
            if name in layout:
                _check_section_compat(name, [(k, tuple(getattr(v, "shape", ())))
                                             for k, v in part.items()],
                                      [(k, tuple(s)) for k, s in layout[name]], step, hint)
            tmpl.update({k: _template_leaf(v) for k, v in part.items()})
        live_ss = getattr(trainer, "strat_state", {})
        saved_ss = {k for k, _ in layout.get("strat_state", [])}
        ss_part = {k: v for k, v in _flatten(live_ss, "strat_state", {}).items()
                   if k in saved_ss}
        tmpl.update({k: _template_leaf(v) for k, v in ss_part.items()})
        got = self._read(step, tmpl)
        prop = getattr(type(trainer), "params", None)
        if isinstance(prop, property) and prop.fset is not None:
            # a trainer that installs a global tree itself (the pipeline
            # trainer keeps only its own stage's blocks)
            trainer.params = _unflatten(live["params"], "params",
                                        _placed(got, _flatten(live["params"], "params", {})))
        else:
            with torch.no_grad():
                for k, v in _flatten(live["params"], "params", {}).items():
                    v.copy_(got[k].to(device=v.device, dtype=v.dtype))
        trainer.state = _unflatten(trainer.state, "state",
                                   _placed(got, _flatten(trainer.state, "state", {})))
        opt = _unflatten(live["opt_state"], "opt_state",
                         _placed(got, _flatten(live["opt_state"], "opt_state", {})))
        if hasattr(trainer, "load_updater_state"):
            trainer.load_updater_state(opt)
        else:
            trainer.opt_state = opt
        if ss_part:
            trainer.strat_state = _unflatten(live_ss, "strat_state",
                                             _placed(got, _flatten(live_ss, "strat_state", {})))
        if "iteration" in meta:
            trainer.iteration = int(meta["iteration"])
        model = getattr(trainer, "model", None)
        rng = getattr(model, "_rng", None)
        if rng is not None and "rng_count" in meta:
            rng.load_state_dict({"seed": int(meta.get("rng_seed", rng.seed)),
                                 "count": int(meta["rng_count"])})
        return meta

    def close(self) -> None:
        self.wait_write()


def _template_leaf(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return torch.empty(tuple(v.shape), dtype=v.dtype)
    return torch.tensor(v)


def _placed(got: Dict[str, torch.Tensor], live: Dict[str, Any]) -> Dict[str, Any]:
    """The restored leaves on the live leaves' devices and types (host
    scalars back to Python numbers)."""
    out = {}
    for k, v in live.items():
        if k not in got:
            continue
        if isinstance(v, torch.Tensor):
            out[k] = got[k].to(device=v.device, dtype=v.dtype)
        elif v is not None:
            out[k] = type(v)(got[k].item())
    return out


def _is_solver(obj) -> bool:
    """A single-device ``Solver``: a model and an updater state, no
    trainer surface."""
    return (not hasattr(obj, "params") and hasattr(obj, "model")
            and hasattr(obj, "opt_state") and hasattr(obj, "optim"))


class _SolverView:
    """The trainer surface of a ``Solver``: its model's live params and
    state, its updater state, and the model's iteration count."""

    def __init__(self, solver) -> None:
        self._solver = solver
        self.model = solver.model

    @property
    def params(self):
        return self.model.params

    @property
    def opt_state(self):
        return self._solver.opt_state

    @opt_state.setter
    def opt_state(self, value) -> None:
        self._solver.opt_state = value

    @property
    def state(self):
        return self.model.state

    @state.setter
    def state(self, value) -> None:
        self.model.state = value

    @property
    def iteration(self) -> int:
        return int(self.model.iteration_count)

    @iteration.setter
    def iteration(self, value: int) -> None:
        self.model.iteration_count = int(value)
