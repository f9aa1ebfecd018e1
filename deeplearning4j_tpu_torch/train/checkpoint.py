"""Checkpoint listener and evaluative listener (port of
``deeplearning4j_tpu/train/checkpoint.py``).

Reference: org.deeplearning4j.optimize.listeners.CheckpointListener (every N
iterations, epochs or seconds, keep-last-K, ``lastCheckpoint()``) and
EvaluativeListener.

With ``async_save=True`` the step thread only SNAPSHOTS the training state
into host memory; a bounded background writer serializes it, fsyncs it and
flips ``lastCheckpoint.json``, so the zip's deflate is off the step's
critical path. Crash consistency: the pointer only ever names a fully
fsynced artifact (zip, then sidecar, then pointer, each atomic through a
temp file, fsync and ``os.replace``), and it only moves FORWARD in
(epoch, iteration) order, so a slow async write never clobbers a newer
preemption save. A failed save (a full disk, an injected
``checkpoint.write`` fault) counts in
``dl4j_tpu_training_checkpoint_failures_total`` and training goes on.

The snapshot is a copy, never a view. The JAX package's ``device_get``
always returns host copies; here ``Tensor.cpu()`` would return the same
tensor for a model on the CPU, and the updater writes its parameters in
place, so the writer would serialize weights that later steps had changed.
Each snapshot copies every parameter, state and updater tensor to the
host with ``to("cpu", copy=True)``: a copy of its own on the CPU, and on
the card a pageable copy that has landed when the call returns. Pinned
buffers filled by queued copies cost the step thread less only when a set
is reused, and a large model's write outlasts the interval between saves,
so each save would allocate a fresh pinned set, which costs more than the
pageable copy (``chip_smoke.py`` times both at GPT-2 small's width).

Each checkpoint zip has a ``.state.json`` sidecar carrying what the zip
cannot: the iteration and epoch counters, the model's dropout stream
position (``model._rng.state_dict()``, ``core/rng.py``) and the data
iterator's cursor (``DataSetIterator.state_dict``).
:func:`restore_training_state` puts them back, so a killed run resumes
BIT-EXACTLY where it stopped. The zip is the JAX package's: either package
restores the other's checkpoints. The RNG position in the sidecar is the
writing package's own (the two packages draw dropout from different
generators), so a cross-package resume is exact only without dropout.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import tempfile
import threading
import time
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.listeners import TrainingListener

# FaultInjector site fired before every checkpoint write (both modes)
CHECKPOINT_WRITE_SITE = "checkpoint.write"

_STATE_SUFFIX = ".state.json"
_POINTER = "lastCheckpoint.json"


def _atomic_write_json(path: str, payload: dict) -> None:
    """tmp + fsync + os.replace: readers never see a torn file, and a
    crash mid-write leaves any existing file untouched."""
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".tmp-",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _fsync_dir(dirname: str) -> None:
    """Durably record a rename in its directory: the pointer flip is only
    complete once the directory entry is on disk."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - some filesystems refuse
        pass
    finally:
        os.close(fd)


def _tensors(tree: Any, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of a nested dict / tuple (optax-style NamedTuple states
    included), in iteration order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (dict, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            _tensors(v, out)
    return out


def _rebuild(tree: Any, it) -> Any:
    """``tree`` with its tensors replaced, in :func:`_tensors` order, by the
    items of ``it``; everything else (step counts) kept."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_rebuild(v, it) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


class _TrainerShim:
    def __init__(self, opt_state: Any) -> None:
        self.opt_state = opt_state


class _ModelSnapshot:
    """Host copies of everything ONE checkpoint write needs, taken on the
    step thread, so the writer never touches the live tensors that the
    next steps update in place. Quacks like the model for ``write_model``
    (``conf``, ``state``, ``_trainer.opt_state``, ``params_flat``)."""

    def __init__(self, model, *, save_updater: bool, dist_trainer: Any = None) -> None:
        self.class_name = type(model).__name__
        self.conf = model.conf
        self._order = model._ravel_order()
        src = dist_trainer if (dist_trainer is not None and getattr(
            dist_trainer, "opt_state", None) is not None) else getattr(model, "_trainer", None)
        opt_state = src.opt_state if (save_updater and src is not None) else None
        trees = ({l: dict(lp) for l, lp in model.params.items()}, model.state, opt_state)
        copies = [t.detach().to("cpu", copy=True) for t in _tensors(trees, [])]
        self.params, self.state, opt = _rebuild(trees, iter(copies))
        self._trainer = _TrainerShim(opt) if opt is not None else None

    def _check_init(self) -> None:
        pass

    def params_flat(self) -> np.ndarray:
        parts = [self.params[l][p].reshape(-1) for l, p in self._order]
        if not parts:
            return np.zeros((0,), np.float32)
        flat = torch.cat(parts)
        if flat.dtype == torch.bfloat16:  # numpy has no bfloat16
            flat = flat.float()
        return flat.numpy()


class CheckpointListener(TrainingListener):
    def __init__(
        self,
        directory: str,
        save_every_n_iterations: Optional[int] = None,
        save_every_n_epochs: Optional[int] = None,
        save_every_n_seconds: Optional[float] = None,
        keep_last: Optional[int] = None,
        save_updater: bool = True,
        log_fn=None,
        trainer: Optional[Any] = None,
        *,
        async_save: bool = False,
        iterator: Optional[Any] = None,
        registry=None,
        max_pending_writes: int = 2,
    ) -> None:
        """``trainer=`` takes any object with ``sync_to_model()``,
        ``model`` and ``opt_state`` (the JAX package's DistributedTrainer;
        the port's comes with distributed training): each save first
        writes the trainer's state back onto the model, and the zip carries
        the trainer's updater state.

        ``async_save=True`` moves serialization and fsync off the step
        thread: the step pays the host snapshot, a bounded daemon writer
        does the rest. At most ``max_pending_writes`` snapshots queue; an
        older unwritten snapshot is superseded (dropped) by a newer one.

        ``iterator=`` attaches the training data iterator; its
        ``state_dict()`` (consumer cursor) rides in the ``.state.json``
        sidecar.

        Neither save mode raises out of ``iteration_done``: a failed write
        is counted and training continues (the previous checkpoint and
        pointer stay intact)."""
        if not (save_every_n_iterations or save_every_n_epochs or save_every_n_seconds):
            raise ValueError("Configure at least one save frequency")
        if max_pending_writes < 1:
            raise ValueError(
                f"max_pending_writes must be >= 1, got {max_pending_writes}")
        from ..obs.metrics import get_registry

        self.trainer = trainer
        self.directory = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.every_seconds = save_every_n_seconds
        self.keep_last = keep_last
        self.save_updater = save_updater
        self.log_fn = log_fn
        self.async_save = bool(async_save)
        self.iterator = iterator
        self.max_pending_writes = int(max_pending_writes)
        self._last_save_time = time.time()
        os.makedirs(directory, exist_ok=True)
        # checkpoints from before a restart count against keep_last too;
        # _saved holds ((epoch, iteration), path), and pruning evicts the
        # LOWEST key, never the pointer's target
        self._saved: List[Tuple[Tuple[int, int], str]] = sorted(
            (key, p) for p in glob.glob(
                os.path.join(directory, "checkpoint_iter*.zip"))
            if (key := self._ckpt_key(p)) is not None)
        # a kill mid-write leaves a writer's temp file behind; the pointer
        # never names it, so it is debris: sweep it on start
        for debris in glob.glob(os.path.join(directory, ".tmp-*")):
            try:
                os.remove(debris)
            except OSError:
                pass
        self._ptr_lock = threading.RLock()
        self._last_ptr: Optional[Tuple[int, int]] = None
        self._q: collections.deque = collections.deque()
        self._q_cond = threading.Condition()
        self._writer: Optional[threading.Thread] = None
        self._writer_stop = False
        self._inflight = False
        reg = registry if registry is not None else get_registry()
        self._c_saves = reg.counter(
            "dl4j_tpu_training_checkpoint_saves_total",
            "Completed checkpoint writes (pointer flipped)", ("mode",))
        self._c_failures = reg.counter(
            "dl4j_tpu_training_checkpoint_failures_total",
            "Checkpoint writes that failed (training continued; the "
            "previous checkpoint remains the resume point)")
        self._h_write = reg.histogram(
            "dl4j_tpu_training_checkpoint_write_seconds",
            "Serialization + fsync + pointer-flip duration per checkpoint")
        self._g_pending = reg.gauge(
            "dl4j_tpu_training_checkpoint_pending_writes",
            "Snapshots queued or in flight on the async writer")
        #: seconds each save spent on the step thread taking its snapshot
        self.snapshot_seconds: List[float] = []
        #: seconds each completed write took (serialize, fsync, pointer)
        self.write_seconds: List[float] = []

    @staticmethod
    def _ckpt_key(path: str) -> Optional[Tuple[int, int]]:
        """(epoch, iteration) parsed from a checkpoint filename: the
        recency order that pruning and the pointer rule share."""
        m = re.match(r"checkpoint_iter(\d+)_epoch(\d+)\.zip$",
                     os.path.basename(path))
        return (int(m.group(2)), int(m.group(1))) if m else None

    # ----- snapshot (step thread) --------------------------------------
    def _snapshot(self, model, iteration: int, epoch: int,
                  score: float = float("nan")) -> dict:
        t0 = time.perf_counter()
        if self.trainer is not None:
            self.trainer.sync_to_model()
            model = self.trainer.model
        snap = _ModelSnapshot(model, save_updater=self.save_updater, dist_trainer=self.trainer)
        sidecar = {
            "iteration": iteration,
            "epoch": epoch,
            "model_iteration_count": getattr(model, "iteration_count", iteration),
            "model_epoch_count": getattr(model, "epoch_count", epoch),
            "score": None if score != score else float(score),
            "time": time.time(),
        }
        rng = getattr(model, "_rng", None)
        if rng is not None and hasattr(rng, "state_dict"):
            sidecar["rng"] = rng.state_dict()
        if self.iterator is not None:
            try:
                sidecar["iterator"] = self.iterator.state_dict()
            except NotImplementedError:
                sidecar["iterator"] = None
        self.snapshot_seconds.append(time.perf_counter() - t0)
        return {"model": snap, "iteration": iteration, "epoch": epoch,
                "sidecar": sidecar}

    # ----- write (background thread in async mode) ---------------------
    def _write(self, job: dict, mode: str) -> bool:
        from ..core.resilience import get_fault_injector
        from ..model.serializer import write_model

        t0 = time.perf_counter()
        iteration, epoch = job["iteration"], job["epoch"]
        fname = os.path.join(
            self.directory, f"checkpoint_iter{iteration}_epoch{epoch}.zip")
        snap: _ModelSnapshot = job["model"]
        try:
            get_fault_injector().fire(CHECKPOINT_WRITE_SITE)
            write_model(snap, fname, save_updater=snap._trainer is not None,
                        class_name=snap.class_name)
            state_name = fname[: -len(".zip")] + _STATE_SUFFIX
            _atomic_write_json(state_name, job["sidecar"])
            with self._ptr_lock:
                # forward-only: a stale queued async write must never move
                # the pointer back past a newer (e.g. preemption) save
                key = (epoch, iteration)
                if self._last_ptr is None or key >= self._last_ptr:
                    _atomic_write_json(
                        os.path.join(self.directory, _POINTER),
                        {"iteration": iteration, "epoch": epoch,
                         "time": time.time(),
                         "file": os.path.basename(fname),
                         "state": os.path.basename(state_name)})
                    _fsync_dir(self.directory)
                    self._last_ptr = key
                self._saved.append((key, fname))
                self._saved.sort()
                if self.keep_last is not None:
                    # evict the lowest (epoch, iteration) first and never
                    # the pointer's target
                    keep = []
                    excess = len(self._saved) - self.keep_last
                    for k, old in self._saved:
                        if excess > 0 and k != self._last_ptr:
                            excess -= 1
                            for victim in (old,
                                           old[: -len(".zip")] + _STATE_SUFFIX):
                                if os.path.exists(victim):
                                    os.remove(victim)
                        else:
                            keep.append((k, old))
                    self._saved = keep
            self._c_saves.labels(mode).inc()
            seconds = time.perf_counter() - t0
            self._h_write.observe(seconds)
            self.write_seconds.append(seconds)
            if self.log_fn:
                self.log_fn(f"Saved checkpoint: {fname}")
            return True
        except BaseException as e:  # keep training: count, clean up, go on
            self._c_failures.inc()
            try:
                if os.path.exists(fname):
                    os.remove(fname)
            except OSError:
                pass
            msg = f"checkpoint save failed ({fname}): {type(e).__name__}: {e}"
            if self.log_fn:
                self.log_fn(msg)
            else:
                warnings.warn(msg, stacklevel=2)
            return False

    def _enqueue(self, job: dict) -> None:
        with self._q_cond:
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, name="ckpt-writer", daemon=True)
                self._writer.start()
            while len(self._q) >= self.max_pending_writes:
                self._q.popleft()  # superseded by the newer snapshot
            self._q.append(job)
            self._g_pending.set(len(self._q) + (1 if self._inflight else 0))
            self._q_cond.notify_all()

    def _writer_loop(self) -> None:
        while True:
            with self._q_cond:
                while not self._q and not self._writer_stop:
                    self._q_cond.wait(0.2)
                if not self._q and self._writer_stop:
                    return
                job = self._q.popleft()
                self._inflight = True
                self._g_pending.set(len(self._q) + 1)
            try:
                self._write(job, "async")
            finally:
                with self._q_cond:
                    self._inflight = False
                    self._g_pending.set(len(self._q))
                    self._q_cond.notify_all()

    def flush(self, timeout: float = 60.0) -> bool:
        """Wait until every queued async write has completed (or failed).
        True when the queue drained inside ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._q_cond:
            while self._q or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._q_cond.wait(min(0.2, remaining))
        return True

    def close(self, timeout: float = 60.0) -> None:
        """Drain pending writes and stop the writer thread. Idempotent."""
        self.flush(timeout)
        with self._q_cond:
            self._writer_stop = True
            self._q_cond.notify_all()
            t = self._writer
        if t is not None:
            t.join(timeout=timeout)
        with self._q_cond:
            self._writer = None
            self._writer_stop = False

    # ----- triggers -----------------------------------------------------
    def _save(self, model, iteration: int, epoch: int,
              score: float = float("nan")) -> None:
        self._last_save_time = time.time()
        try:
            job = self._snapshot(model, iteration, epoch, score)
        except BaseException as e:  # a snapshot failure must not kill fit
            self._c_failures.inc()
            msg = f"checkpoint snapshot failed: {type(e).__name__}: {e}"
            if self.log_fn:
                self.log_fn(msg)
            else:
                warnings.warn(msg, stacklevel=2)
            return
        if self.async_save:
            self._enqueue(job)
        else:
            self._write(job, "sync")

    def save_now(self, model, iteration: Optional[int] = None,
                 epoch: Optional[int] = None,
                 score: float = float("nan")) -> bool:
        """Force a SYNCHRONOUS checkpoint of the current state (the
        preemption path: the final save must be durable before exit).
        True when the write completed and the pointer names it. The
        forward-only pointer rule makes this safe next to a still-draining
        async writer."""
        if iteration is None:
            iteration = getattr(model, "iteration_count", 0)
        if epoch is None:
            epoch = getattr(model, "epoch_count", 0)
        self._last_save_time = time.time()
        try:
            job = self._snapshot(model, iteration, epoch, score)
        except BaseException:
            self._c_failures.inc()
            return False
        ok = self._write(job, "sync")
        self.flush(timeout=10.0)  # let stragglers lose to the pointer rule
        return ok

    def iteration_done(self, model: Any, iteration: int, epoch: int, score: float) -> None:
        # the two triggers are independent; iteration 0 is the pre-step
        # state and never saved
        due = bool(self.every_iter and iteration > 0
                   and iteration % self.every_iter == 0)
        if (not due and self.every_seconds
                and (time.time() - self._last_save_time) >= self.every_seconds):
            due = True
        if due:
            self._save(model, iteration, epoch, score)

    def on_epoch_end(self, model: Any) -> None:
        if self.every_epoch and (model.epoch_count + 1) % self.every_epoch == 0:
            self._save(model, model.iteration_count, model.epoch_count)

    @staticmethod
    def last_checkpoint(directory: str) -> Optional[str]:
        """Resume helper (reference: lastCheckpoint())."""
        meta_path = os.path.join(directory, _POINTER)
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        path = os.path.join(directory, meta["file"])
        return path if os.path.exists(path) else None

    @staticmethod
    def last_checkpoint_state(directory: str) -> Optional[dict]:
        """The ``.state.json`` sidecar of the pointed-at checkpoint
        (counters, RNG stream, iterator cursor), or None for a checkpoint
        without one, or no checkpoint."""
        meta_path = os.path.join(directory, _POINTER)
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        state_name = meta.get("state")
        if state_name is None:
            return None
        state_path = os.path.join(directory, state_name)
        if not os.path.exists(state_path):
            return None
        with open(state_path) as f:
            return json.load(f)


def restore_training_state(model, state: Optional[dict],
                           iterator: Optional[Any] = None,
                           trainer: Optional[Any] = None) -> None:
    """Put the sidecar's state back onto a restored model (and optionally a
    freshly built, identically configured data iterator): the iteration and
    epoch counters, the RNG stream position and the iterator's cursor.
    Training then consumes exactly the batches the killed run never did,
    with the killed run's dropout draws.

    ``trainer=`` takes an object with ``load_updater_state(opt_state)``
    and an ``iteration`` counter (the JAX package's DistributedTrainer):
    it gets the restored model's updater state and the model's iteration
    count."""
    if state is None:
        return
    model.iteration_count = int(state.get(
        "model_iteration_count", state.get("iteration", 0)))
    model.epoch_count = int(state.get(
        "model_epoch_count", state.get("epoch", 0)))
    rng_state = state.get("rng")
    rng = getattr(model, "_rng", None)
    if rng_state is not None and rng is not None:
        rng.load_state_dict(rng_state)
    if iterator is not None and state.get("iterator") is not None:
        iterator.load_state_dict(state["iterator"])
    if trainer is not None:
        host_opt = getattr(getattr(model, "_trainer", None),
                           "opt_state", None)
        if host_opt is not None and hasattr(trainer, "load_updater_state"):
            trainer.load_updater_state(host_opt)
        if hasattr(trainer, "iteration"):
            trainer.iteration = model.iteration_count


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator (reference: EvaluativeListener)."""

    def __init__(self, test_data, frequency: int = 100, log_fn=print) -> None:
        self.test_data = test_data
        self.frequency = frequency
        self.log_fn = log_fn
        self.history: List[float] = []

    def iteration_done(self, model: Any, iteration: int, epoch: int, score: float) -> None:
        if iteration % self.frequency != 0:
            return
        ev = model.evaluate(self.test_data)
        self.history.append(ev.accuracy())
        if self.log_fn:
            self.log_fn(f"iter {iteration}: eval accuracy {ev.accuracy():.4f}")
