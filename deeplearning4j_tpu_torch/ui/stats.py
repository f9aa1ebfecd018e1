"""StatsListener + StatsStorage (port of ``deeplearning4j_tpu/ui/stats.py``).

Reference: org.deeplearning4j.ui.model.stats.StatsListener streaming typed
payloads (score, param/gradient/update histograms and norms, update:param
ratios, runtime info) into a StatsStorage (in-memory or MapDB file) that
the dashboard reads (SURVEY.md §5.5). The update:param ratio is DL4J's
signature learning-rate debugging aid — kept intact.

The records' keys and histogram layout are the JAX package's, so a
``FileStatsStorage`` file written by one package reads in the other. The
listener copies params and gradients to the host on its full-stat
iterations only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.listeners import TrainingListener


def _host(arr) -> np.ndarray:
    """A host copy of ``arr`` (a tensor on any device, or an array): the
    params are updated in place, so a CPU tensor's numpy view would follow
    them; bfloat16 widens to float32, which numpy lacks."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach()
        dtype = torch.float32 if arr.dtype == torch.bfloat16 else arr.dtype
        return arr.to("cpu", dtype, copy=True).numpy()
    return np.array(arr)


def _tensor_stats(arr: np.ndarray, bins: int) -> Dict[str, Any]:
    flat = np.asarray(arr, np.float32).reshape(-1)
    # Divergence (NaN/Inf params or grads) is exactly what this dashboard
    # exists to diagnose — record it instead of letting np.histogram raise
    # from inside the listener and kill the run.
    finite = flat[np.isfinite(flat)]
    nonfinite = int(flat.size - finite.size)
    if finite.size == 0:
        finite = np.zeros(1, np.float32)
    counts, edges = np.histogram(finite, bins=bins)
    out = {
        "mean": float(finite.mean()),
        "std": float(finite.std()),
        "norm": float(np.linalg.norm(finite)),
        "mean_magnitude": float(np.abs(finite).mean()),
        "histogram": {"min": float(edges[0]), "max": float(edges[-1]),
                      "counts": counts.tolist()},
    }
    if nonfinite:
        out["nonfinite_count"] = nonfinite
    return out


class StatsStorage:
    """SPI: ordered stream of JSON-able stat records per session."""

    def put(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError

    def records(self, session_id: Optional[str] = None) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def session_ids(self) -> List[str]:
        return sorted({r.get("session", "") for r in self.records()})

    def scores(self, session_id: Optional[str] = None) -> List[float]:
        return [r["score"] for r in self.records(session_id)
                if "score" in r]

    def update_ratios(self, param_name: str,
                      session_id: Optional[str] = None) -> List[float]:
        """The update:param-ratio trajectory for one parameter — the
        dashboard's headline chart."""
        out = []
        for r in self.records(session_id):
            ratio = r.get("update_ratios", {}).get(param_name)
            if ratio is not None:
                out.append(ratio)
        return out


class InMemoryStatsStorage(StatsStorage):
    def __init__(self) -> None:
        self._records: List[Dict[str, Any]] = []

    def put(self, record: Dict[str, Any]) -> None:
        self._records.append(record)

    def records(self, session_id=None):
        if session_id is None:
            return list(self._records)
        return [r for r in self._records if r.get("session") == session_id]


class FileStatsStorage(StatsStorage):
    """JSONL file storage (reference: FileStatsStorage over MapDB). One
    record per line; readable with pandas/jq while training runs."""

    def __init__(self, path: str) -> None:
        self.path = path
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self._fh = None

    def put(self, record: Dict[str, Any]) -> None:
        # persistent handle + per-line flush: records flow every iteration;
        # an open/close syscall pair per step would stall the dispatch
        # pipeline the listeners docstring warns about
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def records(self, session_id=None):
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                r = json.loads(line)
                if session_id is None or r.get("session") == session_id:
                    out.append(r)
        return out


class StatsListener(TrainingListener):
    """Collects per-iteration stats into a StatsStorage.

    ``update_frequency`` controls how often the expensive pytree stats
    (histograms over params/grads/updates) materialize; score-only records
    flow every iteration.
    """

    requires_arrays = True

    def __init__(self, storage: StatsStorage, *, session_id: str = "default",
                 update_frequency: int = 10, histogram_bins: int = 20) -> None:
        self.storage = storage
        self.session_id = session_id
        self.update_frequency = max(1, update_frequency)
        self.histogram_bins = histogram_bins
        self._prev_params: Optional[Dict[str, np.ndarray]] = None
        self._last_grads: Optional[Dict[str, Any]] = None
        self._start = time.time()

    # flatten {layer: {param: arr}} → {"layer/param": arr}
    @staticmethod
    def _flatten(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
        flat: Dict[str, np.ndarray] = {}
        for lname, lparams in (tree or {}).items():
            if isinstance(lparams, dict):
                for pname, arr in lparams.items():
                    flat[f"{lname}/{pname}"] = _host(arr)
            else:
                flat[str(lname)] = _host(lparams)
        return flat

    def on_gradient_calculation(self, model: Any, gradients: Any) -> None:
        self._last_grads = gradients

    def iteration_done(self, model: Any, iteration: int, epoch: int,
                       score: float) -> None:
        record: Dict[str, Any] = {
            "session": self.session_id,
            "iteration": iteration,
            "epoch": epoch,
            "score": float(score),
            "wallclock_s": time.time() - self._start,
        }
        if iteration % self.update_frequency == 0:
            params = self._flatten(getattr(model, "params", {}))
            record["params"] = {k: _tensor_stats(v, self.histogram_bins)
                                for k, v in params.items()}
            if self._last_grads is not None:
                grads = self._flatten(self._last_grads)
                record["gradients"] = {
                    k: _tensor_stats(v, self.histogram_bins)
                    for k, v in grads.items()}
            if self._prev_params is not None:
                updates = {k: params[k] - self._prev_params[k]
                           for k in params if k in self._prev_params
                           and params[k].shape == self._prev_params[k].shape}
                record["updates"] = {k: _tensor_stats(v, self.histogram_bins)
                                     for k, v in updates.items()}
                record["update_ratios"] = {
                    k: float(np.abs(u).mean()
                             / max(np.abs(params[k]).mean(), 1e-12))
                    for k, u in updates.items()}
            self._prev_params = params
        self.storage.put(record)
