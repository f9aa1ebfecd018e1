"""Deterministic traffic splitting for canary rollout + shadow mirroring
(a copy of ``deeplearning4j_tpu/serving/router.py``, which uses no
framework: the same key, salt and weight pick the same arm in both
packages).

A canary must receive a *stable* slice of traffic: the same request key
always lands on the same side (users don't flap between model versions,
and an incident is attributable to the version that served it). The
router therefore hashes the request key — not a random draw — into
``granularity`` buckets and sends the lowest ``weight``-fraction to the
canary; keyless requests hash their own payload bytes, which keeps the
split deterministic for replayed traffic too.

Shadow mode mirrors every request to the shadow backend and ignores the
result (errors included): the candidate sees production traffic and
fills its metrics/latency histograms, while responses keep coming from
the primary. Mirroring is fail-open — a shed/open/broken shadow never
affects a live response.

Backends are anything with ``output_async(x, timeout=, deadline=)`` and
``model_version`` — i.e. :class:`~deeplearning4j_tpu_torch.parallel.inference.
ParallelInference` engines.
"""

from __future__ import annotations

import hashlib
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np

from ..obs.metrics import MetricsRegistry, get_registry

PRIMARY = "primary"
CANARY = "canary"
SHADOW = "shadow"


def _hash_bucket(key: bytes, salt: str, granularity: int) -> int:
    h = hashlib.sha256(salt.encode() + key).digest()
    return int.from_bytes(h[:8], "big") % granularity


class ModelRouter:
    def __init__(self, primary, *, canary=None, canary_weight: float = 0.0,
                 shadow=None, salt: str = "", granularity: int = 10_000,
                 name: str = "router",
                 registry: Optional[MetricsRegistry] = None) -> None:
        if not 0.0 <= canary_weight <= 1.0:
            raise ValueError(f"canary_weight must be in [0, 1], "
                             f"got {canary_weight}")
        if canary is None and canary_weight > 0.0:
            raise ValueError("canary_weight > 0 without a canary backend")
        self.primary = primary
        self.canary = canary
        self.canary_weight = float(canary_weight)
        self.shadow = shadow
        self.salt = salt
        self.granularity = int(granularity)
        self.name = name
        reg = registry if registry is not None else get_registry()
        routes = reg.counter(
            "dl4j_tpu_serving_routes_total",
            "Routing decisions (shadow counts mirrored submissions)",
            ("router", "target"))
        self._c = {t: routes.labels(name, t)
                   for t in (PRIMARY, CANARY, SHADOW)}

    # ----- decision ----------------------------------------------------
    def _key_bytes(self, x, key: Optional[str]) -> bytes:
        if key is not None:
            return str(key).encode()
        return np.ascontiguousarray(x).tobytes()

    def assign(self, x, *, key: Optional[str] = None) -> str:
        """``"primary"`` or ``"canary"`` for this request — pure function
        of (key|payload, salt, weight)."""
        if self.canary is None or self.canary_weight <= 0.0:
            return PRIMARY
        bucket = _hash_bucket(self._key_bytes(x, key), self.salt,
                              self.granularity)
        if bucket < self.canary_weight * self.granularity:
            return CANARY
        return PRIMARY

    # ----- request path -------------------------------------------------
    def _mirror(self, x, timeout) -> None:
        """Fire-and-forget shadow submission; never raises."""
        try:
            fut = self.shadow.output_async(np.array(x, copy=True),
                                           timeout=timeout)
        except Exception:
            return
        self._c[SHADOW].inc()
        fut.add_done_callback(lambda f: f.exception())  # swallow

    def submit(self, x, *, key: Optional[str] = None,
               timeout: Optional[float] = None,
               deadline=None,
               priority: Optional[str] = None) -> Tuple[Future, str, str]:
        """Route one request. Returns ``(future, target, version)`` where
        ``target`` is ``"primary"``/``"canary"`` and ``version`` the
        model version of the backend that owns the response.
        ``priority`` is forwarded to the backend's admission controller."""
        x = np.asarray(x)
        if self.shadow is not None:
            self._mirror(x, timeout)
        target = self.assign(x, key=key)
        backend = self.canary if target == CANARY else self.primary
        # only forward priority when set: the documented backend duck
        # type is output_async(x, timeout=, deadline=)
        kw = {} if priority is None else {"priority": priority}
        fut = backend.output_async(x, timeout=timeout, deadline=deadline,
                                   **kw)
        self._c[target].inc()
        return fut, target, backend.model_version

    def output(self, x, *, key: Optional[str] = None,
               timeout: Optional[float] = None) -> np.ndarray:
        fut, _, _ = self.submit(x, key=key, timeout=timeout)
        return fut.result()
