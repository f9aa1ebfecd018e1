"""Versioned model registry, zero-downtime hot-swap, and canary serving
(port of ``deeplearning4j_tpu/serving``, with its export list).

The production-serving subsystem between training and the HTTP edge:

* :class:`~.store.ModelStore` — versioned on-disk artifact store over
  ``model/serializer.py``: monotonic version ids, atomic publish,
  SHA-256 manifests verified on load, ``resolve("latest")``/pinned
  lookup, retention GC.
* :class:`~.manager.ModelManager` — load → warm → atomic swap →
  probation → automatic rollback (warmup failure or circuit-breaker
  open), plus canary/shadow rollout on a second engine.
* :class:`~.router.ModelRouter` — deterministic hash-split canary
  routing and fail-open shadow mirroring.
* :class:`~.multiplex.ModelMultiplexer` — multi-tenant weight paging:
  N registered models behind one submit surface on a fixed byte budget
  (LRU + request-rate-EWMA eviction via ``ModelManager.park()``,
  per-tenant SLO admission, bounded cold-start page-in queueing) plus
  :class:`~.multiplex.PoolAutoscaler` for load-driven replica counts.
* :mod:`~.disagg` — disaggregated prefill/decode: the prefill tier, the
  handoff wire format (shared with the JAX package) and the front-tier
  coordinator.

``remote/JsonModelServer`` exposes managed models over HTTP
(``GET /v1/models``, ``POST /v1/models/<name>``, ``X-Model-Version``
pinning); ``tests/test_torch_model_serving.py`` holds the publish →
resolve → swap → rollback contract against the JAX package.
"""

from .disagg import (
    DisaggCoordinator,
    PartialHandoffError,
    PrefillEngine,
    deserialize_handoff,
    serialize_handoff,
)
from .manager import (
    LOAD_SITE,
    WARMUP_SITE,
    ModelManager,
    ModelParkedError,
    SwapError,
)
from .multiplex import ModelMultiplexer, PoolAutoscaler, model_bytes
from .router import ModelRouter
from .store import (
    LATEST,
    ChecksumMismatchError,
    ModelStore,
    ModelStoreError,
    ModelVersion,
    VersionNotFoundError,
)

__all__ = [
    "LATEST",
    "LOAD_SITE",
    "WARMUP_SITE",
    "ChecksumMismatchError",
    "DisaggCoordinator",
    "ModelManager",
    "ModelMultiplexer",
    "ModelParkedError",
    "ModelRouter",
    "ModelStore",
    "ModelStoreError",
    "ModelVersion",
    "PartialHandoffError",
    "PoolAutoscaler",
    "PrefillEngine",
    "SwapError",
    "VersionNotFoundError",
    "deserialize_handoff",
    "model_bytes",
    "serialize_handoff",
]
