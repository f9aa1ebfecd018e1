"""Process-level environment and flag tiers (port of
``deeplearning4j_tpu/core/env.py``).

The reference's three config tiers:
  (a) per-model config  -> the dataclass config DSL (core/config.py)
  (b) process flags     -> ``ND4JSystemProperties`` / ``ND4JEnvironmentVars``
                           -> the environment variables of :data:`ENV_VARS`
  (c) runtime mutable   -> ``Nd4j.getEnvironment()`` -> the
                           :class:`Environment` singleton here.

The JAX package forwards two flags to ``jax.config``. Here each takes the
nearest PyTorch meaning, said in its method's docstring.

``allow_helpers`` (``DL4J_TPU_HELPERS=0``) gates only the ``helper`` of an
:class:`~deeplearning4j_tpu_torch.core.registry.OpDef`, as in the JAX
package. It does not reroute the attention or grouped-matmul kernels: on a
CUDA tensor they launch their kernel or raise, whatever this flag says.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

# Tier (b): environment variables understood by the framework, with the JAX
# package's names and meanings.
ENV_VARS = {
    "DL4J_TPU_DTYPE": "default floating dtype: float32|bfloat16|float64",
    "DL4J_TPU_DEBUG": "1 enables debug mode (per-op logging)",
    "DL4J_TPU_VERBOSE": "1 enables verbose mode",
    "DL4J_TPU_DETERMINISTIC": "1 requests deterministic reductions",
    "DL4J_TPU_HELPERS": "0 disables accelerated (pallas) helpers",
    "DL4J_TPU_NAN_PANIC": "1 enables NaN checking on op outputs",
    "DL4J_TPU_PROFILING": "1 enables the op profiler",
    "DL4J_TPU_LOG_INIT": "0 silences backend init logging",
}


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "false", "False", "")


class Environment:
    """Runtime-mutable global flags (tier c), the singleton behind
    :func:`get_environment` (the reference's ``Nd4j.getEnvironment()``)."""

    _instance: Optional["Environment"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self.debug: bool = _env_flag("DL4J_TPU_DEBUG", False)
        self.verbose: bool = _env_flag("DL4J_TPU_VERBOSE", False)
        self.deterministic: bool = _env_flag("DL4J_TPU_DETERMINISTIC", False)
        self.allow_helpers: bool = _env_flag("DL4J_TPU_HELPERS", True)
        self.nan_panic: bool = _env_flag("DL4J_TPU_NAN_PANIC", False)
        self.inf_panic: bool = False
        self.profiling: bool = _env_flag("DL4J_TPU_PROFILING", False)
        self.log_initialization: bool = _env_flag("DL4J_TPU_LOG_INIT", True)
        self.default_dtype: str = os.environ.get("DL4J_TPU_DTYPE", "float32")
        self.extra: Dict[str, Any] = {}

    @classmethod
    def instance(cls) -> "Environment":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    def enable_nan_panic(self, enabled: bool = True) -> None:
        """JAX's ``jax_debug_nans``: here ``torch.autograd``'s anomaly
        detection, which raises where a backward produces NaN."""
        import torch

        self.nan_panic = enabled
        torch.autograd.set_detect_anomaly(enabled)

    def enable_x64(self, enabled: bool = True) -> None:
        """JAX's ``jax_enable_x64``: here float64 becomes (or stops being)
        the default dtype, which :func:`~deeplearning4j_tpu_torch.core.
        dtypes.default_float_dtype` reports and ``torch`` uses for new
        float tensors."""
        import torch

        self.default_dtype = "float64" if enabled else "float32"
        torch.set_default_dtype(torch.float64 if enabled else torch.float32)

    def reset(self) -> None:
        """Restore constructor defaults (used by tests)."""
        self.__init__()  # type: ignore[misc]


def get_environment() -> Environment:
    return Environment.instance()
