from .config import from_json, register_config, to_json
from .dtypes import as_input, default_device, torch_dtype
from .resilience import (
    AdmissionController,
    AdmissionRejectedError,
    CircuitBreaker,
    CircuitOpenError,
    CircuitState,
    CrashLoopError,
    Deadline,
    DeadlineExceededError,
    FaultInjector,
    ReplicaUnavailableError,
    ResilienceError,
    RetryPolicy,
    get_fault_injector,
    set_fault_injector,
)
from .rng import RngState, get_default_rng, set_default_seed

__all__ = ["AdmissionController", "AdmissionRejectedError", "CircuitBreaker",
           "CircuitOpenError", "CircuitState", "CrashLoopError", "Deadline",
           "DeadlineExceededError", "FaultInjector", "ReplicaUnavailableError",
           "ResilienceError", "RetryPolicy", "RngState", "as_input",
           "default_device", "from_json", "get_default_rng", "get_fault_injector",
           "register_config", "set_default_seed", "set_fault_injector", "to_json",
           "torch_dtype"]
