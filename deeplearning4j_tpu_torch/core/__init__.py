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

__all__ = ["AdmissionController", "AdmissionRejectedError", "CircuitBreaker",
           "CircuitOpenError", "CircuitState", "CrashLoopError", "Deadline",
           "DeadlineExceededError", "FaultInjector", "ReplicaUnavailableError",
           "ResilienceError", "RetryPolicy", "as_input", "default_device",
           "from_json", "get_fault_injector", "register_config",
           "set_fault_injector", "to_json", "torch_dtype"]
