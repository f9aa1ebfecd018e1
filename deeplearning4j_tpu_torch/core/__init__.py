from .config import from_dict, from_json, register_config, replace, to_dict, to_json
from .dtypes import DataType, as_input, as_input_np, default_device, default_float_dtype, torch_dtype
from .env import Environment, get_environment
from .listeners import (
    CollectScoresListener,
    ListenerBus,
    PerformanceListener,
    ScoreIterationListener,
    TrainingListener,
)
from .registry import OpDef, OpRegistry, get_op, register_op
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
           "CircuitOpenError", "CircuitState", "CollectScoresListener", "CrashLoopError",
           "DataType", "Deadline", "DeadlineExceededError", "Environment", "FaultInjector",
           "ListenerBus", "OpDef", "OpRegistry", "PerformanceListener",
           "ReplicaUnavailableError", "ResilienceError", "RetryPolicy", "RngState",
           "ScoreIterationListener", "TrainingListener", "as_input", "as_input_np", "default_device",
           "default_float_dtype", "from_dict", "from_json", "get_default_rng",
           "get_environment", "get_fault_injector", "get_op", "register_config",
           "register_op", "replace", "set_default_seed", "set_fault_injector", "to_dict",
           "to_json", "torch_dtype"]
