from .checkpoint import CheckpointListener, EvaluativeListener, restore_training_state
from .early_stopping import (
    ClassificationScoreCalculator,
    DataSetLossCalculator,
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    EarlyStoppingTrainer,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeTerminationCondition,
    ScoreCalculator,
    ScoreImprovementEpochTerminationCondition,
    TerminationCondition,
)
from .evaluation import (ROC, Evaluation, EvaluationBinary, EvaluationCalibration,
                         RegressionEvaluation, ROCBinary, ROCMultiClass)
from .fault_tolerance import (PREEMPTED_EXIT_CODE, STALL_EXIT_CODE, HeartbeatListener,
                              PreemptionHandler, Watchdog, elastic_fit, read_heartbeat)
from .schedules import (
    CycleSchedule,
    ExponentialSchedule,
    FixedSchedule,
    InverseSchedule,
    ISchedule,
    MapSchedule,
    PolySchedule,
    RampSchedule,
    ScheduleType,
    SigmoidSchedule,
    StepSchedule,
    WarmupSchedule,
)
from .orbax_checkpoint import OrbaxCheckpointer
from .solver import LayerOptimizers, Solver
from .updaters import (
    AdaDelta,
    AdaGrad,
    AdaMax,
    Adam,
    AdamW,
    AMSGrad,
    GradientTransformation,
    IUpdater,
    Lamb,
    Lars,
    Nadam,
    Nesterovs,
    NoOp,
    RmsProp,
    Sgd,
    registered_updaters,
)

__all__ = ["AdaDelta", "AdaGrad", "AdaMax", "Adam", "AdamW", "AMSGrad",
           "CheckpointListener", "ClassificationScoreCalculator", "CycleSchedule",
           "DataSetLossCalculator", "EarlyStoppingConfiguration", "EarlyStoppingResult",
           "EarlyStoppingTrainer", "Evaluation", "EvaluationBinary", "EvaluationCalibration",
           "EvaluativeListener", "ExponentialSchedule", "FixedSchedule",
           "GradientTransformation", "HeartbeatListener", "ISchedule", "InverseSchedule",
           "IUpdater", "Lamb", "Lars", "LayerOptimizers", "MapSchedule",
           "MaxEpochsTerminationCondition", "MaxScoreIterationTerminationCondition",
           "MaxTimeTerminationCondition", "Nadam", "Nesterovs", "NoOp", "OrbaxCheckpointer",
           "PREEMPTED_EXIT_CODE",
           "PolySchedule", "PreemptionHandler", "RampSchedule", "RegressionEvaluation",
           "RmsProp", "ROC", "ROCBinary", "ROCMultiClass", "STALL_EXIT_CODE",
           "ScheduleType", "ScoreCalculator", "ScoreImprovementEpochTerminationCondition",
           "Sgd", "SigmoidSchedule", "Solver", "StepSchedule", "TerminationCondition",
           "WarmupSchedule", "Watchdog", "elastic_fit", "read_heartbeat",
           "registered_updaters", "restore_training_state",
           # the submodules, which the JAX package's ``dir()``-built list names too
           "checkpoint", "early_stopping", "evaluation", "fault_tolerance", "orbax_checkpoint",
           "schedules", "solver", "updaters"]
