from .ops import SD_OPS, get_sd_op
from .samediff import SDVariable, SameDiff
from .training import History, TrainingConfig

__all__ = ["History", "SDVariable", "SD_OPS", "SameDiff", "TrainingConfig", "get_sd_op"]
