"""Early stopping (port of ``deeplearning4j_tpu/train/early_stopping.py``).

Reference: org.deeplearning4j.earlystopping.{EarlyStoppingConfiguration,
EarlyStoppingTrainer, termination conditions, score calculators, ModelSaver}.

The best model is ``model.clone()``, which copies every tensor (the live
model's updater writes its parameters in place), and holds no trainer
state. ``model_saver_path`` writes the best model's zip, without its
updater state, through the port's ``write_model``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class ScoreCalculator:
    """Lower-is-better score on held-out data (reference: ScoreCalculator)."""

    def calculate_score(self, model) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over an iterator (reference: DataSetLossCalculator)."""

    def __init__(self, iterator) -> None:
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        for ds in self.iterator:
            s = model.score(ds.features, ds.labels, mask=ds.features_mask,
                            label_mask=ds.labels_mask)
            b = ds.num_examples()
            total += s * b
            n += b
        return total / max(n, 1)


class ClassificationScoreCalculator(ScoreCalculator):
    """negated accuracy so lower-is-better holds."""

    def __init__(self, iterator) -> None:
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        return -model.evaluate(self.iterator).accuracy()


class TerminationCondition:
    def terminate(self, *args: Any) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(TerminationCondition):
    def __init__(self, max_epochs: int) -> None:
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, *_: Any) -> bool:
        return epoch >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(TerminationCondition):
    """Stop after N epochs without improvement (reference of the same name)."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0) -> None:
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best: Optional[float] = None
        self.stale = 0

    def terminate(self, epoch: int, score: float, *_: Any) -> bool:
        if self.best is None or score < self.best - self.min_improvement:
            self.best = score
            self.stale = 0
            return False
        self.stale += 1
        return self.stale >= self.patience


class MaxTimeTerminationCondition(TerminationCondition):
    def __init__(self, max_seconds: float) -> None:
        self.max_seconds = max_seconds
        self._start = time.time()

    def terminate(self, *_: Any) -> bool:
        return (time.time() - self._start) >= self.max_seconds


class MaxScoreIterationTerminationCondition(TerminationCondition):
    """Abort if the training score explodes (reference of the same name)."""

    def __init__(self, max_score: float) -> None:
        self.max_score = max_score

    def terminate(self, score: float) -> bool:
        return score > self.max_score or not np.isfinite(score)


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: ScoreCalculator = None
    epoch_termination_conditions: List[TerminationCondition] = dataclasses.field(default_factory=list)
    iteration_termination_conditions: List[TerminationCondition] = dataclasses.field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    model_saver_path: Optional[str] = None  # save best model here
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    score_vs_epoch: Dict[int, float]
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


class EarlyStoppingTrainer:
    """Reference: EarlyStoppingTrainer.fit() loop."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_data) -> None:
        self.config = config
        self.model = model
        self.train_data = train_data

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        best_score = float("inf")
        best_epoch = -1
        best_model = None
        scores: Dict[int, float] = {}
        epoch = 0
        reason, details = "EpochTerminationCondition", ""
        while True:
            # one epoch of training, watching iteration conditions
            aborted = False
            for ds in self.train_data:
                self.model.fit(ds.features, ds.labels, mask=ds.features_mask,
                               label_mask=ds.labels_mask)
                for cond in cfg.iteration_termination_conditions:
                    if cond.terminate(self.model.score_value):
                        aborted = True
                        reason = "IterationTerminationCondition"
                        details = type(cond).__name__
                        break
                if aborted:
                    break
            if aborted:
                break
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model)
                scores[epoch] = score
                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    best_model = self.model.clone()
                    if cfg.model_saver_path:
                        from ..model.serializer import write_model

                        write_model(self.model, cfg.model_saver_path)
            epoch += 1
            stop = False
            for cond in cfg.epoch_termination_conditions:
                if cond.terminate(epoch, scores.get(epoch - 1, best_score)):
                    stop = True
                    details = type(cond).__name__
                    break
            if stop:
                break
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            score_vs_epoch=scores,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            total_epochs=epoch,
            best_model=best_model if best_model is not None else self.model,
        )
