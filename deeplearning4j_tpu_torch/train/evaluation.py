"""Evaluation suite.

A copy of ``deeplearning4j_tpu/train/evaluation.py`` for the PyTorch port: host
numpy code, which the port keeps as the reference has it (the port imports
nothing of the JAX package).

Reference: org.nd4j.evaluation.classification.{Evaluation, ROC,
EvaluationBinary, EvaluationCalibration} and regression.RegressionEvaluation
(SURVEY.md §2.2). Host-side numpy accumulation over batches — evaluation is
not a device bottleneck; the forward passes feeding it are jitted.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _to_class_indices(arr: np.ndarray) -> np.ndarray:
    """one-hot / prob [n, k] -> argmax indices; already-int [n] passes through."""
    arr = np.asarray(arr)
    if arr.ndim >= 2 and arr.shape[-1] > 1:
        return np.argmax(arr, axis=-1)
    return arr.astype(np.int64).reshape(-1)


def _flatten_time(labels: np.ndarray, preds: np.ndarray, mask: Optional[np.ndarray]):
    """[b, k, t] sequence outputs -> [b*t, k] with mask filtering."""
    if labels.ndim == 3:
        b, k, t = labels.shape
        labels = labels.transpose(0, 2, 1).reshape(b * t, k)
        preds = preds.transpose(0, 2, 1).reshape(b * t, k)
        if mask is not None:
            keep = mask.reshape(b * t) > 0
            labels, preds = labels[keep], preds[keep]
    return labels, preds


class Evaluation:
    """Multiclass classification metrics (reference: Evaluation)."""

    def __init__(self, num_classes: Optional[int] = None, labels_names: Optional[List[str]] = None,
                 top_n: int = 1) -> None:
        self.num_classes = num_classes
        self.labels_names = labels_names
        self.confusion: Optional[np.ndarray] = None
        self.top_n = int(top_n)  # reference: Evaluation(int topN)
        self._topn_correct = 0
        self._topn_total = 0

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        labels, predictions = _flatten_time(labels, predictions, mask)
        truth = _to_class_indices(labels)
        guess = _to_class_indices(predictions)
        if self.top_n > 1 and predictions.ndim >= 2 and predictions.shape[-1] > 1:
            topk = np.argsort(-predictions, axis=-1)[:, : self.top_n]
            self._topn_correct += int((topk == truth[:, None]).any(axis=1).sum())
            self._topn_total += len(truth)
        n = self.num_classes
        if n is None:
            n = int(max(truth.max(initial=0), guess.max(initial=0))) + 1
            self.num_classes = n
        if self.confusion is None:
            self.confusion = np.zeros((n, n), dtype=np.int64)
        elif self.confusion.shape[0] < n:
            grown = np.zeros((n, n), dtype=np.int64)
            grown[: self.confusion.shape[0], : self.confusion.shape[1]] = self.confusion
            self.confusion = grown
        np.add.at(self.confusion, (truth, guess), 1)

    # ---- metrics ----------------------------------------------------------
    def _check(self) -> np.ndarray:
        if self.confusion is None:
            raise ValueError("No data evaluated")
        return self.confusion

    def accuracy(self) -> float:
        c = self._check()
        total = c.sum()
        return float(np.trace(c) / total) if total else 0.0

    def _tp(self) -> np.ndarray:
        return np.diag(self._check()).astype(np.float64)

    def precision(self, cls: Optional[int] = None) -> float:
        c = self._check()
        tp = self._tp()
        denom = c.sum(axis=0).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(denom > 0, tp / denom, np.nan)
        if cls is not None:
            return float(per[cls])
        return float(np.nanmean(per))

    def recall(self, cls: Optional[int] = None) -> float:
        c = self._check()
        tp = self._tp()
        denom = c.sum(axis=1).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(denom > 0, tp / denom, np.nan)
        if cls is not None:
            return float(per[cls])
        return float(np.nanmean(per))

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def top_n_accuracy(self) -> float:
        """Top-N accuracy (reference: Evaluation(topN).topNAccuracy()) —
        only populated when probability outputs were evaluated."""
        if self.top_n <= 1:
            return self.accuracy()
        if self._topn_total == 0:
            raise ValueError("No probability predictions evaluated for top-N")
        return self._topn_correct / self._topn_total

    def false_positive_rate(self, cls: int) -> float:
        c = self._check()
        fp = c[:, cls].sum() - c[cls, cls]
        tn = c.sum() - c[cls, :].sum() - c[:, cls].sum() + c[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) > 0 else 0.0

    def matthews_correlation(self) -> float:
        c = self._check().astype(np.float64)
        t = c.sum(axis=1)
        p = c.sum(axis=0)
        s = c.sum()
        num = np.trace(c) * s - t @ p
        den = np.sqrt(s * s - p @ p) * np.sqrt(s * s - t @ t)
        return float(num / den) if den > 0 else 0.0

    def stats(self) -> str:
        c = self._check()
        name = lambda i: (self.labels_names[i] if self.labels_names else str(i))
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {c.shape[0]}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "=========================Confusion Matrix=========================",
        ]
        header = "     " + " ".join(f"{name(j):>6}" for j in range(c.shape[0]))
        lines.append(header)
        for i in range(c.shape[0]):
            lines.append(f"{name(i):>4} " + " ".join(f"{c[i, j]:>6}" for j in range(c.shape[1])))
        return "\n".join(lines)


class EvaluationBinary:
    """Per-output binary metrics for multi-label outputs (reference:
    EvaluationBinary). Threshold 0.5."""

    def __init__(self, threshold: float = 0.5) -> None:
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        preds = (np.asarray(predictions) >= self.threshold).astype(np.int64)
        labels_b = (labels >= 0.5).astype(np.int64)
        if mask is not None:
            keep = np.asarray(mask).astype(bool)
            labels_b = labels_b * keep
            preds = preds * keep
        tp = ((preds == 1) & (labels_b == 1)).sum(axis=0)
        fp = ((preds == 1) & (labels_b == 0)).sum(axis=0)
        tn = ((preds == 0) & (labels_b == 0)).sum(axis=0)
        fn = ((preds == 0) & (labels_b == 1)).sum(axis=0)
        if self.tp is None:
            self.tp, self.fp, self.tn, self.fn = tp, fp, tn, fn
        else:
            self.tp += tp
            self.fp += fp
            self.tn += tn
            self.fn += fn

    def accuracy(self, i: int) -> float:
        total = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / total) if total else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0


class ROC:
    """Binary ROC / AUC via threshold sweep (reference: ROC with
    thresholdSteps; exact AUC when steps=0 — here always exact)."""

    def __init__(self) -> None:
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels).reshape(-1)
        preds = np.asarray(predictions)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
            labels_2 = np.asarray(labels).reshape(-1, 2) if labels.size == preds.size * 2 else None
            if labels_2 is not None:
                labels = labels_2[:, 1]
        preds = preds.reshape(-1)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, preds = labels[keep], preds[keep]
        self._labels.append(labels)
        self._scores.append(preds)

    def calculate_auc(self) -> float:
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        order = np.argsort(s)
        y = y[order]
        n_pos = y.sum()
        n_neg = len(y) - n_pos
        if n_pos == 0 or n_neg == 0:
            return float("nan")
        # rank-sum (Mann-Whitney U) AUC with tie correction
        ranks = np.empty(len(s), dtype=np.float64)
        s_sorted = s[order]
        i = 0
        while i < len(s_sorted):
            j = i
            while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
                j += 1
            ranks[i : j + 1] = 0.5 * (i + j) + 1.0
            i = j + 1
        pos_ranks = ranks[y > 0.5].sum()
        return float((pos_ranks - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))

    def calculate_auprc(self) -> float:
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        order = np.argsort(-s)
        y = y[order]
        tp = np.cumsum(y)
        fp = np.cumsum(1 - y)
        precision = tp / np.maximum(tp + fp, 1)
        recall = tp / max(y.sum(), 1)
        # trapezoid over recall
        return float(np.trapezoid(precision, recall))


class RegressionEvaluation:
    """Per-column regression metrics (reference: RegressionEvaluation)."""

    def __init__(self) -> None:
        self._labels: List[np.ndarray] = []
        self._preds: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels, dtype=np.float64)
        preds = np.asarray(predictions, dtype=np.float64)
        labels, preds = _flatten_time(labels, preds, mask)
        if labels.ndim == 1:
            labels = labels[:, None]
            preds = preds[:, None]
        self._labels.append(labels)
        self._preds.append(preds)

    def _cat(self):
        return np.concatenate(self._labels), np.concatenate(self._preds)

    def mean_squared_error(self, col: int = 0) -> float:
        y, p = self._cat()
        return float(np.mean((y[:, col] - p[:, col]) ** 2))

    def mean_absolute_error(self, col: int = 0) -> float:
        y, p = self._cat()
        return float(np.mean(np.abs(y[:, col] - p[:, col])))

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        y, p = self._cat()
        ss_res = np.sum((y[:, col] - p[:, col]) ** 2)
        ss_tot = np.sum((y[:, col] - y[:, col].mean()) ** 2)
        return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0

    def pearson_correlation(self, col: int = 0) -> float:
        y, p = self._cat()
        return float(np.corrcoef(y[:, col], p[:, col])[0, 1])

    def stats(self) -> str:
        y, _ = self._cat()
        cols = y.shape[1]
        lines = ["Column    MSE            MAE            RMSE           R^2"]
        for c in range(cols):
            lines.append(
                f"{c:<9} {self.mean_squared_error(c):<14.6f} {self.mean_absolute_error(c):<14.6f} "
                f"{self.root_mean_squared_error(c):<14.6f} {self.r_squared(c):<14.6f}"
            )
        return "\n".join(lines)


class ROCBinary:
    """Per-output binary ROC for multi-label sigmoid outputs (reference:
    ROCBinary): one exact-AUC ROC per output column."""

    def __init__(self) -> None:
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        preds = np.asarray(predictions)
        if labels.ndim == 1:
            labels = labels[:, None]
            preds = preds[:, None]
        if mask is not None:
            mask = np.asarray(mask)
            if mask.ndim == 1:  # per-example mask applies to every output
                mask = np.broadcast_to(mask[:, None], labels.shape)
        while len(self._rocs) < labels.shape[1]:
            self._rocs.append(ROC())
        for i in range(labels.shape[1]):
            m = None if mask is None else mask[:, i]
            self._rocs[i].eval(labels[:, i], preds[:, i], mask=m)

    def calculate_auc(self, output: int) -> float:
        return self._rocs[output].calculate_auc()

    def calculate_average_auc(self) -> float:
        aucs = [r.calculate_auc() for r in self._rocs]
        return float(np.nanmean(aucs)) if aucs else float("nan")


class ROCMultiClass:
    """One-vs-all ROC per class for softmax outputs (reference:
    ROCMultiClass). ``eval`` takes one-hot (or index) labels and class
    probabilities [n, k]; AUC per class is exact (rank-sum)."""

    def __init__(self) -> None:
        self._rocs: List[ROC] = []

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels)
        preds = np.asarray(predictions)
        labels, preds = _flatten_time(labels, preds, mask)
        k = preds.shape[1]
        truth = _to_class_indices(labels)
        while len(self._rocs) < k:
            self._rocs.append(ROC())
        for c in range(k):
            self._rocs[c].eval((truth == c).astype(np.float64), preds[:, c])

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_auprc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auprc()

    def calculate_average_auc(self) -> float:
        aucs = [r.calculate_auc() for r in self._rocs]
        return float(np.nanmean(aucs)) if aucs else float("nan")


class EvaluationCalibration:
    """Probability-calibration diagnostics (reference: EvaluationCalibration):
    reliability diagram (mean predicted probability vs observed frequency per
    confidence bin), expected calibration error, per-class probability
    histograms, and the residual-plot histogram |label - p|."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50) -> None:
        self.reliability_bins = int(reliability_bins)
        self.histogram_bins = int(histogram_bins)
        self._probs: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels, dtype=np.float64)
        preds = np.asarray(predictions, dtype=np.float64)
        labels, preds = _flatten_time(labels, preds, mask)
        if preds.ndim == 1:  # binary sigmoid output: one probability column
            preds = preds[:, None]
            labels = labels.reshape(-1, 1)
        elif labels.ndim == 1 or (labels.ndim == 2 and labels.shape[1] == 1
                                  and preds.shape[1] > 1):
            idx = labels.reshape(-1).astype(np.int64)
            onehot = np.zeros_like(preds)
            onehot[np.arange(len(idx)), idx] = 1.0
            labels = onehot
        self._labels.append(labels)
        self._probs.append(preds)

    def _cat(self):
        if not self._probs:
            raise ValueError("No data evaluated")
        return np.concatenate(self._labels), np.concatenate(self._probs)

    def get_reliability_info(self, cls: Optional[int] = None):
        """(mean_predicted, observed_frequency, counts) per confidence bin.
        With ``cls`` the curve is for that class's probability column;
        without, all columns pool (the reference's aggregate diagram)."""
        y, p = self._cat()
        if cls is not None:
            y, p = y[:, cls], p[:, cls]
        y, p = y.reshape(-1), p.reshape(-1)
        edges = np.linspace(0.0, 1.0, self.reliability_bins + 1)
        idx = np.clip(np.digitize(p, edges) - 1, 0, self.reliability_bins - 1)
        counts = np.bincount(idx, minlength=self.reliability_bins)
        sum_p = np.bincount(idx, weights=p, minlength=self.reliability_bins)
        sum_y = np.bincount(idx, weights=y, minlength=self.reliability_bins)
        with np.errstate(invalid="ignore"):
            mean_p = np.where(counts > 0, sum_p / counts, np.nan)
            freq = np.where(counts > 0, sum_y / counts, np.nan)
        return mean_p, freq, counts

    def expected_calibration_error(self, cls: Optional[int] = None) -> float:
        mean_p, freq, counts = self.get_reliability_info(cls)
        total = counts.sum()
        if total == 0:
            return float("nan")
        valid = counts > 0
        return float(np.sum(counts[valid] * np.abs(mean_p[valid] - freq[valid])) / total)

    def get_probability_histogram(self, cls: int):
        """(bin_edges, counts) of predicted probabilities for ``cls``."""
        _, p = self._cat()
        counts, edges = np.histogram(p[:, cls], bins=self.histogram_bins,
                                     range=(0.0, 1.0))
        return edges, counts

    def get_residual_plot(self, cls: Optional[int] = None):
        """(bin_edges, counts) of |label - p| residuals (reference:
        getResidualPlot)."""
        y, p = self._cat()
        if cls is not None:
            y, p = y[:, cls], p[:, cls]
        res = np.abs(y.reshape(-1) - p.reshape(-1))
        counts, edges = np.histogram(res, bins=self.histogram_bins,
                                     range=(0.0, 1.0))
        return edges, counts

    def stats(self) -> str:
        y, p = self._cat()
        lines = [
            "==================Calibration Evaluation==================",
            f" examples:  {len(y)}",
            f" classes:   {y.shape[1]}",
            f" ECE:       {self.expected_calibration_error():.4f}",
        ]
        mean_p, freq, counts = self.get_reliability_info()
        lines.append(" bin  mean_p  obs_freq  count")
        for i in range(self.reliability_bins):
            if counts[i]:
                lines.append(f" {i:>3}  {mean_p[i]:.4f}  {freq[i]:.4f}    {counts[i]}")
        return "\n".join(lines)
