"""Data normalizers.

A copy of ``deeplearning4j_tpu/data/normalizers.py`` for the PyTorch port: host
numpy code, which the port keeps as the reference has it (the port imports
nothing of the JAX package).

Reference: org.nd4j.linalg.dataset.api.preprocessor.{NormalizerStandardize,
NormalizerMinMaxScaler, ImagePreProcessingScaler, VGG16ImagePreProcessor}.
Same fit/transform protocol; serializable state for the ModelSerializer's
normalizer entry (SURVEY.md §5.4).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .dataset import DataSet


class DataNormalization:
    fit_labels: bool = False

    def fit(self, dataset_or_iterator) -> None:
        raise NotImplementedError

    def transform(self, dataset: DataSet) -> None:
        raise NotImplementedError

    def pre_process(self, dataset: DataSet) -> None:  # reference spelling
        self.transform(dataset)

    def revert(self, dataset: DataSet) -> None:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def load_state_dict(self, d: Dict[str, np.ndarray]) -> None:
        raise NotImplementedError


def _iter_features(data) -> np.ndarray:
    if isinstance(data, DataSet):
        return data.features
    return np.concatenate([d.features for d in data])


class NormalizerStandardize(DataNormalization):
    """Zero-mean unit-variance per feature column."""

    def __init__(self) -> None:
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, data) -> None:
        feats = _iter_features(data)
        axes = tuple(i for i in range(feats.ndim) if i != 1) if feats.ndim > 2 else (0,)
        self.mean = feats.mean(axis=axes)
        self.std = feats.std(axis=axes) + 1e-8

    def _bshape(self, feats: np.ndarray):
        if feats.ndim > 2:
            return (1, -1) + (1,) * (feats.ndim - 2)
        return (1, -1)

    def transform(self, dataset: DataSet) -> None:
        s = self._bshape(dataset.features)
        dataset.features = (dataset.features - self.mean.reshape(s)) / self.std.reshape(s)

    def revert(self, dataset: DataSet) -> None:
        s = self._bshape(dataset.features)
        dataset.features = dataset.features * self.std.reshape(s) + self.mean.reshape(s)

    def state_dict(self):
        return {"kind": np.array("standardize"), "mean": self.mean, "std": self.std}

    def load_state_dict(self, d) -> None:
        self.mean, self.std = d["mean"], d["std"]


class NormalizerMinMaxScaler(DataNormalization):
    """Scale features to [min_range, max_range] (default [0,1])."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0) -> None:
        self.min_range = min_range
        self.max_range = max_range
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, data) -> None:
        feats = _iter_features(data)
        self.data_min = feats.min(axis=0)
        self.data_max = feats.max(axis=0)

    def transform(self, dataset: DataSet) -> None:
        span = np.maximum(self.data_max - self.data_min, 1e-8)
        scaled = (dataset.features - self.data_min) / span
        dataset.features = scaled * (self.max_range - self.min_range) + self.min_range

    def revert(self, dataset: DataSet) -> None:
        span = np.maximum(self.data_max - self.data_min, 1e-8)
        unscaled = (dataset.features - self.min_range) / (self.max_range - self.min_range)
        dataset.features = unscaled * span + self.data_min

    def state_dict(self):
        return {
            "kind": np.array("minmax"),
            "min": self.data_min, "max": self.data_max,
            "range": np.array([self.min_range, self.max_range]),
        }

    def load_state_dict(self, d) -> None:
        self.data_min, self.data_max = d["min"], d["max"]
        self.min_range, self.max_range = float(d["range"][0]), float(d["range"][1])


class ImagePreProcessingScaler(DataNormalization):
    """Scale pixel values from [0, maxPixel] to [min, max] (reference:
    ImagePreProcessingScaler, default 0-255 -> 0-1). Stateless."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0, max_pixel: float = 255.0) -> None:
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def fit(self, data) -> None:
        pass

    def transform(self, dataset: DataSet) -> None:
        dataset.features = (
            dataset.features / self.max_pixel * (self.max_range - self.min_range) + self.min_range
        )

    def revert(self, dataset: DataSet) -> None:
        dataset.features = (
            (dataset.features - self.min_range) / (self.max_range - self.min_range) * self.max_pixel
        )

    def state_dict(self):
        return {
            "kind": np.array("image"),
            "range": np.array([self.min_range, self.max_range, self.max_pixel]),
        }

    def load_state_dict(self, d) -> None:
        self.min_range, self.max_range, self.max_pixel = (float(v) for v in d["range"])


class VGG16ImagePreProcessor(DataNormalization):
    """Subtract ImageNet channel means (reference: VGG16ImagePreProcessor)."""

    MEANS = np.array([123.68, 116.779, 103.939], dtype=np.float32)

    def fit(self, data) -> None:
        pass

    def transform(self, dataset: DataSet) -> None:
        dataset.features = dataset.features - self.MEANS.reshape(1, 3, 1, 1)

    def revert(self, dataset: DataSet) -> None:
        dataset.features = dataset.features + self.MEANS.reshape(1, 3, 1, 1)

    def state_dict(self):
        return {"kind": np.array("vgg16")}

    def load_state_dict(self, d) -> None:
        pass
