"""Data pipelines of the port (``deeplearning4j_tpu/data``): datasets,
iterators with async prefetch to the card, DataVec readers and transforms,
image augmentation, normalizers and the procedural dataset fetchers.

The JAX package's ``data/sharded.py`` (``ShardedDataSetIterator``,
``shard_paths``) builds global arrays over a device mesh and is not ported
here: it belongs to the distributed slice (ROADMAP A8)."""

from .dataset import DataSet, MultiDataSet
from .fetchers import (Cifar10DataSetIterator, EmnistDataSetIterator,
                       SvhnDataSetIterator, TinyImageNetDataSetIterator)
from .iterators import (AsyncDataSetIterator, DataSetIterator,
                        ListDataSetIterator, MappedDataSetIterator,
                        MultipleEpochsIterator, device_put_dataset)
from .image_transform import (
    BrightnessTransform,
    CropImageTransform,
    FlipImageTransform,
    ImageTransform,
    PipelineImageTransform,
    RandomCropTransform,
    ResizeImageTransform,
    RotateImageTransform,
)
from .records import (
    CollectionRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
    LineRecordReader,
    RecordReader,
    RecordReaderDataSetIterator,
    resolve_data_workers,
)
from .transform import (
    Schema,
    TransformProcess,
    TransformProcessRecordReader,
)

__all__ = [
    "AsyncDataSetIterator",
    "BrightnessTransform",
    "DataSetIterator",
    "ListDataSetIterator",
    "MappedDataSetIterator",
    "MultipleEpochsIterator",
    "device_put_dataset",
    "resolve_data_workers",
    "Cifar10DataSetIterator",
    "CollectionRecordReader",
    "CSVRecordReader",
    "CSVSequenceRecordReader",
    "CropImageTransform",
    "DataSet",
    "EmnistDataSetIterator",
    "SvhnDataSetIterator",
    "TinyImageNetDataSetIterator",
    "FlipImageTransform",
    "ImageRecordReader",
    "ImageTransform",
    "PipelineImageTransform",
    "RandomCropTransform",
    "ResizeImageTransform",
    "RotateImageTransform",
    "LineRecordReader",
    "MultiDataSet",
    "RecordReader",
    "RecordReaderDataSetIterator",
    "Schema",
    "TransformProcess",
    "TransformProcessRecordReader",
]
