"""Model import (port of ``deeplearning4j_tpu/modelimport``): Keras h5
files through the port's own HDF5 reader, ONNX models through its own
wire-format reader; neither h5py nor protobuf is needed."""

from .keras import KerasModelImport

__all__ = ["KerasModelImport"]
