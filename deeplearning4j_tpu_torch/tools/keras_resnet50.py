"""Keras-applications ResNet-50 as an HDF5 skeleton, filled from a seed.

``data/keras_resnet50.h5.gz`` is ``keras.applications.ResNet50(weights=None)``
saved by ``model.save("….h5")`` (Keras 3, h5py's ``libver="earliest"``) and
rewritten with every group and attribute kept and every dataset created but
never written: the file keeps each weight's name, shape and dtype and holds
no values (HDF5 reads unallocated storage as the fill value, zeros). Its 320
datasets are filled in path order from ``np.random.default_rng(seed)`` by
:func:`fill_arrays`, whose rule keeps the batch norms' variances positive
and the activations of order one. ``tools/make_keras_resnet50_skeleton.py``
at the repository root writes the skeleton and, beside it, the JAX
package's output for seed 0 on :func:`golden_input`
(``data/keras_resnet50_jax_golden.npz``).

:func:`load` reads the skeleton with the port's own HDF5 reader (no h5py)
and puts the seeded values in place (``Dataset.assign``); pass the file to
``KerasModelImport.import_keras_model_and_weights``.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from ..modelimport import hdf5

DATA = Path(__file__).resolve().parent / "data"
SKELETON = DATA / "keras_resnet50.h5.gz"
GOLDEN = DATA / "keras_resnet50_jax_golden.npz"
#: a small functional model with a ``Lambda`` layer named "double_shift"
#: (x * 2 + 1): Input 6 -> Dense 5 relu -> Lambda -> Dense 3 softmax
LAMBDA_GRAPH = DATA / "keras_lambda_graph.h5.gz"
FEATURES, OUTPUT = "avg_pool", "predictions"  # the pooled features, the softmax head
N_PARAMS = 25_583_592  # the imported ComputationGraph's (Keras's 25,636,712 less BN's statistics)


def fill_arrays(specs: Sequence[Tuple[str, Tuple[int, ...]]], seed: int) -> Dict[str, np.ndarray]:
    """Seeded float32 values for the datasets ``specs`` ((path, shape)
    pairs), drawn in path order: convolution kernels LeCun-normal (std
    sqrt(1 / fan_in), fan_in the product of all dims but the last; He's
    sqrt(2 / fan_in) doubles the variance at each of the 16 residual sums,
    and the softmax saturates), the dense kernel He-normal, gamma
    1 + 0.1 N, moving variance 1 + 0.1 |N|, beta, moving mean and biases
    0.02 N."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in sorted(specs):
        leaf = path.rsplit("/", 1)[-1].split(":")[0]
        z = rng.standard_normal(shape)
        if leaf == "kernel":
            z *= np.sqrt((1.0 if len(shape) == 4 else 2.0) / np.prod(shape[:-1]))
        elif leaf == "gamma":
            z = 1.0 + 0.1 * z
        elif leaf == "moving_variance":
            z = 1.0 + 0.1 * np.abs(z)
        elif leaf in ("beta", "moving_mean", "bias"):
            z *= 0.02
        else:
            raise ValueError(f"no fill rule for {path}")
        out[path] = z.astype(np.float32)
    return out


def open_skeleton() -> hdf5.File:
    return hdf5.File(gzip.decompress(SKELETON.read_bytes()))


def load(seed: int = 0) -> hdf5.File:
    """The skeleton, read by the port's reader, with every dataset's
    seeded values in place."""
    f = open_skeleton()
    datasets = {d.name: d for d in f.datasets()}
    for path, arr in fill_arrays([(n, d.shape) for n, d in datasets.items()], seed).items():
        datasets[path].assign(arr)
    return f


def golden_input(batch: int = 2) -> np.ndarray:
    """The golden's input: ``default_rng(1)``'s standard normal, [batch, 3,
    224, 224] float32 (NCHW, as the imported graph takes it)."""
    return np.random.default_rng(1).standard_normal((batch, 3, 224, 224)).astype(np.float32)


def golden() -> Dict[str, np.ndarray]:
    """The JAX package's float32 output on the CPU for seed 0 on
    :func:`golden_input`: ``features`` (``avg_pool``, [2, 2048]) and
    ``probs`` (``predictions``, [2, 1000])."""
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}
