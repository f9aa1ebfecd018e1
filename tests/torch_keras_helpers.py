"""Keras, the JAX package's importer and the port's on one saved h5 file,
for ``tests/test_torch_keras_import*.py``.

Each scenario of ``tests/test_keras_import.py`` is a function returning
``(model, inputs, to_ours)``: the Keras model, its inputs in Keras's
layout, and the map to the packages' layout (NCHW, [batch, features,
time]). :func:`compare` saves the model, imports it with both packages
(the port on the CPU through its own HDF5 reader) and holds the port to
the JAX package at ``TOL_JAX`` and to Keras at the JAX test's tolerance.
:func:`same_error` holds both importers to the same error on a file that
must be refused.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.modelimport import KerasModelImport as JaxImport
from deeplearning4j_tpu.modelimport.keras import KerasImportError as JaxError

from deeplearning4j_tpu_torch.core.config import to_json
from deeplearning4j_tpu_torch.modelimport import KerasModelImport
from deeplearning4j_tpu_torch.modelimport.keras import KerasImportError

TOL_JAX = 1e-5  # the same float32 arithmetic, in another order
KERAS_ATOL, KERAS_RTOL = 1e-4, 1e-3  # tests/test_keras_import.py's


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _outputs(model, xs):
    out = model.output(*xs)
    return [_np(o) for o in (out if isinstance(out, tuple) else (out,))]


def compare(tmp_path, kmodel, inputs, to_ours, *, keras_atol=KERAS_ATOL, jax_tol=TOL_JAX,
            same_config=True):
    """Save ``kmodel``, import it with both packages and compare: the
    config JSON, every output within ``jax_tol`` of JAX's, the first within
    ``keras_atol`` of Keras's. Returns the port's model."""
    path = str(tmp_path / "model.h5")
    kmodel.save(path)
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    expected = np.asarray(kmodel(inputs if len(inputs) > 1 else inputs[0]))
    ours_in = to_ours(*inputs)
    ours_in = ours_in if isinstance(ours_in, (list, tuple)) else [ours_in]
    jmodel = JaxImport.import_keras_model_and_weights(path)
    pmodel = KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    assert type(pmodel).__name__ == type(jmodel).__name__
    if same_config:  # a config holding a Python callable has no JSON
        assert to_json(pmodel.conf) == jax_to_json(jmodel.conf)
    got, ref = _outputs(pmodel, ours_in), _outputs(jmodel, ours_in)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=jax_tol, atol=jax_tol)
    np.testing.assert_allclose(got[0], expected, atol=keras_atol, rtol=KERAS_RTOL)
    return pmodel


def same_error(tmp_path, kmodel, match):
    """Both importers refuse the saved ``kmodel`` with the same message."""
    path = str(tmp_path / "model.h5")
    kmodel.save(path)
    with pytest.raises(JaxError, match=match) as jerr:
        JaxImport.import_keras_model_and_weights(path)
    with pytest.raises(KerasImportError, match=match) as perr:
        KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    assert str(perr.value) == str(jerr.value)


def nchw(a):
    return a.transpose(0, 3, 1, 2)


def bft(a):
    return a.transpose(0, 2, 1)


def same(a):
    return a
