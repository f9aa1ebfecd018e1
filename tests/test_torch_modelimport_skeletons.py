"""The two full-width imported models, on the CPU, against their JAX goldens.

* Keras-applications ResNet-50 (``tools/keras_resnet50.py``): the committed
  HDF5 skeleton, read by the port's reader (each of its 320 datasets
  unallocated, read as h5py reads it), filled from seed 0 and imported into
  a ``ComputationGraph`` of 25,583,592 parameters; on the golden's [2, 3,
  224, 224] input its ``avg_pool`` features are within 2e-4 of the JAX
  package's (relative to the largest) and its probabilities within 1e-4.
* BERT-base from ONNX (``tools/onnx_bert.py``): the committed skeleton,
  read by the port's wire reader, filled from seed 0 and imported into
  SameDiff; on [16, 128] ids with a ragged mask, positions 0-1 within 2e-4
  of the JAX package's output, the mean and mean |x| within 1e-6.
* A subprocess in which ``jax``, ``tensorflow``, ``google.protobuf``,
  ``h5py``, ``onnx`` and the JAX package are unimportable imports both.
"""

import gzip
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.modelimport import KerasModelImport
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxGraphMapper
from deeplearning4j_tpu_torch.tools import keras_resnet50, onnx_bert

ROOT = Path(__file__).resolve().parent.parent
TOL_FEATURES, TOL_PROBS, TOL_BERT, TOL_MEAN = 2e-4, 1e-4, 2e-4, 1e-6


def test_skeletons_are_small():
    for path in (keras_resnet50.SKELETON, keras_resnet50.GOLDEN, onnx_bert.SKELETON,
                 onnx_bert.GOLDEN):
        assert path.stat().st_size < 200_000, path


def test_keras_skeleton_reads_as_h5py_reads_it(tmp_path):
    h5py = pytest.importorskip("h5py")
    from test_torch_hdf5 import assert_same_file

    path = tmp_path / "skeleton.h5"
    path.write_bytes(gzip.decompress(keras_resnet50.SKELETON.read_bytes()))
    assert assert_same_file(str(path), path) == 320
    f = keras_resnet50.open_skeleton()
    assert not any(d.allocated for d in f.datasets())
    with h5py.File(path, "r") as theirs:
        specs = []
        theirs.visititems(lambda n, o: specs.append(("/" + n, o.shape))
                          if isinstance(o, h5py.Dataset) else None)
    assert sorted(specs) == sorted((d.name, d.shape) for d in f.datasets())


def test_keras_resnet50_against_jax_golden():
    net = KerasModelImport.import_keras_model_and_weights(keras_resnet50.load(0), device="cpu")
    assert net.num_params() == keras_resnet50.N_PARAMS
    assert type(net).__name__ == "ComputationGraph"
    gold = keras_resnet50.golden()
    with torch.inference_mode():
        acts, _ = net.forward_pure(net.params, net.state,
                                   [torch.from_numpy(keras_resnet50.golden_input())])
    feats = acts[keras_resnet50.FEATURES].numpy()
    probs = acts[keras_resnet50.OUTPUT].numpy()
    assert np.abs(feats - gold["features"]).max() / np.abs(gold["features"]).max() <= TOL_FEATURES
    assert np.abs(probs - gold["probs"]).max() <= TOL_PROBS
    assert gold["probs"].max() < 0.5  # not a saturated softmax
    np.testing.assert_allclose(net.output(keras_resnet50.golden_input()).numpy(), probs,
                               rtol=0, atol=1e-7)


def test_onnx_bert_base_against_jax_golden():
    model = onnx_bert.load(0)
    assert len(onnx_bert.emptied(onnx_wire_skeleton())) == 74
    sd = OnnxGraphMapper.import_model(model, outputs=[onnx_bert.OUTPUT], device="cpu")
    out = sd.output(onnx_bert.bench_feeds(), [onnx_bert.OUTPUT])[onnx_bert.OUTPUT]
    gold = onnx_bert.golden()
    assert tuple(out.shape) == (16, 128, 768) and out.dtype == torch.float32
    assert float((out[:, :2] - torch.from_numpy(gold["first2"])).abs().max()) <= TOL_BERT
    assert float(out.double().mean()) == pytest.approx(float(gold["mean"]), abs=TOL_MEAN)
    assert float(out.double().abs().mean()) == pytest.approx(float(gold["mean_abs"]),
                                                             abs=TOL_MEAN)
    assert sd.host_ops([onnx_bert.OUTPUT]) == []  # the card captures it as one CUDA graph


def onnx_wire_skeleton():
    from deeplearning4j_tpu_torch.modelimport.onnx_proto import onnx_wire

    return onnx_wire.ModelProto.FromString(gzip.decompress(onnx_bert.SKELETON.read_bytes()))


def test_imports_without_jax_tensorflow_protobuf_h5py_or_onnx():
    code = textwrap.dedent(f"""
        import sys
        blocked = ("jax", "jaxlib", "tensorflow", "deeplearning4j_tpu", "h5py", "onnx",
                   "optax", "keras")
        for name in list(sys.modules):
            if name.split(".")[0] in blocked or name.startswith("google.protobuf"):
                del sys.modules[name]
        for name in blocked + ("google.protobuf",):
            sys.modules[name] = None  # import raises ImportError
        sys.path.insert(0, {str(ROOT)!r})
        from deeplearning4j_tpu_torch.modelimport import KerasModelImport
        from deeplearning4j_tpu_torch.modelimport.onnx import OnnxGraphMapper
        from deeplearning4j_tpu_torch.tools import keras_resnet50, onnx_bert
        net = KerasModelImport.import_keras_model_and_weights(keras_resnet50.load(0),
                                                              device="cpu")
        sd = OnnxGraphMapper.import_model(onnx_bert.load(0), outputs=[onnx_bert.OUTPUT],
                                          device="cpu")
        bad = [m for m in sys.modules if sys.modules[m] is not None and
               (m.split(".")[0] in blocked or m.startswith("google.protobuf"))]
        print(net.num_params(), len(sd._nodes), bad)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-3:] == [str(keras_resnet50.N_PARAMS), "640", "[]"], res.stdout


def test_keras_lambda_graph_fixture_against_jax(tmp_path):
    """The committed functional model with a Lambda layer (the card test's
    input): the port, with the Lambda registered in its SameDiff spelling,
    equals the JAX package with it registered as a function."""
    pytest.importorskip("h5py")
    from deeplearning4j_tpu.modelimport import KerasModelImport as JaxImport
    from deeplearning4j_tpu.modelimport.keras import KERAS_LAMBDAS as JAX_LAMBDAS

    from deeplearning4j_tpu_torch.modelimport.keras import KERAS_LAMBDAS, register_keras_lambda

    raw = gzip.decompress(keras_resnet50.LAMBDA_GRAPH.read_bytes())
    path = tmp_path / "lambda.h5"
    path.write_bytes(raw)
    JAX_LAMBDAS["double_shift"] = lambda t: t * 2.0 + 1.0
    register_keras_lambda("double_shift", lambda sd, t: sd._op(
        "add", sd._op("mul", t, sd.constant(np.float32(2.0))), sd.constant(np.float32(1.0))))
    try:
        ours = KerasModelImport.import_keras_model_and_weights(raw, device="cpu")
        ref = JaxImport.import_keras_model_and_weights(str(path))
    finally:
        JAX_LAMBDAS.pop("double_shift", None)
        KERAS_LAMBDAS.pop("double_shift", None)
    assert type(ours).__name__ == "ComputationGraph"
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    np.testing.assert_allclose(ours.output(x).numpy(), np.asarray(ref.output(x)), rtol=1e-6,
                               atol=1e-6)
