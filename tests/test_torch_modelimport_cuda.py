"""The imported models on the card.

These tests need a CUDA device and skip without one. Where there is one
(and no JAX for ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_modelimport_cuda.py

* The Keras-applications ResNet-50 skeleton (seed 0) imported onto the
  card: ``output()`` in float32 against the same graph in float64 on the
  card, within 1e-4 of the largest probability and of the largest pooled
  feature.
* The ONNX BERT-base skeleton (seed 0) imported onto the card: float32
  against its float constants in float64 within 1e-4 of the largest
  output; ``compile()`` captures it as one CUDA graph whose replay equals
  eager ``output()`` within 1e-6.
* The committed functional model with a ``Lambda`` layer, imported onto
  the card with the Lambda registered in its SameDiff spelling: its
  ``ComputationGraph`` output equals the CPU import's within 1e-6, and 5
  ``fit`` steps through the Lambda lower the score.
"""

import copy
import dataclasses
import gzip

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.modelimport import KerasModelImport
from deeplearning4j_tpu_torch.modelimport.keras import KERAS_LAMBDAS, register_keras_lambda
from deeplearning4j_tpu_torch.modelimport.onnx import OnnxGraphMapper
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.tools import keras_resnet50, onnx_bert

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the imported models' card path runs only there")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def float64_graph(net: ComputationGraph) -> ComputationGraph:
    """``net``'s configuration, weights and statistics in float64, on its device."""
    out = ComputationGraph(dataclasses.replace(net.conf, dtype="float64"), device=net.device)
    out.init()
    out.set_params_flat(net.params_flat())
    out.state = {n: {k: t.double() for k, t in st.items()} for n, st in net.state.items()}
    return out


def test_keras_resnet50_f32_against_f64_on_the_card():
    net = KerasModelImport.import_keras_model_and_weights(keras_resnet50.load(0))
    assert net.device.type == "cuda"
    net64 = float64_graph(net)
    x = torch.from_numpy(keras_resnet50.golden_input()).cuda()
    with torch.inference_mode():
        a32, _ = net.forward_pure(net.params, net.state, [x])
        a64, _ = net64.forward_pure(net64.params, net64.state, [x.double()])
    for name in (keras_resnet50.FEATURES, keras_resnet50.OUTPUT):
        assert _rel(a32[name], a64[name]) <= 1e-4, name
    gold = keras_resnet50.golden()
    assert float((a32[keras_resnet50.OUTPUT].cpu() - torch.from_numpy(gold["probs"])).abs()
                 .max()) <= 1e-4


def test_onnx_bert_f32_f64_and_graph_on_the_card():
    sd = OnnxGraphMapper.import_model(onnx_bert.load(0), outputs=[onnx_bert.OUTPUT])
    assert sd.device.type == "cuda"
    feeds = {k: torch.from_numpy(v).cuda() for k, v in onnx_bert.bench_feeds().items()}
    eager = sd.output(feeds, [onnx_bert.OUTPUT])[onnx_bert.OUTPUT]
    sd64 = copy.copy(sd)
    sd64._values = {k: v.double() if v.is_floating_point() else v for k, v in sd._values.items()}
    ref = sd64.output(feeds, [onnx_bert.OUTPUT])[onnx_bert.OUTPUT]
    assert _rel(eager, ref) <= 1e-4
    compiled = sd.compile(feeds, [onnx_bert.OUTPUT])
    assert compiled.graphed, compiled.reason
    out = compiled(dict(sd._values), feeds)[onnx_bert.OUTPUT]
    assert float((out - eager).abs().max()) <= 1e-6


def test_keras_lambda_inside_a_computation_graph_on_the_card():
    raw = gzip.decompress(keras_resnet50.LAMBDA_GRAPH.read_bytes())
    register_keras_lambda("double_shift", lambda sd, t: sd._op(
        "add", sd._op("mul", t, sd.constant(np.float32(2.0))), sd.constant(np.float32(1.0))))
    try:
        card = KerasModelImport.import_keras_model_and_weights(raw)
        cpu = KerasModelImport.import_keras_model_and_weights(raw, device="cpu")
    finally:
        KERAS_LAMBDAS.pop("double_shift", None)
    assert isinstance(card, ComputationGraph) and card.device.type == "cuda"
    rs = np.random.RandomState(0)
    x = rs.randn(16, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 16)]
    assert float((card.output(x).cpu() - cpu.output(x)).abs().max()) <= 1e-6
    scores = [card.score(x, y)]
    for _ in range(5):
        card.fit(x, y)
    scores.append(card.score(x, y))
    assert np.isfinite(scores).all() and scores[-1] < scores[0]
