"""The port's quantized products and rewrites on the card.

These tests need a CUDA device and skip without one. Where there is one
(and, as on the chip machine, no JAX for ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quantize_cuda.py

* ``int8_matmul`` (``torch._int_mm`` on zero-padded operands) equals the
  CPU's int64 products exactly at shapes that meet cuBLASLt's rules and at
  shapes that need each padding (m not a multiple of 32, k or n not a
  multiple of 8), among them shapes cuBLASLt refuses unpadded.
* A calibrated int8 Dense layer on the card quantizes its input as the CPU
  does (true division) and gives the CPU's int32 accumulators exactly.
* ``quantize_weight`` of a weight on the card equals the CPU's bit for bit
  (the scale math runs on the host either way) and stays on the card.
* A small int8 and fp8 TransformerLM's graphed decode step equals its
  uncaptured step (1e-6 on the logits: the same kernels replayed), and its
  ``output()`` in float32 is within 1e-4 of the same quantized network in
  float64 (float32 rounding through 2 blocks, ~1e-6 relative).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.generate import GenerationSession
from deeplearning4j_tpu_torch.model.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.rewrite import quantize as pq
from deeplearning4j_tpu_torch.nn.rewrite import rewrite_model

pytestmark = pytest.mark.cuda

TOL_GRAPH = 1e-6
TOL_F32_VS_F64 = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch._int_mm and the decode graph run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(64, 800, 504), (5, 13, 6), (17, 24, 9), (300, 7, 3),
                                   (16, 64, 64), (17, 64, 64), (40, 32, 504), (48, 16, 33),
                                   (33, 768, 3072)])
def test_int8_matmul_exact_on_the_card(cuda, m, k, n):
    g = torch.Generator().manual_seed(m * 1000 + k * 10 + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    got = pq.int8_matmul(a.to(cuda), b.to(cuda))
    assert got.is_cuda and got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.cpu(), pq.int8_matmul(a, b))


def test_calibrated_dense_accumulators_equal_the_cpus(cuda):
    g = torch.Generator().manual_seed(3)
    layer = pq.QuantizedDenseLayer(n_in=40, n_out=12, act_absmax=1.7, quant_dtype="int8")
    w_q, w_s = pq.quantize_weight(torch.randn(40, 12, generator=g), "int8", channel_axis=1)
    x = 2.0 * torch.rand(33, 40, generator=g) - 1.0
    params = {"W_q": w_q, "W_scale": w_s, "b": torch.zeros(12)}
    acc_cpu, _ = layer.int32_accumulators(params, x)
    acc, _ = layer.int32_accumulators({k: v.to(cuda) for k, v in params.items()}, x.to(cuda))
    assert acc.is_cuda and torch.equal(acc.cpu(), acc_cpu)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantize_weight_on_the_card_equals_the_cpus(cuda, qdtype):
    w = torch.randn(6, 5, 3, 3, generator=torch.Generator().manual_seed(4))
    q, s = pq.quantize_weight(w.to(cuda), qdtype, channel_axis=0)
    q_cpu, s_cpu = pq.quantize_weight(w, qdtype, channel_axis=0)
    assert q.is_cuda and s.is_cuda
    assert torch.equal(q.cpu().view(torch.uint8), q_cpu.view(torch.uint8))
    assert torch.equal(s.cpu(), s_cpu)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantized_lm_graph_and_float64(cuda, qdtype):
    kw = dict(vocab_size=97, hidden=64, n_layers=2, n_heads=4, max_len=64, seed=5)
    lm = TransformerLM(**kw).init(device=cuda)
    qm, applied = rewrite_model(lm, f"inference:{qdtype}")
    assert applied == [f"quantize_weights_{qdtype}"]
    assert qm.params["layer_2"]["W1_q"].is_cuda
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [10, 11]]
    session = GenerationSession(qm, max_len=64)
    carry_g, logits, _ = session.prefill(prompts)
    carry_e, _, _ = session.prefill(prompts)
    toks = torch.argmax(logits, dim=-1)
    worst = 0.0
    for _ in range(6):
        carry_g, lg = session.decode(carry_g, toks)
        with torch.no_grad():
            le = session.step(carry_e, toks.to(torch.int32))
        worst = max(worst, float((lg - le).abs().max()))
        toks = torch.argmax(lg, dim=-1)
    entry = session._graphs.get(len(prompts))
    assert entry is not None and entry.step is not None
    session.release_graphs()
    assert worst <= TOL_GRAPH
    ids = np.random.RandomState(6).randint(0, 97, (2, 40))
    lm64 = TransformerLM(**dict(kw, dtype="float64")).init(device=cuda)
    lm64.set_params_flat(lm.params_flat())
    q64, _ = rewrite_model(lm64, f"inference:{qdtype}")
    # the same quantized values: the scale math runs in float64 either way
    assert torch.equal(q64.params["layer_2"]["W1_q"].view(torch.uint8),
                       qm.params["layer_2"]["W1_q"].view(torch.uint8))
    out, ref = qm.output(ids).double(), q64.output(ids)
    assert float((out - ref).abs().max() / ref.abs().max()) <= TOL_F32_VS_F64
