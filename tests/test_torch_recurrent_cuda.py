"""The port's recurrent layers, LearnedSelfAttentionLayer and the char-RNN's
graphed decode on the card.

These tests need a CUDA device and skip without one. Where there is one
(and, as on the chip machine, no JAX for ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_recurrent_cuda.py

* Every recurrent layer and both attention layers, with a ragged mask, in
  float64 on the card against the same layer on the CPU: the output and the
  gradients of ``sum(out * R)`` with respect to the input and every
  parameter within 1e-12 of the largest (the same float64 operations; the
  card's products sum in another order, ~1e-16 each).
* LearnedSelfAttention in float32 on the card (B1 with tq = n_queries,
  non-causal, key mask, and B2/B3 in its backward) against float64 on the
  CPU: within 1e-5 of the largest value (3xTF32 products and float32 sums).
* The char-RNN's decode: ``GenerationSession.decode`` replays a CUDA graph
  from its third step, and its logits stay within 1e-6 of the uncaptured
  step's on a copy of the carry, for 12 steps; greedy ``generate()`` on the
  card equals the CPU's on the same weights in float64. The same for a
  causal RecurrentAttentionLayer, whose carry also holds the inputs seen
  so far (``cache_x``, copied into the carry inside the graph).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.generate import GenerationSession
from deeplearning4j_tpu_torch.model.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.nn import (Activation, InputType, LossFunction,
                                         NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (BidirectionalLayer, BidirectionalMode,
                                                DenseLayer, GravesLSTMLayer, GRULayer,
                                                LastTimeStepLayer, LayerContext,
                                                LearnedSelfAttentionLayer, LSTMLayer,
                                                MaskZeroLayer, RecurrentAttentionLayer,
                                                RnnOutputLayer, SimpleRnnLayer,
                                                TimeDistributedLayer)
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

pytestmark = pytest.mark.cuda

TOL_F64 = 1e-12
TOL_F32 = 1e-5

LAYERS = {
    "lstm": lambda: LSTMLayer(n_in=6, n_out=16),
    "graves_lstm": lambda: GravesLSTMLayer(n_in=6, n_out=16),
    "gru": lambda: GRULayer(n_in=6, n_out=16),
    "gru_reset_before": lambda: GRULayer(n_in=6, n_out=16, reset_after=False),
    "simple_rnn": lambda: SimpleRnnLayer(n_in=6, n_out=16),
    "bidirectional": lambda: BidirectionalLayer(fwd=GravesLSTMLayer(n_in=6, n_out=8),
                                                mode=BidirectionalMode.CONCAT),
    "last_time_step": lambda: LastTimeStepLayer(underlying=LSTMLayer(n_in=6, n_out=8)),
    "mask_zero": lambda: MaskZeroLayer(underlying=SimpleRnnLayer(n_in=6, n_out=8)),
    "time_distributed": lambda: TimeDistributedLayer(underlying=DenseLayer(n_in=6, n_out=8)),
    "learned_attention": lambda: LearnedSelfAttentionLayer(n_in=6, n_out=16, n_heads=2,
                                                           n_queries=3),
    "recurrent_attention": lambda: RecurrentAttentionLayer(n_in=6, n_out=8, causal=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the layers' card path runs only there")
    return torch.device("cuda")


def _run(layer, params, x, mask, device, dtype):
    p = {k: v.to(device=device, dtype=dtype).requires_grad_(True) for k, v in params.items()}
    xx = x.to(device=device, dtype=dtype).requires_grad_(True)
    ctx = LayerContext(mask=mask.to(device=device, dtype=dtype))
    y, _ = layer.apply(p, {}, xx, ctx)
    r = torch.from_numpy(np.random.RandomState(1).randn(*y.shape)).to(device=device, dtype=dtype)
    (y * r).sum().backward()
    return y.detach().cpu().double(), {"x": xx.grad.cpu().double(),
                                       **{k: v.grad.cpu().double() for k, v in p.items()}}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _inputs():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 6, 11), generator=gen, dtype=torch.float64)
    mask = (torch.arange(11)[None, :] < torch.tensor([11, 7, 2])[:, None]).double()
    return x, mask


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_on_card_matches_cpu_float64(cuda, name):
    layer = LAYERS[name]()
    params = layer.init(torch.Generator().manual_seed(3), torch.float64) if layer.has_params() else {}
    x, mask = _inputs()
    y_c, g_c = _run(layer, params, x, mask, cuda, torch.float64)
    y_h, g_h = _run(layer, params, x, mask, torch.device("cpu"), torch.float64)
    assert _rel(y_c, y_h) < TOL_F64
    for k in g_h:
        assert _rel(g_c[k], g_h[k]) < TOL_F64, k


def test_learned_attention_float32_through_the_kernels(cuda):
    from deeplearning4j_tpu_torch import ops

    layer = LAYERS["learned_attention"]()
    params = layer.init(torch.Generator().manual_seed(3), torch.float64)
    x, mask = _inputs()
    ops.reset_launch_counts()
    y_c, g_c = _run(layer, params, x, mask, cuda, torch.float32)
    assert ops.LAUNCH_COUNTS["flash_forward"] == 1
    assert ops.LAUNCH_COUNTS["flash_bwd_dq"] == 1 and ops.LAUNCH_COUNTS["flash_bwd_dkv"] == 1
    y_h, g_h = _run(layer, params, x, mask, torch.device("cpu"), torch.float64)
    assert _rel(y_c, y_h) < TOL_F32
    for k in g_h:
        assert _rel(g_c[k], g_h[k]) < TOL_F32, k


PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [10], [11, 12, 13, 14]]


def _graph_vs_eager(model, prompts):
    session = GenerationSession(model, max_len=64)
    carry_g, logits, _ = session.prefill(prompts)
    carry_e, _, _ = session.prefill(prompts)
    toks = torch.argmax(logits, dim=-1)
    for step in range(12):
        carry_g, lg = session.decode(carry_g, toks)
        with torch.no_grad():
            le = session.step(carry_e, toks.to(torch.int32))
        assert float((lg - le).abs().max()) <= 1e-6
        toks = torch.argmax(lg, dim=-1)
    assert session._graphs[len(prompts)].step is not None
    session.release_graphs()


def test_char_rnn_graphed_decode_matches_eager_and_cpu(cuda):
    tg = TextGenerationLSTM(vocab_size=29, hidden=32, dtype="float64")
    model = tg.init()
    _graph_vs_eager(model, PROMPTS)
    cpu = tg.init(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    assert (TextGenerationLSTM.generate(model, PROMPTS, 20, max_len=64)
            == TextGenerationLSTM.generate(cpu, PROMPTS, 20, max_len=64))


def test_recurrent_attention_graphed_decode_matches_eager_and_cpu(cuda):
    conf = (NeuralNetConfiguration.builder().seed(5).data_type("float64").list()
            .layer(RecurrentAttentionLayer(n_out=16, causal=True))
            .layer(RnnOutputLayer(n_out=29, loss=LossFunction.MCXENT,
                                  activation=Activation.SOFTMAX))
            .set_input_type(InputType.recurrent(29)).build())
    model = MultiLayerNetwork(conf).init()
    _graph_vs_eager(model, PROMPTS)
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    assert (GenerationSession(model, max_len=64).generate(PROMPTS, 20)
            == GenerationSession(cpu, max_len=64).generate(PROMPTS, 20))
