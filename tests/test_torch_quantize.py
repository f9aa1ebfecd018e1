"""The port's post-training quantization (``nn/rewrite/quantize.py``) against
the JAX package's, on the CPU, with the same weights.

* ``quantize_weight``: int8 values and fp8 (e4m3) bytes bit-equal to
  JAX's, float32 scales equal, over per-channel, conv, tuple (per-expert)
  and all-zero-channel cases.
* Each quantized layer, in float64 within 1e-10 of JAX's on networks the
  pass rewrites in both packages (the quantized parameters bit-equal):
  Dense on feed-forward and sequence input, Convolution (after the fold),
  SelfAttention (masked, and causal), the TransformerLM's decoder blocks,
  BERT's graph, and the MoE layer in einsum, sort and grouped dispatch —
  in int8 and fp8.
* Calibrated activation quantization: ``calibrate`` ranges equal to JAX's,
  the int32 accumulators of every calibrated Dense layer exactly JAX's, the
  output within 1e-10.
* The quantized LM's greedy decode equals JAX's stream token for token.
* The config JSON of a quantized network round-trips through both
  packages; the quantized layers are never initialized or trained.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.core.config import from_json as jax_from_json
from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.generate import GenerationSession as JaxSession
from deeplearning4j_tpu.model.zoo import BertEncoder as JaxBert
from deeplearning4j_tpu.model.zoo import LeNet as JaxLeNet
from deeplearning4j_tpu.model.zoo import TransformerLM as JaxLM
from deeplearning4j_tpu.nn import (Activation as JA, InputType as JIT,
                                   LossFunction as JL, NeuralNetConfiguration as JNNC)
from deeplearning4j_tpu.nn import rewrite as jrw
from deeplearning4j_tpu.nn.layers import (DenseLayer as JDense,
                                          MixtureOfExpertsLayer as JMoE,
                                          OutputLayer as JOut, RnnOutputLayer as JRnnOut,
                                          SelfAttentionLayer as JSA)
from deeplearning4j_tpu.nn.rewrite import quantize as jq

from deeplearning4j_tpu_torch.core.config import from_json, to_json
from deeplearning4j_tpu_torch.generate import GenerationSession
from deeplearning4j_tpu_torch.nn import rewrite as prw
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.rewrite import quantize as pq
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

from torch_rewrite_helpers import pair, stem_conf

TOL = 1e-10


# ---------------------------------------------------------------------------
# quantize_weight
# ---------------------------------------------------------------------------

def _weights(shape, seed=0, zero_channel=None):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if zero_channel is not None:
        axis, idx = zero_channel
        np.moveaxis(w, axis, 0)[idx] = 0.0
    return w


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("shape,axis,zero", [
    ((16, 12), 1, None), ((16, 12), -1, (1, 3)), ((6, 3, 5, 5), 0, (0, 2)),
    ((4, 8, 10), (0, 2), None), ((7,), 0, None)],
    ids=["dense", "dense-zero-channel", "conv", "expert-slab", "vector"])
def test_quantize_weight_bit_equal(qdtype, shape, axis, zero):
    w = _weights(shape, seed=len(shape), zero_channel=zero)
    jqw, js = jq.quantize_weight(jnp.asarray(w), qdtype, channel_axis=axis)
    pqw, ps = pq.quantize_weight(torch.from_numpy(w), qdtype, channel_axis=axis)
    assert ps.dtype == torch.float32 and np.array_equal(ps.numpy(), np.asarray(js))
    if qdtype == "int8":
        assert pqw.dtype == torch.int8 and np.array_equal(pqw.numpy(), np.asarray(jqw))
    else:
        assert pqw.dtype == torch.float8_e4m3fn
        assert np.array_equal(pqw.view(torch.uint8).numpy(),
                              np.asarray(jqw).view(np.uint8))
    # numpy and float64 inputs quantize the same way
    p2, s2 = pq.quantize_weight(w.astype(np.float64), qdtype, channel_axis=axis)
    assert torch.equal(p2.view(torch.uint8), pqw.view(torch.uint8)) and torch.equal(s2, ps)


def test_quantize_weight_rejects_unknown_dtype():
    with pytest.raises(ValueError) as e:
        jq.quantize_weight(jnp.ones((2, 2)), "int4")
    with pytest.raises(ValueError) as got:
        pq.quantize_weight(torch.ones(2, 2), "int4")
    assert str(got.value) == str(e.value)
    with pytest.raises(ValueError) as e:
        jq.QuantizeWeightsPass("int4")
    with pytest.raises(ValueError) as got:
        pq.QuantizeWeightsPass("int4")
    assert str(got.value) == str(e.value)


# ---------------------------------------------------------------------------
# the quantized layers, network by network
# ---------------------------------------------------------------------------

def _seq(*layers, input_type, seed=11):
    b = JNNC.builder().seed(seed).data_type("float64").list()
    for l in layers:
        b.layer(l)
    return b.set_input_type(input_type).build()


def _net(kind):
    """(JAX config, input, [b, t] mask or None) of one test network."""
    rs = np.random.RandomState(3)
    if kind == "dense":
        conf = _seq(JDense(n_out=16, activation=JA.RELU), JDense(n_out=8, activation=JA.TANH),
                    JOut(n_out=3, loss=JL.MCXENT, activation=JA.SOFTMAX),
                    input_type=JIT.feed_forward(8))
        return conf, rs.randn(5, 8), None
    if kind == "dense-sequence":
        conf = _seq(JDense(n_out=12, activation=JA.RELU),
                    JRnnOut(n_out=4, loss=JL.MCXENT, activation=JA.SOFTMAX),
                    input_type=JIT.recurrent(6, 5))
        return conf, rs.randn(3, 6, 5), None
    if kind == "conv":
        return stem_conf(True), rs.rand(2, 3, 16, 16), None
    if kind.startswith("attention"):
        causal = kind.endswith("causal")
        conf = _seq(JSA(n_out=8, n_heads=2, causal=causal),
                    JRnnOut(n_out=4, loss=JL.MCXENT, activation=JA.SOFTMAX),
                    input_type=JIT.recurrent(6, 7))
        mask = np.ones((3, 7))
        mask[1, 4:] = 0.0
        mask[2, 2:] = 0.0
        return conf, rs.randn(3, 6, 7), mask
    if kind.startswith("moe"):
        mode = kind.split("-")[1]
        conf = _seq(JMoE(n_out=8, num_experts=4, hidden=16, top_k=2, dispatch_mode=mode),
                    JOut(n_out=3, loss=JL.MCXENT, activation=JA.SOFTMAX),
                    input_type=JIT.feed_forward(8))
        return conf, rs.rand(16, 8), None
    if kind == "lm":
        conf = JaxLM(vocab_size=23, hidden=16, n_layers=2, n_heads=2, max_len=12,
                     dtype="float64").conf()
        return conf, rs.randint(0, 23, (3, 9)), None
    if kind == "bert":
        conf = JaxBert(vocab_size=30, hidden=16, n_layers=2, n_heads=2, ffn_size=32,
                       max_len=10, dtype="float64").conf()
        mask = np.ones((2, 9))
        mask[1, 5:] = 0.0
        return conf, rs.randint(0, 30, (2, 9)), mask
    raise ValueError(kind)


def _output(m, x, mask):
    if isinstance(m, ComputationGraph) or hasattr(m.conf, "vertices"):
        out = m.output(x, masks=None if mask is None else [mask])
    else:
        out = m.output(x, mask)
    out = out[0] if isinstance(out, tuple) else out
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _quantized_params_equal(pm, jm) -> None:
    for l, lp in pm.params.items():
        assert sorted(lp) == sorted(jm.params[l]), l
        for k, p in lp.items():
            want = np.asarray(jm.params[l][k])
            got = p.detach()
            if got.dtype == torch.float8_e4m3fn:
                assert np.array_equal(got.view(torch.uint8).numpy(), want.view(np.uint8)), (l, k)
            else:
                assert np.array_equal(got.numpy(), want), (l, k)


_QUANTIZED = {
    "dense": 2, "dense-sequence": 1, "conv": 2, "attention": 1, "attention-causal": 1,
    "moe-einsum": 1, "moe-sort": 1, "moe-grouped": 1, "lm": 2, "bert": None,
}


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("kind", sorted(_QUANTIZED))
def test_quantized_network_matches_jax(kind, qdtype):
    jconf, x, mask = _net(kind)
    pm, jm = pair(jconf)
    spec = f"inference:{qdtype}"
    qm, applied = prw.rewrite_model(pm, spec)
    jqm, japplied = jrw.rewrite_model(jm, spec)
    assert applied == japplied and applied[-1] == f"quantize_weights_{qdtype}"
    assert json.loads(to_json(qm.conf)) == json.loads(jax_to_json(jqm.conf))
    n = prw.count_quantized_layers(qm)
    assert n == jrw.count_quantized_layers(jqm) > 0
    if _QUANTIZED[kind] is not None:
        assert n == _QUANTIZED[kind]
    _quantized_params_equal(qm, jqm)
    for lp in qm.params.values():
        for k, p in lp.items():
            if k.endswith("_q"):
                assert p.dtype == pq._quant_storage_dtype(qdtype) and not p.requires_grad
            if k.endswith("_scale"):
                assert p.dtype == torch.float32
    got = _output(qm, x, mask)
    assert np.abs(got - _output(jqm, x, mask)).max() <= TOL
    # a bounded, nonzero rounding error against the full-precision network
    base = _output(pm, x, mask)
    err = np.abs(got - base).max() / np.abs(base).max()
    assert 0.0 < err < 0.2, err
    # the pass is idempotent
    again, ap2 = prw.rewrite_model(qm, [prw.QuantizeWeightsPass(qdtype)])
    assert again is qm and ap2 == []


def test_quantized_layers_are_never_initialized_or_trained():
    jconf, x, _ = _net("dense")
    pm, _ = pair(jconf)
    qm, _ = prw.rewrite_model(pm, "inference:int8")
    for layer in qm.layers[:2]:
        assert isinstance(layer, pq.QuantizedDenseLayer)
        assert layer.trainable_param_names() == ()
        with pytest.raises(RuntimeError, match="rewrite product"):
            layer.init(torch.Generator(), torch.float64)
    with pytest.raises(RuntimeError, match="rewrite product"):
        MultiLayerNetwork(qm.conf, device="cpu").init()


def test_quantized_config_json_round_trips_both_ways():
    jconf, _, _ = _net("lm")
    pm, jm = pair(jconf)
    qm, _ = prw.rewrite_model(pm, [prw.QuantizeWeightsPass("fp8")])
    jqm, _ = jrw.rewrite_model(jm, [jrw.QuantizeWeightsPass("fp8")])
    jdoc = jax_to_json(jqm.conf)
    pconf = from_json(jdoc)
    assert [type(l).__name__ for l in pconf.layers] == [type(l).__name__ for l in jqm.conf.layers]
    assert isinstance(pconf.layers[2], pq.QuantizedTransformerDecoderBlockLayer)
    assert pconf.layers[2].quant_dtype == "fp8"
    assert json.loads(to_json(pconf)) == json.loads(jdoc) == json.loads(to_json(qm.conf))
    back = jax_from_json(to_json(qm.conf))
    assert type(back.layers[2]) is jq.QuantizedTransformerDecoderBlockLayer


# ---------------------------------------------------------------------------
# calibrated activation quantization
# ---------------------------------------------------------------------------

def _lenet_pair():
    return pair(JaxLeNet(dtype="float64").conf())


def test_calibrate_ranges_equal_jax():
    pm, jm = _lenet_pair()
    rs = np.random.RandomState(5)
    batches = [rs.rand(4, 784), 2.0 * rs.rand(3, 784)]
    want = jq.calibrate(jm, batches)
    got = pq.calibrate(pm, batches)
    # the dense layer's input comes out of two convolutions, summed in
    # another order by each package: the ranges agree to float64 rounding
    assert sorted(got) == sorted(want) == ["layer_6"]
    assert abs(got["layer_6"] - want["layer_6"]) <= TOL * want["layer_6"]
    with pytest.raises(ValueError, match="MultiLayerNetwork"):
        pq.calibrate(ComputationGraph(from_json(jax_to_json(_net("bert")[0])),
                                      device="cpu"), batches)


def _jax_accumulators(layer, params, x2):
    xq, _ = jq._act_quantize(jnp.asarray(x2), layer.act_absmax)
    return np.asarray(jax.lax.dot_general(xq, params["W_q"], (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))


@pytest.mark.parametrize("absmax_scale", [1.0, 0.5], ids=["calibrated", "clipping"])
def test_calibrated_int32_accumulators_exact(absmax_scale):
    pm, jm = _lenet_pair()
    rs = np.random.RandomState(6)
    batches = [rs.rand(8, 784)]
    ranges = {k: v * absmax_scale for k, v in pq.calibrate(pm, batches).items()}
    qm, _ = prw.rewrite_model(pm, [prw.QuantizeWeightsPass("int8", act_ranges=ranges)])
    jqm, _ = jrw.rewrite_model(jm, [jrw.QuantizeWeightsPass("int8", act_ranges=ranges)])
    layer = qm.conf.layers[6]
    assert isinstance(layer, pq.QuantizedDenseLayer) and layer.act_absmax == ranges["layer_6"]
    assert jqm.conf.layers[6].act_absmax == layer.act_absmax
    x = 1.5 * rs.rand(5, 784)
    with torch.inference_mode():
        _, _, _, acts = qm.forward_pure(qm.params, qm.state, torch.from_numpy(x), collect=True)
        dense_in = acts[5]
        acc, sx = layer.int32_accumulators(qm.params["layer_6"], dense_in)
    assert acc.dtype == torch.int32
    want = _jax_accumulators(jqm.conf.layers[6], jqm.params["layer_6"], dense_in.numpy())
    assert np.array_equal(acc.numpy(), want)
    assert np.abs(qm.output(x).numpy() - np.asarray(jqm.output(x))).max() <= TOL


def test_int8_matmul_exact_against_int64():
    rs = np.random.RandomState(7)
    a = torch.from_numpy(rs.randint(-127, 128, (5, 13)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-127, 128, (13, 6)).astype(np.int8))
    got = pq.int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ b.long())
    # a product that wraps in int8 (torch's int8 matmul) stays exact here
    big = torch.full((2, 64), 127, dtype=torch.int8)
    assert int(pq.int8_matmul(big, big.T.contiguous())[0, 0]) == 64 * 127 * 127


# ---------------------------------------------------------------------------
# the quantized LM decodes as JAX's does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantized_lm_greedy_stream_equals_jax(qdtype):
    jconf = JaxLM(vocab_size=23, hidden=32, n_layers=2, n_heads=4, max_len=24,
                  dtype="float64").conf()
    pm, jm = pair(jconf)
    qm, _ = prw.rewrite_model(pm, f"inference:{qdtype}")
    jqm, _ = jrw.rewrite_model(jm, f"inference:{qdtype}")
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [2, 2]]
    want = JaxSession(jqm, max_len=24).generate(prompts, 8)
    got = GenerationSession(qm, max_len=24).generate(prompts, 8)
    assert [list(map(int, r)) for r in got] == [list(map(int, r)) for r in want]
    # the cached decode agrees with a full forward of the quantized network
    session = GenerationSession(qm, max_len=24)
    carry, logits, _ = session.prefill(prompts)
    seq = [p + [int(t)] for p, t in zip(prompts, torch.argmax(logits, -1))]
    width = max(len(s) for s in seq)
    ids = np.zeros((3, width), np.int64)
    mask = np.zeros((3, width))
    for i, s in enumerate(seq):
        ids[i, :len(s)], mask[i, :len(s)] = s, 1.0
    full = qm.output(ids, mask)
    _, step = session.decode(carry, [s[-1] for s in seq])
    for i, s in enumerate(seq):
        ref = torch.log(full[i, :, len(s) - 1])
        assert float((step[i] - ref).abs().max()) <= 1e-9


def test_quantized_dataclass_fields_extend_the_full_precision_layers():
    for q, base, extra in ((pq.QuantizedDenseLayer, "DenseLayer", {"quant_dtype", "act_absmax"}),
                           (pq.QuantizedMixtureOfExpertsLayer, "MixtureOfExpertsLayer",
                            {"quant_dtype"})):
        parent = q.__mro__[1]
        assert parent.__name__ == base
        assert {f.name for f in dataclasses.fields(q)} - \
            {f.name for f in dataclasses.fields(parent)} == extra
