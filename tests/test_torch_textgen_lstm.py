"""The port's TextGenerationLSTM and recurrent decode against the JAX
package's, on the CPU in float64, with the JAX model's weights through its
zip.

* The zoo configuration is the JAX one, field for field (its JSON is
  equal), and ``init`` builds the published parameter shapes.
* A JAX TextGenerationLSTM zip loaded by the port: ``output()`` within
  1e-10, and greedy ``generate()`` on ragged prompts equal character for
  character; every greedy character is the argmax of a full forward over
  the sequence so far (the decode carry is exact, not approximate).
* Recurrent carries through ``GenerationSession``: a GRU / SimpleRnn stack
  and a causal RecurrentAttentionLayer (its ``cache_x`` carry) give JAX's
  greedy tokens. The rejections stay as in JAX: a bidirectional model has
  no decode state, and speculative decoding refuses recurrent carries.
"""

import tempfile

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.layers as jlayers
from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.generate import GenerationSession as JaxSession
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo import TextGenerationLSTM as JaxTextGen
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN

import deeplearning4j_tpu_torch.nn as pnn
import deeplearning4j_tpu_torch.nn.layers as players
from deeplearning4j_tpu_torch.core.config import to_json
from deeplearning4j_tpu_torch.generate import GenerationSession, SpeculativeGenerationSession
from deeplearning4j_tpu_torch.model import restore_model
from deeplearning4j_tpu_torch.model.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

TOL = 1e-10
V = 13
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [12], [0, 11, 2, 2, 5]]


def _zip_of(jm):
    path = tempfile.mkdtemp() + "/m.zip"
    jax_write(jm, path)
    return path


def test_conf_matches_jax_and_default_shapes():
    assert to_json(TextGenerationLSTM().conf()) == jax_to_json(JaxTextGen().conf())
    net = TextGenerationLSTM().init(device="cpu")
    shapes = {f"{l}.{k}": tuple(v.shape) for l, lp in net.params.items() for k, v in lp.items()}
    assert shapes == {
        "layer_0.W": (77, 800), "layer_0.RW": (200, 800), "layer_0.b": (800,),
        "layer_0.P": (3, 200),
        "layer_1.W": (200, 800), "layer_1.RW": (200, 800), "layer_1.b": (800,),
        "layer_1.P": (3, 200),
        "layer_2.W": (200, 77), "layer_2.b": (77,),
    }
    assert float(net.params["layer_0"]["b"].detach()[200:400].min()) == 1.0  # forget-gate bias


@pytest.fixture(scope="module")
def pair():
    jm = JaxTextGen(vocab_size=V, hidden=16, layers=2, tbptt_length=5, dtype="float64").init()
    return jm, restore_model(_zip_of(jm), device="cpu")


def test_zip_output_matches_jax(pair):
    jm, pm = pair
    ids = np.random.RandomState(0).randint(0, V, (3, 12))
    x = np.eye(V)[ids].transpose(0, 2, 1)
    assert np.abs(np.asarray(jm.output(x)) - pm.output(x).numpy()).max() < TOL


def _full_greedy_next(model, seq):
    x = torch.nn.functional.one_hot(torch.tensor([seq]), V).double().transpose(1, 2)
    return int(torch.argmax(model.output(x)[0, :, -1]))


def test_greedy_generate_matches_jax(pair):
    jm, pm = pair
    jout = JaxTextGen.generate(jm, PROMPTS, 12, max_len=32)
    pout = TextGenerationLSTM.generate(pm, PROMPTS, 12, max_len=32)
    assert pout == jout
    for p, got in zip(PROMPTS, pout):
        seq = list(p)
        for tok in got:
            assert tok == _full_greedy_next(pm, seq)
            seq.append(tok)


def _decode_net(pkg, kind):
    nn_, L = pkg
    b = (nn_.NeuralNetConfiguration.builder().seed(6).data_type("float64")
         .weight_init(nn_.WeightInit.XAVIER).list())
    if kind == "gru_rnn":
        b.layer(L.GRULayer(n_out=8)).layer(L.SimpleRnnLayer(n_out=7))
    elif kind == "recurrent_attention":
        b.layer(L.RecurrentAttentionLayer(n_out=8, causal=True))
    else:
        b.layer(L.BidirectionalLayer(fwd=L.LSTMLayer(n_out=4)))
    b.layer(L.RnnOutputLayer(n_out=V, loss=nn_.LossFunction.MCXENT,
                             activation=nn_.Activation.SOFTMAX))
    return b.set_input_type(nn_.InputType.recurrent(V)).build()


@pytest.mark.parametrize("kind", ["gru_rnn", "recurrent_attention"])
def test_recurrent_carries_decode_like_jax(kind):
    jm = JaxMLN(_decode_net((jnn, jlayers), kind)).init()
    pm = restore_model(_zip_of(jm), device="cpu")
    jout = JaxSession(jm, max_len=16).generate(PROMPTS, 8, greedy=True)
    sess = GenerationSession(pm, max_len=16)
    assert sess.generate(PROMPTS, 8, greedy=True) == jout
    if kind == "recurrent_attention":
        carry = sess.decode_state(2)["layer_0"]
        assert set(carry) == {"h", "cache_x", "pos"}
        assert tuple(carry["cache_x"].shape) == (2, 16, V)


def test_rejections_stay_as_in_jax(pair):
    _, pm = pair
    bi = MultiLayerNetwork(_decode_net((pnn, players), "bidirectional"), device="cpu").init()
    with pytest.raises(ValueError, match="decode_state"):
        GenerationSession(bi, max_len=16)
    with pytest.raises(ValueError, match="recurrent h/c"):
        SpeculativeGenerationSession(pm, pm, max_len=16)
