"""TextGenerationLSTM — the GravesLSTM char-RNN (port of
``deeplearning4j_tpu/model/zoo/textgen_lstm.py``).

Reference: org.deeplearning4j.zoo.model.TextGenerationLSTM: stacked
GravesLSTM (peephole) layers over one-hot character input with an
RnnOutputLayer, trained by truncated BPTT. :meth:`generate` samples from
the carried (h, c) state: the prompt is consumed once and each further
character costs one single-step forward (on the card, a CUDA graph
replay).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ...nn import Activation, InputType, LossFunction, NeuralNetConfiguration, WeightInit
from ...nn.conf import BackpropType
from ...nn.layers import GravesLSTMLayer, RnnOutputLayer
from ...nn.sequential import MultiLayerNetwork
from ...train.updaters import RmsProp


class TextGenerationLSTM:
    def __init__(self, vocab_size: int = 77, hidden: int = 200,
                 layers: int = 2, tbptt_length: int = 50, seed: int = 123,
                 updater=None, dtype: str = "float32") -> None:
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.tbptt_length = tbptt_length
        self.seed = seed
        self.updater = updater or RmsProp(1e-3)
        self.dtype = dtype

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).data_type(self.dtype).updater(self.updater)
             .weight_init(WeightInit.XAVIER).list())
        for _ in range(self.layers):
            b.layer(GravesLSTMLayer(n_out=self.hidden, activation=Activation.TANH))
        b.layer(RnnOutputLayer(n_out=self.vocab_size, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
        return (b.set_input_type(InputType.recurrent(self.vocab_size))
                .backprop_type(BackpropType.TRUNCATED_BPTT)
                .tbptt_fwd_length(self.tbptt_length)
                .tbptt_back_length(self.tbptt_length)
                .build())

    def init(self, device: Optional[Union[str, torch.device]] = None) -> MultiLayerNetwork:
        """The network with seeded random weights, on ``device`` (default:
        the current CUDA device)."""
        return MultiLayerNetwork(self.conf(), device=device).init()

    @staticmethod
    def generate(
        model: MultiLayerNetwork,
        prompts: Sequence[Sequence[int]],
        max_tokens: int,
        *,
        max_len: int = 256,
        greedy: bool = True,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
    ) -> List[List[int]]:
        """Sample continuations for character-id prompts from a trained
        char-RNN (ids one-hot encoded internally; the recurrent (h, c)
        carry threads through the decode so the prefix never re-runs)."""
        from ...generate import GenerationSession

        session = GenerationSession(model, max_len=max_len)
        return session.generate(
            prompts, max_tokens, greedy=greedy, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed, eos_id=eos_id)
