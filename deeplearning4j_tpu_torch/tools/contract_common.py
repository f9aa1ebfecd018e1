"""Shared helpers of the port's real-HTTP contract checks
(``deeplearning4j_tpu_torch/tools/check_*_contract.py``): the port's copy of
the JAX package's ``tools/contract_common.py`` (``start_http_server``), plus
the models the checks run on and their command line.

Every check binds its servers to OS-assigned ports (``port=0``): the kernel
hands out a free port, so a collision is all but impossible. The residual
race (a pinned-port rebind when a killed host is revived, or two checks
landing in the same SO_REUSEADDR window) surfaces as ``EADDRINUSE``;
:func:`start_http_server` turns it into one bounded retry.

Sizes (``--model``): ``tiny`` is each JAX harness's own model, for the CPU;
``lm`` is the ``TransformerLM`` at GPT-2 small's widths (vocab 50257, hidden
768, 12 blocks, 12 heads, ffn 3072, 1024 positions, float32), for the card.
A caller may pass a built network instead of either name.
"""

from __future__ import annotations

import argparse
import errno
import time

GPT2_SMALL = dict(vocab_size=50257, hidden=768, n_layers=12, n_heads=12,
                  ffn_size=3072, max_len=1024, dtype="float32")
LM_SEED = 1234
# 2 of GPT-2 small's 12 blocks: the size of a model a registry or a
# multiplexer publishes and pages whole (92.2 M params, ~369 MB in float32)
PAGED_LAYERS = 2
# ids a /v1/serving row holds on the LM: each answer is 50257 x this many
# probabilities of JSON, whose encoding, not the forward, sets the pace
LM_ROW_TOKENS = 1


def start_http_server(make_server, *, attempts: int = 2,
                      backoff_s: float = 0.2):
    """Construct-and-start a server via ``make_server()`` (which must
    bind the port: pass ``port=0`` for an OS-assigned one), retrying on
    ``EADDRINUSE``. Any other ``OSError`` propagates immediately."""
    last = None
    for i in range(max(1, int(attempts))):
        try:
            return make_server()
        except OSError as e:
            if e.errno != errno.EADDRINUSE:
                raise
            last = e
            time.sleep(backoff_s * (i + 1))
    raise last


def gpt2_lm(device=None, n_layers: int = 12, seed: int = LM_SEED):
    """The ``TransformerLM`` at GPT-2 small's widths, ``n_layers`` blocks."""
    from deeplearning4j_tpu_torch.model.zoo import TransformerLM

    return TransformerLM(seed=seed, **dict(GPT2_SMALL, n_layers=n_layers)).init(device=device)


def tiny_ff(seed: int, device, n_in: int = 4, hidden: int = 8, n_out: int = 3,
            dtype: str = "float32"):
    """The JAX harnesses' feed-forward network: Dense(n_in -> hidden) and an
    output layer (n_out classes), their default activations and loss."""
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.builder().seed(seed).data_type(dtype).list()
            .layer(DenseLayer(n_in=n_in, n_out=hidden))
            .layer(OutputLayer(n_in=hidden, n_out=n_out))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


class ServingWorkload:
    """What a serving check sends a network over ``/v1/serving``: float
    feature rows for a feed-forward network, rows of ``LM_ROW_TOKENS`` ids
    for a language model. ``width`` is the network's output width (the
    classes, or the LM's vocabulary); ``answer_shape`` the shape of the
    ``output`` of an answer to one row: [1, classes], or the LM's
    [vocab, LM_ROW_TOKENS] probabilities."""

    def __init__(self, model) -> None:
        self.model = model
        self.ids = model.keeps_int_input()
        self.width = model.layers[-1].n_out
        self.n_in = None if self.ids else model.layers[0].n_in
        self.answer_shape = (self.width, LM_ROW_TOKENS) if self.ids else (1, self.width)

    def answered(self, body: dict) -> bool:
        """Whether ``body`` answers one row: an ``output`` of ``answer_shape``."""
        out = body["output"]
        return (len(out), len(out[0])) == self.answer_shape

    @property
    def ok(self) -> list:
        """The fixed row of the JAX harnesses (``[[1.0, 2.0, 3.0, 4.0]]``)."""
        if self.ids:
            return [[(1 + i) % self.width for i in range(LM_ROW_TOKENS)]]
        return [[float(1 + i) for i in range(self.n_in)]]

    def constant(self, v: float) -> list:
        """A row of one value (an id for the LM)."""
        if self.ids:
            return [[int(v) % self.width] * LM_ROW_TOKENS]
        return [[float(v)] * self.n_in]

    def row(self, rng) -> list:
        """A random row from ``rng`` (a ``numpy.random.RandomState``)."""
        if self.ids:
            return rng.randint(0, self.width, (1, LM_ROW_TOKENS)).tolist()
        return rng.randn(1, self.n_in).round(3).tolist()


def serving_model(model, device, dtype: str = "float32"):
    """``model`` as a network: ``"tiny"`` -> the JAX harnesses' network
    (seed 5, in ``dtype``), ``"lm"`` -> the 12-block GPT-2-small-width LM,
    else itself."""
    if model == "tiny":
        return tiny_ff(5, device, dtype=dtype)
    if model == "lm":
        return gpt2_lm(device)
    return model


def cli(main, doc: str) -> int:
    """The command line of a check: ``--device`` (default the card),
    ``--model tiny|lm`` (default ``tiny`` on the CPU, ``lm`` on the card).
    Prints ``FAIL <reason>`` and returns 1 at the first gate that fails."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", choices=("tiny", "lm"), default=None)
    args = ap.parse_args()
    model = args.model or ("tiny" if args.device == "cpu" else "lm")
    try:
        return main(device=args.device, model=model,
                    log=lambda m: print(m, flush=True))
    except AssertionError as e:
        print(f"FAIL {e}", flush=True)
        return 1

