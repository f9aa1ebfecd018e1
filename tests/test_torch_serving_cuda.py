"""The port's HTTP serving stack on the card: a ``/v1/generate`` stream
through ``JsonModelServer`` over a ``DecodeEngine`` (its plain step a CUDA
graph of B4 launches), a prefill handoff resumed by the static and paged
engines, and ``ParallelInference`` serving ``output()`` (B1 in every
block) on its own stream while an engine captures and replays its graph
in the same process. The bucketed prefill attends through the reference
spelling, as in the JAX package, so it launches no B1.

These tests need a CUDA device and skip without one. On the chip machine
(no JAX there for ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_cuda.py

Tolerances: streams token for token against ``GenerationSession`` on the
card; ``ParallelInference`` outputs within 1e-6 of ``model.output`` (the
same float32 forward, batched with other rows)."""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops

from torch_serving_helpers import generate, get, tokens

pytestmark = pytest.mark.cuda

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 20]
N_TOK = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _small_lm(device, seed=4):
    from deeplearning4j_tpu_torch.model.zoo import TransformerLM

    return TransformerLM(vocab_size=97, hidden=64, n_layers=2, n_heads=2, max_len=64,
                         seed=seed).init(device=device)


def _want(model):
    from deeplearning4j_tpu_torch.generate import GenerationSession

    return GenerationSession(model, max_len=64).generate(PROMPTS, N_TOK)


def test_generate_stream_on_the_card(cuda):
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import DecodeEngine
    from deeplearning4j_tpu_torch.remote import JsonModelServer

    model = _small_lm(cuda)
    want = _want(model)
    reg = MetricsRegistry()
    eng = DecodeEngine(model, max_len=64, slots=4, registry=reg)
    srv = JsonModelServer(generator=eng, registry=reg).start()
    try:
        ops.reset_launch_counts()
        got = [tokens(generate(srv.port, p, max_tokens=N_TOK)) for p in PROMPTS]
        assert got == want
        assert ops.LAUNCH_COUNTS["flash_decode"] > 0
        assert "dl4j_tpu_generate_tokens_total" in get(srv.port, "/metrics")[2]
    finally:
        srv.stop()
        eng.shutdown()


@pytest.mark.parametrize("layout", [{}, {"block_size": 8}], ids=["static", "paged"])
def test_handoff_resume_on_the_card(cuda, layout):
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import DecodeEngine
    from deeplearning4j_tpu_torch.serving import (PrefillEngine, deserialize_handoff,
                                                  serialize_handoff)

    model = _small_lm(cuda)
    want = _want(model)
    pe = PrefillEngine(model, max_len=64, registry=MetricsRegistry())
    eng = DecodeEngine(model, max_len=64, slots=4, registry=MetricsRegistry(), **layout)
    try:
        ops.reset_launch_counts()
        handles = [eng.submit_prefilled(deserialize_handoff(serialize_handoff(
            pe.prefill(p, max_tokens=N_TOK)))) for p in PROMPTS]
        assert [h.result(timeout=120) for h in handles] == want
        assert all(h.reason == "completed" for h in handles)
        assert ops.LAUNCH_COUNTS["flash_decode"] > 0
        assert eng.handoff_copy["requests"] == len(PROMPTS)
    finally:
        eng.shutdown()


def test_parallel_inference_beside_a_graphed_engine(cuda):
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import DecodeEngine, ParallelInference

    model = _small_lm(cuda)
    want = _want(model)
    rs = np.random.RandomState(0)
    rows = [rs.randint(0, 97, (1, 16)) for _ in range(16)]
    ref = [model.output(r)[0].cpu().numpy() for r in rows]  # one row: [V, t]
    pi = ParallelInference(model, batch_limit=4, workers=2, registry=MetricsRegistry())
    eng = DecodeEngine(model, max_len=64, slots=4, registry=MetricsRegistry())
    outs = [None] * len(rows)

    def serve():
        for i, r in enumerate(rows):
            outs[i] = pi.output(r, timeout=120)

    try:
        t = threading.Thread(target=serve)
        ops.reset_launch_counts()
        handles = [eng.submit(p, max_tokens=N_TOK) for p in PROMPTS]
        t.start()
        got = [h.result(timeout=120) for h in handles]
        t.join(timeout=120)
        assert not t.is_alive()
        assert got == want and eng._graph is not None
        for o, r in zip(outs, ref):
            assert o.shape == r.shape and np.abs(o - r).max() <= 1e-6
        assert ops.LAUNCH_COUNTS["flash_forward"] > 0
    finally:
        pi.shutdown()
        eng.shutdown()
