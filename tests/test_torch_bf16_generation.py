"""Generation over a ``compute_dtype="bfloat16"`` model in the port against
the JAX package.

Both packages build the decode carry in the model's master dtype (float32)
while the cast layers compute in bfloat16, so the KV-cache attention meets
a bfloat16 query and a float32 cache. JAX promotes the pair; the port does
the same (``ops.decode_attention``, ``core.dtypes.promoted_matmul``). One
model (vocab 50, hidden 32, 2 blocks, 2 heads) goes through the JAX model
zip, and the greedy streams of the session over static, int8 and paged
caches, the continuous-batching engine and speculative decoding are held
against JAX's token for token.

The tie rule: the packages round bfloat16 in different places (XLA fuses
elementwise chains in float32), so where a stream first differs the test
stops comparing that stream only if JAX's top-2 margin of the next-token
log-probabilities there is below bfloat16's resolution at that value,
``2**-8 * |top logit|``, and asserts that bound. Any other difference
fails."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generate import GenerationSession as JaxSession
from deeplearning4j_tpu.generate import SpeculativeGenerationSession as JaxSpec
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo import TransformerLM as JaxLM
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.ops.flash_attention import decode_attention as jax_decode_attention
from deeplearning4j_tpu.parallel.decode import DecodeEngine as JaxEngine

from deeplearning4j_tpu_torch.generate import GenerationSession, SpeculativeGenerationSession
from deeplearning4j_tpu_torch.model import restore_multi_layer_network
from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import DecodeEngine

pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

MAX_LEN = 32
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [9, 31, 44, 2, 17, 8], [40]]
N_TOKENS = 10


def _bf16_lm(tmp_path_factory, name, **kw):
    conf = JaxLM(vocab_size=50, max_len=MAX_LEN, **kw).conf()
    jm = JaxMLN(dataclasses.replace(conf, compute_dtype="bfloat16")).init()
    path = str(tmp_path_factory.mktemp(name) / "lm.zip")
    jax_write(jm, path)
    pm = restore_multi_layer_network(path, device="cpu")
    assert pm.conf.compute_dtype == "bfloat16"
    return jm, pm


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return _bf16_lm(tmp_path_factory, "lm", hidden=32, n_layers=2, n_heads=2, seed=12)


@pytest.fixture(scope="module")
def drafts(tmp_path_factory):
    return _bf16_lm(tmp_path_factory, "draft", hidden=16, n_layers=1, n_heads=2, seed=99)


@pytest.fixture(scope="module")
def jax_greedy(models):
    """JAX's greedy streams over the static cache: the reference for every
    cache and route (greedy streams do not depend on either)."""
    return JaxSession(models[0], max_len=MAX_LEN).generate(PROMPTS, N_TOKENS)


def _assert_streams(jm, want, got, cache_dtype=None):
    """Token-for-token equality under the tie rule of the module docstring,
    the margin read from JAX's session over a cache of the same dtype (a
    paged cache computes what a static one does)."""
    sess = JaxSession(jm, max_len=MAX_LEN, cache_dtype=cache_dtype)
    assert len(want) == len(got)
    for prompt, w, g in zip(PROMPTS, want, got):
        assert len(g) == len(w), (w, g)
        diff = [i for i, (a, b) in enumerate(zip(w, g)) if a != b]
        if not diff:
            continue
        i = diff[0]
        _, logits, _ = sess.prefill([list(prompt) + list(w[:i])])
        top2 = np.sort(np.asarray(logits[0], np.float64))[-2:]
        margin, bound = top2[1] - top2[0], 2.0 ** -8 * abs(top2[1])
        print(f"bf16 tie at step {i}: JAX top-2 margin {margin:.3g}, bound {bound:.3g}")
        assert margin < bound, (f"stream differs at step {i} with JAX's top-2 margin "
                                f"{margin:.3g} >= bf16 resolution {bound:.3g}: {w} vs {g}")


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_session_matches_jax(models, jax_greedy, cache_dtype):
    """The session over a static and an int8 cache (the paged cache is the
    engine's, held below)."""
    jm, pm = models
    want = JaxSession(jm, max_len=MAX_LEN, cache_dtype=cache_dtype).generate(PROMPTS, N_TOKENS)
    got = GenerationSession(pm, max_len=MAX_LEN, cache_dtype=cache_dtype).generate(
        PROMPTS, N_TOKENS)
    _assert_streams(jm, want, got, cache_dtype)
    if cache_dtype is None:
        assert want == jax_greedy


def _engine_streams(eng, timeout=180):
    try:
        handles = [eng.submit(p, max_tokens=N_TOKENS) for p in PROMPTS]
        out = [h.result(timeout=timeout) for h in handles]
        assert [h.reason for h in handles] == ["completed"] * len(PROMPTS)
        return out
    finally:
        eng.shutdown()


@pytest.mark.parametrize("cache", [dict(), dict(cache_dtype="int8"), dict(block_size=8),
                                   dict(block_size=8, cache_dtype="int8")],
                         ids=["static", "int8", "paged", "paged-int8"])
def test_engine_matches_jax(models, cache):
    jm, pm = models
    want = _engine_streams(JaxEngine(jm, max_len=MAX_LEN, slots=4, registry=JaxRegistry(),
                                     **cache))
    got = _engine_streams(DecodeEngine(pm, max_len=MAX_LEN, slots=4,
                                       registry=MetricsRegistry(), **cache))
    _assert_streams(jm, want, got, cache.get("cache_dtype"))


def test_speculative_session_matches_jax(models, drafts, jax_greedy):
    (jm, pm), (jd, pd) = models, drafts
    want = JaxSpec(jm, jd, max_len=MAX_LEN, k=3).generate(PROMPTS, N_TOKENS)
    got = SpeculativeGenerationSession(pm, pd, max_len=MAX_LEN, k=3).generate(PROMPTS, N_TOKENS)
    _assert_streams(jm, want, got)
    # exact acceptance keeps greedy streams those of plain decode
    _assert_streams(jm, jax_greedy, got)


def test_speculative_engine_matches_jax(models, drafts):
    (jm, pm), (jd, pd) = models, drafts
    want = _engine_streams(JaxEngine(jm, draft_model=jd, speculative_k=3, max_len=MAX_LEN,
                                     slots=4, registry=JaxRegistry()))
    got = _engine_streams(DecodeEngine(pm, draft_model=pd, speculative_k=3, max_len=MAX_LEN,
                                       slots=4, registry=MetricsRegistry()))
    _assert_streams(jm, want, got)


def test_cache_holds_master_dtype_and_attention_promotes(models):
    """The carry is the master dtype (float32), as JAX's, and one decode
    step's attention output is float32: the promoted product."""
    _, pm = models
    sess = GenerationSession(pm, max_len=MAX_LEN)
    carry = sess.decode_state(2)
    assert {t.dtype for st in carry.values() for k, t in st.items() if k != "pos"} \
        == {torch.float32}
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 1, 16, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 2, 8, 16, generator=g)
    v = torch.randn(2, 2, 8, 16, generator=g)
    pos = torch.tensor([3, 7], dtype=torch.int32)
    o = pfa.decode_attention(q, k, v, pos)
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, pfa.decode_attention(q.float(), k, v, pos), rtol=0, atol=0)
    want = jax_decode_attention(jnp.asarray(q.float().numpy()).astype(jnp.bfloat16),
                                jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                                jnp.asarray(pos.numpy()))
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=0, atol=1e-6)
