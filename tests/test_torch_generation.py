"""KV-cached generation parity between the JAX package and its PyTorch
port, from one model zip: prefill logits, greedy token streams on ragged
prompts in different buckets, prefill + cached decode against a full
re-forward, the logits warping of the sampler, and the distribution of
the port's seeded sampling.

Tolerances: log-probs atol 1e-4 in float32 (log of probabilities ~1/vocab
computed by two float32 stacks with different summation orders; the
cached path also attends through a different spelling than the full
forward). ``_warp`` is compared exactly: it scales, sorts and masks the
same float32 values."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generate import session as jax_session
from deeplearning4j_tpu.generate import sampling as jax_sampling
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo.transformer_lm import TransformerLM as JaxLM

from deeplearning4j_tpu_torch.generate import GenerationSession, bucket_length
from deeplearning4j_tpu_torch.generate import sampling as port_sampling
from deeplearning4j_tpu_torch.model import restore_multi_layer_network

pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

ATOL = 1e-4
V = 48
PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6, 5], [3, 5, 8, 9, 7, 9, 3, 2, 3]]  # buckets 4, 8, 16


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jmodel = JaxLM(vocab_size=V, hidden=16, n_layers=2, n_heads=2, max_len=48,
                   seed=21).init()
    path = str(tmp_path_factory.mktemp("gen") / "lm.zip")
    jax_write(jmodel, path)
    return jmodel, restore_multi_layer_network(path, device="cpu")


@pytest.fixture(autouse=True)
def _restore_impl():
    yield
    pfa.set_attention_impl("auto")


def test_prefill_logits_match_jax(models):
    jmodel, port = models
    _, j_logits, j_lens = jax_session.GenerationSession(jmodel, max_len=48).prefill(PROMPTS)
    carry, p_logits, p_lens = GenerationSession(port, max_len=48).prefill(PROMPTS)
    np.testing.assert_array_equal(p_lens, j_lens)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits), atol=ATOL)
    for name, st in carry.items():  # every position counter at its row's length
        np.testing.assert_array_equal(st["pos"].numpy(), [3, 6, 9])


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_greedy_generate_matches_jax_token_for_token(models, impl):
    jmodel, port = models
    pfa.set_attention_impl(impl)
    j = jax_session.GenerationSession(jmodel, max_len=48).generate(PROMPTS, 14)
    p = GenerationSession(port, max_len=48).generate(PROMPTS, 14)
    assert p == j
    assert all(len(row) == 14 for row in p)


def test_cached_decode_matches_full_reforward(models):
    _, port = models
    sess = GenerationSession(port, max_len=48)
    gen = sess.generate(PROMPTS, 10)
    carry, logits, _ = sess.prefill(PROMPTS)
    steps = [logits]
    for s in range(9):
        carry, logits = sess.decode(carry, [row[s] for row in gen])
        steps.append(logits)
    cached = torch.stack(steps, dim=1).numpy()  # [b, 10, V]
    for i, (prompt, row) in enumerate(zip(PROMPTS, gen)):
        seq = np.asarray(prompt + row[:9])[None]
        full = np.log(np.maximum(port.output(seq).numpy()[0], 1e-30))  # [V, t]
        ref = full[:, len(prompt) - 1:].T
        np.testing.assert_allclose(cached[i], ref, atol=ATOL)
        assert [int(t) for t in ref.argmax(-1)] == row[:10]


def test_bucket_length():
    assert [bucket_length(n, 48) for n in (1, 3, 4, 5, 17, 40)] == [1, 4, 4, 8, 32, 48]


def test_warp_matches_jax_exactly():
    rs = np.random.RandomState(0)
    logits = (rs.randn(6, 30) * 3).astype(np.float32)
    temps = np.array([1.0, 0.7, 1.3, 1.0, 0.5, 2.0], np.float32)
    ks = np.array([0, 5, 0, 12, 1, 30], np.int32)
    ps = np.array([1.0, 1.0, 0.8, 0.5, 0.9, 0.3], np.float32)
    j = jax.vmap(jax_sampling._warp)(jnp.asarray(logits), jnp.asarray(temps),
                                     jnp.asarray(ks), jnp.asarray(ps))
    p = port_sampling._warp(torch.from_numpy(logits), torch.from_numpy(temps),
                            torch.from_numpy(ks), torch.from_numpy(ps))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    g = port_sampling.greedy(torch.from_numpy(logits))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jax_sampling.greedy(jnp.asarray(logits))))


def test_seeded_sampling_distribution_and_replay():
    z = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5]])
    temp, n = 0.8, 4000
    logits = z.expand(n, -1)
    seeds = np.arange(n)
    draws = port_sampling.sample_tokens(logits, seeds, np.full(n, 3), np.zeros(n, bool),
                                        torch.full((n,), temp), torch.zeros(n, dtype=torch.int64),
                                        torch.ones(n))
    freq = np.bincount(draws.numpy(), minlength=5) / n
    expect = torch.softmax(z[0] / temp, -1).numpy()
    # 4000 draws: the standard error of each frequency is <= 0.008
    np.testing.assert_allclose(freq, expect, atol=0.03)
    again = port_sampling.sample_tokens(logits[:50], seeds[:50], np.full(50, 3),
                                        np.zeros(50, bool), torch.full((50,), temp),
                                        torch.zeros(50, dtype=torch.int64), torch.ones(50))
    np.testing.assert_array_equal(again.numpy(), draws[:50].numpy())
    # top-k 2 keeps only the two largest logits
    top2 = port_sampling.sample_tokens(logits[:200], seeds[:200], np.full(200, 1),
                                       np.zeros(200, bool), torch.ones(200),
                                       torch.full((200,), 2), torch.ones(200))
    assert set(top2.numpy().tolist()) <= {0, 1}


def test_cache_write_in_place_matches_jax():
    from deeplearning4j_tpu.nn.layers import attention as jax_attention
    from deeplearning4j_tpu_torch.nn.layers import attention as port_attention

    rs = np.random.RandomState(4)
    cache = rs.randn(3, 2, 10, 4).astype(np.float32)
    new = rs.randn(3, 2, 3, 4).astype(np.float32)
    pos = np.array([0, 4, 9], np.int32)  # the last start runs past the end: clamped
    j = jax_attention._cache_write(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
    c = torch.from_numpy(cache.copy())
    out = port_attention._cache_write(c, torch.from_numpy(new), torch.from_numpy(pos))
    assert out.data_ptr() == c.data_ptr()  # written in place
    np.testing.assert_array_equal(c.numpy(), np.asarray(j))


def test_single_spec_samplers_keep_their_support():
    z = torch.tensor([[3.0, 2.5, 0.0, -1.0, -2.0]]).expand(64, -1)
    gen = torch.Generator().manual_seed(0)
    assert set(port_sampling.top_k(z, gen, 2).tolist()) <= {0, 1}
    # softmax([3, 2.5, 0, ...]) puts 0.59 + 0.36 on the top two: p=0.9 keeps them
    assert set(port_sampling.top_p(z, gen, 0.9).tolist()) <= {0, 1}
    draws = port_sampling.temperature(z, gen, 1e-3)  # near-zero temperature: argmax
    assert draws.dtype == torch.int32 and set(draws.tolist()) == {0}
