"""Speculative decoding in the port against the JAX package.

The load-bearing contract is distribution exactness: exact acceptance
sampling keeps the output law of plain sampling, so greedy streams are
token-for-token those of plain decode for every k, to the cache limit (where
the k+1 window no longer fits and plain steps take over), and match the JAX
package's (same weights, through a model zip). Held here: the acceptance
primitive (closed form, Monte Carlo marginal, greedy rows accept iff the
argmaxes match, a ``spec_k = 0`` row reproduces the port's plain sampler),
the speculative session and engine against the JAX ones with mixed
per-request ``speculative_k`` and staggered arrival, slot release under
cancel and expiry, the engine's speculative stats and metric names, and
the decode-side AIMD rules.

Tolerances: the closed form to 1e-12 in float64; Monte Carlo total
variation < 0.05 over 4000 seeds (standard error of a frequency <= 0.008),
the speculative-vs-plain first-token distribution TV < 0.15 over 512 seeds
(as the JAX test); streams token for token."""

import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.generate import SpeculativeGenerationSession as JaxSpec
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.parallel.decode import DecodeEngine as JaxEngine

from deeplearning4j_tpu_torch.generate import (GenerationSession, SpeculativeGenerationSession,
                                               rewind_carry, sample_tokens, speculative_accept)
from deeplearning4j_tpu_torch.generate.sampling import _residual_probs, _warped_probs
from deeplearning4j_tpu_torch.generate.session import _check_rewindable
from deeplearning4j_tpu_torch.model.zoo import TransformerLM
from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import DecodeAIMD, DecodeEngine

from torch_decode_helpers import MAX_LEN, VOCAB, collect, draft_pair, lm_pair

MIXED = [([1, 2, 3], dict(max_tokens=6)), ([4, 5, 6, 7, 8], dict(max_tokens=6, speculative_k=1)),
         ([2, 2], dict(max_tokens=6, speculative_k=0)), ([9, 3, 1], dict(max_tokens=MAX_LEN))]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return lm_pair(tmp_path_factory)


@pytest.fixture(scope="module")
def drafts(tmp_path_factory):
    return draft_pair(tmp_path_factory)


def _submit_mixed(eng):
    handles = [eng.submit(p, **kw) for p, kw in MIXED]
    return [h.result(timeout=180) for h in handles]


@pytest.fixture(scope="module")
def jax_mixed(models, drafts):
    """The JAX speculative engine's greedy streams on the mixed batch."""
    eng = JaxEngine(models[0], draft_model=drafts[0], speculative_k=3, max_len=MAX_LEN, slots=4,
                    registry=JaxRegistry())
    try:
        return _submit_mixed(eng)
    finally:
        eng.shutdown()


def _spec_engine(models, drafts, **kw):
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("slots", 4)
    return DecodeEngine(models[1], draft_model=drafts[1], max_len=MAX_LEN, **kw)


# ---------------------------------------------------------------------------
# the acceptance primitive
# ---------------------------------------------------------------------------


def test_closed_form_exactness():
    """q(x)·min(1, p/q)(x) + P(reject)·residual == p for arbitrary pairs,
    with the port's residual, in float64."""
    rng = np.random.RandomState(0)
    for _ in range(20):
        p = torch.from_numpy(rng.dirichlet(np.ones(11)))
        q = torch.from_numpy(rng.dirichlet(np.ones(11)))
        accept = q * torch.clamp(p / torch.clamp_min(q, 1e-300), max=1.0)
        emitted = accept + (1.0 - accept.sum()) * _residual_probs(p, q)
        np.testing.assert_allclose(emitted.numpy(), p.numpy(), atol=1e-12)


def test_monte_carlo_marginal_matches_target():
    rng = np.random.RandomState(1)
    v, b = 8, 4000
    zt, zd = (torch.from_numpy(rng.randn(v).astype(np.float32)) for _ in range(2))
    seeds, steps = torch.arange(b), torch.zeros(b, dtype=torch.int64)
    gmask = torch.zeros(b, dtype=torch.bool)
    temps, ks, ps = torch.full((b,), 0.9), torch.zeros(b, dtype=torch.int64), torch.full((b,), 0.95)
    d_logits = zd.expand(b, 1, v)
    d_toks = sample_tokens(d_logits[:, 0], seeds, steps, gmask, temps, ks, ps)[:, None]
    toks, n_acc, n_emit = speculative_accept(d_toks, d_logits, zt.expand(b, 2, v), seeds, steps,
                                             torch.ones(b, dtype=torch.int64), gmask, temps, ks, ps)
    assert torch.equal(n_emit, n_acc + 1)
    emp = np.bincount(toks[:, 0].numpy(), minlength=v) / b
    pt = _warped_probs(zt, False, 0.9, 0, 0.95).numpy()
    assert 0.5 * np.abs(emp - pt).sum() < 0.05


def test_greedy_rows_accept_iff_argmax_matches():
    rng = np.random.RandomState(2)
    v, k = 9, 3
    t_logits = torch.from_numpy(rng.randn(2, k + 1, v).astype(np.float32))
    d_logits = torch.from_numpy(rng.randn(2, k, v).astype(np.float32))
    t_arg = torch.argmax(t_logits, dim=-1)
    d_toks = torch.stack([t_arg[0, :k], (t_arg[1, :k] + 1) % v])
    toks, n_acc, n_emit = speculative_accept(
        d_toks, d_logits, t_logits, [5, 5], [0, 0], [k, k], [True, True], [1.0, 1.0], [0, 0],
        [1.0, 1.0])
    assert int(n_acc[0]) == k and int(n_emit[0]) == k + 1
    assert toks[0].tolist() == t_arg[0].tolist()
    assert int(n_acc[1]) == 0 and int(n_emit[1]) == 1 and int(toks[1, 0]) == int(t_arg[1, 0])


def test_spec_k_zero_reproduces_plain_sampler():
    """A row with an empty window emits, at its step, the token the plain
    sampler draws there: the bonus draw's key is the untagged (seed, step)."""
    rng = np.random.RandomState(3)
    b, k, v = 64, 2, 13
    t_logits = torch.from_numpy(rng.randn(b, k + 1, v).astype(np.float32))
    d_logits = torch.from_numpy(rng.randn(b, k, v).astype(np.float32))
    d_toks = torch.from_numpy(rng.randint(0, v, (b, k)))
    seeds, steps = torch.arange(b) * 7, torch.arange(b) % 5
    temps, ks = torch.full((b,), 0.8), torch.where(torch.arange(b) % 2 == 0, 0, 4)
    ps, gmask = torch.full((b,), 0.9), torch.zeros(b, dtype=torch.bool)
    toks, n_acc, _ = speculative_accept(d_toks, d_logits, t_logits, seeds, steps,
                                        torch.zeros(b, dtype=torch.int64), gmask, temps, ks, ps)
    plain = sample_tokens(t_logits[:, 0], seeds, steps, gmask, temps, ks, ps)
    assert torch.equal(n_acc, torch.zeros_like(n_acc))
    assert toks[:, 0].tolist() == plain.tolist()


def test_rewind_carry_in_place(models):
    sess = GenerationSession(models[1], max_len=MAX_LEN)
    carry, _, _ = sess.prefill([[1, 2, 3], [4, 5]])
    pos = carry["layer_2"]["pos"]
    out = rewind_carry(carry, torch.tensor([2, 5]))
    assert out is carry and carry["layer_2"]["pos"] is pos
    assert pos.tolist() == [1, 0]  # clamped at 0


def test_non_rewindable_and_vocab_mismatch_rejected(models):
    class Recurrent:  # a carry with no position counter (an LSTM's h/c)
        def decode_state(self, batch):
            return {"layer_0": {"h": torch.zeros(batch, 4), "c": torch.zeros(batch, 4)}}

    with pytest.raises(ValueError, match="position-indexed"):
        _check_rewindable(Recurrent(), "draft")
    other = TransformerLM(vocab_size=VOCAB + 1, hidden=16, n_layers=1, n_heads=2,
                          max_len=MAX_LEN).init(device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeGenerationSession(models[1], other, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeGenerationSession(models[1], models[1], max_len=MAX_LEN, k=0)


# ---------------------------------------------------------------------------
# the speculative session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_session_greedy_matches_jax_and_plain_to_the_cache_limit(models, drafts, k):
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [2, 2]]
    spec = SpeculativeGenerationSession(models[1], drafts[1], max_len=MAX_LEN, k=k)
    got = spec.generate(prompts, MAX_LEN)
    assert got == GenerationSession(models[1], max_len=MAX_LEN).generate(prompts, MAX_LEN)
    assert got == JaxSpec(models[0], drafts[0], max_len=MAX_LEN, k=k).generate(prompts, MAX_LEN)
    st = spec.last_stats
    assert st["spec_steps"] > 0 and 0 <= st["acceptance_rate"] <= 1


def test_session_int8_greedy_matches_plain_int8(models, drafts):
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    got = SpeculativeGenerationSession(models[1], drafts[1], max_len=MAX_LEN, k=2,
                                       cache_dtype="int8").generate(prompts, 10)
    assert got == GenerationSession(models[1], max_len=MAX_LEN,
                                    cache_dtype="int8").generate(prompts, 10)


def test_session_self_draft_accepts_everything(models):
    spec = SpeculativeGenerationSession(models[1], models[1], max_len=MAX_LEN, k=3)
    spec.generate([[1, 2, 3], [4, 5, 6, 7, 8]], 9)
    assert spec.last_stats["acceptance_rate"] == 1.0


def test_sampled_distribution_equivalence(models, drafts):
    """Over 512 seeds (one batched call, rows = seeds), the first
    speculative token's distribution matches plain sampling's."""
    b, kw = 512, dict(greedy=False, temperature=1.0, top_p=0.9, seed=0)
    prompts = [[1, 2, 3]] * b
    ref = GenerationSession(models[1], max_len=MAX_LEN).generate(prompts, 2, **kw)
    got = SpeculativeGenerationSession(models[1], drafts[1], max_len=MAX_LEN,
                                       k=2).generate(prompts, 2, **kw)
    assert [r[0] for r in got] == [r[0] for r in ref]  # the prefill's draw: equal
    emp_ref = np.bincount([r[1] for r in ref], minlength=VOCAB) / b
    emp_got = np.bincount([r[1] for r in got], minlength=VOCAB) / b
    assert 0.5 * np.abs(emp_ref - emp_got).sum() < 0.15


# ---------------------------------------------------------------------------
# the speculative engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", [{}, {"block_size": 4}], ids=["static", "paged"])
def test_engine_mixed_k_matches_jax_engine(models, drafts, jax_mixed, layout):
    """Per-request speculative_k (0 = plain) mixed in one batch, one request
    running to the cache limit: the JAX engine's streams, and the plain
    session's."""
    eng = _spec_engine(models, drafts, speculative_k=3, **layout)
    try:
        got = _submit_mixed(eng)
    finally:
        eng.shutdown()
    assert got == jax_mixed
    full = GenerationSession(models[1], max_len=MAX_LEN).generate([p for p, _ in MIXED], MAX_LEN)
    assert got == [full[0][:6], full[1][:6], full[2][:6], full[3]]


def test_engine_staggered_arrival(models, drafts):
    eng = _spec_engine(models, drafts, speculative_k=2)
    try:
        h1 = eng.submit([1, 2, 3], max_tokens=10)
        ev = iter(h1.events(timeout=60))
        for _ in range(3):
            next(ev)
        h2 = eng.submit([4, 5, 6, 7, 8], max_tokens=6)
        got1, got2 = h1.result(timeout=180), h2.result(timeout=180)
    finally:
        eng.shutdown()
    sess = GenerationSession(models[1], max_len=MAX_LEN)
    assert got1 == sess.generate([[1, 2, 3]], 10)[0]
    assert got2 == sess.generate([[4, 5, 6, 7, 8]], 6)[0]


def test_engine_int8_speculative_matches_plain_int8(models, drafts):
    eng = _spec_engine(models, drafts, speculative_k=2, cache_dtype="int8", block_size=4)
    try:
        got = collect(eng, [[1, 2, 3], [4, 5, 6, 7, 8]], max_tokens=8)
    finally:
        eng.shutdown()
    assert got == GenerationSession(models[1], max_len=MAX_LEN, cache_dtype="int8").generate(
        [[1, 2, 3], [4, 5, 6, 7, 8]], 8)


def test_slot_release_regression(models, drafts):
    """A burst of cancelled and expired requests — mid-speculation and still
    queued — releases every cache and admission slot; full capacity serves
    afterwards."""
    gate = {"delay": 0.05}
    eng = _spec_engine(models, drafts, speculative_k=2, slots=2, queue_limit=6,
                       step_hook=lambda: time.sleep(gate["delay"]))
    try:
        long = [eng.submit([1, 2, 3], max_tokens=MAX_LEN - 4) for _ in range(2)]
        queued = [eng.submit([4, 5], max_tokens=4, timeout=0.2) for _ in range(4)]
        deadline = time.monotonic() + 30
        while eng.stats()["active_slots"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        for h in long:
            h.cancel()
        deadline = time.monotonic() + 60
        while eng.stats()["in_flight"] > 0:
            assert time.monotonic() < deadline, eng.stats()
            time.sleep(0.02)
        gate["delay"] = 0.0
        s = eng.stats()
        assert s["active_slots"] == 0 and s["in_flight"] == 0 and s["cancelled"] >= 2
        for h in queued:
            h.result(timeout=10)
        again = [eng.submit([6, 7], max_tokens=3) for _ in range(6)]
        for h in again:
            assert len(h.result(timeout=180)) == 3
        assert eng.stats()["in_flight"] == 0
    finally:
        eng.shutdown()


def test_stats_zero_guarded_and_counted(models, drafts):
    reg = MetricsRegistry()
    eng = _spec_engine(models, drafts, speculative_k=2, slots=2, registry=reg)
    try:
        s = eng.stats()
        assert s["speculative"]["enabled"] is True and s["speculative"]["current_k"] == 2
        assert s["speculative"]["acceptance_rate"] is None
        assert s["speculative"]["accepted_tokens_per_step"] is None
        assert s["per_token_p95_s"] is None and s["slot_target"] == 2
        eng.submit([1, 2, 3], max_tokens=5).result(timeout=180)
        s = eng.stats()
        assert s["speculative"]["proposed"] > 0 and s["speculative"]["acceptance_rate"] is not None
        assert s["per_token_p95_s"] is not None
    finally:
        eng.shutdown()
    for name in ("dl4j_tpu_generate_spec_proposed_total", "dl4j_tpu_generate_spec_accepted_total",
                 "dl4j_tpu_generate_spec_steps_total", "dl4j_tpu_generate_speculative_k",
                 "dl4j_tpu_generate_slot_target", "dl4j_tpu_generate_token_latency_seconds"):
        assert reg.get(name) is not None, name


def test_plain_engine_reports_speculation_off(models):
    eng = DecodeEngine(models[1], max_len=MAX_LEN, slots=2, registry=MetricsRegistry())
    try:
        s = eng.stats()
        assert s["speculative"]["enabled"] is False and s["speculative"]["current_k"] == 0
        assert eng.speculative_k == 0
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# decode-side AIMD
# ---------------------------------------------------------------------------


class TestDecodeAIMD:
    @pytest.fixture()
    def eng(self, models, drafts):
        e = _spec_engine(models, drafts, speculative_k=4, slots=8)
        yield e
        e.shutdown(drain=False)

    def test_no_traffic_no_action(self, eng):
        assert eng.adjust() is None

    def test_breach_shrinks_k_and_slots(self, eng):
        ctl = DecodeAIMD(eng, target_p95_s=0.05)
        for _ in range(20):
            eng._h_token.observe(0.2)
        assert ctl.tick()["action"] == "shrink"
        assert eng.speculative_k == 2 and eng.slot_target == 4
        for _ in range(20):
            eng._h_token.observe(0.2)
        ctl.tick()
        assert ctl.tick() is None  # no new traffic between ticks
        assert eng.speculative_k == 1 and eng.slot_target == 2

    def test_under_budget_grows_slots_then_k(self, eng):
        ctl = DecodeAIMD(eng, target_p95_s=0.05)
        eng.set_decode_control(2, 4)
        eng._admission.max_pending = 100
        for _ in range(3):
            eng._admission.admit()
        for _ in range(20):
            eng._h_token.observe(0.001)
        obs = ctl.tick()
        assert obs["action"] == "grow_slots"
        assert eng.slot_target == 5 and eng.speculative_k == 2
        for _ in range(3):
            eng._admission.release()
        for _ in range(20):
            eng._h_token.observe(0.001)
        assert ctl.tick()["action"] == "grow_k"
        assert eng.speculative_k == 3 and eng.slot_target == 5

    def test_hold_at_max(self, eng):
        ctl = DecodeAIMD(eng, target_p95_s=0.05)
        eng.set_decode_control(4, 8)
        for _ in range(20):
            eng._h_token.observe(0.001)
        assert ctl.tick()["action"] == "hold"
        assert eng.speculative_k == 4 and eng.slot_target == 8

    def test_control_clamps(self, eng):
        assert eng.set_decode_control(99, 99) == (4, 8)
        assert eng.set_decode_control(0, 0) == (1, 1)
        with pytest.raises(ValueError):
            DecodeAIMD(eng, shrink_factor=1.0)

    def test_adaptive_loop_ticks(self, models, drafts):
        eng = _spec_engine(models, drafts, speculative_k=4, slots=2, adaptive=True,
                           target_p95_s=1e-4, adjust_interval=0.05)
        try:
            eng.submit([1, 2, 3], max_tokens=MAX_LEN - 4).result(timeout=180)
            deadline = time.monotonic() + 30
            while eng.speculative_k == 4 and time.monotonic() < deadline:
                eng.submit([1, 2], max_tokens=4).result(timeout=180)
            assert eng.speculative_k < 4
        finally:
            eng.shutdown()
