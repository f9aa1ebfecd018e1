"""The port's device sampler and its continuous-batching ``DecodeEngine``.

The sampler draws by a counter-based hash of ``(seed, step, tag, index)``
on the logits' device (no threefry, so JAX's draws are not reproduced; the
distribution is). Held here: the hash's bits against a plain-Python
computation of the same function and a pinned stream (the bits the card
must give too, checked by ``chip_smoke.py``), one row's draws alone and in
a batch, and a chi-square against the softmax. The engine: greedy streams
equal to the port's ``GenerationSession`` (and so to the JAX package's,
``tests/test_torch_generation.py``), staggered arrival, sampled requests
alone and batched, deadline, cancel, admission shedding, a failing step,
its metric names and ``stats()`` keys against the JAX engine's, and the
AIMD-free surface (``load_score``, drain, shutdown). The CUDA graph of the
plain step needs the card: its test is in ``tests/test_torch_cuda_kernels.py``.

Tolerances: streams token for token; the chi-square below its 0.999
quantile (7 degrees of freedom: 24.32)."""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.parallel.decode import DecodeEngine as JaxEngine

from deeplearning4j_tpu_torch.core.resilience import (AdmissionRejectedError, CircuitBreaker,
                                                      CircuitOpenError)
from deeplearning4j_tpu_torch.generate import GenerationSession, make_sampler, sample_tokens
from deeplearning4j_tpu_torch.generate import sampling
from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import DecodeEngine

from torch_decode_helpers import MAX_LEN, PROMPTS, collect, lm_pair

pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

M32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return lm_pair(tmp_path_factory)


def _engine(model, **kw):
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("slots", 4)
    return DecodeEngine(model, max_len=MAX_LEN, **kw)


# ---------------------------------------------------------------------------
# the device sampler
# ---------------------------------------------------------------------------


def _mix_py(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x21F0AAAD) & M32
    x ^= x >> 15
    x = (x * 0x735A2D97) & M32
    return x ^ (x >> 15)


def _bits_py(seed: int, step: int, tag: int, i: int) -> int:
    k = _mix_py((seed & M32) ^ 0x3C6EF372)
    k = _mix_py(k ^ ((step + 0x1B873593) & M32))
    k = _mix_py(k ^ ((tag + 0x5851F42D) & M32))
    h = _mix_py((k + i * 0x9E3779B9) & M32)
    return _mix_py((h + k) & M32)


def test_random_bits_match_plain_python_and_pinned_values():
    keys = [(0, 0), (1, 0), (7, 3), (M32, 5)]
    got = sampling.random_bits([s for s, _ in keys], [t for _, t in keys], 0, 4, "cpu")
    want = [[_bits_py(s, t, 0, i) for i in range(4)] for s, t in keys]
    assert got.tolist() == want
    # pinned: the card must give these bits too (chip_smoke.py compares)
    assert want[0] == [1016032071, 2138957388, 3421615011, 2793844449]
    assert want[2] == [1143631802, 931165690, 4128530224, 1464550391]
    assert sampling.random_bits([7], [3], 0x5A, 2, "cpu").tolist() == [[1586445298, 1777573479]]


def test_sample_tokens_pinned_stream():
    rs = np.random.RandomState(11)
    logits = torch.from_numpy((rs.randn(6, 17) * 2).astype(np.float32))
    toks = sample_tokens(logits, [0, 1, 2, 3, 41, 2**31 + 5], [0, 1, 2, 100, 7, 9],
                         np.zeros(6, bool), torch.tensor([1.0, 0.7, 1.3, 1.0, 0.5, 2.0]),
                         torch.tensor([0, 5, 0, 3, 0, 0]),
                         torch.tensor([1.0, 1.0, 0.8, 1.0, 0.9, 1.0]))
    assert toks.dtype == torch.int32
    assert toks.tolist() == [16, 5, 2, 10, 15, 2]


def test_row_draws_the_same_alone_and_in_a_batch():
    rs = np.random.RandomState(12)
    logits = torch.from_numpy(rs.randn(5, 31).astype(np.float32))
    seeds, steps = np.array([3, 9, 9, 4, 100]), np.array([1, 2, 5, 0, 7])
    temps, ks, ps = torch.full((5,), 0.9), torch.tensor([0, 4, 0, 0, 7]), torch.tensor(
        [1.0, 1.0, 0.7, 1.0, 0.95])
    gmask = np.array([False, False, False, True, False])
    batch = sample_tokens(logits, seeds, steps, gmask, temps, ks, ps)
    for i in range(5):
        alone = sample_tokens(logits[i:i + 1], seeds[i:i + 1], steps[i:i + 1], gmask[i:i + 1],
                              temps[i:i + 1], ks[i:i + 1], ps[i:i + 1])
        assert int(alone[0]) == int(batch[i])
    assert int(batch[3]) == int(torch.argmax(logits[3]))  # the greedy row


def test_sampler_chi_square_against_softmax():
    z = torch.tensor([2.0, 1.0, 0.0, -1.0, 0.5, 1.5, -0.5, 0.25])
    n, temp = 20000, 0.8
    draws = sample_tokens(z.expand(n, -1), np.arange(n), np.full(n, 3), np.zeros(n, bool),
                          torch.full((n,), temp), torch.zeros(n, dtype=torch.int64), torch.ones(n))
    freq = np.bincount(draws.numpy(), minlength=8)
    expect = n * torch.softmax(z / temp, -1).double().numpy()
    assert float(((freq - expect) ** 2 / expect).sum()) < 24.32
    # and over steps of one seed, the per-request stream
    draws = sample_tokens(z.expand(n, -1), np.zeros(n), np.arange(n), np.zeros(n, bool),
                          torch.full((n,), temp), torch.zeros(n, dtype=torch.int64), torch.ones(n))
    freq = np.bincount(draws.numpy(), minlength=8)
    assert float(((freq - expect) ** 2 / expect).sum()) < 24.32


def test_make_sampler_single_spec():
    logits = torch.from_numpy(np.random.RandomState(13).randn(4, 9).astype(np.float32))
    g = make_sampler(greedy_mode=True)(logits, np.arange(4), np.zeros(4))
    assert g.tolist() == torch.argmax(logits, -1).tolist()
    s = make_sampler(temp=0.7, k=3)(logits, np.arange(4), np.zeros(4))
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert all(int(t) in top3[i].tolist() for i, t in enumerate(s))
    # temp 0, no truncation: the greedy default, as in the JAX package
    assert make_sampler(temp=0.0)(logits, np.arange(4), np.zeros(4)).tolist() == g.tolist()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_engine_matches_session_with_mixed_positions(models):
    eng = _engine(models[1])
    try:
        got = collect(eng, PROMPTS)
    finally:
        eng.shutdown()
    assert got == GenerationSession(models[1], max_len=MAX_LEN).generate(PROMPTS, 6)


def test_engine_staggered_arrival(models):
    eng = _engine(models[1])
    try:
        h1 = eng.submit([1, 2, 3], max_tokens=10)
        ev = iter(h1.events(timeout=60))
        for _ in range(3):
            next(ev)
        h2 = eng.submit([4, 5, 6, 7, 8], max_tokens=6)
        got1, got2 = h1.result(timeout=120), h2.result(timeout=120)
    finally:
        eng.shutdown()
    sess = GenerationSession(models[1], max_len=MAX_LEN)
    assert got1 == sess.generate([[1, 2, 3]], 10)[0]
    assert got2 == sess.generate([[4, 5, 6, 7, 8]], 6)[0]


def test_engine_runs_to_the_cache_limit(models):
    eng = _engine(models[1])
    try:
        h = eng.submit([9, 3, 1], max_tokens=MAX_LEN)
        got = h.result(timeout=120)
    finally:
        eng.shutdown()
    assert h.reason == "completed" and len(got) == MAX_LEN - 3
    assert got == GenerationSession(models[1], max_len=MAX_LEN).generate([[9, 3, 1]], MAX_LEN)[0]


def test_engine_sampled_request_alone_and_batched(models):
    kw = dict(greedy=False, temperature=0.9, top_k=5, top_p=0.95, seed=13)
    eng = _engine(models[1])
    try:
        alone = eng.submit([4, 5, 6], max_tokens=8, **kw).result(timeout=120)
        others = [eng.submit(p, max_tokens=8) for p in PROMPTS]
        mine = eng.submit([4, 5, 6], max_tokens=8, **kw)
        batched = mine.result(timeout=120)
        for h in others:
            h.result(timeout=120)
    finally:
        eng.shutdown()
    assert alone == batched
    assert all(0 <= t < 23 for t in alone)


def test_engine_deadline_mid_stream_partial_output(models):
    eng = _engine(models[1], slots=2, step_hook=lambda: time.sleep(0.05))
    try:
        h = eng.submit([1, 2, 3], max_tokens=MAX_LEN, timeout=0.4)
        evs = list(h.events(timeout=60))
    finally:
        eng.shutdown()
    assert evs[-1]["done"] and evs[-1]["reason"] == "deadline"
    assert 1 <= evs[-1]["count"] < MAX_LEN - 3
    assert [e["index"] for e in evs[:-1]] == list(range(evs[-1]["count"]))


def test_engine_cancel_frees_slot(models):
    eng = _engine(models[1], slots=1, step_hook=lambda: time.sleep(0.01))
    try:
        h = eng.submit([1, 2, 3], max_tokens=MAX_LEN)
        next(iter(h.events(timeout=60)))
        h.cancel()
        for _ in range(200):
            if eng.stats()["active_slots"] == 0:
                break
            time.sleep(0.02)
        s = eng.stats()
        assert s["active_slots"] == 0 and s["in_flight"] == 0 and s["cancelled"] == 1
        assert eng.submit([4, 5], max_tokens=3).result(timeout=120)
    finally:
        eng.shutdown()


def test_engine_admission_shed(models):
    gate = threading.Event()
    eng = _engine(models[1], slots=1, queue_limit=2, step_hook=lambda: gate.wait(0.02))
    try:
        h1 = eng.submit([1, 2, 3], max_tokens=MAX_LEN)
        h2 = eng.submit([1, 2], max_tokens=4)
        with pytest.raises(AdmissionRejectedError) as ei:
            eng.submit([1], max_tokens=2)
        assert ei.value.retry_after is not None
        gate.set()
        h1.result(timeout=120)
        h2.result(timeout=120)
        s = eng.stats()
        assert s["shed"] == 1 and s["completed"] == 2 and s["in_flight"] == 0
    finally:
        eng.shutdown()


def test_failing_step_fails_requests_and_opens_breaker(models):
    """A step that raises ends the active requests "failed" with the error
    (the reference's behaviour, which ``chip_smoke.py`` turns into a failed
    run) and, past the breaker's threshold, sheds new submits."""
    eng = _engine(models[1], circuit_breaker=CircuitBreaker(failure_threshold=0.5, min_calls=2))

    def broken(*_):
        raise RuntimeError("poisoned step")

    eng._plain_step = broken
    try:
        h = eng.submit([1, 2, 3], max_tokens=4)
        term = list(h.events(timeout=60))[-1]
        assert term["reason"] == "failed" and "poisoned step" in term["error"]
        assert len(h.tokens) == 1  # only the prefill's token
        with pytest.raises(CircuitOpenError):
            eng.submit([1, 2], max_tokens=2)
    finally:
        eng.shutdown()


def test_submit_validation_and_lifecycle(models):
    eng = _engine(models[1], slots=1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(list(range(1, MAX_LEN + 2)), max_tokens=2)
    with pytest.raises(ValueError, match="speculative_k"):
        eng.submit([1], speculative_k=-1)
    # a handoff is validated before admission (tests/test_torch_disagg.py
    # holds the resume itself)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit_prefilled({"prompt": []})
    with pytest.raises(ValueError, match="pos"):
        eng.submit_prefilled({"prompt": [1, 2]})
    assert eng.load_score() == 0.0
    assert eng.bucket_sizes() == [1, 2, 4, 8, 16, 24]
    assert eng.generate([1, 2, 3], max_tokens=3) == GenerationSession(
        models[1], max_len=MAX_LEN).generate([[1, 2, 3]], 3)[0]
    assert eng.drain(timeout=10)
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit([1])
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1])
    assert not eng._thread.is_alive()


def test_gauge_and_histogram_series(models):
    eng = _engine(models[1], slots=2)
    try:
        eng.submit([1, 2, 3], max_tokens=4).result(timeout=120)
    finally:
        eng.shutdown()
    assert int(eng._c_tokens.value) == 4
    assert eng._g_inflight.value == 0
    assert eng._h_prefill.count >= 1 and eng._h_decode.count >= 1


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "speculative"])
def test_metric_names_and_stats_keys_match_jax_engine(models, tmp_path_factory, draft):
    """The 13 series the JAX engine registers, by name, and its ``stats()``
    keys (engines built, no request run: nothing compiles)."""
    jreg, preg = JaxRegistry(), MetricsRegistry()
    jkw, pkw = {}, {}
    if draft:
        jd, pd = lm_pair(tmp_path_factory, hidden=16, n_layers=1, n_heads=2, seed=99)
        jkw, pkw = dict(draft_model=jd, speculative_k=2), dict(draft_model=pd, speculative_k=2)
    je = JaxEngine(models[0], max_len=MAX_LEN, slots=2, registry=jreg, name="e", **jkw)
    pe = DecodeEngine(models[1], max_len=MAX_LEN, slots=2, registry=preg, name="e", **pkw)
    try:
        jnames = sorted(f.name for f in jreg.collect())
        assert len(jnames) == 13
        assert sorted(f.name for f in preg.collect()) == jnames
        js, ps = je.stats(), pe.stats()
        assert sorted(ps) == sorted(js) and sorted(ps["speculative"]) == sorted(js["speculative"])
        for key in ("kv_cache_bytes", "slots", "slot_target", "max_len", "cache_dtype"):
            assert ps[key] == js[key], key
        assert ps["speculative"] == js["speculative"]
    finally:
        je.shutdown()
        pe.shutdown()
