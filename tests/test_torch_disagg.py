"""The port's disaggregated prefill/decode serving (``serving/disagg.py``
and ``DecodeEngine.submit_prefilled``) against the JAX package's, on the
CPU, with the same weights through one model zip.

* The wire format interoperates: a handoff dict serializes to the same
  bytes in both packages (float64, float32 and int8 caches, the int8 scale
  planes included), and each package's deserializer reads the other's
  bytes back to the same bytes. bfloat16 planes (torch tensors in the
  port, ``ml_dtypes`` arrays in JAX) go on the wire as the same 16 bits.
* A handoff resumes across packages with greedy streams equal token for
  token: a JAX ``PrefillEngine`` handoff resumed by the port's static and
  paged engines equals JAX's unified engine, and a port handoff resumed by
  JAX's engine equals the port's unified stream. (The port's sampler is
  not JAX's, so sampled resumes are held port to port: equal to the port's
  unified stream at the same seed, as are int8 and speculative resumes.)
* ``DisaggCoordinator`` runs the two hops over HTTP (prefill host ->
  handoff bytes -> decode host) with streams equal to a unified engine,
  and falls back to the decode host's ``/v1/generate`` when every prefill
  target is down.

Tolerances: streams token for token; float32 cache planes within 1e-5
and float64 within 1e-10 of JAX's (the same prefill in another order).
"""

import numpy as np
import pytest
import torch

import ml_dtypes

from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo import TransformerLM as JaxLM
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.parallel.decode import DecodeEngine as JaxEngine
from deeplearning4j_tpu.serving.disagg import PrefillEngine as JaxPrefill
from deeplearning4j_tpu.serving.disagg import deserialize_handoff as jax_deserialize
from deeplearning4j_tpu.serving.disagg import serialize_handoff as jax_serialize

from deeplearning4j_tpu_torch.core.resilience import CircuitBreaker
from deeplearning4j_tpu_torch.model import restore_multi_layer_network
from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import DecodeEngine
from deeplearning4j_tpu_torch.remote import JsonModelServer
from deeplearning4j_tpu_torch.serving import (DisaggCoordinator, PrefillEngine,
                                              deserialize_handoff, serialize_handoff)
from deeplearning4j_tpu_torch.serving.disagg import HANDOFF_VERSION

from torch_decode_helpers import MAX_LEN, PROMPTS, VOCAB, draft_pair, lm_pair
from torch_serving_helpers import generate, get, tokens

N_TOK = 6
PLANE_TOL = {"float32": 1e-5, "float64": 1e-10}


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    return lm_pair(tmp_path_factory)


@pytest.fixture(scope="module")
def lms64(tmp_path_factory):
    jm = JaxLM(vocab_size=VOCAB, hidden=32, n_layers=2, n_heads=4, max_len=MAX_LEN,
               seed=5, dtype="float64").init()
    path = str(tmp_path_factory.mktemp("lm64") / "lm.zip")
    jax_write(jm, path)
    return jm, restore_multi_layer_network(path, device="cpu")


def _prefills(jm, pm, cache_dtype=None):
    return (JaxPrefill(jm, max_len=MAX_LEN, cache_dtype=cache_dtype, registry=JaxRegistry()),
            PrefillEngine(pm, max_len=MAX_LEN, cache_dtype=cache_dtype,
                          registry=MetricsRegistry()))


def _engine(pkg, model, **kw):
    kw.setdefault("slots", 4)
    if pkg == "jax":
        return JaxEngine(model, max_len=MAX_LEN, registry=JaxRegistry(), **kw)
    return DecodeEngine(model, max_len=MAX_LEN, registry=MetricsRegistry(), **kw)


def _unified(eng, prompts, **kw):
    hs = [eng.submit(p, max_tokens=N_TOK, **kw) for p in prompts]
    return [h.result(timeout=120) for h in hs]


def _resumed(pe, eng, prompts, serialize, deserialize, **kw):
    out = []
    for p in prompts:
        h = eng.submit_prefilled(deserialize(serialize(pe.prefill(p, max_tokens=N_TOK, **kw))))
        out.append(h.result(timeout=120))
        assert h.reason == "completed"
    return out


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["float64", "float32", "int8"])
def test_handoff_bytes_equal_across_packages(case, lms, lms64):
    jm, pm = lms64 if case == "float64" else lms
    jpe, ppe = _prefills(jm, pm, "int8" if case == "int8" else None)
    jh = jpe.prefill(PROMPTS[1], max_tokens=4, seed=3, eos_id=7)
    ph = ppe.prefill(PROMPTS[1], max_tokens=4, seed=3, eos_id=7)
    for h in (jh, ph):
        wire = serialize_handoff(h)
        assert wire == jax_serialize(h)
        assert serialize_handoff(jax_deserialize(wire)) == wire
        assert jax_serialize(deserialize_handoff(wire)) == wire
    jw, pw = jax_serialize(jh), serialize_handoff(ph)
    # the same header (first token, sampling law, tensor manifest) ...
    assert jw[:jw.index(b"\n")] == pw[:pw.index(b"\n")]
    assert ph["version"] == HANDOFF_VERSION and ph["first_token"] == jh["first_token"]
    # ... and the same cache planes up to the prefill's rounding
    for name, planes in jh["layers"].items():
        for key, want in planes.items():
            got = ph["layers"][name][key]
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype
            if case == "int8" and key in ("cache_k", "cache_v"):
                assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
            else:
                tol = PLANE_TOL.get(case, 1e-5)
                np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_bfloat16_planes_round_trip_as_jax_bytes():
    rs = np.random.RandomState(0)
    plane = torch.from_numpy(rs.randn(1, 2, 3, 4).astype(np.float32)).to(torch.bfloat16)
    h = {"prompt": [1, 2, 3], "first_token": 5, "pos": 3, "cache_dtype": None,
         "sampling": {"seed": 1, "greedy": True}, "layers": {"layer_2": {"cache_k": plane}}}
    wire = serialize_handoff(h)
    back = deserialize_handoff(wire)["layers"]["layer_2"]["cache_k"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, plane)
    # the JAX package reads the same bits as ml_dtypes.bfloat16 and writes
    # them back byte for byte
    jarr = jax_deserialize(wire)["layers"]["layer_2"]["cache_k"]
    assert jarr.dtype == ml_dtypes.bfloat16
    assert np.array_equal(jarr.view(np.int16), plane.view(torch.int16).numpy())
    assert jax_serialize(jax_deserialize(wire)) == wire
    jh = dict(h, layers={"layer_2": {"cache_k": plane.float().numpy().astype(ml_dtypes.bfloat16)}})
    assert jax_serialize(jh) == wire
    assert torch.equal(deserialize_handoff(jax_serialize(jh))["layers"]["layer_2"]["cache_k"],
                       plane)


def test_bad_payloads_are_refused(lms):
    _, pm = lms
    wire = serialize_handoff(PrefillEngine(pm, max_len=MAX_LEN, registry=MetricsRegistry())
                             .prefill([1, 2, 3]))
    with pytest.raises(ValueError, match="smaller than requested"):
        deserialize_handoff(wire[:-1])  # truncated
    with pytest.raises(ValueError, match="size mismatch"):
        deserialize_handoff(wire + b"\0")  # trailing bytes
    bumped = wire.replace(b'"version": 1', b'"version": 9', 1)
    with pytest.raises(ValueError, match="unsupported handoff version"):
        deserialize_handoff(bumped)


# ---------------------------------------------------------------------------
# resume across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", [{}, {"block_size": 4}], ids=["static", "paged"])
def test_jax_handoff_resumes_in_the_port(layout, lms):
    jm, pm = lms
    jpe, _ = _prefills(jm, pm)
    jeng, peng = _engine("jax", jm), _engine("port", pm, **layout)
    try:
        want = _unified(jeng, PROMPTS)
        got = _resumed(jpe, peng, PROMPTS, jax_serialize, deserialize_handoff)
        assert got == want
        assert peng.handoff_copy["requests"] == len(PROMPTS)
        assert peng.handoff_copy["bytes"] > 0
    finally:
        jeng.shutdown()
        peng.shutdown()


def test_port_handoff_resumes_in_jax(lms):
    jm, pm = lms
    _, ppe = _prefills(jm, pm)
    jeng, peng = _engine("jax", jm, block_size=4), _engine("port", pm)
    try:
        want = _unified(peng, PROMPTS)
        assert _resumed(ppe, jeng, PROMPTS, serialize_handoff, jax_deserialize) == want
    finally:
        jeng.shutdown()
        peng.shutdown()


@pytest.mark.parametrize("kw", [
    dict(engine={}, prefill={}, sampling=dict(greedy=False, temperature=0.9, top_k=8, seed=11)),
    dict(engine={"block_size": 4, "cache_dtype": "int8"}, prefill={"cache_dtype": "int8"},
         sampling={}),
    dict(engine={"block_size": 4, "speculative_k": 3}, prefill={}, sampling={}),
], ids=["sampled", "paged-int8", "speculative"])
def test_port_resume_equals_port_unified(kw, lms, tmp_path_factory):
    _, pm = lms
    ekw = dict(kw["engine"])
    if "speculative_k" in ekw:
        ekw["draft_model"] = draft_pair(tmp_path_factory)[1]
    ppe = PrefillEngine(pm, max_len=MAX_LEN, registry=MetricsRegistry(), **kw["prefill"])
    unified, resumed = _engine("port", pm, **ekw), _engine("port", pm, **ekw)
    try:
        want = _unified(unified, PROMPTS, **kw["sampling"])
        got = _resumed(ppe, resumed, PROMPTS, serialize_handoff, deserialize_handoff,
                       **kw["sampling"])
        assert got == want
    finally:
        unified.shutdown()
        resumed.shutdown()


def test_handoff_validation(lms):
    _, pm = lms
    ppe8 = PrefillEngine(pm, max_len=MAX_LEN, cache_dtype="int8", registry=MetricsRegistry())
    ppe = PrefillEngine(pm, max_len=MAX_LEN, registry=MetricsRegistry())
    eng = _engine("port", pm, block_size=4)
    try:
        with pytest.raises(ValueError, match="cache_dtype"):
            eng.submit_prefilled(ppe8.prefill([1, 2, 3], max_tokens=4))
        with pytest.raises(ValueError, match="pos"):
            eng.submit_prefilled(dict(ppe.prefill([1, 2, 3], max_tokens=4), pos=2))
        ho = ppe.prefill([1, 2, 3], max_tokens=4)
        name = next(iter(ho["layers"]))
        broken = dict(ho, layers={k: v for k, v in ho["layers"].items() if k != name})
        term = list(eng.submit_prefilled(broken).events(timeout=60))[-1]
        assert term["reason"] == "failed" and name in term.get("error", "")
        # the engine still serves after a failed install
        assert len(eng.submit_prefilled(ho).result(timeout=60)) == 4
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# the coordinator over HTTP
# ---------------------------------------------------------------------------


def test_coordinator_two_hops_and_fallback(lms):
    _, pm = lms
    reg = MetricsRegistry()
    local = _engine("port", pm)
    want = _unified(local, PROMPTS)
    local.shutdown()
    pre = JsonModelServer(prefill=PrefillEngine(pm, max_len=MAX_LEN, registry=reg),
                          registry=reg, name="prefill-host").start()
    dec_eng = _engine("port", pm, block_size=4)
    dec = JsonModelServer(generator=dec_eng, registry=reg, name="decode-host").start()
    coord = DisaggCoordinator(
        [f"http://127.0.0.1:{pre.port}"], [f"http://127.0.0.1:{dec.port}"],
        timeout=60.0, registry=reg, name="coord",
        breaker_factory=lambda: CircuitBreaker(failure_threshold=1.0, min_calls=1,
                                               open_timeout=60.0))
    front = JsonModelServer(generator=coord, registry=reg, name="front").start()
    try:
        got = [tokens(generate(front.port, p, max_tokens=N_TOK)) for p in PROMPTS]
        assert got == want
        assert coord.stats()["handoffs"]["completed"] == len(PROMPTS)
        assert dec_eng.handoff_copy["requests"] == len(PROMPTS)
        health = get(front.port, "/health")[2]
        assert health["status"] == "ok" and "roles" in health["generate"]
        pre.stop()
        got = [tokens(generate(front.port, p, max_tokens=N_TOK)) for p in PROMPTS]
        assert got == want
        s = coord.stats()
        assert s["handoffs"]["fallback"] == len(PROMPTS) and s["fallbacks"] == len(PROMPTS)
        assert s["handoffs"]["failed"] == 0
    finally:
        front.stop()
        coord.shutdown()
        dec.stop()
        dec_eng.shutdown()
        pre.stop()
