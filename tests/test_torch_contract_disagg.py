"""The port's disaggregated-serving chaos harness on the CPU
(``deeplearning4j_tpu_torch/tools/check_disagg_contract.py``) beside the
JAX package's ``tools/check_disagg_contract.py``:

* the port's harness passes with ``main(device="cpu", model="tiny")`` (the
  JAX harness's LM: vocab 23, hidden 32, 2 blocks), its breaker geometry
  the JAX harness's;
* it prints the JAX harness's gate lines, in order (numbers masked);
* the two-hop pipeline's greedy stream (5 tokens after ``[1, 2, 3]``)
  equals, token for token, the JAX ``GenerationSession``'s greedy tokens on
  the same weights, read from the port's model zip.

Tokens are exact; there is no tolerance. The JAX harness reads the dead
prefill target's breaker at an arbitrary time after its load stops, and
an open breaker reads ``half_open`` once ``BREAKER_OPEN_TIMEOUT`` has
passed since the last failed probe ("dead prefill target not open"); the
port's harness reads it right after a probe. The JAX run here, which only
gives the gate lines, opens its breakers for ``JAX_OPEN_TIMEOUT_S`` instead
of 0.6 s, and is run once more if it fails with that message."""

import pytest

from torch_contract_helpers import jax_copy, jax_harness, labels, port_harness, run_jax, run_port

JAX_OPEN_TIMEOUT_S = 3.0


@pytest.fixture(scope="module")
def disagg():
    record = {}
    port_lines = run_port("check_disagg_contract", model="tiny", record=record)
    jax_lines = run_jax("check_disagg_contract", known_races=("dead prefill target not open",),
                        constants={"BREAKER_OPEN_TIMEOUT": JAX_OPEN_TIMEOUT_S})
    return jax_lines, port_lines, record


def test_port_disagg_contract_passes_on_the_cpu(disagg):
    assert disagg[1][-1] == "disagg contract OK"


def test_disagg_gates_match_jax(disagg):
    assert labels(disagg[1]) == labels(disagg[0])


def test_disagg_breaker_geometry_is_the_jax_harness():
    jm, pm = jax_harness("check_disagg_contract"), port_harness("check_disagg_contract")
    for k in ("PROBE_INTERVAL", "BREAKER_MIN_CALLS", "BREAKER_OPEN_TIMEOUT",
              "BREAKER_WINDOW_S", "MAX_LEN"):
        assert getattr(pm, k) == getattr(jm, k), k


def test_disagg_stream_matches_jax_greedy(disagg, tmp_path):
    from deeplearning4j_tpu.generate import GenerationSession as JaxSession

    record = disagg[2]
    jm = jax_copy(record["model"], str(tmp_path))
    want = JaxSession(jm, max_len=24).generate([[1, 2, 3]], 5, greedy=True)[0]
    assert record["stream"] == [int(t) for t in want]
