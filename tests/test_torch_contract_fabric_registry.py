"""The port's fabric, registry and input-pipeline contract harnesses on the
CPU (``deeplearning4j_tpu_torch/tools/check_{fabric,registry,
input_pipeline}_contract.py``), each beside the JAX package's harness of
the same name in ``tools/``:

* the port's harness passes with ``main(device="cpu", model="tiny")``;
* it prints the JAX harness's gate lines, in order (numbers masked);
* fabric: its breaker geometry (``BREAKER_WINDOW_S`` and the rest) is the
  JAX harness's, and, run on the tiny network in float64, the answers the
  front pool relayed from the two hosts in gate 1 are within 1e-10 of the
  JAX network's ``output()`` on the same rows and weights (the port's model
  zip read by the JAX package) rounded to float32: both servers read rows
  as float32, and a ``RemoteReplica`` reads a host's answer as float32 in
  both packages;
* input pipeline: ``DATA_WAIT_SHARE_MAX`` is the JAX harness's 0.25.

The JAX fabric harness counts the dead host's dispatches over 10 answers
without holding its breaker, which admits a half-open trial once
``BREAKER_OPEN_TIMEOUT`` (0.6 s) has passed ("open replica still
dispatched"), and needs live traffic to meet the dead host before its
prober does ("kill must be witnessed as failover"): both are races on a
loaded host. The port's harness holds the breaker over the window and
hands the pool a burst at the kill. The JAX run here, which only gives
the gate lines, opens its breakers for ``JAX_OPEN_TIMEOUT_S`` instead of
0.6 s (on a loaded host its 10 answers took longer than 0.6 s: both tries
failed in one of my whole runs) and is run once more if it fails with one
of those messages."""

import numpy as np
import pytest

from torch_contract_helpers import jax_copy, jax_harness, labels, port_harness, run_jax, run_port


FABRIC_RACES = ("open replica still dispatched", "kill must be witnessed as failover")
JAX_OPEN_TIMEOUT_S = 3.0


@pytest.fixture(scope="module")
def fabric():
    record = {}
    port_lines = run_port("check_fabric_contract", model="tiny", dtype="float64",
                          record=record)
    jax_lines = run_jax("check_fabric_contract", known_races=FABRIC_RACES,
                        constants={"BREAKER_OPEN_TIMEOUT": JAX_OPEN_TIMEOUT_S})
    return jax_lines, port_lines, record


def test_port_fabric_contract_passes_on_the_cpu(fabric):
    assert fabric[1][-1] == "fabric contract OK"


def test_fabric_gates_match_jax(fabric):
    assert labels(fabric[1]) == labels(fabric[0])


def test_fabric_breaker_geometry_is_the_jax_harness():
    jm, pm = jax_harness("check_fabric_contract"), port_harness("check_fabric_contract")
    for k in ("PROBE_INTERVAL", "BREAKER_MIN_CALLS", "BREAKER_OPEN_TIMEOUT", "BREAKER_WINDOW_S"):
        assert getattr(pm, k) == getattr(jm, k), k


def test_fabric_answers_match_jax(fabric, tmp_path):
    record = fabric[2]
    jm = jax_copy(record["model"], str(tmp_path))
    rows, answers = zip(*record["answers"])
    assert len(rows) == 20
    x = np.concatenate([np.asarray(r, np.float32) for r in rows]).astype(np.float64)
    want = np.asarray(jm.output(x))
    assert want.dtype == np.float64
    got = np.concatenate([np.asarray(a, np.float64) for a in answers])
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def registry():
    port_lines = run_port("check_registry_contract", model="tiny")
    return run_jax("check_registry_contract"), port_lines


def test_port_registry_contract_passes_on_the_cpu(registry):
    assert registry[1][-1] == "registry contract OK"


def test_registry_gates_match_jax(registry):
    assert labels(registry[1]) == labels(registry[0])


@pytest.fixture(scope="module")
def input_pipeline():
    port_lines = run_port("check_input_pipeline_contract", model="tiny")
    return run_jax("check_input_pipeline_contract"), port_lines


def test_port_input_pipeline_contract_passes_on_the_cpu(input_pipeline):
    assert input_pipeline[1][-1] == "input-pipeline contract OK"


def test_input_pipeline_gates_match_jax(input_pipeline):
    assert labels(input_pipeline[1]) == labels(input_pipeline[0])


def test_input_pipeline_threshold_is_the_jax_harness():
    assert (port_harness("check_input_pipeline_contract").DATA_WAIT_SHARE_MAX
            == jax_harness("check_input_pipeline_contract").DATA_WAIT_SHARE_MAX == 0.25)
