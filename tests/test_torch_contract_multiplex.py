"""The port's multi-tenant multiplexing chaos harness on the CPU
(``deeplearning4j_tpu_torch/tools/check_multiplex_contract.py``) beside the
JAX package's ``tools/check_multiplex_contract.py``:

* the port's harness passes with ``main(device="cpu", model="tiny")``
  (8 models plus an int8 one, a budget for ~4 warm, the hot-tenant p99 SLO
  of 2.0 s), here on its networks in float64; its constants are the JAX
  harness's;
* it prints the JAX harness's gate lines, in order (numbers masked;
  measurement lines dropped);
* its unparked answers are bitwise equal to the pre-park ones (a gate of
  the harness itself), and each model's first answer is within 1e-10 of
  the JAX network's ``output()`` in float64 on the same weights (the
  port's model zip read by the JAX package) and the same row."""

import numpy as np
import pytest

from torch_contract_helpers import jax_copy, jax_harness, labels, port_harness, run_jax, run_port


@pytest.fixture(scope="module")
def multiplex():
    record = {}
    port_lines = run_port("check_multiplex_contract", model="tiny", dtype="float64",
                          record=record)
    return run_jax("check_multiplex_contract"), port_lines, record


def test_port_multiplex_contract_passes_on_the_cpu(multiplex):
    assert multiplex[1][-1] == "multiplex contract OK"


def test_multiplex_gates_match_jax(multiplex):
    assert labels(multiplex[1]) == labels(multiplex[0])


def test_multiplex_constants_are_the_jax_harness():
    jm, pm = jax_harness("check_multiplex_contract"), port_harness("check_multiplex_contract")
    for k in ("N_MODELS", "WARM_TARGET", "HOT_MODELS", "CHURN_SECONDS", "HOT_P99_SLO_S", "FEAT"):
        assert getattr(pm, k) == getattr(jm, k), k
    assert pm.HOT_P99_SLO_S == 2.0


@pytest.mark.parametrize("i", range(8))
def test_multiplex_answers_match_jax(multiplex, tmp_path, i):
    record = multiplex[2]
    got = record["outputs"][f"m{i}"]
    assert got.dtype == np.float64
    jm = jax_copy(record["models"][100 + i], str(tmp_path))
    want = np.asarray(jm.output(np.asarray(record["x"], np.float64)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
