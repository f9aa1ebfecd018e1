"""The port's graph-rewrite equivalence harness on the CPU
(``deeplearning4j_tpu_torch/tools/check_rewrite_equivalence.py``) beside
the JAX package's ``tools/check_rewrite_equivalence.py``:

* the port's harness passes with ``main(device="cpu", model="tiny")`` on
  its graphs in float32, at the JAX harness's ``TOL`` 2e-5;
* it prints the JAX harness's gate lines, in order (numbers masked).

``tests/test_torch_contract_rewrite_f64.py`` holds its rewrites to the JAX
package's in float64."""

import pytest

from torch_contract_helpers import jax_harness, labels, port_harness, run_jax, run_port


@pytest.fixture(scope="module")
def rewrite():
    port_lines = run_port("check_rewrite_equivalence", model="tiny")
    return run_jax("check_rewrite_equivalence"), port_lines


def test_port_rewrite_contract_passes_on_the_cpu(rewrite):
    assert rewrite[1][-1] == "rewrite equivalence contract: all checks passed"


def test_rewrite_gates_match_jax(rewrite):
    assert labels(rewrite[1]) == labels(rewrite[0])


def test_rewrite_tolerance_is_the_jax_harness():
    assert (port_harness("check_rewrite_equivalence").TOL
            == jax_harness("check_rewrite_equivalence").TOL == 2e-5)
