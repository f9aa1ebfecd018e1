"""The port's generation-serving contract harness on the CPU
(``deeplearning4j_tpu_torch/tools/check_generate_contract.py``) beside the
JAX package's ``tools/check_generate_contract.py``:

* the port's harness passes with ``main(device="cpu", model="tiny")``
  (the JAX harness's LM: vocab 23, hidden 32, 2 blocks; its draft);
* it prints the JAX harness's gate lines, in order;
* the greedy stream it served over HTTP (6 tokens after ``[1, 2, 3]``,
  which every later gate's stream, the speculative pool's included, was
  held to) equals, token for token, the JAX ``GenerationSession``'s greedy
  tokens on the same weights, read from the port's model zip.

Tokens are exact; there is no tolerance."""

import pytest

from torch_contract_helpers import jax_copy, labels, run_jax, run_port


@pytest.fixture(scope="module")
def generate():
    record = {}
    port_lines = run_port("check_generate_contract", model="tiny", record=record)
    return run_jax("check_generate_contract"), port_lines, record


def test_port_generate_contract_passes_on_the_cpu(generate):
    assert generate[1][-1] == "pooled acceptance-rate stats + per-replica circuits ok"


def test_generate_gates_match_jax(generate):
    assert labels(generate[1]) == labels(generate[0])


def test_generate_stream_matches_jax_greedy(generate, tmp_path):
    from deeplearning4j_tpu.generate import GenerationSession as JaxSession

    record = generate[2]
    jm = jax_copy(record["model"], str(tmp_path))
    want = JaxSession(jm, max_len=24).generate([[1, 2, 3]], 6, greedy=True)[0]
    assert len(record["stream"]) == 6
    assert record["stream"] == [int(t) for t in want]
