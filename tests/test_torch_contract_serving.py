"""The port's serving and metrics contract harnesses on the CPU
(``deeplearning4j_tpu_torch/tools/check_{serving,metrics}_contract.py``),
each beside the JAX package's harness of the same name in ``tools/``:

* the port's harness passes with ``main(device="cpu", model="tiny")``;
* it prints the JAX harness's gate lines, in order (numbers masked);
* serving: the status codes of every HTTP call, the main thread's in
  order and the other threads' as a sorted list, equal the JAX run's;
* metrics: the scraped exposition (``/metrics`` of the server, then of the
  ``UIServer``) holds the same families, of the same types, with the same
  label names, in both runs; the contract series and their expected
  values are the JAX harness's (``CONTRACT``, ``CONTRACT_OUTCOMES``).

Status codes and family types are exact; there is no tolerance.

The JAX metrics harness scrapes ``/metrics`` as soon as its fourth request
has been answered, but the server counts a request (status code and
latency) after writing its answer, so under load the scrape can miss it
("code=504 count wrong", "latency _count != 4"). The port's harness waits,
bounded, until the server has counted all four; the JAX run here is run
once more if it fails with one of those messages."""

import pytest

from torch_contract_helpers import (StatusRecorder, jax_harness, labels, port_harness,
                                    run_jax, run_port)


METRICS_RACE = ("count wrong", "latency _count != 4")


@pytest.fixture(scope="module")
def serving():
    with pytest.MonkeyPatch.context() as mp:
        rec = StatusRecorder(mp)
        jax_lines = run_jax("check_serving_contract")
        jax_codes = rec.take()
        port_lines = run_port("check_serving_contract", model="tiny")
        port_codes = rec.take()
    return jax_lines, jax_codes, port_lines, port_codes


def test_port_serving_contract_passes_on_the_cpu(serving):
    assert serving[2][-1] == "serving contract OK"


def test_serving_gates_match_jax(serving):
    assert labels(serving[2]) == labels(serving[0])


def test_serving_status_codes_match_jax(serving):
    jax_codes, port_codes = serving[1], serving[3]
    assert port_codes[0] == jax_codes[0]
    assert port_codes[1] == jax_codes[1]
    codes = {c for _, c in port_codes[0]}
    assert {200, 400, 500, 503, 504} <= codes, codes


@pytest.fixture(scope="module")
def metrics():
    runs = {}
    for side, mod in (("jax", jax_harness("check_metrics_contract")),
                      ("port", port_harness("check_metrics_contract"))):
        scrapes = []
        with pytest.MonkeyPatch.context() as mp:
            real = mod.parse_exposition
            mp.setattr(mod, "parse_exposition",
                       lambda text, real=real: scrapes.append(real(text)) or scrapes[-1])
            lines = (run_jax("check_metrics_contract", known_races=METRICS_RACE) if side == "jax"
                     else run_port("check_metrics_contract", model="tiny"))
        runs[side] = (lines, scrapes[-2:])  # a rerun scrapes twice more
    return runs


def test_port_metrics_contract_passes_on_the_cpu(metrics):
    assert metrics["port"][0][-1] == "metrics contract OK"


def test_metrics_gates_match_jax(metrics):
    assert labels(metrics["port"][0]) == labels(metrics["jax"][0])


def test_metrics_contract_constants_are_the_jax_harness(metrics):
    jm, pm = jax_harness("check_metrics_contract"), port_harness("check_metrics_contract")
    assert pm.CONTRACT == jm.CONTRACT and pm.CONTRACT_OUTCOMES == jm.CONTRACT_OUTCOMES


@pytest.mark.parametrize("scrape", [0, 1], ids=["server", "ui"])
def test_metrics_families_types_and_labels_match_jax(metrics, scrape):
    jax_fams, port_fams = metrics["jax"][1][scrape], metrics["port"][1][scrape]

    def shape(fams):
        return {name: (f["type"], sorted({tuple(sorted(l)) for _, l, _ in f["samples"]}))
                for name, f in fams.items()}

    assert shape(port_fams) == shape(jax_fams)


def test_metrics_contract_values_match_jax(metrics):
    def values(fams):
        served = sorted((l["code"], v) for _, l, v in
                        fams["dl4j_tpu_serving_requests_total"]["samples"])
        count = [v for n, _, v in fams["dl4j_tpu_serving_request_latency_seconds"]["samples"]
                 if n.endswith("_count")]
        return served, count

    assert values(metrics["port"][1][0]) == values(metrics["jax"][1][0])
