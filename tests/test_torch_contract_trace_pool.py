"""The port's trace and pool contract harnesses on the CPU
(``deeplearning4j_tpu_torch/tools/check_{trace,pool}_contract.py``), each
beside the JAX package's harness of the same name in ``tools/``:

* the port's harness passes with ``main(device="cpu", model="tiny")``;
* it prints the JAX harness's gate lines, in order (numbers masked);
* trace: the span trees of the ``TraceStore`` the harness served
  ``/v1/traces`` from (each trace's span names with their parents' names)
  are the same set in both runs;
* pool: the status codes of every HTTP call, the main thread's in order
  and the other threads' as a sorted list, equal the JAX run's.

Span names and status codes are exact; there is no tolerance."""

import pytest

from torch_contract_helpers import StatusRecorder, labels, run_jax, run_port


def _capture_stores(mp, tracing_module):
    """Patch ``TraceStore`` of a tracing module so that every store a
    harness makes is kept: the list of them."""
    stores = []
    base = tracing_module.TraceStore

    class Kept(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            stores.append(self)

    mp.setattr(tracing_module, "TraceStore", Kept)
    return stores


def _trees(store) -> set:
    """{frozenset of (span name, parent span name)} over the store's traces."""
    out = set()
    for t in store.traces():
        by_id = {s["span_id"]: s["name"] for s in t["spans"]}
        out.add(frozenset((s["name"], by_id.get(s["parent_id"])) for s in t["spans"]))
    return out


@pytest.fixture(scope="module")
def trace():
    import deeplearning4j_tpu.obs.tracing as jax_tracing

    import deeplearning4j_tpu_torch.obs.tracing as port_tracing

    with pytest.MonkeyPatch.context() as mp:
        jax_stores = _capture_stores(mp, jax_tracing)
        jax_lines = run_jax("check_trace_contract")
    with pytest.MonkeyPatch.context() as mp:
        port_stores = _capture_stores(mp, port_tracing)
        port_lines = run_port("check_trace_contract", model="tiny")
    return jax_lines, jax_stores[0], port_lines, port_stores[0]


def test_port_trace_contract_passes_on_the_cpu(trace):
    assert trace[2][-1] == "trace contract OK"


def test_trace_gates_match_jax(trace):
    assert labels(trace[2]) == labels(trace[0])


def test_trace_span_trees_match_jax(trace):
    jax_trees, port_trees = _trees(trace[1]), _trees(trace[3])
    assert port_trees == jax_trees
    # the full client -> server -> engine tree is among them
    assert frozenset({("client.request", None), ("client.http", "client.request"),
                      ("server.request", "client.http"),
                      ("engine.queue_wait", "server.request"),
                      ("engine.batch", "server.request"),
                      ("engine.forward", "server.request")}) in port_trees


@pytest.fixture(scope="module")
def pool():
    with pytest.MonkeyPatch.context() as mp:
        rec = StatusRecorder(mp)
        jax_lines = run_jax("check_pool_contract")
        jax_codes = rec.take()
        port_lines = run_port("check_pool_contract", model="tiny")
        port_codes = rec.take()
    return jax_lines, jax_codes, port_lines, port_codes


def test_port_pool_contract_passes_on_the_cpu(pool):
    assert pool[2][-1] == "pool contract OK"


def test_pool_gates_match_jax(pool):
    assert labels(pool[2]) == labels(pool[0])


def test_pool_status_codes_match_jax(pool):
    jax_codes, port_codes = pool[1], pool[3]
    assert port_codes[0] == jax_codes[0]
    assert port_codes[1] == jax_codes[1]
