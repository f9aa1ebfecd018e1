"""The port's training UI (``deeplearning4j_tpu_torch/ui``) against the JAX
package's, on the CPU.

``StatsListener``: the same network (carried over through the JAX zip) fit
on the same batches in float32 in both packages gives records with the
same keys, iterations and histogram layout; scores, the params' and
gradients' statistics and the update:param ratios agree to ``TOL_STATS``
(relative, or of the tensor's mean magnitude for a statistic near zero:
the two float32 steps differ by summation order, ~1e-7, and an update is a
difference of two params) and histogram counts exactly. A
``FileStatsStorage`` file written by one package reads in the other.
``UIServer`` serves the same routes with the same JSON as the JAX server
over one storage. ``enable_debug_nans`` raises at the op that first makes
a NaN, forward and backward."""

import json
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.train.updaters import Adam as JAdam
from deeplearning4j_tpu import ui as jui

from deeplearning4j_tpu_torch import ui as tui
from deeplearning4j_tpu_torch.model import restore_computation_graph, restore_multi_layer_network

TOL_STATS = 1e-4


def _data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    return x, y


def _mln():
    conf = (JConf.builder().seed(3).updater(JAdam(learning_rate=1e-2)).list()
            .layer(JDense(n_in=4, n_out=8)).layer(JOut(n_in=8, n_out=2)).build())
    return JMLN(conf).init()


def _graph():
    g = (JConf.builder().seed(1).updater(JAdam(1e-2)).graph_builder().add_inputs("in")
         .set_input_types(JInputType.feed_forward(4)))
    g.add_layer("d", JDense(n_out=8), "in")
    g.add_layer("out", JOut(n_out=2), "d")
    return JGraph(g.set_outputs("out").build()).init()


def _pair(kind, tmp_path):
    jmodel = _mln() if kind == "mln" else _graph()
    path = str(tmp_path / f"{kind}.zip")
    jax_write(jmodel, path)
    restore = restore_multi_layer_network if kind == "mln" else restore_computation_graph
    return jmodel, restore(path, device="cpu")


def _fit(model, x, y, kind, epochs):
    if kind == "mln":
        model.fit(x, y, epochs=epochs)
    else:
        model.fit([x], [y], epochs=epochs)


def _close_stats(a, b):
    """Each statistic within ``TOL_STATS`` of the tensor's mean magnitude (a
    mean near zero is all rounding)."""
    assert set(a) == set(b)
    scale = TOL_STATS * a["mean_magnitude"]
    for k in ("mean", "std", "norm", "mean_magnitude"):
        assert b[k] == pytest.approx(a[k], rel=TOL_STATS, abs=scale), k
    ha, hb = a["histogram"], b["histogram"]
    assert hb["counts"] == ha["counts"]
    assert hb["min"] == pytest.approx(ha["min"], rel=TOL_STATS, abs=scale)
    assert hb["max"] == pytest.approx(ha["max"], rel=TOL_STATS, abs=scale)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_stats_listener_records_match_jax(tmp_path, kind):
    jmodel, tmodel = _pair(kind, tmp_path)
    js, ts = jui.InMemoryStatsStorage(), tui.InMemoryStatsStorage()
    jmodel.add_listeners(jui.StatsListener(js, session_id="s", update_frequency=2))
    tmodel.add_listeners(tui.StatsListener(ts, session_id="s", update_frequency=2))
    x, y = _data()
    _fit(jmodel, x, y, kind, 5)
    _fit(tmodel, x, y, kind, 5)
    jr, tr = js.records("s"), ts.records("s")
    assert len(tr) == len(jr) == 5
    for a, b in zip(jr, tr):
        assert set(b) == set(a)
        assert (b["session"], b["iteration"], b["epoch"]) == (a["session"], a["iteration"],
                                                              a["epoch"])
        assert b["score"] == pytest.approx(a["score"], rel=TOL_STATS)
        for group in ("params", "gradients", "updates"):
            if group in a:
                assert set(b[group]) == set(a[group])
                for name in a[group]:
                    _close_stats(a[group][name], b[group][name])
        for name, ratio in a.get("update_ratios", {}).items():
            assert b["update_ratios"][name] == pytest.approx(ratio, rel=TOL_STATS)
    assert any("update_ratios" in r for r in tr)
    first = "layer_0/W" if kind == "mln" else "d/W"
    assert ts.update_ratios(first, "s") == pytest.approx(js.update_ratios(first, "s"),
                                                         rel=TOL_STATS)


def test_stats_listener_copies_in_place_params():
    """The port's params are updated in place: the listener's previous params
    must be a copy, or every update would read zero."""
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.train.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_in=4, n_out=8)).layer(OutputLayer(n_in=8, n_out=2)).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    storage = tui.InMemoryStatsStorage()
    model.add_listeners(tui.StatsListener(storage, update_frequency=1))
    model.fit(*_data(), epochs=3)
    ratios = storage.update_ratios("layer_0/W")
    assert len(ratios) == 2 and all(r > 1e-4 for r in ratios)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_stats_storage_cross_packages(tmp_path, writer):
    path = str(tmp_path / "stats.jsonl")
    w, r = (jui, tui) if writer == "jax" else (tui, jui)
    model = _mln()
    jax_write(model, str(tmp_path / "m.zip"))
    if writer == "port":
        model = restore_multi_layer_network(str(tmp_path / "m.zip"), device="cpu")
    storage = w.FileStatsStorage(path)
    model.add_listeners(w.StatsListener(storage, session_id="run", update_frequency=2))
    model.fit(*_data(), epochs=4)
    storage.close()
    back = r.FileStatsStorage(path)
    assert back.session_ids() == ["run"]
    assert back.records("run") == storage.records("run")
    assert back.scores("run") == storage.scores("run") and len(back.scores("run")) == 4
    assert back.update_ratios("layer_1/W", "run") == storage.update_ratios("layer_1/W", "run")


def _get(base, path):
    with urllib.request.urlopen(base + path) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_ui_server_routes_match_jax():
    storages = (jui.InMemoryStatsStorage(), tui.InMemoryStatsStorage())
    for st in storages:
        for i in range(5):
            st.put({"session": "s1" if i < 3 else "s2", "iteration": i, "score": 2.0 / (i + 1),
                    "update_ratios": {"layer_0/W": 10.0 ** (-3 + 0.1 * i)}})
    # each server its own registry and tracer: the processes' global ones
    # hold whatever earlier tests in this worker recorded
    from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JRegistry
    from deeplearning4j_tpu.obs.tracing import Tracer as JTracer

    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.obs.tracing import Tracer

    servers = [jui.UIServer(port=0, registry=JRegistry(), tracer=JTracer())
               .attach(storages[0]).start(),
               tui.UIServer(port=0, registry=MetricsRegistry(), tracer=Tracer())
               .attach(storages[1]).start()]
    try:
        bases = [f"http://127.0.0.1:{s.port}" for s in servers]
        for path in ("/", "/train", "/train/overview"):
            (sj, cj, bj), (sp, cp, bp) = (_get(b, path) for b in bases)
            assert (sp, cp, bp) == (sj, cj, bj) and b"training UI" in bp
        for path in ("/train/sessions", "/train/stats?sessionId=s1", "/train/stats",
                     "/v1/traces", "/v1/traces?limit=3&min_ms=x"):
            (sj, cj, bj), (sp, cp, bp) = (_get(b, path) for b in bases)
            assert (sp, cp) == (sj, cj) == (200, "application/json")
            assert json.loads(bp) == json.loads(bj), path
        sj, cj, _ = _get(bases[0], "/metrics")
        sp, cp, body = _get(bases[1], "/metrics")
        assert (sp, cp) == (sj, cj) and sp == 200
        assert body.decode().endswith("\n") or body == b""
        for base in bases:
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(base, "/nope")
            assert err.value.code == 404
    finally:
        for s in servers:
            s.stop()
    assert tui.UIServer(port=0).stats_payload(None) == jui.UIServer(port=0).stats_payload(None)


def test_profiling_and_nan_panic_listeners(tmp_path):
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(DenseLayer(n_in=4, n_out=8)).layer(OutputLayer(n_in=8, n_out=2)).build())
    model = MultiLayerNetwork(conf, device="cpu").init()
    path = str(tmp_path / "trace.json")
    model.add_listeners(tui.ProfilingListener(path), tui.NanPanicListener())
    model.fit(*_data(), epochs=3)
    events = json.load(open(path))["traceEvents"]
    assert len([e for e in events if e["cat"] == "train"]) == 3
    assert len([e for e in events if e["cat"] == "epoch"]) == 3
    assert all(e["ph"] == "X" and e["dur"] > 0 for e in events)
    with torch.no_grad():
        model.params["layer_0"]["W"].fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="NaN panic"):
        model.fit(*_data(), epochs=1)


def test_device_trace_writes_chrome_trace(tmp_path):
    with tui.device_trace(str(tmp_path / "prof")):
        torch.ones(8).add_(1.0)
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert "traceEvents" in trace


def test_enable_debug_nans_forward_and_backward():
    x = torch.tensor([1.0, -1.0], requires_grad=True)
    z = torch.zeros(1, requires_grad=True)
    tui.enable_debug_nans()
    try:
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.sqrt(x)
        y = torch.sqrt(z) * 0.0       # forward is finite: 0 * 0
        with pytest.raises(FloatingPointError, match="nan"):
            y.sum().backward()          # sqrt's backward divides by 2 * sqrt(0)
        assert torch.isfinite(torch.sqrt(x[:1])).all()
    finally:
        tui.enable_debug_nans(False)
    assert torch.isnan(torch.sqrt(x)).any()  # off again: no raise
