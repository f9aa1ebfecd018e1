"""The port's StepProfiler (``deeplearning4j_tpu_torch/obs/step_profiler.py``)
and its Solver/GraphSolver wiring: the JAX package's
``tests/test_step_profiler.py`` cases against the port (phases land in the
registry, the breakdown sums to 1, the batch-list fast path is bypassed,
sampled fencing controls which steps pay a device sync), then the port's
own: the profiled scores and parameters are bitwise those of a run
without a profiler, in both solvers, and the fence is a no-op on the CPU."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.obs import MetricsRegistry, StepProfiler
from deeplearning4j_tpu_torch.obs.step_profiler import PHASES
from deeplearning4j_tpu_torch.train.solver import Solver


def _model(seed=5):
    conf = (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(DenseLayer(n_in=4, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=3))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def test_phase_recording_and_stats():
    reg = MetricsRegistry()
    prof = StepProfiler(sync_every=1, registry=reg, name="p")
    prof.begin_step()
    prof.record("data_wait", 0.010)
    prof.record("h2d", 0.005, sampled=True)
    prof.record("compute", 0.080, sampled=True)
    prof.record("host", 0.005)
    prof.end_step()
    s = prof.stats()
    assert s["steps"] == 1 and s["sampled_steps"] == 1
    assert s["per_step_ms"]["compute"] == pytest.approx(80.0)
    assert s["share"]["compute"] == pytest.approx(0.8, abs=1e-3)
    assert s["input_bound_share"] == pytest.approx(0.15, abs=1e-3)
    assert sum(s["share"].values()) == pytest.approx(1.0, abs=1e-3)
    # histogram children exist per phase
    fam = reg.get("dl4j_tpu_training_step_phase_seconds")
    assert fam is not None
    for p in PHASES:
        assert fam.labels("p", p).count == 1


def test_unknown_phase_and_bad_sync_every():
    prof = StepProfiler(registry=MetricsRegistry())
    with pytest.raises(ValueError):
        prof.phase("gpu")
    with pytest.raises(ValueError):
        StepProfiler(sync_every=-1, registry=MetricsRegistry())


def test_sampling_schedule():
    prof = StepProfiler(sync_every=3, registry=MetricsRegistry())
    fenced = []
    for _ in range(9):
        fenced.append(prof.begin_step())
        prof.end_step()
    assert fenced == [True, False, False] * 3
    assert prof.sampled_steps == 3
    # sync_every=0 never fences
    prof0 = StepProfiler(sync_every=0, registry=MetricsRegistry())
    assert prof0.begin_step() is False
    assert prof0.stats()["fenced"] is False


def test_wrap_iterator_attributes_data_wait():
    reg = MetricsRegistry()
    prof = StepProfiler(registry=reg)
    x, y = _data(32)
    it = prof.wrap_iterator(ListDataSetIterator(DataSet(x, y), 8))
    seen = 0
    while it.has_next():
        it.next()
        seen += 1
    assert seen == 4
    assert prof._counts["data_wait"] == 4
    assert it.batch_size() == 8
    it.reset()
    assert it.has_next()


def test_wrap_plain_iterable():
    prof = StepProfiler(registry=MetricsRegistry())
    out = list(prof.wrap_iterator([1, 2, 3]))
    assert out == [1, 2, 3]
    assert prof._counts["data_wait"] == 3  # StopIteration not attributed


def test_solver_fit_with_profiler_per_step_attribution():
    reg = MetricsRegistry()
    prof = StepProfiler(sync_every=2, registry=reg)
    solver = Solver(_model(), profiler=prof)
    x, y = _data(64)
    it = prof.wrap_iterator(ListDataSetIterator(DataSet(x, y), 8))
    solver.fit(it, epochs=2)
    s = prof.stats()
    # the scan fast path would leave steps == 0; the profiler must force
    # per-step boundaries (8 batches x 2 epochs)
    assert s["steps"] == 16
    assert s["sampled_steps"] == 8
    assert s["seconds_total"]["data_wait"] > 0
    assert s["seconds_total"]["compute"] > 0
    assert s["seconds_total"]["host"] > 0
    assert s["step_time_ms_est"] > 0
    assert sum(s["share"].values()) == pytest.approx(1.0, abs=1e-3)


def test_solver_without_profiler_unchanged():
    solver = Solver(_model())
    assert solver.profiler is None
    x, y = _data(32)
    solver.fit(ListDataSetIterator(DataSet(x, y), 8), epochs=1)
    assert solver.model.iteration_count == 4  # scan fast path still taken


def test_graph_solver_with_profiler():
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver

    conf = (NeuralNetConfiguration.builder().seed(7)
            .graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_in=4, n_out=8), "in")
            .add_layer("out", OutputLayer(n_in=8, n_out=3), "d")
            .set_outputs("out")
            .build())
    model = ComputationGraph(conf, device="cpu").init()
    reg = MetricsRegistry()
    prof = StepProfiler(sync_every=1, registry=reg)
    solver = GraphSolver(model, profiler=prof)
    x, y = _data(32)
    batches = [DataSet(x[i:i + 8], y[i:i + 8]) for i in range(0, 32, 8)]
    solver.fit(batches, epochs=1)
    s = prof.stats()
    assert s["steps"] == 4
    assert s["sampled_steps"] == 4
    assert s["seconds_total"]["compute"] > 0


def test_async_iterator_fetch_wait_metrics():
    """Satellite: AsyncDataSetIterator stats on /metrics — capacity gauge
    and per-dequeue wait histogram next to the existing depth/starvation
    series."""
    from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator

    reg = MetricsRegistry()
    x, y = _data(32)
    it = AsyncDataSetIterator(ListDataSetIterator(DataSet(x, y), 8),
                              queue_size=2, registry=reg, name="adsi")
    n = 0
    while it.has_next():
        it.next()
        n += 1
    it.close()
    assert n == 4
    s = it.stats()
    assert s["queue_capacity"] == 2
    assert s["fetches"] >= 4
    assert "mean_fetch_wait_s" in s
    text = reg.render()
    assert 'dl4j_tpu_data_prefetch_queue_capacity{instance="adsi"} 2' in text
    assert "dl4j_tpu_data_fetch_wait_seconds_bucket" in text
    assert "dl4j_tpu_data_consumer_starvation_seconds_total" in text


def _graph(seed=7):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf = (NeuralNetConfiguration.builder().seed(seed)
            .graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_in=4, n_out=8), "in")
            .add_layer("out", OutputLayer(n_in=8, n_out=3), "d")
            .set_outputs("out")
            .build())
    return ComputationGraph(conf, device="cpu").init()


@pytest.mark.parametrize("sync_every", [0, 1, 3])
def test_solver_profiled_scores_are_bitwise_unprofiled(sync_every):
    x, y = _data(48)
    runs = []
    for prof in (None, StepProfiler(sync_every=sync_every, registry=MetricsRegistry())):
        solver = Solver(_model(), profiler=prof)
        scores = [float(solver.fit_batch(x[i:i + 8], y[i:i + 8])[0]) for i in range(0, 48, 8)]
        runs.append((scores, solver.model.params_flat()))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_graph_solver_profiled_scores_are_bitwise_unprofiled():
    from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver

    x, y = _data(32)
    runs = []
    for prof in (None, StepProfiler(sync_every=2, registry=MetricsRegistry())):
        solver = GraphSolver(_graph(), profiler=prof)
        scores = [float(solver.fit_batch((x[i:i + 8],), (y[i:i + 8],))) for i in range(0, 32, 8)]
        runs.append((scores, solver.model.params_flat()))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert prof.stats()["steps"] == 4 and prof.stats()["sampled_steps"] == 2


def test_fence_is_a_no_op_on_the_cpu(monkeypatch):
    from deeplearning4j_tpu_torch.obs.step_profiler import fence

    def boom(*a, **kw):
        raise AssertionError("synchronized a CUDA device for a CPU model")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    fence(torch.device("cpu"))
    prof = StepProfiler(sync_every=1, registry=MetricsRegistry())
    x, y = _data(16)
    Solver(_model(), profiler=prof).fit_batch(x[:8], y[:8])
    assert prof.stats()["sampled_steps"] == 1


def test_samples_per_sec_excl_input():
    prof = StepProfiler(sync_every=1, registry=MetricsRegistry())
    assert prof.samples_per_sec_excl_input(8) is None
    prof.begin_step()
    prof.record("data_wait", 0.5)
    prof.record("compute", 0.003, sampled=True)
    prof.record("host", 0.001, sampled=True)
    prof.end_step()
    assert prof.samples_per_sec_excl_input(8) == pytest.approx(8 / 0.004)
