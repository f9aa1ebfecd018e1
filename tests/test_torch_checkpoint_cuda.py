"""Checkpoints, exact resume and the step profiler on the card. These tests
need a CUDA device and skip without one: a snapshot that has landed on the
host when it returns, a resume that is bitwise on the card (the kernels and the
step are deterministic), and ``DL4J_TPU_HELPERS=0`` leaving the attention
kernels in place."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.core.env import get_environment
from deeplearning4j_tpu_torch.core.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.model import restore_model
from deeplearning4j_tpu_torch.model.zoo import TransformerLM
from deeplearning4j_tpu_torch.obs import MetricsRegistry, StepProfiler
from deeplearning4j_tpu_torch.train import CheckpointListener, Solver, restore_training_state

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device-to-host snapshots and the kernels "
                    "exist only on the card")


def _lm():
    return TransformerLM(vocab_size=97, hidden=64, n_layers=2, n_heads=4, max_len=64,
                         seed=3).init(device="cuda")


def _iterator(batches=6):
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 97, (4 * batches, 33))
    return ListDataSetIterator(DataSet(ids[:, :-1], ids[:, 1:]), 4, shuffle=True, seed=2)


def _train_to(model, it, total):
    solver = model._trainer if model._trainer is not None else Solver(model)
    model._trainer = solver
    while model.iteration_count < total:
        solver.fit_iterator(it, epochs=1)


def test_snapshot_has_landed_when_it_returns(tmp_path):
    m = _lm()
    it = _iterator()
    _train_to(m, it, 1)
    ck = CheckpointListener(str(tmp_path), save_every_n_iterations=1, registry=MetricsRegistry())
    want = m.params["layer_2"]["Wq"].detach().cpu()
    torch.cuda._sleep(50_000_000)  # hold the stream: the copy must wait behind it
    job = ck._snapshot(m, 1, 0)
    w = job["model"].params["layer_2"]["Wq"]
    assert w.device.type == "cpu"
    with torch.no_grad():
        m.params["layer_2"]["Wq"].add_(1.0)  # in place, after the snapshot
    assert torch.equal(w, want)
    assert ck._write(job, "sync")


def test_a_step_is_bitwise_deterministic_on_the_card():
    runs = []
    for _ in range(2):
        m = _lm()
        s = CollectScoresListener()
        m.add_listeners(s)
        _train_to(m, _iterator(), 3)
        runs.append((s.scores, m.params_flat()))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_resume_on_the_card_is_bitwise(tmp_path):
    ref = _lm()
    rs = CollectScoresListener()
    ref.add_listeners(rs)
    _train_to(ref, _iterator(), 9)
    m = _lm()
    it = _iterator()
    ck = CheckpointListener(str(tmp_path), save_every_n_iterations=4, async_save=True,
                            iterator=it, registry=MetricsRegistry())
    m.add_listeners(ck)
    _train_to(m, it, 9)
    ck.close()
    np.testing.assert_array_equal(m.params_flat(), ref.params_flat())
    r = restore_model(str(tmp_path / "checkpoint_iter4_epoch0.zip"), load_updater=True)
    assert r.device.type == "cuda"
    it2 = _iterator()
    import json

    with open(tmp_path / "checkpoint_iter4_epoch0.state.json") as f:
        restore_training_state(r, json.load(f), iterator=it2)
    scores = CollectScoresListener()
    r.add_listeners(scores)
    _train_to(r, it2, 9)
    assert scores.scores == rs.scores[4:]
    np.testing.assert_array_equal(r.params_flat(), ref.params_flat())


def test_profiled_steps_equal_unprofiled_on_the_card():
    runs = []
    prof = StepProfiler(sync_every=2, registry=MetricsRegistry())
    for p in (prof, None):
        m = _lm()
        s = CollectScoresListener()
        m.add_listeners(s)
        Solver(m, profiler=p).fit(p.wrap_iterator(_iterator()) if p else _iterator())
        runs.append(s.scores)
    assert runs[0] == runs[1]
    assert prof.stats()["sampled_steps"] == 3 and prof.stats()["per_step_ms"]["compute"] > 0


def test_helper_switch_keeps_the_kernels(monkeypatch):
    monkeypatch.setattr(get_environment(), "allow_helpers", False)
    q = torch.randn(1, 2, 64, 32, device="cuda")
    ops.reset_launch_counts()
    ops.flash_attention(q, q, q, causal=True)
    assert ops.LAUNCH_COUNTS["flash_forward"] == 1
