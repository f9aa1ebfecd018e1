"""Training parity between the JAX package and its PyTorch port: model
gradients and Adam steps from one JAX-written zip, the 13 updaters' math
against their optax chains, the schedules, gradient normalization, updater
state carried through the model zip both ways, and the port's gradient
check.

Tolerances (float32 unless stated), each from the arithmetic compared:
* gradients of the LM: rtol 1e-4 with atol 1e-6 — the same float32
  products and sums through four layers and their backward, in another
  order (XLA's fusions against eager PyTorch, block-wise flash sums against
  a materialised row).
* parameters after Adam steps (lr 1e-3): atol 2e-6 — each step moves a
  parameter by at most ~lr, and the update m/(sqrt(v)+eps) is insensitive
  to a gradient's last bits unless the gradient is within rounding of 0.
* updater trajectories on seeded arrays: rtol 1e-5, atol 1e-6 — elementwise
  float32 math, with bias corrections computed in float64 on the host (the
  JAX side computes them in the weak type, float64 under the tests' x64).
* schedules: rtol 1e-12 — both sides compute in float64.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.model.serializer import restore_multi_layer_network as jax_restore
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo.transformer_lm import TransformerLM as JaxLM
from deeplearning4j_tpu.nn.conf import GradientNormalization as JaxGN
from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu.train.solver import _normalize_gradients as jax_normalize

from deeplearning4j_tpu_torch.core.config import from_json, to_json
from deeplearning4j_tpu_torch.core.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.model import restore_multi_layer_network, write_model
from deeplearning4j_tpu_torch.model.serializer import _state_leaves
from deeplearning4j_tpu_torch.model.zoo import TransformerLM as PortLM
from deeplearning4j_tpu_torch.nn.conf import GradientNormalization
from deeplearning4j_tpu_torch.train import Solver
from deeplearning4j_tpu_torch.train import schedules as psched
from deeplearning4j_tpu_torch.train import updaters as pupd
from deeplearning4j_tpu_torch.train.solver import _normalize_gradients
from deeplearning4j_tpu_torch.utils import check_gradients

jfa = importlib.import_module("deeplearning4j_tpu.ops.flash_attention")
pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

_SHAPE = dict(vocab_size=40, hidden=16, n_heads=2, max_len=32)


@pytest.fixture(autouse=True)
def _restore_impls():
    yield
    jfa.set_attention_impl("auto")
    pfa.set_attention_impl("auto")


def _batch(seed=0, b=3, t=12):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, _SHAPE["vocab_size"], (b, t)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    mask = np.ones((b, t), np.float32)
    mask[1, 9:] = 0.0
    mask[2, 4:] = 0.0
    return ids, labels, mask


def _jax_lm(tmp_path, updater=None, seed=7):
    model = JaxLM(n_layers=2, seed=seed, updater=updater or jupd.Adam(1e-3), **_SHAPE).init()
    path = str(tmp_path / "lm.zip")
    jax_write(model, path)
    return model, path


def _assert_params_close(port, jax_params, atol, rtol=0.0):
    for lname, lparams in jax_params.items():
        for pname, arr in lparams.items():
            np.testing.assert_allclose(
                port.params[lname][pname].detach().numpy(), np.asarray(arr),
                atol=atol, rtol=rtol, err_msg=f"{lname}.{pname}")


# ---- model gradients and Adam steps from one JAX zip ------------------------


@pytest.mark.parametrize("jax_impl,port_impl", [("xla", "reference"), ("flash", "auto")])
def test_calculate_gradients_match_jax(tmp_path, jax_impl, port_impl):
    jmodel, path = _jax_lm(tmp_path)
    port = restore_multi_layer_network(path, device="cpu")
    ids, labels, mask = _batch()
    jfa.set_attention_impl(jax_impl)
    pfa.set_attention_impl(port_impl)
    # what the JAX model's calculate_gradients computes, compiled once
    jgrad = jax.jit(jax.grad(lambda p, mk: jmodel.loss_pure(
        p, jmodel.state, jnp.asarray(ids), jnp.asarray(labels), rng=None, mask=mk,
        train=True)[0]))
    for mk in (None, mask):
        jg = jgrad(jmodel.params, None if mk is None else jnp.asarray(mk))
        pg = port.calculate_gradients(ids, labels, mask=mk)
        assert set(pg) == set(jg)
        for lname, lg in jg.items():
            assert set(pg[lname]) == set(lg)
            for pname, arr in lg.items():
                np.testing.assert_allclose(pg[lname][pname].numpy(), np.asarray(arr),
                                           rtol=1e-4, atol=1e-6, err_msg=f"{lname}.{pname}")


def test_three_adam_fit_steps_match_jax(tmp_path):
    jmodel, path = _jax_lm(tmp_path)
    port = restore_multi_layer_network(path, device="cpu")
    ids, labels, _ = _batch(seed=1)
    scores = CollectScoresListener()
    port.add_listeners(scores)
    for _ in range(3):
        jmodel.fit(ids, labels)
        port.fit(ids, labels)
    _assert_params_close(port, jmodel.params, atol=2e-6)
    assert port.iteration_count == 3 and port.epoch_count == 3
    assert scores.iterations == [1, 2, 3]
    assert scores.scores[-1] < scores.scores[0]
    np.testing.assert_allclose(port.score_value, scores.scores[-1])


# ---- the updaters' math against their optax chains --------------------------


def _updater_cases():
    cases = [(c.__name__, {}) for c in jupd.registered_updaters()]
    cases.append(("Adam", {"learning_rate": ("ExponentialSchedule", {"gamma": 0.9,
                                                                     "initial_value": 1e-2})}))
    cases.append(("Lamb", {"weight_decay": 0.01}))
    cases.append(("Lars", {"weight_decay": 0.01}))
    return cases


def _build(module, sched_module, name, kwargs):
    kw = dict(kwargs)
    if isinstance(kw.get("learning_rate"), tuple):
        sname, skw = kw["learning_rate"]
        kw["learning_rate"] = getattr(sched_module, sname)(**skw)
    return getattr(module, name)(**kw)


def test_every_updater_is_ported():
    assert ([c.__name__ for c in pupd.registered_updaters()]
            == [c.__name__ for c in jupd.registered_updaters()])


@pytest.mark.parametrize("name,kwargs", _updater_cases(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_updater_matches_optax(name, kwargs):
    rs = np.random.RandomState(len(name))
    params = {"W": rs.randn(4, 3).astype(np.float32), "b": rs.randn(3).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    jtx = _build(jupd, jsched, name, kwargs).to_optax()
    ptx = _build(pupd, psched, name, kwargs).to_transform()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jtx.init(jp), ptx.init(pp)
    for g in grads:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        with torch.no_grad():
            pu, ps = ptx.update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
            pupd.apply_updates(pp, pu)
        for k in params:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}.{k}")
    # the state keeps optax's fields and order: the same leaves, one by one
    jl = jax.tree_util.tree_leaves(js)
    pl = _state_leaves(ps)
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


# ---- schedules ----------------------------------------------------------------


_SCHEDULES = [
    ("FixedSchedule", {"value": 0.3}),
    ("StepSchedule", {"initial_value": 0.1, "decay_rate": 0.7, "step": 3.0}),
    ("StepSchedule", {"schedule_type": "EPOCH", "initial_value": 0.1, "step": 2.0}),
    ("ExponentialSchedule", {"initial_value": 0.2, "gamma": 0.97}),
    ("InverseSchedule", {"initial_value": 0.2, "gamma": 0.3, "power": 1.5}),
    ("PolySchedule", {"initial_value": 0.2, "power": 2.0, "max_iter": 40}),
    ("SigmoidSchedule", {"initial_value": 0.2, "gamma": 0.1, "step_size": 20}),
    ("MapSchedule", {"values": {"0": 0.5, "10": 0.25, "30": 0.125}}),
    ("CycleSchedule", {"initial_value": 1e-3, "max_value": 1e-1, "cycle_length": 20,
                       "annealing_cycles": 2}),
    ("RampSchedule", {"underlying": ("ExponentialSchedule", {"gamma": 0.9}),
                      "num_iterations": 10}),
    ("WarmupSchedule", {"base": ("StepSchedule", {"initial_value": 0.1, "step": 5.0}),
                        "warmup_iterations": 8}),
    ("WarmupSchedule", {"warmup_iterations": 8, "base_value": 0.4}),
]


def _schedule(module, name, kwargs):
    kw = {}
    for k, v in kwargs.items():
        if isinstance(v, tuple):
            v = _schedule(module, *v)
        elif k == "schedule_type":
            v = module.ScheduleType[v]
        kw[k] = v
    return getattr(module, name)(**kw)


@pytest.mark.parametrize("name,kwargs", _SCHEDULES, ids=lambda x: x if isinstance(x, str) else "")
def test_schedule_matches_jax(name, kwargs):
    js, ps = _schedule(jsched, name, kwargs), _schedule(psched, name, kwargs)
    for it in (0, 1, 2, 5, 9, 10, 11, 29, 30, 39, 40, 41, 100):
        for ep in (0, 3):
            np.testing.assert_allclose(ps.value_at(it, ep), float(js.value_at(it, ep)),
                                       rtol=1e-12, err_msg=f"{name} at ({it}, {ep})")


def test_jax_config_with_a_schedule_learning_rate_decodes():
    lr = jsched.WarmupSchedule(base=jsched.StepSchedule(
        schedule_type=jsched.ScheduleType.EPOCH, initial_value=0.1, step=5.0),
        warmup_iterations=8)
    text = jax_to_json(JaxLM(n_layers=1, updater=jupd.AdamW(learning_rate=lr),
                             **_SHAPE).conf())
    conf = from_json(text)
    updater = conf.updater
    assert isinstance(updater, pupd.AdamW)
    assert isinstance(updater.learning_rate, psched.WarmupSchedule)
    assert updater.learning_rate.base.schedule_type is psched.ScheduleType.EPOCH
    assert to_json(conf) == text
    np.testing.assert_allclose(updater.learning_rate.value_at(3, 7),
                               float(lr.value_at(3, 7)), rtol=1e-12)


# ---- gradient normalization -----------------------------------------------------


@pytest.mark.parametrize("mode", list(GradientNormalization), ids=lambda m: m.name)
def test_gradient_normalization_matches_jax(mode):
    rs = np.random.RandomState(3)
    grads = {"layer_0": {"W": 3 * rs.randn(4, 3), "b": rs.randn(3)},
             "layer_1": {},
             "layer_2": {"W": 0.01 * rs.randn(5, 2)}}
    grads = {l: {k: v.astype(np.float32) for k, v in lg.items()} for l, lg in grads.items()}
    j = jax_normalize(jax.tree_util.tree_map(jnp.asarray, grads), JaxGN[mode.name], 0.5)
    p = _normalize_gradients({l: {k: torch.from_numpy(v) for k, v in lg.items()}
                              for l, lg in grads.items()}, mode, 0.5)
    assert set(p) == set(j)
    for lname, lg in j.items():
        assert set(p[lname]) == set(lg)
        for k, arr in lg.items():
            np.testing.assert_allclose(p[lname][k].numpy(), np.asarray(arr), rtol=1e-6,
                                       atol=1e-7)


# ---- updater state through the model zip ------------------------------------------


_ZIP_UPDATERS = [
    ("Adam", {"learning_rate": 1e-3}),
    ("AdamW", {"learning_rate": ("ExponentialSchedule", {"initial_value": 1e-3,
                                                          "gamma": 0.8})}),
]


@pytest.mark.parametrize("name,kwargs", _ZIP_UPDATERS, ids=[n for n, _ in _ZIP_UPDATERS])
def test_jax_updater_state_resumes_in_the_port(tmp_path, name, kwargs):
    jmodel, _ = _jax_lm(tmp_path, _build(jupd, jsched, name, kwargs))
    ids, labels, _ = _batch(seed=2)
    for _ in range(2):
        jmodel.fit(ids, labels)
    path = str(tmp_path / "trained.zip")
    jax_write(jmodel, path, save_updater=True)
    port = restore_multi_layer_network(path, device="cpu", load_updater=True)
    jmodel.fit(ids, labels)
    port.fit(ids, labels)  # the restored Solver carries the updater state
    _assert_params_close(port, jmodel.params, atol=2e-6)


@pytest.mark.parametrize("name,kwargs", _ZIP_UPDATERS, ids=[n for n, _ in _ZIP_UPDATERS])
def test_port_updater_state_resumes_in_jax(tmp_path, name, kwargs):
    _, path = _jax_lm(tmp_path, _build(jupd, jsched, name, kwargs))
    port = restore_multi_layer_network(path, device="cpu")
    ids, labels, _ = _batch(seed=3)
    for _ in range(2):
        port.fit(ids, labels)
    out = str(tmp_path / "trained.zip")
    write_model(port, out, save_updater=True)
    jmodel = jax_restore(out, load_updater=True)
    jmodel._trainer.fit_batch(ids, labels)
    port.fit(ids, labels)
    _assert_params_close(port, jmodel.params, atol=2e-6)


def test_other_updater_state_is_not_carried(tmp_path):
    # The name is from when only Adam and AdamW state went into the zip.
    # Every updater's state is carried now (tests/test_torch_updater_state.py
    # holds all 13 against JAX): the char-RNN's RmsProp comes back leaf for
    # leaf, and the restored model's next step is the original's.
    port = PortLM(n_layers=1, updater=pupd.RmsProp(), **_SHAPE).init(device="cpu")
    ids, labels, _ = _batch()
    port.fit(ids, labels)
    path = str(tmp_path / "m.zip")
    write_model(port, path, save_updater=True)
    back = restore_multi_layer_network(path, device="cpu", load_updater=True)
    want, got = _state_leaves(port._trainer.opt_state), _state_leaves(back._trainer.opt_state)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    port.fit(ids, labels)
    back.fit(ids, labels)
    np.testing.assert_array_equal(back.params_flat(), port.params_flat())


# ---- gradient check, and what is not ported yet ----------------------------------------


def test_check_gradients_passes_on_a_float64_lm():
    model = PortLM(n_layers=1, seed=4, dtype="float64", **_SHAPE).init(device="cpu")
    ids, labels, mask = _batch(seed=4, t=6)
    assert check_gradients(model, ids, labels, mask=mask, subset=150)
    # a wrong analytic gradient is caught
    bad = model.calculate_gradients

    def off_by_one_percent(*a, **kw):
        g = bad(*a, **kw)
        g["layer_2"]["Wq"] = g["layer_2"]["Wq"] * 1.01
        return g

    model.calculate_gradients = off_by_one_percent
    assert not check_gradients(model, ids, labels, subset=300, seed=1)


def test_unported_solver_options_raise():
    # Both options are ported now. optimize= resolves as JAX's does: on an
    # LM no training pass matches, and an inference-only pipeline is
    # refused in a training context with JAX's error. profiler= takes a
    # StepProfiler (obs/step_profiler.py; tests/test_torch_step_profiler.py)
    # and leaves the step's result unchanged.
    model = PortLM(n_layers=1, **_SHAPE).init(device="cpu")
    jmodel = JaxLM(n_layers=1, **_SHAPE).init()
    from deeplearning4j_tpu.train.solver import Solver as JaxSolver

    assert Solver(model, optimize=True).applied_rewrites == \
        JaxSolver(jmodel, optimize=True).applied_rewrites == []
    with pytest.raises(ValueError) as want:
        JaxSolver(jmodel, optimize="inference")
    with pytest.raises(ValueError) as got:
        Solver(model, optimize="inference")
    assert str(got.value) == str(want.value)
    from deeplearning4j_tpu_torch.obs import MetricsRegistry, StepProfiler

    ids, labels, _ = _batch()
    prof = StepProfiler(sync_every=1, registry=MetricsRegistry())
    plain = PortLM(n_layers=1, **_SHAPE).init(device="cpu")
    got_score, _ = Solver(model, profiler=prof).fit_batch(ids, labels)
    want_score, _ = Solver(plain).fit_batch(ids, labels)
    assert float(got_score) == float(want_score) and prof.stats()["steps"] == 1
