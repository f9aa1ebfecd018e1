"""The port's MoE slice against the JAX package on the same seeded inputs:
the dispatch plan (``ops/moe_dispatch.py``), ``MixtureOfExpertsLayer.apply``
in its three dispatch modes (outputs, the four state entries, gradients
with the aux load-balance term), the port's own gradient check, a
JAX-written model zip of a tiny MoE language model (output, score,
gradients, state), and Adam steps through ``Solver.fit_batch``.

Tolerances: integer plan arrays and token counts exactly; layer and network
values in float64 to 1e-10 (float64 sums in another order; in float64 no
gate can flip a route by rounding); network values in float64 to 1e-9
relative (two attention spellings and a vocab softmax in another order);
scores over Adam steps to 1e-9 (float64, same updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.model.serializer import restore_multi_layer_network as jax_restore
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import LossFunction as JLoss
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn import WeightInit as JWI
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops import make_dispatch_plan as jax_plan
from deeplearning4j_tpu.ops import top_k_routing as jax_top_k
from deeplearning4j_tpu.train.solver import Solver as JSolver
from deeplearning4j_tpu.train.updaters import Adam as JAdam
from deeplearning4j_tpu.train.updaters import Sgd as JSgd

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.core.config import from_json, to_json
from deeplearning4j_tpu_torch.model import restore_multi_layer_network, write_model
from deeplearning4j_tpu_torch.nn import (
    Activation, InputType, LossFunction, MultiLayerNetwork, NeuralNetConfiguration,
    WeightInit,
)
from deeplearning4j_tpu_torch.nn.layers import (
    MixtureOfExpertsLayer, OutputLayer, RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.train import Solver
from deeplearning4j_tpu_torch.train.updaters import Sgd
from deeplearning4j_tpu_torch.utils import check_gradients

MODES = ("sort", "grouped", "einsum")
STATE_KEYS = ("aux_load_balance", "expert_tokens", "dropped_tokens", "capacity_slots")


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the dispatch plan ---------------------------------------------------------------


def _assert_plan_equal(p, j):
    for field in ("buffer_idx", "keep", "slot_token", "expert_tokens", "dropped_tokens"):
        np.testing.assert_array_equal(getattr(p, field).numpy(), np.asarray(getattr(j, field)),
                                      err_msg=field)


def test_plan_fcfs_example():
    """Capacity 2: expert 0 sees t0 (round 0), t2 (round 0), t1 (round 1),
    so t1's round-1 assignment and t2's round-1 assignment overflow."""
    idx = np.asarray([[0, 1], [1, 0], [0, 1]], np.int32)
    p = ops.make_dispatch_plan(_t(idx), num_experts=2, capacity=2)
    _assert_plan_equal(p, jax_plan(jnp.asarray(idx), num_experts=2, capacity=2))
    np.testing.assert_array_equal(p.slot_token.numpy(), [0, 2, 1, 0])
    np.testing.assert_array_equal(p.keep.numpy(), [True, True, True, True, False, False])
    assert int(p.dropped_tokens) == 2


@pytest.mark.parametrize("capacity,masked", [(3, False), (3, True), (40, True), (1, False)])
def test_plan_matches_jax(capacity, masked):
    rs = np.random.RandomState(capacity + masked)
    idx = np.stack([rs.permutation(5)[:3] for _ in range(23)]).astype(np.int32)
    mask = (rs.rand(23) > 0.3).astype(np.float64) if masked else None
    p = ops.make_dispatch_plan(_t(idx), 5, capacity, None if mask is None else _t(mask))
    j = jax_plan(jnp.asarray(idx), 5, capacity, None if mask is None else jnp.asarray(mask))
    _assert_plan_equal(p, j)


def test_zero_router_ties_go_to_the_lower_index():
    """A zero router makes every gate 1/E: ``jax.lax.top_k`` takes the lowest
    indices first, and so must the port (``torch.topk`` promises no order)."""
    gates = np.full((6, 8), 1 / 8)
    pv, pi = ops.top_k_routing(_t(gates), 3)
    jv, ji = jax_top_k(jnp.asarray(gates), 3)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pi.numpy(), np.tile([0, 1, 2], (6, 1)))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


# ---- the layer: forward, state and gradients against JAX -----------------------------


def _layers(mode, *, k=2, cap=1.5, bl=0.0, e=4, d=8, h=16, o=8):
    kw = dict(n_in=d, n_out=o, num_experts=e, hidden=h, top_k=k, capacity_factor=cap,
              balance_loss_weight=bl, dispatch_mode=mode)
    port = MixtureOfExpertsLayer(activation=Activation.RELU, **kw)
    jax_layer = jl.MixtureOfExpertsLayer(activation=JAct.RELU, **kw)
    params = jax_layer.init(jax.random.PRNGKey(k * 10 + int(cap * 100)), jnp.float64)
    # expert biases start at 0: make them non-zero so their gathers are tested
    rs = np.random.RandomState(1)
    params = dict(params, be1=jnp.asarray(0.1 * rs.randn(e, h)),
                  be2=jnp.asarray(0.1 * rs.randn(e, o)))
    return port, jax_layer, params


# (name, input shape, k, capacity factor, ragged [b, t] mask)
_APPLY_CASES = {
    "ff": ((12, 8), 2, 1.5, False),
    "ff_k1_drops": ((12, 8), 1, 0.26, False),
    "ff_k4_drops": ((12, 8), 4, 0.26, False),
    "recurrent_masked": ((3, 8, 5), 2, 1.0, True),
    # a zero router: every gate 1/E, routes decided by the tie order alone
    "ff_zero_router": ((12, 8), 2, 0.5, False),
}


def _inputs(shape, masked):
    rs = np.random.RandomState(len(shape) + 3)
    x = rs.randn(*shape)
    mask = None
    if masked:
        mask = np.ones((shape[0], shape[2]))
        mask[1, 3:] = 0.0
        mask[2, 1:] = 0.0
    return x, mask


@pytest.mark.parametrize("case", list(_APPLY_CASES))
@pytest.mark.parametrize("mode", MODES)
def test_apply_matches_jax(mode, case):
    shape, k, cap, masked = _APPLY_CASES[case]
    port, jax_layer, params = _layers(mode, k=k, cap=cap)
    if case == "ff_zero_router":
        params = dict(params, Wg=jnp.zeros_like(params["Wg"]))
    x, mask = _inputs(shape, masked)
    jy, js = jax.jit(lambda p, xx, mk: jax_layer.apply(
        p, jax_layer.init_state(jnp.float64), xx, JCtx(mask=mk)))(
            params, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    pp = {n: _t(v) for n, v in params.items()}
    py, ps = port.apply(pp, port.init_state(torch.float64), _t(x),
                        LayerContext(mask=None if mask is None else _t(mask)))
    assert tuple(py.shape) == jy.shape
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-10)
    for key in STATE_KEYS:
        np.testing.assert_allclose(ps[key].numpy(), np.asarray(js[key]), rtol=1e-10,
                                   atol=1e-12, err_msg=key)
    assert ps["expert_tokens"].dtype == ps["dropped_tokens"].dtype == torch.float32
    if "drops" in case or case == "ff_zero_router":
        assert float(ps["dropped_tokens"]) > 0
    real = shape[0] if mask is None else mask.sum()
    assert float(ps["expert_tokens"].sum() + ps["dropped_tokens"]) == k * real


@pytest.mark.parametrize("mode", MODES)
def test_gradients_with_balance_loss_match_jax(mode):
    """d/d(params, x) of sum(y * w) + 0.5 * aux on masked recurrent input,
    against ``jax.grad`` of the same function."""
    port, jax_layer, params = _layers(mode, k=2, cap=1.0, bl=0.5)
    x, mask = _inputs((3, 8, 5), True)
    w = np.random.RandomState(4).randn(3, 8, 5)

    def jloss(p, xx):
        y, st = jax_layer.apply(p, jax_layer.init_state(jnp.float64), xx,
                                JCtx(mask=jnp.asarray(mask)))
        return jnp.sum(y * jnp.asarray(w)) + 0.5 * st["aux_load_balance"]

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    pp = {n: _t(v).requires_grad_() for n, v in params.items()}
    px = _t(x).requires_grad_()
    y, st = port.apply(pp, port.init_state(torch.float64), px, LayerContext(mask=_t(mask)))
    loss = torch.sum(y * _t(w)) + 0.5 * st["aux_load_balance"]
    names = sorted(pp)
    grads = torch.autograd.grad(loss, [pp[n] for n in names] + [px])
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), rtol=1e-10, atol=1e-10,
                                   err_msg=n)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), rtol=1e-10, atol=1e-10)


def test_modes_agree_with_each_other():
    x, mask = _inputs((3, 8, 5), True)
    got = {}
    for mode in MODES:
        port, _, params = _layers(mode, k=2, cap=0.8, bl=0.3)
        pp = {n: _t(v).requires_grad_() for n, v in params.items()}
        y, st = port.apply(pp, port.init_state(torch.float64), _t(x),
                           LayerContext(mask=_t(mask)))
        loss = torch.sum(y ** 2) + 0.3 * st["aux_load_balance"]
        got[mode] = [y.detach()] + list(torch.autograd.grad(loss, [pp[n] for n in sorted(pp)]))
    for mode in ("grouped", "einsum"):
        for a, b in zip(got["sort"], got[mode]):
            torch.testing.assert_close(b, a, rtol=1e-10, atol=1e-12)


def test_sliced_expert_params_raise_not_ported():
    port, _, params = _layers("sort")
    pp = {n: _t(v) for n, v in params.items()}
    pp["We1"] = pp["We1"][:2]
    with pytest.raises(NotImplementedError, match="A8"):
        port.apply(pp, port.init_state(torch.float64), torch.zeros(4, 8), LayerContext())


# ---- networks: config, gradient check, JAX zips, training ----------------------------


def _jax_ff_net(mode, bl, seed=9):
    conf = (JNNC.builder().seed(seed).data_type("float64").updater(JSgd(0.1))
            .weight_init(JWI.XAVIER).list()
            .layer(jl.MixtureOfExpertsLayer(n_out=6, num_experts=3, hidden=8, top_k=2,
                                            capacity_factor=1.0, balance_loss_weight=bl,
                                            activation=JAct.TANH, dispatch_mode=mode))
            .layer(jl.OutputLayer(n_out=2, loss=JLoss.MCXENT, activation=JAct.SOFTMAX))
            .set_input_type(JInputType.feed_forward(5)).build())
    return JNet(conf).init()


def _jax_score_and_grads(jnet, x, y, mask=None):
    """The score and ``{layer: {param: grad}}`` that the JAX network's
    ``score`` and ``calculate_gradients`` compute (no dropout here), from
    one compiled function."""
    def loss(p, xx, yy, mk):
        return jnet.loss_pure(p, jnet.state, xx, yy, rng=None, mask=mk, train=True)[0]

    return jax.jit(jax.value_and_grad(loss))(
        jnet.params, jnp.asarray(x), jnp.asarray(y), None if mask is None else jnp.asarray(mask))


@pytest.mark.parametrize("mode", MODES)
def test_feed_forward_net_gradients_with_balance_loss_match_jax(tmp_path, mode):
    """The JAX package's ``MoE -> OutputLayer`` gradient-check network with
    ``balance_loss_weight=0.5``, loaded from its zip: score and gradients."""
    jnet = _jax_ff_net(mode, 0.5)
    path = str(tmp_path / "ff.zip")
    jax_write(jnet, path)
    net = restore_multi_layer_network(path, device="cpu")
    assert net.layers[0] == from_json(jax_to_json(jnet.conf)).layers[0]
    rs = np.random.default_rng(10)
    x = rs.normal(size=(9, 5))
    y = np.eye(2)[np.arange(9) % 2]
    j_score, jg = _jax_score_and_grads(jnet, x, y)
    np.testing.assert_allclose(net.score(x, y), float(j_score), rtol=1e-12)
    pg = net.calculate_gradients(x, y)
    for lname, lg in jg.items():
        for pname, arr in lg.items():
            np.testing.assert_allclose(pg[lname][pname].numpy(), np.asarray(arr),
                                       rtol=1e-10, atol=1e-10, err_msg=f"{lname}.{pname}")


def test_check_gradients_on_the_sort_mode_net():
    conf = (NeuralNetConfiguration.builder().seed(7).data_type("float64")
            .updater(Sgd(0.1)).weight_init(WeightInit.XAVIER).list()
            .layer(MixtureOfExpertsLayer(n_out=6, num_experts=3, hidden=8, top_k=2,
                                         capacity_factor=4.0, activation=Activation.TANH,
                                         dispatch_mode="sort"))
            .layer(OutputLayer(n_out=2, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(5)).build())
    assert conf.layers[0].n_in == 5 and conf.layers[1].n_in == 6
    model = MultiLayerNetwork(conf, device="cpu").init()
    rs = np.random.default_rng(8)
    x = rs.normal(size=(6, 5))
    y = np.eye(2)[np.arange(6) % 2]
    assert check_gradients(model, x, y, subset=60)


def test_build_keeps_token_layers_and_refuses_missing_preprocessors():
    b = (NeuralNetConfiguration.builder().list()
         .layer(MixtureOfExpertsLayer(n_out=6, num_experts=2, hidden=4))
         .layer(RnnOutputLayer(n_out=3)).set_input_type(InputType.recurrent(5)))
    conf = b.build()  # MoE takes recurrent input as it is
    assert conf.layers[0].n_in == 5 and conf.layers[1].n_in == 6
    # a feed-forward output layer after recurrent input gets the
    # RnnToFeedForward preprocessor, as in the JAX package
    conf = (NeuralNetConfiguration.builder().list()
            .layer(MixtureOfExpertsLayer(n_out=6, num_experts=2, hidden=4))
            .layer(OutputLayer(n_out=3)).set_input_type(InputType.recurrent(5)).build())
    assert [type(l).__name__ for l in conf.layers] == [
        "MixtureOfExpertsLayer", "RnnToFeedForwardPreProcessor", "OutputLayer"]
    assert conf.layers[2].n_in == 6


_V, _T = 30, 10


def _jax_moe_lm(mode="grouped", seed=3):
    """A tiny version of the network ``chip_smoke.py`` runs at GPT-2 small's
    widths: embedding, positions, one decoder block, MoE, LayerNorm, head."""
    conf = (JNNC.builder().seed(seed).data_type("float64").updater(JAdam(1e-3))
            .weight_init(JWI.XAVIER).list()
            .layer(jl.EmbeddingSequenceLayer(n_in=_V, n_out=16))
            .layer(jl.PositionalEmbeddingLayer(n_out=16, max_len=16))
            .layer(jl.TransformerDecoderBlockLayer(n_in=16, n_heads=2, ffn_size=32))
            .layer(jl.MixtureOfExpertsLayer(n_in=16, n_out=16, num_experts=4, hidden=24,
                                            top_k=2, capacity_factor=1.25,
                                            activation=JAct.RELU, balance_loss_weight=0.01,
                                            dispatch_mode=mode))
            .layer(jl.LayerNormLayer(n_out=16))
            .layer(jl.RnnOutputLayer(n_in=16, n_out=_V, loss=JLoss.SPARSE_MCXENT,
                                     activation=JAct.SOFTMAX))
            .build())
    return JNet(conf).init()


def _lm_batch(seed=0, b=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, _V, (b, _T)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    mask = np.ones((b, _T))
    mask[1, 6:] = 0.0
    mask[2, 3:] = 0.0
    return ids, labels, mask


def _assert_state_equal(port_state, jax_state):
    for lname, st in jax_state.items():
        assert set(port_state[lname]) == set(st)
        for key, arr in st.items():
            np.testing.assert_allclose(port_state[lname][key].cpu().numpy(), np.asarray(arr),
                                       rtol=1e-10, atol=1e-12, err_msg=f"{lname}.{key}")


def test_jax_zip_of_a_moe_lm_loads(tmp_path):
    jnet = _jax_moe_lm()
    ids, labels, mask = _lm_batch()
    path = str(tmp_path / "moe_lm.zip")
    jax_write(jnet, path)
    net = restore_multi_layer_network(path, device="cpu")
    np.testing.assert_allclose(net.output(ids, mask).numpy(),
                               np.asarray(jnet.output(ids, mask)), rtol=1e-9, atol=1e-12)
    j_score, jg = _jax_score_and_grads(jnet, ids, labels, mask)
    np.testing.assert_allclose(net.score(ids, labels, mask), float(j_score), rtol=1e-9)
    pg = net.calculate_gradients(ids, labels, mask)
    for lname, lg in jg.items():
        for pname, arr in lg.items():
            np.testing.assert_allclose(pg[lname][pname].numpy(), np.asarray(arr), rtol=1e-9,
                                       atol=1e-11, err_msg=f"{lname}.{pname}")
    assert to_json(net.conf) == jax_to_json(jnet.conf)


def test_three_adam_steps_follow_the_jax_solver(tmp_path):
    jnet = _jax_moe_lm(seed=5)
    path = str(tmp_path / "moe_lm.zip")
    jax_write(jnet, path)
    net = restore_multi_layer_network(path, device="cpu")
    ids, labels, mask = _lm_batch(seed=1)
    js, ps = JSolver(jnet), Solver(net)
    for _ in range(3):
        j_score, _ = js.fit_batch(ids, labels, mask)
        p_score, _ = ps.fit_batch(ids, labels, mask)
        np.testing.assert_allclose(float(p_score), float(j_score), rtol=1e-9)
    _assert_state_equal(net.state, jnet.state)
    # the stored state holds values, not this step's graph
    assert all(not v.requires_grad for st in net.state.values() for v in st.values())
    for lname, lparams in jnet.params.items():
        for pname, arr in lparams.items():
            np.testing.assert_allclose(net.params[lname][pname].detach().numpy(),
                                       np.asarray(arr), rtol=1e-7, atol=1e-9,
                                       err_msg=f"{lname}.{pname}")
    # the zips carry the MoE state leaves both ways
    jax_write(jnet, path)
    _assert_state_equal(restore_multi_layer_network(path, device="cpu").state, jnet.state)
    out = str(tmp_path / "trained.zip")
    write_model(net, out)
    _assert_state_equal(net.state, jax_restore(out).state)
