"""The spine of the port against the JAX package: the public names of
``core``, ``ops``, ``nn``, ``obs`` and ``train``; ``Environment`` and its
variables; the op registry (register/get, helper gating, ``abstract_eval``
shapes on meta tensors against ``jax.eval_shape``); ``DataType`` and the
config dict round trip; and the ``MultiLayerNetwork`` methods ``summary``
(the same text), ``feed_forward`` (every activation to 1e-10 in float64),
``get_layer_params``, ``migrate_state`` and ``clone`` (a deep copy)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.core import config as jconfig
from deeplearning4j_tpu.core import dtypes as jdtypes
from deeplearning4j_tpu.core import env as jenv
from deeplearning4j_tpu.core import registry as jreg
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.nn import Activation as JAct
from deeplearning4j_tpu.nn import InputType as JIT
from deeplearning4j_tpu.nn import LossFunction as JLoss
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JBN
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.train.updaters import Adam as JAdam

from deeplearning4j_tpu_torch.core import config as pconfig
from deeplearning4j_tpu_torch.core import dtypes as pdtypes
from deeplearning4j_tpu_torch.core import env as penv
from deeplearning4j_tpu_torch.core import registry as preg
from deeplearning4j_tpu_torch.model import restore_multi_layer_network

TOL = 1e-10

# names the JAX package exports that the port leaves for distributed
# training (ROADMAP A8): the orbax checkpointer and its module
LEFT_FOR_LATER = {"OrbaxCheckpointer", "orbax_checkpoint"}


@pytest.mark.parametrize("pkg", ["core", "ops", "nn", "obs", "train"])
def test_port_exports_every_jax_name(pkg):
    jmod = importlib.import_module(f"deeplearning4j_tpu.{pkg}")
    pmod = importlib.import_module(f"deeplearning4j_tpu_torch.{pkg}")
    missing = set(jmod.__all__) - set(pmod.__all__) - LEFT_FOR_LATER
    assert not missing, f"{pkg} lacks {sorted(missing)}"
    assert [n for n in pmod.__all__ if not hasattr(pmod, n)] == []


def test_sequential_alias_and_helpers():
    from deeplearning4j_tpu_torch import nn, ops

    assert nn.Sequential is nn.MultiLayerNetwork
    assert ops.helper_name("conv2d") in ops.available_helpers("conv2d")
    assert ops.grouped_matmul_reference is ops.grouped_matmul_plain


# ---- core/env.py -------------------------------------------------------------


_ENVS = [{}, {"DL4J_TPU_DEBUG": "1", "DL4J_TPU_HELPERS": "0", "DL4J_TPU_DTYPE": "float64"},
         {"DL4J_TPU_VERBOSE": "true", "DL4J_TPU_NAN_PANIC": "False", "DL4J_TPU_LOG_INIT": "0",
          "DL4J_TPU_DETERMINISTIC": "1", "DL4J_TPU_PROFILING": ""}]


@pytest.mark.parametrize("env", _ENVS, ids=["defaults", "set", "spellings"])
def test_environment_reads_the_variables_as_jax_does(monkeypatch, env):
    for name in jenv.ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert penv.ENV_VARS == jenv.ENV_VARS
    j, p = jenv.Environment(), penv.Environment()
    assert vars(p) == vars(j)


def test_environment_singleton_and_x64():
    e = penv.get_environment()
    assert e is penv.get_environment() is penv.Environment.instance()
    saved = (e.default_dtype, torch.get_default_dtype())
    try:
        e.enable_x64(True)
        assert pdtypes.default_float_dtype() == torch.float64
        assert torch.get_default_dtype() == torch.float64
        e.enable_x64(False)
        assert pdtypes.default_float_dtype() == torch.float32
    finally:
        e.default_dtype = saved[0]
        torch.set_default_dtype(saved[1])


# ---- core/registry.py --------------------------------------------------------


def _matmul_sum_j(a, b):
    return {"prod": a @ b, "total": jnp.sum(a, axis=0)}


def _matmul_sum_p(a, b):
    return {"prod": a @ b, "total": torch.sum(a, dim=0)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_abstract_eval_shapes_match_jax(dtype):
    a = np.zeros((3, 5), dtype)
    b = np.zeros((5, 2), dtype)
    jout = jreg.OpDef("mm", _matmul_sum_j).abstract_eval(a, b)
    pout = preg.OpDef("mm", _matmul_sum_p).abstract_eval(a, b)
    assert set(pout) == set(jout)
    for k in jout:
        assert pout[k].shape == tuple(jout[k].shape)
        assert str(pout[k].dtype) == f"torch.{jout[k].dtype}"
    # shape/dtype structs in, and nothing ran: meta tensors carry no data
    s = preg.ShapeDtypeStruct((7, 5), torch.float32)
    assert preg.OpDef("mm", _matmul_sum_p).abstract_eval(s, b.astype(np.float32))[
        "prod"].shape == (7, 2)


def test_registry_register_get_and_helper_gating(monkeypatch):
    for mod in (jreg, preg):
        reg = mod.OpRegistry()
        op = reg.register(mod.OpDef("twice", lambda x: 2 * x, helper=lambda x: 3 * x,
                                    namespace="math"))
        assert reg.get("twice") is op and reg.has("twice") and not reg.has("thrice")
        assert reg.names() == ["twice"] and reg.names("math") == ["twice"]
        assert reg.names("nn") == []
        with pytest.raises(ValueError, match="Op already registered: twice"):
            reg.register(mod.OpDef("twice", lambda x: x))
        with pytest.raises(KeyError, match="Unknown op 'thrice'"):
            reg.get("thrice")
    env = penv.get_environment()
    op = preg.OpDef("twice", lambda x: 2 * x, helper=lambda x: 3 * x)
    monkeypatch.setattr(env, "allow_helpers", True)
    assert op(2) == 6  # the helper, as in the JAX package
    monkeypatch.setattr(env, "allow_helpers", False)
    assert op(2) == 4  # DL4J_TPU_HELPERS=0: the plain fn


def test_register_op_decorator_and_get_op():
    @preg.register_op("spine_test_negate", namespace="spine")
    def negate(x):
        """negation"""
        return -x

    assert preg.get_op("spine_test_negate") is negate
    assert negate.doc == "negation" and negate(torch.ones(2)).tolist() == [-1.0, -1.0]
    assert "spine_test_negate" in preg.OpRegistry.instance().names("spine")


def test_helper_switch_does_not_reroute_the_kernels(monkeypatch):
    """DL4J_TPU_HELPERS gates only an OpDef's helper: the attention and
    grouped-matmul seams keep their impl (on the card their CUDA tensors
    launch the kernels or raise; tests/test_torch_checkpoint_cuda.py)."""
    from deeplearning4j_tpu_torch import ops

    before = (ops.attention_impl(), ops.grouped_matmul_impl())
    monkeypatch.setenv("DL4J_TPU_HELPERS", "0")
    monkeypatch.setattr(penv.get_environment(), "allow_helpers", False)
    assert (ops.attention_impl(), ops.grouped_matmul_impl()) == before
    src = open(ops.flash_attention.__code__.co_filename).read()
    assert "allow_helpers" not in src and "get_environment" not in src


# ---- core/dtypes.py, core/config.py --------------------------------------------


def test_datatype_matches_jax():
    assert [(m.name, m.value) for m in pdtypes.DataType] == \
        [(m.name, m.value) for m in jdtypes.DataType]
    for jm, pm in zip(jdtypes.DataType, pdtypes.DataType):
        assert (pm.is_floating, pm.is_integer) == (jm.is_floating, jm.is_integer)
        if pm not in (pdtypes.DataType.BFLOAT16, pdtypes.DataType.UTF8):
            assert pm.np == jm.np and pm.torch == getattr(torch, pm.value)
    assert pdtypes.DataType.BFLOAT16.torch == torch.bfloat16
    with pytest.raises(ValueError, match="host-only"):
        pdtypes.DataType.UTF8.torch
    for spelling in ("float32", "FLOAT", "int8", "bfloat16", np.float64, np.dtype("uint8"),
                     torch.int64, torch.bfloat16, pdtypes.DataType.HALF):
        want = jdtypes.DataType.from_any(
            str(spelling).replace("torch.", "") if isinstance(spelling, torch.dtype)
            else spelling if not isinstance(spelling, pdtypes.DataType) else spelling.value)
        assert pdtypes.DataType.from_any(spelling).name == want.name
    with pytest.raises(ValueError, match="Unknown dtype"):
        pdtypes.DataType.from_any("float7")


def _jax_net(bn=False, seed=6):
    b = (JNNC.builder().seed(seed).data_type("float64").updater(JAdam(1e-2)).list()
         .layer(JDense(n_out=7, activation=JAct.TANH)))
    if bn:
        b = b.layer(JBN())
    b = (b.layer(JDense(n_out=5, activation=JAct.RELU))
         .layer(JOut(n_out=3, loss=JLoss.MCXENT, activation=JAct.SOFTMAX))
         .set_input_type(JIT.feed_forward(4)))
    return JaxMLN(b.build()).init()


def test_config_dict_round_trip_and_replace():
    jconf = _jax_net().conf
    d = jconfig.to_dict(jconf)
    pconf = pconfig.from_dict(d)
    assert pconfig.to_dict(pconf) == d
    assert pconfig.to_json(pconf) == jconfig.to_json(jconf)
    changed = pconfig.replace(pconf, seed=99)
    assert changed.seed == 99 and pconf.seed == 6
    assert pconfig.to_dict(changed) == jconfig.to_dict(jconfig.replace(jconf, seed=99))


# ---- MultiLayerNetwork methods -------------------------------------------------


def _pair(tmp_path, bn=False):
    jm = _jax_net(bn=bn)
    path = str(tmp_path / "m.zip")
    jax_write(jm, path)
    return jm, restore_multi_layer_network(path, device="cpu")


def test_summary_text_equals_jax(tmp_path):
    jm, pm = _pair(tmp_path, bn=True)
    assert pm.summary() == jm.summary()
    from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

    assert MultiLayerNetwork(pm.conf, device="cpu").summary() == JaxMLN(jm.conf).summary()


@pytest.mark.parametrize("bn", [False, True], ids=["dense", "batchnorm"])
def test_feed_forward_matches_jax(tmp_path, bn):
    jm, pm = _pair(tmp_path, bn=bn)
    x = np.random.RandomState(2).randn(6, 4)
    jacts = jm.feed_forward(x)
    pacts = pm.feed_forward(x)
    assert len(pacts) == len(jacts) == len(pm.layers)
    for i, (a, b) in enumerate(zip(pacts, jacts)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL, err_msg=str(i))


def test_get_layer_params_matches_jax(tmp_path):
    jm, pm = _pair(tmp_path)
    for i in range(len(pm.layers)):
        jp, pp = jm.get_layer_params(i), pm.get_layer_params(i)
        assert set(pp) == set(jp)
        for k in jp:
            np.testing.assert_array_equal(pp[k].detach().numpy(), np.asarray(jp[k]))
        assert all(pp[k] is pm.params[pm.conf.layer_name(i)][k] for k in pp)  # live


def test_migrate_state_fills_missing_keys_only(tmp_path):
    jm, pm = _pair(tmp_path, bn=True)
    name = pm.conf.layer_name(1)
    assert set(pm.state[name]) == {"mean", "var"}
    pm.state[name]["mean"] = torch.full_like(pm.state[name]["mean"], 0.25)
    del pm.state[name]["var"]
    pm._persistent_keys[name] = ("mean",)
    jm.state[name] = {"mean": jnp.full_like(jm.state[name]["mean"], 0.25)}
    jm._persistent_keys[name] = ("mean",)
    pm.migrate_state()
    jm.migrate_state()
    assert set(pm.state[name]) == set(jm.state[name]) == {"mean", "var"}
    for k in ("mean", "var"):
        np.testing.assert_array_equal(pm.state[name][k].numpy(), np.asarray(jm.state[name][k]))
    assert set(pm._persistent_keys[name]) == {"mean", "var"}
    from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

    MultiLayerNetwork(pm.conf, device="cpu").migrate_state()  # uninitialized: a no-op


def test_clone_is_deep(tmp_path):
    _, pm = _pair(tmp_path, bn=True)
    x = np.random.RandomState(3).randn(8, 4)
    y = np.eye(3)[np.random.RandomState(4).randint(0, 3, 8)]
    pm.fit(x, y)
    c = pm.clone()
    assert c._trainer is None and c.iteration_count == 0 and not c.listeners.listeners
    before = c.params_flat().copy()
    np.testing.assert_array_equal(before, pm.params_flat())
    for lname, lp in c.params.items():
        for k, p in lp.items():
            assert p.data_ptr() != pm.params[lname][k].data_ptr()
            assert p.requires_grad == pm.params[lname][k].requires_grad
    bn_mean = c.state[pm.conf.layer_name(1)]["mean"].clone()
    pm.fit(x, y)  # one step on the original, in place
    assert not np.array_equal(pm.params_flat(), before)
    np.testing.assert_array_equal(c.params_flat(), before)
    assert torch.equal(c.state[pm.conf.layer_name(1)]["mean"], bn_mean)
    # the clone trains on its own, as the original did from that point
    np.testing.assert_allclose(c.output(x).numpy(), c.output(x).numpy())
    c.fit(x, y)
    assert not np.array_equal(c.params_flat(), before)
