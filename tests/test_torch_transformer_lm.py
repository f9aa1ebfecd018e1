"""TransformerLM parity between the JAX package and its PyTorch port: one
model zip written by the JAX package, restored by both, gives the same
``output()`` (with and without a key mask) and ``score()``.

The JAX side runs under ``set_attention_impl("xla")`` and ``("flash")``
(the Pallas kernel in interpret mode on the CPU); the port under
``"reference"`` and ``"auto"`` (the kernels' plain versions on the CPU).

Tolerance: rtol 1e-5 in float32 on the softmax output (atol 1e-7, well
below the smallest probability, ~1/vocab): the two sides run the same
float32 arithmetic with different summation orders. The 9-block case has
13 layers, so ``layer_10`` sorts before ``layer_2`` in the zip's flat
coefficient vector."""

import importlib
import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.model.serializer import restore_multi_layer_network as jax_restore
from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo.transformer_lm import TransformerLM as JaxLM

from deeplearning4j_tpu_torch.model import (
    load_jax_params,
    restore_model,
    restore_multi_layer_network,
    write_model,
)
from deeplearning4j_tpu_torch.model.zoo import TransformerLM as PortLM
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

jfa = importlib.import_module("deeplearning4j_tpu.ops.flash_attention")
pfa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

RTOL, ATOL = 1e-5, 1e-7
_SHAPE = dict(vocab_size=40, hidden=16, n_heads=2, max_len=32)


@pytest.fixture(autouse=True)
def _restore_impls():
    yield
    jfa.set_attention_impl("auto")
    pfa.set_attention_impl("auto")


@pytest.fixture(scope="module")
def jax_zips(tmp_path_factory):
    """{n_layers: (JAX model, path of the zip it wrote)} for 2 and 9 blocks."""
    out = {}
    for n_layers in (2, 9):
        model = JaxLM(n_layers=n_layers, seed=7, **_SHAPE).init()
        path = str(tmp_path_factory.mktemp("lm") / f"lm{n_layers}.zip")
        jax_write(model, path)
        out[n_layers] = (model, path)
    return out


def _inputs(b=3, t=12, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, _SHAPE["vocab_size"], (b, t)).astype(np.int32)
    labels = rs.randint(0, _SHAPE["vocab_size"], (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, 9:] = 0.0
    mask[2, 4:] = 0.0
    return ids, labels, mask


@pytest.mark.parametrize("n_layers,jax_impl,port_impl,with_score", [
    (2, "xla", "reference", True),
    (2, "flash", "auto", True),
    (9, "xla", "auto", False),  # the JAX score runs eagerly: seconds at 13 layers
])
def test_output_and_score_match_jax(jax_zips, n_layers, jax_impl, port_impl, with_score):
    jmodel, path = jax_zips[n_layers]
    port = restore_multi_layer_network(path, device="cpu")
    assert len(port.layers) == n_layers + 4
    ids, labels, mask = _inputs()
    jfa.set_attention_impl(jax_impl)
    pfa.set_attention_impl(port_impl)
    for mk in (None, mask):
        j = np.asarray(jmodel.output(ids, mask=mk))
        p = port.output(ids, mask=mk).numpy()
        assert p.shape == j.shape == (3, _SHAPE["vocab_size"], 12)
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)
    if with_score:
        js = jmodel.score(ids, labels, mask=mask)
        np.testing.assert_allclose(port.score(ids, labels, mask=mask), js, rtol=RTOL)


def test_flat_order_and_named_params_match_jax(jax_zips):
    jmodel, path = jax_zips[9]
    port = restore_model(path, device="cpu")
    np.testing.assert_array_equal(port.params_flat(), jmodel.params_flat())
    sd = port.state_dict()
    for lname, lparams in jmodel.params.items():
        for pname, arr in lparams.items():
            np.testing.assert_array_equal(sd[f"{lname}.{pname}"].numpy(), np.asarray(arr))


def test_load_jax_params_from_numpy(jax_zips):
    jmodel, _ = jax_zips[2]
    port = MultiLayerNetwork(PortLM(n_layers=2, **_SHAPE).conf(), device="cpu")
    params_np = jax.tree_util.tree_map(np.asarray, jmodel.params)
    load_jax_params(port, params_np)
    ids, _, _ = _inputs(seed=1)
    np.testing.assert_allclose(port.output(ids).numpy(), np.asarray(jmodel.output(ids)),
                               rtol=RTOL, atol=ATOL)
    params_np["layer_2"].pop("Wq")
    with pytest.raises(KeyError, match="layer_2"):
        load_jax_params(port, params_np)


def test_jax_restores_a_zip_the_port_wrote(tmp_path):
    port = PortLM(n_layers=2, seed=5, **_SHAPE).init(device="cpu")
    path = str(tmp_path / "port.zip")
    write_model(port, path)
    jmodel = jax_restore(path)
    np.testing.assert_array_equal(jmodel.params_flat(), port.params_flat())
    ids, _, _ = _inputs(seed=2)
    np.testing.assert_allclose(np.asarray(jmodel.output(ids)), port.output(ids).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_init_is_seeded_and_needs_a_device_choice():
    a = PortLM(n_layers=1, seed=11, **_SHAPE).init(device="cpu")
    b = PortLM(n_layers=1, seed=11, **_SHAPE).init(device="cpu")
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    assert a.num_params() == b.num_params() == a.params_flat().size
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PortLM(n_layers=1, **_SHAPE).init()


def test_zip_from_a_foreign_framework_is_refused(jax_zips, tmp_path):
    import json
    import zipfile

    _, path = jax_zips[2]
    other = str(tmp_path / "other.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(other, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                data = json.dumps({"model_class": "MultiLayerNetwork",
                                   "framework": "other"})
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="framework"):
        restore_multi_layer_network(other, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"hidden": 32, "n_layers": 2, "n_heads": 4, "seed": 5}])
def test_draft_of_pairs_the_draft_as_jax_does(kw):
    """``TransformerLM.draft_of``: the same vocab, max_len and dtype as the
    target, the draft's own stack, the target's seed plus one by default;
    its config JSON is the JAX package's."""
    from deeplearning4j_tpu.core.config import to_json as jax_to_json

    from deeplearning4j_tpu_torch.core.config import to_json

    target = dict(vocab_size=50, hidden=48, n_layers=3, n_heads=4, max_len=24, seed=11,
                  dtype="float64")
    jd = JaxLM.draft_of(JaxLM(**target), **kw)
    pd = PortLM.draft_of(PortLM(**target), **kw)
    for f in ("vocab_size", "hidden", "n_layers", "n_heads", "ffn_size", "max_len", "seed",
              "dtype"):
        assert getattr(pd, f) == getattr(jd, f), f
    assert json.loads(to_json(pd.conf())) == json.loads(jax_to_json(jd.conf()))
