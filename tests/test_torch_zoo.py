"""The rest of the port's model zoo against the JAX package's, on the CPU in
float64 with the same weights: AlexNet, VGG16, VGG19, SqueezeNet,
Darknet19, TinyYOLO, UNet, Xception, NASNet, InceptionResNetV1, SimpleCNN,
YOLO2 and FaceNetNN4Small2, each at a small input (the JAX package's own
zoo tests' sizes or smaller; widths as published unless the constructor
offers a cut, named below).

For each model: the config JSON equals the JAX package's (where no
``SameDiffLambdaLayer`` carries a Python function), the parameter count is
equal, and every layer's or vertex's output on a seeded batch of 2 agrees
with the JAX network's within 1e-10 of its largest value (the same float64
arithmetic in another order); then the ``"inference"`` rewrite applies the
same passes in both packages and leaves the port's output within 1e-10.
``model/zoo/__init__.py`` exports what the JAX package's does."""

import json

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.model.zoo as jax_zoo
from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.nn.rewrite import rewrite_model as jax_rewrite

import deeplearning4j_tpu_torch.model.zoo as port_zoo
from deeplearning4j_tpu_torch.core.config import to_json
from deeplearning4j_tpu_torch.nn.rewrite import rewrite_model

from torch_rewrite_helpers import (jax_activations, jax_twin, port_activations, seed_bn_stats,
                                   worst_rel)

TOL = 1e-10

# (class name, constructor arguments, input [c, h, w], output shape of a batch of 2)
CASES = [
    ("AlexNet", dict(num_classes=5, height=96, width=96), (3, 96, 96), (2, 5)),
    ("VGG16", dict(num_classes=4, height=32, width=32), (3, 32, 32), (2, 4)),
    ("VGG19", dict(num_classes=4, height=32, width=32), (3, 32, 32), (2, 4)),
    ("SqueezeNet", dict(num_classes=6, height=64, width=64), (3, 64, 64), (2, 6)),
    ("Darknet19", dict(num_classes=7, height=64, width=64), (3, 64, 64), (2, 7)),
    ("TinyYOLO", dict(num_classes=3, num_boxes=5, height=64, width=64), (3, 64, 64),
     (2, 40, 2, 2)),
    ("UNet", dict(num_classes=2, height=32, width=32, base_filters=8, depth=2),
     (3, 32, 32), (2, 2, 32, 32)),
    ("Xception", dict(num_classes=4, height=32, width=32, middle_blocks=1), (3, 32, 32),
     (2, 4)),
    ("NASNet", dict(num_classes=4, height=32, width=32, num_blocks=1,
                    penultimate_filters=120, stem_filters=8), (3, 32, 32), (2, 4)),
    ("InceptionResNetV1", dict(num_classes=4, height=96, width=96, blocks_a=1, blocks_b=1,
                               blocks_c=1), (3, 96, 96), (2, 4)),
    ("SimpleCNN", dict(num_classes=4, height=16, width=16), (3, 16, 16), (2, 4)),
    ("YOLO2", dict(num_classes=3, n_boxes=5, height=64, width=64), (3, 64, 64),
     (2, 40, 2, 2)),
    ("FaceNetNN4Small2", dict(embedding_size=64, height=96, width=96), (3, 96, 96), (2, 64)),
]
# a SameDiffLambdaLayer holds a Python function, which config JSON cannot carry
_LAMBDA_MODELS = {"YOLO2", "FaceNetNN4Small2"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: with the suite's 6 workers
    sharing the cores, Xception's float64 depthwise convolutions on the
    default thread count took 478 s against 2 s on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_zoo_exports_equal_jax():
    assert port_zoo.__all__ == jax_zoo.__all__
    for name in port_zoo.__all__:
        assert hasattr(port_zoo, name), name
    from deeplearning4j_tpu_torch.generate import sampling

    assert port_zoo.greedy is sampling.greedy and port_zoo.top_p is sampling.top_p


@pytest.mark.parametrize("name,kw,chw,out_shape", CASES, ids=[c[0] for c in CASES])
def test_zoo_model_matches_jax(name, kw, chw, out_shape):
    kw = dict(kw, dtype="float64")
    pconf = getattr(port_zoo, name)(**kw).conf()
    jconf = getattr(jax_zoo, name)(**kw).conf()
    if name not in _LAMBDA_MODELS:
        assert json.loads(to_json(pconf)) == json.loads(jax_to_json(jconf))
    pm = getattr(port_zoo, name)(**kw).init(device="cpu")
    seed_bn_stats(pm)
    jm = jax_twin(pm, jconf)
    assert pm.num_params() == jm.num_params()
    x = np.random.RandomState(7).randn(2, *chw)
    got = port_activations(pm, x)
    err, where = worst_rel(got, jax_activations(jm, x))
    assert err <= TOL, (name, where, err)
    out = pm.output(x)
    out = out[0] if isinstance(out, tuple) else out
    assert tuple(out.shape) == out_shape and bool(torch.isfinite(out).all())

    # the serving rewrite: the same passes in both packages, the same output
    rm, applied = rewrite_model(pm, "inference")
    _, japplied = jax_rewrite(jm, "inference")
    assert applied == japplied
    rout = rm.output(x)
    rout = rout[0] if isinstance(rout, tuple) else rout
    scale = float(out.abs().max())
    assert float((rout - out).abs().max()) <= TOL * scale, (name, applied)


def _jax_output_shape(jconf, batch, chw):
    """The JAX package's output shape of ``jconf`` on a [batch, *chw] input,
    by abstract evaluation (parameter shapes from each layer's init, no
    draw and no arithmetic)."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
    from deeplearning4j_tpu.nn.graph_conf import ComputationGraphConfiguration as JaxCGConf
    from deeplearning4j_tpu.nn.rewrite.base import _install as jax_install
    from deeplearning4j_tpu.nn.sequential import MultiLayerNetwork as JaxMLN

    graph = isinstance(jconf, JaxCGConf)
    layers = ([(s.name, s.layer) for s in jconf.vertices if s.layer is not None] if graph
              else [(jconf.layer_name(i), l) for i, l in enumerate(jconf.layers)])
    key = jax.random.PRNGKey(0)
    params = {n: (jax.eval_shape(lambda k, l=l: l.init(k, jnp.float32), key)
                  if l.has_params() else {}) for n, l in layers}
    state = {n: l.init_state(jnp.float32) for n, l in layers}
    jm = (JaxCG if graph else JaxMLN)(jconf)
    jax_install(jm, jconf, params, state)

    def fwd(p, x):
        if graph:
            acts, _ = jm.forward_pure(p, state, (x,), train=False, rng=None)
            return acts[jconf.network_outputs[0]]
        return jm.forward_pure(p, state, x, train=False, rng=None)[0]

    out = jax.eval_shape(fwd, params, jax.ShapeDtypeStruct((batch,) + tuple(chw), jnp.float32))
    return tuple(out.shape)


def test_chip_smoke_zoo_shapes_are_jax_output_shapes():
    """``chip_smoke.py``'s published-size zoo table (input and expected
    output shape of each model, batch 8) against the JAX package's shape
    inference."""
    import chip_smoke

    assert sorted(n for n, *_ in chip_smoke.ZOO_CASES) == sorted(n for n, *_ in CASES)
    for name, kw, chw, shape in chip_smoke.ZOO_CASES:
        jconf = getattr(jax_zoo, name)(**kw).conf()
        assert _jax_output_shape(jconf, chip_smoke.ZOO_BATCH, chw) == shape, name
