"""The port's pooling, spatial reshape and normalization layers against the
JAX package's, on the CPU in float64.

Outputs and the gradients of ``sum(out * R)`` (input and parameters) are
held within 1e-10, as in ``tests/test_torch_conv.py``: the same float64
arithmetic in another order. Batch norm's running ``mean``/``var`` after
3 training steps are held within 1e-12: each step adds a float64 moment
over a few hundred values (~1e-16 relative) to a decayed sum of the same
in both packages.

Covered: MAX, AVG, SUM and PNORM pooling (1-D, 2-D, 3-D) with SAME and
TRUNCATE padding (MAX pads with -inf; AVG divides by the unpadded count);
global pooling with and without a [b, t] mask; zero padding, cropping,
upsampling and space-to-depth; batch norm on FF, recurrent and CNN input,
plain and fused, with locked gamma/beta, 3 training steps then inference;
LRN; and batch norm's refusal of a distributed context (ROADMAP A8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.layers.base import LayerContext as JaxCtx

from deeplearning4j_tpu_torch.nn.layers import LayerContext

from torch_layer_helpers import layer_errors, port_of, rand

TOL = 1e-10
STATE_TOL = 1e-12
P = jl.PoolingType
M = jl.ConvolutionMode
TYPES = ["MAX", "AVG", "SUM", "PNORM"]


def _check(jlayer, x, mask=None):
    out_err, grad_err = layer_errors(jlayer, x, mask=mask)
    assert out_err <= TOL and grad_err <= TOL, (out_err, grad_err)


@pytest.mark.parametrize("pooling", TYPES)
@pytest.mark.parametrize("mode", ["SAME", "TRUNCATE"])
@pytest.mark.parametrize("stride", [1, 2])
def test_subsampling2d(pooling, mode, stride):
    layer = jl.SubsamplingLayer(pooling_type=P[pooling], kernel_size=(3, 2),
                                stride=(stride, 2), padding=(1, 1), convolution_mode=M[mode],
                                pnorm=3)
    _check(layer, rand(2, 3, 9, 8))


@pytest.mark.parametrize("pooling", TYPES)
@pytest.mark.parametrize("mode", ["SAME", "TRUNCATE"])
def test_subsampling1d(pooling, mode):
    layer = jl.Subsampling1DLayer(pooling_type=P[pooling], kernel_size=3, stride=2, padding=1,
                                  convolution_mode=M[mode])
    _check(layer, rand(2, 3, 10))


@pytest.mark.parametrize("pooling", TYPES)
@pytest.mark.parametrize("mode", ["SAME", "TRUNCATE"])
def test_subsampling3d(pooling, mode):
    layer = jl.Subsampling3DLayer(pooling_type=P[pooling], kernel_size=(2, 3, 2),
                                  stride=(2, 2, 1), padding=(0, 1, 1), convolution_mode=M[mode])
    _check(layer, rand(1, 2, 5, 6, 4))


@pytest.mark.parametrize("pooling", TYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_global_pooling_recurrent(pooling, masked):
    mask = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1], [1, 0, 0, 0, 0, 0]], np.float64)
    _check(jl.GlobalPoolingLayer(pooling_type=P[pooling], pnorm=3), rand(3, 4, 6),
           mask=mask if masked else None)


@pytest.mark.parametrize("pooling", TYPES)
def test_global_pooling_cnn(pooling):
    _check(jl.GlobalPoolingLayer(pooling_type=P[pooling]), rand(2, 3, 4, 5))


@pytest.mark.parametrize("jlayer,shape", [
    (jl.ZeroPaddingLayer(padding=(1, 2, 0, 3)), (2, 3, 4, 5)),
    (jl.ZeroPadding1DLayer(padding=(2, 1)), (2, 3, 5)),
    (jl.Cropping2DLayer(crop=(1, 0, 2, 1)), (2, 3, 5, 6)),
    (jl.SpaceToDepthLayer(block_size=2), (2, 3, 4, 6)),
    (jl.Upsampling1DLayer(size=3), (2, 3, 4)),
    (jl.Upsampling2DLayer(size=(2, 3)), (2, 3, 4, 5)),
    (jl.Upsampling3DLayer(size=(2, 1, 3)), (1, 2, 3, 4, 2)),
], ids=lambda v: type(v).__name__ if not isinstance(v, tuple) else "x".join(map(str, v)))
def test_spatial_reshape_layers(jlayer, shape):
    _check(jlayer, rand(*shape))


def test_local_response_normalization():
    _check(jl.LocalResponseNormalizationLayer(k=1.5, n=5, alpha=0.1, beta=0.75),
           rand(2, 7, 3, 4))


# ---- batch normalization ----------------------------------------------------

_SHAPES = {"ff": (6, 4), "recurrent": (3, 4, 5), "cnn": (4, 4, 3, 5)}


@pytest.mark.parametrize("kind", list(_SHAPES))
@pytest.mark.parametrize("variant", ["plain", "fused", "locked"])
def test_batch_norm_training_then_inference(kind, variant):
    """3 training steps on seeded batches (outputs, gradients, the running
    statistics threaded through), then an inference call on the final
    statistics."""
    jlayer = jl.BatchNormalizationLayer(n_out=4, decay=0.8, eps=1e-3,
                                        fused=variant == "fused",
                                        lock_gamma_beta=variant == "locked",
                                        gamma_init=1.5, beta_init=-0.5)
    player = port_of(jlayer)
    jp = jlayer.init(jax.random.PRNGKey(0), jnp.float64)
    # non-trivial gamma/beta so a swapped scale or shift shows
    jp = {k: v + 0.1 * jnp.arange(4) for k, v in jp.items()}
    pp = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in jp.items()}
    js = jlayer.init_state(jnp.float64)
    ps = {k: torch.tensor(np.asarray(v)) for k, v in js.items()}
    assert set(ps) == {"mean", "var"}
    for step in range(3):
        x = 2.0 + 3.0 * rand(*_SHAPES[kind], seed=10 + step)
        r = rand(*_SHAPES[kind], seed=20 + step)

        def loss(p, xx):
            y, st = jlayer.apply(p, js, xx, JaxCtx(train=True))
            return jnp.sum(y * r), (y, st)

        (_, (jy, js_new)), (jgp, jgx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
        px = torch.tensor(x, requires_grad=True)
        py, ps_new = player.apply(pp, ps, px, LayerContext(train=True))
        (py * torch.tensor(r)).sum().backward()
        assert np.abs(py.detach().numpy() - np.asarray(jy)).max() <= TOL
        assert np.abs(px.grad.numpy() - np.asarray(jgx)).max() <= TOL
        for k in pp:
            assert np.abs(pp[k].grad.numpy() - np.asarray(jgp[k])).max() <= TOL, k
            pp[k].grad = None
        for k in ("mean", "var"):
            assert not ps_new[k].requires_grad
            assert np.abs(ps_new[k].numpy() - np.asarray(js_new[k])).max() <= STATE_TOL, k
        js, ps = js_new, ps_new
    assert np.abs(ps["var"].numpy() - 1.0).max() > 0.5  # the statistics moved
    x = rand(*_SHAPES[kind], seed=30)
    jy, _ = jlayer.apply(jp, js, jnp.asarray(x), JaxCtx(train=False))
    with torch.inference_mode():
        py, st = player.apply(pp, ps, torch.tensor(x), LayerContext(train=False))
    assert st is ps
    assert np.abs(py.numpy() - np.asarray(jy)).max() <= TOL


def test_batch_norm_refuses_a_distributed_context():
    player = port_of(jl.BatchNormalizationLayer(n_out=3, stats_axis_group=2))
    params = player.init(torch.Generator().manual_seed(0), torch.float64)
    state = {k: v.double() for k, v in player.init_state(torch.float64).items()}
    x = torch.tensor(rand(4, 3))
    with pytest.raises(NotImplementedError, match="A8"):
        player.apply(params, state, x, LayerContext(train=True, dist=object()))
    # without a distributed context the statistics are local, as in JAX
    y, _ = player.apply(params, state, x, LayerContext(train=True))
    assert torch.allclose(y.mean(0), torch.zeros(3, dtype=torch.float64), atol=1e-12)
