"""A JAX layer against its port on the same float64 inputs, for the port's
layer parity tests (``tests/test_torch_{conv,pooling_norm}.py``).

The layer config is built in the JAX package and decoded in the port from
its JSON; the parameters are drawn by the JAX layer and copied over."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.nn.layers.base import LayerContext as JaxCtx

from deeplearning4j_tpu_torch.core.config import from_json
from deeplearning4j_tpu_torch.nn.layers import LayerContext


def port_of(jlayer):
    player = from_json(jax_to_json(jlayer))
    assert type(player).__name__ == type(jlayer).__name__
    return player


def layer_errors(jlayer, x_np, *, mask=None, seed=0):
    """Run ``jlayer`` and its port on ``x_np`` (inference context, with the
    [b, t] ``mask`` if given). Returns the largest output error and the
    largest error of the gradients of ``sum(out * R)``, ``R`` seeded, with
    respect to the input and every parameter (``jax.vjp`` on the JAX side,
    autograd on the port's)."""
    player = port_of(jlayer)
    jp = jlayer.init(jax.random.PRNGKey(seed), jnp.float64) if jlayer.has_params() else {}
    pp = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in jp.items()}
    jctx = JaxCtx(mask=None if mask is None else jnp.asarray(mask))
    pctx = LayerContext(mask=None if mask is None else torch.tensor(mask))
    px = torch.tensor(x_np, requires_grad=True)

    def jfwd(p, x):
        return jlayer.apply(p, {}, x, jctx)[0]

    jy, vjp = jax.vjp(jax.jit(jfwd), jp, jnp.asarray(x_np))
    r = np.random.RandomState(seed + 1).randn(*jy.shape)
    jgp, jgx = vjp(jnp.asarray(r))
    py = player.apply(pp, {}, px, pctx)[0]
    assert tuple(py.shape) == tuple(jy.shape)
    (py * torch.tensor(r)).sum().backward()
    out_err = float(np.abs(py.detach().numpy() - np.asarray(jy)).max())
    grad_err = float(np.abs(px.grad.numpy() - np.asarray(jgx)).max())
    for k in jp:
        grad_err = max(grad_err, float(np.abs(pp[k].grad.numpy() - np.asarray(jgp[k])).max()))
    return out_err, grad_err


def rand(*shape, seed=3):
    return np.random.RandomState(seed).randn(*shape)
