"""Updaters — optimizer configs with the reference's vocabulary, and their
math (port of ``deeplearning4j_tpu/train/updaters.py``).

Reference: org.nd4j.linalg.learning.config.{Sgd, Adam, AdamW, AMSGrad, Nadam,
Nesterovs, RmsProp, AdaGrad, AdaDelta, AdaMax, NoOp} plus Lars and Lamb.

The JAX package builds each updater as an ``optax`` chain. The port spells
the same chains with the same defaults and the same state, as optax 0.2.6
does — not as ``torch.optim`` does, whose defaults differ (optax's AdaGrad
starts its accumulator at 0.1; its AdamW multiplies the decay by the
learning rate). :class:`GradientTransformation` is the counterpart of
``optax.GradientTransformation``: ``init(params)`` gives the state and
``update(updates, state, params)`` gives ``(updates, new_state)``, over
``{param_name: tensor}`` dicts. The states keep optax's types, fields and
order (for Adam: ``ScaleByAdamState(count, mu, nu)`` then the learning
rate's state), so a state flattens to the leaves the JAX package writes.

Differences that follow from running eagerly, said here once:

* Step counts stay on the host as Python ints, so reading a schedule or a
  bias correction never waits for the device.
* The moment tensors of a state are updated in place, and the returned
  state holds the same tensors; the caller runs the whole update under
  ``torch.no_grad()`` and adds the updates to the parameters in place
  (:func:`apply_updates`).

Learning rates accept either a float or an :class:`ISchedule`, read at the
step count (``_lr_fn``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import register_config
from .schedules import ISchedule

LR = Union[float, ISchedule]
Tree = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    """Counterpart of ``optax.GradientTransformation`` (see the module
    docstring)."""

    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Optional[Tree]], Tuple[Tree, Any]]


# ---- optax's state types, field for field -----------------------------------


class EmptyState(NamedTuple):
    pass


class ScaleByScheduleState(NamedTuple):
    count: int


class ScaleByAdamState(NamedTuple):
    count: int
    mu: Tree
    nu: Tree


class ScaleByAmsgradState(NamedTuple):
    count: int
    mu: Tree
    nu: Tree
    nu_max: Tree


class ScaleByRmsState(NamedTuple):
    nu: Tree


class ScaleByRssState(NamedTuple):
    sum_of_squares: Tree


class ScaleByAdaDeltaState(NamedTuple):
    e_g: Tree
    e_x: Tree


class TraceState(NamedTuple):
    trace: Tree


class MaskedState(NamedTuple):
    inner_state: Any


_INT32_MAX = 2**31 - 1


def _inc(count: int) -> int:
    """optax's ``safe_increment`` of an int32 counter."""
    return min(count + 1, _INT32_MAX)


def _zeros(params: Tree) -> Tree:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _full(params: Tree, value: float) -> Tree:
    return {k: torch.full_like(p, value) for k, p in params.items()}


def _lr_fn(lr: LR):
    if isinstance(lr, ISchedule):
        # optax schedules get a step count; epochs enter via ScheduleType
        # at the trainer level (iteration-based, as in the JAX package)
        return lambda count: lr.value_at(count, 0)
    return float(lr)


def _lr_at(lr_fn, count: int) -> float:
    return lr_fn(count) if callable(lr_fn) else lr_fn


def _moment(g: torch.Tensor, m: torch.Tensor, decay: float, order: int) -> torch.Tensor:
    """In place: ``m = (1 - decay) * g**order + decay * m``."""
    gp = g if order == 1 else g * g
    return m.mul_(decay).add_((1.0 - decay) * gp)


def _bias_correction(t: torch.Tensor, decay: float, count: int) -> torch.Tensor:
    return t / (1.0 - decay ** count)


# ---- optax's transformations ------------------------------------------------


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params=None: (updates, state))


def set_to_zero() -> GradientTransformation:
    return GradientTransformation(
        lambda params: EmptyState(),
        lambda updates, state, params=None: (
            {k: torch.zeros_like(g) for k, g in updates.items()}, state))


def scale_by_learning_rate(learning_rate: LR) -> GradientTransformation:
    """``updates * -lr``: a constant (``EmptyState``) or a schedule read at
    its own count (``ScaleByScheduleState``)."""
    lr_fn = _lr_fn(learning_rate)
    if not callable(lr_fn):
        return GradientTransformation(
            lambda params: EmptyState(),
            lambda updates, state, params=None: (
                {k: g * -lr_fn for k, g in updates.items()}, state))

    def update(updates, state, params=None):
        step = -lr_fn(state.count)
        return ({k: g * step for k, g in updates.items()},
                ScaleByScheduleState(_inc(state.count)))

    return GradientTransformation(lambda params: ScaleByScheduleState(0), update)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Dict[str, bool]] = None) -> GradientTransformation:
    """``updates + weight_decay * params``; with ``mask``, only where the
    mask is True (``optax.masked``, whose state wraps the inner one)."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights requires params")
        return ({k: g + weight_decay * params[k] if mask is None or mask.get(k, False) else g
                 for k, g in updates.items()}, state)

    if mask is None:
        return GradientTransformation(lambda params: EmptyState(), update)
    return GradientTransformation(lambda params: MaskedState(EmptyState()), update)


def scale_by_adam(b1: float, b2: float, eps: float, *,
                  nesterov: bool = False) -> GradientTransformation:
    """optax's ``scale_by_adam`` (``eps_root`` 0, as every updater uses it)."""
    def init(params):
        return ScaleByAdamState(0, _zeros(params), _zeros(params))

    def update(updates, state, params=None):
        count = _inc(state.count)
        out = {}
        for k, g in updates.items():
            mu = _moment(g, state.mu[k], b1, 1)
            nu = _moment(g, state.nu[k], b2, 2)
            if nesterov:
                mu_hat = (b1 * _bias_correction(mu, b1, _inc(count))
                          + (1 - b1) * _bias_correction(g, b1, count))
            else:
                mu_hat = _bias_correction(mu, b1, count)
            nu_hat = _bias_correction(nu, b2, count)
            out[k] = mu_hat / (torch.sqrt(nu_hat) + eps)
        return out, ScaleByAdamState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


def scale_by_amsgrad(b1: float, b2: float, eps: float) -> GradientTransformation:
    def init(params):
        return ScaleByAmsgradState(0, _zeros(params), _zeros(params), _zeros(params))

    def update(updates, state, params=None):
        count = _inc(state.count)
        out = {}
        for k, g in updates.items():
            mu = _moment(g, state.mu[k], b1, 1)
            nu = _moment(g, state.nu[k], b2, 2)
            mu_hat = _bias_correction(mu, b1, count)
            nu_max = torch.maximum(state.nu_max[k], _bias_correction(nu, b2, count),
                                   out=state.nu_max[k])
            out[k] = mu_hat / (torch.sqrt(nu_max) + eps)
        return out, ScaleByAmsgradState(count, state.mu, state.nu, state.nu_max)

    return GradientTransformation(init, update)


def scale_by_adamax(b1: float, b2: float, eps: float) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(0, _zeros(params), _zeros(params))

    def update(updates, state, params=None):
        count = _inc(state.count)
        out = {}
        for k, g in updates.items():
            mu = _moment(g, state.mu[k], b1, 1)
            # the infinity moment: max(|g| + eps, b2 * nu); no bias correction
            nu = state.nu[k]
            torch.maximum(torch.abs(g) + eps, b2 * nu, out=nu)
            out[k] = _bias_correction(mu, b1, count) / nu
        return out, ScaleByAdamState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


def scale_by_rms(decay: float, eps: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return ({k: g * torch.rsqrt(_moment(g, state.nu[k], decay, 2) + eps)
                 for k, g in updates.items()}, state)

    return GradientTransformation(lambda params: ScaleByRmsState(_zeros(params)), update)


def scale_by_rss(eps: float) -> GradientTransformation:
    """optax's ``scale_by_rss``, whose accumulator starts at 0.1."""
    def update(updates, state, params=None):
        out = {}
        for k, g in updates.items():
            sos = state.sum_of_squares[k].add_(g * g)
            inv = torch.where(sos > 0, torch.rsqrt(sos + eps), torch.zeros_like(sos))
            out[k] = inv * g
        return out, state

    return GradientTransformation(lambda params: ScaleByRssState(_full(params, 0.1)), update)


def scale_by_adadelta(rho: float, eps: float) -> GradientTransformation:
    def init(params):
        return ScaleByAdaDeltaState(_zeros(params), _zeros(params))

    def update(updates, state, params=None):
        out = {}
        for k, g in updates.items():
            e_g = _moment(g, state.e_g[k], rho, 2)
            u = torch.sqrt(state.e_x[k] + eps) / torch.sqrt(e_g + eps) * g
            _moment(u, state.e_x[k], rho, 2)
            out[k] = u
        return out, state

    return GradientTransformation(init, update)


def nesterov_trace(decay: float) -> GradientTransformation:
    """optax's ``trace(decay, nesterov=True)``."""

    def update(updates, state, params=None):
        out = {}
        for k, g in updates.items():
            t = state.trace[k].mul_(decay).add_(g)  # g + decay * trace
            out[k] = g + decay * t
        return out, state

    return GradientTransformation(lambda params: TraceState(_zeros(params)), update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def apply_updates(params: Tree, updates: Tree) -> None:
    """``params += updates``, in place (``optax.apply_updates``); the caller
    holds ``torch.no_grad()``."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


# ---- layer-wise trust-ratio updaters (LARS/LAMB) ----------------------------


NormFn = Callable[[str, torch.Tensor], torch.Tensor]


def make_norm_fn(axis: Any = None, sliced: Optional[Dict[str, bool]] = None) -> NormFn:
    """Squared-norm reducer for the trust-ratio updaters, called with the
    param's name and its local squared sum.

    Default (``axis=None``): identity, the local squared sum is the whole
    norm. Under ZeRO-1 each replica holds a 1/N slice of the params named
    in ``sliced``, so their norm is the slice-local squared sum all-reduced
    over ``axis`` (the data axis's ``torch.distributed`` process group).
    The norms are the only coupling between elements in LARS/LAMB, and
    they reduce, so the sliced update stays the replicated update to
    rounding. Leaves not sliced are whole on every replica, and summing
    them would count them N times.

    With ``sliced=None``, ``axis`` is a list of ``(group, sliced)`` pairs,
    each summed over in turn (a ZeRO-1 slice of a tensor-parallel shard
    sums over the data axis, then the model axis)."""
    if axis is None:
        return lambda name, s: s
    pairs = [(g, dict(f or {})) for g, f in (axis if sliced is None else [(axis, sliced)])]

    def fn(name, s):
        for group, flags in pairs:
            if flags.get(name, False):
                torch.distributed.all_reduce(s, group=group)  # s is a fresh sum
        return s

    return fn


def _sq_sum(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(a.float()))


def _trust_ratio(wn: torch.Tensor, un: torch.Tensor, coeff: float, eps: float) -> torch.Tensor:
    """phi(||w||)/||u|| with the standard guards: a zero-norm param (fresh
    bias) or a zero update falls back to ratio 1 (plain step)."""
    return torch.where((wn > 0.0) & (un > 0.0), coeff * wn / (un + eps),
                       torch.ones_like(wn))


def _scalar_tree(params: Tree) -> Tree:
    return {k: torch.zeros((), dtype=torch.float32, device=p.device) for k, p in params.items()}


def _lars_tx(lr: LR, momentum: float, weight_decay: float, trust_coefficient: float,
             eps: float, norm_fn: Optional[NormFn] = None) -> GradientTransformation:
    lr_fn = _lr_fn(lr)
    norm_fn = norm_fn or make_norm_fn()

    def init(params):
        return {"count": 0, "trace": _zeros(params), "trust": _scalar_tree(params),
                "gnorm": _scalar_tree(params)}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("Lars requires params")
        count = state["count"] + 1
        lr_t = _lr_at(lr_fn, count - 1)
        out, trust_t, gnorm = {}, {}, {}
        for k, g in updates.items():
            p, m = params[k], state["trace"][k]
            u = g + weight_decay * p if weight_decay else g
            wn, un = torch.sqrt(norm_fn(k, _sq_sum(p))), torch.sqrt(norm_fn(k, _sq_sum(u)))
            trust = _trust_ratio(wn, un, trust_coefficient, eps)
            m.mul_(momentum).add_((trust * u.float()).to(m.dtype))
            out[k] = (-lr_t * m).to(g.dtype)
            trust_t[k], gnorm[k] = trust, un
        return out, {"count": count, "trace": state["trace"], "trust": trust_t,
                     "gnorm": gnorm}

    return GradientTransformation(init, update)


def _lamb_tx(lr: LR, b1: float, b2: float, eps: float, weight_decay: float,
             trust_coefficient: float, norm_fn: Optional[NormFn] = None) -> GradientTransformation:
    lr_fn = _lr_fn(lr)
    norm_fn = norm_fn or make_norm_fn()

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params),
                "trust": _scalar_tree(params), "gnorm": _scalar_tree(params)}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("Lamb requires params")
        count = state["count"] + 1
        lr_t = _lr_at(lr_fn, count - 1)
        # the JAX package's bias corrections are float32 (its count is cast
        # to float32): 1 - 0.999 loses five digits there, and a parameter
        # with no trust ratio (a zero bias) takes that rounding into its step
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        out, trust_t, gnorm = {}, {}, {}
        for k, g in updates.items():
            p = params[k]
            m = _moment(g, state["mu"][k], b1, 1)
            v = _moment(g, state["nu"][k], b2, 2)
            adam = (m / c1) / (torch.sqrt(v / c2) + eps)
            u = adam + weight_decay * p if weight_decay else adam
            wn, un = torch.sqrt(norm_fn(k, _sq_sum(p))), torch.sqrt(norm_fn(k, _sq_sum(u)))
            trust = _trust_ratio(wn, un, trust_coefficient, 0.0)
            out[k] = (-lr_t * trust * u).to(g.dtype)
            trust_t[k], gnorm[k] = trust, un
        return out, {"count": count, "mu": state["mu"], "nu": state["nu"],
                     "trust": trust_t, "gnorm": gnorm}

    return GradientTransformation(init, update)


# ---- the configs ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IUpdater:
    """Base updater config."""

    def to_transform(self) -> GradientTransformation:
        """The update math: the counterpart of the JAX package's
        ``to_optax()``."""
        raise NotImplementedError

    @property
    def has_state(self) -> bool:
        return True

    @property
    def elementwise(self) -> bool:
        """True when the update is independent per tensor element (every
        built-in updater). ZeRO-1 relies on it: the update applied to each
        replica's 1/N slice of grads, params and state, then an all-gather
        of the param slices, is the replicated update. An updater whose
        only coupling is a reduction (the LARS/LAMB norms) stays ``True``
        by re-spelling the reduction in :meth:`to_transform_zero1`; one
        whose state couples elements otherwise must return ``False``, and
        the trainer then keeps that layer's state whole."""
        return True

    def to_transform_zero1(self, axis: Any, sliced: Dict[str, bool]) -> GradientTransformation:
        """The transformation as applied to 1/N parameter slices under
        ZeRO-1 (the counterpart of the JAX package's ``to_optax_zero1``).
        ``axis`` is the data axis's process group and ``sliced`` says which
        params arrive sliced. An elementwise updater needs no collective,
        so the default is :meth:`to_transform`; Lars and Lamb all-reduce
        their slice-local squared norms (:func:`make_norm_fn`). The state
        is the same in both spellings."""
        return self.to_transform()

    def state_partition_spec(self, param_shape, n_shards: int, axis: str = "data",
                             base=None):
        """Partition spec of a param-shaped state leaf under ZeRO-1: dim 0
        over the data axis when it divides (``parallel.mesh.
        zero1_partition_spec``), else ``base``. A non-elementwise updater
        keeps ``base`` (whole)."""
        from ..parallel.mesh import PartitionSpec, zero1_partition_spec

        if not self.elementwise:
            return base if base is not None else PartitionSpec()
        return zero1_partition_spec(tuple(param_shape), n_shards, axis, base)


@register_config
@dataclasses.dataclass(frozen=True)
class Sgd(IUpdater):
    learning_rate: LR = 1e-1

    def to_transform(self) -> GradientTransformation:
        return chain(identity(), scale_by_learning_rate(self.learning_rate))

    @property
    def has_state(self) -> bool:
        return False


@register_config
@dataclasses.dataclass(frozen=True)
class Adam(IUpdater):
    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self) -> GradientTransformation:
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(self.learning_rate))


@register_config
@dataclasses.dataclass(frozen=True)
class AdamW(IUpdater):
    """Decoupled weight decay Adam: optax's ``adamw``, whose decay is added
    to the Adam direction and so multiplied by the learning rate."""

    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 1e-2

    def to_transform(self) -> GradientTransformation:
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     add_decayed_weights(self.weight_decay),
                     scale_by_learning_rate(self.learning_rate))


@register_config
@dataclasses.dataclass(frozen=True)
class AMSGrad(IUpdater):
    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self) -> GradientTransformation:
        return chain(scale_by_amsgrad(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(self.learning_rate))


@register_config
@dataclasses.dataclass(frozen=True)
class Nadam(IUpdater):
    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self) -> GradientTransformation:
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon, nesterov=True),
                     scale_by_learning_rate(self.learning_rate))


@register_config
@dataclasses.dataclass(frozen=True)
class Nesterovs(IUpdater):
    learning_rate: LR = 1e-1
    momentum: float = 0.9

    def to_transform(self) -> GradientTransformation:
        return chain(nesterov_trace(self.momentum),
                     scale_by_learning_rate(self.learning_rate))


@register_config
@dataclasses.dataclass(frozen=True)
class RmsProp(IUpdater):
    learning_rate: LR = 1e-1
    decay: float = 0.95
    epsilon: float = 1e-8

    def to_transform(self) -> GradientTransformation:
        return chain(scale_by_rms(self.decay, self.epsilon),
                     scale_by_learning_rate(self.learning_rate), identity())


@register_config
@dataclasses.dataclass(frozen=True)
class AdaGrad(IUpdater):
    """optax's ``adagrad``: the accumulator starts at 0.1."""

    learning_rate: LR = 1e-1
    epsilon: float = 1e-6

    def to_transform(self) -> GradientTransformation:
        return chain(scale_by_rss(self.epsilon),
                     scale_by_learning_rate(self.learning_rate))


@register_config
@dataclasses.dataclass(frozen=True)
class AdaDelta(IUpdater):
    # AdaDelta is self-scaling; the reference exposes no LR and applies the
    # raw delta (lr == 1)
    learning_rate: LR = 1.0
    rho: float = 0.95
    epsilon: float = 1e-6

    def to_transform(self) -> GradientTransformation:
        # optax's adadelta opens with add_decayed_weights(0.0), a no-op
        # with an empty state: identity() keeps the state's layout
        return chain(identity(), scale_by_adadelta(self.rho, self.epsilon),
                     scale_by_learning_rate(self.learning_rate))


@register_config
@dataclasses.dataclass(frozen=True)
class AdaMax(IUpdater):
    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self) -> GradientTransformation:
        return chain(scale_by_adamax(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(self.learning_rate))


@register_config
@dataclasses.dataclass(frozen=True)
class Lars(IUpdater):
    """Layer-wise Adaptive Rate Scaling (You et al. 2017): each parameter
    tensor's LR is scaled by the trust ratio ``trust_coefficient * ||w|| /
    ||g + wd*w||`` before the momentum accumulation. State per tensor: the
    momentum ``trace`` and the last step's ``trust`` and ``gnorm``."""

    learning_rate: LR = 1e-1
    momentum: float = 0.9
    weight_decay: float = 0.0
    trust_coefficient: float = 1e-3
    epsilon: float = 1e-9

    def to_transform(self) -> GradientTransformation:
        return _lars_tx(self.learning_rate, self.momentum, self.weight_decay,
                        self.trust_coefficient, self.epsilon)

    def to_transform_zero1(self, axis, sliced) -> GradientTransformation:
        return _lars_tx(self.learning_rate, self.momentum, self.weight_decay,
                        self.trust_coefficient, self.epsilon,
                        norm_fn=make_norm_fn(axis, sliced))


@register_config
@dataclasses.dataclass(frozen=True)
class Lamb(IUpdater):
    """Layer-wise adaptive Adam (LAMB, You et al. 2019): LARS's trust ratio
    applied to the bias-corrected Adam direction plus decoupled weight
    decay: ``update = -lr * (||w||/||adam + wd*w||) * (adam + wd*w)``."""

    learning_rate: LR = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-6
    weight_decay: float = 0.0
    trust_coefficient: float = 1.0

    def to_transform(self) -> GradientTransformation:
        return _lamb_tx(self.learning_rate, self.beta1, self.beta2, self.epsilon,
                        self.weight_decay, self.trust_coefficient)

    def to_transform_zero1(self, axis, sliced) -> GradientTransformation:
        return _lamb_tx(self.learning_rate, self.beta1, self.beta2, self.epsilon,
                        self.weight_decay, self.trust_coefficient,
                        norm_fn=make_norm_fn(axis, sliced))


@register_config
@dataclasses.dataclass(frozen=True)
class NoOp(IUpdater):
    """Applies no update (frozen params use this)."""

    def to_transform(self) -> GradientTransformation:
        return set_to_zero()

    @property
    def has_state(self) -> bool:
        return False


def updater_from_any(u: Any) -> IUpdater:
    if isinstance(u, IUpdater):
        return u
    if u is None:
        return Sgd()
    raise TypeError(f"Not an updater: {u!r}")


def registered_updaters() -> Tuple[type, ...]:
    """Every ``@register_config``'d IUpdater subclass, sorted by name."""
    from ..core.config import _CONFIG_REGISTRY

    return tuple(sorted(
        (c for c in _CONFIG_REGISTRY.values()
         if isinstance(c, type) and issubclass(c, IUpdater) and c is not IUpdater),
        key=lambda c: c.__name__))
