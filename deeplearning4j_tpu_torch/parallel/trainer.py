"""DistributedTrainer: data-parallel training over ``torch.distributed``
(port of ``DistributedTrainer`` in ``deeplearning4j_tpu/parallel/trainer.py``).

Reference: ``ParallelWrapper`` (single-node multi-device data parallelism),
``SharedTrainingMaster`` (gradient sharing) and
``ParameterAveragingTrainingMaster`` (periodic averaging).

The JAX trainer is one process driving every device of a mesh. The port
runs one process per replica (a rank), and every rank runs this trainer,
following the JAX package's multi-process contract:

* each rank feeds its own LOCAL rows; the global batch is the local batch
  times the number of ranks;
* ``fit`` re-chunks by the local shard count (one per rank);
* every rank must see the same number of batches, or the others block in
  the next collective.

A step is the forward and backward on the local rows, the strategy's
gradient exchange, gradient normalization, the update, and the averaging
of the float state (batch norm's running statistics) and of the score over
the data axis. As in the JAX package, :class:`SyncAllReduce` is the
implicit path, whose step sees the global batch: a batch norm with no
statistics group takes its moments over every rank's rows, all-reduced in
the forward and the backward. Every other strategy is explicit: each rank
normalizes by its own rows unless ``bn_group_size`` groups them.

ZeRO-1 (``zero1=True``) keeps 1/N of each elementwise updater's state on
each rank: after the exchange every rank holds the same gradients, updates
only its dim-0 slice of each param that the data axis divides, and the
slices are all-gathered (one collective per dtype), as the JAX package's
explicit path spells it. The parameters live on the model and are updated
in place, as ``Solver`` does.

Tensor and expert parallelism (``param_sharding_rules``, and
:func:`moe_expert_parallel_rules`) run over a mesh such as
``make_mesh(data=2, model=2)``: rank ``(d, m)`` feeds the ``d``-th block of
rows of the global batch (the ranks of one model group feed the same rows)
and holds its shard of every matched param; ``parallel/tensor_parallel.py``
spells each layer over the shards. Gradients are all-reduced over ``data``
only, the updater works on the shards, and what reads a whole param (the
l1/l2 score, gradient normalization, the LARS/LAMB norms) sums the shards'
parts over the model group.

:class:`PipelineParallelTrainer` (below) splits the layer stack over a
``pipe`` axis and composes with ``data``; sequence parallelism is
``parallel/sequence.py``.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.dtypes import as_input, to_numpy
from ..nn.layers.base import DistContext
from ..nn.sequential import grads_of
from ..train.solver import LayerOptimizers, _normalize_gradients
from ..train.updaters import apply_updates
from .mesh import PartitionSpec, make_mesh, mesh_axis_size, zero1_partition_spec
from .strategies import GradientSyncStrategy, SyncAllReduce, pmean_flat, psum_flat
from .tensor_parallel import TensorParallelPlan

Tree = Dict[str, Dict[str, torch.Tensor]]


def moe_expert_parallel_rules(axis: str = "model",
                              layer_pattern: str = r".*") -> List[Tuple[str, PartitionSpec]]:
    """``param_sharding_rules`` for expert parallelism over ``axis``: every
    :class:`~deeplearning4j_tpu_torch.nn.layers.MixtureOfExpertsLayer`
    expert param (``We1``/``be1``/``We2``/``be2``, each with a leading
    ``E``) split over dim 0, the router ``Wg`` whole. Each rank of the axis
    then holds and computes ``E/n`` experts (``dispatch_mode`` "sort" or
    "grouped"), under any strategy, and composes with ``zero1=True``, whose
    slices of the other params' updater state stay on the data axis.
    ``layer_pattern`` narrows the match to some layer names (rules are
    matched against ``"layername/paramname"``)."""
    return [(rf"{layer_pattern}/(?:We1|be1|We2|be2)$", PartitionSpec(axis))]


def _map_state(node, fn, path=()):
    """``fn(path, tensor)`` over every tensor of an updater-state tree
    (dicts, tuples and NamedTuples), keeping its structure; host ints and
    other leaves stay."""
    if isinstance(node, torch.Tensor):
        return fn(path, node)
    if isinstance(node, dict):
        return {k: _map_state(v, fn, path + (k,)) for k, v in node.items()}
    if isinstance(node, tuple):
        items = [_map_state(v, fn, path + (i,)) for i, v in enumerate(node)]
        return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
    if isinstance(node, list):
        return [_map_state(v, fn, path + (i,)) for i, v in enumerate(node)]
    return node


def _state_leaves(node, out=None):
    """Every leaf of a state tree in order (tensors and host scalars)."""
    out = [] if out is None else out
    if isinstance(node, dict):
        for v in node.values():
            _state_leaves(v, out)
    elif isinstance(node, (tuple, list)):
        for v in node:
            _state_leaves(v, out)
    else:
        out.append(node)
    return out


class DistributedTrainer:
    """Data-parallel trainer for ``MultiLayerNetwork`` and
    ``ComputationGraph`` (anything with ``loss_pure(..., dist=)``, ``conf``
    and ``params``); every rank constructs one on its own replica of the
    model (the same weights: build from one seed or one zip).

    Parameters are the JAX package's: ``mesh`` (a ``DeviceMesh``; default
    :func:`make_mesh` over every rank on ``data``), ``strategy`` (default
    :class:`SyncAllReduce`), ``param_sharding_rules``, ``data_axis``,
    ``zero1``, ``bn_group_size`` (batch-norm statistics over groups of that
    many adjacent ranks; it must divide the data axis), ``registry`` and
    ``metrics_every``. ``donate_inputs`` is accepted and has no effect (an
    eager step keeps no buffers).

    ``param_sharding_rules`` are ``[(regex, PartitionSpec), ...]`` matched
    against ``"layername/paramname"``, first hit wins; unmatched params
    stay whole. As in the JAX package they need the default
    :class:`SyncAllReduce`, except expert-parallel rules (every spec
    ``P(axis)`` on dim 0 over one axis that is not the data axis, such as
    :func:`moe_expert_parallel_rules`), which the MoE layers spell under any
    strategy without per-replica persistent state. The JAX package's error
    for rules in a multi-process run has no counterpart: the port always
    runs one process per rank, and spells the layers over the shards.

    Under rules the model holds each rank's shards between steps:
    ``params`` reads the whole tensors (a collective), ``sync_to_model()``
    writes them into the model (the next ``fit_batch`` or ``output`` cuts
    the shards again), ``output(x)`` runs the sharded forward,
    ``gathered_updater_state()`` reads the updater state at global shapes
    and ``load_updater_state`` takes it so; ``opt_state`` is the rank's
    own (its shards, and under ZeRO-1 its slices).
    """

    def __init__(self, model, mesh=None, strategy: Optional[GradientSyncStrategy] = None,
                 param_sharding_rules=None, data_axis: str = "data",
                 donate_inputs: bool = False, zero1: bool = False,
                 bn_group_size: Optional[int] = None, registry=None,
                 metrics_every: int = 1) -> None:
        self.model = model
        self.donate_inputs = bool(donate_inputs)
        self.mesh = mesh if mesh is not None else make_mesh(
            device_type=torch.device(model.device).type)
        self.strategy = strategy or SyncAllReduce()
        self.data_axis = data_axis
        self.zero1 = bool(zero1)
        n = mesh_axis_size(self.mesh, data_axis)  # raises without the axis
        self.group = self.mesh.get_group(data_axis)
        self.rank = int(self.mesh.get_local_rank(data_axis))
        self.bn_group_size = None if bn_group_size is None else int(bn_group_size)
        if self.bn_group_size is not None and (
                self.bn_group_size < 1 or n % self.bn_group_size):
            raise ValueError(
                f"bn_group_size {self.bn_group_size} must divide the data "
                f"axis ({n} shards)")
        self._ep_axis = (self._resolve_ep_axis(param_sharding_rules)
                         if param_sharding_rules else None)
        if param_sharding_rules and self.strategy.explicit and self._ep_axis is None:
            raise ValueError(
                "param_sharding_rules (tensor parallelism) requires the "
                "default SyncAllReduce strategy — explicit strategies "
                "replicate params. Exception: expert-parallel rules "
                "(every spec P(axis) on dim 0 over one non-data axis, "
                "e.g. moe_expert_parallel_rules()) are spelled "
                "explicitly by the MoE layers.")
        if self.zero1 and not getattr(self.strategy, "replicated_grads", True):
            raise ValueError(
                "zero1 requires a strategy whose synced gradients are identical "
                "on every replica; ParameterAveragingSync applies purely local "
                "updates between sync points, so no replica may own a 1/N "
                "parameter slice")
        self.rules = [(re.compile(pat), spec) for pat, spec in (param_sharding_rules or [])]
        if self._ep_axis is not None and self.strategy.explicit:
            self._check_ep_divides()
        self._tp = (TensorParallelPlan(model, self.rules, self.mesh, data_axis)
                    if self.rules else None)
        self._held_whole = True
        self._hold_shards()
        self.dropped_rows = 0  # unshardable tail rows (see fit)
        self._stats_groups = self._make_stats_groups(n)
        self.optim = LayerOptimizers(model)
        self._zero1_flags = self._zero1_sliced_flags()
        reductions = self._tp.norm_reductions() if self._tp is not None else {}
        self._zoptim = (LayerOptimizers(model, zero1_axis=self.group,
                                        zero1_sliced=self._zero1_flags,
                                        tp_reductions=reductions)
                        if reductions or any(any(f.values()) for f in self._zero1_flags.values())
                        else self.optim)
        self.opt_state = self.optim.init(self._local_params())
        # the sync strategy sees this rank's shards: shape-derived layouts
        # are sized from them, and per-rank persistent state (error
        # feedback) would diverge across the expert axis
        self.strat_state = self.strategy.init_state(model.params)
        if self._ep_axis is not None and any(
                isinstance(v, torch.Tensor) and v.ndim > 0
                for v in _state_leaves(self.strat_state)):
            raise ValueError(
                "expert parallelism on the explicit path requires a sync "
                "strategy without per-replica persistent state (error "
                "feedback would diverge across expert shards); use "
                "BucketedAllReduceSync or SyncAllReduce")
        self.iteration = 0
        self.metrics_every = int(metrics_every)
        self._init_metrics(registry)

    # ----- layout ------------------------------------------------------
    @property
    def n_data_shards(self) -> int:
        return mesh_axis_size(self.mesh, self.data_axis)

    @property
    def params(self) -> Tree:
        """The model's live parameters (the trainer updates them in place);
        under ``param_sharding_rules``, their whole tensors gathered from
        the shards (a collective: every rank reads it)."""
        live = self.model.params
        if self._tp is None or self._held_whole:
            return live
        tp = self._tp
        return {ln: {pn: (p if tp.shard(ln, pn) is None else tp.full_value(p, tp.shard(ln, pn)))
                     for pn, p in lp.items()} for ln, lp in live.items()}

    @params.setter
    def params(self, tree) -> None:
        """Install whole params (a checkpoint's): each rank copies in its
        shards."""
        tp = self._tp
        with torch.no_grad():
            for ln, lp in self.model.params.items():
                for pn, p in lp.items():
                    v = tree[ln][pn]
                    v = (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                         ).to(device=p.device, dtype=p.dtype)
                    shard = None if tp is None or self._held_whole else tp.shard(ln, pn)
                    p.copy_(v if shard is None else tp.local(v, shard))

    # ----- tensor and expert parallelism --------------------------------
    def _resolve_ep_axis(self, rules) -> Optional[str]:
        """The expert-parallel mesh axis if every rule's spec is ``P(axis)``
        on dim 0 over one shared axis that is not the data axis; None
        otherwise."""
        axes = set()
        for _, spec in rules:
            entries = tuple(spec)
            if len(entries) != 1 or entries[0] is None or isinstance(entries[0], (tuple, list)):
                return None
            axes.add(entries[0])
        if len(axes) != 1:
            return None
        ax = axes.pop()
        if ax == self.data_axis or ax not in (self.mesh.mesh_dim_names or ()):
            return None
        return ax

    @property
    def ep_shards(self) -> int:
        """The expert-parallel width (1 without expert-parallel rules)."""
        return mesh_axis_size(self.mesh, self._ep_axis) if self._ep_axis else 1

    def _spec_for(self, path: str) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return PartitionSpec()

    def _check_ep_divides(self) -> None:
        """Explicit expert parallelism slices dim 0 of every matched param
        over the expert axis: it must divide."""
        n = self.ep_shards
        for ln, lp in self.model.params.items():
            for pn, p in lp.items():
                if tuple(self._spec_for(f"{ln}/{pn}")) and p.ndim and p.shape[0] % n:
                    raise ValueError(
                        f"expert-parallel param {ln}/{pn} dim 0 "
                        f"({p.shape[0]}) must divide the {self._ep_axis!r} "
                        f"axis ({n} shards)")

    def _hold_shards(self) -> None:
        """Cut every matched param to this rank's shard (the model holds the
        shards until ``sync_to_model``)."""
        if self._tp is None or not self._held_whole:
            return
        live = self.model.params
        with torch.no_grad():
            for ln, shards in self._tp.shards.items():
                for pn, shard in shards.items():
                    live[ln][pn].data = self._tp.local(live[ln][pn].data, shard)
        self._held_whole = False

    def _leaf_shard(self, lname: str, path, leaf):
        """The param shard an updater-state leaf follows: the state of a
        split param (keyed by its name), not one of its scalars."""
        if self._tp is None or not (isinstance(leaf, torch.Tensor) and leaf.ndim > 0
                                    and path and isinstance(path[-1], str)):
            return None
        return self._tp.shard(lname, path[-1])

    def param_bytes(self, *, per_rank: bool = True) -> int:
        """Param bytes this rank holds (its shards and the whole params),
        or with ``per_rank=False`` the whole model's."""
        total = 0
        for ln, lp in self.model.params.items():
            for pn, p in lp.items():
                shard = self._tp.shard(ln, pn) if self._tp is not None else None
                n = p.numel() if per_rank or shard is None or self._held_whole else shard.numel()
                total += n * p.element_size()
        return int(total)

    @property
    def state(self) -> Tree:
        return self.model.state

    @state.setter
    def state(self, value: Tree) -> None:
        self.model.state = value

    @property
    def data_sharding(self):
        """What a :class:`~deeplearning4j_tpu_torch.data.sharded.
        ShardedDataSetIterator` places a batch against: this rank's device
        and the data axis's width."""
        return (torch.device(self.model.device), self.n_data_shards)

    @property
    def _is_graph(self) -> bool:
        return hasattr(self.model.conf, "network_inputs")

    def _make_stats_groups(self, n: int) -> Dict[int, Any]:
        """For every group size that divides the data axis, the process
        group of this rank's adjacent replicas. ``new_group`` is collective:
        every rank creates every group, in the same order."""
        groups: Dict[int, Any] = {n: self.group}
        ranks = dist.get_process_group_ranks(self.group)
        for g in range(2, n):
            if n % g:
                continue
            for start in range(0, n, g):
                pg = dist.new_group(ranks[start:start + g])
                if start <= self.rank < start + g:
                    groups[g] = pg
        return groups

    def _dist_context(self) -> DistContext:
        return DistContext(axis=self.data_axis if self.strategy.explicit else None,
                           n_shards=self.n_data_shards, bn_group_size=self.bn_group_size,
                           rank=self.rank, groups=self._stats_groups,
                           ep_axis=self._ep_axis, ep_shards=self.ep_shards, tp=self._tp)

    def _zero1_sliced_flags(self) -> Dict[str, Dict[str, bool]]:
        """Per layer and param: does ZeRO-1 slice it? Dim 0 (of this rank's
        shard) divisible by the data axis and not split by a rule, the layer
        trained by an elementwise chain."""
        n = self.n_data_shards
        tp = self._tp
        out = {}
        for lname, lparams in self.model.params.items():
            ok = (self.zero1 and n > 1 and lname in self.optim.txs
                  and self.optim.elementwise.get(lname, False))
            out[lname] = {pn: bool(ok and zero1_partition_spec(
                tuple(p.shape), n, self.data_axis) != PartitionSpec()
                and (tp is None or tp.shard(lname, pn) is None
                     or tp.shard(lname, pn).axes[0] is None))
                for pn, p in lparams.items()}
        return out

    def _rows(self, size: int) -> slice:
        per = size // self.n_data_shards
        return slice(self.rank * per, (self.rank + 1) * per)

    def _local_params(self) -> Tree:
        """Each param, or this rank's dim-0 slice of it under ZeRO-1 (a view
        of the live parameter)."""
        return {ln: {pn: (p[self._rows(p.shape[0])] if self._zero1_flags[ln][pn] else p)
                     for pn, p in lp.items()}
                for ln, lp in self.model.params.items()}

    def _is_sliced(self, lname: str, path, leaf: torch.Tensor) -> bool:
        """An updater-state leaf is sliced when it is the state of a sliced
        param (keyed by the param's name) and not one of its scalars."""
        flags = self._zero1_flags.get(lname, {})
        return (leaf.ndim > 0 and bool(path) and isinstance(path[-1], str)
                and flags.get(path[-1], False))

    # ----- the step ----------------------------------------------------
    def _rank_generator(self) -> torch.Generator:
        """This step's dropout generator: the model's stream, with the rank
        folded in when there are several ranks (each holds other rows)."""
        gen = self.model._next_generator()
        if self.n_data_shards == 1:
            return gen
        seed = int(torch.randint(0, 2**62, (), generator=gen))
        return torch.Generator().manual_seed((seed + self.rank) % 2**63)

    def _prep_inputs(self, x, y):
        model = self.model
        if self._is_graph:
            xs = model._as_inputs(model._as_tuple(x))
            ys = model._as_labels(model._as_tuple(y))
            return xs, ys
        return model._input(x), as_input(y, model.dtype, True, model.device)

    def _step(self, x, y) -> torch.Tensor:
        model = self.model
        n = self.n_data_shards
        ctx = self._dist_context()
        rng = self._rank_generator()
        if self._is_graph:
            score, new_state = model.loss_pure(model.params, model.state, x, y, rng=rng,
                                               train=True, dist=ctx)
        else:
            score, (new_state, _) = model.loss_pure(model.params, model.state, x, y,
                                                    rng=rng, train=True, dist=ctx)
        grads = grads_of(score, model.params)
        score = score.detach()
        grads, self.strat_state = self.strategy.sync(grads, self.strat_state, self.group)
        conf = model.conf
        grads = _normalize_gradients(grads, conf.gradient_normalization,
                                     conf.gradient_normalization_threshold,
                                     sq_reduce=self._tp.reduce_sq_norms if self._tp else None)
        with torch.no_grad():
            if self._zoptim is not self.optim:
                self._zero1_update(grads)
            else:
                self.opt_state = self.optim.update(grads, self.opt_state, model.params)
            self.strategy.sync_params(model.params, self.iteration, self.group)
        state = {l: {k: v.detach() for k, v in st.items()} for l, st in new_state.items()}
        if n > 1:
            # the running statistics follow each rank's rows (or group):
            # average them so the replicas agree
            names = [(l, k) for l, st in state.items() for k, v in st.items()
                     if v.is_floating_point()]
            for (l, k), v in zip(names, pmean_flat([state[l][k] for l, k in names], self.group)):
                state[l][k] = v
            score = pmean_flat([score], self.group)[0]
        model.state = state
        return score

    def _zero1_update(self, grads: Tree) -> None:
        """The ZeRO-1 schedule: this rank's slice of each sliced param takes
        the update against its slice of the state; the slices are then
        all-gathered, one flat buffer per dtype."""
        flags = self._zero1_flags
        params = self.model.params
        params_l = self._local_params()
        grads_l = {ln: {pn: (g[self._rows(g.shape[0])] if flags[ln][pn] else g)
                        for pn, g in lg.items()}
                   for ln, lg in grads.items()}
        self.opt_state = self._zoptim.update(grads_l, self.opt_state, params_l)
        sliced = [params[ln][pn] for ln, lp in params.items() for pn in lp if flags[ln][pn]]
        _all_gather_rows(sliced, self.rank, self.n_data_shards, self.group)

    # ----- public API --------------------------------------------------
    def fit_batch(self, x, y) -> torch.Tensor:
        """One step on this rank's LOCAL rows (the global batch is the
        local batch on every rank); returns the score, the mean over the
        data axis, as a 0-dim tensor on the model's device."""
        model = self.model
        self._hold_shards()
        x, y = self._prep_inputs(x, y)
        first = x[0] if isinstance(x, tuple) else x
        model.last_batch_size = int(first.shape[0])
        self.iteration += 1
        score = self._step(x, y)
        self._record_compression()
        return score

    def fit(self, data, labels=None, *, epochs: int = 1) -> float:
        """Train on this rank's local rows: arrays or a DataSetIterator.

        Batches are re-chunked to one size, a multiple of the local shard
        count (one per rank): rows left over from a smaller batch are
        carried into the next, so no row vanishes. A final remainder
        smaller than that count would be dropped, counted in
        ``dropped_rows`` and warned about; with one shard per rank there is
        none."""
        from ..nn.sequential import _as_batches

        model = self.model
        n = 1  # the local shard count: one process per replica
        last = None
        sync = bool(model.listeners.listeners)
        for _ in range(epochs):
            model.listeners.epoch_start(model)
            carry_x: Optional[np.ndarray] = None
            carry_y: Optional[np.ndarray] = None
            emit: Optional[int] = None  # one chunk size for the whole epoch
            for feats, labs, _msk, _lmsk in _as_batches(data, labels, None):
                fx, fy = to_numpy(feats), to_numpy(labs)
                if carry_x is not None:
                    fx = np.concatenate([carry_x, fx])
                    fy = np.concatenate([carry_y, fy])
                    carry_x = carry_y = None
                if not emit:
                    emit = (fx.shape[0] // n) * n
                while emit and fx.shape[0] >= emit:
                    last = self.fit_batch(fx[:emit], fy[:emit])
                    fx, fy = fx[emit:], fy[emit:]
                    self._fit_iteration_done(sync, last)
                if fx.shape[0]:
                    carry_x, carry_y = fx, fy
            if carry_x is not None and carry_x.shape[0]:
                m = (carry_x.shape[0] // n) * n
                if m:
                    last = self.fit_batch(carry_x[:m], carry_y[:m])
                    self._fit_iteration_done(sync, last)
                left = carry_x.shape[0] - m
                if left:
                    self.dropped_rows += left
                    warnings.warn(
                        f"DistributedTrainer.fit: {left} tail row(s) smaller "
                        f"than the data axis ({n}) could not be sharded and "
                        f"were dropped this epoch (total {self.dropped_rows})")
            model.listeners.epoch_end(model)
            model.epoch_count += 1
        if last is not None:
            model.score_value = float(last)
        self.sync_to_model()
        return model.score_value

    def fit_iterator(self, iterator, *, epochs: int = 1) -> float:
        """Train from a ``DataSetIterator`` with no re-chunking: each batch
        (this rank's local rows, e.g. a :class:`~deeplearning4j_tpu_torch.
        data.sharded.ShardedDataSetIterator`'s, already on the device)
        feeds ``fit_batch`` as it comes. Consumption starts at the
        iterator's CURRENT position (a ``load_state_dict()`` resumes the
        interrupted epoch, which counts as the first of ``epochs``), and it
        is reset only when exhausted."""
        model = self.model
        sync = bool(model.listeners.listeners)
        last = None
        resumable = hasattr(iterator, "has_next")
        for _ in range(epochs):
            model.listeners.epoch_start(model)
            if resumable:
                if not iterator.has_next():
                    iterator.reset()
                while iterator.has_next():
                    ds = iterator.next().wait_ready()
                    last = self.fit_batch(ds.features, ds.labels)
                    self._fit_iteration_done(sync, last)
            else:
                for ds in iterator:
                    last = self.fit_batch(ds.features, ds.labels)
                    self._fit_iteration_done(sync, last)
            model.listeners.epoch_end(model)
            model.epoch_count += 1
        if last is not None:
            model.score_value = float(last)
        self.sync_to_model()
        return model.score_value

    def _fit_iteration_done(self, sync: bool, last) -> None:
        model = self.model
        model.iteration_count += 1
        if sync:
            if model.listeners.requires_score:
                model.score_value = float(last)
                score = model.score_value
            else:
                # score-free listeners must not force a per-step read
                score = float("nan")
            if model.listeners.requires_arrays:
                self.sync_to_model()
            model.listeners.iteration_done(
                model, model.iteration_count, model.epoch_count, score)

    def output(self, x):
        """Inference on this rank's local rows, after the replicas'
        parameters are reconciled (a collective: every rank calls it);
        under ``param_sharding_rules`` the forward over the shards."""
        self._reconcile_params()
        model = self.model
        if self._tp is None:
            return model.output(*model._as_tuple(x)) if self._is_graph else model.output(x)
        self._hold_shards()
        ctx = self._dist_context()
        with torch.no_grad():
            if self._is_graph:
                acts, _ = model.forward_pure(model.params, model.state,
                                             model._as_inputs(model._as_tuple(x)), dist=ctx)
                outs = tuple(acts[n].to(model.dtype) for n in model.conf.network_outputs)
                return outs[0] if len(outs) == 1 else outs
            out, _, _ = model.forward_pure(model.params, model.state, model._input(x), dist=ctx)
            return out.to(model.dtype)

    def _reconcile_params(self) -> None:
        """For strategies whose replicas drift between sync points
        (parameter averaging), average the params now: the averaging step
        taken out of schedule (the reference master's end-of-epoch
        aggregation)."""
        if not getattr(self.strategy, "params_diverge", False) or self.n_data_shards == 1:
            return
        params = self.model.params
        names = [(ln, pn) for ln, lp in params.items() for pn in lp]
        avg = pmean_flat([params[ln][pn] for ln, pn in names], self.group)
        with torch.no_grad():
            for (ln, pn), a in zip(names, avg):
                params[ln][pn].copy_(a)

    def sync_to_model(self) -> None:
        """The params and state already live on the model; under parameter
        averaging this first takes the final average, and under
        ``param_sharding_rules`` the model's params become the whole
        tensors (a collective)."""
        self._reconcile_params()
        if self._tp is None or self._held_whole:
            return
        live = self.model.params
        for ln, shards in self._tp.shards.items():
            for pn, shard in shards.items():
                live[ln][pn].data = self._tp.full_value(live[ln][pn], shard)
        self._held_whole = True

    def gathered_updater_state(self) -> Any:
        """The updater state at global shapes: the ZeRO-1 slices
        all-gathered, and the shards of split params' state (a collective:
        every rank calls it). This is what a checkpoint holds, valid at any
        data-axis width."""
        n = self.n_data_shards

        def full(lname):
            def fn(path, leaf):
                out = leaf
                if self._is_sliced(lname, path, leaf):
                    out = torch.empty((leaf.shape[0] * n,) + tuple(leaf.shape[1:]),
                                      dtype=leaf.dtype, device=leaf.device)
                    _gather_into(out, leaf.contiguous(), self.group)
                shard = self._leaf_shard(lname, path, leaf)
                return out if shard is None else self._tp.full_value(out, shard)
            return fn

        return {ln: _map_state(st, full(ln)) for ln, st in self.opt_state.items()}

    def load_updater_state(self, host_opt) -> None:
        """Put a restored updater state onto this trainer. ``host_opt`` holds
        GLOBAL-shape leaves (a zip checkpoint's, or
        :meth:`gathered_updater_state`'s); under ZeRO-1 each sliced leaf is
        cut to this rank's rows. Since the input is global-shape, it is
        valid whatever data-axis width wrote it: the elastic-resize restore
        path."""
        live_leaves = _state_leaves(self.opt_state)
        new_leaves = _state_leaves(host_opt)
        if len(new_leaves) != len(live_leaves):
            raise ValueError(
                "updater state structure mismatch: checkpoint has "
                f"{len(new_leaves)} leaves, trainer expects "
                f"{len(live_leaves)}: was the model/updater "
                "configuration changed between save and restore?")
        n = self.n_data_shards
        it = iter(new_leaves)
        counter = [0]

        def put(lname):
            def fn(path, live):
                new = next(it)
                i = counter[0]
                counter[0] += 1
                arr = new if isinstance(new, torch.Tensor) else torch.as_tensor(np.asarray(new))
                want = tuple(live.shape)
                shard = self._leaf_shard(lname, path, live)
                if shard is not None:
                    want = shard.shape
                elif self._is_sliced(lname, path, live):
                    want = (want[0] * n,) + want[1:]
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"updater state leaf {i} has global shape "
                        f"{tuple(arr.shape)}, trainer expects {want}: "
                        "checkpoint updater state must be saved at global "
                        "shape to restore onto a resized mesh")
                arr = arr.to(device=live.device, dtype=live.dtype)
                if shard is not None:
                    arr = self._tp.local(arr, shard)
                if self._is_sliced(lname, path, live):
                    arr = arr[self._rows(arr.shape[0])]
                return arr.clone()
            return fn

        def walk(lname, node, path=()):
            # host scalars (step counts) come from the checkpoint as well
            if isinstance(node, torch.Tensor):
                return put(lname)(path, node)
            if isinstance(node, dict):
                return {k: walk(lname, v, path + (k,)) for k, v in node.items()}
            if isinstance(node, tuple):
                items = [walk(lname, v, path + (i,)) for i, v in enumerate(node)]
                return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
            if isinstance(node, list):
                return [walk(lname, v, path + (i,)) for i, v in enumerate(node)]
            counter[0] += 1
            new = next(it)
            return type(node)(np.asarray(new).item()) if node is not None else new

        self.opt_state = {ln: walk(ln, st) for ln, st in self.opt_state.items()}

    # ----- observability -----------------------------------------------
    def _init_metrics(self, registry) -> None:
        from ..obs import get_registry

        self.registry = registry if registry is not None else get_registry()
        gauge = self.registry.gauge(
            "dl4j_tpu_training_updater_state_bytes",
            "Updater (optimizer) state bytes resident per data-parallel "
            "replica", labelnames=("sharded",))
        gauge.labels("true" if self.zero1 else "false").set(
            float(self.updater_state_bytes()))
        self._comp_hist = None
        if getattr(self.strategy, "compressed", False):
            self._comp_hist = self.registry.histogram(
                "dl4j_tpu_training_grad_compression_ratio",
                "Measured gradient-exchange compression ratio "
                "(elements per exchanged element) per recorded step",
                labelnames=("strategy",),
                buckets=(1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                         1000.0, 10000.0),
            ).labels(type(self.strategy).__name__)
        self._trust_gauge = self._gnorm_gauge = None
        if self._has_trust_state():
            self._trust_gauge = self.registry.gauge(
                "dl4j_tpu_training_trust_ratio",
                "Last recorded LARS/LAMB layer-wise trust ratio "
                "(||w||/||update||) per parameter tensor",
                labelnames=("layer",))
            self._gnorm_gauge = self.registry.gauge(
                "dl4j_tpu_training_grad_norm",
                "Last recorded per-parameter-tensor update norm (the "
                "trust-ratio denominator: grad/adam direction + decoupled "
                "weight decay)", labelnames=("layer",))

    def _trust_nodes(self):
        """(layer, state dict) of every trust-ratio updater state."""
        found = []

        def walk(node, lname):
            if isinstance(node, dict):
                if isinstance(node.get("trust"), dict):
                    found.append((lname, node))
                    return
                for v in node.values():
                    walk(v, lname)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v, lname)

        for lname, lstate in (self.opt_state or {}).items():
            walk(lstate, lname)
        return found

    def _has_trust_state(self) -> bool:
        return bool(self._trust_nodes())

    def trust_ratio_stats(self) -> dict:
        """``{"layer/param": {"trust_ratio", "update_norm"}}`` from a
        trust-ratio updater's state (Lars/Lamb); empty otherwise. Reads
        device scalars."""
        out = {}
        for lname, node in self._trust_nodes():
            gn = node.get("gnorm", {})
            for pn, v in node["trust"].items():
                entry = {"trust_ratio": float(v)}
                if pn in gn:
                    entry["update_norm"] = float(gn[pn])
                out[f"{lname}/{pn}"] = entry
        return out

    def _record_compression(self) -> None:
        if self.metrics_every <= 0 or self.iteration % self.metrics_every:
            return
        if self._comp_hist is not None:
            ratio = (self.compression_stats() or {}).get("compression_ratio")
            if ratio:
                self._comp_hist.observe(float(ratio))
        if self._trust_gauge is not None:
            for label, entry in self.trust_ratio_stats().items():
                self._trust_gauge.labels(label).set(entry["trust_ratio"])
                if "update_norm" in entry:
                    self._gnorm_gauge.labels(label).set(entry["update_norm"])

    def updater_state_bytes(self, *, per_replica: bool = True) -> int:
        """Bytes of updater state this rank holds (under ZeRO-1 its slices),
        or, with ``per_replica=False``, the global logical bytes."""
        total = [0]
        n = self.n_data_shards

        def count(lname):
            def fn(path, leaf):
                b = leaf.numel() * leaf.element_size()
                shard = None if per_replica else self._leaf_shard(lname, path, leaf)
                if shard is not None:
                    b = shard.numel() * leaf.element_size()
                elif not per_replica and self._is_sliced(lname, path, leaf):
                    b *= n
                total[0] += b
                return leaf
            return fn

        for ln, st in self.opt_state.items():
            _map_state(st, count(ln))
        return int(total[0])

    def compression_stats(self) -> Optional[dict]:
        """The strategy's compression view (threshold, measured density,
        ratio) or ``None`` for uncompressed strategies. Reads device
        scalars."""
        fn = getattr(self.strategy, "compression_stats", None)
        return fn(self.strat_state) if fn is not None else None

    def stats(self) -> dict:
        out = {
            "iteration": self.iteration,
            "dropped_rows": self.dropped_rows,
            "data_shards": self.n_data_shards,
            "strategy": type(self.strategy).__name__,
            "zero1": self.zero1,
            "bn_group_size": self.bn_group_size,
            "updater_state_bytes": self.updater_state_bytes(),
            "updater_state_bytes_global": self.updater_state_bytes(per_replica=False),
            "ep_shards": self.ep_shards,
            "sharded_params": sum(len(v) for v in self._tp.shards.values()) if self._tp else 0,
            "param_bytes": self.param_bytes(),
            "param_bytes_global": self.param_bytes(per_rank=False),
        }
        comp = self.compression_stats()
        if comp is not None:
            out["compression"] = comp
        return out

    def threshold_value(self) -> Optional[float]:
        """The current adaptive threshold, for a strategy that exposes one
        (``None`` otherwise, e.g. top-k compression)."""
        comp = self.compression_stats() or {}
        t = comp.get("threshold")
        if t is None and isinstance(self.strat_state, dict):
            t = self.strat_state.get("threshold")
        return None if t is None else float(t)


def _gather_into(out: torch.Tensor, mine: torch.Tensor, group) -> None:
    """``out`` = the ranks' ``mine`` concatenated along dim 0, in rank order
    (``all_gather_single``, the name of ``all_gather_into_tensor`` in newer
    torch releases)."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, mine, group=group)


def _all_gather_rows(params, rank: int, n: int, group) -> None:
    """Each param's dim-0 blocks all-gathered in place: this rank's block
    is current, the others are filled from their owners. One flat buffer
    per dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        per = [p.shape[0] // n for p in ps]
        mine = torch.cat([p[rank * s:(rank + 1) * s].reshape(-1) for p, s in zip(ps, per)])
        out = torch.empty((n * mine.numel(),), dtype=mine.dtype, device=mine.device)
        _gather_into(out, mine, group)
        chunks = out.view(n, -1)
        for r in range(n):
            if r == rank:
                continue
            off = 0
            for p, s in zip(ps, per):
                size = s * (p[0].numel() if p.ndim > 1 else 1)
                p[r * s:(r + 1) * s].copy_(chunks[r, off:off + size].view((s,) + tuple(p.shape[1:])))
                off += size


# ===========================================================================
# Pipeline-parallel training (PP × DP)
# ===========================================================================


def _rebuild(template, it):
    """``template``'s structure with each leaf the next of ``it``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, it) for k, v in template.items()}
    if isinstance(template, tuple):
        items = [_rebuild(v, it) for v in template]
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    if isinstance(template, list):
        return [_rebuild(v, it) for v in template]
    return next(it)


def _broadcast_leaves(leaves: list, src: int, group, device) -> list:
    """``leaves`` (tensors and host numbers) as rank ``src`` holds them, on
    every rank of ``group``: the other ranks pass templates of the same
    shapes and dtypes. One flat buffer per dtype; host numbers ride as one
    float64 tensor."""
    out = list(leaves)
    by_dtype: Dict[torch.dtype, list] = {}
    nums = []
    for j, v in enumerate(leaves):
        if isinstance(v, torch.Tensor):
            by_dtype.setdefault(v.dtype, []).append(j)
        elif isinstance(v, (bool, int, float, np.number)):
            nums.append(j)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([leaves[j].detach().reshape(-1).to(device) for j in idx])
        dist.broadcast(flat, src, group=group)
        off = 0
        for j in idx:
            n = leaves[j].numel()
            out[j] = flat[off:off + n].view(leaves[j].shape).clone()
            off += n
    if nums:
        flat = torch.tensor([float(leaves[j]) for j in nums], dtype=torch.float64, device=device)
        dist.broadcast(flat, src, group=group)
        for j, v in zip(nums, flat.tolist()):
            out[j] = type(leaves[j])(v)
    return out


class PipelineParallelTrainer:
    """Pipeline-parallel trainer (port of ``PipelineParallelTrainer`` in
    ``deeplearning4j_tpu/parallel/trainer.py``): the layer sequence split
    over a ``pipe`` mesh axis, microbatches streamed through the stages
    under a GPipe or 1F1B tick schedule, composing with data parallelism
    (and ZeRO-1) inside each stage across the ``data`` axis.

    One process per rank, as :class:`DistributedTrainer`: every rank
    builds the same model (one seed or one zip) and a trainer on it, over
    a mesh such as ``make_mesh(pipe=2, data=2)``. Rank ``(s, d)`` runs
    stage ``s`` on the ``d``-th block of rows of every microbatch.

    Layout: :func:`~deeplearning4j_tpu_torch.parallel.pipeline.partition_stages`
    splits the model into prelude (stage 0), periodic blocks and head
    (last stage). A rank keeps the parameters of its own stage's blocks
    and releases the others' storage (``stage_param_bytes``); prelude and
    head parameters are replicated on every rank (embeddings and heads:
    small) but computed on their owning stage only, so their gradients are
    summed over ``pipe``. :meth:`sync_to_model` brings every block back
    onto every rank's model.

    A step (:meth:`fit_batch`, on the GLOBAL batch, as in the JAX package)
    walks this rank's column of the tick tables
    (:func:`~deeplearning4j_tpu_torch.parallel.pipeline.run_pipeline_schedule`):
    each in-flight microbatch's stage input is stashed and the stage
    forward rerun under autograd at its backward tick. The loss is the last
    stage's sum times 1/M; prelude and head gradients are summed over
    ``pipe``, every gradient is averaged over ``data``; regularization and
    elementwise clipping come after, then the updaters (under ``zero1``,
    each rank updates its dim-0 slice and the slices are all-gathered over
    ``data``).

    The checkpoint surface (``params`` / ``opt_state`` / ``state``) speaks
    GLOBAL name-keyed trees structurally identical to the single-device
    model's, so checkpoints interchange with ``Solver`` and
    ``DistributedTrainer`` both ways; reading ``params`` or ``opt_state``
    is a collective (every rank calls it).

    Scope, with the JAX package's errors otherwise: sequential models or
    linear-chain graphs with a periodic middle; stateless layers;
    full-precision compute; no masks; gradient normalization NONE or
    elementwise clipping; elementwise updaters on block layers.
    """

    def __init__(self, model, mesh=None, *, n_micro: int = 8, schedule: str = "1f1b",
                 pipe_axis: str = "pipe", data_axis: str = "data", zero1: bool = False,
                 partition=None, registry=None, stage_time_probe: bool = True) -> None:
        from ..nn.conf import GradientNormalization as _GN
        from ..nn.layers.output import BaseOutputLayer
        from ..train.updaters import IUpdater, Sgd, updater_from_any
        from .pipeline import _model_units, build_pipeline_schedule, partition_stages

        if mesh is None:
            mesh = make_mesh(device_type=torch.device(model.device).type,
                             pipe=dist.get_world_size())
        names = tuple(mesh.mesh_dim_names or ())
        if pipe_axis not in names:
            raise ValueError(f"mesh has no {pipe_axis!r} axis: {names}")
        self.model = model
        self.mesh = mesh
        self.pipe_axis = pipe_axis
        self.data_axis = data_axis
        self.n_stages = mesh_axis_size(mesh, pipe_axis)
        self._n_data = mesh_axis_size(mesh, data_axis) if data_axis in names else 1
        self.stage = int(mesh.get_local_rank(pipe_axis))
        self.pipe_group = mesh.get_group(pipe_axis)
        self.data_rank = int(mesh.get_local_rank(data_axis)) if self._n_data > 1 else 0
        self.data_group = mesh.get_group(data_axis) if self._n_data > 1 else None
        ranks = mesh.mesh.flatten().tolist()
        self._all_group = (None if len(ranks) == dist.get_world_size()
                           else dist.new_group(sorted(ranks)))
        self.n_micro = int(n_micro)
        self.schedule = schedule
        self.zero1 = bool(zero1) and self._n_data > 1
        self.iteration = 0
        self._stage_probe_pending = bool(stage_time_probe)
        self.stage_times: Optional[list] = None
        self._boundaries: dict = {}
        #: set to a dict to time every tick's compute and exchange (fenced)
        self.clock: Optional[dict] = None

        model._check_init()
        conf = model.conf
        if getattr(conf, "compute_dtype", None):
            raise ValueError(
                "PipelineParallelTrainer does not support compute_dtype "
                "mixed precision yet — drop compute_dtype or use "
                "DistributedTrainer")
        if conf.gradient_normalization not in (_GN.NONE, _GN.CLIP_ELEMENT_WISE_ABSOLUTE_VALUE):
            raise ValueError(
                f"gradient normalization {conf.gradient_normalization} "
                "computes per-layer/param-type norms that would span the "
                "pipeline stages; use NONE or CLIP_ELEMENT_WISE_ABSOLUTE_VALUE")
        for name, st in model.state.items():
            if st:
                raise ValueError(
                    f"layer {name!r} carries persistent state "
                    f"({sorted(st)}): stateful layers (batch norm running "
                    "stats, MoE counters) do not pipeline here yet")

        self._units = _model_units(model)
        self._n_units = len(self._units)
        if not isinstance(self._units[-1][1], BaseOutputLayer):
            raise ValueError("the last layer must be an output/loss layer")
        self.partition = (partition if partition is not None
                          else partition_stages(model, self.n_stages))
        if self.partition.n_stages != self.n_stages:
            raise ValueError(
                f"partition is for {self.partition.n_stages} stages, mesh "
                f"{pipe_axis!r} axis has {self.n_stages}")
        self._sched = build_pipeline_schedule(self.n_stages, self.n_micro, schedule)

        part = self.partition
        self.optim = LayerOptimizers(model)
        global_upd = updater_from_any(conf.updater) if conf.updater is not None else Sgd()
        params = model.params
        for i0 in part.blocks[0]:
            name0, layer0, _ = self._units[i0]
            if not params.get(name0):
                continue
            upd = updater_from_any(layer0.updater) if layer0.updater is not None else global_upd
            # the JAX package stacks the blocks into [S, k] leaves, which a
            # per-tensor trust-ratio norm would span; its override of the
            # ZeRO-1 spelling marks that coupling
            coupled = (not getattr(upd, "elementwise", False)
                       or type(upd).to_transform_zero1 is not IUpdater.to_transform_zero1)
            if not layer0.frozen and coupled:
                raise ValueError(
                    f"block layer {name0!r} uses {type(upd).__name__}, "
                    "whose per-tensor (trust-ratio) norms would span the "
                    "stacked [S, k] pipeline leaves; use an elementwise "
                    "updater (Sgd/Adam/...) on block layers")

        # ---- ownership ---------------------------------------------------
        self._block_stage = {}  # unit index -> owning stage
        for b, blk in enumerate(part.blocks):
            s, _ = part.locate_block(b)
            for i in blk:
                self._block_stage[i] = s
        self._aux_names = [self._units[i][0] for i in (*part.prelude, *part.head)
                           if params.get(self._units[i][0])]
        self._own_units = [i for i in part.stage_units[self.stage] if i in self._block_stage]
        self._owned = list(self._aux_names) + [self._units[i][0] for i in self._own_units
                                               if params.get(self._units[i][0])]
        self._shapes = {ln: {pn: (tuple(p.shape), p.dtype) for pn, p in lp.items()}
                        for ln, lp in params.items()}
        self._released = False
        self._release_foreign_blocks()

        # ---- updater state (owned layers only; ZeRO-1 slices) -------------
        self._zero1_flags = {
            ln: {pn: bool(self.zero1 and self.optim.elementwise.get(ln, False)
                          and zero1_partition_spec(tuple(p.shape), self._n_data, data_axis)
                          != PartitionSpec())
                 for pn, p in params[ln].items()}
            for ln in self._owned}
        self._zoptim = (LayerOptimizers(model, zero1_axis=self.data_group,
                                        zero1_sliced=self._zero1_flags)
                        if any(any(f.values()) for f in self._zero1_flags.values())
                        else self.optim)
        local = self._local_params()
        self._opt = {ln: self.optim.txs[ln].init(local[ln]) for ln in self._owned
                     if ln in self.optim.txs}

        self._has_reg = any(getattr(layer, f, None) for _, layer, _ in self._units
                            for f in ("l1", "l2", "l1_bias", "l2_bias"))
        self._init_metrics(registry)

    # ------------------------------------------------------------ metrics
    def _init_metrics(self, registry) -> None:
        from ..obs import get_registry

        self.registry = registry if registry is not None else get_registry()
        self.registry.gauge(
            "dl4j_tpu_training_pipeline_bubble_share",
            "Fraction of pipeline stage-ticks idle under the tick "
            "schedule: (S-1)/(M+S-1) for GPipe and 1F1B both",
            labelnames=("schedule",)).labels(self.schedule).set(self._sched.bubble_share)
        self.registry.gauge(
            "dl4j_tpu_training_pipeline_resident_microbatches",
            "Peak per-stage stashed boundary activations (microbatches): "
            "min(S, M) under 1F1B vs M under GPipe",
            labelnames=("schedule",)).labels(self.schedule).set(self._sched.max_inflight)
        spg = self.registry.gauge(
            "dl4j_tpu_training_pipeline_stage_params",
            "Parameter count owned per pipeline stage (partition balance)",
            labelnames=("stage",))
        for s, c in enumerate(self.partition.stage_costs):
            spg.labels(str(s)).set(float(c))
        self._stage_time_gauge = self.registry.gauge(
            "dl4j_tpu_training_pipeline_stage_step_seconds",
            "Per-stage fold time of one microbatch (one-off probe at the "
            "first fit_batch): the schedule's tick length is the max over "
            "stages", labelnames=("stage",))

    # ------------------------------------------------------------ layout
    @property
    def n_data_shards(self) -> int:
        return self._n_data

    def _release_foreign_blocks(self) -> None:
        """Free the storage of the blocks other stages own: this rank holds
        its own stage's blocks only."""
        params = self.model.params
        with torch.no_grad():
            for i, s in self._block_stage.items():
                if s == self.stage:
                    continue
                for p in params[self._units[i][0]].values():
                    p.data = p.data.new_empty((0,))
        self._released = True

    def _rows(self, size: int) -> slice:
        per = size // self._n_data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def _local_params(self):
        """Each owned param, or this rank's dim-0 slice of it under ZeRO-1
        (a view of the live parameter)."""
        params = self.model.params
        return {ln: {pn: (p[self._rows(p.shape[0])] if self._zero1_flags[ln][pn] else p)
                     for pn, p in params[ln].items()}
                for ln in self._owned}

    def _is_sliced(self, lname: str, path, leaf) -> bool:
        flags = self._zero1_flags.get(lname, {})
        return (isinstance(leaf, torch.Tensor) and leaf.ndim > 0 and bool(path)
                and isinstance(path[-1], str) and flags.get(path[-1], False))

    # ---------------------------------------------------- layer folding
    def _generator(self, seed: int, m: int, i: int) -> torch.Generator:
        """The dropout generator of unit ``i`` on microbatch ``m`` this
        step: seeded from the step's draw, so the backward tick's rerun
        draws the forward tick's masks."""
        return torch.Generator().manual_seed(
            hash((seed, self.data_rank, m, i)) & ((1 << 63) - 1))

    def _apply_unit(self, i: int, h, seed: int, m: int):
        from ..nn.layers.base import LayerContext, apply_layer

        name, layer, preproc = self._units[i]
        ctx = LayerContext(train=True, rng=self._generator(seed, m, i), mask=None, dist=None)
        if preproc is not None:
            h, _ = preproc.apply({}, {}, h, ctx)
        y, _ = apply_layer(layer, self.model.params.get(name, {}), {}, h, ctx)
        return y

    def _fold_prelude(self, x, seed: int, m: int):
        h = x
        for i in self.partition.prelude:
            h = self._apply_unit(i, h, seed, m)
        return h

    def _fold_body(self, h, seed: int, m: int):
        for i in self._own_units:
            h = self._apply_unit(i, h, seed, m)
        return h

    def _fold_head_loss(self, h, y, seed: int, m: int):
        from ..nn.layers.base import LayerContext

        part = self.partition
        for i in part.head[:-1]:
            h = self._apply_unit(i, h, seed, m)
        i = part.head[-1]
        name, layer, preproc = self._units[i]
        ctx = LayerContext(train=True, rng=self._generator(seed, m, i), mask=None, dist=None)
        if preproc is not None:
            h, _ = preproc.apply({}, {}, h, ctx)
        loss = layer.compute_loss(self.model.params.get(name, {}), h, y, ctx)
        return loss.to(self._score_dtype)

    @property
    def _score_dtype(self) -> torch.dtype:
        return torch.promote_types(self.model.dtype, torch.float32)

    def _reg_score(self):
        """(aux regularization, this stage's blocks' regularization)."""
        from ..nn.sequential import _layer_reg_score

        params = self.model.params
        aux = torch.zeros((), dtype=self._score_dtype, device=self.model.device)
        body = torch.zeros_like(aux)
        for i, (name, layer, _) in enumerate(self._units):
            if not params.get(name):
                continue
            if i in self._block_stage:
                if self._block_stage[i] == self.stage:
                    body = body + _layer_reg_score(layer, params[name], self._score_dtype)
            else:
                aux = aux + _layer_reg_score(layer, params[name], self._score_dtype)
        return aux, body

    # ---------------------------------------------------------- the step
    def _inputs(self, x, y):
        model = self.model
        if hasattr(model.conf, "network_inputs"):
            x = model._as_inputs((x,))[0]
        else:
            x = model._input(x)
        return x, as_input(y, model.dtype, True, model.device)

    def _microbatches(self, x, y):
        B = int(x.shape[0])
        M, D = self.n_micro, self._n_data
        if B % M or (B // M) % D:
            raise ValueError(
                f"global batch {B} must split into n_micro={M} microbatches "
                f"of {D}-divisible size (data axis); got {B}/{M} = {B / M:g}")
        mb, per = B // M, B // M // D
        lo = self.data_rank * per
        xs = [x[m * mb + lo:m * mb + lo + per] for m in range(M)]
        ys = [y[m * mb + lo:m * mb + lo + per] for m in range(M)]
        return xs, ys

    def _boundary(self, x0):
        """(shape, dtype, device) of the activation between stages: the
        prelude's output on one row of a microbatch, run once per input
        shape."""
        key = (tuple(x0.shape), x0.dtype)
        if key not in self._boundaries:
            with torch.no_grad():
                h = self._fold_prelude(x0[:1], 0, 0)
            self._boundaries[key] = ((int(x0.shape[0]),) + tuple(h.shape[1:]), h.dtype, h.device)
        return self._boundaries[key]

    def _step(self, xs, ys):
        from .pipeline import run_pipeline_schedule

        model = self.model
        S, D, M = self.n_stages, self._n_data, self.n_micro
        seed = int(torch.randint(0, 2**62, (), generator=model._next_generator()))
        params = model.params
        owned = {ln: params[ln] for ln in self._owned}

        def fwd(p, m, xi):
            h = self._fold_prelude(xs[m], seed, m) if self.stage == 0 else xi
            return self._fold_body(h, seed, m)

        def lfn(p, h, m):
            return self._fold_head_loss(h, ys[m], seed, m)

        loss, grads = run_pipeline_schedule(fwd, lfn, owned, self._sched, self.pipe_group,
                                            self._boundary(xs[0]), self.clock)
        if self.stage != S - 1:
            loss = torch.zeros_like(loss)
        if self._has_reg:
            with torch.enable_grad():
                reg_aux, reg_body = self._reg_score()
                reg_grads = grads_of(reg_aux + reg_body, owned)
            reg_aux, reg_body = reg_aux.detach(), reg_body.detach()
        else:
            reg_aux = reg_body = torch.zeros_like(loss)
        inv = 1.0 / (M * D)
        # prelude/head grads live on one stage, zero elsewhere: one sum over
        # the whole mesh is the sum over pipe and the sum over data; the loss
        # (last stage) and the blocks' regularization ride along
        aux = [(ln, pn) for ln in self._aux_names for pn in grads[ln]]
        summed = psum_flat([grads[ln][pn] for ln, pn in aux] + [loss, reg_body],
                            self._all_group)
        for (ln, pn), g in zip(aux, summed):
            grads[ln][pn] = g * inv
        loss = summed[-2] * inv + reg_aux + summed[-1] / D
        body = [(ln, pn) for ln in self._owned if ln not in self._aux_names for pn in grads[ln]]
        if D > 1:
            for (ln, pn), g in zip(body, psum_flat([grads[ln][pn] for ln, pn in body],
                                                     self.data_group)):
                grads[ln][pn] = g * inv
        else:
            for ln, pn in body:
                grads[ln][pn] = grads[ln][pn] * inv
        if self._has_reg:
            grads = {ln: {pn: g + reg_grads[ln][pn] for pn, g in lg.items()}
                     for ln, lg in grads.items()}
        conf = model.conf
        grads = _normalize_gradients(grads, conf.gradient_normalization,
                                     conf.gradient_normalization_threshold)
        with torch.no_grad():
            self._update(grads)
        return loss

    def _update(self, grads) -> None:
        params = self.model.params
        local = self._local_params()
        flags = self._zero1_flags
        g_local = {ln: {pn: (g[self._rows(g.shape[0])] if flags[ln][pn] else g)
                        for pn, g in grads[ln].items()}
                   for ln in self._owned}
        new = {}
        for ln in self._owned:
            if ln not in self._zoptim.txs:
                continue
            upd, new[ln] = self._zoptim.txs[ln].update(g_local[ln], self._opt[ln], local[ln])
            apply_updates(local[ln], upd)
        self._opt = new
        sliced = [params[ln][pn] for ln in self._owned for pn in params[ln] if flags[ln][pn]]
        if sliced:
            _all_gather_rows(sliced, self.data_rank, self._n_data, self.data_group)

    # ------------------------------------------------------------- train
    def fit_batch(self, x, y) -> torch.Tensor:
        """One optimizer step on a GLOBAL batch, the same on every rank: split
        into ``n_micro`` microbatches along dim 0 (rank ``d`` of the data
        axis takes the ``d``-th block of rows of each), streamed through the
        stages under the tick schedule. Returns the score (loss +
        regularization) on every rank, equal to the single-device Solver's
        at the same global batch."""
        x, y = self._inputs(x, y)
        xs, ys = self._microbatches(x, y)
        if not self._released:
            self._release_foreign_blocks()
        if self._stage_probe_pending:
            self._probe(xs, ys)
        self.model.last_batch_size = int(x.shape[0])
        loss = self._step(xs, ys)
        self.iteration += 1
        return loss

    def fit(self, x, y, *, batch_size: int, epochs: int = 1):
        """Minimal epoch loop over host arrays (shuffling and iterators stay
        the caller's). Returns the last score."""
        n = int(np.shape(x)[0])
        loss = None
        for _ in range(int(epochs)):
            for lo in range(0, n - batch_size + 1, batch_size):
                loss = self.fit_batch(x[lo:lo + batch_size], y[lo:lo + batch_size])
        return loss

    def probe_stage_times(self, x, y) -> list:
        """Time each stage's fold of one microbatch (its blocks, with the
        prelude on stage 0 and the head and loss on the last), fenced by the
        device, after one untimed fold: every rank times its own stage and
        the times are all-gathered over ``pipe``. Feeds the
        ``dl4j_tpu_training_pipeline_stage_step_seconds`` gauge; the
        schedule's tick length is the max over stages. Runs at the first
        :meth:`fit_batch` unless called before (a collective)."""
        xs, ys = self._microbatches(*self._inputs(x, y))
        return self._probe(xs, ys)

    def _probe(self, xs, ys) -> list:
        import time as _time

        from ..obs.step_profiler import fence

        self._stage_probe_pending = False
        dev = self.model.device
        last = self.stage == self.n_stages - 1
        with torch.no_grad():
            h0 = self._fold_prelude(xs[0], 0, 0) if self.stage > 0 else None

            def fold():
                h = self._fold_prelude(xs[0], 0, 0) if self.stage == 0 else h0
                h = self._fold_body(h, 0, 0)
                return self._fold_head_loss(h, ys[0], 0, 0) if last else h

            fold()
            fence(dev)
            t0 = _time.perf_counter()
            fold()
            fence(dev)
            mine = torch.tensor([_time.perf_counter() - t0], dtype=torch.float64, device=dev)
        parts = [torch.empty_like(mine) for _ in range(self.n_stages)]
        dist.all_gather(parts, mine, group=self.pipe_group)
        self.stage_times = [float(p) for p in parts]
        for s, v in enumerate(self.stage_times):
            self._stage_time_gauge.labels(str(s)).set(v)
        return self.stage_times

    # ------------------------------------------- checkpoint-facing views
    def _stage_layers(self, s: int) -> list:
        """The names of stage ``s``'s block layers that have params."""
        return [self._units[i][0] for i in self.partition.stage_units[s]
                if self._block_stage.get(i) == s and self._shapes[self._units[i][0]]]

    def _gather_blocks(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Every stage's block params, broadcast from their owners over the
        pipe group (a collective)."""
        params = self.model.params
        dev = self.model.device
        out = {}
        for s in range(self.n_stages):
            names = self._stage_layers(s)
            keys = [(ln, pn) for ln in names for pn in self._shapes[ln]]
            if s == self.stage:
                leaves = [params[ln][pn].detach() for ln, pn in keys]
            else:
                leaves = [torch.empty(self._shapes[ln][pn][0], dtype=self._shapes[ln][pn][1], device=dev)
                          for ln, pn in keys]
            if self.n_stages > 1 and keys:
                leaves = _broadcast_leaves(leaves, dist.get_global_rank(self.pipe_group, s),
                                           self.pipe_group, dev)
            for (ln, pn), v in zip(keys, leaves):
                out.setdefault(ln, {})[pn] = v
        return out

    @property
    def params(self):
        """GLOBAL name-keyed params, structurally identical to
        ``model.params`` (a collective: every stage's blocks are broadcast
        from their owners)."""
        blocks = self._gather_blocks()
        live = self.model.params
        out = {}
        for i, (name, _, _) in enumerate(self._units):
            if i in self._block_stage:
                own = self._block_stage[i] == self.stage
                out[name] = dict(live[name]) if own else blocks.get(name, {})
            else:
                out[name] = dict(live.get(name, {}))
        return out

    @params.setter
    def params(self, tree) -> None:
        """Install GLOBAL params: this rank copies in the prelude, head and
        its own stage's blocks."""
        live = self.model.params
        with torch.no_grad():
            for ln in self._owned:
                for pn, p in live[ln].items():
                    v = tree[ln][pn]
                    v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                    p.copy_(v.to(device=p.device, dtype=p.dtype))

    def _global_opt_template(self) -> Dict[str, Any]:
        """The per-layer updater state at global shapes, on the meta device
        (structure and shapes only)."""
        return {ln: tx.init({pn: torch.empty(shape, dtype=dt, device="meta")
                             for pn, (shape, dt) in self._shapes[ln].items()})
                for ln, tx in self.optim.txs.items()}

    def _owned_global_state(self, ln: str):
        """This rank's state of an owned layer at global shapes (ZeRO-1
        slices all-gathered over ``data``: a collective)."""
        n = self._n_data

        def fn(path, leaf):
            if not self._is_sliced(ln, path, leaf):
                return leaf
            out = torch.empty((leaf.shape[0] * n,) + tuple(leaf.shape[1:]),
                              dtype=leaf.dtype, device=leaf.device)
            _gather_into(out, leaf.contiguous(), self.data_group)
            return out

        return _map_state(self._opt[ln], fn)

    @property
    def opt_state(self):
        """GLOBAL per-layer updater state, ``{layer: state}`` as
        ``LayerOptimizers`` lays it out (the checkpoint format): a
        collective, every block layer's state broadcast from its owner."""
        dev = self.model.device
        template = self._global_opt_template()
        out = {ln: self._owned_global_state(ln) for ln in self._owned if ln in self._opt}
        for s in range(self.n_stages):
            names = [ln for ln in self._stage_layers(s) if ln in template]
            if not names or self.n_stages == 1:
                continue
            if s == self.stage:
                leaves = [v for ln in names for v in _state_leaves(out[ln])]
            else:
                leaves = [torch.empty(v.shape, dtype=v.dtype, device=dev)
                          if isinstance(v, torch.Tensor) else v
                          for ln in names for v in _state_leaves(template[ln])]
            got = iter(_broadcast_leaves(leaves, dist.get_global_rank(self.pipe_group, s),
                                         self.pipe_group, dev))
            for ln in names:
                out[ln] = _rebuild(template[ln], got)
        return {ln: out[ln] for ln in template}

    @opt_state.setter
    def opt_state(self, tree) -> None:
        self.load_updater_state(tree)

    def load_updater_state(self, host_opt) -> None:
        """Install an updater-state tree saved by ANY trainer (global
        per-layer shapes: ``Solver``, ``DistributedTrainer`` with or without
        ZeRO-1, or a differently staged ``PipelineParallelTrainer``): this
        rank takes its owned layers' states, cut to its ZeRO-1 slices."""
        template = self._global_opt_template()
        live = _state_leaves(template)
        new = _state_leaves(host_opt)
        if len(live) != len(new):
            raise ValueError(
                f"updater state leaf count mismatch: checkpoint has "
                f"{len(new)}, trainer expects {len(live)}")
        for a, b in zip(live, new):
            if isinstance(a, torch.Tensor) and tuple(np.shape(b)) != tuple(a.shape):
                raise ValueError(
                    f"updater state leaf shape mismatch: {tuple(np.shape(b))} vs "
                    f"expected {tuple(a.shape)} — was this saved with "
                    "different GLOBAL shapes?")
        for ln in self._opt:
            it = iter(_state_leaves(host_opt[ln]))

            def put(node, path=(), ln=ln, it=it):
                if isinstance(node, dict):
                    return {k: put(v, path + (k,)) for k, v in node.items()}
                if isinstance(node, tuple):
                    items = [put(v, path + (j,)) for j, v in enumerate(node)]
                    return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
                if isinstance(node, list):
                    return [put(v, path + (j,)) for j, v in enumerate(node)]
                v = next(it)
                if isinstance(node, torch.Tensor):
                    arr = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                    arr = arr.to(device=node.device, dtype=node.dtype)
                    if self._is_sliced(ln, path, node):
                        arr = arr[self._rows(arr.shape[0])]
                    return arr.clone()
                return type(node)(np.asarray(v).item()) if node is not None else v

            self._opt[ln] = put(self._opt[ln])

    @property
    def state(self):
        """Per-layer persistent state: empty by construction (stateless
        layers only), so this is the model's empty-dict tree."""
        return {name: {} for name in self.model.state}

    @state.setter
    def state(self, tree) -> None:
        pass  # stateless by construction

    # ------------------------------------------------- trainer interop
    def sync_to_model(self) -> None:
        """Write every stage's blocks back into this rank's model (a
        collective): afterwards the model holds the global params, as a
        checkpoint or a non-PP trainer reads them. The next ``fit_batch``
        releases the other stages' blocks again."""
        blocks = self._gather_blocks()
        live = self.model.params
        with torch.no_grad():
            for ln, lp in blocks.items():
                for pn, v in lp.items():
                    if live[ln][pn].numel() != v.numel():
                        live[ln][pn].data = v.clone()
        self._released = False

    def stage_param_bytes(self, *, per_device: bool = True) -> int:
        """Trainable-param bytes this rank holds (its own stage's blocks plus
        the replicated prelude and head), or with ``per_device=False`` the
        whole model's."""
        total = 0
        for i, (ln, _, _) in enumerate(self._units):
            if per_device and i in self._block_stage and self._block_stage[i] != self.stage:
                continue
            for shape, dt in self._shapes.get(ln, {}).values():
                total += int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
        return int(total)

    def stats(self) -> dict:
        return {
            "iteration": self.iteration,
            "schedule": self.schedule,
            "n_stages": self.n_stages,
            "n_micro": self.n_micro,
            "data_shards": self._n_data,
            "zero1": self.zero1,
            "bubble_share": self._sched.bubble_share,
            "resident_microbatches": self._sched.max_inflight,
            "stage_costs": list(self.partition.stage_costs),
            "stage_param_bytes": self.stage_param_bytes(),
            "stage_param_bytes_global": self.stage_param_bytes(per_device=False),
            "stage_times": self.stage_times,
        }
