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

Tensor parallelism (``param_sharding_rules``) and explicit expert
parallelism (``moe_expert_parallel_rules``) are ROADMAP A8 part 2.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.dtypes import as_input, to_numpy
from ..nn.layers.base import DistContext
from ..nn.sequential import grads_of
from ..train.solver import LayerOptimizers, _normalize_gradients
from .mesh import PartitionSpec, make_mesh, mesh_axis_size, zero1_partition_spec
from .strategies import GradientSyncStrategy, SyncAllReduce, pmean_flat

Tree = Dict[str, Dict[str, torch.Tensor]]


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
    :class:`SyncAllReduce`), ``data_axis``, ``zero1``, ``bn_group_size``
    (batch-norm statistics over groups of that many adjacent ranks; it must
    divide the data axis), ``registry`` and ``metrics_every``.
    ``donate_inputs`` is accepted and has no effect (an eager step keeps no
    buffers). ``param_sharding_rules`` (tensor and expert parallelism)
    raises: ROADMAP A8 part 2.
    """

    def __init__(self, model, mesh=None, strategy: Optional[GradientSyncStrategy] = None,
                 param_sharding_rules=None, data_axis: str = "data",
                 donate_inputs: bool = False, zero1: bool = False,
                 bn_group_size: Optional[int] = None, registry=None,
                 metrics_every: int = 1) -> None:
        if param_sharding_rules:
            raise ValueError(
                "param_sharding_rules (tensor parallelism, and the expert "
                "parallelism of moe_expert_parallel_rules) is not ported: the "
                "port's DistributedTrainer is data-parallel (ROADMAP A8 part 2)")
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
        if self.zero1 and not getattr(self.strategy, "replicated_grads", True):
            raise ValueError(
                "zero1 requires a strategy whose synced gradients are identical "
                "on every replica; ParameterAveragingSync applies purely local "
                "updates between sync points, so no replica may own a 1/N "
                "parameter slice")
        self.dropped_rows = 0  # unshardable tail rows (see fit)
        self._stats_groups = self._make_stats_groups(n)
        self.optim = LayerOptimizers(model)
        self._zero1_flags = self._zero1_sliced_flags()
        self._zoptim = (LayerOptimizers(model, zero1_axis=self.group,
                                        zero1_sliced=self._zero1_flags)
                        if any(any(f.values()) for f in self._zero1_flags.values())
                        else self.optim)
        self.opt_state = self.optim.init(self._local_params())
        self.strat_state = self.strategy.init_state(model.params)
        self.iteration = 0
        self.metrics_every = int(metrics_every)
        self._init_metrics(registry)

    # ----- layout ------------------------------------------------------
    @property
    def n_data_shards(self) -> int:
        return mesh_axis_size(self.mesh, self.data_axis)

    @property
    def params(self) -> Tree:
        """The model's live parameters (the trainer updates them in place)."""
        return self.model.params

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
                           rank=self.rank, groups=self._stats_groups)

    def _zero1_sliced_flags(self) -> Dict[str, Dict[str, bool]]:
        """Per layer and param: does ZeRO-1 slice it? Dim 0 divisible by
        the data axis, the layer trained by an elementwise chain."""
        n = self.n_data_shards
        out = {}
        for lname, lparams in self.model.params.items():
            ok = (self.zero1 and n > 1 and lname in self.optim.txs
                  and self.optim.elementwise.get(lname, False))
            out[lname] = {pn: bool(ok and zero1_partition_spec(
                tuple(p.shape), n, self.data_axis) != PartitionSpec())
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
                                     conf.gradient_normalization_threshold)
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
        parameters are reconciled (a collective: every rank calls it)."""
        self._reconcile_params()
        if self._is_graph:
            return self.model.output(*self.model._as_tuple(x))
        return self.model.output(x)

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
        averaging this first takes the final average."""
        self._reconcile_params()

    def gathered_updater_state(self) -> Any:
        """The updater state at global shapes: the ZeRO-1 slices
        all-gathered (a collective: every rank calls it). This is what a
        checkpoint holds, valid at any data-axis width."""
        n = self.n_data_shards

        def full(lname):
            def fn(path, leaf):
                if not self._is_sliced(lname, path, leaf):
                    return leaf
                out = torch.empty((leaf.shape[0] * n,) + tuple(leaf.shape[1:]),
                                  dtype=leaf.dtype, device=leaf.device)
                _gather_into(out, leaf.contiguous(), self.group)
                return out
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
                if self._is_sliced(lname, path, live):
                    want = (want[0] * n,) + want[1:]
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"updater state leaf {i} has global shape "
                        f"{tuple(arr.shape)}, trainer expects {want}: "
                        "checkpoint updater state must be saved at global "
                        "shape to restore onto a resized mesh")
                arr = arr.to(device=live.device, dtype=live.dtype)
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
                if not per_replica and self._is_sliced(lname, path, leaf):
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
