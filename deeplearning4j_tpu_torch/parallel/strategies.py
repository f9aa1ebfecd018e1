"""Gradient synchronization strategies (port of
``deeplearning4j_tpu/parallel/strategies.py``).

Reference semantics (the reference's ``ParallelWrapper`` /
``SharedTrainingMaster`` sync modes): parameter averaging every N
iterations, or per-iteration encoded-gradient sharing (Strom 2015:
threshold quantization, residual error feedback, adaptive threshold).
They are synchronous collectives, as in the JAX package.

The JAX strategies run inside ``shard_map`` and bind the data axis by
name. In the port every rank runs its own step, and ``sync(grads, state,
group)`` spells the same collectives with ``torch.distributed`` over the
data axis's process group: ``pmean`` is an ``all_reduce`` (sum) divided
by the group's size. ``grads`` and the strategy state are
``{layer: {param: tensor}}`` trees on the model's device.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

Tree = Dict[str, Dict[str, torch.Tensor]]


def _natural_key(s: str):
    """layer_10 sorts after layer_9 (the model's depth order), not after
    layer_1: bucket packing follows true layer order."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _pmean_(t: torch.Tensor, group) -> torch.Tensor:
    """In place: the mean of ``t`` over ``group``'s ranks."""
    dist.all_reduce(t, group=group)
    return t.div_(dist.get_world_size(group))


def _flat_all_reduce(tensors: List[torch.Tensor], group, mean: bool) -> List[torch.Tensor]:
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = (tensors[idx[0]].detach().reshape(-1).clone() if len(idx) == 1
                else torch.cat([tensors[i].detach().reshape(-1) for i in idx]))
        if mean:
            _pmean_(flat, group)
        else:
            dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def pmean_flat(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean over ``group`` of each tensor, exchanged as one flat buffer
    per dtype (one collective for a whole tree of one dtype, as the JAX
    package's fused all-reduce is). Returns new tensors."""
    return _flat_all_reduce(tensors, group, mean=True)


def psum_flat(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The sum over ``group`` of each tensor, as :func:`pmean_flat`
    exchanges it."""
    return _flat_all_reduce(tensors, group, mean=False)


def _leaves(tree: Tree) -> List[Tuple[str, str]]:
    return [(ln, pn) for ln, lt in tree.items() for pn in lt]


def _zeros_tree(tree: Tree) -> Tree:
    return {ln: {pn: torch.zeros_like(t) for pn, t in lt.items()} for ln, lt in tree.items()}


class GradientSyncStrategy:
    """SPI: how per-replica gradients become the applied update."""

    #: strategies that take the explicit path set this (each replica
    #: normalizes by its own rows; see ``DistributedTrainer``)
    explicit = True
    #: True when replicas' params may disagree between sync points, so the
    #: trainer must all-reduce params before exporting or serving them
    params_diverge = False
    #: True when ``sync`` returns the SAME gradients on every replica. ZeRO-1
    #: needs it: a replica may update only its 1/N slice of the params if
    #: the gradients it applies agree with every other replica's.
    replicated_grads = True
    #: True for strategies that compress what crosses the wire; the trainer
    #: records dl4j_tpu_training_grad_compression_ratio for these
    compressed = False

    def init_state(self, params: Any) -> Any:
        return ()

    def sync(self, grads: Tree, state: Any, group) -> Tuple[Tree, Any]:
        raise NotImplementedError

    def sync_params(self, params: Tree, iteration: int, group) -> None:
        """Hook applied to the params after the local update, in place
        (parameter averaging). Default: nothing."""

    def compression_stats(self, state: Any) -> Optional[Dict[str, Any]]:
        """Host view of the compression state (reads the device scalars).
        ``None`` for uncompressed strategies; compressed ones give at least
        ``density`` (the share of elements exchanged last step) and
        ``compression_ratio`` (``None`` before the first sync)."""
        return None


class SyncAllReduce(GradientSyncStrategy):
    """Default: the mean of the gradients over the data axis every step,
    one all-reduce per dtype. ``explicit=False`` marks the JAX package's
    implicit path, whose step sees the global batch: the trainer then
    takes batch-norm moments over every replica's rows."""

    explicit = False

    def sync(self, grads, state, group):
        names = _leaves(grads)
        synced = pmean_flat([grads[ln][pn] for ln, pn in names], group)
        out: Tree = {ln: {} for ln in grads}
        for (ln, pn), g in zip(names, synced):
            out[ln][pn] = g
        return out, state


class BucketedAllReduceSync(GradientSyncStrategy):
    """Gradient exchange in fixed-byte buckets, packed in REVERSE layer
    order (the output layer first, the order in which gradients appear in
    the backward pass), each bucket all-reduced as its own collective.

    Per-bucket collectives each depend only on their own layers' gradients,
    so a scheduler can start the output-side exchange while the input-side
    backward runs (MLPerf TPU-pods paper, "gradient summation"). The sum of
    a concatenation is the concatenation of the sums, so at two ranks the
    result is :class:`SyncAllReduce`'s bit for bit; with more ranks a ring
    all-reduce may add in another order for another packing.

    ``bucket_bytes`` trades overlap against per-collective latency; a leaf
    larger than the budget gets a bucket of its own (leaves are never
    split). The layout is sized from the param template at ``init_state``
    and held on the instance: use one instance per trainer.
    """

    explicit = True
    replicated_grads = True

    def __init__(self, bucket_bytes: int = 4 << 20) -> None:
        if bucket_bytes <= 0:
            raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
        self.bucket_bytes = int(bucket_bytes)
        # [(dtype, [(layer, param, shape, size), ...]), ...], from the template
        self._buckets: Optional[List[Tuple[torch.dtype, List[Tuple[str, str, Tuple[int, ...], int]]]]] = None

    def init_state(self, params):
        buckets = []
        fill: Dict[torch.dtype, int] = {}
        open_bucket: Dict[torch.dtype, list] = {}
        for ln in sorted(params, key=_natural_key, reverse=True):
            for pn in sorted(params[ln], key=_natural_key):
                leaf = params[ln][pn]
                shape = tuple(leaf.shape)
                size = int(np.prod(shape, dtype=np.int64)) if shape else 1
                dt = leaf.dtype
                nbytes = size * leaf.element_size()
                cur = open_bucket.get(dt)
                if cur is not None and fill[dt] + nbytes > self.bucket_bytes:
                    buckets.append((dt, cur))
                    cur = None
                if cur is None:
                    cur = []
                    open_bucket[dt] = cur
                    fill[dt] = 0
                cur.append((ln, pn, shape, size))
                fill[dt] += nbytes
        for dt, cur in open_bucket.items():
            if cur:
                buckets.append((dt, cur))
        self._buckets = buckets
        return ()

    def sync(self, grads, state, group):
        if self._buckets is None:
            self.init_state(grads)
        out: Tree = {ln: {} for ln in grads}
        for _, bucket in self._buckets:
            if len(bucket) == 1:
                ln, pn, _, _ = bucket[0]
                out[ln][pn] = _pmean_(grads[ln][pn].detach().clone(), group)
                continue
            flat = _pmean_(torch.cat([grads[ln][pn].detach().reshape(-1)
                                      for ln, pn, _, _ in bucket]), group)
            off = 0
            for ln, pn, shape, size in bucket:
                out[ln][pn] = flat[off:off + size].view(shape)
                off += size
        return out, state

    def compression_stats(self, state):
        """Not compression: the bucket layout, that is how many collectives
        the exchange issues and the bytes each carries (``None`` before
        ``init_state``)."""
        if self._buckets is None:
            return None
        volumes = [sum(size for _, _, _, size in bucket) * torch.empty((), dtype=dt).element_size()
                   for dt, bucket in self._buckets]
        return {
            "buckets": len(self._buckets),
            "bucket_bytes_target": self.bucket_bytes,
            "bucket_volume_bytes": volumes,
            "total_exchanged_bytes": int(sum(volumes)),
        }


class ThresholdCompressedSync(GradientSyncStrategy):
    """Strom-style threshold encoding with residual error feedback.

    Per element: add the gradient to the residual; where ``|r| >= t`` emit
    ``sign(r) * t`` and subtract it from the residual; the emitted tensor
    is what is exchanged (all-reduced here). The threshold adapts toward a
    target update density from the density measured over the whole data
    axis, so every replica quantizes at the same magnitude (the reference's
    ``AdaptiveThresholdAlgorithm``). The exchanged tensor stays dense; the
    value is the convergence behaviour of compressed sharing.

    State: ``{"residual", "threshold", "density"}``, ``threshold`` and
    ``density`` float32 scalars on the device.
    """

    compressed = True

    def __init__(self, threshold: float = 1e-3, target_density: float = 1e-3,
                 adapt_rate: float = 1.05, min_threshold: float = 1e-11,
                 max_threshold: float = 1.0) -> None:
        self.threshold = float(threshold)
        self.target_density = float(target_density)
        self.adapt_rate = float(adapt_rate)
        self.min_threshold = float(min_threshold)
        self.max_threshold = float(max_threshold)

    def init_state(self, params):
        dev = next((t.device for lt in params.values() for t in lt.values()), None)
        return {
            "residual": _zeros_tree(params),
            "threshold": torch.tensor(self.threshold, dtype=torch.float32, device=dev),
            "density": torch.zeros((), dtype=torch.float32, device=dev),
        }

    def sync(self, grads, state, group):
        t = state["threshold"]
        names = _leaves(grads)
        encoded, new_residual = [], {ln: {} for ln in grads}
        n_set = torch.zeros((), dtype=torch.float32, device=t.device)
        n_total = 0
        for ln, pn in names:
            g = grads[ln][pn].detach()
            acc = g + state["residual"][ln][pn]
            enc = torch.where(torch.abs(acc) >= t, torch.sign(acc) * t,
                              torch.zeros((), dtype=acc.dtype, device=acc.device)).to(g.dtype)
            encoded.append(enc)
            new_residual[ln][pn] = acc - enc
            n_set = n_set + torch.sum((enc != 0).to(torch.float32))
            n_total += enc.numel()
        # the density over the whole axis: replicas must agree on the
        # threshold's trajectory
        density = _pmean_(n_set / max(n_total, 1), group)
        new_t = torch.where(density > self.target_density, t * self.adapt_rate,
                            t / self.adapt_rate)
        new_t = torch.clamp(new_t, self.min_threshold, self.max_threshold)
        synced = pmean_flat(encoded, group)
        out: Tree = {ln: {} for ln in grads}
        for (ln, pn), e in zip(names, synced):
            out[ln][pn] = e
        return out, {"residual": new_residual, "threshold": new_t, "density": density}

    def compression_stats(self, state):
        d = float(state["density"]) if "density" in state else 0.0
        return {
            "threshold": float(state["threshold"]),
            "density": d,
            "compression_ratio": (1.0 / d) if d > 0 else None,
        }


class TopKCompressedSync(GradientSyncStrategy):
    """Top-k sparsification with residual error feedback.

    Per leaf: add the gradient to the residual, exchange only the ``k =
    round(density * size)`` (at least 1) largest-magnitude entries (ties at
    the k-th magnitude are all kept, so the realized density can exceed the
    target; an all-zero accumulator selects nothing) and feed the rest back
    as residual: ``exchanged + new_residual == grad + old_residual`` every
    step. The exchanged volume is fixed per step, unlike the threshold
    strategy's.
    """

    compressed = True

    def __init__(self, density: float = 0.01) -> None:
        if not 0.0 < density <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {density}")
        self.density = float(density)

    def init_state(self, params):
        dev = next((t.device for lt in params.values() for t in lt.values()), None)
        return {"residual": _zeros_tree(params),
                "density": torch.zeros((), dtype=torch.float32, device=dev)}

    def sync(self, grads, state, group):
        names = _leaves(grads)
        encoded, new_residual = [], {ln: {} for ln in grads}
        n_set = None
        n_total = 0
        for ln, pn in names:
            g = grads[ln][pn].detach()
            acc = g + state["residual"][ln][pn]
            k = max(1, int(round(self.density * acc.numel())))
            mag = torch.abs(acc)
            kth = torch.topk(mag.reshape(-1), k).values[-1]
            mask = (mag >= kth) & (mag > 0)
            enc = torch.where(mask, acc, torch.zeros((), dtype=acc.dtype,
                                                     device=acc.device)).to(g.dtype)
            encoded.append(enc)
            new_residual[ln][pn] = acc - enc
            cnt = torch.sum(mask.to(torch.float32))
            n_set = cnt if n_set is None else n_set + cnt
            n_total += acc.numel()
        if n_set is None:
            n_set = state["density"] * 0
        density = _pmean_(n_set / max(n_total, 1), group)
        synced = pmean_flat(encoded, group)
        out: Tree = {ln: {} for ln in grads}
        for (ln, pn), e in zip(names, synced):
            out[ln][pn] = e
        return out, {"residual": new_residual, "density": density}

    def compression_stats(self, state):
        d = float(state["density"]) if "density" in state else 0.0
        return {
            "target_density": self.density,
            "density": d,
            "compression_ratio": (1.0 / d) if d > 0 else None,
        }


class ParameterAveragingSync(GradientSyncStrategy):
    """``ParameterAveragingTrainingMaster`` semantics: each replica takes
    ``frequency`` purely local steps, then the parameters are averaged
    across the data axis (one all-reduce). The JAX package blends the
    average in every step to keep its compiled program branch-free; the
    port's step is eager and averages only on the steps that need it."""

    params_diverge = True
    replicated_grads = False  # purely local updates between sync points

    def __init__(self, frequency: int = 5) -> None:
        if frequency < 1:
            raise ValueError("frequency must be >= 1")
        self.frequency = int(frequency)

    def sync(self, grads, state, group):
        return grads, state  # local update, no gradient exchange

    def sync_params(self, params, iteration, group):
        if int(iteration) % self.frequency:
            return
        names = _leaves(params)
        avg = pmean_flat([params[ln][pn] for ln, pn in names], group)
        with torch.no_grad():
            for (ln, pn), a in zip(names, avg):
                params[ln][pn].copy_(a)
