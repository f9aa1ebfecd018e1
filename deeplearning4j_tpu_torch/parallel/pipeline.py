"""Pipeline parallelism (port of ``deeplearning4j_tpu/parallel/pipeline.py``):
the layer stack split into S stages over a ``pipe`` mesh axis, M
microbatches streamed through them.

The JAX package runs every stage inside one ``shard_map`` program and
hands activations to the neighbour stage with ``ppermute`` each tick of a
``lax.scan``. The port runs one process (one rank) per stage, joined by
``torch.distributed``: each rank walks its own column of the same static
tick tables, and at the end of every tick posts its sends and the
receives the tables announce for the next tick in one
``batch_isend_irecv`` (:func:`~deeplearning4j_tpu_torch.parallel.mesh.exchange`)
before it waits, so a stage sending an activation down while its
neighbour sends a cotangent up cannot deadlock.

* :func:`pipeline_apply` — the forward-only GPipe fill-drain over uniform
  stages; under autograd its backward is the reversed pipeline (the GPipe
  schedule's backward ticks), as reverse-mode AD of the JAX primitive is.
* :func:`build_pipeline_schedule` / :func:`run_pipeline_schedule` /
  :func:`pipeline_value_and_grad` — explicit tick schedules (``"gpipe"``
  fill-drain or interleaved ``"1f1b"``) where forward and backward are
  scheduled ops. Both run 2(M+S-1) ticks (bubble share (S-1)/(M+S-1)); 1F1B
  keeps at most min(S, M) microbatches in flight per stage, GPipe M. A
  stage stashes each in-flight microbatch's stage *input* and reruns the
  stage forward under autograd at its backward tick, so the stash is one
  boundary activation per in-flight microbatch.
* :func:`partition_stages` — splits a ``MultiLayerNetwork`` or a
  linear-chain ``ComputationGraph`` into S stages balanced by parameter
  count; :class:`~deeplearning4j_tpu_torch.parallel.trainer.PipelineParallelTrainer`
  consumes the partition.

Stage parameters for the uniform-stage functions are the JAX layout:
leaves with a leading dim of S (the whole stack, from which each rank
takes its slice), or the leading dim 1 that :func:`shard_stage_params`
gives (this rank's slice only). Gradients come back in the layout given:
a whole stack's on every rank, a slice's on its rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .mesh import exchange, mesh_axis_size

# Schedule op codes.
PIPE_IDLE, PIPE_FWD, PIPE_BWD = 0, 1, 2

SCHEDULES = ("gpipe", "1f1b")


def _pipe(mesh, axis: str):
    """(process group, this rank's stage, number of stages) of ``axis``."""
    n = mesh_axis_size(mesh, axis)
    return mesh.get_group(axis), int(mesh.get_local_rank(axis)), n


def _peer(group, stage: int) -> int:
    """The global rank of ``stage`` in the pipe group."""
    return dist.get_global_rank(group, stage)


def _stage_slice(stage_params, n_stages: int, stage: int, axis: str):
    """This rank's stage parameters as fresh leaves (gradients are taken
    against them), and whether the caller gave the whole stack (every leaf
    of leading dim S) rather than this rank's slice (leading dim 1)."""
    leaves, spec = pytree.tree_flatten(stage_params)
    leading = {int(t.shape[0]) for t in leaves}
    for t in leaves:
        if t.shape[0] not in (n_stages, 1) or len(leading) > 1:
            raise ValueError(
                f"stage_params leaf of shape {tuple(t.shape)} has leading "
                f"dim {t.shape[0]} but the {axis!r} mesh axis has "
                f"{n_stages} stages — each shard would silently apply only "
                "its first slice")
    stacked = leading == {n_stages} and n_stages > 1
    local = [(t[stage] if stacked else t[0]).detach() for t in leaves]
    local = [t.requires_grad_(t.is_floating_point()) for t in local]
    return pytree.tree_unflatten(local, spec), stacked


def _grads_in_layout(grads, stage_params, stacked: bool, stage: int, group):
    """Local stage gradients in the caller's layout: [1, ...] for a slice;
    for a whole stack, [S, ...] with every stage's slice, all-reduced over
    the pipe group (each slice is non-zero on its owner only, so the sum
    is exact)."""
    g_leaves, spec = pytree.tree_flatten(grads)
    p_leaves, _ = pytree.tree_flatten(stage_params)
    out = []
    for g, p in zip(g_leaves, p_leaves):
        if not stacked:
            out.append(g[None])
            continue
        full = torch.zeros(p.shape, dtype=g.dtype, device=g.device)
        full[stage] = g
        dist.all_reduce(full, group=group)
        out.append(full)
    return pytree.tree_unflatten(out, spec)


def _broadcast_from_last(t: torch.Tensor, group, n_stages: int) -> torch.Tensor:
    """``t`` as the last stage holds it, on every rank of the group (bool
    rides as uint8)."""
    if n_stages == 1:
        return t
    wire = t.view(torch.uint8) if t.dtype == torch.bool else t
    dist.broadcast(wire, _peer(group, n_stages - 1), group=group)
    return t


# ---------------------------------------------------------------------------
# GPipe fill-drain forward
# ---------------------------------------------------------------------------


def _fill_drain(stage_fn, p_local, x: torch.Tensor, group, stage: int,
                n_stages: int) -> torch.Tensor:
    """Stage ``stage`` of the fill-drain forward: at tick t it runs
    microbatch t - stage, sends the result down and receives the next
    microbatch from above; the last stage banks what completes. Returns
    the last stage's [M, ...] result on every rank of the group."""
    M = x.shape[0]
    buf = torch.zeros_like(x)
    carry = None
    prev = _peer(group, stage - 1) if stage > 0 else None
    nxt = _peer(group, stage + 1) if stage + 1 < n_stages else None
    for t in range(M + n_stages - 1):
        m = t - stage
        sends, recvs = [], []
        if 0 <= m < M:
            out = stage_fn(p_local, x[m] if stage == 0 else carry)
            if stage == n_stages - 1:
                buf[m] = out
            else:
                sends.append((out.contiguous(), nxt))
        if stage > 0 and 0 <= t + 1 - stage < M:
            carry = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
            recvs.append((carry, prev))
        exchange(sends, recvs, group)
    return _broadcast_from_last(buf, group, n_stages)


class _PipelineApply(torch.autograd.Function):
    """:func:`pipeline_apply` under autograd: the forward is the fill-drain;
    the backward reruns each stage from its input under the GPipe schedule's
    backward ticks (the reversed pipeline), seeded on the last stage by the
    output's cotangent. Gradients go back in the caller's layout."""

    @staticmethod
    def forward(ctx, meta, x, *leaves):
        stage_fn, spec, group, stage, n_stages, axis = meta
        orig = pytree.tree_unflatten(list(leaves), spec)
        local, stacked = _stage_slice(orig, n_stages, stage, axis)
        with torch.no_grad():
            out = _fill_drain(stage_fn, local, x, group, stage, n_stages)
        ctx.meta, ctx.stacked = meta, stacked
        ctx.save_for_backward(x, *leaves)
        return out

    @staticmethod
    def backward(ctx, g_out):
        stage_fn, spec, group, stage, n_stages, axis = ctx.meta
        x, *leaves = ctx.saved_tensors
        orig = pytree.tree_unflatten(list(leaves), spec)
        local, _ = _stage_slice(orig, n_stages, stage, axis)
        params = {"p": local, "x": x.detach().requires_grad_(x.is_floating_point())}
        g_out = g_out.contiguous()

        def fwd(p, m, xi):
            return stage_fn(p["p"], p["x"][m] if stage == 0 else xi)

        def lfn(p, h, m):
            return torch.sum(h * g_out[m].to(h.dtype))

        sched = build_pipeline_schedule(n_stages, x.shape[0], "gpipe")
        _, grads = run_pipeline_schedule(fwd, lfn, params, sched, group,
                                         (tuple(x.shape[1:]), x.dtype, x.device))
        gx = grads["x"]
        if n_stages > 1:
            dist.all_reduce(gx, group=group)  # stage 0's, zero elsewhere
        laid = _grads_in_layout(grads["p"], orig, ctx.stacked, stage, group)
        g_leaves, _ = pytree.tree_flatten(laid)
        return (None, gx if ctx.needs_input_grad[1] else None, *g_leaves)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   x: torch.Tensor, mesh, axis: str = "pipe") -> torch.Tensor:
    """Run ``x`` through S pipelined stages (GPipe fill-drain, forward).

    ``stage_params``: a tree whose leaves have leading dim S (the whole
    stack) or 1 (this rank's slice, :func:`shard_stage_params`). ``x``:
    [M, mb, ...] microbatches, the same on every rank of the pipe group.
    ``stage_fn(params_slice, act) -> act`` keeps the activation's shape and
    dtype. Returns [M, mb, ...] on every rank: equal to folding the stages
    one after another. Under autograd the backward is the reversed
    pipeline; a whole stack's gradient, and ``x``'s, reach every rank."""
    group, stage, n_stages = _pipe(mesh, axis)
    leaves, spec = pytree.tree_flatten(stage_params)
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        return _PipelineApply.apply((stage_fn, spec, group, stage, n_stages, axis), x, *leaves)
    local, _ = _stage_slice(stage_params, n_stages, stage, axis)
    with torch.no_grad():
        return _fill_drain(stage_fn, local, x, group, stage, n_stages)


# ---------------------------------------------------------------------------
# Explicit tick schedules: GPipe fill-drain and interleaved 1F1B
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """Static tick tables driving one pipelined forward+backward pass.

    All tables are [ticks, n_stages]: ``ops[t, s]`` is the op stage ``s``
    runs at tick ``t`` (PIPE_IDLE/PIPE_FWD/PIPE_BWD), ``mb[t, s]`` the
    microbatch it targets; ``fwd_recv[t, s]`` / ``bwd_recv[t, s]`` name
    the microbatch whose activation / cotangent arrives at the START of
    tick ``t`` (-1: nothing arrives).

    ``max_inflight`` is the per-stage peak of forwards-minus-backwards —
    the number of stashed boundary activations a stage keeps resident:
    ≤ min(S, M) under 1F1B, = M under GPipe. ``bubble_share`` is the
    fraction of stage-ticks spent idle: 1 - 2M/T = (S-1)/(M+S-1) for both
    schedules.
    """

    kind: str
    n_stages: int
    n_micro: int
    ticks: int
    ops: np.ndarray
    mb: np.ndarray
    fwd_recv: np.ndarray
    bwd_recv: np.ndarray
    max_inflight: int
    bubble_share: float


def build_pipeline_schedule(n_stages: int, n_micro: int,
                            schedule: str = "1f1b") -> PipelineSchedule:
    """Build the static tick tables for ``schedule`` at (S, M).

    Per-stage op queues are laid out canonically and then run through a
    discrete-event simulation: a forward needs its input activation
    (stage 0: always ready; else sent by the upstream forward one tick
    earlier), a backward needs its cotangent (last stage: its own
    forward's loss, ready the next tick; else sent by the downstream
    backward one tick earlier). GPipe queues all M forwards then all M
    backwards in reverse microbatch order; 1F1B (PipeDream-flush) warms up
    with min(S-1-s, M) forwards then strictly alternates F/B, bounding
    in-flight at min(S, M).
    """
    S, M = int(n_stages), int(n_micro)
    if S < 1 or M < 1:
        raise ValueError(f"need n_stages >= 1 and n_micro >= 1, got {S}/{M}")
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; pick one of {SCHEDULES}")

    queues: List[List[Tuple[int, int]]] = []
    for s in range(S):
        if schedule == "gpipe":
            q = [(PIPE_FWD, m) for m in range(M)]
            q += [(PIPE_BWD, m) for m in reversed(range(M))]
        else:
            w = min(S - 1 - s, M)
            q = [(PIPE_FWD, m) for m in range(w)]
            f, b = w, 0
            while f < M:
                q += [(PIPE_FWD, f), (PIPE_BWD, b)]
                f, b = f + 1, b + 1
            q += [(PIPE_BWD, m) for m in range(b, M)]
        queues.append(q)

    INF = 1 << 30
    f_avail = np.full((S, M), INF, np.int64)
    f_avail[0, :] = 0
    b_avail = np.full((S, M), INF, np.int64)
    pos = [0] * S
    inflight = np.zeros(S, np.int64)
    max_inflight = 1
    events: List[Tuple[int, int, int, int]] = []  # (tick, stage, op, mb)
    max_ticks = 4 * (M + S) + 8
    t = 0
    while any(pos[s] < len(queues[s]) for s in range(S)):
        if t >= max_ticks:  # pragma: no cover - deadlock guard
            raise AssertionError("pipeline schedule failed to converge")
        for s in range(S):
            if pos[s] >= len(queues[s]):
                continue
            op, m = queues[s][pos[s]]
            avail = f_avail if op == PIPE_FWD else b_avail
            if avail[s, m] > t:
                continue
            pos[s] += 1
            events.append((t, s, op, m))
            if op == PIPE_FWD:
                inflight[s] += 1
                max_inflight = max(max_inflight, int(inflight[s]))
                if s + 1 < S:
                    f_avail[s + 1, m] = t + 1
                else:
                    b_avail[s, m] = t + 1  # loss cotangent of own output
            else:
                inflight[s] -= 1
                if s > 0:
                    b_avail[s - 1, m] = t + 1
        t += 1
    T = t

    ops = np.full((T, S), PIPE_IDLE, np.int32)
    mbt = np.zeros((T, S), np.int32)
    fwd_recv = np.full((T, S), -1, np.int32)
    bwd_recv = np.full((T, S), -1, np.int32)
    for tt, s, op, m in events:
        ops[tt, s] = op
        mbt[tt, s] = m
        if op == PIPE_FWD and s + 1 < S:
            assert tt + 1 < T
            fwd_recv[tt + 1, s + 1] = m
        elif op == PIPE_BWD and s > 0:
            assert tt + 1 < T
            bwd_recv[tt + 1, s - 1] = m

    bubble = 0.0 if S == 1 else 1.0 - (2.0 * M) / T
    if schedule == "1f1b":
        assert max_inflight <= min(S, M), (max_inflight, S, M)
    return PipelineSchedule(
        kind=schedule, n_stages=S, n_micro=M, ticks=T, ops=ops, mb=mbt,
        fwd_recv=fwd_recv, bwd_recv=bwd_recv, max_inflight=max_inflight,
        bubble_share=float(bubble))


def run_pipeline_schedule(
    fwd_fn: Callable[[Any, int, Optional[torch.Tensor]], torch.Tensor],
    loss_fn: Callable[[Any, torch.Tensor, int], torch.Tensor],
    params: Any,
    sched: PipelineSchedule,
    group,
    carry_like,
    clock: Optional[dict] = None,
) -> Tuple[torch.Tensor, Any]:
    """Run this rank's column of one scheduled forward+backward pass; the
    rank's stage is its rank in ``group`` (the pipe axis's process group).

    ``fwd_fn(params, m, act_in) -> act_out`` is this stage's forward for
    microbatch ``m`` (stage 0 gets ``act_in=None`` and reads its own
    input). ``loss_fn(params, act_out, m) -> scalar`` is the last stage's
    loss for microbatch ``m``. ``carry_like`` is the boundary activation
    ``(shape, dtype, device)`` (or a tensor of that shape): what travels
    between stages. ``params`` is a tree of tensors; gradients are taken
    against its floating leaves that require grad.

    Returns ``(loss_sum, grads)``: the un-normalized contributions — the
    sum of the microbatch losses on the last stage (0 elsewhere) and the
    gradient accumulator in ``params``' layout (zeros for leaves the stage
    does not reach).

    A forward tick runs without autograd and stashes the stage input; the
    backward tick reruns the stage forward from the stash under autograd
    (activation remat), so at most ``sched.max_inflight`` boundary
    activations stay resident.

    With ``clock`` (a dict), the device is fenced around every tick's
    compute and every exchange, and their host seconds are added to
    ``clock["compute"]`` and ``clock["exchange"]`` (the exchange's share
    is this stage's measured bubble, transfers included).
    """
    S, T = sched.n_stages, sched.ticks
    s = dist.get_rank(group) if S > 1 else 0
    if isinstance(carry_like, torch.Tensor):
        cshape, cdtype, cdev = tuple(carry_like.shape), carry_like.dtype, carry_like.device
    else:
        cshape, cdtype, cdev = tuple(carry_like[0]), carry_like[1], carry_like[2]
    leaves, spec = pytree.tree_flatten(params)
    wrt = [i for i, t in enumerate(leaves) if t.requires_grad]
    gacc: List[Optional[torch.Tensor]] = [None] * len(leaves)
    loss = None
    stash: dict = {}
    fbuf: dict = {}
    bbuf: dict = {}
    prev = _peer(group, s - 1) if s > 0 else None
    nxt = _peer(group, s + 1) if s + 1 < S else None
    last = s == S - 1
    fence = (lambda: torch.cuda.synchronize(cdev)) if torch.device(cdev).type == "cuda" else (
        lambda: None)
    for t in range(T):
        if clock is not None:
            fence()
            t0 = time.perf_counter()
        op, m = int(sched.ops[t, s]), int(sched.mb[t, s])
        sends = []
        if op == PIPE_FWD:
            x_in = fbuf.pop(m) if s > 0 else None
            with torch.no_grad():
                h = fwd_fn(params, m, x_in)
            if tuple(h.shape) != cshape:
                raise ValueError(
                    f"stage {s} maps the boundary activation {cshape} to "
                    f"{tuple(h.shape)}: stages cannot pass activations of differing shapes")
            stash[m] = x_in
            assert len(stash) <= sched.max_inflight, (len(stash), sched.max_inflight)
            if not last:
                sends.append((h.to(cdtype).contiguous(), nxt))
        elif op == PIPE_BWD:
            xi = stash.pop(m)
            if xi is not None:
                xi = xi.detach().requires_grad_(xi.is_floating_point())
            with torch.enable_grad():
                h = fwd_fn(params, m, xi)
                if last:
                    lval = loss_fn(params, h, m)
                    outs, gouts = [lval], [torch.ones_like(lval)]
                    loss = lval.detach() if loss is None else loss + lval.detach()
                else:
                    outs, gouts = [h.to(cdtype)], [bbuf.pop(m)]
                inputs = [leaves[i] for i in wrt]
                take_x = xi is not None and xi.requires_grad and s > 0
                if take_x:
                    inputs.append(xi)
                got = torch.autograd.grad(outs, inputs, gouts, allow_unused=True) if inputs else ()
            for i, g in zip(wrt, got):
                if g is not None:
                    gacc[i] = g if gacc[i] is None else gacc[i] + g
            if s > 0:
                gx = got[-1] if take_x and got[-1] is not None else None
                if gx is None:
                    gx = torch.zeros(cshape, dtype=cdtype, device=cdev)
                sends.append((gx.to(cdtype).contiguous(), prev))
        recvs = []
        if t + 1 < T:
            fm, bm = int(sched.fwd_recv[t + 1, s]), int(sched.bwd_recv[t + 1, s])
            if fm >= 0:
                fbuf[fm] = torch.empty(cshape, dtype=cdtype, device=cdev)
                recvs.append((fbuf[fm], prev))
            if bm >= 0:
                bbuf[bm] = torch.empty(cshape, dtype=cdtype, device=cdev)
                recvs.append((bbuf[bm], nxt))
        if clock is not None:
            fence()
            t1 = time.perf_counter()
            clock["compute"] = clock.get("compute", 0.0) + (t1 - t0)
        if S > 1:
            exchange(sends, recvs, group)
        if clock is not None:
            fence()
            clock["exchange"] = clock.get("exchange", 0.0) + (time.perf_counter() - t1)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, gacc)]
    if loss is None:
        ref = next((t for t in leaves if t.is_floating_point()), None)
        loss = torch.zeros((), dtype=torch.promote_types(
            ref.dtype if ref is not None else torch.float32, torch.float32), device=cdev)
    return loss, pytree.tree_unflatten(grads, spec)


def pipeline_value_and_grad(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    y: torch.Tensor,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh,
    axis: str = "pipe",
    schedule: str = "1f1b",
) -> Tuple[torch.Tensor, Any]:
    """Scheduled loss and gradients over S uniform stages.

    Equal to the gradient of ``mean_m loss_fn(fold(x[m]), y[m])`` but run
    under the selected tick schedule. ``loss_fn(out, y_mb)`` returns the
    microbatch-mean scalar. ``x`` and ``y`` are the [M, mb, ...]
    microbatches on every rank. Returns ``(loss, grads)`` on every rank of
    the pipe group, the grads in ``stage_params``' layout (see the module
    docstring)."""
    group, stage, n_stages = _pipe(mesh, axis)
    local, stacked = _stage_slice(stage_params, n_stages, stage, axis)
    n_micro = x.shape[0]
    sched = build_pipeline_schedule(n_stages, n_micro, schedule)

    def fwd(p, m, xi):
        return stage_fn(p, x[m] if stage == 0 else xi)

    def lfn(p, h, m):
        return loss_fn(h, y[m])

    loss, grads = run_pipeline_schedule(fwd, lfn, local, sched, group,
                                        (tuple(x.shape[1:]), x.dtype, x.device))
    inv = 1.0 / n_micro
    loss = loss.clone() if stage == n_stages - 1 else torch.zeros_like(loss)
    if n_stages > 1:
        dist.all_reduce(loss, group=group)
    loss = loss * inv
    grads = pytree.tree_map(lambda g: g * inv, grads)
    return loss, _grads_in_layout(grads, stage_params, stacked, stage, group)


# ---------------------------------------------------------------------------
# Stage partitioning for real models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StagePartition:
    """How a layer sequence splits into S pipeline stages.

    Unit indices refer to the model's layer sequence (``_model_units``).
    ``prelude`` (input layers, stage 0) and ``head`` (output/loss layers,
    last stage) bracket ``blocks``: ``n_blocks`` structurally identical
    runs of ``period`` layers, distributed contiguously —
    ``blocks_per_stage[s]`` consecutive blocks per stage, balanced by
    parameter count against the prelude/head base loads.
    """

    n_stages: int
    period: int
    prelude: Tuple[int, ...]
    blocks: Tuple[Tuple[int, ...], ...]
    head: Tuple[int, ...]
    blocks_per_stage: Tuple[int, ...]
    stage_units: Tuple[Tuple[int, ...], ...]
    stage_costs: Tuple[int, ...]
    balance: float

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def block_offsets(self) -> Tuple[int, ...]:
        out, off = [], 0
        for c in self.blocks_per_stage:
            out.append(off)
            off += c
        return tuple(out)

    def locate_block(self, b: int) -> Tuple[int, int]:
        """Block index -> (stage, slot-within-stage)."""
        off = 0
        for s, c in enumerate(self.blocks_per_stage):
            if b < off + c:
                return s, b - off
            off += c
        raise IndexError(b)


def _model_units(model) -> List[Tuple[str, Any, Any]]:
    """The (name, layer, preprocessor) sequence of a sequential model or a
    linear-chain ComputationGraph — the shape pipeline partitioning needs."""
    conf = getattr(model, "conf", None)
    if hasattr(model, "layers") and hasattr(conf, "layer_name"):
        return [(conf.layer_name(i), layer, None)
                for i, layer in enumerate(model.layers)]
    if hasattr(model, "linear_chain"):
        return [(spec.name, spec.layer, spec.preprocessor)
                for spec in model.linear_chain()]
    raise TypeError(
        f"cannot partition {type(model).__name__} into pipeline stages: "
        "expected a MultiLayerNetwork or a ComputationGraph")


def _unit_signature(layer, params) -> Any:
    """Structural identity of a layer: its config minus the name, plus its
    param shapes/dtypes. Equal signatures <=> interchangeable pipeline
    blocks."""
    shapes = tuple(sorted(
        (k, tuple(v.shape), str(v.dtype)) for k, v in params.items()))
    try:
        anon = dataclasses.replace(layer, name=None)
    except Exception:
        anon = type(layer).__name__
    return (anon, shapes)


def partition_stages(model, n_stages: int) -> StagePartition:
    """Split an initialized model's layer sequence into ``n_stages``
    pipeline stages balanced by parameter count.

    Finds the largest-parameter-cost periodic run of structurally
    identical layer blocks (period chosen smallest on ties), anchors
    everything before it to stage 0 (prelude) and everything after —
    always including the output layer — to the last stage (head), and
    hands each stage at least one block, distributing the rest greedily
    onto the least-loaded stage. Raises ``ValueError`` when the sequence
    has no periodic region with >= ``n_stages`` repeats (e.g. LeNet's
    conv->dense chain) — such models cannot pipeline here yet.
    """
    S = int(n_stages)
    if S < 2:
        raise ValueError(
            f"n_stages={S}: pipeline partitioning needs >= 2 stages "
            "(use the single-device Solver otherwise)")
    units = _model_units(model)
    L = len(units)
    params = model.params
    costs = [sum(int(np.prod(tuple(v.shape))) for v in params.get(name, {}).values())
             for name, _, _ in units]
    sigs = [_unit_signature(layer, params.get(name, {}))
            for name, layer, _ in units]

    body_end = L - 1  # the output layer is always head
    best: Optional[Tuple[int, int, int]] = None  # (a, p, n)
    best_key: Optional[Tuple[int, int, int]] = None
    for p in range(1, body_end // S + 1):
        for a in range(0, body_end - p + 1):
            n = 1
            while (a + (n + 1) * p <= body_end
                   and sigs[a + n * p:a + (n + 1) * p] == sigs[a:a + p]):
                n += 1
            if n >= S:
                cost = sum(costs[a:a + n * p])
                key = (cost, -p, -a)
                if best_key is None or key > best_key:
                    best, best_key = (a, p, n), key
    if best is None:
        raise ValueError(
            f"cannot partition {L} layers into {S} pipeline stages: no run "
            f"of >= {S} structurally identical layer blocks found — "
            "pipeline partitioning needs a periodic middle (repeated "
            "dense/transformer blocks); heterogeneous chains like "
            "conv->dense don't pipeline here yet")
    a, p, n = best

    # The block region must preserve the activation shape (block k's output
    # feeds block k+1): verify via the static InputType walk when available.
    conf = getattr(model, "conf", None)
    it = getattr(conf, "input_type", None)
    if it is not None and hasattr(model, "layers"):
        types = [it]
        for _, layer, _ in units:
            it = layer.output_type(it)
            types.append(it)
        if types[a] != types[a + p]:
            raise ValueError(
                f"periodic block at layers [{a}, {a + p}) does not preserve "
                f"the activation type ({types[a]} -> {types[a + p]}): "
                "stages cannot ring-pass activations of differing shapes")

    prelude = tuple(range(a))
    blocks = tuple(tuple(range(a + b * p, a + (b + 1) * p))
                   for b in range(n))
    head = tuple(range(a + n * p, L))
    block_cost = sum(costs[a:a + p])
    loads = [float(block_cost)] * S
    loads[0] += sum(costs[i] for i in prelude)
    loads[-1] += sum(costs[i] for i in head)
    counts = [1] * S
    for _ in range(n - S):
        s = int(np.argmin(loads))
        counts[s] += 1
        loads[s] += block_cost

    stage_units: List[Tuple[int, ...]] = []
    off = 0
    for s in range(S):
        ids = list(prelude) if s == 0 else []
        for b in range(off, off + counts[s]):
            ids.extend(blocks[b])
        off += counts[s]
        if s == S - 1:
            ids.extend(head)
        stage_units.append(tuple(ids))
    mean_load = sum(loads) / S
    balance = (max(loads) / mean_load) if mean_load > 0 else 1.0
    return StagePartition(
        n_stages=S, period=p, prelude=prelude, blocks=blocks, head=head,
        blocks_per_stage=tuple(counts), stage_units=tuple(stage_units),
        stage_costs=tuple(int(v) for v in loads), balance=float(balance))


# ---------------------------------------------------------------------------
# Stand-in stages (tests, benchmarks)
# ---------------------------------------------------------------------------


def pipeline_stages_init(seed: int, n_stages: int, d: int, hidden: int,
                         dtype=torch.float32, device=None):
    """Stacked params for S identical dense blocks (tanh MLP with residual):
    the standard pipelined-transformer-block stand-in. Weights are uniform
    in ±1/sqrt(fan-in), drawn from a CPU generator seeded with ``seed`` (the
    JAX package draws them from a PRNG key: the values differ)."""
    from ..core.dtypes import default_device

    gen = torch.Generator().manual_seed(int(seed))
    s1, s2 = 1.0 / np.sqrt(d), 1.0 / np.sqrt(hidden)

    def uni(shape, lim):
        return ((torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1) * lim).to(dtype)

    dev = default_device(device)
    return {
        "W1": uni((n_stages, d, hidden), s1).to(dev),
        "b1": torch.zeros((n_stages, hidden), dtype=dtype, device=dev),
        "W2": uni((n_stages, hidden, d), s2).to(dev),
        "b2": torch.zeros((n_stages, d), dtype=dtype, device=dev),
    }


def dense_block_stage(p, x):
    """One pipeline stage: residual tanh MLP [mb, d] -> [mb, d]."""
    h = torch.tanh(x @ p["W1"] + p["b1"])
    return x + h @ p["W2"] + p["b2"]


def shard_stage_params(stage_params, mesh, axis: str = "pipe"):
    """This rank's slice of stacked stage params, leading dim 1 (what one
    device of the JAX package's ``pipe``-sharded array holds)."""
    _, stage, n_stages = _pipe(mesh, axis)
    _stage_slice(stage_params, n_stages, stage, axis)  # the leading-dim check

    def take(a):
        return a[stage:stage + 1].detach().clone() if a.shape[0] == n_stages else a

    return pytree.tree_map(take, stage_params)
