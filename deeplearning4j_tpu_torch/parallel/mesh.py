"""Device mesh and process-group bring-up (port of
``deeplearning4j_tpu/parallel/mesh.py``).

The JAX package drives every device from one process over a
``jax.sharding.Mesh``. The port runs one process (one rank) per replica,
joined by ``torch.distributed``: :func:`initialize_distributed` starts the
process group, and :func:`make_mesh` names its axes over the ranks with
``torch.distributed.device_mesh.init_device_mesh``. :class:`PartitionSpec`
is the port's own spec type in place of JAX's; the distributed trainers
read it only for ZeRO-1's updater slicing.

Between neighbouring ranks (pipeline stages, the ring of ring attention)
:func:`exchange` posts every send and receive of a step at once. Gloo
cannot send a tensor that lies on a card (``send`` fails with "Bad
address", ``batch_isend_irecv`` aborts the process:
``tools/dp_collectives_probe.py``), so gloo ranks on a card go through
:func:`gloo_host_staged_exchange`, which stages through host tensors and
counts its calls, bytes and seconds in :data:`HOST_STAGED_STATS`; NCCL
sends the device tensors themselves.

Tensor and expert parallelism spell GSPMD's activation collectives by
hand, with four autograd functions over a process group (Megatron-LM's
*f* and *g* and their gather/scatter pair): :func:`copy_to_group`
(identity forward, all-reduce backward), :func:`reduce_from_group`
(all-reduce forward, identity backward), :func:`gather_from_group`
(all-gather forward, slice backward) and :func:`scatter_to_group` (slice
forward, all-gather backward). Every rank of the group seeds the same loss
cotangent, so the backward of a forward sum is the identity: a summing
transpose, as ``torch.distributed.nn.functional.all_reduce`` has, would
scale the gradients by the group's size. Their calls, bytes and fenced
seconds add up in :data:`COLLECTIVE_STATS`.

Two JAX names have no counterpart, by design: ``shmap`` (the
``shard_map`` shim: each rank runs its own step, with the collectives
spelled by hand) and ``force_host_device_count`` (virtual XLA host
devices: the port spawns processes instead).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist


class PartitionSpec(tuple):
    """``PartitionSpec("data")``: per dimension, the mesh axis it is split
    over, or ``None`` (the counterpart of ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named mesh axes and sizes, e.g. ``MeshSpec(pipe=2, data=2)``. A size
    of -1 means "all remaining ranks". Axis vocabulary:

    * ``data`` — batch (``DistributedTrainer``; ZeRO-1 inside a stage);
    * ``pipe`` — layer sequence (``PipelineParallelTrainer`` stages);
    * ``seq`` — sequence (``ring_attention``, ``ulysses_attention``);
    * ``model`` — tensor and expert parallelism (``DistributedTrainer``'s
      ``param_sharding_rules``: the shards of the matched params), and the
      rows of a ``ShardedEmbeddingTable``.

    :func:`make_mesh` gives one process group per axis; rank ``r`` of a
    ``(pipe, data)`` mesh sits at ``(r // data, r % data)``, and of a
    ``(data, model)`` mesh at ``(r // model, r % model)``: the ranks of one
    model group are adjacent."""

    axes: Tuple[Tuple[str, int], ...]

    def __init__(self, axes: Optional[Dict[str, int]] = None, **kw: int) -> None:
        merged = dict(axes or {})
        merged.update(kw)
        if not merged:
            merged = {"data": -1}
        object.__setattr__(self, "axes", tuple(merged.items()))

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = int(np.prod([v for v in sizes.values() if v != -1])) if sizes else 1
        if wild:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} wants {fixed} devices, have {n_devices}")
        return sizes


def free_port() -> int:
    """A free local TCP port for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv: Sequence[str], world: int, *, env: Optional[Mapping[str, str]] = None,
                stdout=None, stderr=None) -> List[subprocess.Popen]:
    """Start ``world`` processes of ``argv`` joined on a free local port:
    rank ``r`` gets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT``, which :func:`initialize_distributed` called with no
    address reads. ``env`` defaults to this process's environment; the
    port's root goes on ``PYTHONPATH``, so ``python -m
    deeplearning4j_tpu_torch...`` works from any directory. ``stdout`` /
    ``stderr`` are passed to every rank, or one per rank as a list. Wait
    with :func:`wait_ranks`."""
    base = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base["PYTHONPATH"] = root + os.pathsep + base.get("PYTHONPATH", "")
    port = free_port()

    def pick(stream, r):
        return stream[r] if isinstance(stream, (list, tuple)) else stream

    return [subprocess.Popen(list(argv), env={**base, "RANK": str(r), "WORLD_SIZE": str(world),
                                              "MASTER_ADDR": "127.0.0.1",
                                              "MASTER_PORT": str(port)},
                             stdout=pick(stdout, r), stderr=pick(stderr, r))
            for r in range(world)]


def wait_ranks(procs: Sequence[subprocess.Popen], timeout: Optional[float] = None,
               grace: float = 30.0) -> int:
    """Wait for a world's ranks. When one rank fails the others would block
    in their next collective, so they are killed after ``grace`` seconds;
    at ``timeout`` every rank still running is killed. Returns the first
    nonzero exit code (rank order), else 0."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        now = time.monotonic()
        if any(p.poll() not in (None, 0) for p in procs):
            deadline = min(deadline or now + grace, now + grace)
        if deadline is not None and now >= deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            break
        time.sleep(0.05)
    return next((p.returncode for p in procs if p.returncode != 0), 0)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> str:
    """Start this rank's process group; returns the backend.

    ``coordinator_address`` is ``host:port`` of rank 0 (``MASTER_ADDR`` /
    ``MASTER_PORT`` when omitted), ``num_processes`` the world size and
    ``process_id`` this rank (``WORLD_SIZE`` / ``RANK``). With none of them
    the process runs alone: a world of one on a free local port, so the
    trainer's code is the same at every width.

    ``backend=None`` picks NCCL for a CUDA ``device`` (the default: the
    current CUDA device) and gloo for ``device="cpu"``. Ranks that share one
    card pass ``backend="gloo"``: NCCL takes one device per rank. Nothing
    switches backend or device behind the caller's back; a backend that
    cannot start raises. Safe to call again once initialized (no-op)."""
    if dist.is_initialized():
        return dist.get_backend()
    from ..core.dtypes import default_device

    dev = default_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
    rank = process_id if process_id is not None else os.environ.get("RANK")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    if world is None or int(world) == 1:
        world, rank = 1, 0
        if coordinator_address is None:
            coordinator_address = f"127.0.0.1:{free_port()}"
    elif coordinator_address is None or rank is None:
        raise ValueError(
            f"a world of {world} processes needs coordinator_address and process_id")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(world), rank=int(rank), **kw)
    return backend


def make_mesh(spec: Optional[MeshSpec] = None, *, device_type: Optional[str] = None,
              **axes: int):
    """A ``DeviceMesh`` over the process group's ranks:
    ``make_mesh(data=4)``, or ``make_mesh()`` for every rank on ``data``.
    Needs :func:`initialize_distributed` first. ``device_type`` defaults
    to ``"cuda"`` under NCCL and ``"cpu"`` otherwise (gloo ranks on a card
    pass ``"cuda"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed() first")
    spec = spec or MeshSpec(axes or None)
    sizes = spec.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names = tuple(sizes)
    return init_device_mesh(device_type, tuple(sizes[n] for n in names), mesh_dim_names=names)


#: the host transport's use: calls, bytes carried (sent and received), and
#: the host-timed seconds of its calls, each fenced by the device
HOST_STAGED_STATS: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_host_staged_stats() -> None:
    HOST_STAGED_STATS.update(calls=0, bytes=0, seconds=0.0)


def _is_gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def gloo_host_staged_exchange(sends: Sequence[Tuple[torch.Tensor, int]],
                              recvs: Sequence[Tuple[torch.Tensor, int]], group=None) -> None:
    """The point-to-point transport of gloo ranks whose tensors lie on a
    card: each send is copied to the host, every send and receive is posted
    in one ``batch_isend_irecv`` on host tensors, and each received host
    tensor is copied into its buffer on the card. ``sends`` are ``(tensor,
    peer)`` and ``recvs`` ``(buffer, peer)``, peers being global ranks.
    Used only on gloo (it raises on another backend); every call adds to
    :data:`HOST_STAGED_STATS`."""
    if not _is_gloo(group):
        raise RuntimeError("gloo_host_staged_exchange is gloo's transport; "
                           f"the group's backend is {dist.get_backend(group)}")
    t0 = time.perf_counter()
    host_out = [(t.detach().to("cpu", copy=True).contiguous(), p) for t, p in sends]
    host_in = [(torch.empty(b.shape, dtype=b.dtype), p) for b, p in recvs]
    _post_and_wait(host_out, host_in, group)
    for (buf, _), (t, _) in zip(recvs, host_in):
        buf.copy_(t)
    if any(b.is_cuda for b, _ in recvs):
        torch.cuda.synchronize()
    HOST_STAGED_STATS["calls"] += 1
    HOST_STAGED_STATS["bytes"] += sum(t.numel() * t.element_size()
                                      for t, _ in (*host_out, *host_in))
    HOST_STAGED_STATS["seconds"] += time.perf_counter() - t0


def _wire(t: torch.Tensor) -> torch.Tensor:
    """What a tensor travels as: bool as a uint8 view of its storage."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], group=None) -> None:
    """Post every send ``(tensor, peer)`` and every receive ``(buffer,
    peer)`` at once, then wait for all of them: the point-to-point step of
    the pipeline schedules, where a stage may send an activation down while
    its neighbour sends a cotangent up. Peers are global ranks; received
    values land in the buffers. On NCCL, and for host tensors, it is one
    ``batch_isend_irecv``; gloo ranks whose tensors lie on a card go through
    :func:`gloo_host_staged_exchange`."""
    sends = [(_wire(t), p) for t, p in sends]
    recvs = [(_wire(b), p) for b, p in recvs]
    if not sends and not recvs:
        return
    on_card = any(t.is_cuda for t, _ in (*sends, *recvs))
    if on_card and _is_gloo(group):
        gloo_host_staged_exchange(sends, recvs, group)
        return
    _post_and_wait([(t.contiguous(), p) for t, p in sends], recvs, group)


def _tagged(pairs):
    """``(tensor, peer, tag)``: the n-th message to (or from) one peer
    carries tag n, so several between one pair match in order."""
    seen: Dict[int, int] = {}
    out = []
    for t, p in pairs:
        out.append((t, p, seen.get(p, 0)))
        seen[p] = seen.get(p, 0) + 1
    return out


def _post_and_wait(sends, recvs, group) -> None:
    ops = ([dist.P2POp(dist.isend, t, p, group, tag) for t, p, tag in _tagged(sends)]
           + [dist.P2POp(dist.irecv, b, p, group, tag) for b, p, tag in _tagged(recvs)])
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()


#: the activation collectives' use: calls, bytes in (each rank's tensor),
#: and host-timed seconds, each call fenced by the device on a card
COLLECTIVE_STATS: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_collective_stats() -> None:
    COLLECTIVE_STATS.update(calls=0, bytes=0, seconds=0.0)


def _timed_collective(fn, t: torch.Tensor):
    """Run ``fn()`` (a collective on ``t``) fenced by the device, adding to
    :data:`COLLECTIVE_STATS`."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    COLLECTIVE_STATS["calls"] += 1
    COLLECTIVE_STATS["bytes"] += t.numel() * t.element_size()
    COLLECTIVE_STATS["seconds"] += time.perf_counter() - t0
    return out


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, into a new contiguous tensor."""
    out = t.contiguous().clone()
    _timed_collective(lambda: dist.all_reduce(out, group=group), out)
    return out


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _timed_collective(lambda: dist.all_gather(parts, t, group=group), t)
    return torch.cat(parts, dim=dim)


def _own_part(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (the group's size divides it)."""
    n = dist.get_world_size(group)
    size = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_part(g, ctx.group, ctx.dim), None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_part(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward (Megatron's *f*; the JAX
    package's ``_psum_in_bwd``): a tensor that every rank of ``group``
    holds whole enters a branch each rank computes on its own shard, so its
    gradient is the sum of the ranks' parts."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward (Megatron's *g*; the JAX
    package's ``_ep_combine``): the ranks' partial sums added up. Every
    rank seeds the same loss cotangent, so each partial's cotangent is the
    output's as it is."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather forward (the ranks' blocks concatenated along ``dim``),
    slice backward: the whole tensor is used alike on every rank, so each
    rank's cotangent block is already the whole gradient of its block."""
    return _GatherFromGroup.apply(x, group, dim)


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Slice forward (this rank's block of ``dim``, which the group's size
    divides), all-gather backward: each rank computes with its block only,
    so the whole gradient is the ranks' blocks put together."""
    return _ScatterToGroup.apply(x, group, dim)


def mesh_axis_size(mesh, axis: str = "data") -> int:
    """The number of ranks along ``axis`` of a ``DeviceMesh``."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.mesh_dim_names}")
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def local_batch_slice(global_batch: int, mesh, axis: str = "data") -> slice:
    """The rows of a global batch this rank owns: rank ``i`` of the data
    axis takes the ``i``-th of its equal row blocks. The batch must divide
    the axis (an error, not overlapping or dropped rows)."""
    n = mesh_axis_size(mesh, axis)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} data shards")
    per = global_batch // n
    start = mesh.get_local_rank(axis) * per
    return slice(start, start + per)


def zero1_partition_spec(
    shape: Tuple[int, ...],
    n_shards: int,
    axis: str = "data",
    base: Optional[PartitionSpec] = None,
) -> PartitionSpec:
    """Updater-state sharding rule for ZeRO-1 ("Automatic Cross-Replica
    Sharding of Weight Update in Data-Parallel Training"): split dim 0 of
    a param-shaped updater leaf over the data axis when the axis divides
    it, keeping ``base`` on the other dims. ``base`` comes back unchanged
    for a scalar or zero-sized leaf, a dim 0 the axis does not divide, one
    shard, or a ``base`` that already splits dim 0."""
    base = base if base is not None else PartitionSpec()
    if not shape or not shape[0] or shape[0] % max(n_shards, 1) or n_shards <= 1:
        return base
    existing = tuple(base)
    if existing and existing[0] is not None:
        return base
    if existing:
        return PartitionSpec(axis, *existing[1:])
    return PartitionSpec(axis)
