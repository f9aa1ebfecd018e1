"""Which ``torch.distributed`` collectives carry CUDA tensors for ranks that
share one card, and what they cost.

NCCL takes one device per rank, so two NCCL ranks on one card are expected
to fail; gloo stages CUDA tensors through the host for some collectives.
The distributed trainer's ZeRO-1 schedule (all-reduce, slice, all-gather)
is spelled from the collectives this probe finds working, and the pipeline
and sequence-parallel transports (``parallel/mesh.py``) from its
point-to-point and all-to-all rows. Run on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.dp_collectives_probe

It spawns two ranks on ``cuda:0`` per backend and prints one JSON line per
rank (each collective: ``ok``, the error, or a wrong result; the ms of one
call on a 16 MiB float32 tensor, host-timed and fenced by
``torch.cuda.synchronize``) and the card's name and power limit. On gloo
the point-to-point operations (``send``/``recv``, ``batch_isend_irecv``)
and ``all_to_all_single`` run in a world of their own each, at 6.3 MB (one
[2, 1024, 768] float32 boundary activation) and at 16 MiB, so that a rank
that dies on one of them leaves the others' rows standing; then the host
transport :func:`~deeplearning4j_tpu_torch.parallel.mesh.gloo_host_staged_exchange`
(the port's route for those on gloo) is timed at the same sizes. Ranks that
do not finish within ``--timeout`` seconds are killed and reported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

NUMEL = 4 << 20  # 16 MiB of float32
#: the point-to-point and all-to-all sizes: one [2, 1024, 768] float32
#: boundary activation (6.3 MB), and 16 MiB
P2P_NUMEL = {"6.3MB": 2 * 1024 * 768, "16MiB": NUMEL}
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather", "reduce_scatter_tensor",
               "broadcast")
P2P = ("send_recv", "batch_isend_irecv", "all_to_all_single", "host_staged_exchange")


def _collectives(dist, torch, world, rank, dev):
    def t(v):
        return torch.full((NUMEL,), float(v), device=dev)

    return {
        "all_reduce": (lambda: dist.all_reduce(x := t(rank + 1)) or x,
                       lambda out: bool(torch.all(out == world * (world + 1) / 2))),
        "all_gather_into_tensor": (
            lambda: dist.all_gather_into_tensor(out := torch.empty(world * NUMEL, device=dev),
                                                t(rank)) or out,
            lambda out: all(bool(torch.all(out[r * NUMEL:(r + 1) * NUMEL] == r))
                            for r in range(world))),
        "all_gather": (
            lambda: dist.all_gather(outs := [torch.empty(NUMEL, device=dev) for _ in range(world)],
                                    t(rank)) or outs,
            lambda outs: all(bool(torch.all(o == r)) for r, o in enumerate(outs))),
        "reduce_scatter_tensor": (
            lambda: dist.reduce_scatter_tensor(out := torch.empty(NUMEL // world, device=dev),
                                               t(rank + 1)) or out,
            lambda out: bool(torch.all(out == world * (world + 1) / 2))),
        "broadcast": (lambda: dist.broadcast(x := t(rank), 0) or x,
                      lambda out: bool(torch.all(out == 0))),
    }


def _p2p(dist, torch, world, rank, dev, numel):
    """Rank r trades a tensor of ``numel`` floats filled with r with its
    neighbour ``r ^ 1`` (worlds of an even size)."""
    peer = rank ^ 1

    def t(v):
        return torch.full((numel,), float(v), device=dev)

    def send_recv():
        out = torch.empty(numel, device=dev)
        if rank % 2 == 0:
            dist.send(t(rank), peer)
            dist.recv(out, peer)
        else:
            dist.recv(out, peer)
            dist.send(t(rank), peer)
        return out

    def batched():
        out = torch.empty(numel, device=dev)
        ops = [dist.P2POp(dist.isend, t(rank), peer), dist.P2POp(dist.irecv, out, peer)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out

    def a2a():
        per = numel // world
        x = torch.cat([torch.full((per,), float(10 * rank + j), device=dev)
                       for j in range(world)])
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out

    def staged():
        from deeplearning4j_tpu_torch.parallel.mesh import gloo_host_staged_exchange

        out = torch.empty(numel, device=dev)
        gloo_host_staged_exchange([(t(rank), peer)], [(out, peer)], None)
        return out

    per = numel // world
    return {
        "send_recv": (send_recv, lambda out: bool(torch.all(out == peer))),
        "batch_isend_irecv": (batched, lambda out: bool(torch.all(out == peer))),
        "all_to_all_single": (a2a, lambda out: all(
            bool(torch.all(out[j * per:(j + 1) * per] == 10 * j + rank)) for j in range(world))),
        "host_staged_exchange": (staged, lambda out: bool(torch.all(out == peer))),
    }


def _timed(call, check, torch):
    out = call()
    torch.cuda.synchronize()
    good = check(out)
    t0 = time.perf_counter()
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    return {"result": "ok" if good else "wrong result", "ms": round(ms, 3)}


def _rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    res = {"backend": args.backend, "rank": rank}
    try:
        # a raw process group: the finding is whether the backend starts at all
        kw = {"device_id": dev} if args.backend == "nccl" else {}
        dist.init_process_group(args.backend, init_method="env://", world_size=world, rank=rank,
                                timeout=timedelta(seconds=args.timeout), **kw)
    except Exception as e:  # the finding: reported, not hidden
        res["init"] = f"{type(e).__name__}: {str(e)[:300]}"
        print(json.dumps(res), flush=True)
        return 0
    res["init"] = "ok"
    ops = args.ops.split(",")
    calls = {n: c for n, c in _collectives(dist, torch, world, rank, dev).items() if n in ops}
    for size, numel in P2P_NUMEL.items():
        calls.update({f"{n} {size}": c for n, c in _p2p(dist, torch, world, rank, dev,
                                                         numel).items() if n in ops})
    for name, (call, check) in calls.items():
        try:
            res[name] = _timed(call, check, torch)
        except Exception as e:
            res[name] = {"result": f"{type(e).__name__}: {str(e)[:200]}"}
        print(json.dumps(res), flush=True)  # each row as it lands: a crash keeps the earlier
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--backends", default="gloo,nccl")
    p.add_argument("--timeout", type=int, default=60)
    p.add_argument("--worker", action="store_true")
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--ops", default=",".join(COLLECTIVES))
    args = p.parse_args(argv)
    if args.worker:
        return _rank_main(args)
    import torch

    if not torch.cuda.is_available():
        print("dp_collectives_probe needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    from deeplearning4j_tpu_torch.parallel.mesh import spawn_ranks, wait_ranks

    worlds = []
    for backend in args.backends.split(","):
        worlds.append((backend, ",".join(COLLECTIVES)))
        if backend == "gloo":
            worlds += [(backend, op) for op in P2P]
    for backend, ops in worlds:
        logs = [tempfile.TemporaryFile(mode="w+") for _ in range(args.world)]
        errs = [tempfile.TemporaryFile(mode="w+") for _ in range(args.world)]
        procs = spawn_ranks([sys.executable, "-m",
                             "deeplearning4j_tpu_torch.tools.dp_collectives_probe", "--worker",
                             "--backend", backend, "--timeout", str(args.timeout),
                             "--ops", ops],
                            args.world, stdout=logs, stderr=errs)
        wait_ranks(procs, timeout=args.timeout + 30)
        for r, (proc, log, err) in enumerate(zip(procs, logs, errs)):
            log.seek(0)
            err.seek(0)
            lines = [ln for ln in log.read().splitlines() if ln.startswith("{")]
            row = json.loads(lines[-1]) if lines else {"backend": backend, "rank": r}
            if proc.returncode != 0:
                row.update({"ops": ops, "exit": proc.returncode, "stderr": err.read()[-400:]})
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
