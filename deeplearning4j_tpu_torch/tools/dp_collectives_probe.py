"""Which ``torch.distributed`` collectives carry CUDA tensors for ranks that
share one card, and what they cost.

NCCL takes one device per rank, so two NCCL ranks on one card are expected
to fail; gloo stages CUDA tensors through the host for some collectives.
The distributed trainer's ZeRO-1 schedule (all-reduce, slice, all-gather)
is spelled from the collectives this probe finds working. Run on a machine
with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.dp_collectives_probe

It spawns two ranks on ``cuda:0`` per backend, prints one JSON line per
backend (each collective: ``ok``, the error, or a wrong result; the ms of
one call on a 16 MiB float32 tensor, host-timed and fenced by
``torch.cuda.synchronize``) and the card's name and power limit. Ranks
that do not finish within ``--timeout`` seconds are killed and reported.
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
    for name, (call, check) in _collectives(dist, torch, world, rank, dev).items():
        try:
            out = call()
            torch.cuda.synchronize()
            good = check(out)
            t0 = time.perf_counter()
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 5
            res[name] = {"result": "ok" if good else "wrong result", "ms": round(ms, 3)}
        except Exception as e:
            res[name] = {"result": f"{type(e).__name__}: {str(e)[:200]}"}
    print(json.dumps(res), flush=True)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--backends", default="gloo,nccl")
    p.add_argument("--timeout", type=int, default=60)
    p.add_argument("--worker", action="store_true")
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--backend", default="gloo")
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

    for backend in args.backends.split(","):
        logs = [tempfile.TemporaryFile(mode="w+") for _ in range(args.world)]
        errs = [tempfile.TemporaryFile(mode="w+") for _ in range(args.world)]
        procs = spawn_ranks([sys.executable, "-m",
                             "deeplearning4j_tpu_torch.tools.dp_collectives_probe", "--worker",
                             "--backend", backend, "--timeout", str(args.timeout)],
                            args.world, stdout=logs, stderr=errs)
        wait_ranks(procs, timeout=args.timeout + 30)
        for r, (proc, log, err) in enumerate(zip(procs, logs, errs)):
            log.seek(0)
            err.seek(0)
            lines = [ln for ln in log.read().splitlines() if ln.startswith("{")]
            print(lines[-1] if lines else json.dumps(
                {"backend": backend, "rank": r, "exit": proc.returncode,
                 "stderr": err.read()[-400:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
