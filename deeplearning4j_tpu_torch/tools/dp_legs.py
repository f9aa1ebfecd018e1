"""Data-parallel legs: one boot of a world of ranks trains a model under
several :class:`~deeplearning4j_tpu_torch.parallel.DistributedTrainer`
configurations in turn, and reports what the ranks hold.

Each leg rebuilds the model from one seed (the same weights on every
rank), trains ``steps`` steps on one seeded global batch (rank ``r`` takes
the ``r``-th block of its rows), and reports per rank: a SHA-256 of
the final parameters and of the float state (ranks are compared bit for
bit), the scores, the wall ms of each step and the host-timed ms spent in
collectives (each fenced by ``torch.cuda.synchronize`` on a card), the
updater-state bytes the rank holds, the strategy's compression view, and
the flash kernels' launches. Rank 0 also saves the ``sync`` leg's
parameters.

Run a world from Python (``run_world``) or, on a machine with a CUDA
device, the default LM legs on two ranks that share ``cuda:0``::

    python3 -m deeplearning4j_tpu_torch.tools.dp_legs

Each rank is a process (``python -m deeplearning4j_tpu_torch.tools.dp_legs
--worker ...``) started by
:func:`~deeplearning4j_tpu_torch.parallel.mesh.spawn_ranks`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

GPT2_SMALL = dict(vocab_size=50257, hidden=768, n_layers=12, n_heads=12, ffn_size=3072,
                  max_len=1024)
LM_LEGS = [
    {"name": "sync", "strategy": "SyncAllReduce", "zero1": False},
    {"name": "bucketed", "strategy": "BucketedAllReduceSync", "zero1": False},
    {"name": "zero1", "strategy": "BucketedAllReduceSync", "zero1": True},
    {"name": "threshold", "strategy": "ThresholdCompressedSync", "zero1": False},
]


def lm_spec(steps: int = 3, global_batch: int = 8, seq: int = 1024, seed: int = 0,
            lm: Optional[dict] = None, legs: Optional[List[dict]] = None) -> dict:
    """The LM legs: every step trains on one seeded global batch (as
    ``chip_smoke.py``'s training phase does), so the score falls over a few
    steps."""
    return {"model": "lm", "lm": dict(lm or GPT2_SMALL), "seed": seed, "steps": steps,
            "global_batch": global_batch, "seq": seq, "legs": legs or LM_LEGS}


def resnet_spec(steps: int = 3, local_batch: int = 32, seed: int = 0, size: int = 224,
                classes: int = 1000, legs: Optional[List[dict]] = None) -> dict:
    return {"model": "resnet50", "seed": seed, "steps": steps, "local_batch": local_batch,
            "height": size, "width": size, "classes": classes,
            "legs": legs or [{"name": "threshold_bn2", "strategy": "ThresholdCompressedSync",
                              "kwargs": {"bn_group_size": 2}}]}


def lm_batch(spec: dict):
    """The seeded global batch: ids [B, T] and labels (the ids shifted by
    one)."""
    rs = np.random.RandomState(spec["seed"] + 2)
    ids = rs.randint(0, spec["lm"]["vocab_size"], (spec["global_batch"], spec["seq"] + 1))
    return ids[:, :-1], ids[:, 1:]


def resnet_batch(spec: dict, world: int):
    """The seeded global batch: images [b, 3, H, W] and one-hot labels."""
    rs = np.random.RandomState(spec["seed"] + 3)
    b = spec["local_batch"] * world
    x = rs.rand(b, 3, spec["height"], spec["width"]).astype(np.float32)
    y = np.eye(spec["classes"], dtype=np.float32)[rs.randint(0, spec["classes"], b)]
    return x, y


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _build(spec: dict, device: str):
    if spec["model"] == "lm":
        from deeplearning4j_tpu_torch.model.zoo import TransformerLM

        return TransformerLM(**spec["lm"], seed=spec["seed"], dtype="float32").init(device=device)
    from deeplearning4j_tpu_torch.model.zoo import ResNet50

    return ResNet50(num_classes=spec["classes"], height=spec["height"], width=spec["width"],
                    seed=spec["seed"]).init(device=device)


class _CollectiveClock:
    """Host time inside the collectives of ``torch.distributed`` (each call
    fenced by ``torch.cuda.synchronize`` on a card)."""

    NAMES = ("all_reduce", "all_gather_into_tensor", "all_gather_single", "all_gather",
             "broadcast")

    def __init__(self, cuda: bool) -> None:
        import torch
        import torch.distributed as dist

        self.seconds = 0.0
        self.calls = 0
        self._dist = dist
        self._orig = {n: getattr(dist, n) for n in self.NAMES if hasattr(dist, n)}
        sync = torch.cuda.synchronize if cuda else (lambda: None)

        def wrap(fn):
            def timed(*a, **kw):
                sync()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            return timed

        for n, fn in self._orig.items():
            setattr(dist, n, wrap(fn))

    def reset(self) -> None:
        self.seconds, self.calls = 0.0, 0


def run_rank(backend: str, device: str, spec: dict, out_dir: str) -> dict:
    """One rank's legs (the world from the variables
    :func:`~deeplearning4j_tpu_torch.parallel.mesh.spawn_ranks` sets);
    writes ``rank<r>.json`` under ``out_dir``."""
    import torch

    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.parallel import (DistributedTrainer, initialize_distributed,
                                                   strategies)

    dev = "cuda" if device == "cuda" else "cpu"
    initialize_distributed(backend=backend, device="cuda:0" if dev == "cuda" else "cpu")
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    clock = _CollectiveClock(cuda)
    if spec["model"] == "lm":
        xs, ys = lm_batch(spec)
        per = spec["global_batch"] // world
    else:
        xs, ys = resnet_batch(spec, world)
        per = spec["local_batch"]
    rows = slice(rank * per, (rank + 1) * per)
    x = torch.from_numpy(np.ascontiguousarray(xs[rows])).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(ys[rows])).to(dev)
    ops.reset_launch_counts()
    out: Dict = {"rank": rank, "world": world, "backend": backend, "legs": {}}
    for leg in spec["legs"]:
        model = _build(spec, dev)
        kw = dict(leg.get("kwargs", {}))
        strategy = getattr(strategies, leg["strategy"])(**leg.get("strategy_kwargs", {}))
        trainer = DistributedTrainer(model, strategy=strategy, zero1=leg.get("zero1", False),
                                     **kw)
        scores, step_ms, coll_ms = [], [], []
        for _ in range(spec["steps"]):
            sync()
            clock.reset()
            t0 = time.perf_counter()
            score = trainer.fit_batch(x, y)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            coll_ms.append(1e3 * clock.seconds)
            scores.append(float(score))
        params = [p for lp in model.params.values() for p in lp.values()]
        state = [v for st in model.state.values() for v in st.values() if v.is_floating_point()]
        rec = {"scores": scores, "step_ms": step_ms, "collective_ms": coll_ms,
               "params_sha256": _digest(params), "state_sha256": _digest(state),
               "updater_state_bytes": trainer.updater_state_bytes(),
               "updater_state_bytes_global": trainer.updater_state_bytes(per_replica=False),
               "compression": trainer.compression_stats() if strategy.compressed else None}
        if rank == 0 and leg["name"] == "sync":
            path = os.path.join(out_dir, f"params_{leg['name']}.npy")
            np.save(path, model.params_flat())
            rec["params_path"] = path
        out["legs"][leg["name"]] = rec
        del trainer, model
        if cuda:
            torch.cuda.empty_cache()
    out["launches"] = {**ops.LAUNCH_COUNTS, **ops.GROUPED_MATMUL_LAUNCH_COUNTS}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return out


def run_world(spec: dict, *, world: int = 2, backend: str = "gloo", device: str = "cuda",
              out_dir: Optional[str] = None, timeout: float = 900.0) -> List[dict]:
    """Spawn ``world`` ranks of :func:`run_rank` and return their reports
    (rank order). Raises with the ranks' output if a rank fails or outlives
    ``timeout`` (all are killed then)."""
    from deeplearning4j_tpu_torch.parallel.mesh import spawn_ranks, wait_ranks

    out_dir = out_dir or tempfile.mkdtemp(prefix="dp_legs_")
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = spawn_ranks([sys.executable, "-m", "deeplearning4j_tpu_torch.tools.dp_legs",
                         "--worker", "--backend", backend, "--device", device,
                         "--spec", spec_path, "--out", out_dir],
                        world, stdout=logs, stderr=subprocess.STDOUT)
    if wait_ranks(procs, timeout=timeout):
        out = []
        for r, log in enumerate(logs):
            log.seek(0)
            out.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n{log.read()[-3000:]}")
        raise RuntimeError("dp_legs ranks failed:\n" + "\n".join(out))
    reports = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--worker", action="store_true")
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", default="cuda")
    p.add_argument("--spec", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.worker:
        with open(args.spec) as f:
            spec = json.load(f)
        run_rank(args.backend, args.device, spec, args.out)
        return 0
    reports = run_world(lm_spec(), world=args.world, backend=args.backend, device=args.device)
    for rep in reports:
        print(json.dumps({k: v for k, v in rep.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
