"""Pipeline- and sequence-parallel legs on a world of ranks that share one
card: what ``chip_smoke.py``'s three phases of them drive.

* ``pp_lm`` — ``PipelineParallelTrainer`` over ``pipe=world`` on the
  ``TransformerLM`` from one seed, ``steps`` steps of one seeded global
  batch under each schedule of ``schedules``; then each planted fault of
  ``faults`` (one microbatch's loss dropped, the last stage's update
  skipped, the head gradients left unsummed over ``pipe``) under 1F1B.
  Per leg: scores, wall ms a step, the kernels' launches a step, the
  fenced compute and exchange seconds of the tick walk (its measured
  bubble), the stage-time probe, ``stage_param_bytes``, the schedule's
  bubble share and resident microbatches, and the host transport's use.
  Rank 0 saves each leg's global params (``params_<leg>.npy``).
* ``ppdp`` — the same trainer over ``pipe=2, data=world/2``, replicated
  and ZeRO-1, on the float64 LM; the replicated leg's checkpoint
  (``OrbaxCheckpointer``) is restored into a ``DistributedTrainer`` over
  every rank and, on rank 0, into a ``Solver``, each of which takes the
  next step.
* ``seq`` — ``ring_attention`` and ``ulysses_attention`` over
  ``seq=world`` on seeded whole tensors, against ``flash_attention`` on the
  whole sequence on rank 0 (forward and q/k/v gradients of
  ``sum(out * w)``), timed; and a ``ShardedEmbeddingTable`` over
  ``model=world`` against a dense table.
* ``many`` — the specs of ``specs`` in turn in one boot of the world, each
  with an output directory of its own (``<out>/<index>``); the report's
  ``legs`` is then the list of their legs.

Run a world from Python (:func:`run_world`); each rank is a process
(``python -m deeplearning4j_tpu_torch.tools.pp_legs --worker ...``)
started by :func:`~deeplearning4j_tpu_torch.parallel.mesh.spawn_ranks`.
On a machine with a CUDA device, ``python3 -m
deeplearning4j_tpu_torch.tools.pp_legs`` runs a small ``pp_lm`` world.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

FAULTS = ("drop_microbatch", "skip_last_update", "head_not_summed")


def _trainer_class(fault: Optional[str]):
    """The trainer, or a subclass with a planted fault (never the port's
    own code path)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import PipelineParallelTrainer

    if fault is None:
        return PipelineParallelTrainer

    class Faulty(PipelineParallelTrainer):
        def _fold_head_loss(self, h, y, seed, m):
            loss = super()._fold_head_loss(h, y, seed, m)
            return loss * 0 if fault == "drop_microbatch" and m == self.n_micro - 1 else loss

        def _update(self, grads):
            if fault == "skip_last_update" and self.stage == self.n_stages - 1:
                return
            if fault == "head_not_summed" and self.stage != self.n_stages - 1:
                # before the sum over pipe, a stage other than the last holds
                # zero head gradients: left unsummed, they stay zero
                head = {self._units[i][0] for i in self.partition.head}
                grads = {ln: ({pn: torch.zeros_like(g) for pn, g in lg.items()}
                              if ln in head else lg) for ln, lg in grads.items()}
            super()._update(grads)

    return Faulty


def _sync(cuda: bool):
    import torch

    return torch.cuda.synchronize if cuda else (lambda: None)


def _counts():
    from deeplearning4j_tpu_torch import ops

    return {**ops.LAUNCH_COUNTS, **ops.GROUPED_MATMUL_LAUNCH_COUNTS}


def _lm(spec: dict, dev: str, dtype: str):
    from deeplearning4j_tpu_torch.model.zoo import TransformerLM

    return TransformerLM(**spec["lm"], seed=spec["seed"], dtype=dtype).init(device=dev)


def _lm_batch(spec: dict):
    rs = np.random.RandomState(spec["seed"] + 2)
    ids = rs.randint(0, spec["lm"]["vocab_size"], (spec["global_batch"], spec["seq"] + 1))
    return ids[:, :-1], ids[:, 1:]


def _train_leg(spec, leg, mesh, ids, labels, dev, rank, out_dir, dtype="float32") -> dict:
    import torch

    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh

    cuda = dev == "cuda"
    sync = _sync(cuda)
    model = _lm(spec, dev, dtype)
    cls = _trainer_class(leg.get("fault"))
    tr = cls(model, mesh, n_micro=spec["n_micro"], schedule=leg.get("schedule", "1f1b"),
             zero1=leg.get("zero1", False))
    stage_times = tr.probe_stage_times(ids, labels)
    scores, step_ms, launches, clocks = [], [], [], []
    pmesh.reset_host_staged_stats()
    for _ in range(spec["steps"]):
        ops.reset_launch_counts()
        tr.clock = {"compute": 0.0, "exchange": 0.0}
        sync()
        t0 = time.perf_counter()
        scores.append(float(tr.fit_batch(ids, labels)))
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(_counts())
        clocks.append(tr.clock)
    tr.clock = None
    staged = dict(pmesh.HOST_STAGED_STATS)
    st = tr.stats()
    rec = {"scores": scores, "step_ms": step_ms, "launches": launches, "clock": clocks,
           "stage_times": stage_times, "stage": tr.stage,
           "blocks": len(tr._own_units) // max(tr.partition.period, 1),
           "stage_param_bytes": st["stage_param_bytes"],
           "stage_param_bytes_global": st["stage_param_bytes_global"],
           "bubble_share": st["bubble_share"], "max_inflight": st["resident_microbatches"],
           "host_staged": staged}
    tr.sync_to_model()
    if rank == 0:
        path = os.path.join(out_dir, f"params_{leg['name']}.npy")
        np.save(path, model.params_flat())
        rec["params_path"] = path
    return rec, tr, model


def _pp_lm(spec, rank, world, dev, out_dir) -> dict:
    import torch

    from deeplearning4j_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device_type=dev, pipe=world)
    ids, labels = (torch.from_numpy(a).to(dev) for a in _lm_batch(spec))
    legs = [{"name": s, "schedule": s} for s in spec["schedules"]]
    legs += [{"name": f, "schedule": "1f1b", "fault": f} for f in spec.get("faults", ())]
    out = {}
    for leg in legs:
        rec, tr, model = _train_leg(spec, leg, mesh, ids, labels, dev, rank, out_dir)
        out[leg["name"]] = rec
        del tr, model
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def _ppdp(spec, rank, world, dev, out_dir) -> dict:
    """Replicated and ZeRO-1 legs on the float64 LM over pipe=2 x data;
    then the replicated leg's checkpoint restored into a
    ``DistributedTrainer`` over every rank and (rank 0) a ``Solver``, each
    taking the next step."""
    import torch

    from deeplearning4j_tpu_torch.parallel import DistributedTrainer, make_mesh
    from deeplearning4j_tpu_torch.train import OrbaxCheckpointer, Solver

    mesh = make_mesh(device_type=dev, pipe=2, data=world // 2)
    ids, labels = (torch.from_numpy(a).to(dev) for a in _lm_batch(spec))
    out = {}
    ck_dir = os.path.join(out_dir, "ppdp_ckpt")
    for leg in ({"name": "replicated"}, {"name": "zero1", "zero1": True}):
        rec, tr, model = _train_leg(spec, leg, mesh, ids, labels, dev, rank, out_dir,
                                    dtype="float64")
        if leg["name"] == "replicated":
            ck = OrbaxCheckpointer(ck_dir, async_save=False)
            ck.save(spec["steps"], tr)
            ck.wait()
        out[leg["name"]] = rec
        del tr, model
    dp = DistributedTrainer(_lm(spec, dev, "float64"), make_mesh(device_type=dev, data=world))
    meta = OrbaxCheckpointer(ck_dir).restore(dp)
    per = ids.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    out["dp_next"] = float(dp.fit_batch(ids[rows], labels[rows]))
    out["restored_stages"] = meta.get("pipeline_stages")
    if rank == 0:
        np.save(os.path.join(out_dir, "params_dp_next.npy"), dp.model.params_flat())
    del dp
    if rank == 0:
        solver = Solver(_lm(spec, dev, "float64"))
        OrbaxCheckpointer(ck_dir).restore(solver)
        out["solver_next"] = float(solver.fit_batch(ids, labels)[0])
        np.save(os.path.join(out_dir, "params_solver_next.npy"), solver.model.params_flat())
        del solver
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _timed(fn, sync, n: int = 3) -> float:
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / n


def _seq(spec, rank, world, dev, out_dir) -> dict:
    import torch

    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.parallel import (ShardedEmbeddingTable, make_mesh,
                                                   ring_attention, ulysses_attention)
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh

    cuda = dev == "cuda"
    sync = _sync(cuda)
    mesh = make_mesh(device_type=dev, seq=world)
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    out: Dict = {"cases": []}
    main_counts = {k: 0 for k in _counts()}
    for case in spec["cases"]:
        b, h, tq, tk, d = case["shape"]
        gen = torch.Generator().manual_seed(case["seed"])
        q = torch.randn(b, h, tq, d, generator=gen).to(dev)
        k = torch.randn(b, h, tk, d, generator=gen).to(dev)
        v = torch.randn(b, h, tk, d, generator=gen).to(dev)
        w = torch.randn(b, h, tq, d, generator=gen).to(dev)  # the loss weights
        fn = fns[case["kind"]]
        causal = case["causal"]
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        ops.reset_launch_counts()
        pmesh.reset_host_staged_stats()
        sync()
        t0 = time.perf_counter()
        o = fn(qs, ks, vs, causal=causal, mesh=mesh)
        sync()
        t1 = time.perf_counter()
        torch.sum(o * w).backward()
        sync()
        t2 = time.perf_counter()
        counts = _counts()
        staged = dict(pmesh.HOST_STAGED_STATS)
        for n, c in counts.items():
            main_counts[n] += c
        rec = {"label": case["label"], "kind": case["kind"], "shape": case["shape"],
               "causal": causal, "fwd_ms": 1e3 * (t1 - t0), "bwd_ms": 1e3 * (t2 - t1),
               "launches": counts, "host_staged": staged}
        if rank == 0:
            # the whole sequence in this one process: B1 forward, B2/B3 backward
            qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
            ref = ops.flash_attention(qr, kr, vr, causal=causal)
            torch.sum(ref * w).backward()
            sync()
            rec["max_abs_out"] = float((o - ref).abs().max())
            rec["ref_max_out"] = float(ref.abs().max())
            for n, a, r in (("dq", qs, qr), ("dk", ks, kr), ("dv", vs, vr)):
                rec[f"rel_{n}"] = float((a.grad - r.grad).abs().max() / r.grad.abs().max())
            rec["whole_ms"] = _timed(lambda: ops.flash_attention(q, k, v, causal=causal), sync)
        out["cases"].append(rec)
        del q, k, v, w, qs, ks, vs, o
        if cuda:
            torch.cuda.empty_cache()
    out["main_launches"] = main_counts
    # the sharded table against a dense one
    tab = spec["table"]
    t = ShardedEmbeddingTable(tab["vocab"], tab["dim"], make_mesh(device_type=dev, model=world),
                              seed=tab["seed"], device=dev)
    rs = np.random.RandomState(tab["seed"] + 1)
    dense = ((np.random.RandomState(tab["seed"]).rand(tab["vocab"], tab["dim"]) - 0.5) * 2
             * (1.0 / tab["dim"])).astype(np.float32)
    ids = rs.randint(0, tab["vocab"], tab["lookups"])
    ids[:8] = ids[8:16]  # repeated ids
    deltas = rs.randn(len(ids), tab["dim"]).astype(np.float32)
    sync()
    t0 = time.perf_counter()
    rows = t.lookup(torch.from_numpy(ids).to(dev))
    sync()
    look_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    t.add_sparse(torch.from_numpy(ids).to(dev), torch.from_numpy(deltas).to(dev))
    sync()
    add_ms = 1e3 * (time.perf_counter() - t0)
    np.add.at(dense_after := dense.copy(), ids, deltas)
    after = t.to_numpy()
    out["table"] = {"lookup_err": float(np.abs(rows.cpu().numpy() - dense[ids]).max()),
                    "update_err": float(np.abs(after - dense_after).max()),
                    "local_rows": int(t.table.shape[0]), "lookup_ms": look_ms,
                    "add_ms": add_ms, "lookups": int(len(ids))}
    return out


_KINDS = {"pp_lm": _pp_lm, "ppdp": _ppdp, "seq": _seq}


def run_rank(backend: str, device: str, spec: dict, out_dir: str, kinds=None) -> dict:
    """One rank's legs (the world from the variables ``spawn_ranks``
    sets): ``spec["kind"]`` of ``kinds`` (default this module's); writes
    ``rank<r>.json`` under ``out_dir``."""
    import torch

    from deeplearning4j_tpu_torch.parallel import initialize_distributed

    dev = "cuda" if device == "cuda" else "cpu"
    initialize_distributed(backend=backend, device="cuda:0" if dev == "cuda" else "cpu")
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    if dev == "cpu":
        torch.set_num_threads(1)
    kinds = kinds or _KINDS
    if spec["kind"] == "many":
        legs = []
        for i, part in enumerate(spec["specs"]):
            part_dir = os.path.join(out_dir, str(i))
            os.makedirs(part_dir, exist_ok=True)
            legs.append(kinds[part["kind"]](part, rank, world, dev, part_dir))
    else:
        legs = kinds[spec["kind"]](spec, rank, world, dev, out_dir)
    out = {"rank": rank, "world": world, "backend": backend, "legs": legs}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return out


def run_world(spec: dict, *, world: int = 2, backend: str = "gloo", device: str = "cuda",
              out_dir: Optional[str] = None, timeout: float = 900.0,
              module: str = "deeplearning4j_tpu_torch.tools.pp_legs") -> List[dict]:
    """Spawn ``world`` ranks of :func:`run_rank` (as ``python -m module
    --worker``) and return their reports (rank order). Raises with the
    ranks' output if a rank fails or outlives ``timeout`` (all are killed
    then)."""
    from deeplearning4j_tpu_torch.parallel.mesh import spawn_ranks, wait_ranks

    out_dir = out_dir or tempfile.mkdtemp(prefix="pp_legs_")
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = spawn_ranks([sys.executable, "-m", module,
                         "--worker", "--backend", backend, "--device", device,
                         "--spec", spec_path, "--out", out_dir],
                        world, stdout=logs, stderr=subprocess.STDOUT)
    if wait_ranks(procs, timeout=timeout):
        out = []
        for r, log in enumerate(logs):
            log.seek(0)
            out.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n{log.read()[-3000:]}")
        raise RuntimeError(f"{module} ranks failed:\n" + "\n".join(out))
    reports = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def small_lm_spec(**kw) -> dict:
    """A 4-block LM at small widths (the worker's own check on a card)."""
    spec = {"kind": "pp_lm", "lm": dict(vocab_size=512, hidden=128, n_layers=4, n_heads=2,
                                        ffn_size=512, max_len=128),
            "seed": 0, "global_batch": 8, "seq": 128, "steps": 2, "n_micro": 4,
            "schedules": ["1f1b", "gpipe"], "faults": []}
    spec.update(kw)
    return spec


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
    for rep in run_world(small_lm_spec(), world=args.world, backend=args.backend,
                         device=args.device):
        print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
