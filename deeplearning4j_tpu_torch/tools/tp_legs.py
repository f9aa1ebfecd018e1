"""Tensor- and expert-parallel legs on a world of ranks that share one card:
what ``chip_smoke.py``'s three phases of them drive.

* ``tp_lm`` — ``DistributedTrainer`` under the Megatron rules
  (:data:`MEGATRON_RULES`) over ``data=1, model=world`` on the
  ``TransformerLM`` from one seed, ``steps`` steps of one seeded global
  batch; then one step under each planted fault of ``faults``
  (:data:`TP_FAULTS`: the row-parallel all-reduce skipped in the forward,
  *g*'s backward made a sum, *f*'s backward all-reduce skipped), whose
  params rank 0 holds against the sound leg's after its first step
  (``fault_gap``). Per leg: scores, wall ms a step,
  the kernels' launches a step and the head counts B1-B3 saw, the host-timed
  seconds in every collective and in the activation collectives alone,
  the param bytes a rank holds beside the whole model's; for the sound leg,
  ``output()`` over the shards against the model's own ``output()`` after
  ``sync_to_model``. Rank 0 reports each leg's params max |diff| from the
  reference params in ``spec["reference"]`` (a ``.npy`` of
  ``params_flat()``).
* ``ep_moe`` — ``DistributedTrainer`` under ``moe_expert_parallel_rules``
  over ``data=1, model=world`` on the MoE network
  (``tools/moe_profile.py::moe_lm_conf``) in each dispatch mode of
  ``modes``, then each fault of ``faults`` (:data:`EP_FAULTS`: the
  combine's backward made a sum, ``copy_to_group`` left out) in grouped
  dispatch. From the seeded params, each leg's gradients (the split ones
  gathered) and its ``output()`` over the shards, which rank 0 holds
  against the replicated network's (the worst relative error of a param's
  gradient, the output's relative error); then the sound legs train
  ``steps`` steps (the same records as ``tp_lm``, the expert slab shapes
  and counts), and rank 0 trains the replicated network with ``Solver``
  and reports the params max |diff| (``params_gap``).
* ``tpep_f64`` — over ``data=2, model=world/2`` in float64: the LM under the
  Megatron rules with ``CLIP_L2_PER_LAYER`` and Lamb, replicated and
  ZeRO-1; the replicated leg's checkpoint restored into a
  ``DistributedTrainer`` without rules over every rank and (rank 0) a
  ``Solver``, each taking the next step; the MoE network under
  ``BucketedAllReduceSync`` with the expert rules, plain and ZeRO-1, and
  without rules. Rank 0 trains the reference ``Solver`` and reports each
  leg's params max |diff| from its reference (``gaps``).

Its worker also runs ``tools/pp_legs.py``'s kinds, and ``many`` (a list of
specs of any of the six kinds in one boot of the world).

Run a world from Python (:func:`run_world`); each rank is a process
(``python -m deeplearning4j_tpu_torch.tools.tp_legs --worker ...``) started
by :func:`~deeplearning4j_tpu_torch.parallel.mesh.spawn_ranks`. On a
machine with a CUDA device, ``python3 -m deeplearning4j_tpu_torch.tools.tp_legs``
runs a small ``tp_lm`` world.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from . import pp_legs
from .pp_legs import _counts, _lm_batch, _sync

#: the Megatron layout of ``TransformerDecoderBlockLayer``'s params
MEGATRON_RULES = [(r"/W[qkv]$", (None, "model")), (r"/Wo$", ("model", None)),
                  (r"/W1$", (None, "model")), (r"/b1$", ("model",)),
                  (r"/W2$", ("model", None))]
TP_FAULTS = ("row_reduce_skipped", "g_backward_sum", "f_backward_skipped")
EP_FAULTS = ("combine_backward_sum", "copy_skipped")
_MODULE = "deeplearning4j_tpu_torch.tools.tp_legs"


def _rules(pairs):
    from deeplearning4j_tpu_torch.parallel import PartitionSpec

    return [(pat, PartitionSpec(*spec)) for pat, spec in pairs]


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """Replace a group collective of ``parallel/mesh.py`` with a faulty one
    for the duration (never the port's own code path): ``*_skipped`` by the
    identity, ``*_backward_sum`` by an all-reduce whose backward all-reduces
    too (``torch.distributed.nn``'s transpose)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import mesh as pmesh

    if fault is None:
        yield
        return

    class _SummingBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return pmesh._all_reduce(x, group)

        @staticmethod
        def backward(ctx, g):
            return pmesh._all_reduce(g, ctx.group), None

    name, fn = {"row_reduce_skipped": ("reduce_from_group", lambda x, group: x),
                "g_backward_sum": ("reduce_from_group", _SummingBackward.apply),
                "combine_backward_sum": ("reduce_from_group", _SummingBackward.apply),
                "f_backward_skipped": ("copy_to_group", lambda x, group: x),
                "copy_skipped": ("copy_to_group", lambda x, group: x)}[fault]
    orig = getattr(pmesh, name)
    setattr(pmesh, name, fn)
    try:
        yield
    finally:
        setattr(pmesh, name, orig)


@contextlib.contextmanager
def heads_seen(into: dict):
    """Record the head count of every B1, B2 and B3 launch (q's dim 1) in
    ``into[kernel]``: the wrappers are wrapped, their counts untouched."""
    import importlib

    fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")
    names = {"flash_forward": "_flash_forward_cuda", "flash_bwd_dq": "_flash_bwd_dq_cuda",
             "flash_bwd_dkv": "_flash_bwd_dkv_cuda"}
    orig = {k: getattr(fa, fn) for k, fn in names.items()}

    def spy(kernel, fn):
        def wrapped(q, *a, **kw):
            into.setdefault(kernel, set()).add(int(q.shape[1]))
            return fn(q, *a, **kw)
        return wrapped

    for k, fn in names.items():
        setattr(fa, fn, spy(k, orig[k]))
    try:
        yield
    finally:
        for k, fn in names.items():
            setattr(fa, fn, orig[k])


def _train(tr, ids, labels, steps, sync, clock):
    """``steps`` steps; per step the score, wall ms, launches and the
    host-timed seconds in all collectives and in the activation ones."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh

    rec = {"scores": [], "step_ms": [], "launches": [], "collective_ms": [], "activation_ms": []}
    for _ in range(steps):
        ops.reset_launch_counts()
        pmesh.reset_collective_stats()
        clock.reset()
        sync()
        t0 = time.perf_counter()
        rec["scores"].append(float(tr.fit_batch(ids, labels)))
        sync()
        rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
        rec["launches"].append(_counts())
        rec["collective_ms"].append(1e3 * clock.seconds)
        rec["activation_ms"].append(1e3 * pmesh.COLLECTIVE_STATS["seconds"])
    return rec


def _gap(a, b) -> float:
    return float(np.abs(a - b).max())


def _rows(a, mesh):
    from deeplearning4j_tpu_torch.parallel import local_batch_slice

    return a[local_batch_slice(a.shape[0], mesh, "data")]


def _tp_lm(spec, rank, world, dev, out_dir) -> dict:
    import torch

    from deeplearning4j_tpu_torch.parallel import DistributedTrainer, make_mesh
    from deeplearning4j_tpu_torch.tools.dp_legs import _CollectiveClock

    cuda = dev == "cuda"
    sync = _sync(cuda)
    clock = _CollectiveClock(cuda)
    mesh = make_mesh(device_type=dev, data=1, model=world)
    ids, labels = (torch.from_numpy(a).to(dev) for a in _lm_batch(spec))
    reference = np.load(spec["reference"]) if rank == 0 and spec.get("reference") else None
    base = pp_legs._lm(spec, dev, "float32")  # each leg trains a copy
    out, first = {}, None
    for fault in (None, *spec.get("faults", ())):
        name = fault or "sound"
        model = base.clone()
        tr = DistributedTrainer(model, mesh, param_sharding_rules=_rules(MEGATRON_RULES))
        heads: dict = {}
        with planted(fault), heads_seen(heads):
            rec = _train(tr, ids, labels, 1, sync, clock)
            if fault is None:
                tr.sync_to_model()  # a collective: the sound leg's first step
                first = model.params_flat() if rank == 0 else None
                more = _train(tr, ids, labels, spec["steps"] - 1, sync, clock)
                rec = {k: rec[k] + more[k] for k in rec}
        rec["heads"] = {k: sorted(v) for k, v in heads.items()}
        st = tr.stats()
        rec.update(param_bytes=st["param_bytes"], param_bytes_global=st["param_bytes_global"],
                   sharded_params=st["sharded_params"])
        if fault is None:
            probe = ids[:1, :spec.get("probe_len", 256)]
            got = tr.output(probe)
            tr.sync_to_model()
            rec["output_gap"] = float((got - model.output(probe)).abs().max())
            del got
        tr.sync_to_model()
        if rank == 0 and fault is not None:
            rec["fault_gap"] = _gap(model.params_flat(), first)
        elif reference is not None:  # rank 0's params against the reference run's
            rec["params_gap"] = _gap(model.params_flat(), reference)
        out[name] = rec
        del tr, model
        if cuda:
            torch.cuda.empty_cache()
    return out


def _moe_model(spec, mode, dev, dtype="float32"):
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.tools.moe_profile import moe_lm_conf

    conf = dataclasses.replace(moe_lm_conf(mode, seed=spec["seed"]), dtype=dtype)
    return MultiLayerNetwork(conf, device=dev).init()


def _moe_batch(spec):
    rs = np.random.RandomState(spec["seed"] + 3)
    ids = rs.randint(0, 50257, (spec["global_batch"], spec["seq"] + 1))
    return ids[:, :-1], ids[:, 1:]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / max(float(b.double().abs().max()), 1e-30))


def _ep_grads(tr, model, ids, labels, probe):
    """From the params as they stand: the gradients of one training
    forward under the trainer's context (the split params' gathered to
    whole, on the host) and ``output()`` of ``probe`` over the shards."""
    import torch

    from deeplearning4j_tpu_torch.nn.sequential import grads_of

    score, _ = model.loss_pure(model.params, model.state, ids, labels, rng=None, train=True,
                               dist=tr._dist_context())
    grads = grads_of(score, model.params)
    tp = tr._tp
    whole = {ln: {pn: tp.full_value(g, tp.shard(ln, pn)).cpu() if tp.shard(ln, pn) else g.cpu()
                  for pn, g in lg.items()} for ln, lg in grads.items()}
    with torch.no_grad():
        out = tr.output(probe).cpu()
    return whole, out


def _ep_moe(spec, rank, world, dev, out_dir) -> dict:
    import torch

    from deeplearning4j_tpu_torch.parallel import (DistributedTrainer, make_mesh,
                                                   moe_expert_parallel_rules)
    from deeplearning4j_tpu_torch.tools.dp_legs import _CollectiveClock
    from deeplearning4j_tpu_torch.train import Solver

    cuda = dev == "cuda"
    sync = _sync(cuda)
    clock = _CollectiveClock(cuda)
    mesh = make_mesh(device_type=dev, data=1, model=world)
    ids, labels = (torch.from_numpy(a).to(dev) for a in _moe_batch(spec))
    probe = ids[:1, :spec.get("probe_len", 256)]
    legs = [(m, m, None) for m in spec["modes"]]
    legs += [(f, "grouped", f) for f in spec.get("faults", ())]
    out, held, trained = {}, {}, {}
    bases = {m: _moe_model(spec, m, dev) for m in spec["modes"]}  # each leg trains a copy
    for name, mode, fault in legs:
        model = bases[mode].clone()
        tr = DistributedTrainer(model, mesh, param_sharding_rules=moe_expert_parallel_rules())
        with planted(fault):
            held[name] = _ep_grads(tr, model, ids, labels, probe)
        rec = {"mode": mode}
        if fault is None:  # the sound legs train
            rec.update(_train(tr, ids, labels, spec["steps"], sync, clock))
            layer = next(ln for ln, lp in model.params.items() if "We1" in lp)
            rec["slabs"] = {pn: list(p.shape) for pn, p in model.params[layer].items()}
            rec["expert_tokens"] = [float(v) for v in model.state[layer]["expert_tokens"].tolist()]
            rec["dropped_tokens"] = float(model.state[layer]["dropped_tokens"])
            rec["ep_shards"] = tr.ep_shards
            st = tr.stats()
            rec.update(param_bytes=st["param_bytes"], param_bytes_global=st["param_bytes_global"])
            tr.sync_to_model()
            if rank == 0:
                trained[name] = model.params_flat()
        out[name] = rec
        del tr, model
        if cuda:
            torch.cuda.empty_cache()
    if rank != 0:
        return out
    for mode in spec["modes"]:  # the replicated network, on rank 0 alone
        model = bases.pop(mode)
        ref = {ln: {pn: g.cpu() for pn, g in lg.items()}
               for ln, lg in model.calculate_gradients(ids, labels).items()}
        ref_out = model.output(probe).cpu()
        for name, m, _ in legs:
            if m != mode:
                continue
            grads, got = held[name]
            out[name]["grad_rel"] = max((_rel(grads[ln][pn], r), f"{ln}.{pn}")
                                        for ln, lg in ref.items() for pn, r in lg.items())
            out[name]["out_rel"] = _rel(got, ref_out)
        solver = Solver(model)
        out[f"replicated_{mode}"] = {"scores": [float(solver.fit_batch(ids, labels)[0])
                                                for _ in range(spec["steps"])]}
        out[mode]["params_gap"] = _gap(trained[mode], model.params_flat())
        del solver, model, ref, ref_out
        if cuda:
            torch.cuda.empty_cache()
    return out


def _f64_lm(spec, dev):
    from deeplearning4j_tpu_torch.model.zoo import TransformerLM
    from deeplearning4j_tpu_torch.nn import GradientNormalization, MultiLayerNetwork
    from deeplearning4j_tpu_torch.train.updaters import Lamb

    lm = TransformerLM(**spec["lm"], seed=spec["seed"], dtype="float64",
                       updater=Lamb(spec["lamb_lr"]))
    conf = dataclasses.replace(lm.conf(), gradient_normalization=(
        GradientNormalization.CLIP_L2_PER_LAYER), gradient_normalization_threshold=1.0)
    return MultiLayerNetwork(conf, device=dev).init()


def _tpep_f64(spec, rank, world, dev, out_dir) -> dict:
    """The float64 legs; rank 0 holds every leg's params and the
    references in memory and reports the gaps (no params leave the
    world)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import (BucketedAllReduceSync, DistributedTrainer,
                                                   make_mesh, moe_expert_parallel_rules)
    from deeplearning4j_tpu_torch.tools.dp_legs import _CollectiveClock
    from deeplearning4j_tpu_torch.train import OrbaxCheckpointer, Solver

    cuda = dev == "cuda"
    sync = _sync(cuda)
    clock = _CollectiveClock(cuda)
    mesh = make_mesh(device_type=dev, data=2, model=world // 2)
    ids, labels = (torch.from_numpy(a).to(dev) for a in _lm_batch(spec))
    ids_l, labels_l = _rows(ids, mesh), _rows(labels, mesh)
    out, flat = {}, {}
    ck_dir = os.path.join(out_dir, "tp_ckpt")
    base = _f64_lm(spec, dev)  # each leg trains a copy
    for name, zero1 in (("lm_replicated", False), ("lm_zero1", True)):
        model = base.clone()
        tr = DistributedTrainer(model, mesh, param_sharding_rules=_rules(MEGATRON_RULES),
                                zero1=zero1)
        out[name] = _train(tr, ids_l, labels_l, spec["steps"], sync, clock)
        if not zero1:
            ck = OrbaxCheckpointer(ck_dir, async_save=False)
            ck.save(spec["steps"], tr)
            ck.wait()
        tr.sync_to_model()
        flat[name] = model.params_flat()
        del tr, model
    dmesh = make_mesh(device_type=dev, data=world)
    dp = DistributedTrainer(base.clone(), dmesh)
    OrbaxCheckpointer(ck_dir).restore(dp)
    out["dp_next"] = float(dp.fit_batch(_rows(ids, dmesh), _rows(labels, dmesh)))
    flat["dp_next"] = dp.model.params_flat()
    del dp
    if rank == 0:  # Solver restored from the checkpoint, and Solver from the seed
        solver = Solver(base.clone())
        OrbaxCheckpointer(ck_dir).restore(solver)
        out["solver_next"] = float(solver.fit_batch(ids, labels)[0])
        flat["solver_next"] = solver.model.params_flat()
        ref = Solver(base)
        out["solver"] = [float(ref.fit_batch(ids, labels)[0]) for _ in range(spec["steps"])]
        ref_steps = ref.model.params_flat()
        out["solver"].append(float(ref.fit_batch(ids, labels)[0]))
        ref_next = ref.model.params_flat()
        del solver, ref
        out["gaps"] = {"lm_replicated": _gap(flat["lm_replicated"], ref_steps),
                       "lm_zero1": _gap(flat["lm_zero1"], ref_steps),
                       "dp_next": _gap(flat["dp_next"], ref_next),
                       "solver_next": _gap(flat["solver_next"], ref_next)}
        out["zero1_bitwise"] = bool(np.array_equal(flat["lm_zero1"], flat["lm_replicated"]))
    flat.clear()
    del base
    torch.distributed.barrier()
    m_ids, m_labels = (_rows(torch.from_numpy(a).to(dev), mesh) for a in _moe_batch(spec))
    base = _moe_model(spec, "grouped", dev, "float64")
    for name, rules, zero1 in (("moe_ep", True, False), ("moe_ep_zero1", True, True),
                               ("moe_replicated", False, False)):
        model = base.clone()
        tr = DistributedTrainer(model, mesh, strategy=BucketedAllReduceSync(), zero1=zero1,
                                param_sharding_rules=moe_expert_parallel_rules() if rules else None)
        out[name] = _train(tr, m_ids, m_labels, spec["steps"], sync, clock)
        out[name]["ep_shards"] = tr.ep_shards
        tr.sync_to_model()
        flat[name] = model.params_flat()
        del tr, model
        if cuda:
            torch.cuda.empty_cache()
    if rank == 0:
        for name in ("moe_ep", "moe_ep_zero1"):
            out["gaps"][name] = _gap(flat[name], flat["moe_replicated"])
            out[f"{name}_bitwise"] = bool(np.array_equal(flat[name], flat["moe_replicated"]))
    return out


_KINDS = {"tp_lm": _tp_lm, "ep_moe": _ep_moe, "tpep_f64": _tpep_f64}


def run_world(spec: dict, *, world: int = 2, backend: str = "gloo", device: str = "cuda",
              out_dir: Optional[str] = None, timeout: float = 900.0) -> List[dict]:
    """Spawn ``world`` ranks over ``spec`` and return their reports (rank
    order); raises with the ranks' output if one fails or outlives
    ``timeout``."""
    return pp_legs.run_world(spec, world=world, backend=backend, device=device,
                             out_dir=out_dir, timeout=timeout, module=_MODULE)


def small_lm_spec(**kw) -> dict:
    """A 2-block LM at small widths (the worker's own check on a card)."""
    spec = {"kind": "tp_lm", "lm": dict(vocab_size=512, hidden=128, n_layers=2, n_heads=4,
                                        ffn_size=512, max_len=128),
            "seed": 0, "global_batch": 4, "seq": 128, "steps": 2, "faults": list(TP_FAULTS),
            "probe_len": 64}
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
        pp_legs.run_rank(args.backend, args.device, spec, args.out,
                         kinds={**pp_legs._KINDS, **_KINDS})
        return 0
    for rep in run_world(small_lm_spec(), world=args.world, backend=args.backend,
                         device=args.device):
        print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
