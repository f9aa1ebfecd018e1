"""Cases of pipeline, sequence and sharded-table parallelism run on a world
of ranks: the port's side of its CPU parity tests
(``tests/test_torch_{pipeline,pipeline_trainer,sequence,sharded_embedding}.py``).

A caller writes its cases (dicts naming a kind, a model zip, seeded
inputs as npz) and :func:`run_world` spawns ``world`` ranks ONCE for all
of them (:func:`~deeplearning4j_tpu_torch.parallel.mesh.spawn_ranks`,
gloo on the CPU). Every rank runs every case in turn and writes
``<case>.r<rank>.npz``; :func:`result` reads one back. The ranks import
only numpy, torch and the port.

Kinds: ``apply`` (``pipeline_apply`` over stacked dense stages, with the
gradients of ``sum(out**2)``; ``local`` gives this rank's slice instead;
``stage`` ``add`` or ``xor`` runs integer or boolean activations),
``value_and_grad`` (``pipeline_value_and_grad`` under ``schedule``),
``trainer`` (``PipelineParallelTrainer`` on a model zip for ``steps``
steps of a global batch; scores, the global params after
``sync_to_model``, the global updater state and the trainer's stats),
``orbax`` (the checkpoint interchange of a pipeline trainer with a
differently staged one, ``DistributedTrainer`` and ``Solver``), ``reject``
(a trainer that must raise: its error type and message; ``partition_for``
hands it a partition for another stage count), ``ring`` and
``ulysses`` (whole-sequence attention with the gradients of
``sum(out**2)``), ``table`` (``ShardedEmbeddingTable`` lookups and a
sparse update), ``w2v`` (``Word2Vec(mesh=)`` over row-sharded tables on a
corpus given as JSON: the whole tables after ``fit``).

Tensor and expert parallelism (``tests/test_torch_{tp,ep}.py``):
``dt`` (``DistributedTrainer`` under ``rules`` on a model zip: rank ``(d,
m)`` feeds the ``d``-th rows of each global batch; scores, ``output`` of
the first batch's rows, the whole params after ``sync_to_model``, the
global updater state, the state, the shapes each rank holds and the
trainer's stats), ``dt_orbax`` (a checkpoint of a trainer under rules
restored into one under the same rules, one without rules and a
``Solver``, and back), ``dt_reject`` (a ``DistributedTrainer`` that must
raise). Rules travel as ``[regex, [entry, ...]]``, an entry ``None``, an
axis name or a list of them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np


def run_world(cases, world: int, out_dir: str, timeout: float = 300.0) -> None:
    """Spawn ``world`` gloo ranks over ``cases``; raises with the ranks'
    output if one fails or outlives ``timeout``."""
    from deeplearning4j_tpu_torch.parallel.mesh import spawn_ranks, wait_ranks

    path = os.path.join(out_dir, f"parallel_cases_w{world}.json")
    with open(path, "w") as f:
        json.dump(cases, f)
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # the ranks share the test workers' cores
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = spawn_ranks([sys.executable, "-m", "deeplearning4j_tpu_torch.tools.parallel_cases",
                         path, out_dir], world, env=env, stdout=logs, stderr=subprocess.STDOUT)
    if wait_ranks(procs, timeout=timeout):
        out = []
        for r, log in enumerate(logs):
            log.seek(0)
            out.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n{log.read()[-4000:]}")
        raise RuntimeError("parallel-case ranks failed:\n" + "\n".join(out))


def result(out_dir: str, name: str, rank: int) -> dict:
    with np.load(os.path.join(out_dir, f"{name}.r{rank}.npz"), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _opt_leaves(tree) -> list:
    """The tensor leaves of an updater-state tree in JAX's tree order
    (sorted dict keys)."""
    import torch

    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(_np(node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(tree)
    return out


def _stage_fn(name):
    import torch

    from deeplearning4j_tpu_torch.parallel.pipeline import dense_block_stage

    if name == "add":
        return lambda p, a: a + p
    if name == "xor":
        return lambda p, a: torch.logical_xor(a, p[0])
    return dense_block_stage


def _case_apply(case, mesh, data):
    import torch

    from deeplearning4j_tpu_torch.parallel import pipeline_apply, shard_stage_params

    stage = case.get("stage", "dense")
    x = torch.from_numpy(data["x"])
    if stage != "dense":
        p = torch.from_numpy(data["p"])
        return {"out": _np(pipeline_apply(_stage_fn(stage), p, x, mesh))}
    params = {k: torch.from_numpy(data[k]) for k in ("W1", "b1", "W2", "b2")}
    if case.get("local"):
        params = shard_stage_params(params, mesh)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    x = x.clone().requires_grad_()
    out = pipeline_apply(_stage_fn(stage), params, x, mesh)
    torch.sum(out ** 2).backward()
    res = {"out": _np(out), "gx": _np(x.grad)}
    res.update({f"g/{k}": _np(v.grad) for k, v in params.items()})
    return res


def _case_value_and_grad(case, mesh, data):
    import torch

    from deeplearning4j_tpu_torch.parallel import pipeline_value_and_grad

    params = {k: torch.from_numpy(data[k]) for k in ("W1", "b1", "W2", "b2")}
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    loss, grads = pipeline_value_and_grad(
        _stage_fn("dense"), params, x, y, lambda o, t: torch.mean((o - t) ** 2), mesh,
        schedule=case["schedule"])
    res = {"loss": _np(loss)}
    res.update({f"g/{k}": _np(v) for k, v in grads.items()})
    return res


def _trainer(case, model, mesh):
    from deeplearning4j_tpu_torch.parallel import PipelineParallelTrainer, partition_stages

    kw = dict(case.get("kwargs", {}))
    if "partition_for" in case:  # a partition made for another stage count
        kw["partition"] = partition_stages(model, case["partition_for"])
    return PipelineParallelTrainer(model, mesh, **kw)


def _case_trainer(case, mesh, data):
    from deeplearning4j_tpu_torch.model import restore_model

    model = restore_model(case["zip"], device="cpu")
    tr = _trainer(case, model, mesh)
    scores = [float(tr.fit_batch(data["x"][s], data["y"][s])) for s in range(case["steps"])]
    opt = tr.opt_state
    tr.sync_to_model()
    st = tr.stats()
    res = {"scores": np.asarray(scores), "params": model.params_flat(),
           "stage_param_bytes": np.asarray(st["stage_param_bytes"]),
           "stage_param_bytes_global": np.asarray(st["stage_param_bytes_global"]),
           "bubble_share": np.asarray(st["bubble_share"]),
           "resident_microbatches": np.asarray(st["resident_microbatches"]),
           "n_stage_times": np.asarray(len(st["stage_times"] or [])),
           "stage": np.asarray(tr.stage)}
    for i, leaf in enumerate(_opt_leaves(opt)):
        res[f"opt/{i}"] = leaf
    return res


def _case_orbax(case, mesh, data):
    """Two pipelined steps, a checkpoint; restored into a differently
    scheduled pipeline trainer, a ZeRO-1 ``DistributedTrainer`` over every
    rank and a ``Solver``, each taking the third step; then the
    ``DistributedTrainer`` checkpoints its state and a pipeline trainer
    restores it and takes the fourth step beside it."""
    import torch

    from deeplearning4j_tpu_torch.model import restore_model
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer, make_mesh
    from deeplearning4j_tpu_torch.train import OrbaxCheckpointer, Solver

    x, y = data["x"], data["y"]
    d = case["dir"]
    tr = _trainer(case, restore_model(case["zip"], device="cpu"), mesh)
    scores = [float(tr.fit_batch(x[s], y[s])) for s in range(2)]
    ck = OrbaxCheckpointer(os.path.join(d, "pp"), async_save=False)
    ck.save(2, tr)
    ck.wait()
    other = dict(case, kwargs=dict(case["kwargs"], schedule="gpipe"))
    ref = _trainer(other, restore_model(case["zip"], device="cpu"), mesh)
    meta = ck.restore(ref)
    l_pp = float(ref.fit_batch(x[2], y[2]))

    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    per = x.shape[1] // world
    rows = slice(rank * per, (rank + 1) * per)
    dp = DistributedTrainer(restore_model(case["zip"], device="cpu"),
                            make_mesh(data=world), zero1=True)
    ck.restore(dp)
    l_dp = float(dp.fit_batch(x[2][rows], y[2][rows]))

    solver = Solver(restore_model(case["zip"], device="cpu"))
    ck.restore(solver)
    l_solver = float(solver.fit_batch(x[2], y[2])[0])

    ck2 = OrbaxCheckpointer(os.path.join(d, "dp"), async_save=False)
    ck2.save(3, dp)
    ck2.wait()
    tr2 = _trainer(case, restore_model(case["zip"], device="cpu"), mesh)
    ck2.restore(tr2)
    l_pp2 = float(tr2.fit_batch(x[3], y[3]))
    l_dp2 = float(dp.fit_batch(x[3][rows], y[3][rows]))
    tr2.sync_to_model()
    return {"scores": np.asarray(scores), "pp_step3": np.asarray(l_pp),
            "dp_step3": np.asarray(l_dp), "solver_step3": np.asarray(l_solver),
            "pp_step4": np.asarray(l_pp2), "dp_step4": np.asarray(l_dp2),
            "pipeline_stages": np.asarray(meta.get("pipeline_stages", -1)),
            "params_pp": tr2.model.params_flat(), "params_dp": dp.model.params_flat()}


def _case_reject(case, mesh, data):
    from deeplearning4j_tpu_torch.model import restore_model

    try:
        tr = _trainer(case, restore_model(case["zip"], device="cpu"), mesh)
        if data is not None:
            tr.fit_batch(data["x"], data["y"])
    except ValueError as e:
        return {"error": np.asarray("ValueError"), "message": np.asarray(str(e))}
    return {"error": np.asarray("none"), "message": np.asarray("")}


def _case_attention(case, mesh, data):
    import torch

    from deeplearning4j_tpu_torch.parallel import ring_attention, ulysses_attention

    fn = ring_attention if case["kind"] == "ring" else ulysses_attention
    q, k, v = (torch.from_numpy(data[n]).clone().requires_grad_() for n in ("q", "k", "v"))
    mask = torch.from_numpy(data["mask"]) if "mask" in data else None
    try:
        out = fn(q, k, v, mask=mask, causal=case.get("causal", False), mesh=mesh)
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    torch.sum(out ** 2).backward()
    return {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}


def _case_table(case, mesh, data):
    from deeplearning4j_tpu_torch.parallel import ShardedEmbeddingTable

    t = ShardedEmbeddingTable(case["vocab"], case["dim"], mesh, seed=case["seed"],
                              device="cpu")
    res = {"table": t.to_numpy(), "local_rows": np.asarray(t.table.shape[0]),
           "padded": np.asarray(t.padded_size), "shards": np.asarray(t.shard_count),
           "lookup": _np(t.lookup(data["ids"]))}
    t.add_sparse(data["ids"], data["deltas"])
    res["table_after"] = t.to_numpy()
    return res


def _case_w2v(case, mesh, data):
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w2v = Word2Vec(mesh=mesh, device="cpu", **case["kwargs"]).fit(case["sentences"])
    return {"syn0": w2v.syn0, "syn1": w2v.syn1}


def _rules(case):
    from deeplearning4j_tpu_torch.parallel import PartitionSpec

    return [(pat, PartitionSpec(*[tuple(e) if isinstance(e, list) else e for e in spec]))
            for pat, spec in case.get("rules", [])]


def _dt(case, model, mesh, rules=None, **over):
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer
    from deeplearning4j_tpu_torch.parallel import strategies as strat

    kw = dict(case.get("kwargs", {}), **over)
    name = kw.pop("strategy", "SyncAllReduce")
    strategy = getattr(strat, name)(**kw.pop("strategy_kw", {}))
    return DistributedTrainer(model, mesh, strategy=strategy,
                              param_sharding_rules=_rules(case) if rules is None else rules, **kw)


def _rows(x, mesh):
    from deeplearning4j_tpu_torch.parallel import local_batch_slice

    return x[local_batch_slice(x.shape[0], mesh, "data")]


def _case_dt(case, mesh, data):
    from deeplearning4j_tpu_torch.model import restore_model

    model = restore_model(case["zip"], device="cpu")
    tr = _dt(case, model, mesh)
    x, y = data["x"], data["y"]
    res = {}
    for ln, lp in model.params.items():  # what this rank holds
        for pn, p in lp.items():
            res[f"shape/{ln}/{pn}"] = np.asarray(p.shape)
    scores = [float(tr.fit_batch(_rows(x[s], mesh), _rows(y[s], mesh)))
              for s in range(case["steps"])]
    res["out"] = _np(tr.output(_rows(x[0], mesh)))
    opt = tr.gathered_updater_state()
    st = tr.stats()
    tr.sync_to_model()
    res.update({"scores": np.asarray(scores), "params": model.params_flat(),
                "ep_shards": np.asarray(tr.ep_shards)})
    for k in ("updater_state_bytes", "updater_state_bytes_global", "param_bytes",
              "param_bytes_global", "sharded_params"):
        res[k] = np.asarray(st[k])
    for i, leaf in enumerate(_opt_leaves(opt)):
        res[f"opt/{i}"] = leaf
    for ln, lst in model.state.items():
        for k, v in lst.items():
            res[f"state/{ln}/{k}"] = _np(v)
    return res


def _case_dt_orbax(case, mesh, data):
    """Three steps under rules and a checkpoint; the trainer goes on two
    steps (the reference). Restored into a trainer under the same rules
    (its two steps), into one without rules over every rank and into a
    ``Solver`` (one step each); then the ``Solver`` checkpoints and a
    trainer under rules restores it and takes the step after."""
    import torch

    from deeplearning4j_tpu_torch.model import restore_model
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.train import OrbaxCheckpointer, Solver

    x, y = data["x"], data["y"]
    d = case["dir"]

    def fresh(rules=None, m=mesh):
        return _dt(case, restore_model(case["zip"], device="cpu"), m, rules)

    def steps(tr, m, lo, hi):
        return [float(tr.fit_batch(_rows(x[s], m), _rows(y[s], m))) for s in range(lo, hi)]

    t1 = fresh()
    first = steps(t1, mesh, 0, 3)
    ck = OrbaxCheckpointer(os.path.join(d, "tp"), async_save=False)
    ck.save(3, t1)
    ck.wait()
    ref = steps(t1, mesh, 3, 5)
    t2 = fresh()
    meta = ck.restore(t2)
    resumed = steps(t2, mesh, 3, 5)
    world = torch.distributed.get_world_size()
    dmesh = make_mesh(data=world)
    dp = fresh([], dmesh)
    ck.restore(dp)
    dp_next = steps(dp, dmesh, 3, 4)
    solver = Solver(restore_model(case["zip"], device="cpu"))
    ck.restore(solver)
    solver_next = float(solver.fit_batch(x[3], y[3])[0])
    ck2 = OrbaxCheckpointer(os.path.join(d, "solver"), async_save=False)
    ck2.save(4, solver)  # every rank's Solver holds the same values; rank 0 writes
    ck2.wait()
    t3 = fresh()
    ck2.restore(t3)
    back = steps(t3, mesh, 4, 5)
    t2.sync_to_model()
    return {"first": np.asarray(first), "ref": np.asarray(ref), "resumed": np.asarray(resumed),
            "dp_next": np.asarray(dp_next), "solver_next": np.asarray(solver_next),
            "back": np.asarray(back), "iteration": np.asarray(meta["iteration"]),
            "params_resumed": t2.model.params_flat()}


def _case_dt_reject(case, mesh, data):
    from deeplearning4j_tpu_torch.model import restore_model

    try:
        tr = _dt(case, restore_model(case["zip"], device="cpu"), mesh)
        if data is not None:
            tr.fit_batch(_rows(data["x"], mesh), _rows(data["y"], mesh))
    except ValueError as e:
        return {"error": np.asarray("ValueError"), "message": np.asarray(str(e))}
    return {"error": np.asarray("none"), "message": np.asarray("")}


_KINDS = {"apply": _case_apply, "value_and_grad": _case_value_and_grad,
          "trainer": _case_trainer, "orbax": _case_orbax, "reject": _case_reject,
          "ring": _case_attention, "ulysses": _case_attention, "table": _case_table,
          "w2v": _case_w2v,
          "dt": _case_dt, "dt_orbax": _case_dt_orbax, "dt_reject": _case_dt_reject}


def _main(argv) -> int:
    path, out_dir = argv
    import torch

    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(device="cpu")
    rank = torch.distributed.get_rank()
    with open(path) as f:
        cases = json.load(f)
    meshes = {}
    for case in cases:
        key = json.dumps(case["mesh"], sort_keys=True)
        if key not in meshes:  # new_group is collective: every rank, same order
            meshes[key] = make_mesh(**case["mesh"])
        data = dict(np.load(case["data"])) if case.get("data") else None
        res = _KINDS[case["kind"]](case, meshes[key], data)
        np.savez(os.path.join(out_dir, f"{case['name']}.r{rank}.npz"), **res)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
