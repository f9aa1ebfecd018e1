"""Rank workers for the port's data-parallel parity tests
(``tests/test_torch_dp_*.py``).

A test module writes its cases (JAX model zips, seeded batches as npz) to a
directory, then :func:`run_world` spawns the ranks ONCE for the whole
module: ``world`` processes of this file, started by the port's
``spawn_ranks`` and joined by gloo, each running every case in turn and writing ``<case>.r<rank>.npz``.
The worker side imports only numpy, torch and the port; the test process
holds its results against the JAX package's trainer.

Case keys: ``name``; ``zip`` (the JAX model zip the weights come from);
``data`` (npz with ``x`` [steps, B, ...] and ``y`` global batches; rank r
takes the r-th block of rows); ``steps``; ``strategy`` and
``strategy_kwargs``; ``zero1``; ``bn_group_size``; ``graph`` (a
ComputationGraph); ``mode``: ``"fit_batch"`` (the default), ``"fit"``
(``batches``: global row counts, fed as local row blocks), ``"sharded"``
(``fit_iterator`` through a ``ShardedDataSetIterator``), ``"resume"``
(``restore_model(load_updater=True)`` and
``restore_training_state(trainer=)`` from the zip, then ``steps`` steps),
``"orbax_save"`` / ``"orbax_restore"`` (an ``OrbaxCheckpointer`` in
``dir``), ``"listener"`` (``fit`` under a ``CheckpointListener(trainer=)``
writing to ``dir``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np


def run_world(cases, world: int, out_dir: str, timeout: float = 240.0) -> None:
    """Spawn ``world`` ranks over ``cases`` (a list of dicts); raises with
    the ranks' output if one fails or outlives ``timeout``."""
    from deeplearning4j_tpu_torch.parallel.mesh import spawn_ranks, wait_ranks

    path = os.path.join(out_dir, f"cases_w{world}.json")
    with open(path, "w") as f:
        json.dump(cases, f)
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # the ranks share the workers' cores
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = spawn_ranks([sys.executable, __file__, path, out_dir], world, env=env, stdout=logs,
                        stderr=subprocess.STDOUT)
    if wait_ranks(procs, timeout=timeout):
        out = []
        for r, log in enumerate(logs):
            log.seek(0)
            out.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n{log.read()[-4000:]}")
        raise RuntimeError("data-parallel ranks failed:\n" + "\n".join(out))


def result(out_dir: str, name: str, rank: int) -> dict:
    with np.load(os.path.join(out_dir, f"{name}.r{rank}.npz"), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the rank side: torch and the port only
# ---------------------------------------------------------------------------


def _strategy(case):
    from deeplearning4j_tpu_torch.parallel import strategies

    return getattr(strategies, case.get("strategy", "SyncAllReduce"))(
        **case.get("strategy_kwargs", {}))


def _rows(a, rank, world):
    per = a.shape[0] // world
    return a[rank * per:(rank + 1) * per]


def _state_arrays(model) -> dict:
    return {f"state/{l}/{k}": v.detach().cpu().numpy()
            for l, st in model.state.items() for k, v in st.items() if v.is_floating_point()}


def _opt_leaves(tree) -> list:
    import torch

    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node.detach().cpu().numpy())
        elif isinstance(node, dict):  # in JAX's tree order: sorted keys
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(tree)
    return out


def _run_case(case, rank, world, out_dir):
    import torch

    from deeplearning4j_tpu_torch.model import restore_model
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer

    mode = case.get("mode", "fit_batch")
    model = restore_model(case["zip"], device="cpu", load_updater=(mode == "resume"))
    kw = dict(strategy=_strategy(case), zero1=case.get("zero1", False),
              bn_group_size=case.get("bn_group_size"))
    data = np.load(case["data"]) if case.get("data") else None
    scores, extra = [], {}
    graph = case.get("graph", False)

    def feed(x, y):
        return (x,) if graph else x, (y,) if graph else y

    if mode == "resume":
        from deeplearning4j_tpu_torch.train.checkpoint import restore_training_state

        trainer = DistributedTrainer(model, **kw)
        restore_training_state(model, case["sidecar"], trainer=trainer)
        extra["iteration_after_restore"] = np.asarray(trainer.iteration)
        mode = "fit_batch"
    elif mode == "orbax_restore":
        from deeplearning4j_tpu_torch.train import OrbaxCheckpointer

        trainer = DistributedTrainer(model, **kw)
        meta = OrbaxCheckpointer(case["dir"]).restore(trainer)
        extra["iteration"] = np.asarray(meta["iteration"])
        extra["saved_data_axis"] = np.asarray(meta["data_axis"])
        for i, leaf in enumerate(_opt_leaves(trainer.gathered_updater_state())):
            extra[f"opt/{i}"] = leaf
        mode = "none"
    else:
        trainer = DistributedTrainer(model, **kw)
    if mode == "fit_batch":
        for s in range(case["steps"]):
            x, y = feed(_rows(data["x"][s], rank, world), _rows(data["y"][s], rank, world))
            scores.append(float(trainer.fit_batch(x, y)))
        trainer.sync_to_model()
    elif mode == "fit":
        xs, ys, off = [], [], 0
        for n in case["batches"]:  # global batches, each split into local blocks
            xs.append(_rows(data["x"][off:off + n], rank, world))
            ys.append(_rows(data["y"][off:off + n], rank, world))
            off += n
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        import warnings

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.fit([DataSet(x, y) for x, y in zip(xs, ys)])
        extra["warned"] = np.asarray(sum("tail row" in str(w.message) for w in caught))
        scores.append(float(model.score_value))
    elif mode == "listener":
        from deeplearning4j_tpu_torch.train import CheckpointListener

        model.add_listeners(CheckpointListener(case["dir"], save_every_n_iterations=case["steps"],
                                               trainer=trainer))
        trainer.fit([(_rows(data["x"][s], rank, world), _rows(data["y"][s], rank, world))
                     for s in range(case["steps"])])
    elif mode == "sharded":
        from deeplearning4j_tpu_torch.data import (ListDataSetIterator, ShardedDataSetIterator)
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        # this rank's rows of every global batch, in order: its iterator
        # yields the local block of each
        per = case["global_batch"] // world
        x = np.concatenate([_rows(b, rank, world) for b in data["x"]])
        y = np.concatenate([_rows(b, rank, world) for b in data["y"]])
        it = ShardedDataSetIterator(ListDataSetIterator(DataSet(x, y), per),
                                    trainer.data_sharding)
        extra["global_batch_size"] = np.asarray(it.batch_size())
        trainer.fit_iterator(it, epochs=1)
        scores.append(float(model.score_value))
    if mode == "orbax_save":
        from deeplearning4j_tpu_torch.train import OrbaxCheckpointer

        for s in range(case["steps"]):
            scores.append(float(trainer.fit_batch(_rows(data["x"][s], rank, world),
                                                  _rows(data["y"][s], rank, world))))
        ck = OrbaxCheckpointer(case["dir"], async_save=True)
        ck.save(trainer.iteration, trainer)
        ck.wait()
        for i, leaf in enumerate(_opt_leaves(trainer.gathered_updater_state())):
            extra[f"opt/{i}"] = leaf
    if case.get("updater"):
        for i, leaf in enumerate(_opt_leaves(trainer.gathered_updater_state())):
            extra[f"opt/{i}"] = leaf
    comp = trainer.compression_stats() if getattr(trainer.strategy, "compressed", False) else None
    np.savez(os.path.join(out_dir, f"{case['name']}.r{rank}.npz"),
             params=model.params_flat(), scores=np.asarray(scores, np.float64),
             iteration_count=np.asarray(model.iteration_count),
             dropped_rows=np.asarray(trainer.dropped_rows),
             updater_bytes=np.asarray(trainer.updater_state_bytes()),
             updater_bytes_global=np.asarray(trainer.updater_state_bytes(per_replica=False)),
             density=np.asarray(np.nan if comp is None else comp["density"]),
             threshold=np.asarray(np.nan if comp is None or "threshold" not in comp
                                  else comp["threshold"]),
             **_state_arrays(model), **extra)
    torch.distributed.barrier()


def _main(argv) -> int:
    path, out_dir = argv
    import torch

    torch.set_num_threads(1)
    from deeplearning4j_tpu_torch.parallel import initialize_distributed

    initialize_distributed(device="cpu")
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    with open(path) as f:
        cases = json.load(f)
    for case in cases:
        _run_case(case, rank, world, out_dir)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
