#!/usr/bin/env python
"""Elastic resize chaos harness of the port: the counterpart of the JAX
package's ``tools/check_elastic_resize_contract.py``.

It drives a real ZeRO-1 ``DistributedTrainer`` run through a 2 -> 1 -> 2
resize of the data axis by SIGKILLing every rank of a boot twice and
changing the width ``elastic_fit(mesh_size_fn=...)`` resolves between
boots. A boot at width N is N rank processes (one per replica, joined by
gloo; on a card they share it); the trainer checkpoints through the port's
``OrbaxCheckpointer`` (global shapes, no deflate), which carries the
iterator's cursor and the counters in its ``meta.json``. Two legs run
concurrently:

  * **reference**: width 2 throughout: the consumed-batch sequence (content
    hashes of the GLOBAL batches at the consumer) and the final eval loss;
  * **resize**: boot 1 at width 2 holds at ``kill1`` and is SIGKILLed once
    that step's checkpoint is committed, boot 2 at width 1 resumes and is
    SIGKILLed at ``kill2``, boot 3 at width 2 finishes. It asserts:

    - both restarts are ``reshard`` events (2 -> 1, 1 -> 2) and count under
      ``reason="resize"``; both boots died of SIGKILL;
    - the ZeRO-1 updater state was restored onto both widths: every
      resumed boot logs a nonzero moment norm (fresh Adam moments are
      zero) and a per-rank slice of ``dim0 / width`` rows;
    - nothing trained twice, nothing skipped: the committed prefixes of
      boots 1 and 2 plus boot 3's consumption are the reference sequence,
      batch for batch (the cursor counts global steps, and the global
      batch does not change with the width);
    - the final eval loss is inside a quality gate of the reference (the
      widths only change the reduction order of the same global-batch
      gradient);
    - the goodput ledger prices the outage: ``reshard`` downtime > 0 and
      the ratio in (0, 1];
    - each resumed boot restores the checkpoint the killed boot committed
      bit for bit: the parameters and the gathered updater state hash as
      the writer's did, at width 2 -> 1 (a ZeRO-1 trainer holds every leaf
      whole at width 1) and at 1 -> 2.

Two configurations: ``"mlp"`` (the JAX harness's network, Dense 8 tanh and
softmax 2, ``Adam(0.02)``, 12 steps of 8 rows, a checkpoint every step;
tier-1 runs it on the CPU in ``tests/test_torch_elastic_resize_contract.py``) and
``"lm"`` (the ``TransformerLM`` at GPT-2 small's widths cut to 2 blocks,
float32, ``Adam(1e-4)``, 6 steps of [8, 1024], a checkpoint every 2 steps;
each is about 1.1 GB of parameters and moments).

Run ``python -m deeplearning4j_tpu_torch.tools.check_elastic_resize_contract
[--device cpu] [--model lm]``: on the card unless ``--device`` says
otherwise. The legs' directories are removed at the end unless
``DL4J_CHAOS_KEEP_DIR=1``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import shutil
import signal
import sys
import tempfile
import time

ENTRY_REF = "deeplearning4j_tpu_torch.tools.check_elastic_resize_contract:train_entry"
CONSUMED_LOG = "consumed.log"
BOOTS_LOG = "boots.log"
FINAL_JSON = "final.json"
SAVED_LOG = "saved.log"
WIDTH_FULL, WIDTH_HALF = 2, 1

CONFIGS = {
    "mlp": dict(total=12, batch=8, rows=96, dim0=8, save_every=1, kills=(4, 8), pacer=0.02,
                stall_timeout=120.0),
    "lm": dict(total=6, batch=8, rows=48, seq=1024, save_every=2, kills=(3, 5), pacer=0.0,
               stall_timeout=600.0),
}
LM_WIDTHS = dict(vocab_size=50257, hidden=768, n_layers=2, n_heads=12, ffn_size=3072,
                 max_len=1024)


# ---------------------------------------------------------------------------
# child-side pieces (imported by the spawned ranks)
# ---------------------------------------------------------------------------

class _AppendLog:
    """Crash-safe append log: one fsync'd line per event, plus a RUN marker
    per process so the parent can split the runs apart."""

    def __init__(self, path: str) -> None:
        self._f = open(path, "a")
        self.write(f"RUN {os.getpid()}")

    def write(self, line: str) -> None:
        self._f.write(line + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())


class _LocalRows:
    """This rank's block of each GLOBAL batch, hashed (on rank 0) as the
    consumer pulls it: the hash is of the global rows, so it does not
    depend on the width."""

    def __init__(self, underlying, rank: int, world: int, log=None) -> None:
        self.underlying, self.rank, self.world, self.log = underlying, rank, world, log

    def has_next(self):
        return self.underlying.has_next()

    def next(self):
        import numpy as np

        from deeplearning4j_tpu_torch.data.dataset import DataSet

        ds = self.underlying.next()
        if self.log is not None:
            self.log.write(hashlib.sha1(np.ascontiguousarray(ds.features).tobytes())
                           .hexdigest()[:12])
        per = ds.features.shape[0] // self.world
        rows = slice(self.rank * per, (self.rank + 1) * per)
        return DataSet(ds.features[rows], ds.labels[rows])

    def reset(self):
        self.underlying.reset()

    def batch_size(self):
        return self.underlying.batch_size() // self.world

    def state_dict(self):
        return self.underlying.state_dict()

    def load_state_dict(self, state):
        self.underlying.load_state_dict(state)


def _build_model(kind: str, device: str):
    from deeplearning4j_tpu_torch.train.updaters import Adam

    if kind == "lm":
        from deeplearning4j_tpu_torch.model.zoo import TransformerLM

        return TransformerLM(**LM_WIDTHS, seed=17, dtype="float32",
                             updater=Adam(1e-4)).init(device=device)
    from deeplearning4j_tpu_torch.nn import (Activation, InputType, LossFunction,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

    dim0 = CONFIGS["mlp"]["dim0"]
    # dim0 input features: every kernel and bias has a dim 0 that both
    # widths divide, so ZeRO-1 slices the updater state at width 2
    conf = (NeuralNetConfiguration.builder().seed(17).updater(Adam(0.02)).list()
            .layer(DenseLayer(n_out=dim0, activation=Activation.TANH))
            .layer(OutputLayer(n_out=2, loss=LossFunction.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(dim0)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _rows(kind: str, cfg: dict, seed: int = 3):
    import numpy as np

    rng = np.random.RandomState(seed)
    if kind == "lm":
        ids = rng.randint(0, LM_WIDTHS["vocab_size"], (cfg["rows"], cfg["seq"] + 1))
        return ids[:, :-1], ids[:, 1:]
    x = rng.rand(cfg["rows"], cfg["dim0"]).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[rng.randint(0, 2, cfg["rows"])]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _opt_tensors(tree) -> list:
    import torch

    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(tree)
    return out


def _opt_stats(trainer):
    """(sum of |moments| over this rank's updater state, the rows this rank
    holds of the first sliced leaf's param and that param's dim 0). Fresh
    Adam moments sum to exactly 0."""
    leaves = _opt_tensors(trainer.opt_state)
    norm = float(sum(float(t.abs().sum()) for t in leaves if t.is_floating_point()))
    for ln, lp in trainer.model.params.items():
        for pn, p in lp.items():
            if p.ndim and p.shape[0] % 2 == 0:  # slices at width 2
                st = trainer.opt_state[ln]
                mu = st[0].mu[pn] if isinstance(st, tuple) else st["mu"][pn]
                return norm, int(mu.shape[0]), int(p.shape[0])
    return norm, None, None


def train_entry(resume_path, checkpoint_dir, mesh_size=None):
    """Resize-aware ``elastic_fit`` entry, run by every rank of a boot: it
    builds the ZeRO-1 trainer at this boot's width, restores the latest
    checkpoint (parameters, the updater state cut to this width, the
    iterator's cursor, the counters) and trains to the configuration's
    step count, checkpointing as it goes."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.core.listeners import TrainingListener
    from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                               ShardedDataSetIterator)
    from deeplearning4j_tpu_torch.parallel import DistributedTrainer, initialize_distributed
    from deeplearning4j_tpu_torch.train import HeartbeatListener, OrbaxCheckpointer

    kind = os.environ.get("DL4J_CHAOS_MODEL", "mlp")
    device = os.environ["DL4J_CHAOS_DEVICE"]
    cfg = CONFIGS[kind]
    width = int(mesh_size or 1)
    initialize_distributed(backend="gloo", device="cuda:0" if device == "cuda" else "cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    assert world == width, (world, width)
    dev = "cuda" if device == "cuda" else "cpu"
    model = _build_model(kind, dev)
    trainer = DistributedTrainer(model, zero1=True)
    ck = OrbaxCheckpointer(os.path.join(checkpoint_dir, "orbax"), max_to_keep=2)
    x, y = _rows(kind, cfg)
    consumed = _AppendLog(os.path.join(checkpoint_dir, CONSUMED_LOG)) if rank == 0 else None
    launches = _AppendLog(os.path.join(checkpoint_dir, f"launches.r{rank}.log"))
    base = ListDataSetIterator(DataSet(x, y), cfg["batch"], shuffle=True, seed=11)
    it = ShardedDataSetIterator(_LocalRows(base, rank, world, consumed), trainer.data_sharding)
    def digests():  # collective: the ZeRO-1 slices are gathered
        return {"params_sha256": _digest(p for lp in model.params.values() for p in lp.values()),
                "opt_sha256": _digest(_opt_tensors(trainer.gathered_updater_state()))}

    boot = {"width": world, "resumed": False}
    if ck.latest_step() is not None:
        meta = ck.restore(trainer)
        it.load_state_dict(meta["iterator"])
        model.iteration_count = int(meta["model_iteration_count"])
        model.epoch_count = int(meta["model_epoch_count"])
        boot.update(resumed=True, restored_step=ck.latest_step(), restored=digests())
    norm, held, dim0 = _opt_stats(trainer)
    boot.update(start_iter=model.iteration_count, opt_norm=norm, held_rows=held, param_rows=dim0)
    if rank == 0:
        _AppendLog(os.path.join(checkpoint_dir, BOOTS_LOG)).write(json.dumps(boot))
    hold = int(os.environ.get("DL4J_ELASTIC_HOLD_AT", "0"))
    last_save = hold - hold % cfg["save_every"]  # what the parent waits for

    class _Checkpoint(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            launches.write(json.dumps(ops.LAUNCH_COUNTS))  # this process's, so far
            if iteration % cfg["save_every"] == 0:
                ck.save(iteration, trainer, extra={
                    "iterator": it.state_dict(), "model_iteration_count": iteration,
                    "model_epoch_count": model.epoch_count})
                if hold and iteration == last_save:  # the values the next boot restores
                    saved = {"step": iteration, "width": world, **digests()}
                    if rank == 0:
                        _AppendLog(os.path.join(checkpoint_dir, SAVED_LOG)).write(
                            json.dumps(saved))

    class _Hold(TrainingListener):
        """Waits at this boot's kill step for the parent's SIGKILL."""

        def iteration_done(self, model, iteration, epoch, score):
            if iteration == hold:
                deadline = time.monotonic() + 900
                while time.monotonic() < deadline:
                    time.sleep(0.05)

    class _Pacer(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            time.sleep(cfg["pacer"])

    listeners = [_Checkpoint()]
    if rank == 0:
        listeners.append(HeartbeatListener(checkpoint_dir))
    if cfg["pacer"]:
        listeners.append(_Pacer())
    listeners.append(_Hold())
    model.add_listeners(*listeners)
    while model.iteration_count < cfg["total"]:
        trainer.fit_iterator(it, epochs=1)
    ck.wait()
    final = {"iteration": model.iteration_count, "width": world}
    ex, ey = _rows(kind, cfg, seed=29)
    final["eval_loss"] = float(model.score(ex[:16], ey[:16]))
    if rank == 0:
        with open(os.path.join(checkpoint_dir, FINAL_JSON), "w") as f:
            json.dump(final, f)
    dist.barrier()


# ---------------------------------------------------------------------------
# parent-side orchestration
# ---------------------------------------------------------------------------

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))


def _child_env(kind: str, device: str) -> dict:
    env = {"PYTHONPATH": os.pathsep.join([_REPO_ROOT, os.environ.get("PYTHONPATH", "")]),
           "DL4J_CHAOS_MODEL": kind, "DL4J_CHAOS_DEVICE": device}
    if device != "cuda":
        env["OMP_NUM_THREADS"] = "1"
    return env


def _latest(ckpt_dir: str):
    from deeplearning4j_tpu_torch.train import OrbaxCheckpointer

    d = os.path.join(ckpt_dir, "orbax")
    return OrbaxCheckpointer(d).latest_step() if os.path.isdir(d) else None


class _ResizeSpawner:
    """``elastic_fit`` spawn_fn: boots the ranks at the width elastic_fit
    resolved, and for boot ``i`` with ``holds[i]`` set, SIGKILLs every rank
    once rank 0's heartbeat reaches the hold step and the checkpoint at or
    before it is committed. Records exit codes, widths, boot-to-first-step
    seconds and the committed step between a death and its restart."""

    def __init__(self, ckpt_dir, kind, device, *, holds=(), save_every=1,
                 stall_timeout=120.0, extra_env=None) -> None:
        self.ckpt_dir, self.kind, self.device = ckpt_dir, kind, device
        self.holds = list(holds)
        self.save_every = save_every
        self.stall_timeout = stall_timeout
        self.extra_env = extra_env or {}
        self.rcs, self.widths, self.committed_between, self.boot_seconds = [], [], [], []

    def __call__(self, mesh_size=None) -> int:
        from deeplearning4j_tpu_torch.parallel.mesh import wait_ranks
        from deeplearning4j_tpu_torch.train.fault_tolerance import _spawn_world, read_heartbeat

        boot = len(self.rcs)
        if boot:
            self.committed_between.append(_latest(self.ckpt_dir))
        self.widths.append(mesh_size)
        hold = self.holds[boot] if boot < len(self.holds) else None
        env = {**_child_env(self.kind, self.device), **self.extra_env}
        if hold:
            env["DL4J_ELASTIC_HOLD_AT"] = str(hold)
        spawned = time.time()
        with open(os.path.join(self.ckpt_dir, f"child.{boot}.err"), "wb") as err:
            procs = _spawn_world(ENTRY_REF, self.ckpt_dir, self.stall_timeout, env, mesh_size,
                                 stderr=err)
            if hold:
                want = hold - hold % self.save_every
                deadline = time.monotonic() + 1800
                while time.monotonic() < deadline:
                    hb = read_heartbeat(self.ckpt_dir)
                    if (hb and hb.get("pid") == procs[0].pid and hb["iteration"] >= hold
                            and (_latest(self.ckpt_dir) or 0) >= want):
                        break
                    if any(p.poll() is not None for p in procs):
                        break
                    time.sleep(0.05)
                for p in procs:
                    if p.poll() is None:
                        p.send_signal(signal.SIGKILL)
            rc = wait_ranks(procs)
        hb = read_heartbeat(self.ckpt_dir)
        if hb and isinstance(hb.get("first_ts"), (int, float)) and hb["first_ts"] >= spawned:
            self.boot_seconds.append(hb["first_ts"] - spawned)
        self.rcs.append(rc)
        return rc


def _parse_runs(path: str):
    runs = []
    if not os.path.exists(path):
        return runs
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("RUN "):
                runs.append([])
            elif line and runs:
                runs[-1].append(line)
    return runs


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _launches(ckpt_dir: str) -> dict:
    total: dict = {}
    for name in os.listdir(ckpt_dir):
        if name.startswith("launches."):
            for run in _parse_runs(os.path.join(ckpt_dir, name)):
                for k, v in (json.loads(run[-1]) if run else {}).items():
                    total[k] = total.get(k, 0) + v
    return total


def _run_elastic(ckpt_dir, spawner, log, *, widths, **kw):
    from deeplearning4j_tpu_torch.core.resilience import RetryPolicy
    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.train.fault_tolerance import elastic_fit

    os.makedirs(ckpt_dir, exist_ok=True)
    kw.setdefault("retry_policy",
                  RetryPolicy(max_retries=5, initial_backoff=0.05, max_backoff=0.2))
    reg = kw.pop("registry", None) or MetricsRegistry()
    res = elastic_fit(ENTRY_REF, ckpt_dir, spawn_fn=spawner, registry=reg,
                      stall_timeout=spawner.stall_timeout,
                      mesh_size_fn=lambda: widths[min(len(spawner.rcs), len(widths) - 1)],
                      log_fn=lambda m: log(f"  {os.path.basename(ckpt_dir)}: {m}"), **kw)
    return res, reg


def run_legs(device: str = "cuda", model: str = "mlp", log=print) -> dict:
    """Run the reference and resize legs concurrently and check the
    contract; returns what each leg measured. Raises AssertionError on a
    broken contract."""
    base = tempfile.mkdtemp(prefix="elastic_resize_")
    try:
        return _run_legs(base, device, model, log)
    finally:
        if os.environ.get("DL4J_CHAOS_KEEP_DIR") == "1":
            log(f"legs kept in {base}")
        else:
            shutil.rmtree(base, ignore_errors=True)


def _run_legs(base: str, device: str, model: str, log) -> dict:
    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry

    cfg = CONFIGS[model]
    total = cfg["total"]
    if device == "cuda":
        from deeplearning4j_tpu_torch.ops import cuda_build

        cuda_build.build_all()  # the ranks load these; none rebuilds
    kill1, kill2 = cfg["kills"]
    sp1 = _ResizeSpawner(os.path.join(base, "reference"), model, device,
                         save_every=cfg["save_every"], stall_timeout=cfg["stall_timeout"])
    sp2 = _ResizeSpawner(os.path.join(base, "resize"), model, device, holds=(kill1, kill2),
                         save_every=cfg["save_every"], stall_timeout=cfg["stall_timeout"])
    reg = MetricsRegistry()

    def leg(sp, widths, **kw):
        t0 = time.perf_counter()
        res, _ = _run_elastic(sp.ckpt_dir, sp, log, widths=widths, **kw)
        return res, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        f1 = pool.submit(leg, sp1, [WIDTH_FULL], max_restarts=0)
        f2 = pool.submit(leg, sp2, [WIDTH_FULL, WIDTH_HALF, WIDTH_FULL], max_restarts=3,
                         registry=reg)
        (res1, sec1), (res2, sec2) = f1.result(), f2.result()

    # -- leg 1: fixed-width reference -------------------------------------
    d1 = sp1.ckpt_dir
    assert res1["ok"] and res1["restarts"] == 0, res1
    fin1 = _json(os.path.join(d1, FINAL_JSON))
    assert fin1["iteration"] == total and fin1["width"] == WIDTH_FULL, fin1
    seq = _parse_runs(os.path.join(d1, CONSUMED_LOG))[0]
    assert len(seq) == total, len(seq)
    log(f"[1/3] reference at width {WIDTH_FULL}: {total} iterations, eval loss "
        f"{fin1['eval_loss']:.4f}")

    # -- leg 2: 2 -> 1 -> 2 under SIGKILL ---------------------------------
    d2 = sp2.ckpt_dir
    assert res2["ok"] and res2["restarts"] == 2, res2
    assert sp2.rcs == [-signal.SIGKILL, -signal.SIGKILL, 0], sp2.rcs
    assert sp2.widths == [WIDTH_FULL, WIDTH_HALF, WIDTH_FULL], sp2.widths
    reshards = [e for e in res2["events"] if e["event"] == "reshard"]
    assert [(e["from_width"], e["to_width"]) for e in reshards] == \
        [(WIDTH_FULL, WIDTH_HALF), (WIDTH_HALF, WIDTH_FULL)], reshards
    r = reg.counter("dl4j_tpu_training_restarts_total", "", ("reason",))
    assert r.labels("resize").value == 2, r.labels("resize").value
    boots = [json.loads(ln) for run in _parse_runs(os.path.join(d2, BOOTS_LOG)) for ln in run]
    assert [b["width"] for b in boots] == [WIDTH_FULL, WIDTH_HALF, WIDTH_FULL], boots
    assert [b["resumed"] for b in boots] == [False, True, True], boots
    assert boots[0]["opt_norm"] == 0.0 and all(b["opt_norm"] > 0.0 for b in boots[1:]), boots
    for b in boots:  # ZeRO-1 slices at this width (whole at width 1)
        assert b["held_rows"] == b["param_rows"] // b["width"], b
    c1, c2 = sp2.committed_between
    want1, want2 = (k - k % cfg["save_every"] for k in (kill1, kill2))
    assert c1 == want1 and c2 == want2, (c1, c2, want1, want2)
    assert [b["start_iter"] for b in boots] == [0, c1, c2], (boots, c1, c2)
    p1, p2, rest = _parse_runs(os.path.join(d2, CONSUMED_LOG))
    assert len(p1) >= c1 and len(p2) >= c2 - c1, (len(p1), len(p2), c1, c2)
    assert p1[:c1] + p2[:c2 - c1] + rest == seq, (c1, c2, len(p1), len(p2), len(rest))
    fin2 = _json(os.path.join(d2, FINAL_JSON))
    assert fin2["iteration"] == total, fin2
    gate = max(0.02, 0.05 * abs(fin1["eval_loss"]))
    assert abs(fin2["eval_loss"] - fin1["eval_loss"]) <= gate, (fin2, fin1, gate)
    gp = res2["goodput"]
    assert 0.0 < gp["ratio"] <= 1.0 and gp["downtime_seconds"]["reshard"] > 0.0, gp
    log(f"[2/3] resize {WIDTH_FULL}->{WIDTH_HALF}->{WIDTH_FULL}: SIGKILL at {kill1} "
        f"(committed {c1}) and {kill2} (committed {c2}), ZeRO-1 state restored on both "
        f"widths, nothing consumed twice or skipped, eval loss {fin2['eval_loss']:.4f} vs "
        f"{fin1['eval_loss']:.4f} (gate {gate:.3f}), goodput {gp['ratio']:.3f} with "
        f"{gp['downtime_seconds']['reshard']:.2f} s reshard downtime")

    # -- 3: each resumed boot restored the killed boot's checkpoint exactly ----
    saved = {json.loads(ln)["step"]: json.loads(ln) for run in
             _parse_runs(os.path.join(d2, SAVED_LOG)) for ln in run}
    for b in boots[1:]:
        w = saved[b["restored_step"]]
        assert b["restored"]["params_sha256"] == w["params_sha256"], (b, w)
        assert b["restored"]["opt_sha256"] == w["opt_sha256"], (b, w)
    log(f"[3/3] the width-{WIDTH_FULL} ZeRO-1 checkpoint at step {c1} restored at width "
        f"{WIDTH_HALF}, and the width-{WIDTH_HALF} one at step {c2} at width {WIDTH_FULL}: "
        f"parameters and updater state bit for bit the writer's")
    log("elastic resize contract OK")
    return {"reference": {"result": res1, "seconds": sec1, "rcs": sp1.rcs,
                          "boot_seconds": sp1.boot_seconds, "launches": _launches(d1)},
            "resize": {"result": res2, "seconds": sec2, "rcs": sp2.rcs, "widths": sp2.widths,
                       "committed": [c1, c2], "boot_seconds": sp2.boot_seconds,
                       "launches": _launches(d2), "eval_loss": fin2["eval_loss"],
                       "reference_eval_loss": fin1["eval_loss"]}}


def main(log=print, device: str = "cuda", model: str = "mlp") -> int:
    run_legs(device, model, log)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="mlp", choices=sorted(CONFIGS))
    args = ap.parse_args()
    sys.exit(main(device=args.device, model=args.model))
