#!/usr/bin/env python
"""Fault-tolerant-training chaos harness of the port: the counterpart of
the JAX package's ``tools/check_training_resilience_contract.py``.

It runs a real supervised trainer (``elastic_fit`` spawning child
processes; a ``CheckpointListener`` carrying the iterator cursor and the
dropout stream in its sidecar; ``HeartbeatListener`` and the watchdog;
``PreemptionHandler``) through four legs, each in its own directory, and
holds every leg's final parameters BIT-IDENTICAL to the first's:

  1. **uninterrupted**: the reference run: final parameters, the loss
     curve and the consumed-batch sequence (hashed at the consumer);
  2. **SIGKILL** mid-epoch, once a checkpoint is committed: the supervisor
     sees a crash and restarts from the last committed checkpoint; the
     committed prefix of the killed run's batches plus the resumed run's
     batches is exactly the uninterrupted sequence, and so is the loss
     curve;
  3. **SIGTERM** (a preemption notice): the child finishes the step in
     flight, forces a final synchronous checkpoint and exits
     ``PREEMPTED_EXIT_CODE`` with ZERO lost iterations (the final
     checkpoint's iteration is the last heartbeat's); ``elastic_fit``
     restarts it at once, without spending crash budget;
  4. **stall** (the step loop stops beating, as on a wedged device): the
     watchdog hard-exits ``STALL_EXIT_CODE`` and the supervisor restarts.

The legs run concurrently, each under its own ``elastic_fit`` and metrics
registry. Two configurations:

* ``"mlp"``: the JAX harness's network (Dense 8 tanh, softmax 2; seed 17,
  ``Adam(0.02)``), 24 iterations of 8 rows behind an
  ``AsyncDataSetIterator``, an async checkpoint every iteration; the kill
  and stall points are random mid-epoch iterations (``DL4J_CHAOS_SEED``
  pins them). tier-1 runs it on the CPU
  (``tests/test_torch_fault_tolerance.py``).
* ``"lm"``: the ``TransformerLM`` at GPT-2 small's widths with 2 blocks
  (vocab 50257, hidden 768, 12 heads, ffn 3072, 1024 positions; float32,
  ``Adam(1e-4)``), 6 iterations of [8, 1024] tokens, the main training
  path's batch; one checkpoint at iteration 4 (its zip holds the
  parameters and Adam's two moments, about 1.1 GB; 1.96 GB at 12 blocks,
  which is why the depth is cut). Each write takes seconds, so
  the faults land at fixed points: at iteration 5 the child holds until a
  signal comes, the SIGKILL and SIGTERM legs send theirs once iteration
  4's checkpoint is committed, and the stall leg stops beating at
  iteration 5 with a watchdog timeout longer than the write.

Run it with ``python -m deeplearning4j_tpu_torch.tools.
check_training_resilience_contract [--device cpu] [--model lm]``: on the
card unless ``--device`` says otherwise. The legs' directories are removed
at the end unless ``DL4J_CHAOS_KEEP_DIR=1``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ENTRY_REF = "deeplearning4j_tpu_torch.tools.check_training_resilience_contract:train_entry"
CONSUMED_LOG = "consumed.log"
SCORES_LOG = "scores.log"
LAUNCHES_LOG = "launches.log"
FINAL_NPZ = "final.npz"
_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, os.pardir))

CONFIGS = {
    "mlp": dict(total=24, batch=8, rows=64, save_every=1, keep_last=5, pacer=0.05,
                stall_timeout=20.0, hold_at=0),
    # the stall leg's watchdog: the 1.1 GB stored zip lands in about 7 s,
    # and a restoring child beats first 14-16 s after its spawn (H100 runs)
    "lm": dict(total=6, batch=8, rows=48, seq=1024, save_every=4, keep_last=2, pacer=0.0,
               stall_timeout=30.0, hold_at=5),
}
LM_WIDTHS = dict(vocab_size=50257, hidden=768, n_layers=2, n_heads=12, ffn_size=3072,
                 max_len=1024)


# ---------------------------------------------------------------------------
# child-side pieces (imported by the spawned trainer)
# ---------------------------------------------------------------------------

class _AppendLog:
    """Crash-safe append log: one fsync'd line per event, plus a RUN
    marker per process so the parent can split the runs apart."""

    def __init__(self, path: str) -> None:
        self._f = open(path, "a")
        self.write(f"RUN {os.getpid()}")

    def write(self, line: str) -> None:
        self._f.write(line + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())


class _LoggingIterator:
    """Wraps the training iterator OUTSIDE the async prefetcher: each
    batch is hashed as the consumer receives it."""

    def __init__(self, underlying, log: _AppendLog) -> None:
        self.underlying = underlying
        self.log = log

    def has_next(self):
        return self.underlying.has_next()

    def next(self):
        import numpy as np

        from deeplearning4j_tpu_torch.core.dtypes import to_numpy

        ds = self.underlying.next()
        feats = np.ascontiguousarray(to_numpy(ds.features))
        self.log.write(hashlib.sha1(feats.tobytes()).hexdigest()[:12])
        return ds

    def reset(self):
        self.underlying.reset()

    def batch_size(self):
        return self.underlying.batch_size()

    def state_dict(self):
        return self.underlying.state_dict()

    def load_state_dict(self, state):
        self.underlying.load_state_dict(state)

    def close(self, *a, **kw):
        c = getattr(self.underlying, "close", None)
        if callable(c):
            c(*a, **kw)


def _build_model(kind: str, device: str):
    from deeplearning4j_tpu_torch.train.updaters import Adam

    if kind == "lm":
        from deeplearning4j_tpu_torch.model.zoo import TransformerLM

        lm = TransformerLM(**LM_WIDTHS, seed=17, dtype="float32", updater=Adam(1e-4))
        return lm.init(device=device)
    from deeplearning4j_tpu_torch.nn import (Activation, InputType, LossFunction,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(17).updater(Adam(0.02))
            .list()
            .layer(DenseLayer(n_out=8, activation=Activation.TANH))
            .layer(OutputLayer(n_out=2, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _make_iterator(kind: str, cfg: dict, log: _AppendLog):
    import numpy as np

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import (AsyncDataSetIterator,
                                                         ListDataSetIterator)

    rng = np.random.RandomState(3)
    if kind == "lm":
        ids = rng.randint(0, LM_WIDTHS["vocab_size"], (cfg["rows"], cfg["seq"] + 1))
        ds = DataSet(ids[:, :-1], ids[:, 1:])
    else:
        x = rng.rand(cfg["rows"], 4).astype(np.float32)
        ds = DataSet(x, np.eye(2, dtype=np.float32)[rng.randint(0, 2, cfg["rows"])])
    base = ListDataSetIterator(ds, cfg["batch"], shuffle=True, seed=11)
    # the async prefetch sits BETWEEN the cursor-owning base iterator and the
    # logging consumer: the kill legs exercise the run-ahead-not-counted
    # property of the iterator's state protocol
    return _LoggingIterator(AsyncDataSetIterator(base, queue_size=4), log)


def train_entry(resume_path, checkpoint_dir):
    """elastic_fit entry point: fresh or resumed, it trains to exactly the
    configuration's iteration count, checkpointing as it goes."""
    import numpy as np

    from deeplearning4j_tpu_torch.core.listeners import TrainingListener
    from deeplearning4j_tpu_torch.model.serializer import restore_model
    from deeplearning4j_tpu_torch.train.checkpoint import (CheckpointListener,
                                                           restore_training_state)
    from deeplearning4j_tpu_torch.train.fault_tolerance import (HeartbeatListener,
                                                                PreemptionHandler)
    from deeplearning4j_tpu_torch.train.solver import Solver

    kind = os.environ.get("DL4J_CHAOS_MODEL", "mlp")
    device = os.environ["DL4J_CHAOS_DEVICE"]  # the parent always passes its own
    cfg = CONFIGS[kind]
    from deeplearning4j_tpu_torch import ops

    consumed = _AppendLog(os.path.join(checkpoint_dir, CONSUMED_LOG))
    scores = _AppendLog(os.path.join(checkpoint_dir, SCORES_LOG))
    launches = _AppendLog(os.path.join(checkpoint_dir, LAUNCHES_LOG))
    it = _make_iterator(kind, cfg, consumed)
    if resume_path:
        model = restore_model(resume_path, device=device, load_updater=True)
        state = CheckpointListener.last_checkpoint_state(checkpoint_dir)
    else:
        model = _build_model(kind, device)
        state = None
    solver = model._trainer if model._trainer is not None else Solver(model)
    model._trainer = solver
    restore_training_state(model, state, iterator=it)

    ckpt = CheckpointListener(
        checkpoint_dir, save_every_n_iterations=cfg["save_every"], async_save=True,
        iterator=it, keep_last=cfg["keep_last"], log_fn=lambda m: None)
    preempt = PreemptionHandler(checkpoint=ckpt)

    class _ScoreLog(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            scores.write(f"{iteration} {float(score)!r}")
            launches.write(json.dumps(ops.LAUNCH_COUNTS))  # this process's, so far

    class _Pacer(TrainingListener):
        """A real model's step time: without it the toy network finishes
        all its iterations faster than one zip write, and the parent's
        mid-epoch signals cannot land where they aim."""

        def iteration_done(self, model, iteration, epoch, score):
            time.sleep(cfg["pacer"])

    class _Hold(TrainingListener):
        """Waits at iteration ``at`` for a signal (the parent sends one
        once a checkpoint is committed): a preemption notice lets the
        handler after it save and exit; a SIGKILL ends the process here."""

        def __init__(self, at: int) -> None:
            self.at = at

        def iteration_done(self, model, iteration, epoch, score):
            if iteration == self.at and os.environ.get("DL4J_CHAOS_HOLD") == "1":
                deadline = time.monotonic() + 900
                while not preempt.requested and time.monotonic() < deadline:
                    time.sleep(0.05)

    class _Staller(TrainingListener):
        """Wedged-device simulation: the step loop stops beating AFTER
        iteration ``at`` committed; the watchdog must hard-exit."""

        def __init__(self, at: int) -> None:
            self.at = at

        def iteration_done(self, model, iteration, epoch, score):
            if iteration == self.at:
                while True:
                    time.sleep(0.1)

    listeners = [ckpt, HeartbeatListener(checkpoint_dir), _ScoreLog()]
    if cfg["pacer"]:
        listeners.append(_Pacer())
    if cfg["hold_at"]:
        listeners.append(_Hold(cfg["hold_at"]))
    stall_at = int(os.environ.get("DL4J_TEST_STALL_AT_ITER", "0"))
    if stall_at:
        listeners.append(_Staller(stall_at))
    listeners.append(preempt.install())
    model.add_listeners(*listeners)

    while model.iteration_count < cfg["total"]:
        solver.fit_iterator(it, epochs=1)
    ckpt.close(timeout=600.0)
    it.close()
    np.savez(os.path.join(checkpoint_dir, FINAL_NPZ), params=model.params_flat(),
             iteration=model.iteration_count, score=float(model.score_value))


# ---------------------------------------------------------------------------
# parent-side orchestration
# ---------------------------------------------------------------------------

def _child_env(kind: str, device: str) -> dict:
    py_path = os.pathsep.join([_REPO_ROOT, os.environ.get("PYTHONPATH", "")])
    return {"PYTHONPATH": py_path, "DL4J_CHAOS_MODEL": kind, "DL4J_CHAOS_DEVICE": device}


class _ChaosSpawner:
    """elastic_fit spawn_fn that runs the real child trainer and, on the
    FIRST run only, delivers ``sig`` once the heartbeat reaches ``kill_at``
    and a checkpoint is committed. Records each run's exit code, its
    boot-to-first-step seconds and the committed checkpoint state seen
    between a child's death and its restart."""

    def __init__(self, ckpt_dir: str, kind: str, device: str, *, kill_at=None, sig=None,
                 stall_timeout: float = 300.0, extra_env=None) -> None:
        self.ckpt_dir = ckpt_dir
        self.kind = kind
        self.device = device
        self.kill_at = kill_at
        self.sig = sig
        self.stall_timeout = stall_timeout
        self.extra_env = extra_env or {}
        self.rcs = []
        self.boot_seconds = []
        self.committed_between = []

    def __call__(self) -> int:
        from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
        from deeplearning4j_tpu_torch.train.fault_tolerance import _child_argv, read_heartbeat

        if self.rcs:  # what the dead run durably committed, before the restart
            self.committed_between.append(
                CheckpointListener.last_checkpoint_state(self.ckpt_dir))
        first = not self.rcs
        env = {**os.environ, **_child_env(self.kind, self.device), **self.extra_env}
        if first and self.kill_at is not None:
            env["DL4J_CHAOS_HOLD"] = "1"
        if not first:  # the fault is the first run's; a restart runs clean
            env.pop("DL4J_TEST_STALL_AT_ITER", None)
        err_path = os.path.join(self.ckpt_dir, f"child.{len(self.rcs)}.err")
        spawned = time.time()
        with open(err_path, "wb") as err:
            proc = subprocess.Popen(_child_argv(ENTRY_REF, self.ckpt_dir, self.stall_timeout),
                                    env=env, stderr=err)
            if first and self.kill_at is not None:
                deadline = time.monotonic() + 900
                while time.monotonic() < deadline:
                    hb = read_heartbeat(self.ckpt_dir)
                    # the leg under test resumes from a committed checkpoint:
                    # fire only once the writer has flipped the pointer
                    if (hb and hb["iteration"] >= self.kill_at
                            and CheckpointListener.last_checkpoint(self.ckpt_dir) is not None):
                        break
                    if proc.poll() is not None:
                        break
                    time.sleep(0.02)
                if proc.poll() is None:
                    proc.send_signal(self.sig)
            rc = proc.wait(timeout=1800)
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


def _final(ckpt_dir: str):
    import numpy as np

    with np.load(os.path.join(ckpt_dir, FINAL_NPZ)) as z:
        return np.array(z["params"]), int(z["iteration"])


def _run_elastic(ckpt_dir, spawner, log, **kw):
    from deeplearning4j_tpu_torch.core.resilience import RetryPolicy
    from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.train.fault_tolerance import elastic_fit

    os.makedirs(ckpt_dir, exist_ok=True)
    kw.setdefault("retry_policy",
                  RetryPolicy(max_retries=5, initial_backoff=0.05, max_backoff=0.2))
    return elastic_fit(ENTRY_REF, ckpt_dir, spawn_fn=spawner, registry=MetricsRegistry(),
                       log_fn=lambda m: log(f"  {os.path.basename(ckpt_dir)}: {m}"), **kw)


def run_legs(device: str = "cuda", model: str = "mlp", log=print) -> dict:
    """Run the four legs and check them; returns, per leg, the elastic_fit
    result, the spawner's exit codes and boot seconds, the leg's wall
    seconds, the steps its runs took and the kernel launches their
    processes made. Raises AssertionError on a broken contract. The legs'
    directories (checkpoint zips of up to 1.1 GB each) go when it returns
    or raises, unless ``DL4J_CHAOS_KEEP_DIR=1`` keeps them for a look."""
    base = tempfile.mkdtemp(prefix="training_resilience_")
    try:
        return _run_legs(base, device, model, log)
    finally:
        if os.environ.get("DL4J_CHAOS_KEEP_DIR") == "1":
            log(f"legs kept in {base}")
        else:
            shutil.rmtree(base, ignore_errors=True)


def _run_legs(base: str, device: str, model: str, log) -> dict:
    import numpy as np

    from deeplearning4j_tpu_torch.train.fault_tolerance import (PREEMPTED_EXIT_CODE,
                                                                STALL_EXIT_CODE)

    cfg = CONFIGS[model]
    total = cfg["total"]
    if device.startswith("cuda"):
        from deeplearning4j_tpu_torch.ops import cuda_build

        cuda_build.build_all()  # the children load these; none rebuilds
    seed_env = os.environ.get("DL4J_CHAOS_SEED", "")
    rnd = random.Random(int(seed_env)) if seed_env else random.Random()
    per_epoch = cfg["rows"] // cfg["batch"]
    if cfg["hold_at"]:
        kill_at = term_at = stall_at = cfg["hold_at"]
    else:
        mid_epoch = [i for i in range(per_epoch + 1, total - 2) if i % per_epoch != 0]
        kill_at, term_at, stall_at = (rnd.choice(mid_epoch) for _ in range(3))
    st = cfg["stall_timeout"]
    legs = {
        "uninterrupted": (_ChaosSpawner(os.path.join(base, "uninterrupted"), model, device),
                          dict(max_restarts=0)),
        "sigkill": (_ChaosSpawner(os.path.join(base, "sigkill"), model, device,
                                  kill_at=kill_at, sig=signal.SIGKILL), dict(max_restarts=3)),
        "sigterm": (_ChaosSpawner(os.path.join(base, "sigterm"), model, device,
                                  kill_at=term_at, sig=signal.SIGTERM), dict(max_restarts=0)),
        "stall": (_ChaosSpawner(os.path.join(base, "stall"), model, device, stall_timeout=st,
                                extra_env={"DL4J_TEST_STALL_AT_ITER": str(stall_at)}),
                  dict(max_restarts=3, stall_timeout=st)),
    }

    def run(name):
        sp, kw = legs[name]
        t0 = time.perf_counter()
        res = _run_elastic(sp.ckpt_dir, sp, log, **kw)
        return res, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(legs)) as pool:
        futures = {name: pool.submit(run, name) for name in legs}
        results = {name: f.result() for name, f in futures.items()}
    out = {}
    for name, (sp, _) in legs.items():
        launched: dict = {}
        for run in _parse_runs(os.path.join(sp.ckpt_dir, LAUNCHES_LOG)):
            for k, v in (json.loads(run[-1]) if run else {}).items():
                launched[k] = launched.get(k, 0) + v
        out[name] = {"result": results[name][0], "seconds": results[name][1], "rcs": sp.rcs,
                     "boot_seconds": sp.boot_seconds, "launches": launched,
                     "steps": sum(len(r) for r in _parse_runs(os.path.join(sp.ckpt_dir,
                                                                           SCORES_LOG)))}

    # -- leg 1: uninterrupted reference ---------------------------------
    d1 = legs["uninterrupted"][0].ckpt_dir
    res1 = out["uninterrupted"]["result"]
    assert res1["ok"] and res1["restarts"] == 0, res1
    ref_params, ref_iter = _final(d1)
    assert ref_iter == total
    ref_consumed = _parse_runs(os.path.join(d1, CONSUMED_LOG))
    assert len(ref_consumed) == 1 and len(ref_consumed[0]) == total, \
        [len(r) for r in ref_consumed]
    seq = ref_consumed[0]
    ref_scores = _parse_runs(os.path.join(d1, SCORES_LOG))[0]
    log(f"[1/4] uninterrupted: {total} iterations, {len(set(seq))} distinct batches consumed")

    # -- leg 2: SIGKILL mid-epoch ---------------------------------------
    sp2 = legs["sigkill"][0]
    res2 = out["sigkill"]["result"]
    assert res2["ok"], res2
    assert sp2.rcs[0] == -signal.SIGKILL, sp2.rcs
    assert [e["event"] for e in res2["events"]][0] == "crash"
    committed = sp2.committed_between[0]
    assert committed is not None, "no committed checkpoint survived SIGKILL"
    c = committed["iteration"]
    assert 0 < c <= kill_at + 2, (c, kill_at)
    params2, _ = _final(sp2.ckpt_dir)
    assert np.array_equal(ref_params, params2), "SIGKILL resume diverged from the uninterrupted run"
    runs2 = _parse_runs(os.path.join(sp2.ckpt_dir, CONSUMED_LOG))
    assert len(runs2) == 2, [len(r) for r in runs2]
    prefix, resumed = runs2
    # non-overlapping, non-skipping: the committed prefix plus the resumed
    # run's consumption is EXACTLY the uninterrupted sequence
    assert len(prefix) >= c, (len(prefix), c)
    assert prefix[:c] + resumed == seq, (c, len(prefix), len(resumed))
    sruns2 = _parse_runs(os.path.join(sp2.ckpt_dir, SCORES_LOG))
    assert sruns2[0][:c] + sruns2[1] == ref_scores, "loss curve diverged after SIGKILL"
    log(f"[2/4] SIGKILL at iter {kill_at} (committed {c}): restart resumed batch {c + 1}, "
        f"params + loss curve bit-identical ({len(prefix) - c} uncommitted batch(es) "
        f"re-consumed)")

    # -- leg 3: SIGTERM preemption --------------------------------------
    sp3 = legs["sigterm"][0]
    res3 = out["sigterm"]["result"]
    assert res3["ok"], res3
    assert sp3.rcs[0] == PREEMPTED_EXIT_CODE, sp3.rcs
    assert res3["preemptions"] == 1 and res3["restarts"] == 0, res3
    assert [e["event"] for e in res3["events"]] == ["preempted", "completed"]
    assert os.path.exists(os.path.join(sp3.ckpt_dir, "preempted"))
    committed3 = sp3.committed_between[0]
    hb3 = res3["events"][0]["last_heartbeat"]
    # zero lost iterations: the forced final save covered the last heartbeat
    assert committed3["iteration"] == hb3["iteration"], (committed3, hb3)
    params3, _ = _final(sp3.ckpt_dir)
    assert np.array_equal(ref_params, params3), \
        "preemption resume diverged from the uninterrupted run"
    runs3 = _parse_runs(os.path.join(sp3.ckpt_dir, CONSUMED_LOG))
    c3 = committed3["iteration"]
    assert runs3[0][:c3] + runs3[1] == seq
    out["sigterm"]["lost_iterations"] = hb3["iteration"] - c3
    log(f"[3/4] SIGTERM at iter {term_at}: exit {PREEMPTED_EXIT_CODE}, final sync checkpoint "
        f"at iter {c3} == last heartbeat, immediate restart, params bit-identical")

    # -- leg 4: injected stall (watchdog path) --------------------------
    sp4 = legs["stall"][0]
    res4 = out["stall"]["result"]
    assert res4["ok"], res4
    assert sp4.rcs[0] == STALL_EXIT_CODE, sp4.rcs
    assert [e["event"] for e in res4["events"]][0] == "stall"
    params4, _ = _final(sp4.ckpt_dir)
    assert np.array_equal(ref_params, params4), "stall resume diverged from the uninterrupted run"
    committed4 = sp4.committed_between[0]
    log(f"[4/4] stall at iter {stall_at}: watchdog exit {STALL_EXIT_CODE}, restart from "
        f"{'iteration %d' % committed4['iteration'] if committed4 else 'the start'}, "
        f"params bit-identical")
    out["stall"]["resumed_from"] = committed4["iteration"] if committed4 else 0
    log("training resilience contract OK")
    return out


def main(log=print, device: str = "cuda", model: str = "mlp") -> int:
    run_legs(device, model, log)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", default="mlp", choices=sorted(CONFIGS))
    args = ap.parse_args()
    sys.exit(main(device=args.device, model=args.model))
