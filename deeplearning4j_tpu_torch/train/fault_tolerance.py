"""Failure detection and elastic restart (port of
``deeplearning4j_tpu/train/fault_tolerance.py``).

A device that hangs a dispatch (a wedged kernel, a lost card) never returns
control to Python, so recovery means process supervision:

* ``HeartbeatListener`` writes ``heartbeat.json`` (iteration, epoch, score,
  timestamp) every iteration from inside ``fit``: the liveness signal.
* ``Watchdog`` is a daemon thread that watches the heartbeat's age and
  calls ``on_stall`` when training stops making progress (default: write a
  ``stalled`` marker and hard-exit with :data:`STALL_EXIT_CODE`, with
  kernels possibly still queued, so that a supervisor can restart).
* ``PreemptionHandler`` turns SIGTERM/SIGINT into "finish the step in
  flight, force a final synchronous checkpoint, exit
  :data:`PREEMPTED_EXIT_CODE`".
* ``elastic_fit`` is the supervisor: it runs a training entry point in a
  child process and restarts it from the latest checkpoint on a crash, a
  stall or a preemption. The entry point is a ``"module:function"``
  reference with signature ``fn(resume_path, checkpoint_dir)``, or
  ``fn(resume_path, checkpoint_dir, mesh_size)`` for a resize-aware entry;
  the child imports it fresh and loads the kernels the parent built (the
  build directory is shared; nothing is rebuilt).

``elastic_fit(mesh_size_fn=...)`` re-resolves the width before every boot
and hands it to the child as ``DL4J_ELASTIC_MESH_SIZE``, which
``_child_main`` forwards to a resize-aware entry. The JAX package's child
is one process that forces that many host devices; the port runs one
process per replica, so a boot at width N starts N ranks of the entry
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` set for
``initialize_distributed()``), and a rank that dies takes its boot down. The supervisor keeps
a goodput ledger: ``dl4j_tpu_training_goodput_ratio`` and
``dl4j_tpu_training_downtime_seconds_total{reason=}`` itemized by
``backoff``/``preempted``/``reshard``/``stall``/``crash``, returned under
``result["goodput"]``.
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import signal as _signal
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

from ..core.listeners import TrainingListener
from .checkpoint import _atomic_write_json

STALL_EXIT_CODE = 86  # distinct from crash codes: "alive but not progressing"
# EX_TEMPFAIL: an EXPECTED eviction (pod preemption), not a crash — the
# supervisor restarts immediately without burning crash budget
PREEMPTED_EXIT_CODE = 75
HEARTBEAT_FILE = "heartbeat.json"
PREEMPTED_MARKER = "preempted"


class HeartbeatListener(TrainingListener):
    """Per-iteration liveness record (failure detection)."""

    def __init__(self, directory: str) -> None:
        self.path = os.path.join(directory, HEARTBEAT_FILE)
        self._first_ts: Optional[float] = None
        os.makedirs(directory, exist_ok=True)

    def iteration_done(self, model, iteration: int, epoch: int,
                       score: float) -> None:
        now = time.time()
        if self._first_ts is None:
            self._first_ts = now
        try:
            # same tmp + fsync + os.replace discipline as the checkpoint
            # pointer: a power cut mid-beat leaves the previous beat
            # intact, never a torn file. first_ts/pid let the supervisor
            # tell THIS run's beats from a stale predecessor's and price
            # restore-to-first-step boot time in the goodput ledger.
            _atomic_write_json(self.path, {
                "iteration": iteration, "epoch": epoch,
                "score": float(score), "ts": now,
                "first_ts": self._first_ts, "pid": os.getpid()})
        except OSError:
            pass  # liveness only: a failed beat must not kill the fit —
            # if beats keep failing the watchdog takes over


def read_heartbeat(directory: str) -> Optional[dict]:
    """Latest heartbeat, or None — a missing, empty, torn, or otherwise
    unparseable ``heartbeat.json`` is reported as "no heartbeat", never
    raised into the supervisor/watchdog loop."""
    path = os.path.join(directory, HEARTBEAT_FILE)
    try:
        with open(path) as f:
            hb = json.load(f)
    except (OSError, ValueError):  # ValueError covers JSONDecodeError
        return None
    return hb if isinstance(hb, dict) else None


class Watchdog:
    """Stall detector: fires ``on_stall`` when the heartbeat stops aging
    forward for ``timeout`` seconds. Default action writes a ``stalled``
    marker and hard-exits — the only way out of a wedged device dispatch."""

    def __init__(self, directory: str, timeout: float = 300.0,
                 on_stall: Optional[Callable[[], None]] = None,
                 poll_interval: float = 5.0) -> None:
        self.directory = directory
        self.timeout = float(timeout)
        self.poll_interval = float(poll_interval)
        self.on_stall = on_stall or self._default_stall
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at = None

    def _default_stall(self) -> None:
        if self._stop.is_set():  # raced with stop(): the fit finished
            return
        with open(os.path.join(self.directory, "stalled"), "w") as f:
            f.write(f"no heartbeat progress for {self.timeout}s\n")
        sys.stderr.write("Watchdog: training stalled — exiting for "
                         "supervisor restart\n")
        sys.stderr.flush()
        os._exit(STALL_EXIT_CODE)  # noqa: SLF001 — a hung dispatch blocks clean exit

    def start(self) -> "Watchdog":
        self._started_at = time.time()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop AND JOIN the checker thread: after stop() returns, no
        stall can fire. (Setting the event alone left a race — a check
        already past the wait could still hard-exit a process whose fit
        had just finished cleanly; _fire re-checks, and the join closes
        the window for the caller.)"""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=timeout)
        self._thread = None

    def _fire(self) -> None:
        """Stall detected: re-check stop() immediately before acting —
        the only interleaving left is stop() arriving mid-on_stall."""
        if self._stop.is_set():
            return
        self.on_stall()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            hb = read_heartbeat(self.directory)
            # never trust a heartbeat older than our own start: a restarted
            # child inherits the previous run's stale file and must get the
            # full grace period to restore + compile before its first beat
            ts = hb.get("ts") if hb else None
            last = (max(float(ts), self._started_at)
                    if isinstance(ts, (int, float)) else self._started_at)
            if time.time() - last > self.timeout:
                self._fire()
                return


class PreemptionHandler(TrainingListener):
    """Preemption-aware stop: SIGTERM/SIGINT (the pod scheduler's
    eviction notice) becomes "finish the in-flight step, force a final
    SYNCHRONOUS checkpoint, exit with :data:`PREEMPTED_EXIT_CODE`".

    The signal handler only sets a flag: nothing touches the device in
    signal context. The NEXT ``iteration_done`` (i.e. after the in-flight
    step completed and the listener chain ran, so heartbeat/periodic
    checkpoints for this iteration are already down) performs the final
    save and exits. ``elastic_fit`` classifies the exit code as a
    preemption: immediate restart, no backoff, no crash-loop budget.

    Attach AFTER the CheckpointListener/HeartbeatListener and call
    :meth:`install` from the main thread::

        ckpt = CheckpointListener(dir_, ..., async_save=True, iterator=it)
        model.add_listeners(ckpt, HeartbeatListener(dir_),
                            PreemptionHandler(checkpoint=ckpt).install())
    """

    def __init__(self, checkpoint=None, *,
                 signals: tuple = (_signal.SIGTERM, _signal.SIGINT),
                 watchdog: Optional[Watchdog] = None,
                 exit_fn: Optional[Callable[[int], None]] = None,
                 log_fn: Callable[[str], None] = None) -> None:
        self.checkpoint = checkpoint  # CheckpointListener (or None)
        self.signals = tuple(signals)
        self.watchdog = watchdog
        self.directory = getattr(checkpoint, "directory", None)
        self._exit = exit_fn or os._exit  # noqa: SLF001 — must exit through user code
        self.log_fn = log_fn
        self._requested = threading.Event()
        self.signal_received: Optional[int] = None
        self._prev_handlers: dict = {}

    def install(self) -> "PreemptionHandler":
        """Register the signal handlers (main thread only — a CPython
        restriction on ``signal.signal``)."""
        for s in self.signals:
            self._prev_handlers[s] = _signal.signal(s, self._on_signal)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev_handlers.items():
            _signal.signal(s, prev)
        self._prev_handlers.clear()

    def _on_signal(self, signum, frame) -> None:
        self.signal_received = signum
        self._requested.set()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def iteration_done(self, model, iteration: int, epoch: int,
                       score: float) -> None:
        if not self._requested.is_set():
            return
        if self.watchdog is not None:  # a final sync save is not a stall
            self.watchdog.stop()
        ok = True
        if self.checkpoint is not None:
            ok = self.checkpoint.save_now(model, iteration, epoch, score)
        if self.directory is not None:
            try:
                with open(os.path.join(self.directory, PREEMPTED_MARKER),
                          "w") as f:
                    f.write(f"signal {self.signal_received} at iteration "
                            f"{iteration}\n")
            except OSError:
                pass
        msg = (f"PreemptionHandler: signal {self.signal_received} — final "
               f"checkpoint at iteration {iteration} "
               f"{'saved' if ok else 'FAILED'}, exiting "
               f"{PREEMPTED_EXIT_CODE}")
        (self.log_fn or (lambda m: (sys.stderr.write(m + "\n"),
                                    sys.stderr.flush())))(msg)
        self._exit(PREEMPTED_EXIT_CODE)


def _resolve(ref: str) -> Callable:
    mod, _, fn = ref.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _accepts_mesh_size(fn: Callable) -> bool:
    """True when the entry function can take the resolved mesh width as a
    third argument (``fn(resume, dir, mesh_size)`` or a ``mesh_size``
    keyword) — pre-resize 2-arg entries keep working unchanged."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # C callables: assume the old contract
        return False
    if "mesh_size" in sig.parameters:
        return True
    positional = [p for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 3 or any(
        p.kind == p.VAR_POSITIONAL for p in sig.parameters.values())


def _mesh_child_env(env: dict, mesh_size: Optional[int]) -> dict:
    """Child environment for a boot at ``mesh_size`` devices:
    ``DL4J_ELASTIC_MESH_SIZE`` carries the width to ``_child_main``, which
    forwards it to a resize-aware entry function. (The JAX package also
    rewrites ``XLA_FLAGS`` here to force a CPU mesh's device count; torch
    has no such flag, and the device count is what the machine grants.)"""
    out = dict(env)
    if mesh_size is not None:
        out["DL4J_ELASTIC_MESH_SIZE"] = str(int(mesh_size))
    return out


def _child_main() -> None:
    ref, checkpoint_dir = sys.argv[2], sys.argv[3]
    timeout = float(sys.argv[4])
    from .checkpoint import CheckpointListener

    resume = CheckpointListener.last_checkpoint(checkpoint_dir)
    # sub-second stall timeouts (tests, chaos harness) need a matching
    # poll cadence; production keeps the cheap 5s poll
    Watchdog(checkpoint_dir, timeout=timeout,
             poll_interval=min(5.0, max(0.05, timeout / 4.0))).start()
    fn = _resolve(ref)
    mesh_size = os.environ.get("DL4J_ELASTIC_MESH_SIZE")
    if mesh_size and _accepts_mesh_size(fn):
        fn(resume, checkpoint_dir, int(mesh_size))
    else:
        fn(resume, checkpoint_dir)


def _child_argv(entry_ref: str, checkpoint_dir: str, stall_timeout: float) -> List[str]:
    """The command of one supervised child: :func:`_child_main` in a fresh
    interpreter. Every spawner (``elastic_fit``'s own, a chaos harness's)
    starts its children through this one list."""
    return [sys.executable, "-c",
            "from deeplearning4j_tpu_torch.train.fault_tolerance import "
            "_child_main; _child_main()",
            "child", entry_ref, checkpoint_dir, str(stall_timeout)]


def _spawn_world(entry_ref: str, checkpoint_dir: str, stall_timeout: float,
                 env: Optional[dict], mesh_size: Optional[int] = None,
                 stderr=None) -> List[subprocess.Popen]:
    """Start one boot: a single child, or with a width above one that many
    ranks of the entry (one process per replica, joined by
    ``torch.distributed`` on a free local port). Wait with
    :func:`~deeplearning4j_tpu_torch.parallel.mesh.wait_ranks`."""
    base = _mesh_child_env({**os.environ, **(env or {})}, mesh_size)
    argv = _child_argv(entry_ref, checkpoint_dir, stall_timeout)
    if not mesh_size or int(mesh_size) <= 1:
        return [subprocess.Popen(argv, env=base, stderr=stderr)]
    from ..parallel.mesh import spawn_ranks

    return spawn_ranks(argv, int(mesh_size), env=base, stderr=stderr)


def _spawn_child(entry_ref: str, checkpoint_dir: str, stall_timeout: float,
                 env: Optional[dict], mesh_size: Optional[int] = None) -> int:
    from ..parallel.mesh import wait_ranks

    return wait_ranks(_spawn_world(entry_ref, checkpoint_dir, stall_timeout, env, mesh_size))


def _call_spawn(spawn_fn: Callable, mesh_size: Optional[int]) -> int:
    """Invoke an injected ``spawn_fn``, passing the boot's mesh width to
    spawners that accept one (chaos harnesses); legacy zero-arg spawners
    keep working."""
    try:
        sig = inspect.signature(spawn_fn)
    except (TypeError, ValueError):
        return spawn_fn()
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                      p.VAR_POSITIONAL):
            return spawn_fn(mesh_size)
    return spawn_fn()


def elastic_fit(entry_ref: str, checkpoint_dir: str, *,
                max_restarts: int = 3, stall_timeout: float = 300.0,
                env: Optional[dict] = None,
                retry_policy: Optional["RetryPolicy"] = None,
                crash_loop_window: float = 600.0,
                crash_loop_budget: Optional[int] = None,
                log_fn: Callable[[str], None] = print,
                spawn_fn: Optional[Callable[[], int]] = None,
                sleep: Callable[[float], None] = time.sleep,
                clock: Callable[[], float] = time.monotonic,
                max_preemptions: Optional[int] = None,
                mesh_size_fn: Optional[Callable[[], Optional[int]]] = None,
                registry=None) -> dict:
    """Supervised training: run ``entry_ref`` ("module:function") in a child
    process; restart from the latest checkpoint on crash or stall.

    Restart discipline (core/resilience.py): restarts back off
    exponentially with seeded jitter (``retry_policy``) so a flaky fleet
    doesn't hammer checkpoint storage, and a restart-budget-per-window
    crash-loop detector (more than ``crash_loop_budget`` restarts inside
    ``crash_loop_window`` seconds) gives up early — a child that dies
    instantly on every boot must not burn all ``max_restarts`` at full
    speed. ``spawn_fn``/``sleep``/``clock`` are injectable and the
    ``elastic_fit.spawn`` FaultInjector site fires before every child
    launch, so the whole recovery path is testable without subprocesses.

    Exit-code classification: ``PREEMPTED_EXIT_CODE`` (a
    :class:`PreemptionHandler` stop — the child already forced a final
    sync checkpoint) restarts IMMEDIATELY: no backoff, and it consumes
    neither ``max_restarts`` nor the crash-loop budget — preemption is
    the pod's routine operation, not a failure of ours.
    ``max_preemptions`` optionally bounds an eviction storm (None =
    scheduler-driven, unbounded); ``STALL_EXIT_CODE`` and everything
    else keep the crash discipline unchanged.

    Elastic resize: ``mesh_size_fn`` (when given) is called once before
    EVERY child boot and returns the device count the boot should use —
    a changed width is recorded as a ``reshard`` event, the restart is
    counted under ``reason="resize"``, and the width reaches the child
    via :func:`_mesh_child_env` (``DL4J_ELASTIC_MESH_SIZE``). Injected
    ``spawn_fn`` callables that accept an argument receive the width.

    Goodput ledger: the supervisor itemizes downtime seconds by reason —
    ``backoff`` (restart delays), ``stall`` (heartbeat age at watchdog
    fire: how long the child was wedged), ``crash`` (work seconds between
    the last beat and death), and the restore-to-first-beat boot time of
    each restart, attributed to ``reshard`` when the width changed and to
    the triggering failure kind otherwise. Exposed as
    ``dl4j_tpu_training_downtime_seconds_total{reason=}`` plus the
    ``dl4j_tpu_training_goodput_ratio`` gauge (useful seconds / wall
    seconds), and returned under ``result["goodput"]``.

    Returns {"restarts": n, "preemptions": p, "events": [...], "ok": bool,
    "goodput": {"ratio", "wall_seconds", "useful_seconds",
    "downtime_seconds": {reason: s}}}. Failure events carry
    ``heartbeat_age_s`` — wall seconds since the last beat at failure
    time, distinguishing "died mid-step" (small) from "heartbeat stale
    since boot" (large). The entry function must attach
    CheckpointListener(checkpoint_dir, ...) and
    HeartbeatListener(checkpoint_dir) itself — it owns the model and
    data.
    """
    from ..core.resilience import RetryPolicy, get_fault_injector
    from ..obs.metrics import get_registry

    reg = registry if registry is not None else get_registry()
    ev_counts = reg.counter(
        "dl4j_tpu_training_elastic_events_total",
        "elastic_fit supervisor events", ("event",))
    c_restarts = reg.counter(
        "dl4j_tpu_training_restarts_total",
        "Child restarts performed by elastic_fit",
        ("reason",))
    c_downtime = reg.counter(
        "dl4j_tpu_training_downtime_seconds_total",
        "Wall seconds the supervised run spent NOT making training "
        "progress, itemized by cause", ("reason",))
    g_goodput = reg.gauge(
        "dl4j_tpu_training_goodput_ratio",
        "Useful-step seconds / wall seconds over the supervised run")

    def record(kind: str, **fields) -> None:
        ev_counts.labels(kind).inc()
        reg.log_event("elastic_fit", event=kind, **fields)

    policy = retry_policy or RetryPolicy(
        max_retries=max_restarts, initial_backoff=1.0, max_backoff=60.0)
    budget = crash_loop_budget if crash_loop_budget is not None \
        else max(2, max_restarts)
    os.makedirs(checkpoint_dir, exist_ok=True)
    events: List[dict] = []
    restart_times: List[float] = []
    restarts = 0
    preemptions = 0
    t_start = clock()
    downtime = {"backoff": 0.0, "preempted": 0.0, "reshard": 0.0,
                "stall": 0.0, "crash": 0.0}
    prev_width: Optional[int] = None
    pending_restart: Optional[str] = None  # failure kind awaiting next boot

    def lose(reason: str, seconds: Optional[float]) -> None:
        if not seconds or seconds <= 0:
            return
        downtime[reason] = downtime.get(reason, 0.0) + float(seconds)
        c_downtime.labels(reason).inc(float(seconds))

    def finish(ok: bool) -> dict:
        wall = max(0.0, clock() - t_start)
        lost = min(wall, sum(downtime.values()))
        useful = wall - lost
        ratio = (useful / wall) if wall > 0 else 1.0
        g_goodput.set(ratio)
        reg.log_event("elastic_fit", event="goodput", ratio=ratio,
                      wall_seconds=wall, useful_seconds=useful)
        return {"ok": ok, "restarts": restarts, "preemptions": preemptions,
                "events": events,
                "goodput": {"ratio": ratio, "wall_seconds": wall,
                            "useful_seconds": useful,
                            "downtime_seconds": dict(downtime)}}

    while True:
        width = mesh_size_fn() if mesh_size_fn is not None else None
        boot_reason = pending_restart
        if pending_restart is not None:
            if (width is not None and prev_width is not None
                    and width != prev_width):
                boot_reason = "reshard"
                events.append({"event": "reshard", "from_width": prev_width,
                               "to_width": width})
                record("reshard", from_width=prev_width, to_width=width)
                log_fn(f"elastic_fit: mesh resize {prev_width} -> {width} "
                       f"devices; restoring re-sharded state")
                c_restarts.labels("resize").inc()
            else:
                c_restarts.labels(pending_restart).inc()
        if width is not None:
            prev_width = width
        get_fault_injector().fire("elastic_fit.spawn")
        spawn_wall = time.time()
        rc = (_call_spawn(spawn_fn, width) if spawn_fn is not None
              else _spawn_child(entry_ref, checkpoint_dir, stall_timeout,
                                env, width))
        if boot_reason is not None:
            # restore-to-first-beat boot time of a RESTART is downtime
            # (restore + re-shard + recompile before the first useful step)
            hb_boot = read_heartbeat(checkpoint_dir)
            first = hb_boot.get("first_ts") if hb_boot else None
            if isinstance(first, (int, float)) and first >= spawn_wall:
                lose(boot_reason, float(first) - spawn_wall)
        pending_restart = None
        if rc == 0:
            events.append({"event": "completed", "restarts": restarts})
            record("completed", restarts=restarts)
            return finish(True)
        kind = ("stall" if rc == STALL_EXIT_CODE
                else "preempted" if rc == PREEMPTED_EXIT_CODE else "crash")
        hb = read_heartbeat(checkpoint_dir)
        hb_ts = hb.get("ts") if hb else None
        hb_age = (max(0.0, time.time() - float(hb_ts))
                  if isinstance(hb_ts, (int, float)) else None)
        events.append({"event": kind, "rc": rc, "last_heartbeat": hb,
                       "heartbeat_age_s": hb_age})
        record(kind, rc=rc, heartbeat_age_s=hb_age)
        log_fn(f"elastic_fit: child {kind} (rc={rc}), last iteration "
               f"{hb.get('iteration') if hb else 'none'}"
               + (f", heartbeat age {hb_age:.1f}s" if hb_age is not None
                  else ""))
        if kind == "stall":
            # time the child sat wedged before the watchdog fired; with no
            # beat at all the whole stall_timeout was the wait
            lose("stall", hb_age if hb_age is not None else stall_timeout)
        elif kind == "crash":
            lose("crash", hb_age)  # work between the last beat and death
        if kind == "preempted":
            # expected eviction: the child checkpointed and asked to be
            # rescheduled — restart NOW, burn no crash budget of any kind
            preemptions += 1
            if max_preemptions is not None and preemptions > max_preemptions:
                events.append({"event": "gave_up", "restarts": restarts,
                               "preemptions": preemptions})
                record("gave_up", restarts=restarts)
                log_fn(f"elastic_fit: {preemptions} preemptions exceed "
                       f"max_preemptions={max_preemptions}, giving up")
                return finish(False)
            pending_restart = "preempted"
            continue
        if restarts >= max_restarts:
            events.append({"event": "gave_up", "restarts": restarts})
            record("gave_up", restarts=restarts)
            return finish(False)
        now = clock()
        restart_times = [t for t in restart_times
                         if now - t <= crash_loop_window]
        if len(restart_times) >= budget:
            events.append({"event": "crash_loop", "restarts": restarts,
                           "window_s": crash_loop_window, "budget": budget})
            record("crash_loop", restarts=restarts)
            log_fn(f"elastic_fit: crash loop — {len(restart_times) + 1} "
                   f"failures within {crash_loop_window}s, giving up")
            return finish(False)
        restart_times.append(now)
        delay = policy.backoff(restarts)
        events.append({"event": "backoff", "delay_s": delay})
        record("backoff", delay_s=delay)
        log_fn(f"elastic_fit: restarting in {delay:.2f}s "
               f"(restart {restarts + 1}/{max_restarts})")
        sleep(delay)
        lose("backoff", delay)
        pending_restart = kind
        restarts += 1
