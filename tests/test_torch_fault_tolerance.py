"""The port's failure detection and elastic restart
(``deeplearning4j_tpu_torch/train/{fault_tolerance,checkpoint}.py``): the
JAX package's ``tests/test_fault_tolerance.py`` cases run against the port
(the supervisor resumes from the latest checkpoint after a crash, the
watchdog detects a stalled child, preemption is classified without backoff
or crash budget, the async checkpoint writer's bounded queue,
crash-consistent pointer, fault tolerance, keep_last across restarts,
decoupled triggers, the Watchdog stop() race, the resize plumbing and the
goodput ledger), then the port's chaos harness
(``deeplearning4j_tpu_torch/tools/check_training_resilience_contract.py``)
with its four legs on the CPU: uninterrupted, SIGKILL mid-epoch, SIGTERM
preemption with zero lost iterations and a stall the watchdog ends, each
finishing with parameters bit-identical to the first. The port's own
checkpoint cases are in ``tests/test_torch_checkpoint.py``."""

import os
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.train.fault_tolerance import (
    PREEMPTED_EXIT_CODE,
    HeartbeatListener,
    PreemptionHandler,
    Watchdog,
    elastic_fit,
    read_heartbeat,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_heartbeat_listener_writes_progress(tmp_path):
    hb = HeartbeatListener(str(tmp_path))

    class FakeModel:
        pass

    hb.iteration_done(FakeModel(), 7, 1, 0.5)
    got = read_heartbeat(str(tmp_path))
    assert got["iteration"] == 7 and got["epoch"] == 1
    assert got["score"] == pytest.approx(0.5)


def test_watchdog_fires_on_stall(tmp_path):
    fired = []
    wd = Watchdog(str(tmp_path), timeout=0.3, poll_interval=0.05,
                  on_stall=lambda: fired.append(True))
    wd.start()
    time.sleep(1.0)
    wd.stop()
    assert fired  # no heartbeat ever arrived -> stall


def test_watchdog_quiet_while_progressing(tmp_path):
    fired = []
    wd = Watchdog(str(tmp_path), timeout=0.5, poll_interval=0.05,
                  on_stall=lambda: fired.append(True))
    hb = HeartbeatListener(str(tmp_path))
    wd.start()
    for i in range(6):
        hb.iteration_done(None, i, 0, 0.1)
        time.sleep(0.15)
    wd.stop()
    time.sleep(0.2)
    assert not fired


_ENTRY = textwrap.dedent('''
    """Elastic-fit test target: crashes mid-training on the first run
    (marker file absent), completes on the resume run."""
    import os

    import numpy as np


    def train(resume_path, checkpoint_dir):
        from deeplearning4j_tpu_torch.model.serializer import restore_model
        from deeplearning4j_tpu_torch.nn import (
            Activation, InputType, LossFunction, NeuralNetConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
        from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
        from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
        from deeplearning4j_tpu_torch.train.fault_tolerance import HeartbeatListener
        from deeplearning4j_tpu_torch.train.updaters import Sgd

        if resume_path:
            model = restore_model(resume_path, device="cpu", load_updater=True)
        else:
            conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1))
                    .list()
                    .layer(DenseLayer(n_out=8, activation=Activation.TANH))
                    .layer(OutputLayer(n_out=2, loss=LossFunction.MCXENT,
                                       activation=Activation.SOFTMAX))
                    .set_input_type(InputType.feed_forward(4)).build())
            model = MultiLayerNetwork(conf, device="cpu").init()
        model.add_listeners(
            CheckpointListener(checkpoint_dir, save_every_n_iterations=5),
            HeartbeatListener(checkpoint_dir))

        rng = np.random.RandomState(0)
        x = rng.rand(8, 4).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 8)]
        crash_marker = os.path.join(checkpoint_dir, "crashed_once")
        target_iters = 30
        while model.iteration_count < target_iters:
            model.fit(x, y, epochs=1)
            if model.iteration_count >= 12 and not os.path.exists(crash_marker):
                open(crash_marker, "w").write("boom")
                os._exit(1)  # simulated worker death mid-training
''')


def test_elastic_fit_resumes_after_crash(tmp_path):
    from deeplearning4j_tpu_torch.core.resilience import RetryPolicy

    target = tmp_path / "elastic_target.py"
    target.write_text(_ENTRY)
    ckpt = str(tmp_path / "ckpt")
    result = elastic_fit(
        "elastic_target:train", ckpt, max_restarts=2, stall_timeout=120.0,
        retry_policy=RetryPolicy(max_retries=2, initial_backoff=0.01),
        env={"PYTHONPATH": os.pathsep.join([str(tmp_path), _REPO,
                                            os.environ.get("PYTHONPATH", "")])},
        log_fn=lambda m: None)
    assert result["ok"], result
    assert result["restarts"] == 1  # crashed once, resumed, completed
    kinds = [e["event"] for e in result["events"]]
    assert kinds == ["crash", "backoff", "completed"]
    # the resumed run really continued past the crash point
    hb = read_heartbeat(ckpt)
    assert hb["iteration"] >= 30
    # and it resumed FROM the checkpoint (crash at >=12, checkpoints every 5)
    assert result["events"][0]["last_heartbeat"]["iteration"] >= 10


class TestElasticRestartDiscipline:
    """Restart backoff + crash-loop detection, fully deterministic: the
    child is a ``spawn_fn`` stub, the clock is fake, sleeps are recorded.
    No subprocesses, no wall-clock waits."""

    @staticmethod
    def _clock_sleep():
        t = [0.0]
        slept = []

        def clock():
            return t[0]

        def sleep(dt):
            slept.append(dt)
            t[0] += dt

        return t, slept, clock, sleep

    def test_backoff_between_restarts_is_exponential(self, tmp_path):
        from deeplearning4j_tpu_torch.core.resilience import RetryPolicy

        _, slept, clock, sleep = self._clock_sleep()
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=3,
            retry_policy=RetryPolicy(max_retries=3, initial_backoff=1.0,
                                     multiplier=2.0, jitter=0.0),
            crash_loop_window=0.0,      # window disabled: nothing ever counts
            spawn_fn=lambda: 1, sleep=sleep, clock=clock,
            log_fn=lambda m: None)
        assert not result["ok"]
        assert result["events"][-1]["event"] == "gave_up"
        assert slept == [1.0, 2.0, 4.0]

    def test_crash_loop_gives_up_before_max_restarts(self, tmp_path):
        spawns = []
        _, slept, clock, sleep = self._clock_sleep()
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=50,
            crash_loop_window=600.0, crash_loop_budget=3,
            spawn_fn=lambda: spawns.append(1) or 1, sleep=sleep, clock=clock,
            log_fn=lambda m: None)
        assert not result["ok"]
        assert result["events"][-1]["event"] == "crash_loop"
        assert result["restarts"] == 3      # budget, nowhere near 50
        assert len(spawns) == 4             # initial + 3 restarts

    def test_slow_failures_outside_window_use_full_budget(self, tmp_path):
        t, _, clock, _ = self._clock_sleep()

        def slow_sleep(dt):  # each restart lands outside the loop window
            t[0] += 1000.0

        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=4,
            crash_loop_window=600.0, crash_loop_budget=2,
            spawn_fn=lambda: 1, sleep=slow_sleep, clock=clock,
            log_fn=lambda m: None)
        assert not result["ok"]
        # failures were spread out -> no crash loop, the full restart
        # budget was spent before giving up
        assert result["events"][-1]["event"] == "gave_up"
        assert result["restarts"] == 4

    def test_recovery_after_transient_crashes(self, tmp_path):
        rcs = iter([1, 86, 0])  # crash, stall, then success
        _, slept, clock, sleep = self._clock_sleep()
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=5,
            spawn_fn=lambda: next(rcs), sleep=sleep, clock=clock,
            log_fn=lambda m: None)
        assert result["ok"] and result["restarts"] == 2
        kinds = [e["event"] for e in result["events"]]
        assert kinds == ["crash", "backoff", "stall", "backoff", "completed"]
        assert len(slept) == 2

    def test_fault_injector_spawn_site_is_live(self, tmp_path):
        from deeplearning4j_tpu_torch.core.resilience import (
            FaultInjector, set_fault_injector)

        inj = FaultInjector()
        inj.inject_error("elastic_fit.spawn",
                         lambda: RuntimeError("injected supervisor fault"),
                         times=1)
        prev = set_fault_injector(inj)
        try:
            with pytest.raises(RuntimeError, match="injected supervisor"):
                elastic_fit("unused:train", str(tmp_path),
                            spawn_fn=lambda: 0, log_fn=lambda m: None)
        finally:
            set_fault_injector(prev)
        assert inj.fired("elastic_fit.spawn") == 1
        # with the plan exhausted the supervisor runs normally
        result = elastic_fit("unused:train", str(tmp_path),
                             spawn_fn=lambda: 0, log_fn=lambda m: None)
        assert result["ok"]


class TestPreemptionClassification:
    """elastic_fit exit-code semantics: PREEMPTED_EXIT_CODE
    restarts immediately — no backoff sleep, no crash-loop budget, no
    max_restarts consumption — while real crashes keep the old
    discipline. All deterministic via spawn_fn/clock stubs."""

    @staticmethod
    def _clock_sleep():
        t = [0.0]
        slept = []

        def clock():
            return t[0]

        def sleep(dt):
            slept.append(dt)
            t[0] += dt

        return t, slept, clock, sleep

    def test_preemption_restarts_without_backoff(self, tmp_path):
        rcs = iter([PREEMPTED_EXIT_CODE, 0])
        _, slept, clock, sleep = self._clock_sleep()
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=0,
            spawn_fn=lambda: next(rcs), sleep=sleep, clock=clock,
            log_fn=lambda m: None)
        assert result["ok"]
        assert result["preemptions"] == 1
        assert result["restarts"] == 0  # no crash budget consumed
        assert slept == []              # immediate restart
        kinds = [e["event"] for e in result["events"]]
        assert kinds == ["preempted", "completed"]

    def test_preemptions_do_not_trip_crash_loop(self, tmp_path):
        rcs = iter([PREEMPTED_EXIT_CODE] * 5 + [0])
        _, slept, clock, sleep = self._clock_sleep()
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=2,
            crash_loop_window=600.0, crash_loop_budget=2,
            spawn_fn=lambda: next(rcs), sleep=sleep, clock=clock,
            log_fn=lambda m: None)
        # 5 back-to-back preemptions inside the window: still completes
        assert result["ok"] and result["preemptions"] == 5
        assert result["restarts"] == 0 and slept == []

    def test_crash_semantics_unchanged_next_to_preemptions(self, tmp_path):
        rcs = iter([PREEMPTED_EXIT_CODE, 1, 1, 1, 1])
        _, slept, clock, sleep = self._clock_sleep()
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=3,
            crash_loop_window=0.0,
            spawn_fn=lambda: next(rcs), sleep=sleep, clock=clock,
            log_fn=lambda m: None)
        assert not result["ok"]
        assert result["events"][-1]["event"] == "gave_up"
        assert result["restarts"] == 3 and result["preemptions"] == 1
        assert len(slept) == 3  # backoffs only for the crashes

    def test_max_preemptions_bounds_eviction_storm(self, tmp_path):
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=5,
            max_preemptions=2,
            spawn_fn=lambda: PREEMPTED_EXIT_CODE,
            sleep=lambda dt: None, clock=lambda: 0.0,
            log_fn=lambda m: None)
        assert not result["ok"]
        assert result["preemptions"] == 3  # the one over budget included
        assert result["events"][-1]["event"] == "gave_up"

    def test_preempted_metric_label(self, tmp_path):
        from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry()
        rcs = iter([PREEMPTED_EXIT_CODE, 0])
        elastic_fit("unused:train", str(tmp_path), registry=reg,
                    spawn_fn=lambda: next(rcs), sleep=lambda dt: None,
                    clock=lambda: 0.0, log_fn=lambda m: None)
        c = reg.counter("dl4j_tpu_training_elastic_events_total", "",
                        ("event",))
        assert c.labels("preempted").value == 1
        assert c.labels("completed").value == 1
        r = reg.counter("dl4j_tpu_training_restarts_total", "", ("reason",))
        # the preemption restart IS a restart — under its own reason label
        assert r.labels("preempted").value == 1


class TestPreemptionHandler:
    def _model(self):
        class FakeModel:
            iteration_count = 7
            epoch_count = 1

        return FakeModel()

    def test_signal_sets_flag_and_next_iteration_exits(self, tmp_path):
        exits = []
        saves = []

        class FakeCkpt:
            directory = str(tmp_path)

            def save_now(self, model, iteration=None, epoch=None,
                         score=float("nan")):
                saves.append((iteration, epoch))
                return True

        h = PreemptionHandler(checkpoint=FakeCkpt(),
                              exit_fn=exits.append, log_fn=lambda m: None)
        assert not h.requested
        h.iteration_done(self._model(), 7, 1, 0.5)
        assert exits == [] and saves == []  # nothing requested yet
        h._on_signal(15, None)
        assert h.requested
        h.iteration_done(self._model(), 8, 1, 0.4)
        assert saves == [(8, 1)]
        assert exits == [PREEMPTED_EXIT_CODE]
        assert os.path.exists(os.path.join(str(tmp_path), "preempted"))

    def test_install_uninstall_roundtrip(self):
        import signal as _sig

        h = PreemptionHandler(exit_fn=lambda c: None, log_fn=lambda m: None,
                              signals=(_sig.SIGUSR1,))
        prev = _sig.getsignal(_sig.SIGUSR1)
        h.install()
        assert _sig.getsignal(_sig.SIGUSR1) == h._on_signal
        h.uninstall()
        assert _sig.getsignal(_sig.SIGUSR1) == prev

    def test_stops_watchdog_before_final_save(self, tmp_path):
        order = []

        class FakeWd:
            def stop(self, timeout=5.0):
                order.append("wd_stop")

        class FakeCkpt:
            directory = str(tmp_path)

            def save_now(self, *a, **kw):
                order.append("save")
                return True

        h = PreemptionHandler(checkpoint=FakeCkpt(), watchdog=FakeWd(),
                              exit_fn=lambda c: order.append("exit"),
                              log_fn=lambda m: None)
        h._on_signal(15, None)
        h.iteration_done(self._model(), 9, 1, 0.1)
        assert order == ["wd_stop", "save", "exit"]


class TestWatchdogStopRace:
    def test_stop_joins_thread(self, tmp_path):
        wd = Watchdog(str(tmp_path), timeout=30.0, poll_interval=0.05,
                      on_stall=lambda: None)
        wd.start()
        t = wd._thread
        wd.stop()
        assert t is not None and not t.is_alive()
        assert wd._thread is None

    def test_fire_rechecks_stop(self, tmp_path):
        """The race fix: a stall check that decided to fire re-checks
        the stop event immediately before acting, so a stop() landing
        after the timeout comparison cannot hard-exit a finished fit."""
        fired = []
        wd = Watchdog(str(tmp_path), timeout=0.0, poll_interval=0.01,
                      on_stall=lambda: fired.append(True))
        wd._stop.set()   # stop() won the race between check and fire
        wd._fire()
        assert not fired
        wd._stop.clear()
        wd._fire()
        assert fired

    def test_default_stall_noop_after_stop(self, tmp_path):
        # _default_stall would os._exit: with stop set it must return
        # (reaching os._exit here would kill the pytest process)
        wd = Watchdog(str(tmp_path), timeout=0.1)
        wd._stop.set()
        wd._default_stall()
        assert not os.path.exists(os.path.join(str(tmp_path), "stalled"))

    def test_stop_from_on_stall_thread_does_not_deadlock(self, tmp_path):
        done = threading.Event()

        def stall():
            wd.stop()  # stop() from the checker thread itself
            done.set()

        wd = Watchdog(str(tmp_path), timeout=0.0, poll_interval=0.01,
                      on_stall=stall)
        wd.start()
        assert done.wait(timeout=5.0)


def _tiny_model():
    from deeplearning4j_tpu_torch.nn import (
        Activation, InputType, LossFunction, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train.updaters import Adam

    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(0.01))
            .list()
            .layer(DenseLayer(n_out=6, activation=Activation.TANH))
            .layer(OutputLayer(n_out=2, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _tiny_data(n=16):
    rng = np.random.RandomState(0)
    x = rng.rand(n, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, n)]
    return x, y


class TestAsyncCheckpointListener:
    def _reg(self):
        from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry

        return MetricsRegistry()

    def test_async_artifact_matches_sync(self, tmp_path):
        from deeplearning4j_tpu_torch.model.serializer import restore_model
        from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

        x, y = _tiny_data()
        m = _tiny_model()
        d_sync, d_async = str(tmp_path / "s"), str(tmp_path / "a")
        cs = CheckpointListener(d_sync, save_every_n_iterations=1,
                                registry=self._reg())
        ca = CheckpointListener(d_async, save_every_n_iterations=1,
                                async_save=True, registry=self._reg())
        m.add_listeners(cs, ca)
        m.fit(x, y, epochs=3)
        ca.close()
        p_s = CheckpointListener.last_checkpoint(d_sync)
        p_a = CheckpointListener.last_checkpoint(d_async)
        r_s = restore_model(p_s, device="cpu", load_updater=True)
        r_a = restore_model(p_a, device="cpu", load_updater=True)
        for ln in r_s.params:
            for pn in r_s.params[ln]:
                assert torch.equal(r_s.params[ln][pn], r_a.params[ln][pn])
        st_s = CheckpointListener.last_checkpoint_state(d_sync)
        st_a = CheckpointListener.last_checkpoint_state(d_async)
        assert st_s["iteration"] == st_a["iteration"] == 3
        assert st_s["rng"] == st_a["rng"]

    def test_bounded_queue_supersedes_oldest(self, tmp_path):
        from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

        ck = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                                async_save=True, max_pending_writes=2,
                                registry=self._reg())
        # hold the writer hostage by filling the queue before it starts:
        # enqueue without a started writer is impossible (started on
        # first enqueue), so block it with a slow first job instead
        ev = threading.Event()

        class SlowSnap:
            class_name = "MultiLayerNetwork"
            _trainer = None

            def _check_init(self):
                pass

            @property
            def conf(self):
                ev.wait(5.0)
                raise RuntimeError("slow job done")

        for i in range(5):
            ck._enqueue({"model": SlowSnap(), "iteration": i, "epoch": 0,
                         "sidecar": {}})
        with ck._q_cond:
            pending = len(ck._q)
        assert pending <= 2
        ev.set()
        ck.close()
        # all the "writes" failed (RuntimeError) but nothing raised and
        # the failure counter moved — the keep-training contract
        assert ck._c_failures.value >= 1

    def test_write_fault_keeps_training_and_counts(self, tmp_path):
        from deeplearning4j_tpu_torch.core.resilience import (
            FaultInjector, set_fault_injector)
        from deeplearning4j_tpu_torch.train.checkpoint import (
            CHECKPOINT_WRITE_SITE, CheckpointListener)

        x, y = _tiny_data()
        m = _tiny_model()
        reg = self._reg()
        ck = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                                registry=reg)
        m.add_listeners(ck)
        inj = FaultInjector()
        inj.inject_error(CHECKPOINT_WRITE_SITE,
                         lambda: OSError("disk full"), times=2)
        prev = set_fault_injector(inj)
        try:
            with pytest.warns(UserWarning, match="checkpoint save failed"):
                m.fit(x, y, epochs=2)  # both saves fail, fit survives
            m.fit(x, y, epochs=1)      # injection exhausted: save lands
        finally:
            set_fault_injector(prev)
        assert reg.counter(
            "dl4j_tpu_training_checkpoint_failures_total", "").value == 2
        assert CheckpointListener.last_checkpoint_state(
            str(tmp_path))["iteration"] == 3

    def test_pointer_only_moves_forward(self, tmp_path):
        from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

        x, y = _tiny_data()
        m = _tiny_model()
        ck = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                                registry=self._reg())
        m.add_listeners(ck)
        m.fit(x, y, epochs=2)
        newest = ck._snapshot(m, 2, 0)
        stale = ck._snapshot(m, 1, 0)
        assert ck._write(newest, "sync")
        assert ck._write(stale, "sync")  # writes the zip, not the pointer
        st = CheckpointListener.last_checkpoint_state(str(tmp_path))
        assert st["iteration"] == 2

    def test_keep_last_prunes_pre_restart_files(self, tmp_path):
        """A fresh listener (a restarted run) must
        enumerate existing checkpoints so keep_last holds ACROSS restart
        cycles instead of growing the directory unboundedly."""
        from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

        x, y = _tiny_data()
        m = _tiny_model()
        ck1 = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                                 keep_last=3, registry=self._reg())
        m.add_listeners(ck1)
        m.fit(x, y, epochs=3)
        assert len([f for f in os.listdir(tmp_path)
                    if f.endswith(".zip")]) == 3
        # "restart": new listener, same dir
        m2 = _tiny_model()
        m2.iteration_count = 3
        ck2 = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                                 keep_last=3, registry=self._reg())
        m2.add_listeners(ck2)
        m2.fit(x, y, epochs=2)
        zips = sorted(f for f in os.listdir(tmp_path) if f.endswith(".zip"))
        assert len(zips) == 3, zips
        assert "checkpoint_iter1_epoch0.zip" not in zips
        # sidecars pruned alongside
        states = [f for f in os.listdir(tmp_path)
                  if f.endswith(".state.json")]
        assert len(states) == 3

    def test_triggers_decoupled_and_iteration_zero_skipped(self, tmp_path):
        from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

        saved = []
        ck = CheckpointListener(str(tmp_path), save_every_n_iterations=4,
                                save_every_n_seconds=0.05,
                                registry=self._reg())
        ck._save = lambda model, it, ep, score=float("nan"): saved.append(it)
        m = object()
        ck.iteration_done(m, 0, 0, 0.1)      # iteration 0 never saves
        assert saved == []
        ck.iteration_done(m, 4, 0, 0.1)      # iteration trigger
        assert saved == [4]
        ck._last_save_time = time.time() - 1.0
        ck.iteration_done(m, 5, 0, 0.1)      # TIME trigger despite 5 % 4
        assert saved == [4, 5]
        ck._last_save_time = time.time()
        ck.iteration_done(m, 6, 0, 0.1)      # neither trigger due
        assert saved == [4, 5]

    def test_prune_never_evicts_pointer_target(self, tmp_path):
        """Regression (found driving the preemption path): keep_last
        pruning evicted in COMPLETION order, so a forced final sync save
        landing before stale async stragglers was deleted — the pointer
        then named a missing file. Eviction must follow (epoch,
        iteration) order and spare the pointer target."""
        from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

        x, y = _tiny_data()
        m = _tiny_model()
        ck = CheckpointListener(str(tmp_path), save_every_n_iterations=1,
                                keep_last=2, registry=self._reg())
        m.add_listeners(ck)
        m.fit(x, y, epochs=2)
        # forced final save first, then stale writes complete after it
        newest = ck._snapshot(m, 9, 3)
        assert ck._write(newest, "sync")
        for it in (5, 6, 7):
            assert ck._write(ck._snapshot(m, it, 2), "async")
        path = CheckpointListener.last_checkpoint(str(tmp_path))
        assert path is not None and path.endswith("iter9_epoch3.zip")
        zips = sorted(f for f in os.listdir(tmp_path) if f.endswith(".zip"))
        assert len(zips) == 2 and "checkpoint_iter9_epoch3.zip" in zips

    def test_save_now_is_sync_and_durable(self, tmp_path):
        from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

        x, y = _tiny_data()
        m = _tiny_model()
        ck = CheckpointListener(str(tmp_path), save_every_n_iterations=100,
                                async_save=True, registry=self._reg())
        m.add_listeners(ck)
        m.fit(x, y, epochs=1)
        assert CheckpointListener.last_checkpoint(str(tmp_path)) is None
        assert ck.save_now(m)
        st = CheckpointListener.last_checkpoint_state(str(tmp_path))
        assert st["iteration"] == m.iteration_count
        ck.close()


def test_watchdog_ignores_stale_heartbeat_on_restart(tmp_path):
    """Regression: a restarted child inherits the previous run's old
    heartbeat file — it must still get the full grace period."""
    hb = HeartbeatListener(str(tmp_path))
    hb.iteration_done(None, 5, 0, 0.1)
    # age the heartbeat far past the timeout
    path = os.path.join(str(tmp_path), "heartbeat.json")
    import json as _json
    with open(path) as f:
        data = _json.load(f)
    data["ts"] -= 100.0
    with open(path, "w") as f:
        _json.dump(data, f)

    fired = []
    wd = Watchdog(str(tmp_path), timeout=0.6, poll_interval=0.05,
                  on_stall=lambda: fired.append(True))
    wd.start()
    time.sleep(0.3)
    assert not fired  # grace period counted from start(), not the stale ts
    time.sleep(0.6)
    wd.stop()
    assert fired  # and it still fires once the REAL grace period lapses


class TestElasticResize:
    """Mesh_size_fn width resolution, reason-labeled restarts,
    reshard events, and the supervisor plumbing that carries the width to
    the child. Deterministic — spawn_fn stubs, fake clock."""

    @staticmethod
    def _clock_sleep():
        t = [0.0]
        slept = []

        def clock():
            return t[0]

        def sleep(dt):
            slept.append(dt)
            t[0] += dt

        return t, slept, clock, sleep

    def test_width_reaches_spawn_fn_and_resize_is_labeled(self, tmp_path):
        from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry()
        widths = iter([8, 4])
        rcs = iter([1, 0])
        seen = []

        def spawn(mesh_size):
            seen.append(mesh_size)
            return next(rcs)

        _, slept, clock, sleep = self._clock_sleep()
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=3,
            spawn_fn=spawn, sleep=sleep, clock=clock,
            mesh_size_fn=lambda: next(widths),
            registry=reg, log_fn=lambda m: None)
        assert result["ok"] and seen == [8, 4]
        kinds = [e["event"] for e in result["events"]]
        assert kinds == ["crash", "backoff", "reshard", "completed"]
        resh = next(e for e in result["events"] if e["event"] == "reshard")
        assert resh["from_width"] == 8 and resh["to_width"] == 4
        r = reg.counter("dl4j_tpu_training_restarts_total", "", ("reason",))
        assert r.labels("resize").value == 1
        assert r.labels("crash").value == 0

    def test_same_width_restart_keeps_failure_reason(self, tmp_path):
        from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry()
        rcs = iter([1, 86, 0])
        _, slept, clock, sleep = self._clock_sleep()
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=5,
            spawn_fn=lambda w: next(rcs), sleep=sleep, clock=clock,
            mesh_size_fn=lambda: 8,
            registry=reg, log_fn=lambda m: None)
        assert result["ok"]
        kinds = [e["event"] for e in result["events"]]
        assert kinds == ["crash", "backoff", "stall", "backoff", "completed"]
        r = reg.counter("dl4j_tpu_training_restarts_total", "", ("reason",))
        assert r.labels("crash").value == 1
        assert r.labels("stall").value == 1
        assert r.labels("resize").value == 0

    def test_legacy_zero_arg_spawn_fn_still_works(self, tmp_path):
        rcs = iter([1, 0])
        _, slept, clock, sleep = self._clock_sleep()
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=2,
            spawn_fn=lambda: next(rcs), sleep=sleep, clock=clock,
            mesh_size_fn=lambda: 4, log_fn=lambda m: None)
        assert result["ok"] and result["restarts"] == 1

    def test_mesh_child_env_carries_the_width_only(self):
        """The port passes the width on as DL4J_ELASTIC_MESH_SIZE and
        rewrites no flags (the JAX package also forces a CPU mesh's device
        count through XLA_FLAGS, which torch does not read)."""
        from deeplearning4j_tpu_torch.train.fault_tolerance import _mesh_child_env

        env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8", "A": "1"}
        out = _mesh_child_env(env, 4)
        assert out == {**env, "DL4J_ELASTIC_MESH_SIZE": "4"}
        assert _mesh_child_env(env, None) == env
        assert out is not env  # a copy

    def test_accepts_mesh_size_arities(self):
        from deeplearning4j_tpu_torch.train.fault_tolerance import _accepts_mesh_size

        assert _accepts_mesh_size(lambda a, b, mesh_size=None: None)
        assert _accepts_mesh_size(lambda a, b, c: None)
        assert _accepts_mesh_size(lambda *args: None)
        assert not _accepts_mesh_size(lambda a, b: None)


class TestGoodputLedger:
    """The supervisor's downtime itemization and goodput ratio,
    deterministic via fake clock/sleep (no heartbeat files -> the
    boot-time and heartbeat-age terms are absent by construction)."""

    def test_result_carries_ledger_and_backoff_downtime(self, tmp_path):
        from deeplearning4j_tpu_torch.core.resilience import RetryPolicy
        from deeplearning4j_tpu_torch.obs.metrics import MetricsRegistry

        reg = MetricsRegistry()
        t = [0.0]
        slept = []

        def clock():
            return t[0]

        def sleep(dt):
            slept.append(dt)
            t[0] += dt

        rcs = iter([1, 1, 0])
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=5,
            retry_policy=RetryPolicy(max_retries=5, initial_backoff=1.0,
                                     multiplier=2.0, jitter=0.0),
            spawn_fn=lambda: next(rcs), sleep=sleep, clock=clock,
            registry=reg, log_fn=lambda m: None)
        assert result["ok"]
        gp = result["goodput"]
        # the fake clock only advances inside sleep(): wall == backoff
        # downtime, so every second was downtime and the ratio is 0
        assert gp["downtime_seconds"]["backoff"] == sum(slept) == 3.0
        assert gp["wall_seconds"] == 3.0
        assert gp["useful_seconds"] == 0.0 and gp["ratio"] == 0.0
        c = reg.counter("dl4j_tpu_training_downtime_seconds_total", "",
                        ("reason",))
        assert c.labels("backoff").value == 3.0
        g = reg.gauge("dl4j_tpu_training_goodput_ratio", "")
        assert g.value == 0.0

    def test_clean_run_has_full_goodput(self, tmp_path):
        t = [0.0]

        def clock():
            t[0] += 5.0  # every clock() read advances: wall > 0
            return t[0]

        result = elastic_fit(
            "unused:train", str(tmp_path), spawn_fn=lambda: 0,
            sleep=lambda dt: None, clock=clock, log_fn=lambda m: None)
        gp = result["goodput"]
        assert gp["ratio"] == 1.0
        assert gp["useful_seconds"] == gp["wall_seconds"] > 0
        assert all(v == 0.0 for v in gp["downtime_seconds"].values())

    def test_stall_downtime_uses_heartbeat_age(self, tmp_path):
        import json as _json

        # a heartbeat 5 "wall" seconds stale at failure time
        with open(os.path.join(str(tmp_path), "heartbeat.json"), "w") as f:
            _json.dump({"iteration": 3, "ts": time.time() - 5.0}, f)
        rcs = iter([86, 0])
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=2,
            stall_timeout=300.0,
            spawn_fn=lambda: next(rcs), sleep=lambda dt: None,
            clock=lambda: 0.0, log_fn=lambda m: None)
        assert result["ok"]
        stall_ev = result["events"][0]
        assert stall_ev["event"] == "stall"
        assert stall_ev["heartbeat_age_s"] == pytest.approx(5.0, abs=1.0)
        # the itemized stall seconds are the measured age, NOT the
        # configured 300s timeout
        assert result["goodput"]["downtime_seconds"]["stall"] == \
            pytest.approx(5.0, abs=1.0)

    def test_stall_without_heartbeat_charges_full_timeout(self, tmp_path):
        rcs = iter([86, 0])
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=2,
            stall_timeout=42.0,
            spawn_fn=lambda: next(rcs), sleep=lambda dt: None,
            clock=lambda: 0.0, log_fn=lambda m: None)
        assert result["events"][0]["heartbeat_age_s"] is None
        assert result["goodput"]["downtime_seconds"]["stall"] == 42.0


class TestHeartbeatHardening:
    """Crash-consistent heartbeat writes and a
    read path that tolerates torn/empty/garbage files."""

    def test_read_heartbeat_tolerates_missing_empty_torn(self, tmp_path):
        d = str(tmp_path)
        assert read_heartbeat(d) is None  # missing
        path = os.path.join(d, "heartbeat.json")
        open(path, "w").close()
        assert read_heartbeat(d) is None  # empty
        with open(path, "w") as f:
            f.write('{"iteration": 3, "ts"')  # torn mid-write
        assert read_heartbeat(d) is None
        with open(path, "w") as f:
            f.write("[1, 2, 3]")  # parseable but not a beat
        assert read_heartbeat(d) is None

    def test_heartbeat_write_is_atomic_and_keeps_first_ts(self, tmp_path):
        import glob

        hb = HeartbeatListener(str(tmp_path))
        hb.iteration_done(None, 1, 0, 0.5)
        first = read_heartbeat(str(tmp_path))
        time.sleep(0.02)
        hb.iteration_done(None, 2, 0, 0.4)
        second = read_heartbeat(str(tmp_path))
        assert second["iteration"] == 2
        assert second["pid"] == os.getpid()
        # first_ts survives across beats (boot-time pricing anchor) while
        # ts advances
        assert second["first_ts"] == first["first_ts"] == first["ts"]
        assert second["ts"] > first["ts"]
        # tmp + os.replace discipline leaves no debris behind
        assert glob.glob(os.path.join(str(tmp_path), "*.tmp*")) == []
        assert glob.glob(os.path.join(str(tmp_path), ".tmp*")) == []

    def test_watchdog_tolerates_ts_less_heartbeat(self, tmp_path):
        import json as _json

        with open(os.path.join(str(tmp_path), "heartbeat.json"), "w") as f:
            _json.dump({"iteration": 1}, f)  # dict, but no ts field
        fired = []
        wd = Watchdog(str(tmp_path), timeout=0.2, poll_interval=0.05,
                      on_stall=lambda: fired.append(True))
        wd.start()
        time.sleep(0.5)
        wd.stop()
        assert fired  # treated as "no beat yet", aged from start()

    def test_crash_event_heartbeat_age(self, tmp_path):
        import json as _json

        with open(os.path.join(str(tmp_path), "heartbeat.json"), "w") as f:
            _json.dump({"iteration": 9, "ts": time.time() - 7.0}, f)
        rcs = iter([1])
        result = elastic_fit(
            "unused:train", str(tmp_path), max_restarts=0,
            spawn_fn=lambda: next(rcs), sleep=lambda dt: None,
            clock=lambda: 0.0, log_fn=lambda m: None)
        ev = result["events"][0]
        assert ev["event"] == "crash"
        # died-mid-step vs stale-since-boot is now readable off the event
        assert ev["heartbeat_age_s"] == pytest.approx(7.0, abs=1.0)
        assert result["goodput"]["downtime_seconds"]["crash"] == \
            pytest.approx(7.0, abs=1.0)


def test_port_chaos_harness_four_legs_on_the_cpu():
    from deeplearning4j_tpu_torch.tools import check_training_resilience_contract as harness

    lines = []
    out = harness.run_legs(device="cpu", model="mlp", log=lines.append)
    assert lines[-1] == "training resilience contract OK"
    assert out["sigterm"]["lost_iterations"] == 0
    assert out["sigkill"]["rcs"][0] < 0 and out["stall"]["rcs"][0] == 86
    # every boot reached its first step, and the ledger priced the downtime
    assert all(len(leg["boot_seconds"]) == len(leg["rcs"]) for leg in out.values())
    assert out["stall"]["result"]["goodput"]["downtime_seconds"]["stall"] > 0
