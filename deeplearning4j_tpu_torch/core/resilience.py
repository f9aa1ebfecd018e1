"""Resilience primitives for serving and elastic training.

The north star is a system serving heavy traffic, and at that scale the
failure path IS the hot path (PAPERS.md: MLPerf TPU-v3 pods, TPU
generations retrospective — detection, fast-fail and restart discipline
are the load-bearing properties of a production fleet). This module is
the one place those policies live; consumers
(:class:`~deeplearning4j_tpu_torch.parallel.inference.ParallelInference`,
:class:`~deeplearning4j_tpu_torch.remote.server.JsonModelServer`,
:func:`~deeplearning4j_tpu_torch.train.fault_tolerance.elastic_fit`) thread
them through rather than hand-rolling timeouts and sleeps.

Everything takes an injectable ``clock`` / ``sleep`` so the whole state
machine is testable on CPU with a fake clock — no wall-clock sleeps in
tier-1. The :class:`FaultInjector` closes the loop: deterministic,
seeded exception/latency injection at named sites so overload and
recovery paths are exercised by ordinary tests.
"""

from __future__ import annotations

import enum
import inspect
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------
class ResilienceError(RuntimeError):
    """Base class for policy-driven rejections (not model errors)."""


class DeadlineExceededError(ResilienceError, TimeoutError):
    """The request's deadline expired (maps to HTTP 504)."""


class AdmissionRejectedError(ResilienceError):
    """Load shed: the admission controller refused the request (HTTP 503).
    ``retry_after`` hints when a retry might be admitted."""

    def __init__(self, msg: str = "overloaded", retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class CircuitOpenError(ResilienceError):
    """The circuit breaker is open — fail fast, do not attempt the call
    (HTTP 503). ``retry_after`` hints when the breaker will probe again."""

    def __init__(self, msg: str = "circuit open", retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = float(retry_after)


class CrashLoopError(ResilienceError):
    """Restart budget exhausted inside the crash-loop window."""


class ReplicaUnavailableError(ResilienceError):
    """A (remote) replica could not take or finish the request: connection
    refused/reset, read timeout, truncated response, or a 503 from the
    host. The pool layer treats this as "the HOST failed, not the
    request" and fails the request over to the next least-loaded replica
    — never raised for a 400 (resending malformed input elsewhere cannot
    help). ``retry_after`` carries the host's Retry-After hint when one
    was sent."""

    def __init__(self, msg: str = "replica unavailable",
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.retry_after = retry_after


# --------------------------------------------------------------------------
# Deadline
# --------------------------------------------------------------------------
class Deadline:
    """Absolute point on a monotonic clock by which work must finish.

    A deadline travels WITH the request (queue -> batcher -> forward ->
    response) so every stage can cheaply ask "is this still worth doing?"
    — an expired request is dropped before it wastes a forward.
    """

    __slots__ = ("_at", "_clock")

    def __init__(self, at: Optional[float],
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._at = None if at is None else float(at)
        self._clock = clock

    @classmethod
    def after(cls, seconds: Optional[float],
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        if seconds is None:
            return cls(None, clock)
        return cls(clock() + float(seconds), clock)

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    def remaining(self) -> Optional[float]:
        """Seconds left (may be negative); None means unbounded."""
        if self._at is None:
            return None
        return self._at - self._clock()

    def expired(self) -> bool:
        return self._at is not None and self._clock() >= self._at

    def check(self, what: str = "request") -> None:
        rem = self.remaining()
        if rem is not None and rem <= 0:
            raise DeadlineExceededError(
                f"{what} deadline exceeded by {-rem:.3f}s")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Deadline(remaining={self.remaining()})"


# --------------------------------------------------------------------------
# RetryPolicy
# --------------------------------------------------------------------------
class RetryPolicy:
    """Exponential backoff with seeded full-jitter.

    ``backoff(attempt)`` is deterministic for a given ``seed`` — retry
    storms de-correlate in production (every client seeds differently)
    while tests replay exactly.
    """

    def __init__(self, *, max_retries: int = 3, initial_backoff: float = 0.1,
                 multiplier: float = 2.0, max_backoff: float = 10.0,
                 jitter: float = 0.5, seed: Optional[int] = None) -> None:
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = int(max_retries)
        self.initial_backoff = float(initial_backoff)
        self.multiplier = float(multiplier)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        # standing retry observer: fn(attempt, exc, delay) on every retry
        # (in addition to any per-execute on_retry). Lets obs wiring count
        # attempts without threading a callback through each call site.
        self.observer: Optional[Callable[[int, BaseException, float], None]] = None

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based)."""
        base = min(self.max_backoff,
                   self.initial_backoff * self.multiplier ** attempt)
        if self.jitter <= 0:
            return base
        # full jitter over [base*(1-j), base]: bounded below so a retry
        # never fires immediately, spread above so clients de-correlate
        return base * (1.0 - self.jitter * self._rng.random())

    def execute(self, fn: Callable, *, retry_on=(Exception,),
                deadline: Optional[Deadline] = None,
                sleep: Callable[[float], None] = time.sleep,
                on_retry: Optional[Callable[[int, BaseException, float], None]] = None):
        """Run ``fn`` with retries. Never sleeps past ``deadline``; a retry
        that cannot fit re-raises the last error immediately."""
        attempt = 0
        while True:
            if deadline is not None:
                deadline.check("retry")
            try:
                return fn()
            except retry_on as e:
                if attempt >= self.max_retries:
                    raise
                delay = self.backoff(attempt)
                retry_after = getattr(e, "retry_after", None)
                if retry_after is not None:
                    delay = max(delay, float(retry_after))
                if deadline is not None:
                    rem = deadline.remaining()
                    if rem is not None and delay >= rem:
                        raise  # the retry cannot complete in time
                if self.observer is not None:
                    self.observer(attempt, e, delay)
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                sleep(delay)
                attempt += 1


# --------------------------------------------------------------------------
# CircuitBreaker
# --------------------------------------------------------------------------
class CircuitState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Closed / open / half-open breaker over a sliding outcome window.

    Opens when, with at least ``min_calls`` recent outcomes, the failure
    rate reaches ``failure_threshold`` — a poisoned jitted forward (every
    call raises) trips it within ``min_calls`` calls instead of burning a
    device dispatch per queued request. After ``open_timeout`` it lets
    ``half_open_max_calls`` probes through; all-success closes it, any
    failure re-opens with a fresh timeout.
    """

    def __init__(self, *, failure_threshold: float = 0.5, min_calls: int = 5,
                 window: int = 20, open_timeout: float = 30.0,
                 half_open_max_calls: int = 1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not 0.0 < failure_threshold <= 1.0:
            raise ValueError("failure_threshold must be in (0, 1]")
        self.failure_threshold = float(failure_threshold)
        self.min_calls = int(min_calls)
        self.open_timeout = float(open_timeout)
        self.half_open_max_calls = int(half_open_max_calls)
        self._clock = clock
        self._outcomes: deque = deque(maxlen=int(window))
        self._state = CircuitState.CLOSED
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self._lock = threading.Lock()
        # state-transition observers: fn(old_state, new_state). Transitions
        # happen under self._lock, so notifications are buffered and fired
        # AFTER release — an observer may safely call back into the breaker
        # (e.g. to read retry_after) without deadlocking. No behavior
        # change when no observer is registered.
        self._observers: List[Callable[[CircuitState, CircuitState], None]] = []
        self._pending_transitions: List[tuple] = []

    def add_observer(
            self, fn: Callable[[CircuitState, CircuitState], None]) -> None:
        """Register ``fn(old_state, new_state)`` for every transition."""
        self._observers.append(fn)

    def remove_observer(self, fn) -> None:
        try:
            self._observers.remove(fn)
        except ValueError:
            pass

    def _set_state(self, new: CircuitState) -> None:
        """Transition under the lock; queue the observer notification."""
        old = self._state
        self._state = new
        if self._observers and old is not new:
            self._pending_transitions.append((old, new))

    def _notify(self) -> None:
        """Drain queued transitions — call with the lock RELEASED."""
        while self._pending_transitions:
            old, new = self._pending_transitions.pop(0)
            for fn in list(self._observers):
                fn(old, new)

    @property
    def state(self) -> CircuitState:
        with self._lock:
            self._maybe_half_open()
            s = self._state
        self._notify()
        return s

    def _maybe_half_open(self) -> None:
        if (self._state is CircuitState.OPEN
                and self._clock() - self._opened_at >= self.open_timeout):
            self._set_state(CircuitState.HALF_OPEN)
            self._half_open_inflight = 0

    def retry_after(self) -> float:
        """Seconds until the breaker will next admit a probe."""
        with self._lock:
            if self._state is not CircuitState.OPEN:
                return 0.0
            return max(0.0, self.open_timeout - (self._clock() - self._opened_at))

    def allow(self) -> bool:
        """True if a call may proceed now (reserves a half-open probe slot)."""
        with self._lock:
            self._maybe_half_open()
            if self._state is CircuitState.CLOSED:
                ok = True
            elif self._state is CircuitState.HALF_OPEN:
                ok = self._half_open_inflight < self.half_open_max_calls
                if ok:
                    self._half_open_inflight += 1
            else:
                ok = False
        self._notify()
        return ok

    def check(self) -> None:
        if not self.allow():
            raise CircuitOpenError(retry_after=self.retry_after())

    def release(self) -> None:
        """Release a slot reserved by ``allow()``/``check()`` when the
        call ended with neither a host success nor a host failure (the
        caller's bad input, the caller's deadline). Leaves the state and
        the outcome window untouched — without this, a 400/504 landing
        in the single half-open trial slot would wedge the breaker in
        HALF_OPEN forever (no probe could ever run again)."""
        with self._lock:
            if self._state is CircuitState.HALF_OPEN:
                self._half_open_inflight = max(
                    0, self._half_open_inflight - 1)

    def record_success(self) -> None:
        with self._lock:
            if self._state is CircuitState.HALF_OPEN:
                self._half_open_inflight = max(0, self._half_open_inflight - 1)
                # probe succeeded -> close with a clean window (old
                # failures must not instantly re-trip the breaker)
                self._set_state(CircuitState.CLOSED)
                self._outcomes.clear()
            self._outcomes.append(True)
        self._notify()

    def record_failure(self) -> None:
        with self._lock:
            self._outcomes.append(False)
            if self._state is CircuitState.HALF_OPEN:
                self._trip()
            elif self._state is CircuitState.CLOSED:
                n = len(self._outcomes)
                if n >= self.min_calls:
                    failures = sum(1 for ok in self._outcomes if not ok)
                    if failures / n >= self.failure_threshold:
                        self._trip()
        self._notify()

    def _trip(self) -> None:
        self._set_state(CircuitState.OPEN)
        self._opened_at = self._clock()
        self._half_open_inflight = 0

    def call(self, fn: Callable, *args, **kwargs):
        self.check()
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


# --------------------------------------------------------------------------
# AdmissionController
# --------------------------------------------------------------------------
class _PriorityBudget:
    """Per-class admission budget: a fraction of the pending window plus a
    weighted slice of the token-bucket refill."""

    __slots__ = ("fraction", "rate", "burst", "tokens", "admitted", "shed")

    def __init__(self, fraction: float, rate: Optional[float],
                 burst: float) -> None:
        self.fraction = fraction
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.admitted = 0
        self.shed = 0


class AdmissionController:
    """Bounded fail-fast admission: pending-slot cap plus an optional
    token bucket. Overload answers immediately (shed -> HTTP 503 +
    Retry-After) instead of blocking the caller on a full queue.

    **Priority classes** (``priorities=``): a mapping of class name to a
    fraction in (0, 1] of ``max_pending`` that class may fill, e.g.
    ``{"high": 1.0, "normal": 0.85, "low": 0.6}``. As the pending window
    fills, classes shed in ascending-fraction order — low-priority
    traffic is refused while high-priority requests still fit, so
    overload degrades the cheapest traffic first instead of collapsing
    tail latency for everyone. When ``rate`` is also set, each class gets
    its own token bucket with the refill split proportionally to its
    fraction (weighted token buckets): one class exhausting its slice
    never starves another's. Requests naming an unknown class are
    treated as the lowest-fraction class (strictest budget — headers are
    client-controlled, so unknown names must not escalate). ``admit()``
    without a priority uses the highest-fraction class, which keeps the
    single-class behavior exactly as before; ``priorities=None`` (the
    default) is byte-identical to the pre-priority controller.
    """

    def __init__(self, *, max_pending: int = 256,
                 rate: Optional[float] = None, burst: Optional[float] = None,
                 priorities: Optional[Dict[str, float]] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.max_pending = int(max_pending)
        self.rate = None if rate is None else float(rate)
        self.burst = float(burst if burst is not None
                           else (rate if rate is not None else 0.0))
        self._clock = clock
        self._tokens = self.burst
        self._last_refill = clock()
        self._pending = 0
        self._shed = 0
        self._admitted = 0
        self._lock = threading.Lock()
        self._priorities: Optional[Dict[str, _PriorityBudget]] = None
        self._default_priority: Optional[str] = None
        self._lowest_priority: Optional[str] = None
        if priorities:
            total = sum(float(f) for f in priorities.values())
            self._priorities = {}
            for pname, frac in priorities.items():
                frac = float(frac)
                if not 0.0 < frac <= 1.0:
                    raise ValueError(
                        f"priority fraction for {pname!r} must be in (0, 1], "
                        f"got {frac}")
                share = frac / total if total > 0 else 0.0
                self._priorities[pname] = _PriorityBudget(
                    frac,
                    None if self.rate is None else self.rate * share,
                    self.burst * share if self.rate is not None else 0.0)
            ordered = sorted(priorities, key=lambda n: float(priorities[n]))
            self._lowest_priority = ordered[0]
            self._default_priority = ordered[-1]
        # decision observers: fn(decision, pending) — or, when the
        # callable accepts a third parameter, fn(decision, pending,
        # priority) — with decision in {"admitted", "shed"}, called AFTER
        # the lock is released (an observer may read .pending/.stats()).
        # No behavior change unset.
        self._observers: List[tuple] = []

    @staticmethod
    def _observer_arity(fn) -> bool:
        """True when ``fn`` accepts a third (priority) argument."""
        try:
            return len(inspect.signature(fn).parameters) >= 3
        except (TypeError, ValueError):  # builtins, exotic callables
            return False

    def add_observer(self, fn: Callable[..., None]) -> None:
        """Register ``fn(decision, pending)`` — or
        ``fn(decision, pending, priority)`` — for every admit/shed call."""
        self._observers.append((fn, self._observer_arity(fn)))

    def remove_observer(self, fn) -> None:
        self._observers = [(f, a) for f, a in self._observers if f is not fn]

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending

    @property
    def priority_classes(self) -> tuple:
        """Configured class names, highest-fraction first (empty when
        priorities are not enabled)."""
        if self._priorities is None:
            return ()
        return tuple(sorted(self._priorities,
                            key=lambda n: -self._priorities[n].fraction))

    def _resolve(self, priority: Optional[str]) -> Optional[str]:
        if self._priorities is None:
            return None
        if priority is None:
            return self._default_priority
        if priority in self._priorities:
            return priority
        return self._lowest_priority

    def _refill(self) -> None:
        if self.rate is None:
            return
        now = self._clock()
        dt = now - self._last_refill
        self._tokens = min(self.burst, self._tokens + dt * self.rate)
        if self._priorities is not None:
            for b in self._priorities.values():
                if b.rate is not None:
                    b.tokens = min(b.burst, b.tokens + dt * b.rate)
        self._last_refill = now

    def try_admit(self, priority: Optional[str] = None) -> bool:
        pname = self._resolve(priority)
        with self._lock:
            self._refill()
            budget = (self._priorities[pname]
                      if pname is not None else None)
            window = (self.max_pending if budget is None
                      else max(1, int(round(self.max_pending
                                            * budget.fraction))))
            tokens_ok = True
            if self.rate is not None:
                tokens_ok = ((self._tokens >= 1.0) if budget is None
                             else (budget.tokens >= 1.0))
            if self._pending >= window or not tokens_ok:
                self._shed += 1
                if budget is not None:
                    budget.shed += 1
                admitted = False
            else:
                if self.rate is not None:
                    if budget is None:
                        self._tokens -= 1.0
                    else:
                        budget.tokens -= 1.0
                self._pending += 1
                self._admitted += 1
                if budget is not None:
                    budget.admitted += 1
                admitted = True
            pending = self._pending
        decision = "admitted" if admitted else "shed"
        for fn, wants_priority in list(self._observers):
            if wants_priority:
                fn(decision, pending, pname or "default")
            else:
                fn(decision, pending)
        return admitted

    def admit(self, priority: Optional[str] = None) -> None:
        if not self.try_admit(priority):
            detail = "" if priority is None else f" (priority {priority!r})"
            raise AdmissionRejectedError(
                f"overloaded: {self.pending}/{self.max_pending} "
                f"pending{detail}",
                retry_after=self.retry_after())

    def release(self) -> None:
        with self._lock:
            self._pending = max(0, self._pending - 1)

    def retry_after(self) -> float:
        """Hint for Retry-After: time for one token (rate-limited) or a
        nominal 1s drain guess when only the slot cap is binding."""
        if self.rate is not None and self.rate > 0:
            return max(1.0 / self.rate, 0.001)
        return 1.0

    def stats(self) -> Dict:
        with self._lock:
            out: Dict = {"pending": self._pending,
                         "admitted": self._admitted, "shed": self._shed}
            if self._priorities is not None:
                out["by_priority"] = {
                    pname: {"admitted": b.admitted, "shed": b.shed,
                            "fraction": b.fraction}
                    for pname, b in sorted(self._priorities.items())}
            return out


# --------------------------------------------------------------------------
# FaultInjector
# --------------------------------------------------------------------------
class _FaultPlan:
    __slots__ = ("exc_factory", "latency", "times", "probability")

    def __init__(self, exc_factory, latency, times, probability):
        self.exc_factory = exc_factory
        self.latency = latency
        self.times = times  # None = unlimited
        self.probability = probability


class FaultInjector:
    """Deterministic, seeded fault injection at named sites.

    Production code calls :meth:`fire` at instrumented sites (a no-op
    when nothing is planned); tests plan exceptions/latency against those
    site names. ``times=N`` arms exactly N firings; ``probability`` draws
    from the injector's own seeded RNG so a given seed replays the exact
    same fault sequence — overload and recovery become ordinary
    deterministic tests.
    """

    def __init__(self, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._plans: Dict[str, List[_FaultPlan]] = {}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    # ---- planning (test side) ----------------------------------------
    def inject_error(self, site: str, exc_factory: Callable[[], BaseException],
                     *, times: Optional[int] = 1,
                     probability: float = 1.0) -> "FaultInjector":
        with self._lock:
            self._plans.setdefault(site, []).append(
                _FaultPlan(exc_factory, None, times, probability))
        return self

    def inject_latency(self, site: str, seconds: float, *,
                       times: Optional[int] = 1,
                       probability: float = 1.0) -> "FaultInjector":
        with self._lock:
            self._plans.setdefault(site, []).append(
                _FaultPlan(None, float(seconds), times, probability))
        return self

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._plans.clear()
            else:
                self._plans.pop(site, None)

    def fired(self, site: str) -> int:
        with self._lock:
            return self._fired.get(site, 0)

    # ---- firing (production side) ------------------------------------
    def fire(self, site: str) -> None:
        """Apply any armed faults for ``site``: latency first, then raise."""
        if not self._plans:
            # lock-free fast path: serving hot paths fire sites on every
            # request, and an unarmed injector must cost a dict check,
            # not a contended lock. Benign race: plans are armed before
            # traffic in every test, and a concurrent arm is picked up
            # by the next fire.
            return
        with self._lock:
            plans = self._plans.get(site)
            if not plans:
                return
            latency = None
            exc = None
            for plan in list(plans):
                if plan.probability < 1.0 and self._rng.random() >= plan.probability:
                    continue
                if plan.times is not None:
                    plan.times -= 1
                    if plan.times <= 0:
                        plans.remove(plan)
                self._fired[site] = self._fired.get(site, 0) + 1
                if plan.latency is not None:
                    latency = plan.latency
                if plan.exc_factory is not None:
                    exc = plan.exc_factory()
                    break
            if not plans:
                self._plans.pop(site, None)
        if latency is not None:
            self._sleep(latency)
        if exc is not None:
            raise exc


_NULL_INJECTOR = FaultInjector()  # never armed: fire() is a cheap no-op
_default_injector = _NULL_INJECTOR


def get_fault_injector() -> FaultInjector:
    return _default_injector


def set_fault_injector(injector: Optional[FaultInjector]) -> FaultInjector:
    """Install a process-global injector (tests); None restores the inert
    default. Returns the previous injector so callers can restore it."""
    global _default_injector
    prev = _default_injector
    _default_injector = injector if injector is not None else _NULL_INJECTOR
    return prev
