"""DecodeEngine — continuous-batching autoregressive decode serving (port
of ``deeplearning4j_tpu/parallel/decode.py``).

The engine multiplexes long-lived sequences at different positions into
one preallocated KV cache, on one worker thread:

* **admit** — pending requests (fail-fast admitted through the shared
  :class:`~deeplearning4j_tpu_torch.core.resilience.AdmissionController`;
  a full window sheds with ``AdmissionRejectedError``) claim free cache
  slots. Each prefills alone at its bucketed prompt length
  (``session.bucket_sizes()``) and its 1-row carry is copied into the
  slot.
* **step** — ONE ``[B, 1]`` forward advances every active slot (rows at
  different positions share the step; idle and finished rows are kept
  unchanged by an active mask), per-row seeded sampling on the device
  picks each next token, and tokens stream to per-request event queues.
  On the card this plain step (forward, sampler, freeze) is captured once
  in a CUDA graph and replayed: the JAX engine's one jitted dispatch a
  step. The per-row inputs go in as two small tensors, the block tables
  are a tensor of the carry updated in place.
* **retire** — eos / ``max_tokens`` / ``max_len`` complete a request; an
  expired :class:`Deadline` ends it mid-stream with partial output
  (reason "deadline"); a cancelled handle frees its slot on the next loop
  turn. Retirement releases the admission slot.
* **speculate** — with ``draft_model=``, each turn runs the draft ``k+1``
  times at ``[B, 1]``, verifies the ``k`` proposals with ONE ``tq=k+1``
  target forward, and commits through exact acceptance sampling (greedy
  streams token-for-token those of plain decode). Rows near ``max_len``
  (or with per-request ``speculative_k=0``) take the plain step in the
  same turn. The speculative step runs eagerly. :class:`DecodeAIMD`
  adapts the current ``k`` and the active-slot target against a
  per-token p95 budget (``adaptive=True``).

Failures run through a :class:`CircuitBreaker`: a failing decode step
fails the affected requests (reason "failed") and opens the breaker, so
new submits shed instead of queueing behind a broken step.

The carry is written in place, so a step must not touch an inactive row:
``generate.paged.redirect_inactive_writes`` sends those rows' paged writes
to the trash block and makes static-cache writes write back what the row
holds, and ``generate.paged.freeze_rows`` commits positions for the active
rows only.

The disaggregated prefill handoff (``submit_prefilled``) waits for the
serving stack (ROADMAP A4) and raises.

Observability: the JAX engine's metric names (``dl4j_tpu_generate_*``) in
the registry; traced requests get ``engine.prefill`` and ``engine.decode``
spans.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.resilience import (
    AdmissionController,
    CircuitBreaker,
    CircuitOpenError,
    CircuitState,
    Deadline,
)
from ..generate.paged import (
    BlockAllocator,
    OutOfBlocksError,
    block_bytes,
    blocks_needed,
    paged_decode_state,
)
from ..generate.sampling import sample_tokens
from ..generate.session import (GenerationSession, SpeculativeGenerationSession,
                                bucket_length, carry_bytes)
from ..obs.metrics import MetricsRegistry, get_registry
from ..obs.tracing import Tracer, current_context, get_tracer, trace_now
from ..ops.cuda_graph import GraphedStep
from ..ops.paged_attention import pack_row_blocks

_engine_seq = itertools.count()

_OUTCOMES = ("completed", "deadline", "cancelled", "shed", "failed",
             "circuit_rejected")


class GenerationHandle:
    """Per-request streaming handle: the engine pushes ``{"token", "index"}``
    events and one terminal ``{"done": True, "reason", "count"}`` event;
    the consumer iterates :meth:`events` (a server handler streams them as
    chunks) or blocks on :meth:`result`. :meth:`cancel` (e.g. on client
    disconnect) asks the engine to retire the request and free its cache
    slot at the next loop turn."""

    def __init__(self, request_id: str, deadline: Deadline) -> None:
        self.request_id = request_id
        self.deadline = deadline
        self.tokens: List[int] = []
        self.reason: Optional[str] = None
        self._events: "queue.Queue[dict]" = queue.Queue()
        self._done = threading.Event()
        self._cancelled = threading.Event()
        self._cb_lock = threading.Lock()
        self._on_done: List[Callable[["GenerationHandle"], None]] = []

    # ----- engine side -----
    def _emit(self, index: int, token: int) -> None:
        self.tokens.append(int(token))
        self._events.put({"token": int(token), "index": int(index)})

    def _finish(self, reason: str, error: Optional[str] = None) -> None:
        self.reason = reason
        ev = {"done": True, "reason": reason, "count": len(self.tokens)}
        if error:
            ev["error"] = error
        self._events.put(ev)
        with self._cb_lock:
            self._done.set()
            cbs = list(self._on_done)
            self._on_done.clear()
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a callback never kills the loop
                pass

    def add_done_callback(
            self, fn: Callable[["GenerationHandle"], None]) -> None:
        """Run ``fn(handle)`` when the terminal event lands (immediately
        if it already has) — race-free: registration and the done flag
        share one lock, so the callback fires exactly once. A replica
        pool uses this to release its admission slot."""
        with self._cb_lock:
            if not self._done.is_set():
                self._on_done.append(fn)
                return
        try:
            fn(self)
        except Exception:  # noqa: BLE001
            pass

    # ----- consumer side -----
    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def events(self, timeout: Optional[float] = None):
        """Yield events in order until (and including) the terminal one."""
        while True:
            ev = self._events.get(timeout=timeout)
            yield ev
            if ev.get("done"):
                return

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout=timeout):
            raise TimeoutError("generation not finished")
        return list(self.tokens)


class _Request:
    __slots__ = ("prompt", "max_tokens", "eos_id", "handle", "seed",
                 "greedy", "temp", "top_k", "top_p", "spec_k", "trace_ctx",
                 "t_submit", "t_decode_start")

    def __init__(self, prompt, max_tokens, eos_id, handle, seed, greedy,
                 temp, top_k, top_p, spec_k, trace_ctx) -> None:
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos_id = eos_id
        self.handle = handle
        self.seed = seed
        self.greedy = greedy
        self.temp = temp
        self.top_k = top_k
        self.top_p = top_p
        self.spec_k = spec_k  # None = follow the engine's adaptive k
        self.trace_ctx = trace_ctx
        self.t_submit = trace_now() if trace_ctx is not None else 0.0
        self.t_decode_start = 0.0


class DecodeEngine:
    def __init__(
        self,
        model,
        *,
        max_len: int = 256,
        slots: int = 8,
        default_timeout: Optional[float] = None,
        default_max_tokens: int = 64,
        admission: Optional[AdmissionController] = None,
        queue_limit: int = 64,
        circuit_breaker: Optional[CircuitBreaker] = None,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[MetricsRegistry] = None,
        name: Optional[str] = None,
        tracer: Optional[Tracer] = None,
        step_hook: Optional[Callable[[], None]] = None,
        draft_model=None,
        speculative_k: int = 4,
        adaptive: bool = False,
        target_p95_s: float = 0.05,
        adjust_interval: float = 0.5,
        cache_dtype: Optional[str] = None,
        block_size: Optional[int] = None,
        num_kv_blocks: Optional[int] = None,
    ) -> None:
        """``draft_model=`` turns on speculative decoding: the draft
        proposes up to ``speculative_k`` tokens per step, one tq=k+1
        target forward verifies them, and exact acceptance sampling keeps
        the output law (greedy streams token-identical to plain decode).
        ``adaptive=True`` runs the decode-side AIMD controller
        (:class:`DecodeAIMD`): the current ``k`` and the active-slot
        target adapt against ``target_p95_s`` per-token latency, ticked
        every ``adjust_interval`` seconds on the engine loop
        (``adjust_interval=0`` -> manual :meth:`adjust`).
        ``cache_dtype="int8"`` stores the attention KV caches quantized
        (per-slot/per-head scales on the carry; dequant inside the decode
        attention). ``block_size=`` switches the cache to the PAGED layout:
        fixed-size blocks in a shared per-layer pool of ``num_kv_blocks``
        (default: the static layout's capacity, ``slots * max_len /
        block_size`` plus the trash block) with per-row block tables,
        allocated at admit, grown as rows advance and freed at
        retire/cancel. Greedy streams are token-identical to the static
        layout; composes with ``cache_dtype="int8"``. The model's device
        is the engine's."""
        if draft_model is not None:
            self._spec = SpeculativeGenerationSession(
                model, draft_model, max_len=max_len,
                k=max(1, int(speculative_k)), cache_dtype=cache_dtype)
            self.session = self._spec.target
        else:
            self._spec = None
            self.session = GenerationSession(model, max_len=max_len,
                                             cache_dtype=cache_dtype)
        self.cache_dtype = cache_dtype
        self.max_len = int(max_len)
        self.slots = int(slots)
        # paged KV cache config (None = static slot x max_len layout)
        self.block_size = None if block_size is None else int(block_size)
        if self.block_size is not None:
            if self.block_size < 1:
                raise ValueError("block_size must be >= 1")
            if self.max_len % self.block_size:
                raise ValueError(
                    f"max_len {self.max_len} not divisible by block_size "
                    f"{self.block_size}")
            self.num_kv_blocks = (
                self.slots * (self.max_len // self.block_size) + 1
                if num_kv_blocks is None else int(num_kv_blocks))
        else:
            self.num_kv_blocks = None
        self.default_timeout = default_timeout
        self.default_max_tokens = int(default_max_tokens)
        self._clock = clock
        self._tracer = tracer  # None -> process-global at call time
        self._step_hook = step_hook  # test seam: runs after each decode step
        self.name = name or f"decode-{next(_engine_seq)}"
        self._admission = admission or AdmissionController(
            max_pending=queue_limit, clock=clock)
        self._breaker = circuit_breaker or CircuitBreaker(clock=clock)
        # decode-side AIMD knobs: current speculation depth (clamped to
        # the construction-time ceiling) and the active-slot target
        self.max_speculative_k = (max(1, int(speculative_k))
                                  if self._spec is not None else 0)
        self._spec_k = self.max_speculative_k
        self._slot_target = self.slots
        self._init_metrics(registry if registry is not None else get_registry())

        # device-side batch state: one preallocated carry, updated in place
        self._device = self.session.model.device
        if self.block_size is not None:
            self._carry = paged_decode_state(
                self.session, self.slots, block_size=self.block_size,
                num_blocks=self.num_kv_blocks)
            self._allocator = BlockAllocator(self.num_kv_blocks)
            # host image of every row's block list, mirrored into ONE device
            # table that every paged layer of the carry shares
            self._block_tables = np.zeros(
                (self.slots, self.max_len // self.block_size), np.int32)
            self._nblocks = np.zeros((self.slots,), np.int32)
            self._block_bytes = block_bytes(self.session, self.block_size)
            self._table = torch.zeros(self._block_tables.shape, dtype=torch.int32,
                                      device=self._device)
            for st in self._carry.values():
                if "block_table" in st:
                    st["block_table"] = self._table
        else:
            self._carry = self.session.decode_state(self.slots)
            self._allocator = None
        # the draft cache stays static (slot x max_len): proposals run every
        # slot each turn, and the draft rows rewind with the target's
        self._draft_carry = (None if self._spec is None
                             else self._spec.draft.decode_state(self.slots))
        self._aux_kv_bytes = 0 if self._draft_carry is None else carry_bytes(self._draft_carry)
        if self._allocator is None:
            # static layout: resident bytes are the preallocated carry
            self._kv_cache_bytes = self._aux_kv_bytes + carry_bytes(self._carry)
            self._g_kv_bytes.set(self._kv_cache_bytes)
        else:
            self._update_kv_bytes()
        self._active = np.zeros((self.slots,), bool)
        self._last = np.zeros((self.slots,), np.int32)
        self._steps = np.zeros((self.slots,), np.int32)
        self._seeds = np.zeros((self.slots,), np.uint32)
        self._greedy = np.ones((self.slots,), bool)
        self._temps = np.ones((self.slots,), np.float32)
        self._ks = np.zeros((self.slots,), np.int32)
        self._ps = np.ones((self.slots,), np.float32)
        # committed cache frontier (next write position) per slot, and the
        # per-request speculation cap (-1 = follow the engine's current k)
        self._pos = np.zeros((self.slots,), np.int64)
        self._spec_caps = np.full((self.slots,), -1, np.int32)
        self._requests: List[Optional[_Request]] = [None] * self.slots
        self.aimd = DecodeAIMD(self, target_p95_s=target_p95_s)
        self._adaptive = bool(adaptive)
        self._adjust_interval = float(adjust_interval)
        self._next_adjust = clock() + self._adjust_interval
        # the plain step's CUDA graph: captured at the second plain step
        # (the first runs eagerly and sets up libraries and workspaces)
        self._graph: Optional[GraphedStep] = None
        self._graph_warm = False

        self._pending: "deque[_Request]" = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._shutdown = False
        self._draining = False
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.name}-loop", daemon=True)
        self._thread.start()

    # ----- metrics ----------------------------------------------------
    def _init_metrics(self, reg: MetricsRegistry) -> None:
        self.registry = reg
        inst = self.name
        req = reg.counter(
            "dl4j_tpu_generate_requests_total",
            "Generation requests by outcome", ("instance", "outcome"))
        self._c = {o: req.labels(inst, o) for o in _OUTCOMES}
        self._c_tokens = reg.counter(
            "dl4j_tpu_generate_tokens_total",
            "Tokens emitted across all generation requests",
            ("instance",)).labels(inst)
        self._g_inflight = reg.gauge(
            "dl4j_tpu_generate_in_flight_sequences",
            "Generation requests admitted and not yet finished",
            ("instance",)).labels(inst)
        self._g_active = reg.gauge(
            "dl4j_tpu_generate_active_slots",
            "Cache slots currently decoding", ("instance",)).labels(inst)
        self._h_decode = reg.histogram(
            "dl4j_tpu_generate_decode_latency_seconds",
            "Per-token decode latency (one continuous-batched step emits "
            "one token per active sequence)", ("instance",)).labels(inst)
        self._h_prefill = reg.histogram(
            "dl4j_tpu_generate_prefill_latency_seconds",
            "Prompt prefill latency (bucketed length, batch of one)",
            ("instance",)).labels(inst)
        self._h_token = reg.histogram(
            "dl4j_tpu_generate_token_latency_seconds",
            "Per-emitted-token latency per sequence (step time divided by "
            "the tokens that sequence committed — the AIMD control signal)",
            ("instance",)).labels(inst)
        self._c_spec_steps = reg.counter(
            "dl4j_tpu_generate_spec_steps_total",
            "Speculative propose/verify steps executed",
            ("instance",)).labels(inst)
        self._c_spec_proposed = reg.counter(
            "dl4j_tpu_generate_spec_proposed_total",
            "Draft tokens proposed for verification",
            ("instance",)).labels(inst)
        self._c_spec_accepted = reg.counter(
            "dl4j_tpu_generate_spec_accepted_total",
            "Draft tokens accepted by the target",
            ("instance",)).labels(inst)
        self._g_spec_k = reg.gauge(
            "dl4j_tpu_generate_speculative_k",
            "Current speculation depth (0 = speculative decoding off)",
            ("instance",)).labels(inst)
        self._g_spec_k.set(self._spec_k)
        self._g_slot_target = reg.gauge(
            "dl4j_tpu_generate_slot_target",
            "AIMD active-slot target (admission fills at most this many "
            "cache slots)", ("instance",)).labels(inst)
        self._g_slot_target.set(self._slot_target)
        self._g_kv_bytes = reg.gauge(
            "dl4j_tpu_generate_kv_cache_bytes",
            "Live resident bytes of the decode KV cache: the full "
            "preallocated carry for the static layout, allocated blocks "
            "x block bytes (+ the static draft cache) for the paged one "
            "— updated on admit/grow/retire, so the gauge tracks what "
            "resident sequences actually hold", ("instance",)).labels(inst)

    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    # ----- paged block accounting (engine-loop thread only) ------------
    def _update_kv_bytes(self) -> None:
        used = self._allocator.total_blocks - self._allocator.free_blocks
        self._kv_cache_bytes = used * self._block_bytes + self._aux_kv_bytes
        self._g_kv_bytes.set(self._kv_cache_bytes)

    def _push_tables(self) -> None:
        """Mirror the host block tables into the carry's one shared device
        table, in place (the plain step's graph reads it there)."""
        self._table.copy_(torch.from_numpy(self._block_tables))

    def _ensure_blocks(self, slot: int, upto: int) -> None:
        """Grow ``slot``'s block list to cover positions ``[0, upto)``.
        All-or-nothing: raises :class:`OutOfBlocksError` without touching
        any state when the pool cannot satisfy it."""
        need = blocks_needed(upto, self.block_size)
        held = int(self._nblocks[slot])
        if need <= held:
            return
        ids = self._allocator.alloc(need - held)
        self._block_tables[slot, held:need] = ids
        self._nblocks[slot] = need
        self._push_tables()
        self._update_kv_bytes()

    def _release_blocks(self, slot: int) -> None:
        if self._allocator is None:
            return
        held = int(self._nblocks[slot])
        if held:
            self._allocator.free(self._block_tables[slot, :held].tolist())
            self._block_tables[slot, :held] = 0
            self._nblocks[slot] = 0
            self._push_tables()
            self._update_kv_bytes()

    def _preempt_row(self, slot: int, why: str) -> None:
        """A mid-stream allocation failed and nothing retires this turn:
        fail the row cleanly (partial tokens already streamed) and return
        its blocks to the pool."""
        req = self._requests[slot]
        self._requests[slot] = None
        self._active[slot] = False
        self._release_blocks(slot)
        self._g_active.set(int(self._active.sum()))
        if req is not None:
            self._finish(req, "failed", error=why)

    def _reserve_rows(self, rows: np.ndarray, ahead: int) -> np.ndarray:
        """Reserve ``ahead`` positions past each row's frontier before a
        batch step. Rows the pool cannot back are preempted (their freed
        blocks may rescue later rows in the same sweep); returns the
        surviving row mask."""
        rows = rows.copy()
        for slot in np.nonzero(rows)[0]:
            try:
                self._ensure_blocks(int(slot), int(self._pos[slot]) + ahead)
            except OutOfBlocksError as e:
                rows[slot] = False
                self._preempt_row(int(slot), f"kv block pool exhausted: {e}")
        return rows

    # ----- device steps -------------------------------------------------
    def _decode_rows(self, ints: torch.Tensor, floats: torch.Tensor) -> torch.Tensor:
        """The plain [B, 1] step, uncaptured: forward on the carry (rows
        where ``active`` is 0 kept unchanged), per-row sampling, freeze.
        ``ints`` [6, slots] int64 holds the last tokens, the active mask,
        seeds, steps, the greedy mask and top-k; ``floats`` [2, slots] the
        temperatures and top-p. Returns the sampled tokens, 0 on inactive
        rows. On the card :meth:`_plain_step` replays it from a graph."""
        tokens, active, seeds, steps, gmask, ks = ints.unbind(0)
        temps, ps = floats.unbind(0)
        active = active.bool()
        logits = self.session.step(self._carry, tokens, active)
        toks = sample_tokens(logits, seeds, steps, gmask.bool(), temps, ks, ps)
        return torch.where(active, toks, torch.zeros_like(toks))

    def _step_inputs(self, rows: np.ndarray):
        ints = np.stack([self._last, rows, self._seeds, self._steps,
                         self._greedy, self._ks]).astype(np.int64)
        floats = np.stack([self._temps, self._ps]).astype(np.float32)
        return torch.from_numpy(ints), torch.from_numpy(floats)

    def _plain_step(self, ints: torch.Tensor, floats: torch.Tensor) -> torch.Tensor:
        """:meth:`_decode_rows` on the model's device: eagerly on the CPU;
        on the card eagerly once, then captured in a CUDA graph and
        replayed. A capture that fails raises."""
        if self._device.type != "cuda" or not self._graph_warm:
            self._graph_warm = True
            return self._decode_rows(ints.to(self._device), floats.to(self._device))
        if self._graph is None:
            self._graph = GraphedStep(self._decode_rows,
                                      [ints.to(self._device), floats.to(self._device)])
        return self._graph(ints, floats)

    def _install_row(self, slot: int, row) -> None:
        """Copy a fresh 1-row target carry into the batch carry, in place
        (the static row copy, or the paged block scatter)."""
        if self._allocator is None:
            self.session._write_row(self._carry, row, slot)
            return
        dest = np.zeros((self._block_tables.shape[1],), np.int64)
        held = int(self._nblocks[slot])
        dest[:held] = self._block_tables[slot, :held]
        # the unallocated tail is block 0: pad blocks land in trash
        dest_t = torch.from_numpy(dest).to(self._device)
        for name, st in self._carry.items():
            r = row[name]
            for key, pool in st.items():
                if key == "pos":
                    pool[slot] = r["pos"][0]
                elif key != "block_table":
                    pool[dest_t] = pack_row_blocks(r[key][0], self.block_size).to(pool.dtype)

    # ----- client side ------------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        *,
        max_tokens: Optional[int] = None,
        greedy: bool = True,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
        timeout: Optional[float] = None,
        deadline: Optional[Deadline] = None,
        request_id: Optional[str] = None,
        priority: Optional[str] = None,
        speculative_k: Optional[int] = None,
    ) -> GenerationHandle:
        """Fail-fast enqueue: raises :class:`AdmissionRejectedError` when
        the pending window is full and :class:`CircuitOpenError` while the
        decode step is known-poisoned. Returns immediately; tokens stream
        through the handle. ``priority`` names an admission priority class
        — under overload, lower classes shed first. ``speculative_k`` caps
        this request's speculation window (0 = plain decode for this
        request; None = follow the engine's adaptive k); exact acceptance
        sampling means the choice changes latency, never the output law."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_len {self.max_len} — "
                "no room to generate")
        if speculative_k is not None and int(speculative_k) < 0:
            raise ValueError("speculative_k must be >= 0")
        if deadline is None:
            deadline = Deadline.after(
                timeout if timeout is not None else self.default_timeout,
                clock=self._clock)
        mt = self.default_max_tokens if max_tokens is None else int(max_tokens)
        mt = max(1, min(mt, self.max_len - len(prompt)))
        handle = GenerationHandle(request_id or f"{self.name}-req", deadline)
        tracer = self.tracer
        ctx = current_context() if tracer.enabled else None
        req = _Request(prompt, mt, eos_id, handle, int(seed) & 0xFFFFFFFF,
                       bool(greedy), float(temperature), int(top_k),
                       float(top_p),
                       None if speculative_k is None else int(speculative_k),
                       ctx)
        with self._lock:
            if self._shutdown or self._draining:
                raise RuntimeError("DecodeEngine is shut down" if
                                   self._shutdown else
                                   "DecodeEngine is draining")
            if self._breaker.state is CircuitState.OPEN:
                self._c["circuit_rejected"].inc()
                raise CircuitOpenError(retry_after=self._breaker.retry_after())
            try:
                self._admission.admit(priority)
            except Exception:
                self._c["shed"].inc()
                raise
            self._g_inflight.inc()
            self._pending.append(req)
        self._wake.set()
        return handle

    def generate(self, prompt: Sequence[int], **kw) -> List[int]:
        """Blocking convenience: submit + wait for the full token list."""
        return self.submit(prompt, **kw).result()

    def submit_prefilled(self, handoff: dict, **kw) -> GenerationHandle:
        """Admit a request whose prefill ran on another host (the
        disaggregated-serving resume path of the JAX engine). Not ported:
        it comes with ``serving/disagg.py`` (ROADMAP A4)."""
        raise NotImplementedError(
            "submit_prefilled (the disaggregated prefill handoff, "
            "serving/disagg.py) is not ported yet (ROADMAP A4)")

    # ----- engine loop ------------------------------------------------
    def _finish(self, req: _Request, reason: str,
                error: Optional[str] = None) -> None:
        req.handle._finish(reason, error)
        outcome = reason if reason in _OUTCOMES else "completed"
        self._c[outcome].inc()
        self._admission.release()
        self._g_inflight.dec()
        if req.trace_ctx is not None and req.t_decode_start:
            rec = self.tracer.make_record(
                "engine.decode", req.trace_ctx, req.t_decode_start,
                trace_now(),
                attrs={"engine": self.name, "tokens": len(req.handle.tokens),
                       "reason": reason}, error=reason == "failed")
            self.tracer.record_spans([rec])

    def _free_slot(self) -> Optional[int]:
        for i in range(self.slots):
            if self._requests[i] is None:
                return i
        return None

    def _admit(self) -> None:
        while True:
            # AIMD admission pacing: fill at most slot_target cache slots
            # even when more are free (the controller shrinks the target
            # when per-token p95 breaches the budget)
            if int(self._active.sum()) >= self._slot_target:
                return
            slot = self._free_slot()
            with self._lock:
                if not self._pending:
                    return
                if slot is None:
                    return
                req = self._pending.popleft()
            if req.handle.cancelled:
                self._finish(req, "cancelled")
                continue
            if req.handle.deadline.expired():
                self._finish(req, "deadline")
                continue
            try:
                self._prefill_into(slot, req)
            except OutOfBlocksError as e:
                # transient when rows are mid-flight (their blocks free at
                # retire): requeue and retry next wake. Terminal when the
                # batch is idle — the prompt can never fit this pool.
                if self._active.any():
                    with self._lock:
                        self._pending.appendleft(req)
                    return
                self._finish(req, "failed", error=str(e))
            except Exception as e:  # noqa: BLE001 — fail the request, not the loop
                self._breaker.record_failure()
                self._finish(req, "failed", error=str(e))

    def _prefill_into(self, slot: int, req: _Request) -> None:
        if self._allocator is not None:
            # reserve blocks for the committed prompt BEFORE any compute:
            # OutOfBlocksError here is cheap and leaves nothing to undo
            self._ensure_blocks(slot, len(req.prompt))
        try:
            self._prefill_into_reserved(slot, req)
        except Exception:
            self._release_blocks(slot)
            raise

    def _prefill_into_reserved(self, slot: int, req: _Request) -> None:
        t0 = time.perf_counter()
        tt0 = trace_now() if req.trace_ctx is not None else 0.0
        # one prompt alone, at its own bucket, into a fresh 1-row carry
        row, last, _ = self.session.prefill([req.prompt])
        tok = sample_tokens(last, [req.seed], [0], [req.greedy], [req.temp],
                            [req.top_k], [req.top_p])
        first = int(tok[0])
        self._install_row(slot, row)
        cap = -1 if req.spec_k is None else min(req.spec_k,
                                                self.max_speculative_k)
        if self._spec is not None and cap != 0:
            # paired draft cache: same prompt, same slot — proposals must
            # condition on the same committed prefix the target verifies
            drow, _, _ = self._spec.draft.prefill([req.prompt])
            self._spec.draft._write_row(self._draft_carry, drow, slot)
        self._h_prefill.observe(time.perf_counter() - t0)
        self._breaker.record_success()
        if req.trace_ctx is not None:
            rec = self.tracer.make_record(
                "engine.prefill", req.trace_ctx, tt0, trace_now(),
                attrs={"engine": self.name, "slot": slot,
                       "prompt_len": len(req.prompt),
                       "bucket": bucket_length(len(req.prompt), self.max_len)})
            self.tracer.record_spans([rec])
            req.t_decode_start = trace_now()
        # install the slot, emit the first token
        self._requests[slot] = req
        self._active[slot] = True
        self._last[slot] = first
        self._steps[slot] = 1  # next sample is decode step 1
        self._seeds[slot] = req.seed
        self._greedy[slot] = req.greedy
        self._temps[slot] = req.temp
        self._ks[slot] = req.top_k
        self._ps[slot] = req.top_p
        self._pos[slot] = len(req.prompt)  # committed cache frontier
        self._spec_caps[slot] = cap
        self._g_active.set(int(self._active.sum()))
        self._c_tokens.inc()
        req.handle._emit(0, first)
        self._retire_if_done(slot, first, emitted=1)

    def _retire_if_done(self, slot: int, last_token: int, emitted: int) -> None:
        req = self._requests[slot]
        if req is None:
            return
        reason = None
        if req.handle.cancelled:
            reason = "cancelled"
        elif req.eos_id is not None and last_token == req.eos_id:
            reason = "completed"
        elif emitted >= req.max_tokens:
            reason = "completed"
        elif len(req.prompt) + emitted >= self.max_len:
            reason = "completed"
        elif req.handle.deadline.expired():
            reason = "deadline"
        if reason is not None:
            self._requests[slot] = None
            self._active[slot] = False
            self._release_blocks(slot)
            self._g_active.set(int(self._active.sum()))
            self._finish(req, reason)

    def _fail_active(self, e: Exception) -> None:
        """Poisoned device step: fail every active request, open-circuit
        accounting, clear the batch."""
        self._breaker.record_failure()
        for slot in range(self.slots):
            req = self._requests[slot]
            if req is not None:
                self._requests[slot] = None
                self._active[slot] = False
                self._release_blocks(slot)
                self._finish(req, "failed", error=f"{type(e).__name__}: {e}")
        self._g_active.set(0)

    def _step(self, rows: Optional[np.ndarray] = None) -> None:
        """One plain [B, 1] decode step over ``rows`` (default: every
        active slot — the non-speculative path, and the boundary fallback
        for rows whose remaining cache room cannot hold a k+1 window)."""
        rows = self._active if rows is None else rows
        if self._allocator is not None:
            rows = self._reserve_rows(rows, 1)
            if not rows.any():
                return
        t0 = time.perf_counter()
        try:
            toks_h = self._plain_step(*self._step_inputs(rows)).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — poisoned step: fail active requests
            self._fail_active(e)
            return
        dt = time.perf_counter() - t0
        self._h_decode.observe(dt)
        self._breaker.record_success()
        for slot in np.nonzero(rows)[0]:
            req = self._requests[slot]
            tok = int(toks_h[slot])
            emitted = len(req.handle.tokens)
            req.handle._emit(emitted, tok)
            self._last[slot] = tok
            self._steps[slot] += 1
            self._pos[slot] += 1
            self._c_tokens.inc()
            self._h_token.observe(dt)
            self._retire_if_done(slot, tok, emitted + 1)
        if self._step_hook is not None:
            self._step_hook()

    def _spec_step(self) -> None:
        """One speculative engine turn: propose/verify/accept for every
        row with cache room for the full k+1 window, then a plain [B, 1]
        step for the remainder (rows near ``max_len``, and requests with
        ``speculative_k=0``). Both caches are rewound to the committed
        frontier inside :meth:`SpeculativeGenerationSession.step`, so a
        cancelled or expired request never leaves speculative writes
        behind when its slot is reused."""
        k = max(1, self._spec_k)
        caps = np.where(self._spec_caps < 0, k,
                        np.minimum(self._spec_caps, k)).astype(np.int32)
        spec_rows = (self._active & (caps > 0)
                     & (self._pos + k + 1 <= self.max_len))
        if self._allocator is not None and spec_rows.any():
            # a speculative window may write up to k+1 positions past the
            # frontier; rows that can't reserve that many blocks degrade
            # to the plain path (which reserves just 1, preempting only
            # when even that fails)
            spec_rows = spec_rows.copy()
            for slot in np.nonzero(spec_rows)[0]:
                try:
                    self._ensure_blocks(slot, int(self._pos[slot]) + k + 1)
                except OutOfBlocksError:
                    spec_rows[slot] = False
        plain_rows = self._active & ~spec_rows
        if spec_rows.any():
            t0 = time.perf_counter()
            try:
                _, _, toks, n_acc, n_emit = self._spec.step(
                    self._carry, self._draft_carry, self._last, self._steps,
                    spec_rows, self._seeds, self._greedy, self._temps,
                    self._ks, self._ps, np.where(spec_rows, caps, 0), k=k)
                toks_h = toks.cpu().numpy()
                acc_h = n_acc.cpu().numpy()
                ne_h = n_emit.cpu().numpy()
            except Exception as e:  # noqa: BLE001
                self._fail_active(e)
                return
            dt = time.perf_counter() - t0
            self._h_decode.observe(dt)
            self._breaker.record_success()
            self._c_spec_steps.inc()
            for slot in np.nonzero(spec_rows)[0]:
                req = self._requests[slot]
                if req is None:
                    continue
                self._c_spec_proposed.inc(int(caps[slot]))
                self._c_spec_accepted.inc(int(acc_h[slot]))
                committed = 0
                for j in range(int(ne_h[slot])):
                    tok = int(toks_h[slot, j])
                    emitted = len(req.handle.tokens)
                    req.handle._emit(emitted, tok)
                    self._last[slot] = tok
                    self._steps[slot] += 1
                    self._pos[slot] += 1
                    self._c_tokens.inc()
                    committed += 1
                    self._retire_if_done(slot, tok, emitted + 1)
                    if self._requests[slot] is None:
                        break  # retired mid-window: drop the tail
                self._h_token.observe(dt / max(1, committed))
            if self._step_hook is not None:
                self._step_hook()
        if plain_rows.any():
            self._step(plain_rows)

    def _sweep_pending(self) -> None:
        """Fail pending requests that died in the queue (cancel/expiry)
        WITHOUT waiting for a cache slot: a burst of doomed requests must
        release its admission window even while every slot is busy."""
        with self._lock:
            dead = [r for r in self._pending
                    if r.handle.cancelled or r.handle.deadline.expired()]
            for r in dead:
                self._pending.remove(r)
        for r in dead:
            self._finish(r, "cancelled" if r.handle.cancelled else "deadline")

    def _loop(self) -> None:
        with torch.no_grad():
            while True:
                if not self._active.any():
                    with self._lock:
                        has_pending = bool(self._pending)
                    if not has_pending:
                        if self._shutdown:
                            return
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                        continue
                self._admit()
                if self._active.any():
                    if self._spec is not None:
                        self._spec_step()
                    else:
                        self._step()
                # also sweep cancelled requests on slots that produced nothing
                for slot in range(self.slots):
                    req = self._requests[slot]
                    if req is not None and (req.handle.cancelled or
                                            req.handle.deadline.expired()):
                        self._retire_if_done(slot, -1, len(req.handle.tokens))
                self._sweep_pending()
                if (self._adaptive and self._adjust_interval > 0
                        and self._clock() >= self._next_adjust):
                    self.adjust()
                    self._next_adjust = self._clock() + self._adjust_interval

    # ----- decode-side AIMD control -----------------------------------
    @property
    def speculative_k(self) -> int:
        """Current speculation depth (0 when no draft model)."""
        return self._spec_k if self._spec is not None else 0

    @property
    def slot_target(self) -> int:
        return self._slot_target

    def set_decode_control(self, speculative_k: Optional[int] = None,
                           slot_target: Optional[int] = None):
        """Write the AIMD-controlled knobs (clamped: ``k`` to
        ``[1, max_speculative_k]`` when a draft is attached, the slot
        target to ``[1, slots]``). Returns the effective pair."""
        if speculative_k is not None and self._spec is not None:
            self._spec_k = max(1, min(int(speculative_k),
                                      self.max_speculative_k))
            self._g_spec_k.set(self._spec_k)
        if slot_target is not None:
            self._slot_target = max(1, min(int(slot_target), self.slots))
            self._g_slot_target.set(self._slot_target)
        return self.speculative_k, self._slot_target

    def adjust(self) -> Optional[dict]:
        """Tick the AIMD controller once (the engine loop does this every
        ``adjust_interval`` seconds when ``adaptive=True``); returns the
        observation/action, or None when no tokens were emitted since the
        last tick."""
        return self.aimd.tick()

    def token_p95(self) -> Optional[float]:
        """Lifetime per-token p95 from the latency histogram (bucket upper
        bound; None before any traffic)."""
        count = self._h_token.count
        if count <= 0:
            return None
        threshold = 0.95 * count
        for le, c in self._h_token.buckets():
            if c >= threshold:
                return le
        return float("inf")

    # ----- lifecycle / introspection ----------------------------------
    def bucket_sizes(self) -> List[int]:
        return self.session.bucket_sizes()

    @property
    def circuit_state(self) -> CircuitState:
        return self._breaker.state

    def load_score(self) -> float:
        """Dispatch load score for a replica pool: admitted-but-unfinished
        sequences plus the fraction of cache slots busy (a replica with
        free slots is cheaper than one continuously batching at
        capacity)."""
        return (float(self._admission.pending)
                + float(self._active.sum()) / max(1, self.slots))

    def stats(self) -> dict:
        counts = {k: int(c.value) for k, c in self._c.items()}
        proposed = int(self._c_spec_proposed.value)
        accepted = int(self._c_spec_accepted.value)
        spec_steps = int(self._c_spec_steps.value)
        counts.update({
            "in_flight": self._admission.pending,
            # the engine-list aggregation key health()/pools sum over
            "queue_depth": self._admission.pending,
            "active_slots": int(self._active.sum()),
            "slots": self.slots,
            "slot_target": self._slot_target,
            "tokens": int(self._c_tokens.value),
            "max_len": self.max_len,
            "cache_dtype": self.cache_dtype or str(self.session.model.dtype).replace("torch.", ""),
            "kv_cache_bytes": self._kv_cache_bytes,
            "kv_block_size": self.block_size,
            "kv_blocks_total": (None if self._allocator is None
                                else self._allocator.total_blocks),
            "kv_blocks_free": (None if self._allocator is None
                               else self._allocator.free_blocks),
            "circuit_state": self._breaker.state.value,
            "draining": self._draining,
            # derived ratios are None, not 0.0, before any traffic
            "per_token_p95_s": self.token_p95(),
            "speculative": {
                "enabled": self._spec is not None,
                "current_k": self.speculative_k,
                "max_k": self.max_speculative_k,
                "steps": spec_steps,
                "proposed": proposed,
                "accepted": accepted,
                "acceptance_rate": (accepted / proposed) if proposed
                else None,
                "accepted_tokens_per_step":
                    ((accepted + spec_steps) / spec_steps) if spec_steps
                    else None,
            },
        })
        return counts

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, wait for in-flight generations to finish."""
        with self._lock:
            self._draining = True
        end = None if timeout is None else time.monotonic() + timeout
        while self._admission.pending > 0:
            if end is not None and time.monotonic() > end:
                return False
            time.sleep(0.01)
        return True

    def shutdown(self, *, drain: bool = True,
                 drain_timeout: Optional[float] = 30.0) -> None:
        if drain and not self._shutdown:
            self.drain(timeout=drain_timeout)
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            pending = list(self._pending)
            self._pending.clear()
        for req in pending:
            self._finish(req, "cancelled")
        for slot in range(self.slots):
            req = self._requests[slot]
            if req is not None:
                req.handle.cancel()
        self._wake.set()
        self._thread.join(timeout=10)
        # the graph replays into the carry: drop it with the engine
        self._graph = None


class DecodeAIMD:
    """AIMD controller for the decode engine's latency/throughput knobs —
    the decode-side mirror of :class:`~deeplearning4j_tpu.parallel.pool.
    AdaptiveBatcher`.

    Each :meth:`tick` estimates the per-token p95 from the delta of the
    engine's token-latency histogram since the previous tick, then:

    * **p95 over target** → multiplicative decrease: the active-slot
      target AND the speculation depth both shrink by ``shrink_factor``
      (fewer sequences sharing the step, shallower windows — per-token
      latency is the hard constraint, back off fast).
    * **p95 under target, pending queue non-empty and slots headroom** →
      additive increase of the slot target (demand exists; batch wider).
    * **p95 under target otherwise** → additive increase of the
      speculation depth toward ``max_speculative_k`` (spend the latency
      headroom on deeper windows: more accepted tokens per fixed-cost
      target forward).

    No tokens since the last tick leaves everything untouched. Writes go
    through :meth:`DecodeEngine.set_decode_control` (clamped there)."""

    def __init__(self, engine: DecodeEngine, *, target_p95_s: float = 0.05,
                 grow_step: int = 1, shrink_factor: float = 0.5,
                 min_k: int = 1, min_slots: int = 1) -> None:
        if not 0.0 < shrink_factor < 1.0:
            raise ValueError("shrink_factor must be in (0, 1)")
        self.engine = engine
        self.target_p95_s = float(target_p95_s)
        self.grow_step = int(grow_step)
        self.shrink_factor = float(shrink_factor)
        self.min_k = int(min_k)
        self.min_slots = int(min_slots)
        self._last_buckets = [c for _, c in engine._h_token.buckets()]
        self._last_count = engine._h_token.count

    def _p95_delta(self) -> Optional[float]:
        hist = self.engine._h_token
        pairs = hist.buckets()  # cumulative (le, count)
        count = hist.count
        cums = [c for _, c in pairs]
        deltas = [c - p for c, p in zip(cums, self._last_buckets)]
        dcount = count - self._last_count
        self._last_buckets = cums
        self._last_count = count
        if dcount <= 0:
            return None
        threshold = 0.95 * dcount
        for (le, _), d in zip(pairs, deltas):
            if d >= threshold:
                return le if le != float("inf") else float("inf")
        return float("inf")

    def tick(self) -> Optional[dict]:
        """One control step; returns the observation/action taken, or
        None when no tokens were emitted since the last tick."""
        p95 = self._p95_delta()
        if p95 is None:
            return None
        eng = self.engine
        k, st = eng.speculative_k, eng.slot_target
        queue_depth = max(0, eng._admission.pending
                          - int(eng._active.sum()))
        if p95 > self.target_p95_s:
            new_k = max(self.min_k, int(k * self.shrink_factor)) if k else 0
            new_st = max(self.min_slots, int(st * self.shrink_factor))
            action = "shrink"
        elif queue_depth > 0 and st < eng.slots:
            new_k, new_st = k, st + self.grow_step
            action = "grow_slots"
        elif k and k < eng.max_speculative_k:
            new_k, new_st = k + self.grow_step, st
            action = "grow_k"
        else:
            new_k, new_st = k, st
            action = "hold"
        new_k, new_st = eng.set_decode_control(
            new_k if new_k else None, new_st)
        return {"p95_s": p95, "queue_depth": queue_depth, "action": action,
                "speculative_k": new_k, "slot_target": new_st}
