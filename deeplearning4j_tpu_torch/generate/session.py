"""GenerationSession — KV-cached autoregressive decode over a
MultiLayerNetwork, and its speculative counterpart (port of
``deeplearning4j_tpu/generate/session.py``).

* **carry** — one preallocated dict ``{layer: layer.decode_state(B,
  max_len, dtype, device)}``: static-shape KV caches ``[B, H, max_len, d]``
  (int8 with float32 scale planes for ``cache_dtype="int8"``) with per-row
  position counters. Threaded through ``forward_pure``'s ``rnn_state``
  channel, so decode runs the same model code as ``output``. Every step
  updates the carry in place (caches and positions): the dict a step
  returns is the one it was given.
* **prefill** — the prompts run once, right-padded to a power-of-two
  bucket, with a validity mask; every position's K/V goes into the cache
  and the first token comes from each row's last valid position.
* **decode** — each next token is a ``[B, 1]`` forward against the cache
  (an in-place cache write + the single-query decode kernel). On the card
  the step is captured once per carry in a CUDA graph and replayed: the
  first step on a carry runs eagerly, the second captures, later ones
  replay (``ops/cuda_graph.py``). On the CPU every step runs eagerly.
* **speculative** — :class:`SpeculativeGenerationSession` proposes with a
  draft model, verifies with one ``tq=k+1`` target forward and commits
  through exact acceptance sampling; both caches rewind to the committed
  frontier. Its step runs eagerly.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.activations import Activation
from ..nn.layers.output import BaseOutputLayer
from ..ops.cuda_graph import GraphedStep
from ..ops.flash_attention import attention_impl
from .paged import freeze_rows, redirect_inactive_writes
from .sampling import sample_tokens, speculative_accept


def bucket_length(n: int, limit: int) -> int:
    """Smallest power-of-two >= n, capped at ``limit``."""
    b = 1
    while b < n and b < limit:
        b <<= 1
    return min(b, limit)


CACHE_DTYPES = (None, "int8")


def quantize_decode_state(st):
    """Convert one layer's decode carry to the int8 KV-cache layout:
    ``cache_k``/``cache_v`` become int8 with per-slot/per-head float32 scale
    planes ``cache_k_scale``/``cache_v_scale`` ([b, h, L]); everything else
    keeps its dtype. The attention layers' ``_cached_attention`` detects the
    scale keys and runs the quantize-on-write / dequant-on-attend path."""
    if "cache_k" not in st or "cache_v" not in st:
        return st
    out = dict(st)
    for key in ("cache_k", "cache_v"):
        c = st[key]
        out[key] = torch.zeros(c.shape, dtype=torch.int8, device=c.device)
        out[key + "_scale"] = torch.zeros(c.shape[:-1], dtype=torch.float32, device=c.device)
    return out


def _leaves(carry) -> List[torch.Tensor]:
    return [carry[name][key] for name in sorted(carry) for key in sorted(carry[name])]


def carry_bytes(carry) -> int:
    """Resident bytes of a decode carry's tensors."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(carry)))


class _CarryGraph:
    """The decode graph of one carry: the carry's tensors (held weakly, so
    a dropped carry is freed), the attention seam it runs (a graph replays
    the path it captured) and, from the second step on, the graph."""

    def __init__(self, carry) -> None:
        self._refs = [weakref.ref(t) for t in _leaves(carry)]
        self._impl = attention_impl()
        self.step: Optional[GraphedStep] = None

    def owns(self, carry) -> bool:
        leaves = _leaves(carry)
        return (self._impl == attention_impl() and len(leaves) == len(self._refs)
                and all(r() is t for r, t in zip(self._refs, leaves)))


class GenerationSession:
    def __init__(self, model, *, max_len: int = 256,
                 cache_dtype: Optional[str] = None) -> None:
        model._check_init()
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(
                f"cache_dtype must be one of {CACHE_DTYPES}, got {cache_dtype!r}")
        #: "int8" stores attention K/V caches quantized (per-slot/per-head
        #: absmax scales on the carry); None keeps the model dtype (exact)
        self.cache_dtype = cache_dtype
        self.model = model
        self.max_len = int(max_len)
        last = model.layers[-1]
        if not isinstance(last, BaseOutputLayer):
            raise ValueError("generation needs an output layer last")
        self.vocab_size = int(last.n_out)
        act = last.activation or Activation.SOFTMAX
        self._out_is_probs = act == Activation.SOFTMAX
        self._layer_names = model.layer_names()
        #: decode graphs by batch size, each bound to the carry it captured
        self._graphs: Dict[int, _CarryGraph] = {}
        # at least one layer must expose decode state, otherwise "decode"
        # would silently re-run from scratch each step
        if not any(l.decode_state(1, 1, model.dtype, torch.device("cpu"))
                   for l in model.layers):
            raise ValueError(
                "no layer exposes decode_state — model cannot be decoded "
                "incrementally (attention layers need causal=True)")

    # ----- carry ------------------------------------------------------
    def decode_state(self, batch: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Fresh per-sequence decode carry for ``batch`` rows (attention
        K/V caches quantized when ``cache_dtype="int8"``)."""
        out = {}
        for name, layer in zip(self._layer_names, self.model.layers):
            st = layer.decode_state(batch, self.max_len, self.model.dtype,
                                    self.model.device)
            if st:
                if self.cache_dtype == "int8":
                    st = quantize_decode_state(st)
                out[name] = st
        return out

    def cache_bytes(self, batch: int = 1) -> int:
        """Resident bytes of the decode carry for ``batch`` rows — the
        per-sequence device-memory cost capacity planning divides the cache
        budget by (and the ``dl4j_tpu_generate_kv_cache_bytes`` gauge)."""
        return carry_bytes(self.decode_state(batch))

    def bucket_sizes(self, limit: Optional[int] = None) -> List[int]:
        """Prompt-length buckets (powers of two up to ``limit``, default
        ``max_len``)."""
        limit = self.max_len if limit is None else min(limit, self.max_len)
        sizes: List[int] = []
        b = 1
        while b < limit:
            sizes.append(b)
            b <<= 1
        sizes.append(limit)
        return sizes

    # ----- model plumbing ---------------------------------------------
    def _prep(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [b, t] -> model input: kept as int ids for embedding-first
        models, one-hot [b, V, t] otherwise (the char-RNN convention)."""
        ids = ids.to(device=self.model.device, dtype=torch.int32)
        if self.model.keeps_int_input():
            return ids
        oh = F.one_hot(ids.long(), self.vocab_size).to(self.model.dtype)
        return oh.transpose(1, 2)

    def _logits(self, out: torch.Tensor) -> torch.Tensor:
        """Model output [b, V, t] -> per-position logits [b, V, t] (log of
        probs for softmax outputs)."""
        if self._out_is_probs:
            return torch.log(torch.clamp_min(out, 1e-30))
        return out

    def _forward(self, carry, x, mask):
        out, _, new_rnn = self.model.forward_pure(
            self.model.params, self.model.state, x, train=False, rng=None,
            mask=mask, rnn_state=carry)
        return new_rnn, self._logits(out)

    def _write_row(self, carry, row, i: int) -> None:
        """Copy a 1-row carry (a fresh prefill) into slot ``i`` of a B-row
        carry, in place — the continuous-batching slot install."""
        for name, st in carry.items():
            for key, c in st.items():
                c[i].copy_(row[name][key][0])

    # ----- host API ----------------------------------------------------
    def prefill(self, prompts: Sequence[Sequence[int]], *, batch: Optional[int] = None):
        """Run the (ragged) prompts through the model once, building the
        decode carry. Returns ``(carry, logits [b, V], lengths [b])`` with
        prompts right-padded to the shared bucket length; ``batch`` rows
        past the prompts get length 1."""
        lengths = np.asarray([len(p) for p in prompts], np.int32)
        if lengths.min() < 1:
            raise ValueError("empty prompt")
        b = len(prompts) if batch is None else batch
        tb = bucket_length(int(lengths.max()), self.max_len)
        ids = np.zeros((b, tb), np.int32)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = np.asarray(p, np.int32)
        lens = np.ones((b,), np.int32)
        lens[: len(prompts)] = lengths
        dev = self.model.device
        with torch.no_grad():
            lens_t = torch.from_numpy(lens).to(dev)
            mask = (torch.arange(tb, device=dev)[None, :] < lens_t[:, None]).to(self.model.dtype)
            carry, logits = self._forward(self.decode_state(b),
                                          self._prep(torch.from_numpy(ids)), mask)
            idx = (lens_t.long() - 1)[:, None, None].expand(b, logits.shape[1], 1)
            last = torch.gather(logits, 2, idx)[:, :, 0]  # [b, V]
        return carry, last, lens

    def step(self, carry, tokens: torch.Tensor, active: Optional[torch.Tensor] = None):
        """One ``[b, 1]`` decode step on ``carry``, in place and uncaptured:
        ``tokens [b]`` on the model's device -> logits [b, V]. Rows where
        ``active`` [b] is False keep their carry unchanged. This is the
        function :meth:`decode` captures on the card."""
        fwd = carry if active is None else redirect_inactive_writes(carry, active)
        out, _, new = self.model.forward_pure(
            self.model.params, self.model.state, self._prep(tokens[:, None]),
            train=False, rng=None, mask=None, rnn_state=fwd)
        freeze_rows(new, carry, active)
        return self._logits(out)[:, :, 0]

    def decode(self, carry, tokens):
        """One incremental step: ``tokens [b]`` -> (carry, logits [b, V]);
        the carry is updated in place. On the card the step replays a CUDA
        graph bound to this carry (captured at its second step; a new carry
        replaces the graph of the old one)."""
        with torch.no_grad():
            toks = torch.as_tensor(tokens).to(device=self.model.device, dtype=torch.int32)
            if toks.device.type != "cuda":
                return carry, self.step(carry, toks)
            b = toks.shape[0]
            entry = self._graphs.get(b)
            if entry is None or not entry.owns(carry):
                self._graphs[b] = _CarryGraph(carry)  # releases the old graph
                return carry, self.step(carry, toks)
            if entry.step is None:
                entry.step = GraphedStep(lambda t: self.step(carry, t), [toks])
            return carry, entry.step(toks).clone()

    def release_graphs(self, carry=None) -> None:
        """Drop the decode graphs (of ``carry`` only, when given), freeing
        their memory pools."""
        for b in [b for b, g in self._graphs.items() if carry is None or g.owns(carry)]:
            del self._graphs[b]

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_tokens: int,
        *,
        greedy: bool = True,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
    ) -> List[List[int]]:
        """Batch generation. Stops a row at ``eos_id`` or ``max_tokens``,
        never past ``max_len``. Row ``i`` samples with seed ``seed + i``."""
        b = len(prompts)
        carry, logits, lens = self.prefill(prompts)
        dev = logits.device
        seeds = torch.from_numpy((np.full((b,), seed, np.int64) + np.arange(b)) & 0xFFFFFFFF).to(dev)
        gmask = torch.full((b,), bool(greedy), device=dev)
        temps = torch.full((b,), float(temperature), device=dev)
        ks = torch.full((b,), int(top_k), device=dev)
        ps = torch.full((b,), float(top_p), device=dev)
        out: List[List[int]] = [[] for _ in range(b)]
        done = [False] * b
        pos = lens.copy()
        tokens = None
        try:
            for step in range(max_tokens):
                if tokens is not None:
                    carry, logits = self.decode(carry, tokens)
                toks = sample_tokens(logits, seeds, torch.full((b,), step, device=dev),
                                     gmask, temps, ks, ps)
                toks_h = toks.cpu().numpy()
                for i in range(b):
                    if done[i]:
                        continue
                    t = int(toks_h[i])
                    out[i].append(t)
                    pos[i] += 1
                    if (eos_id is not None and t == eos_id) or pos[i] >= self.max_len:
                        done[i] = True
                if all(done):
                    break
                tokens = toks
        finally:
            self.release_graphs(carry)
        return out


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

_REWINDABLE_KEYS = frozenset({"cache_k", "cache_v", "pos",
                              "cache_k_scale", "cache_v_scale",
                              "block_table"})


def _check_rewindable(session: GenerationSession, role: str) -> None:
    """Speculative decode writes ``k+1`` positions ahead and must be able
    to roll the uncommitted suffix back after a rejection. That is only
    possible when every decode-state leaf is position-indexed (K/V caches
    masked by a ``pos`` counter): a recurrent ``h``/``c`` carry has no
    position to rewind, so those models are rejected up front."""
    for name, st in session.decode_state(1).items():
        keys = set(st.keys())
        if "pos" not in keys or not keys <= _REWINDABLE_KEYS:
            raise ValueError(
                f"speculative decoding requires position-indexed decode "
                f"caches; {role} layer {name!r} carries state "
                f"{sorted(keys)}, which cannot be rewound past a rejected "
                "draft (recurrent h/c carries have no position counter)")


def rewind_carry(carry, delta: torch.Tensor):
    """Roll a decode carry back ``delta`` [b] positions per row, in place.
    Stale K/V entries past the committed frontier stay in the cache but are
    masked by ``pos`` (decode attention reads ``[0, pos]`` only) and are
    overwritten by the next forward — rewind is a per-row position
    subtraction, not a data copy. Returns ``carry``."""
    for st in carry.values():
        pos = st["pos"]
        pos.copy_(torch.clamp_min(pos - delta.to(pos.dtype), 0))
    return carry


class SpeculativeGenerationSession:
    """Draft-model speculative decoding over a paired target+draft cache.

    Each speculative step runs the cheap draft model ``k+1`` times at
    ``[B, 1]`` (proposing ``k`` tokens and keeping its own cache aligned
    through the window), scores the proposals with ONE target forward at
    ``[B, k+1]`` — the tq>1 causal pass through the same cached-attention
    path prefill uses, writing into the target's KV cache — and commits
    tokens through :func:`~deeplearning4j_tpu_torch.generate.sampling.
    speculative_accept` (exact accept-or-resample: the output law is the
    target's; greedy streams are token-identical to plain decode). Both
    caches then REWIND to the committed frontier, so a rejected burst never
    leaks speculative state into the next step."""

    def __init__(self, model, draft_model, *, max_len: int = 256,
                 k: int = 4, cache_dtype: Optional[str] = None) -> None:
        if k < 1:
            raise ValueError("speculative k must be >= 1")
        # cache_dtype applies to BOTH caches: the rewind contract holds
        # for int8 caches too (scales are position-indexed, masked by pos)
        self.target = GenerationSession(model, max_len=max_len,
                                        cache_dtype=cache_dtype)
        self.draft = GenerationSession(draft_model, max_len=max_len,
                                       cache_dtype=cache_dtype)
        if self.draft.vocab_size != self.target.vocab_size:
            raise ValueError(
                f"draft vocab {self.draft.vocab_size} != target vocab "
                f"{self.target.vocab_size} — the acceptance ratio needs "
                "one shared token space")
        _check_rewindable(self.target, "target")
        _check_rewindable(self.draft, "draft")
        self.k = int(k)
        self.max_len = int(max_len)
        self.last_stats: Optional[dict] = None

    # ----- one batched speculative step --------------------------------
    def step(self, target_carry, draft_carry, last, steps, active, seeds,
             gmask, temps, ks, ps, spec_ks, *, k: Optional[int] = None):
        """Propose / verify / accept / rewind for one batch step.

        ``last`` [B] is each row's most recent committed token (not yet
        fed), ``steps`` [B] the decode-step index its NEXT token samples
        at, ``spec_ks`` [B] the per-row acceptance window (<= ``k``; 0
        degenerates to a plain decode step for that row). Rows where
        ``active`` is False are frozen. Returns ``(target_carry,
        draft_carry, tokens [B, k+1], n_accepted [B], n_emitted [B])`` —
        the caller commits ``tokens[i, :n_emitted[i]]`` per row; both
        carries (updated in place) are already rewound to the committed
        frontier."""
        kk = self.k if k is None else int(k)
        dsess, tsess = self.draft, self.target
        dev = tsess.model.device
        with torch.no_grad():
            last = torch.as_tensor(np.asarray(last), device=dev).to(torch.int32)
            steps = torch.as_tensor(np.asarray(steps), device=dev).long()
            active = torch.as_tensor(np.asarray(active, bool), device=dev)
            # inactive rows' writes change nothing of theirs (trash block
            # for paged layers, write-back for static caches)
            tfwd = redirect_inactive_writes(target_carry, active)
            cur, feed = redirect_inactive_writes(draft_carry, active), last
            # ---- propose: k draft tokens, draft cache kept aligned
            toks, logits_list = [], []
            for i in range(kk + 1):
                out, _, cur = dsess.model.forward_pure(
                    dsess.model.params, dsess.model.state, dsess._prep(feed[:, None]),
                    train=False, rng=None, mask=None, rnn_state=cur)
                if i < kk:
                    logits_i = dsess._logits(out)[:, :, 0]
                    feed = sample_tokens(logits_i, seeds, steps + i, gmask, temps, ks, ps)
                    toks.append(feed)
                    logits_list.append(logits_i)
            d_toks = torch.stack(toks, dim=1)
            d_logits = torch.stack(logits_list, dim=1)
            # ---- verify: ONE tq=k+1 target forward through the cached
            # attention path (the multi-token "prefill" shape)
            tokens_in = torch.cat([last[:, None], d_toks], dim=1)
            out, _, tnew = tsess.model.forward_pure(
                tsess.model.params, tsess.model.state, tsess._prep(tokens_in),
                train=False, rng=None, mask=None, rnn_state=tfwd)
            t_logits = tsess._logits(out).transpose(1, 2)  # [b, t, V]
            # ---- accept (exact), freeze idle rows, rewind both
            otoks, n_acc, n_emit = speculative_accept(
                d_toks, d_logits, t_logits, seeds, steps,
                torch.as_tensor(np.asarray(spec_ks), device=dev), gmask, temps, ks, ps)
            freeze_rows(tnew, target_carry, active)
            freeze_rows(cur, draft_carry, active)
            delta = torch.where(active, (kk + 1) - n_emit, torch.zeros_like(n_emit))
            rewind_carry(target_carry, delta)
            rewind_carry(draft_carry, delta)
        return target_carry, draft_carry, otoks, n_acc, n_emit

    # ----- host API ----------------------------------------------------
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_tokens: int,
        *,
        greedy: bool = True,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
        k: Optional[int] = None,
    ) -> List[List[int]]:
        """Batch speculative generation with the same semantics (and, for
        greedy, the same token streams) as :meth:`GenerationSession.
        generate`. Near the cache limit, where a full ``k+1`` window no
        longer fits, the batch falls back to plain [B, 1] decode steps so
        no write ever lands past ``max_len``. Records acceptance counters
        in :attr:`last_stats`."""
        b = len(prompts)
        kk = self.k if k is None else int(k)
        tcarry, logits, lens = self.target.prefill(prompts)
        dcarry, _, _ = self.draft.prefill(prompts)
        dev = logits.device
        seeds = torch.from_numpy((np.full((b,), seed, np.int64) + np.arange(b)) & 0xFFFFFFFF).to(dev)
        gmask = torch.full((b,), bool(greedy), device=dev)
        temps = torch.full((b,), float(temperature), device=dev)
        ks = torch.full((b,), int(top_k), device=dev)
        ps = torch.full((b,), float(top_p), device=dev)
        out: List[List[int]] = [[] for _ in range(b)]
        done = [False] * b
        comm = lens.copy().astype(np.int64)  # committed length per row
        first = sample_tokens(logits, seeds, torch.zeros((b,), dtype=torch.int64, device=dev),
                              gmask, temps, ks, ps)
        last = first.cpu().numpy().astype(np.int32)
        for i in range(b):
            out[i].append(int(last[i]))
            comm[i] += 1
            if ((eos_id is not None and int(last[i]) == eos_id)
                    or comm[i] >= self.max_len or max_tokens <= 1):
                done[i] = True
        steps_h = np.ones((b,), np.int64)
        spec_steps = proposed = accepted = 0

        def commit(i, t):
            out[i].append(t)
            comm[i] += 1
            steps_h[i] += 1
            last[i] = t
            if ((eos_id is not None and t == eos_id) or len(out[i]) >= max_tokens
                    or comm[i] >= self.max_len):
                done[i] = True

        try:
            while not all(done):
                active_rows = [i for i in range(b) if not done[i]]
                k_step = min(kk, min(self.max_len - int(comm[i]) for i in active_rows))
                active = np.asarray([not d for d in done])
                if k_step >= 1:
                    spec_ks_h = np.where(active, k_step, 0)
                    tcarry, dcarry, toks, n_acc, n_emit = self.step(
                        tcarry, dcarry, last, steps_h, active, seeds, gmask,
                        temps, ks, ps, spec_ks_h, k=k_step)
                    toks_h = toks.cpu().numpy()
                    acc_h, ne_h = n_acc.cpu().numpy(), n_emit.cpu().numpy()
                    spec_steps += 1
                    for i in active_rows:
                        proposed += int(spec_ks_h[i])
                        accepted += int(acc_h[i])
                        for j in range(int(ne_h[i])):
                            commit(i, int(toks_h[i, j]))
                            if done[i]:
                                break
                else:
                    # boundary fallback: plain decode (no speculative write
                    # may straddle max_len)
                    tcarry, step_logits = self.target.decode(tcarry, last)
                    toks = sample_tokens(step_logits, seeds, torch.from_numpy(steps_h).to(dev),
                                         gmask, temps, ks, ps)
                    toks_h = toks.cpu().numpy()
                    for i in active_rows:
                        commit(i, int(toks_h[i]))
        finally:
            self.target.release_graphs(tcarry)
        self.last_stats = {
            "spec_steps": spec_steps,
            "proposed": proposed,
            "accepted": accepted,
            "acceptance_rate": (accepted / proposed) if proposed else None,
            "accepted_per_step": ((accepted + spec_steps) / spec_steps)
            if spec_steps else None,
        }
        return out
