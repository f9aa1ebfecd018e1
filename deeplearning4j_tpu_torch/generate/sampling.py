"""Seeded token sampling for autoregressive decode, drawn on the logits'
device (port of ``deeplearning4j_tpu/generate/sampling.py``).

All functions work on the LAST axis of a logits tensor. Log-probabilities
work everywhere plain logits do: for a softmax-output model ``log(p)``
differs from the logits by a per-row constant, which temperature scaling,
top-k/top-p truncation and sampling are all invariant to.

Greedy selection and the warped logits (:func:`_warp`) are exactly the JAX
package's. The random draws are not: JAX keys each row by
``fold_in(PRNGKey(seed), step)`` (threefry). Here a draw is a Gumbel-max
over the warped logits whose noise comes from a counter-based hash of
``(seed, step, tag, vocab index)``, computed with int64 tensor ops on the
logits' device. Every product in the hash stays below 2^63 (32-bit values
times constants below 2^31), so the CPU and CUDA give the same bits, and a
stream pinned by a CPU test is the stream the card draws, up to the
rounding of the logits and of ``log``. A request's stream depends only on
its seed and position, never on which other requests share its batch, and
nothing is read back to the host, so a step that samples can be captured
in a CUDA graph.

Tie semantics (as in the JAX package): ``top_k`` keeps every token tied with
the k-th largest logit; ``top_p`` keeps the smallest prefix of the sorted
distribution whose cumulative mass reaches ``p``, including the token that
crosses the threshold, plus any tokens tied with the last kept probability.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NEG = -1e30  # finite -inf: masked logits stay exp-safe

# ---------------------------------------------------------------------------
# counter-based random bits
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
# xorshift-multiply mixer [16 21f0aaad 15 735a2d97 15] (Wellons' hash
# prospector): both multipliers are below 2^31, so a 32-bit value times
# either stays below 2^63 in int64 on every backend
_MIX_A, _MIX_B = 0x21F0AAAD, 0x735A2D97
_WEYL = 0x9E3779B9  # per-index increment (2^32 / golden ratio)
_SEED_SALT, _STEP_SALT, _TAG_SALT = 0x3C6EF372, 0x1B873593, 0x5851F42D


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit mix of int64 values in ``[0, 2^32)``."""
    x = x ^ (x >> 16)
    x = (x * _MIX_A) & _M32
    x = x ^ (x >> 15)
    x = (x * _MIX_B) & _M32
    return x ^ (x >> 15)


def _i64(x, device) -> torch.Tensor:
    """Seeds, steps or tags (tensor, numpy array, list or int) as int64 on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def random_bits(seeds, steps, tag: int, n: int, device) -> torch.Tensor:
    """32-bit random values (int64 tensor) ``[..., n]`` for the keys
    ``(seeds, steps, tag)`` (broadcast together) and indices ``[0, n)``:
    a hash of the key mixed three times, then two rounds over a Weyl
    sequence of the index. The same key gives the same bits on every
    device."""
    s = _i64(seeds, device) & _M32
    t = _i64(steps, device) & _M32
    k = _mix32(s ^ _SEED_SALT)
    k = _mix32(k ^ ((t + _STEP_SALT) & _M32))
    k = _mix32(k ^ ((int(tag) + _TAG_SALT) & _M32))[..., None]
    idx = torch.arange(n, device=device, dtype=torch.int64)
    h = _mix32((k + idx * _WEYL) & _M32)
    return _mix32((h + k) & _M32)


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """The top 24 bits as a float32 uniform in (0, 1), exact in float32."""
    return ((bits >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def _categorical(z: torch.Tensor, seeds, steps, tag: int = 0) -> torch.Tensor:
    """One draw from softmax(z) over the last axis per leading index
    (Gumbel-max), keyed by ``(seeds, steps, tag)``, which broadcast against
    ``z.shape[:-1]``. Returns int64 indices on ``z``'s device."""
    u = _uniform(random_bits(seeds, steps, tag, z.shape[-1], z.device))
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(z.float() + gumbel, dim=-1)


# ---------------------------------------------------------------------------
# logits warping
# ---------------------------------------------------------------------------


def _scaled(logits: torch.Tensor, temp) -> torch.Tensor:
    t = torch.as_tensor(temp, dtype=logits.dtype, device=logits.device)
    return logits / torch.clamp_min(t, 1e-6)


def _col(x, z: torch.Tensor, dtype) -> torch.Tensor:
    """A per-row scalar (python number or [...] tensor) as a column that
    broadcasts against ``z`` [..., V]."""
    t = torch.as_tensor(x, dtype=dtype, device=z.device)
    return t[..., None] if t.ndim else t


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis — the deterministic decode mode."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _top_k_logits(z: torch.Tensor, k) -> torch.Tensor:
    v = z.shape[-1]
    kk = torch.clamp(_col(k, z, torch.int64), 1, v)
    sorted_z = torch.sort(z, dim=-1, descending=True).values
    thr = torch.gather(sorted_z, -1, (kk - 1).expand(*z.shape[:-1], 1))
    return torch.where(z >= thr, z, torch.full_like(z, _NEG))


def _top_p_logits(z: torch.Tensor, p) -> torch.Tensor:
    probs = torch.softmax(z, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    cs = torch.cumsum(sp, dim=-1)
    # keep while the mass BEFORE this token is < p (always keeps the top-1,
    # includes the token that crosses the threshold)
    keep = (cs - sp) < _col(p, z, probs.dtype)
    thr = torch.amin(torch.where(keep, sp, torch.full_like(sp, float("inf"))),
                     dim=-1, keepdim=True)
    return torch.where(probs >= thr, z, torch.full_like(z, _NEG))


def _warp(logits: torch.Tensor, temp, k, p) -> torch.Tensor:
    """Shared logits warping: temperature scale, then top-k, then top-p
    over the surviving support (``k == 0`` and ``p >= 1`` disable). ``temp``,
    ``k`` and ``p`` are scalars or one value per row of ``logits``."""
    z = logits.float()
    z = z / torch.clamp_min(_col(temp, z, torch.float32), 1e-6)
    k = torch.as_tensor(k, dtype=torch.int64, device=z.device)
    p = torch.as_tensor(p, dtype=torch.float32, device=z.device)
    z = torch.where(_col(k, z, torch.int64) > 0,
                    _top_k_logits(z, torch.clamp_min(k, 1)), z)
    z = torch.where(_col(p, z, torch.float32) < 1.0,
                    _top_p_logits(z, torch.clamp(p, 1e-6, 1.0)), z)
    return z


# ---------------------------------------------------------------------------
# single-spec samplers (one draw per row)
# ---------------------------------------------------------------------------


def _draw(z: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row of ``z`` from softmax(z): the seed comes from the
    CPU generator ``gen`` (the counterpart of a JAX key), the row index is
    the step, so rows draw independently."""
    seed = int(torch.randint(0, 1 << 32, (), generator=gen))
    flat = z.reshape(-1, z.shape[-1])
    rows = torch.arange(flat.shape[0], device=z.device)
    return _categorical(flat, seed, rows).reshape(z.shape[:-1]).to(torch.int32)


def temperature(logits: torch.Tensor, gen: torch.Generator, temp: float = 1.0) -> torch.Tensor:
    """Sample from softmax(logits / temp), one draw per row."""
    return _draw(_scaled(logits, temp), gen)


def top_k(logits: torch.Tensor, gen: torch.Generator, k: int,
          temp: float = 1.0) -> torch.Tensor:
    """Sample among the k highest-logit tokens (ties at the k-th kept)."""
    return _draw(_top_k_logits(_scaled(logits, temp), k), gen)


def top_p(logits: torch.Tensor, gen: torch.Generator, p: float,
          temp: float = 1.0) -> torch.Tensor:
    """Nucleus sampling: smallest prefix of the sorted distribution with
    cumulative probability >= p."""
    return _draw(_top_p_logits(_scaled(logits, temp), p), gen)


# ---------------------------------------------------------------------------
# the batched per-row sampler
# ---------------------------------------------------------------------------


def _bool(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(x, dtype=bool), device=device)


def sample_tokens(
    logits: torch.Tensor,       # [B, V]
    seeds,                      # [B] per-request seed
    steps,                      # [B] per-request decode step index
    greedy_mask,                # [B] bool — True rows take argmax
    temp,                       # [B] float temperature
    k,                          # [B] int top-k (0 = off)
    p,                          # [B] float top-p (>= 1 = off)
) -> torch.Tensor:
    """Batched per-row sampler: every row carries its own sampling spec.
    Greedy rows take the argmax of the raw logits; the others draw from
    softmax(_warp(logits)) keyed by their ``(seed, step)``. Both are
    computed for every row and selected on the device (no host read).
    Returns [B] int32 tokens on the logits' device."""
    dev = logits.device
    sampled = _categorical(_warp(logits, temp, k, p), seeds, steps)
    g = _bool(greedy_mask, dev)
    return torch.where(g, torch.argmax(logits, dim=-1), sampled).to(torch.int32)


# ---------------------------------------------------------------------------
# speculative decoding: exact accept-or-resample
# ---------------------------------------------------------------------------

# tags keeping the accept-test and residual-resample streams independent of
# each other AND of the plain draw at the same (seed, step), which is
# untagged (tag 0) — the independence the exactness proof requires
_ACCEPT_TAG = 0x5A
_RESID_TAG = 0x5B


def _per_pos(x, shape, dtype, device) -> torch.Tensor:
    """A per-row value ([B] or scalar) broadcast over positions: ``shape``
    is ``[B, n]``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    t = t.to(device=device, dtype=dtype)
    if t.ndim == 1:
        t = t[:, None]
    return t.expand(shape)


def _warped_probs(logits, greedy_flag, temp, k, p):
    """The per-position sampling distribution a request's spec implies:
    softmax of the warped logits, or a one-hot argmax for greedy rows
    (greedy == the temperature->0 limit, so the ratio test degenerates to
    exact token equality and speculative greedy streams stay
    token-identical to plain greedy). The spec values broadcast against
    ``logits.shape[:-1]``."""
    probs = torch.softmax(_warp(logits, temp, k, p), dim=-1)
    hot = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1),
                                      logits.shape[-1]).to(probs.dtype)
    g = torch.as_tensor(greedy_flag, dtype=torch.bool, device=logits.device)
    return torch.where(g[..., None] if g.ndim else g, hot, probs)


def _residual_probs(p_t, p_d):
    """Normalized max(0, p_t - p_d): the exact residual distribution a
    rejection resamples from. Falls back to p_t when the residual has no
    mass (p_d == p_t — a rejection there has probability zero, the
    fallback only guards the division)."""
    r = torch.clamp_min(p_t - p_d, 0.0)
    mass = torch.sum(r, dim=-1, keepdim=True)
    return torch.where(mass > 1e-12, r / torch.clamp_min(mass, 1e-12), p_t)


def _log(probs):
    return torch.log(torch.clamp_min(probs, 1e-30))


def speculative_accept(
    draft_tokens,    # [B, K] proposed tokens
    draft_logits,    # [B, K, V] draft dist at each proposal
    target_logits,   # [B, K+1, V] target dist at each position
    seeds,           # [B] per-request seed
    steps,           # [B] decode step of the FIRST position
    spec_ks,         # [B] per-row window (0 = plain decode)
    greedy_mask,     # [B] bool
    temp,            # [B] float temperature
    k,               # [B] int top-k (0 = off)
    p,               # [B] float top-p (>= 1 = off)
):
    """Exact acceptance sampling for draft-model speculative decoding.

    Per row: walk the ``spec_ks`` proposed tokens left to right, accepting
    token ``x_i`` with probability ``min(1, p_target(x_i)/p_draft(x_i))``;
    the first rejection emits a resample from the normalized residual
    ``max(0, p_target - p_draft)`` and closes the window; full acceptance
    emits a bonus token sampled from the target's ``K+1``-th distribution.
    The emitted-token marginal at every position is exactly the (warped)
    target distribution. Greedy rows degenerate to argmax equality, so
    greedy streams are token-identical to plain decode.

    Randomness at output position ``steps + i`` is keyed by
    ``(seed, steps + i)`` and a per-use tag; the bonus draw at a row's
    ``spec_k``-th position is untagged, the key :func:`sample_tokens` uses
    at that step, so a ``spec_k == 0`` row reproduces plain sampling.
    Everything stays on the logits' device. Returns ``(tokens [B, K+1],
    n_accepted [B], n_emitted [B])`` (int32) with ``n_emitted ==
    n_accepted + 1``; entries past ``n_emitted`` are padding."""
    dev = target_logits.device
    d_toks = torch.as_tensor(draft_tokens, device=dev).long()
    b, kmax = d_toks.shape
    pos = _i64(steps, dev)[:, None] + torch.arange(kmax + 1, device=dev)  # [B, K+1]
    seed = _i64(seeds, dev)[:, None]
    spec = _i64(spec_ks, dev)[:, None]
    g = _bool(greedy_mask, dev)

    def warped(logits):
        shape = logits.shape[:2]
        return _warped_probs(logits, g[:, None].expand(shape),
                             _per_pos(temp, shape, torch.float32, dev),
                             _per_pos(k, shape, torch.int64, dev),
                             _per_pos(p, shape, torch.float32, dev))

    p_t = warped(target_logits)   # [B, K+1, V]
    p_d = warped(draft_logits)    # [B, K, V]
    # accept test at each proposed position: u < p_t(x)/p_d(x)
    pt_x = torch.gather(p_t[:, :kmax], -1, d_toks[..., None])[..., 0]
    pd_x = torch.gather(p_d, -1, d_toks[..., None])[..., 0]
    u = _uniform(random_bits(seed, pos[:, :kmax], _ACCEPT_TAG, 1, dev)[..., 0])
    ratio = pt_x / torch.clamp_min(pd_x, 1e-30)
    in_window = torch.arange(kmax, device=dev)[None, :] < spec
    accept = (u < ratio) & in_window
    # number of LEADING accepts (a rejection stops the window)
    n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    # at every position, what a rejection there would emit (residual
    # dist), and what full acceptance emits (the untagged plain draw)
    resample = _categorical(_log(_residual_probs(p_t[:, :kmax], p_d)),
                            seed, pos[:, :kmax], _RESID_TAG)      # [B, K]
    plain = _categorical(_log(p_t), seed, pos)                   # [B, K+1]
    greedy_fix = torch.argmax(target_logits, dim=-1)
    idx = torch.arange(kmax + 1, device=dev)[None, :]
    pad = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    # inside the window a stop is a REJECTION -> residual resample; at
    # position spec_k the window is merely exhausted -> plain sample from
    # the full target dist (the "bonus" token)
    sampled_fix = torch.where(idx < spec, torch.cat([resample, pad], dim=1), plain)
    correction = torch.where(g[:, None], greedy_fix, sampled_fix)
    fix = torch.gather(correction, 1, torch.clamp_max(n_acc, kmax)[:, None])  # [B, 1]
    out = torch.where(idx < n_acc[:, None], torch.cat([d_toks, pad], dim=1), fix)
    return out.to(torch.int32), n_acc.to(torch.int32), (n_acc + 1).to(torch.int32)


def make_sampler(*, greedy_mode: Optional[bool] = None,
                 temp: float = 1.0, k: int = 0, p: float = 1.0):
    """Single-spec convenience: returns ``fn(logits [B, V], seeds, steps)``
    applying one sampling configuration to every row."""
    use_greedy = bool(greedy_mode) if greedy_mode is not None else (
        k == 0 and p >= 1.0 and temp == 0.0)

    def fn(logits, seeds, steps):
        b, dev = logits.shape[0], logits.device
        return sample_tokens(
            logits, seeds, steps,
            torch.full((b,), use_greedy, dtype=torch.bool, device=dev),
            torch.full((b,), temp, dtype=torch.float32, device=dev),
            torch.full((b,), k, dtype=torch.int64, device=dev),
            torch.full((b,), p, dtype=torch.float32, device=dev))

    return fn
