"""Autoregressive generation: KV-cached decode, seeded sampling, serving.

* :class:`GenerationSession` (session.py) — static-shape KV-cache decode
  over a MultiLayerNetwork (bucketed prefill + [B, 1] incremental steps,
  replayed from a CUDA graph on the card), with static, int8 and paged
  caches; :class:`SpeculativeGenerationSession` adds a draft model.
* sampling.py — seeded greedy/temperature/top-k/top-p samplers drawn on
  the logits' device, single and batched-per-row, and exact speculative
  acceptance.
* :class:`~deeplearning4j_tpu_torch.parallel.decode.DecodeEngine` — the
  continuous-batching serving loop.
"""

from .sampling import (
    greedy,
    make_sampler,
    sample_tokens,
    speculative_accept,
    temperature,
    top_k,
    top_p,
)
from .paged import (
    BlockAllocator,
    OutOfBlocksError,
    block_bytes,
    blocks_needed,
    freeze_rows,
    is_paged,
    paged_decode_state,
    redirect_inactive_writes,
)
from .session import (
    CACHE_DTYPES,
    GenerationSession,
    SpeculativeGenerationSession,
    bucket_length,
    quantize_decode_state,
    rewind_carry,
)


def __getattr__(name):
    # lazy: parallel.decode imports generate (sampling/session); a direct
    # top-level import here would be circular
    if name in ("DecodeEngine", "GenerationHandle"):
        from ..parallel.decode import DecodeEngine, GenerationHandle

        return {"DecodeEngine": DecodeEngine,
                "GenerationHandle": GenerationHandle}[name]
    raise AttributeError(name)


__all__ = [
    "BlockAllocator",
    "CACHE_DTYPES",
    "DecodeEngine",
    "GenerationHandle",
    "GenerationSession",
    "OutOfBlocksError",
    "SpeculativeGenerationSession",
    "block_bytes",
    "blocks_needed",
    "bucket_length",
    "freeze_rows",
    "greedy",
    "is_paged",
    "make_sampler",
    "paged_decode_state",
    "quantize_decode_state",
    "redirect_inactive_writes",
    "rewind_carry",
    "sample_tokens",
    "speculative_accept",
    "temperature",
    "top_k",
    "top_p",
]
