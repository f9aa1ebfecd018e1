"""Why greedy tokens over an int8 KV cache sit up to one bfloat16 ulp below
the argmax in a ``compute_dtype="bfloat16"`` LM, on the card.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.int8_decode_probe

The LM is ``chip_smoke.py``'s GPT-2-small-width ``TransformerLM`` (12
blocks, 768 wide, vocab 50257, seed 1234) with ``compute_dtype="bfloat16"``,
and the traffic its 8 ragged prompts of 100-500 tokens, 64 greedy tokens
each. For a float and an int8 cache, once through the decode kernel (B4)
and once through the reference spelling (``set_attention_impl``), it
prints:

1. the dtype of the decode step's log-probs;
2. the worst distance of a greedy token below the maximum log-prob of a
   full forward over a fresh cache of the same dtype on its prefix
   (teacher-forced, the log taken in float32), and the same distance less
   one bfloat16 ulp of that maximum;
3. for the first bfloat16 call of B4 in an int8 step, its largest error
   against the reference spelling in float32 on the same inputs, beside the
   bfloat16 reference spelling's.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from deeplearning4j_tpu_torch.generate import GenerationSession
from deeplearning4j_tpu_torch.model.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork

fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")

SEED = 1234
B, MAX_TOKENS, MAX_LEN = 8, 64, 1024


def _prompts():
    rs = np.random.RandomState(SEED + 1)
    lens = [100, 500] + rs.randint(100, 501, B - 2).tolist()
    return [rs.randint(0, 50257, n).tolist() for n in lens]


def _teacher_forced(model, prompts, streams, cache_dtype):
    """Per request, log-probs [len(stream), V] of one forward over
    ``prompt + stream[:-1]`` on a fresh decode carry of ``cache_dtype``."""
    seqs = [p + s[:-1] for p, s in zip(prompts, streams)]
    ids = np.zeros((len(seqs), max(len(s) for s in seqs)), np.int32)
    mask = np.zeros(ids.shape, np.float32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1.0
    carry = GenerationSession(model, max_len=ids.shape[1],
                              cache_dtype=cache_dtype).decode_state(len(seqs))
    with torch.no_grad():
        full, _, _ = model.forward_pure(
            model.params, model.state, torch.from_numpy(ids).to(model.device),
            train=False, rng=None, mask=torch.from_numpy(mask).to(model.device, model.dtype),
            rnn_state=carry)
    full = full.float()
    return [torch.log(torch.clamp_min(full[i, :, len(p) - 1: len(p) - 1 + len(s)], 1e-30)).T
            for i, (p, s) in enumerate(zip(prompts, streams))]


def _gaps(lps, streams):
    """(worst gap, worst gap less one bf16 ulp of the position's maximum)."""
    raw, tied = 0.0, 0.0
    for lp, s in zip(lps, streams):
        top = lp.max(dim=1).values
        g = top - lp.gather(1, torch.tensor(s, device=lp.device)[:, None])[:, 0]
        raw = max(raw, float(g.max()))
        tied = max(tied, float((g - torch.exp2(torch.floor(torch.log2(top.abs())) - 7)).max()))
    return raw, tied


def main() -> None:
    prompts = _prompts()
    conf = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12, ffn_size=3072,
                         max_len=MAX_LEN, seed=SEED).conf()
    model = MultiLayerNetwork(dataclasses.replace(conf, compute_dtype="bfloat16")).init()
    for cache in (None, "int8"):
        for impl in ("auto", "reference"):
            fa.set_attention_impl(impl)
            sess = GenerationSession(model, max_len=MAX_LEN, cache_dtype=cache)
            with torch.no_grad():
                streams = sess.generate(prompts, MAX_TOKENS)
                carry, _, _ = sess.prefill(prompts[:1])
                step_dtype = sess.step(carry, torch.zeros(1, dtype=torch.int32,
                                                          device=model.device)).dtype
            fa.set_attention_impl("auto")
            raw, tied = _gaps(_teacher_forced(model, prompts, streams, cache), streams)
            print(f"cache {cache or 'float'}, attention {impl}: step log-probs "
                  f"{str(step_dtype)[6:]}; worst greedy gap {raw:.6e}, less one bf16 ulp "
                  f"{tied:.6e}")
            del sess, carry
            torch.cuda.empty_cache()

    captured = []
    wrapped = fa.flash_decode_attention

    def grab(q, k, v, start_pos, scale=None):
        if q.dtype == torch.bfloat16 and not captured:
            captured.append((q.clone(), k.clone(), v.clone(), start_pos.clone()))
        return wrapped(q, k, v, start_pos, scale=scale)

    fa.flash_decode_attention = grab
    try:
        sess = GenerationSession(model, max_len=MAX_LEN, cache_dtype="int8")
        with torch.no_grad():
            carry, logits, _ = sess.prefill(prompts)
            sess.step(carry, logits.argmax(1).to(torch.int32))
    finally:
        fa.flash_decode_attention = wrapped
    q, k, v, sp = captured[0]
    with torch.no_grad():
        o4 = fa.flash_decode_attention(q, k, v, sp).float()
        o32 = fa.decode_attention_reference(q.float(), k.float(), v.float(), sp)
        o16 = fa.decode_attention_reference(q, k, v, sp).float()
    print(f"B4 bf16 over the dequantized int8 cache {list(k.shape)}: max_abs vs the float32 "
          f"reference {float((o4 - o32).abs().max()):.4e}; the bf16 reference spelling's "
          f"{float((o16 - o32).abs().max()):.4e}; largest |output| {float(o32.abs().max()):.4e}")


if __name__ == "__main__":
    main()
