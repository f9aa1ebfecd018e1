"""Where the serving path's time goes on the card.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.serving_profile

Builds the GPT-2-small-width ``TransformerLM`` that ``chip_smoke.py``
serves (seeded random weights, float32, batch 8, ragged prompts of
100-500 tokens), then for each phase — ``output()`` on [8, 1024],
``prefill`` at bucket 512, single-token session ``decode`` steps run
eagerly (``GenerationSession.step``) and replayed from the session's CUDA
graph (``GenerationSession.decode``), and the ``DecodeEngine``'s plain
step (forward, device sampler, freeze; the sampled tokens read back as the
engine does) over the static, paged (``block_size=16``), int8 and paged
int8 caches, eager and from its graph — prints the host wall time of an
unprofiled run, the device busy time that ``torch.profiler`` attributes to
CUDA kernels, the device's idle share (1 - busy / wall), the number of
kernel launches, and the kernels that take the most device time. The
engine's steps run on its carry with the 8 prompts installed and its
worker thread stopped, so the tool drives them alone.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from deeplearning4j_tpu_torch.generate import GenerationSession
from deeplearning4j_tpu_torch.model.zoo import TransformerLM
from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.parallel import DecodeEngine
from deeplearning4j_tpu_torch.parallel.decode import GenerationHandle, _Request
from deeplearning4j_tpu_torch.core.resilience import Deadline

B, T_FULL, DECODE_STEPS, SEED = 8, 1024, 16, 1234


def _wall_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _device_profile(fn):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: the CPU-side aten ops also report their kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("serving_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    model = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12,
                          ffn_size=3072, max_len=T_FULL, seed=SEED).init()
    session = GenerationSession(model, max_len=T_FULL)
    rs = np.random.RandomState(SEED + 1)
    lens = [100, 500] + rs.randint(100, 501, B - 2).tolist()
    prompts = [rs.randint(0, 50257, n).tolist() for n in lens]
    ids = rs.randint(0, 50257, (B, T_FULL))
    carry, logits, _ = session.prefill(prompts)
    tokens = torch.argmax(logits, dim=-1)

    def session_steps(graph: bool):
        def run():
            nonlocal carry
            with torch.no_grad():
                for _ in range(DECODE_STEPS):
                    if graph:
                        carry, _ = session.decode(carry, tokens)
                    else:
                        session.step(carry, tokens.to(torch.int32))
        return run

    phases = [("output() [8,1024]", lambda: model.output(ids), 1),
              ("prefill bucket 512", lambda: session.prefill(prompts), 1),
              (f"session decode eager x{DECODE_STEPS}", session_steps(False), DECODE_STEPS),
              (f"session decode CUDA graph x{DECODE_STEPS}", session_steps(True), DECODE_STEPS)]
    _report(phases)
    del carry
    session.release_graphs()
    for label, kw in (("static", {}), ("paged", {"block_size": 16}),
                      ("int8", {"cache_dtype": "int8"}),
                      ("paged int8", {"cache_dtype": "int8", "block_size": 16})):
        eng = _engine_with_rows(model, prompts, **kw)
        ints, floats = eng._step_inputs(eng._active)
        dev_ints, dev_floats = ints.cuda(), floats.cuda()

        def steps(graph: bool):
            def run():
                with torch.no_grad():
                    for _ in range(DECODE_STEPS):
                        if graph:
                            eng._plain_step(ints, floats).cpu()
                        else:
                            eng._decode_rows(dev_ints, dev_floats).cpu()
            return run

        _report([(f"engine {label} step eager x{DECODE_STEPS}", steps(False), DECODE_STEPS),
                 (f"engine {label} step CUDA graph x{DECODE_STEPS}", steps(True), DECODE_STEPS)])
        del eng
        torch.cuda.empty_cache()


def _engine_with_rows(model, prompts, **kw) -> DecodeEngine:
    """A ``DecodeEngine`` whose worker thread is stopped, with every prompt
    prefilled into its slot and, for a paged cache, blocks reserved for the
    positions the tool steps through."""
    eng = DecodeEngine(model, max_len=T_FULL, slots=B, registry=MetricsRegistry(), **kw)
    eng.shutdown()
    with torch.no_grad():
        for slot, p in enumerate(prompts):
            handle = GenerationHandle(f"profile-{slot}", Deadline.after(None))
            eng._prefill_into(slot, _Request(p, T_FULL, None, handle, slot, True, 1.0, 0,
                                             1.0, None, None))
    if eng._allocator is not None:
        eng._reserve_rows(eng._active, 12 * DECODE_STEPS)
    return eng


def _report(phases) -> None:
    for name, fn, per in phases:
        wall = _wall_ms(fn) / per
        busy, launches, rows = _device_profile(fn)
        busy, launches = busy / per, launches / per
        print(f"{name}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}, {launches:.0f} kernel launches (per "
              f"{'step' if per > 1 else 'call'})", flush=True)
        for key, ms, count in rows[:8]:
            print(f"    {ms / per:9.4f} ms  {count / per:6.0f}x  {key[:90]}")

if __name__ == "__main__":
    main()
