"""Replay a step function from a CUDA graph, with its kernel launches counted.

A decode step issues hundreds of small launches and is bound by the host's
time to issue them (PERF.md §5); one graph replay issues them all at once.
:class:`GraphedStep` captures ``fn(*inputs)`` once into a graph over static
copies of ``inputs``; each call copies new values into those buffers and
replays. ``fn`` must read everything that changes between calls from its
inputs or from tensors that it updates in place (the decode carry), and must
not read device values on the host.

A replay launches the kernels without calling their wrappers, so it would
leave the launch counts (:data:`~.flash_attention.LAUNCH_COUNTS`,
:data:`~.grouped_matmul.LAUNCH_COUNTS`) where they were. The capture calls
each wrapper once and launches nothing: the counts it adds are taken back
after the capture and added again on every replay.

A capture that fails raises; nothing falls back to running ``fn`` eagerly.
The caller runs ``fn`` once eagerly before the capture, so that libraries,
kernel builds and workspaces are set up outside it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .flash_attention import LAUNCH_COUNTS as _ATTENTION_COUNTS
from .grouped_matmul import LAUNCH_COUNTS as _GROUPED_MATMUL_COUNTS

_COUNTS = (_ATTENTION_COUNTS, _GROUPED_MATMUL_COUNTS)


def _snapshot():
    return [dict(c) for c in _COUNTS]


class GraphedStep:
    """``fn(*inputs)`` captured in one CUDA graph. ``inputs`` are CUDA
    tensors whose shapes and dtypes every later call repeats; ``outputs``
    are the graph's own tensors, overwritten by each replay."""

    def __init__(self, fn, inputs: Sequence[torch.Tensor]) -> None:
        dev = inputs[0].device
        if dev.type != "cuda":
            raise ValueError(f"GraphedStep captures CUDA work, got inputs on {dev}")
        self.inputs = [x.clone() for x in inputs]
        self.graph = torch.cuda.CUDAGraph()
        before = _snapshot()
        try:
            with torch.cuda.device(dev):
                torch.cuda.synchronize(dev)
                # thread_local: another thread's work (a caller waiting on
                # a result) does not invalidate this thread's capture
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                    self.outputs = fn(*self.inputs)
        finally:
            #: launches of one replay, by wrapper
            self.launches: Dict[str, int] = {}
            for counts, was in zip(_COUNTS, before):
                for name, n in was.items():
                    if counts[name] != n:
                        self.launches[name] = counts[name] - n
                        counts[name] = n

    def __call__(self, *inputs: torch.Tensor):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x, non_blocking=True)
        self.graph.replay()
        for counts in _COUNTS:
            for name in counts:
                counts[name] += self.launches.get(name, 0)
        return self.outputs
