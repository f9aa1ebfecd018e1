"""Where the char-RNN's time goes on the card.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.lstm_profile

Builds the zoo ``TextGenerationLSTM()`` that ``chip_smoke.py`` trains
(vocab 77, hidden 200, 2 GravesLSTM layers, TBPTT 50, RmsProp 1e-3,
float32, seeded random weights) and one batch of 32 x 200 one-hot
characters, then for one ``fit`` batch (4 truncated-BPTT windows), one
``output()`` over the batch, and one ``[8, 1]`` decode step of
``GenerationSession`` run eagerly and replayed from its CUDA graph, prints
the host wall time of unprofiled calls, the device busy time that
``torch.profiler`` attributes to CUDA kernels, the device's idle share
(1 - busy / wall), the number of kernel launches, and the kernels that take
the most device time.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.generate import GenerationSession
from deeplearning4j_tpu_torch.model.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.tools.serving_profile import _device_profile, _wall_ms
from deeplearning4j_tpu_torch.train import Solver

V, BATCH, T, SEED, SLOTS = 77, 32, 200, 1234, 8


def _report(label: str, fn, top: int = 8) -> None:
    wall = _wall_ms(fn)
    busy, launches, rows = _device_profile(fn)
    print(f"{label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {launches:.0f} kernel launches")
    for key, ms, count in rows[:top]:
        print(f"    {ms:9.4f} ms  {count:6.0f}x  {key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lstm_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    model = TextGenerationLSTM().init()
    solver = Solver(model)
    rs = np.random.RandomState(SEED + 20)
    ids = torch.from_numpy(rs.randint(0, V, (BATCH, T + 1))).cuda()
    x = F.one_hot(ids[:, :-1], V).float().transpose(1, 2)
    y = F.one_hot(ids[:, 1:], V).float().transpose(1, 2)
    _report(f"fit batch [{BATCH},{V},{T}], {T // model.conf.tbptt_fwd_length} TBPTT windows",
            lambda: solver.fit(x, y))
    with torch.no_grad():
        _report(f"output() [{BATCH},{V},{T}]", lambda: model.output(x))

    session = GenerationSession(model, max_len=512)
    prompts = [rs.randint(0, V, n).tolist() for n in rs.randint(10, 101, SLOTS)]
    carry, logits, _ = session.prefill(prompts)
    toks = torch.argmax(logits, dim=-1).to(torch.int32)

    def eager():
        with torch.no_grad():
            session.step(carry, toks)

    def graphed():
        session.decode(carry, toks)

    _report(f"decode step [{SLOTS},1], eager", eager)
    for _ in range(2):  # the first decode runs eagerly, the second captures
        graphed()
    _report(f"decode step [{SLOTS},1], CUDA graph replay", graphed)
    session.release_graphs()


if __name__ == "__main__":
    main()
