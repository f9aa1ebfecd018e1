"""Where the training step's time goes on the card.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.training_profile

Builds the GPT-2-small-width ``TransformerLM`` that ``chip_smoke.py``
trains (seeded random weights, float32, Adam 1e-4) and one fixed batch of
8 x 1024 tokens, then for one ``Solver.fit_batch`` step prints the host wall
time of unprofiled steps, the device busy time that ``torch.profiler``
attributes to CUDA kernels, the device's idle share (1 - busy / wall), the
number of kernel launches, the kernels that take the most device time, and
the device time of the port's three attention kernels.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from deeplearning4j_tpu_torch.model.zoo import TransformerLM
from deeplearning4j_tpu_torch.tools.serving_profile import _device_profile, _wall_ms
from deeplearning4j_tpu_torch.train import Solver

B, T_FULL, SEED = 8, 1024, 1234
_KERNELS = ("flash_forward_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("training_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    model = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12,
                          ffn_size=3072, max_len=T_FULL, seed=SEED).init()
    solver = Solver(model)
    rs = np.random.RandomState(SEED + 2)
    ids = torch.from_numpy(rs.randint(0, 50257, (B, T_FULL + 1))).cuda()
    x, y = ids[:, :-1], ids[:, 1:]

    def step():
        solver.fit_batch(x, y)

    wall = _wall_ms(step)
    busy, launches, rows = _device_profile(step)
    print(f"training step [8,1024]: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall:.3f}, {launches:.0f} kernel launches")
    for key, ms, count in rows[:12]:
        print(f"    {ms:9.4f} ms  {count:6.0f}x  {key[:90]}")
    for name in _KERNELS:
        ms = sum(r[1] for r in rows if name in r[0])
        n = sum(r[2] for r in rows if name in r[0])
        print(f"  {name}: {ms:.4f} ms in {n:.0f} launches")


if __name__ == "__main__":
    main()
