"""Where the training step's time goes on the card.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.training_profile [--compute-dtype bfloat16]

Builds the GPT-2-small-width ``TransformerLM`` that ``chip_smoke.py``
trains (seeded random weights, float32 master weights, Adam 1e-4; with
``--compute-dtype bfloat16`` its layers compute in bf16, as the
configuration's ``compute_dtype`` says) and one fixed batch of 8 x 1024
tokens, then for one ``Solver.fit_batch`` step prints the host wall time of
unprofiled steps, the device busy time that ``torch.profiler`` attributes to
CUDA kernels, the device's idle share (1 - busy / wall), the number of
kernel launches, the kernels that take the most device time, and the device
time of the port's three attention kernels (each name covers its mma.sync
and wgmma instantiations) with their share of the busy time.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess

import numpy as np
import torch

from deeplearning4j_tpu_torch.model.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.tools.serving_profile import _device_profile, _wall_ms
from deeplearning4j_tpu_torch.train import Solver

B, T_FULL, SEED = 8, 1024, 1234
# B1, B2, B3: the names' common stem covers the mma.sync kernel
# (flash_forward_kernel), the bf16/f16 wgmma one (flash_forward_wgmma_kernel)
# and the float32 3xTF32 wgmma one (flash_forward_tf32_kernel)
_KERNELS = ("flash_forward_", "flash_bwd_dq_", "flash_bwd_dkv_")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float16"],
                        help="the layers' compute dtype (default: float32)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("training_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    conf = TransformerLM(vocab_size=50257, hidden=768, n_layers=12, n_heads=12,
                         ffn_size=3072, max_len=T_FULL, seed=SEED).conf()
    if args.compute_dtype is not None:
        conf = dataclasses.replace(conf, compute_dtype=args.compute_dtype)
    model = MultiLayerNetwork(conf).init()
    solver = Solver(model)
    rs = np.random.RandomState(SEED + 2)
    ids = torch.from_numpy(rs.randint(0, 50257, (B, T_FULL + 1))).cuda()
    x, y = ids[:, :-1], ids[:, 1:]

    def step():
        solver.fit_batch(x, y)

    wall = _wall_ms(step)
    busy, launches, rows = _device_profile(step)
    print(f"training step [8,1024], compute dtype {args.compute_dtype or 'float32'}: wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
          f"{launches:.0f} kernel launches")
    for key, ms, count in rows[:12]:
        print(f"    {ms:9.4f} ms  {count:6.0f}x  {key[:90]}")
    for name in _KERNELS:
        ms = sum(r[1] for r in rows if name in r[0])
        n = sum(r[2] for r in rows if name in r[0])
        print(f"  {name}*: {ms:.4f} ms in {n:.0f} launches, {ms / busy:.3f} of the busy time")


if __name__ == "__main__":
    main()
