"""Where ResNet-50's training step and ``output()`` spend their time on the card.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.cnn_profile

Builds the zoo ``ResNet50()`` that ``chip_smoke.py`` drives (224x224x3,
1000 classes, seeded random weights, float32, Adam 1e-3) and one seeded
batch of 32 images, then for ``output()`` and for one
``GraphSolver.fit_batch`` step prints the host wall time of unprofiled
calls, the device busy time that ``torch.profiler`` attributes to CUDA
kernels, the device's idle share (1 - busy / wall), the number of kernel
launches and the kernels that take the most device time. cuDNN's TF32
switch stays at PyTorch's default; the port's convolutions keep float32.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from deeplearning4j_tpu_torch.model.zoo import ResNet50
from deeplearning4j_tpu_torch.tools.serving_profile import _device_profile, _wall_ms
from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver

BATCH, SEED = 32, 1234


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cnn_profile needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(f"cudnn.benchmark={torch.backends.cudnn.benchmark} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    model = ResNet50(seed=SEED).init()
    solver = GraphSolver(model)
    rs = np.random.RandomState(SEED + 10)
    x = torch.from_numpy(rs.randn(BATCH, 3, 224, 224).astype(np.float32)).cuda()
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, BATCH)]).cuda()
    for label, fn in ((f"output() [{BATCH},3,224,224]", lambda: model.output(x)),
                      (f"training step [{BATCH},3,224,224]",
                       lambda: solver.fit_batch((x,), (y,)))):
        wall = _wall_ms(fn)
        busy, launches, rows = _device_profile(fn)
        print(f"{label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}, {launches:.0f} kernel launches, "
              f"{BATCH / wall * 1e3:.1f} images/s")
        for key, ms, count in rows[:12]:
            print(f"    {ms:9.4f} ms  {count:6.0f}x  {key[:100]}")


if __name__ == "__main__":
    main()
