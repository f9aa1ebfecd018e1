"""Which shapes ``torch._int_mm`` (cuBLASLt's int8 x int8 -> int32 product)
accepts on the card, and whether each accepted one is exact.

``nn/rewrite/quantize.py::int8_matmul`` pads its operands to the shapes this
probe finds accepted: PyTorch documents m > 16 and k, n multiples of 8, but
on an H100 with CUDA 12.8 cuBLASLt refused every m of 17, 24, 40 and 48 at
k <= 64 and n >= 32 and accepted m = 32, 64 and 128 at every k and n of the
grid. Run on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.int_mm_probe

It prints the card, the counts of accepted and refused shapes, and each
refused (or inexact) (m, k, n).
"""

from __future__ import annotations

import itertools
import sys

import torch

M = (17, 24, 32, 40, 48, 64, 128)
K = (16, 24, 32, 64, 128, 800)
N = (8, 16, 24, 32, 64, 504)


def main() -> int:
    if not torch.cuda.is_available():
        print("int_mm_probe needs a CUDA device", file=sys.stderr)
        return 2
    ok, bad = [], []
    g = torch.Generator().manual_seed(0)
    for m, k, n in itertools.product(M, K, N):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g)
        try:
            c = torch._int_mm(a.cuda(), b.cuda()).cpu()
        except RuntimeError:
            bad.append((m, k, n, "refused"))
            continue
        exact = torch.equal(c.long(), a.long() @ b.long())
        (ok if exact else bad).append((m, k, n, "ok" if exact else "inexact"))
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}: {len(ok)} shapes accepted and exact, {len(bad)} not")
    for row in bad:
        print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
