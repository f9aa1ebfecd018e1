"""Where the MoE network's time goes on the card.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.moe_profile [--compute-dtype bfloat16]

Builds the network that ``chip_smoke.py`` runs (:func:`moe_lm_conf`:
GPT-2 small's trunk widths cut to one decoder block, then a
``MixtureOfExpertsLayer`` at the widths of the JAX package's MoE
dispatch benchmark; seeded random weights, float32, Adam 1e-4; with
``--compute-dtype`` the layers compute in that dtype over float32 master
weights) and one
fixed batch of 8 x 1024 tokens. For ``output()`` and for one
``Solver.fit_batch`` step it prints the host wall time of unprofiled runs,
the device busy time that ``torch.profiler`` attributes to CUDA kernels,
the device's idle share (1 - busy / wall), the number of kernel launches,
the kernels that take the most device time, and the device time of the
port's kernels (B1-B3 and the grouped matmul B5).
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import (
    Activation, LossFunction, MultiLayerConfiguration, NeuralNetConfiguration, WeightInit,
)
from deeplearning4j_tpu_torch.nn.layers import (
    EmbeddingSequenceLayer, LayerNormLayer, MixtureOfExpertsLayer, PositionalEmbeddingLayer,
    RnnOutputLayer, TransformerDecoderBlockLayer,
)
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.tools.serving_profile import _device_profile, _wall_ms
from deeplearning4j_tpu_torch.train import Solver
from deeplearning4j_tpu_torch.train.updaters import Adam

B, T_FULL, SEED = 8, 1024, 1234
VOCAB, D_MODEL = 50257, 768
MOE_LAYER = "layer_3"
# what every instantiation of a kernel holds in its name: the mma.sync and
# wgmma kernels of B1-B3 (flash_forward_kernel, flash_forward_wgmma_kernel,
# ...), and B5's float32, wgmma and float64 kernels ("grouped_matmul_")
_KERNELS = ("flash_forward_", "flash_bwd_dq_", "flash_bwd_dkv_", "grouped_matmul_")


def moe_lm_conf(dispatch_mode: str = "grouped", seed: int = SEED,
                compute_dtype: Optional[str] = None) -> MultiLayerConfiguration:
    """Token and position embeddings, one pre-LN decoder block at GPT-2
    small's widths (Radford et al. 2019: 768 wide, 12 heads, FFN 3072,
    1024 positions, vocab 50257), then an MoE FFN with 8 experts of hidden
    1536, top-2 routing (GShard, Mixtral), capacity factor 1.25 and an
    aux weight of 0.01 (Switch Transformer), a LayerNorm and the softmax
    head. About 104 M parameters; float32; Adam(1e-4). ``compute_dtype``
    (e.g. ``"bfloat16"``): the layers compute in it over the float32
    master weights."""
    return (NeuralNetConfiguration.builder().seed(seed).data_type("float32")
            .compute_dtype(compute_dtype)
            .updater(Adam(1e-4)).weight_init(WeightInit.XAVIER).list()
            .layer(EmbeddingSequenceLayer(n_in=VOCAB, n_out=D_MODEL))
            .layer(PositionalEmbeddingLayer(n_out=D_MODEL, max_len=T_FULL))
            .layer(TransformerDecoderBlockLayer(n_in=D_MODEL, n_heads=12, ffn_size=3072))
            .layer(MixtureOfExpertsLayer(n_in=D_MODEL, n_out=D_MODEL, num_experts=8,
                                         hidden=1536, top_k=2, capacity_factor=1.25,
                                         activation=Activation.RELU,
                                         balance_loss_weight=0.01,
                                         dispatch_mode=dispatch_mode))
            .layer(LayerNormLayer(n_out=D_MODEL))
            .layer(RnnOutputLayer(n_in=D_MODEL, n_out=VOCAB, loss=LossFunction.SPARSE_MCXENT,
                                  activation=Activation.SOFTMAX))
            .build())


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compute-dtype", default=None, choices=["bfloat16", "float16"],
                        help="the layers' compute dtype (default: float32)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(f"compute dtype {args.compute_dtype or 'float32'}")
    model = MultiLayerNetwork(moe_lm_conf(compute_dtype=args.compute_dtype)).init()
    solver = Solver(model)
    rs = np.random.RandomState(SEED + 2)
    ids = torch.from_numpy(rs.randint(0, VOCAB, (B, T_FULL + 1))).cuda()
    x, y = ids[:, :-1], ids[:, 1:]

    phases = [("output() [8,1024]", lambda: model.output(x)),
              ("training step [8,1024]", lambda: solver.fit_batch(x, y))]
    for name, fn in phases:
        wall = _wall_ms(fn)
        busy, launches, rows = _device_profile(fn)
        print(f"{name}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
              f"idle share {1 - busy / wall:.3f}, {launches:.0f} kernel launches")
        for key, ms, count in rows[:12]:
            print(f"    {ms:9.4f} ms  {count:6.0f}x  {key[:90]}")
        for kname in _KERNELS:
            ms = sum(r[1] for r in rows if kname in r[0])
            n = sum(r[2] for r in rows if kname in r[0])
            print(f"  {kname}*: {ms:.4f} ms in {n:.0f} launches, {ms / busy:.3f} of the busy "
                  f"time")


if __name__ == "__main__":
    main()
