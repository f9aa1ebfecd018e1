"""Where the MoE network's time goes on the card.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.moe_profile

Builds the network that ``chip_smoke.py`` runs (:func:`moe_lm_conf`:
GPT-2 small's trunk widths cut to one decoder block, then a
``MixtureOfExpertsLayer`` at the widths of the JAX package's MoE
dispatch benchmark; seeded random weights, float32, Adam 1e-4) and one
fixed batch of 8 x 1024 tokens. For ``output()`` and for one
``Solver.fit_batch`` step it prints the host wall time of unprofiled runs,
the device busy time that ``torch.profiler`` attributes to CUDA kernels,
the device's idle share (1 - busy / wall), the number of kernel launches,
the kernels that take the most device time, and the device time of the
port's kernels (B1-B3 and the grouped matmul B5).
"""

from __future__ import annotations

import subprocess

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
# the kernels' names, or what every instantiation of one holds (B5's float32,
# tensor-core and float64 kernels all begin with "grouped_matmul_")
_KERNELS = ("flash_forward_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
            "grouped_matmul_")


def moe_lm_conf(dispatch_mode: str = "grouped", seed: int = SEED) -> MultiLayerConfiguration:
    """Token and position embeddings, one pre-LN decoder block at GPT-2
    small's widths (Radford et al. 2019: 768 wide, 12 heads, FFN 3072,
    1024 positions, vocab 50257), then an MoE FFN with 8 experts of hidden
    1536, top-2 routing (GShard, Mixtral), capacity factor 1.25 and an
    aux weight of 0.01 (Switch Transformer), a LayerNorm and the softmax
    head. About 104 M parameters; float32; Adam(1e-4)."""
    return (NeuralNetConfiguration.builder().seed(seed).data_type("float32")
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
    if not torch.cuda.is_available():
        raise SystemExit("moe_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    model = MultiLayerNetwork(moe_lm_conf()).init()
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
            print(f"  {kname}: {ms:.4f} ms in {n:.0f} launches")


if __name__ == "__main__":
    main()
