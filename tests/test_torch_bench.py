"""The port's MFU helpers (``deeplearning4j_tpu_torch/bench``): the FLOP
counts are the JAX package's arithmetic, equal exactly on the zoo
``BertEncoder``'s widths and ResNet-50's input sizes; ``chip_peak_flops``
reads the card's published dense rates by name (H100 SXM5 80GB: bf16/f16
989, TF32 495, float32 on the CUDA cores 67 TFLOP/s) and is None on the
CPU, for a card not in the table and for a dtype without a rate."""

import pytest
import torch

from deeplearning4j_tpu.bench import flops as jflops
from deeplearning4j_tpu.model.zoo import BertEncoder as JBert

from deeplearning4j_tpu_torch.bench import (bert_train_flops_per_token, chip_peak_flops,
                                            resnet50_train_flops_per_example)
from deeplearning4j_tpu_torch.bench import peak
from deeplearning4j_tpu_torch.model.zoo import BertEncoder

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("widths", [{}, dict(hidden=32, n_layers=2, n_heads=2, ffn_size=64,
                                              vocab_size=100, max_len=16)])
@pytest.mark.parametrize("seq", [128, 512])
def test_bert_flops_match_jax(widths, seq):
    got = bert_train_flops_per_token(BertEncoder(**widths), seq)
    assert got == jflops.bert_train_flops_per_token(JBert(**widths), seq)
    if not widths and seq == 512:
        # 6 * (12 * (4 * 768^2 + 2 * 768 * 3072) + 768 * 30522) + 12 * 12 * 768 * 512
        assert got == 6.0 * (12 * (4 * 768 ** 2 + 2 * 768 * 3072) + 768 * 30522) \
            + 12.0 * 12 * 768 * 512


@pytest.mark.parametrize("hw", [(224, 224), (32, 32), (299, 299)])
def test_resnet50_flops_match_jax(hw):
    assert resnet50_train_flops_per_example(*hw) == jflops.resnet50_train_flops_per_example(*hw)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_chip_peak_flops_none_on_cpu(device):
    assert chip_peak_flops(device) is None
    assert chip_peak_flops(device, "float32") is None


def test_chip_peak_flops_none_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_peak_flops("cuda:0") is None


@pytest.mark.parametrize("dtype,want", [
    ("bfloat16", 989e12), (torch.bfloat16, 989e12), ("bf16", 989e12), ("float16", 989e12),
    (torch.float16, 989e12), ("tf32", 495e12), ("float32", 67e12), ("f32", 67e12),
    (torch.float32, 67e12), ("float64", None), ("int8", None)])
def test_chip_peak_flops_h100_table(monkeypatch, dtype, want):
    monkeypatch.setattr(peak, "_card_name", lambda device: H100)
    assert chip_peak_flops("cuda:0", dtype) == want


def test_chip_peak_flops_unknown_card(monkeypatch):
    monkeypatch.setattr(peak, "_card_name", lambda device: "NVIDIA H100 PCIe")
    assert chip_peak_flops("cuda:0") is None
