"""Card peak FLOPs/sec lookup for MFU denominators (port of
``deeplearning4j_tpu/bench/peak.py``).

The JAX package keys its table by accelerator generation; the port keys it
by the name the card reports (``torch.cuda.get_device_name``). The rates
are NVIDIA's published dense (no sparsity) peaks of the card at its full
power limit; a card set below it runs slower under load, so state its
``power.limit`` beside an MFU taken against these.
"""

from __future__ import annotations

from typing import Optional

import torch

# dense peak FLOPs/sec per card (NVIDIA data sheet: H100 SXM5 80GB, 700 W)
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,   # tensor cores
        "float16": 989e12,    # tensor cores
        "tf32": 495e12,       # tensor cores
        "float32": 67e12,     # CUDA cores
    },
}

_ALIASES = {"bf16": "bfloat16", "f16": "float16", "fp16": "float16", "half": "float16",
            "f32": "float32", "fp32": "float32", "float": "float32"}


def _card_name(device) -> Optional[str]:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(dev)


def chip_peak_flops(device, compute_dtype: str = "bfloat16") -> Optional[float]:
    """Peak FLOPs/sec of ``device`` (a ``torch.device``, ``"cuda:0"``...) for
    products in ``compute_dtype`` (a name or a ``torch.dtype``), or None when
    unknown: the CPU, a card not in the table, a dtype it has no rate for
    (MFU is then reported as null rather than against a made-up
    denominator).

    The port keeps TF32 off (PyTorch's default for products, and
    ``ops/helpers.py`` around convolutions), so ``"float32"`` reads the CUDA-core rate, not a
    share of the bf16 rate; ``"tf32"`` reads the tensor cores' TF32 rate."""
    name = _card_name(device)
    if name is None or name not in _PEAKS:
        return None
    key = str(compute_dtype).replace("torch.", "")
    return _PEAKS[name].get(_ALIASES.get(key, key))
