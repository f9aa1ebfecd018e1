"""Model-FLOPs accounting for MFU estimates (a copy of
``deeplearning4j_tpu/bench/flops.py``, which uses no framework).

Counting convention: a multiply-add is 2 FLOPs; training (forward + backward)
is 3x forward — the standard approximation (backward does ~2x the forward
matmul work). These are MODEL flops (what the math requires), not hardware
flops, so recompute/remat doesn't inflate them — exactly what MFU wants.
"""

from __future__ import annotations


def resnet50_train_flops_per_example(height: int = 224, width: int = 224) -> float:
    """ResNet-50 v1 at 224x224: 7.75 GFLOPs forward at the file's stated
    2-FLOPs-per-MAC convention — 7.712 GF of convolutions (summed exactly
    over the zoo graph's conv shapes, = 3.86 GMACs) plus the fc layer and
    change. The widely quoted torchvision/fvcore "4.09 GFLOPs" counts
    MACs, i.e. HALF this convention; taken directly it undercounts
    achieved TFLOP/s and MFU by ~1.9x. Scales with spatial area for other
    input sizes.
    Train = 3x forward."""
    forward = 7.75e9 * (height * width) / (224.0 * 224.0)
    return 3.0 * forward


def bert_train_flops_per_token(model, seq: int) -> float:
    """Transformer-encoder train FLOPs/token from model dims: the standard
    6*N decomposition (2*N forward matmul FLOPs per token, 3x for training)
    plus the attention-score term 12*L*H*T (2 FLOPs * 2 matmuls [QK^T, PV]
    * 3x training * H*T per token per layer).

    ``model`` is the zoo BertEncoder (hidden/n_layers/ffn_size/vocab_size
    attributes); N counts the weight matrices the matrix units actually multiply
    per token: attention 4*H^2, FFN 2*H*F per layer, plus the vocab
    projection H*V (the MLM head dominates at bert-base: 23M of ~110M).
    Embedding lookups are gathers, not matmuls — excluded.
    """
    h, L, f, v = model.hidden, model.n_layers, model.ffn_size, model.vocab_size
    n_matmul_params = L * (4 * h * h + 2 * h * f) + h * v
    return 6.0 * n_matmul_params + 12.0 * L * h * seq
