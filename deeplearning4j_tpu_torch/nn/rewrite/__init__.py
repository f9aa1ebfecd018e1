"""Graph rewrite passes (port of ``deeplearning4j_tpu/nn/rewrite``).

Pattern-match-and-rewrite over ``MultiLayerConfiguration`` /
``ComputationGraphConfiguration`` configs **plus their params**: each
pass returns a numerically equivalent (config, params, state) triple —
except the post-training quantization passes (``quantize.py``), which
trade bounded rounding error for serving capacity and therefore deploy
through the canary gate. Rewrites are in-memory only — serialized
artifacts always store the un-rewritten model.

Entry points: ``Solver``/``GraphSolver`` ``optimize=`` (training-safe
set), ``ModelManager`` / ``ModelMultiplexer.register`` ``optimize=``
(inference set, applied before warmup on every deploy/canary;
``"inference:int8"``/``"inference:fp8"`` adds weight quantization), or
direct ``rewrite_model``.
"""

from .base import (
    RewritePass,
    apply_passes,
    inference_passes,
    quantization_passes,
    resolve_passes,
    rewrite_model,
    rewrite_model_inplace,
    training_passes,
)
from .passes import (
    BatchNormAffinePass,
    ConvBatchNormFoldPass,
    SpaceToDepthStemPass,
)
from .quantize import (
    QuantizedConvolutionLayer,
    QuantizedDenseLayer,
    QuantizedMixtureOfExpertsLayer,
    QuantizedSelfAttentionLayer,
    QuantizedTransformerDecoderBlockLayer,
    QuantizeWeightsPass,
    calibrate,
    count_quantized_layers,
    quantize_weight,
)

__all__ = [
    "BatchNormAffinePass",
    "ConvBatchNormFoldPass",
    "QuantizeWeightsPass",
    "QuantizedConvolutionLayer",
    "QuantizedDenseLayer",
    "QuantizedMixtureOfExpertsLayer",
    "QuantizedSelfAttentionLayer",
    "QuantizedTransformerDecoderBlockLayer",
    "RewritePass",
    "SpaceToDepthStemPass",
    "apply_passes",
    "calibrate",
    "count_quantized_layers",
    "inference_passes",
    "quantization_passes",
    "quantize_weight",
    "resolve_passes",
    "rewrite_model",
    "rewrite_model_inplace",
    "training_passes",
]
