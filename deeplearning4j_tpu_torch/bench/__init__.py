"""Benchmark support: model-FLOPs accounting and card peak rates for MFU
(port of ``deeplearning4j_tpu/bench``).

MFU (model FLOPs utilization) = achieved model FLOPs/sec divided by the
card's peak FLOPs/sec for the dtype its products run in.
"""

from .flops import bert_train_flops_per_token, resnet50_train_flops_per_example
from .peak import chip_peak_flops

__all__ = [
    "bert_train_flops_per_token",
    "chip_peak_flops",
    "resnet50_train_flops_per_example",
]
