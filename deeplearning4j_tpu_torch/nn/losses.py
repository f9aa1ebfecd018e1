"""Loss functions (port of ``deeplearning4j_tpu/nn/losses.py``).

Parity with the reference's ``org.nd4j.linalg.lossfunctions.LossFunctions``:
per-example score arrays, an optional per-output ``weights`` vector, an
optional mask ([batch] after the caller flattens time into batch), a mean
over the unmasked examples. Softmax + MCXENT and sigmoid + XENT compute from
pre-activations (log-softmax, logits) for numerical stability; the loss
math runs in at least float32.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from .activations import Activation

_EPS = 1e-7


def _apply_mask_and_mean(per_example: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        mask = mask.reshape(per_example.shape[0]).to(per_example.dtype)
        per_example = per_example * mask
        denom = torch.clamp_min(torch.sum(mask), 1.0)
        return torch.sum(per_example) / denom
    return torch.mean(per_example)


class LossFunction(enum.Enum):
    MSE = "MSE"
    L1 = "L1"
    L2 = "L2"
    XENT = "XENT"
    MCXENT = "MCXENT"
    SPARSE_MCXENT = "SPARSE_MCXENT"
    NEGATIVELOGLIKELIHOOD = "NEGATIVELOGLIKELIHOOD"
    COSINE_PROXIMITY = "COSINE_PROXIMITY"
    HINGE = "HINGE"
    SQUARED_HINGE = "SQUARED_HINGE"
    KL_DIVERGENCE = "KL_DIVERGENCE"
    MEAN_ABSOLUTE_ERROR = "MEAN_ABSOLUTE_ERROR"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "MEAN_ABSOLUTE_PERCENTAGE_ERROR"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "MEAN_SQUARED_LOGARITHMIC_ERROR"
    POISSON = "POISSON"
    WASSERSTEIN = "WASSERSTEIN"

    @classmethod
    def from_any(cls, l) -> "LossFunction":
        if isinstance(l, LossFunction):
            return l
        return cls[str(l).upper()]

    def score_array(self, labels: torch.Tensor, preoutput: torch.Tensor,
                    activation: Activation,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-example scores, shape [batch]. ``preoutput`` is pre-activation."""
        return _score_array(self, labels, preoutput, activation, weights)

    def score(self, labels: torch.Tensor, preoutput: torch.Tensor,
              activation: Activation, mask: Optional[torch.Tensor] = None,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        per = self.score_array(labels, preoutput, activation, weights)
        return _apply_mask_and_mean(per, mask)


def _score_array(kind: LossFunction, labels: torch.Tensor, pre: torch.Tensor,
                 activation: Activation,
                 weights: Optional[torch.Tensor]) -> torch.Tensor:
    act = Activation.from_any(activation)
    # loss math in >= f32 regardless of compute dtype
    f32 = torch.promote_types(pre.dtype, torch.float32)
    pre = pre.to(f32)
    if labels.is_floating_point():
        labels = labels.to(f32)

    def logp_of(x):
        if act is Activation.SOFTMAX:
            return torch.log_softmax(x, dim=-1)
        return torch.log(torch.clamp(act(x), _EPS, 1.0))

    if kind in (LossFunction.MCXENT, LossFunction.NEGATIVELOGLIKELIHOOD):
        per = -labels * logp_of(pre)
        if weights is not None:
            per = per * weights
        return torch.sum(per, dim=tuple(range(1, per.ndim)))
    if kind is LossFunction.SPARSE_MCXENT:
        logp = logp_of(pre)
        idx = labels.long()
        if idx.ndim == logp.ndim:  # [batch, 1] -> [batch]
            idx = idx.squeeze(-1)
        return -torch.gather(logp, -1, idx[..., None]).squeeze(-1)

    def sum_last(a):
        return torch.sum(a, dim=tuple(range(1, a.ndim)))

    def weighted(err):
        return err * weights if weights is not None else err

    if kind is LossFunction.XENT:
        if act is Activation.SIGMOID:
            # stable BCE-with-logits
            per = (torch.clamp_min(pre, 0) - pre * labels
                   + torch.log1p(torch.exp(-torch.abs(pre))))
        else:
            p = torch.clamp(act(pre), _EPS, 1.0 - _EPS)
            per = -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))
        return sum_last(weighted(per))

    out = act(pre)
    n = out.shape[-1]
    if kind is LossFunction.MSE:
        return sum_last(weighted((out - labels) ** 2)) / n
    if kind is LossFunction.L2:
        return sum_last(weighted((out - labels) ** 2))
    if kind is LossFunction.MEAN_ABSOLUTE_ERROR:
        return sum_last(weighted(torch.abs(out - labels))) / n
    if kind is LossFunction.L1:
        return sum_last(weighted(torch.abs(out - labels)))
    if kind is LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR:
        pct = torch.abs((labels - out) / torch.clamp_min(torch.abs(labels), _EPS)) * 100.0
        return sum_last(weighted(pct)) / n
    if kind is LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR:
        per = (torch.log1p(torch.clamp_min(out, -1 + _EPS))
               - torch.log1p(torch.clamp_min(labels, -1 + _EPS))) ** 2
        return sum_last(weighted(per)) / n
    if kind is LossFunction.COSINE_PROXIMITY:
        on = out / torch.clamp_min(torch.linalg.vector_norm(out, dim=-1, keepdim=True), _EPS)
        ln = labels / torch.clamp_min(torch.linalg.vector_norm(labels, dim=-1, keepdim=True),
                                      _EPS)
        return -sum_last(on * ln)
    if kind is LossFunction.HINGE:
        return sum_last(weighted(torch.clamp_min(1.0 - labels * out, 0.0)))
    if kind is LossFunction.SQUARED_HINGE:
        return sum_last(weighted(torch.clamp_min(1.0 - labels * out, 0.0) ** 2))
    if kind is LossFunction.KL_DIVERGENCE:
        p = torch.clamp(labels, _EPS, 1.0)
        q = torch.clamp(out, _EPS, 1.0)
        return sum_last(weighted(p * (torch.log(p) - torch.log(q))))
    if kind is LossFunction.POISSON:
        return sum_last(weighted(out - labels * torch.log(torch.clamp_min(out, _EPS))))
    if kind is LossFunction.WASSERSTEIN:
        return sum_last(weighted(labels * out))
    raise ValueError(f"Unhandled loss {kind}")
