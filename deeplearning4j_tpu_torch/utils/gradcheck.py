"""Numerical gradient checking harness (port of
``deeplearning4j_tpu/utils/gradcheck.py``).

Reference: org.nd4j.autodiff.validation.GradCheckUtil and the DL4J
gradientcheck test family: central-difference numerical gradients in
float64 compared against analytic gradients for whole small networks.

Usage mirrors the reference: build a tiny net in double precision on the
CPU, ``check_gradients(model, features, labels)`` perturbs every parameter
(or a random subset) by ±eps and compares.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.dtypes import as_input

DEFAULT_EPS = 1e-6
DEFAULT_MAX_REL_ERROR = 1e-5
DEFAULT_MIN_ABS_ERROR = 1e-8


def check_gradients(
    model,
    features,
    labels,
    *,
    mask=None,
    label_mask=None,
    eps: float = DEFAULT_EPS,
    max_rel_error: float = DEFAULT_MAX_REL_ERROR,
    min_abs_error: float = DEFAULT_MIN_ABS_ERROR,
    subset: Optional[int] = None,
    seed: int = 12345,
    print_results: bool = False,
) -> bool:
    """Central-difference gradient check of a MultiLayerNetwork.

    Requires the model built with dtype float64, exactly like the reference
    requires DataType.DOUBLE for gradient checks. The parameters are
    perturbed in place, one at a time, and restored."""
    if model.dtype != torch.float64:
        raise ValueError(
            "Gradient checks require dtype=float64 (reference: DataType.DOUBLE); "
            f"model dtype is {model.dtype}")

    analytic = model.calculate_gradients(features, labels, mask=mask, label_mask=label_mask)
    params = model.params
    # (param tensor, its analytic gradient) in the flat ravel_pytree order
    slots = [(params[l][p], analytic[l][p]) for l, p in model._ravel_order()]
    starts = np.cumsum([0] + [t.numel() for t, _ in slots])
    flat_grads = np.concatenate([g.detach().reshape(-1).cpu().numpy() for _, g in slots]
                                ) if slots else np.zeros(0)
    n = int(starts[-1])

    x = model._input(features)
    y = as_input(labels, model.dtype, True, model.device)
    m, lm = model._mask(mask), model._mask(label_mask)

    def score() -> float:
        with torch.no_grad():
            s, _ = model.loss_pure(params, model.state, x, y, rng=None, mask=m,
                                   label_mask=lm, train=True)
        return float(s)

    if subset is not None and subset < n:
        indices = np.random.default_rng(seed).choice(n, size=subset, replace=False)
    else:
        indices = np.arange(n)

    n_fail = 0
    max_err = 0.0
    for idx in indices:
        slot = int(np.searchsorted(starts, idx, side="right")) - 1
        view = slots[slot][0].data.view(-1)
        off = int(idx - starts[slot])
        orig = float(view[off])
        view[off] = orig + eps
        s_plus = score()
        view[off] = orig - eps
        s_minus = score()
        view[off] = orig
        numeric = (s_plus - s_minus) / (2 * eps)
        a = float(flat_grads[idx])
        abs_err = abs(numeric - a)
        denom = max(abs(numeric), abs(a))
        rel_err = abs_err / denom if denom > 0 else 0.0
        ok = rel_err <= max_rel_error or abs_err <= min_abs_error
        max_err = max(max_err, rel_err if denom > 0 else 0.0)
        if not ok:
            n_fail += 1
            if print_results:
                print(f"  FAIL idx={idx}: analytic={a:.10g} numeric={numeric:.10g} "
                      f"rel={rel_err:.3g}")
    if print_results:
        print(f"gradcheck: {len(indices) - n_fail}/{len(indices)} passed, max rel err {max_err:.3g}")
    return n_fail == 0
