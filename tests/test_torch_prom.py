"""The port's Prometheus exposition (``obs/prom.py``) against the JAX
package's: registries of both packages take the same sequence of metric
operations and must render byte-equal 0.0.4 text; so must the MoE routing
series ``obs/listener.py`` records from a layer state. Label values and HELP
text carry the characters the format escapes (backslash, double quote,
newline), values the special spellings (+Inf, -Inf, NaN, integral floats,
large and fractional floats). Tolerance: none, the bytes are equal."""

import math
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.obs.listener import MoEMetricsListener as JaxMoEListener
from deeplearning4j_tpu.obs.listener import record_moe_metrics as jax_record_moe
from deeplearning4j_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from deeplearning4j_tpu.obs.prom import render_prometheus as jax_render

from deeplearning4j_tpu_torch.obs import (MetricsRegistry, MoEMetricsListener,
                                          record_moe_metrics, render_prometheus)
from deeplearning4j_tpu_torch.obs import prom


def _drive(reg, label: str, help_text: str, value: float) -> None:
    """One script of registry operations: every metric type, labelled and
    not, with ``label`` as a label value and ``help_text`` as HELP."""
    c = reg.counter("dl4j_tpu_test_requests_total", help_text, ("instance", "code"))
    c.labels(label, "200").inc()
    c.labels(label, "503").inc(3)
    c.labels("plain", "200").inc(2.5)
    g = reg.gauge("dl4j_tpu_test_queue_depth", "Queue depth", ("instance",))
    g.labels(label).set(value)
    g.labels("other").inc(4)
    g.labels("other").dec()
    g.labels("peak").set_max(7)
    g.labels("peak").set_max(5)
    reg.gauge("dl4j_tpu_test_unlabelled", "").set(1e20)
    h = reg.histogram("dl4j_tpu_test_latency_seconds", help_text, ("instance",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.005, 0.05, 0.5, 5.0):
        h.labels(label).observe(v)
    d = reg.histogram("dl4j_tpu_test_default_buckets_seconds", "default buckets")
    d.observe(0.25)
    d.observe(value if math.isfinite(value) else 0.0)


@pytest.mark.parametrize("label", [
    "server-0", 'quote " inside', "back\\slash", "new\nline", 'all \\ " \n three', ""])
@pytest.mark.parametrize("help_text", ["Plain help", "back\\slash help", "two\nlines"])
def test_render_is_byte_equal_to_jax(label, help_text):
    jreg, preg = JaxRegistry(), MetricsRegistry()
    _drive(jreg, label, help_text, 2.0)
    _drive(preg, label, help_text, 2.0)
    got = render_prometheus(preg)
    assert got == jax_render(jreg)
    assert preg.render() == got
    assert got.endswith("\n")


@pytest.mark.parametrize("value", [
    0.0, 3.0, -2.0, 1e15, 1e16, 0.1, 1.0 / 3.0, float("inf"), float("-inf"), float("nan")])
def test_values_render_like_jax(value):
    jreg, preg = JaxRegistry(), MetricsRegistry()
    _drive(jreg, "v", "values", value)
    _drive(preg, "v", "values", value)
    assert render_prometheus(preg) == jax_render(jreg)


def test_escapes_and_content_type():
    assert prom.escape_label_value('a\\b"c\nd') == 'a\\\\b\\"c\\nd'
    assert prom.escape_help('a\\b"c\nd') == 'a\\\\b"c\\nd'
    assert prom.CONTENT_TYPE == "text/plain; version=0.0.4; charset=utf-8"
    assert MetricsRegistry().render() == "\n"  # an empty registry


def _moe_state(as_tensor):
    conv = (lambda a: torch.tensor(a)) if as_tensor else np.asarray
    return {"layer_0": {"expert_tokens": conv(np.array([5.0, 0.0, 3.0, 8.0], np.float32)),
                        "dropped_tokens": conv(np.float32(2.0)),
                        "capacity_slots": conv(np.float32(24.0))},
            "layer_1": {"W": conv(np.zeros(2, np.float32))}}


def test_moe_metrics_render_like_jax():
    """The MoE routing series from a state of torch tensors (the port's MoE
    layer state) against the JAX package's from the same values."""
    jreg, preg = JaxRegistry(), MetricsRegistry()
    assert jax_record_moe(_moe_state(False), jreg) == 1
    assert record_moe_metrics(_moe_state(True), preg) == 1
    model = types.SimpleNamespace(state=_moe_state(True))
    JaxMoEListener(jreg).iteration_done(types.SimpleNamespace(state=_moe_state(False)),
                                        1, 0, float("nan"))
    MoEMetricsListener(preg).iteration_done(model, 1, 0, float("nan"))
    assert render_prometheus(preg) == jax_render(jreg)
    assert preg.get("dl4j_tpu_moe_dropped_tokens_total").labels("layer_0").value == 4.0
