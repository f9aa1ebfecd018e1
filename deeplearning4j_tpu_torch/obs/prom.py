"""Prometheus text exposition, format version 0.0.4.

Renders a :class:`~deeplearning4j_tpu_torch.obs.metrics.MetricsRegistry` into the
plain-text scrape format every Prometheus-compatible collector understands
(https://prometheus.io/docs/instrumenting/exposition_formats/):

    # HELP dl4j_tpu_serving_requests_total HTTP requests by status code
    # TYPE dl4j_tpu_serving_requests_total counter
    dl4j_tpu_serving_requests_total{code="200",instance="server-0"} 42

Histograms expand into cumulative ``_bucket`` series (``le`` label, last
bucket ``+Inf`` equal to ``_count``), plus ``_sum`` and ``_count``. Label
values escape backslash, double-quote and newline; HELP text escapes
backslash and newline — exactly the 0.0.4 rules. A copy of
``deeplearning4j_tpu/obs/prom.py`` (it uses no framework): the same
registry operations render to the same bytes in both packages.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

# What a scraper must be told; version pins the exposition grammar.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    return (text.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def format_value(value: float) -> str:
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labels(names: Tuple[str, ...], values: Tuple[str, ...],
            extra: Iterable[Tuple[str, str]] = ()) -> str:
    pairs = [f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)]
    pairs.extend(f'{n}="{escape_label_value(v)}"' for n, v in extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry) -> str:
    """Render every family in ``registry`` (sorted by name, children sorted
    by label values) as 0.0.4 text. Ends with a trailing newline, as the
    format requires."""
    lines = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.typ}")
        names = fam.labelnames
        for values, child in fam.items():
            if fam.typ == "histogram":
                for le, cum in child.buckets():
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labels(names, values, [('le', format_value(le))])}"
                        f" {cum}")
                lines.append(
                    f"{fam.name}_sum{_labels(names, values)}"
                    f" {format_value(child.sum)}")
                lines.append(
                    f"{fam.name}_count{_labels(names, values)} {child.count}")
            else:
                lines.append(
                    f"{fam.name}{_labels(names, values)}"
                    f" {format_value(child.value)}")
    return "\n".join(lines) + "\n"
