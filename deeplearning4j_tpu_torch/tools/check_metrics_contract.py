#!/usr/bin/env python
"""Metrics exposition contract of the port: the counterpart of the JAX
package's ``tools/check_metrics_contract.py``, with its gates in its order.

Boots a ``JsonModelServer``, drives success/malformed/deadline traffic,
scrapes ``GET /metrics``, and validates from the OUTSIDE (with its own
parser, a copy of the JAX harness's, not the renderer's code paths) that
the body is well-formed Prometheus text exposition 0.0.4 and that the
contract series exist:

  * request counters by status code + request-latency histogram
  * inference outcome counters (accepted/shed/timed-out/failed) and
    queue depth
  * circuit-breaker state gauge
  * forward-latency histogram

Grammar checks: every sample line parses, every sample belongs to a
TYPE-declared family, label names/escapes are legal, histogram buckets
are cumulative and non-decreasing, the ``+Inf`` bucket equals ``_count``,
and ``_sum`` is present. Also scrapes a ``UIServer`` ``/metrics`` to prove
the training-dashboard process is scrapeable from the same registry.

The client reads every answer whole (an LM's is ~1 MB of JSON: closing the
connection early breaks the server's write, which it counts as a 500).
The server records a request's status-code counter and latency in its
handler after the response is written, so a client can hold its answer
before the server has counted it. The scrape therefore waits (bounded)
until the server has counted all four requests it was sent, then holds
every gate on that scrape: the counts stay exact.

Run ``python -m deeplearning4j_tpu_torch.tools.check_metrics_contract
[--device cpu] [--model tiny|lm]``: on the card unless ``--device`` says
otherwise; ``lm`` serves the GPT-2-small-width ``TransformerLM`` (B1 in
every block). It prints each gate as it passes and exits non-zero on the
first that fails.
"""

from __future__ import annotations

import json
import math
import re
import sys
import time
from urllib import request as urllib_request
from urllib.error import HTTPError

from deeplearning4j_tpu_torch.tools.contract_common import (ServingWorkload, cli,
                                                             serving_model)

_METRIC = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL = r"[a-zA-Z_][a-zA-Z0-9_]*"
# label value: any escaped char or anything except backslash/quote/newline
_VALUE = r'"(?:\\.|[^"\\\n])*"'
_SAMPLE_RE = re.compile(
    rf"^({_METRIC})"
    rf"(?:\{{({_LABEL}={_VALUE}(?:,{_LABEL}={_VALUE})*)?\}})?"
    rf" ([^ ]+)(?: (-?[0-9]+))?$")
_LABEL_RE = re.compile(rf"({_LABEL})=({_VALUE})")


def _parse_number(tok: str) -> float:
    if tok == "+Inf":
        return math.inf
    if tok == "-Inf":
        return -math.inf
    if tok == "NaN":
        return math.nan
    return float(tok)  # raises on garbage -> caller reports the line


def _unescape(quoted: str) -> str:
    body = quoted[1:-1]
    return (body.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_exposition(text: str):
    """Validate 0.0.4 grammar; return {family: {"type": t, "samples":
    [(name, labels_dict, value)]}}. Raises AssertionError with the
    offending line on any violation."""
    assert text.endswith("\n"), "exposition must end with a newline"
    families = {}
    seen_help, seen_type = set(), set()

    def family_of(sample_name: str):
        for fam, info in families.items():
            if sample_name == fam:
                return fam
            if info["type"] == "histogram" and sample_name in (
                    f"{fam}_bucket", f"{fam}_sum", f"{fam}_count"):
                return fam
        return None

    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            assert len(parts) >= 3 and re.fullmatch(_METRIC, parts[2]), line
            assert parts[2] not in seen_help, f"duplicate HELP: {line}"
            seen_help.add(parts[2])
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            assert len(parts) == 4, line
            _, _, name, typ = parts
            assert re.fullmatch(_METRIC, name), line
            assert typ in ("counter", "gauge", "histogram", "summary",
                           "untyped"), line
            assert name not in seen_type, f"duplicate TYPE: {line}"
            seen_type.add(name)
            families[name] = {"type": typ, "samples": []}
            continue
        assert not line.startswith("#"), f"unknown comment: {line}"
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable sample line: {line!r}"
        name, labelstr, valtok = m.group(1), m.group(2), m.group(3)
        value = _parse_number(valtok)
        labels = {}
        if labelstr:
            for lm in _LABEL_RE.finditer(labelstr):
                lname, lval = lm.group(1), _unescape(lm.group(2))
                assert lname not in labels, f"duplicate label {lname}: {line}"
                labels[lname] = lval
        fam = family_of(name)
        assert fam is not None, f"sample {name} has no TYPE declaration"
        families[fam]["samples"].append((name, labels, value))
    return families


def check_histograms(families) -> int:
    """Bucket cumulativity + _sum/_count consistency for every histogram
    child. Returns the number of children checked."""
    checked = 0
    for fam, info in families.items():
        if info["type"] != "histogram":
            continue
        children = {}
        for name, labels, value in info["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            child = children.setdefault(key, {"buckets": [], "sum": None,
                                              "count": None})
            if name == f"{fam}_bucket":
                assert "le" in labels, f"{fam} bucket without le"
                child["buckets"].append((_parse_number(labels["le"]), value))
            elif name == f"{fam}_sum":
                child["sum"] = value
            elif name == f"{fam}_count":
                child["count"] = value
        for key, child in children.items():
            assert child["sum"] is not None, f"{fam}{key}: missing _sum"
            assert child["count"] is not None, f"{fam}{key}: missing _count"
            buckets = child["buckets"]
            assert buckets, f"{fam}{key}: no buckets"
            les = [le for le, _ in buckets]
            assert les == sorted(les), f"{fam}{key}: le not sorted"
            counts = [c for _, c in buckets]
            assert counts == sorted(counts), \
                f"{fam}{key}: buckets not cumulative: {counts}"
            assert math.isinf(les[-1]), f"{fam}{key}: missing +Inf bucket"
            assert counts[-1] == child["count"], \
                f"{fam}{key}: +Inf bucket {counts[-1]} != _count {child['count']}"
            checked += 1
    return checked


# The scrape contract: these series must exist on a fresh server (all
# outcome children are pre-created at 0) — a rename is a breaking change
# for every dashboard and alert downstream, so it fails tier-1.
CONTRACT = {
    "dl4j_tpu_serving_requests_total": "counter",
    "dl4j_tpu_serving_request_latency_seconds": "histogram",
    "dl4j_tpu_inference_requests_total": "counter",
    "dl4j_tpu_inference_queue_depth": "gauge",
    "dl4j_tpu_inference_forward_latency_seconds": "histogram",
    "dl4j_tpu_resilience_circuit_state": "gauge",
    "dl4j_tpu_resilience_admission_decisions_total": "counter",
}
CONTRACT_OUTCOMES = ("accepted", "shed", "timed_out", "failed")


def _get(port, path, timeout=10):
    with urllib_request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, r.headers, r.read().decode()


def _requests_counted(text: str) -> float:
    """The request-latency histogram's ``_count`` in an exposition (0 when
    absent): how many requests the server has finished recording."""
    for line in text.splitlines():
        if line.startswith("dl4j_tpu_serving_request_latency_seconds_count"):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def scrape_after(port, n_requests: int, timeout: float = 10.0):
    """``GET /metrics`` once the server has recorded ``n_requests``
    requests (or ``timeout`` seconds have passed): (status, headers, text)."""
    end = time.monotonic() + timeout
    while True:
        code, headers, text = _get(port, "/metrics")
        if _requests_counted(text) >= n_requests or time.monotonic() > end:
            return code, headers, text
        time.sleep(0.01)


def main(device: str = "cuda", model="tiny", log=print) -> int:
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.remote import JsonModelServer
    from deeplearning4j_tpu_torch.ui import UIServer

    w = ServingWorkload(serving_model(model, device))
    registry = MetricsRegistry()  # hermetic: injected, not the global
    srv = JsonModelServer(w.model, port=0, workers=1,
                          registry=registry, name="contract").start()
    port = srv.port
    try:
        # drive: 2 successes, 1 malformed (400), 1 deadline (504)
        body = json.dumps({"data": w.ok}).encode()
        for _ in range(2):
            req = urllib_request.Request(
                f"http://127.0.0.1:{port}/v1/serving", data=body,
                headers={"Content-Type": "application/json"})
            with urllib_request.urlopen(req, timeout=10) as r:
                assert r.status == 200
                r.read()  # the whole answer: an LM's is ~1 MB of JSON
        try:
            req = urllib_request.Request(
                f"http://127.0.0.1:{port}/v1/serving", data=b"{]",
                headers={"Content-Type": "application/json"})
            urllib_request.urlopen(req, timeout=10)
            raise AssertionError("malformed input did not 400")
        except HTTPError as e:
            assert e.code == 400, e.code
        try:
            req = urllib_request.Request(
                f"http://127.0.0.1:{port}/v1/serving",
                data=json.dumps({"data": w.ok, "deadline_ms": 0.001}).encode(),
                headers={"Content-Type": "application/json"})
            urllib_request.urlopen(req, timeout=10)
            raise AssertionError("expired deadline did not 504")
        except HTTPError as e:
            assert e.code == 504, e.code
        log("PASS drove 200/400/504 traffic")

        code, headers, text = scrape_after(port, 4)
        assert code == 200
        ctype = headers.get("Content-Type", "")
        assert "version=0.0.4" in ctype, f"bad content type: {ctype}"
        families = parse_exposition(text)
        n_hist = check_histograms(families)
        log(f"PASS grammar: {sum(len(f['samples']) for f in families.values())}"
            f" samples, {len(families)} families, {n_hist} histogram children")

        for name, typ in CONTRACT.items():
            assert name in families, f"missing contract metric {name}"
            assert families[name]["type"] == typ, \
                f"{name}: type {families[name]['type']} != {typ}"
        outcomes = {l.get("outcome")
                    for _, l, _ in
                    families["dl4j_tpu_inference_requests_total"]["samples"]}
        missing = set(CONTRACT_OUTCOMES) - outcomes
        assert not missing, f"missing outcome series: {sorted(missing)}"
        served = {(l.get("code"), v) for _, l, v in
                  families["dl4j_tpu_serving_requests_total"]["samples"]}
        assert ("200", 2.0) in served, f"code=200 count wrong: {served}"
        assert ("400", 1.0) in served, f"code=400 count wrong: {served}"
        assert ("504", 1.0) in served, f"code=504 count wrong: {served}"
        lat = families["dl4j_tpu_serving_request_latency_seconds"]["samples"]
        count = [v for n, _, v in lat if n.endswith("_count")]
        assert count and count[0] == 4.0, f"latency _count != 4: {count}"
        circuit = families["dl4j_tpu_resilience_circuit_state"]["samples"]
        assert circuit and circuit[0][2] == 0.0, f"circuit not closed: {circuit}"
        log("PASS contract series present with expected values")

        # the training dashboard process is scrapeable from the same
        # registry shape (ui/server.py GET /metrics)
        ui = UIServer(port=0, registry=registry).start()
        try:
            ucode, uheaders, utext = _get(ui.port, "/metrics")
            assert ucode == 200 and "version=0.0.4" in \
                uheaders.get("Content-Type", "")
            ufams = parse_exposition(utext)
            assert "dl4j_tpu_serving_requests_total" in ufams
            log("PASS UIServer /metrics scrapeable")
        finally:
            ui.stop()
    finally:
        srv.stop()
    log("metrics contract OK")
    return 0


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
