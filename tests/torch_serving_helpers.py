"""Helpers shared by the port's serving tests: a small feed-forward
network of both packages with the same weights (one float64 softmax
``OutputLayer``, 4 inputs, 3 classes, written by the JAX package and read
back by the port), and HTTP calls with a timeout on each. The JAX package
is imported only by the functions that build its network, so the card's
tests (which run without JAX) can use the HTTP helpers."""

import http.client
import json
import socket
import struct

N_IN, N_OUT = 4, 3
TIMEOUT = 60.0


def jax_ff(seed: int = 3):
    from deeplearning4j_tpu.nn import (Activation as JaxActivation,
                                       LossFunction as JaxLoss,
                                       MultiLayerNetwork as JaxNet,
                                       NeuralNetConfiguration as JaxConf)
    from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOutput

    conf = (JaxConf.builder().seed(seed).data_type("float64").list()
            .layer(JaxOutput(n_in=N_IN, n_out=N_OUT, loss=JaxLoss.MCXENT,
                             activation=JaxActivation.SOFTMAX))
            .build())
    return JaxNet(conf).init()


def ff_pair(tmp_path_factory, seed: int = 3):
    """(JAX network, port network on the CPU) with the same weights."""
    from deeplearning4j_tpu.model.serializer import write_model as jax_write
    from deeplearning4j_tpu_torch.model import restore_multi_layer_network

    jm = jax_ff(seed)
    path = str(tmp_path_factory.mktemp("ff") / "ff.zip")
    jax_write(jm, path)
    return jm, restore_multi_layer_network(path, device="cpu")


def request(port: int, method: str, path: str, body=None, headers=None,
            timeout: float = TIMEOUT):
    """(status, headers dict, parsed body): JSON bodies parsed, anything
    else as text."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        hdrs = dict(resp.getheaders())
    finally:
        conn.close()
    ctype = hdrs.get("Content-Type", "")
    if "json" in ctype and "ndjson" not in ctype:
        return resp.status, hdrs, json.loads(raw)
    if "ndjson" in ctype:
        return resp.status, hdrs, [json.loads(l) for l in raw.splitlines() if l.strip()]
    return resp.status, hdrs, raw.decode(errors="replace")


def post(port, path, body=None, headers=None, timeout: float = TIMEOUT):
    return request(port, "POST", path, body, headers, timeout)


def get(port, path, timeout: float = TIMEOUT):
    return request(port, "GET", path, None, None, timeout)


def generate(port, prompt, path: str = "/v1/generate", timeout: float = TIMEOUT, **kw):
    """The NDJSON events of one streamed ``POST /v1/generate``."""
    status, _, events = post(port, path, dict(kw, prompt=list(prompt)), timeout=timeout)
    assert status == 200, (status, events)
    return events


def tokens(events):
    return [e["token"] for e in events if "token" in e]


def open_stream_and_drop(port, prompt, path: str = "/v1/generate", **kw):
    """Start a streamed generation, read its status line and first event,
    then reset the connection (SO_LINGER 0: the server's next write fails
    at once). Returns (status, first event)."""
    body = json.dumps(dict(kw, prompt=list(prompt))).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    try:
        sock.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     f"Content-Type: application/json\r\n"
                     f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        f = sock.makefile("rb")
        status = int(f.readline().split()[1])
        while f.readline().strip():  # headers
            pass
        first = json.loads(f.readline())
        f.close()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
    finally:
        sock.close()
    return status, first


def metric_series(text: str):
    """{(name, label names)} of a Prometheus text exposition."""
    out = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series = line.rsplit(" ", 1)[0]
        name, _, labels = series.partition("{")
        keys = tuple(sorted(kv.split("=", 1)[0] for kv in labels.rstrip("}").split(",")
                            if kv)) if labels else ()
        out.add((name, keys))
    return out
