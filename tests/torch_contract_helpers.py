"""Helpers of the port's contract-harness tests (``tests/test_torch_contract_*.py``):
run a JAX harness from ``tools/`` the way its ``tests/test_*_contract.py``
does, run the port's counterpart from ``deeplearning4j_tpu_torch/tools/``,
and compare what both printed.

A harness prints one line per gate as it passes. ``labels`` masks every
number of a line (counts, timings, ports, seeds), so that two runs of the
same gates compare equal; lines that start with two spaces are the port's
measurements (memory, page-in times), not gates, and are dropped.
"""

import importlib
import os
import re
import sys
import threading
import urllib.request
from urllib.error import HTTPError
from urllib.parse import urlsplit

_TOOLS = os.path.join(os.path.dirname(__file__), os.pardir, "tools")
_NUMBER = re.compile(r"\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def jax_harness(name: str):
    """The JAX harness module ``tools/<name>.py``, imported as its tier-1
    test imports it (``tools/`` on ``sys.path`` for the import only)."""
    sys.path.insert(0, _TOOLS)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(_TOOLS)


def port_harness(name: str):
    return importlib.import_module(f"deeplearning4j_tpu_torch.tools.{name}")


def run_jax(name: str, known_races=(), constants=None) -> list:
    """The lines the JAX harness printed in a passing run. ``known_races``
    are substrings of the assertion messages of a race of the reference
    harness itself (its read can land before the state it checks settles;
    the port's harness waits for it): a run that fails with one is run
    once more. Any other failure, or a second one, is raised.
    ``constants`` overrides module constants of the JAX harness for the
    run (a timing that a loaded host cannot keep), and only for it."""
    mod = jax_harness(name)
    saved = {k: getattr(mod, k) for k in (constants or {})}
    try:
        for k, v in (constants or {}).items():
            setattr(mod, k, v)
        for attempt in range(2):
            lines = []
            try:
                assert mod.main(log=lines.append) == 0
                return lines
            except AssertionError as e:
                if attempt or not any(r in str(e) for r in known_races):
                    raise
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
    raise AssertionError("unreachable")


def run_port(name: str, **kw) -> list:
    """The lines the port's harness printed; it must return 0 on the CPU."""
    lines = []
    assert port_harness(name).main(device="cpu", log=lines.append, **kw) == 0
    return lines


def labels(lines) -> list:
    """Each gate line with its numbers masked; measurement lines dropped."""
    return [_NUMBER.sub("#", ln) for ln in lines if not ln.startswith("  ")]


class StatusRecorder:
    """Wraps ``urllib.request.urlopen`` (both packages' harnesses call it)
    and records ``(path, status)`` of every call: the main thread's in
    order, the other threads' apart (their order is the scheduler's)."""

    def __init__(self, monkeypatch) -> None:
        self.main, self.others = [], []
        real = urllib.request.urlopen

        def urlopen(req, *a, **kw):
            url = req if isinstance(req, str) else req.full_url
            path = urlsplit(url).path
            out = self.main if threading.current_thread() is threading.main_thread() \
                else self.others
            try:
                r = real(req, *a, **kw)
            except HTTPError as e:
                out.append((path, e.code))
                raise
            except OSError as e:
                out.append((path, type(e).__name__))
                raise
            out.append((path, r.status))
            return r

        monkeypatch.setattr(urllib.request, "urlopen", urlopen)

    def take(self) -> tuple:
        """(main-thread calls in order, other threads' calls sorted); the
        record starts again empty."""
        got = (list(self.main), sorted(self.others, key=repr))
        self.main.clear()
        self.others.clear()
        return got


def jax_copy(port_net, directory: str, name: str = "net"):
    """The JAX network holding ``port_net``'s weights, through the model
    zip: the port writes it, the JAX package restores it."""
    from deeplearning4j_tpu.model.serializer import restore_model as jax_restore

    from deeplearning4j_tpu_torch.model import write_model

    path = os.path.join(directory, f"{name}.zip")
    write_model(port_net, path)
    return jax_restore(path)
