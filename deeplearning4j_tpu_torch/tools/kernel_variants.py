"""Helpers for timing design alternatives of a kernel source against the
source as it is: text substitutions of ``csrc/<stem>.cu`` (with its local
headers written out in place, so a substitution may reach a shared helper),
each built by its own ``nvcc`` with the package's flags, all at once, into
``_build/variants/``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_build


def variant_sources(stem: str, variants: Dict[str, List[Tuple[str, str]]],
                    only: Sequence[str] = (), against: Sequence[str] = ()) -> Dict[str, str]:
    """``{"as it is": text, name: substituted text, ...}``, of the variants
    named in ``only`` if it names any, then the source of each checkout
    root in ``against`` under its path (a parent built beside its change);
    raises if a variant's text is no longer in the source, or ``only``
    names no variant."""
    unknown = set(only) - set(variants)
    if unknown:
        raise SystemExit(f"no such variant: {sorted(unknown)}; known: {sorted(variants)}")
    base = cuda_build.source_text(cuda_build.CSRC / f"{stem}.cu")
    sources = {"as it is": base}
    for name, subs in variants.items():
        if only and name not in only:
            continue
        text = base
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name!r}: the source no longer has {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    for tree in against:
        sources[tree] = cuda_build.source_text(
            Path(tree) / "deeplearning4j_tpu_torch" / "csrc" / f"{stem}.cu")
    return sources


def _entry_stats(log: str) -> List[Tuple[str, str]]:
    """``[(kernel, "N registers, S B spilled"), ...]`` from a ptxas log,
    each kernel named by its function and template arguments (the element
    type and the integers)."""
    out, fn, spill = [], None, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = line.split("'")[1]
            base = re.search(r"\d((?:flash|grouped)_[a-z0-9_]*?_kernel)I", m)
            dtype = next((t for k, t in (("If", "float"), ("Id", "double"), ("bfloat16", "bf16"),
                                         ("__half", "f16")) if k in m), "")
            args = ",".join(x for x in [dtype] + re.findall(r"Li(\d+)E", m) if x)
            fn = f"{base.group(1) if base else m}<{args}>"
        elif fn and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((fn, f"{regs} registers, {spill} B spilled"))
            fn, spill = None, "?"
    return out


def build(tag: str, sources: Dict[str, str], symbols: Dict[str, list],
          focus: str = "tf32") -> Dict[str, ctypes.CDLL]:
    """``{name: CDLL}``, each source compiled by its own nvcc, all at once;
    prints the registers and spills ptxas reports, and each kernel's whose
    name holds ``focus``. ``symbols`` gives each C function's argument
    types (every function returns an int)."""
    out_dir = cuda_build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, lib = out_dir / f"{tag}{i}.cu", out_dir / f"lib{tag}{i}.so"
        src.write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = sorted({int(n) for n in re.findall(r"(\d+) bytes spill stores", log)} - {0})
        print(f"{tag} {name}: registers a thread {regs}, spill stores {spills} B")
        for fn, stat in _entry_stats(log):
            if focus in fn:
                print(f"  {tag} {name}: {fn}: {stat}")
        lib_ = ctypes.CDLL(str(lib))
        for symbol, argtypes in symbols.items():
            fn = getattr(lib_, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib_
    return libs


def ms(fn, iters: int = 10) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events (for kernels that take far longer than the host needs to issue
    them)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 100, reps: int = 3) -> float:
    """Mean device milliseconds a call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events. The card
    runs the captured kernels back to back without the host, so a kernel
    that takes a few microseconds, less than the host needs to issue it, is
    timed alone (with the card's own gap between graph nodes). ``fn`` must
    launch on the current stream, read when it is called."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def kernel_ms(fn, kernel: str, calls: int = 100) -> tuple:
    """``(mean ms, launches seen)`` of the CUDA kernels whose name holds
    ``kernel``, from ``torch.profiler`` over ``calls`` calls of ``fn``: the
    time of each launch alone, without the gaps between them."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in rows)
    return (sum(e.self_device_time_total for e in rows) / 1e3 / n if n else float("nan")), n


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
