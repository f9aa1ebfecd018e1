"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled on first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is then
loaded with ``ctypes``. No PyTorch header is included, so each file builds
in seconds. All sources are compiled at once, one ``nvcc`` process per
file, and each library's name carries a hash of its source (with the
``csrc/*.cuh`` headers it includes) and flags, so a changed source or
header is rebuilt and an unchanged one is loaded as it is.

Libraries go to ``deeplearning4j_tpu_torch/_build/`` (listed in
``.gitignore``). Nothing is imported or compiled when this module is
imported: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library built
#: by this process, by source stem
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                           "use and need the CUDA toolkit")
    return found


_LOCAL_INCLUDE = re.compile(r'^#include "([^"]+)"[^\n]*$', re.M)


def source_text(src: Path) -> str:
    """The text of a kernel source with its local ``#include "..."``
    headers (files under ``csrc/``) written out in place, each once: what
    the library's hash covers, so that editing a shared header rebuilds
    every source that includes it."""
    seen = set()

    def expand(path: Path) -> str:
        def sub(m):
            inc = path.parent / m.group(1)
            if inc in seen:
                return ""
            seen.add(inc)
            return expand(inc)
        return _LOCAL_INCLUDE.sub(sub, path.read_text())
    return expand(src)


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256((source_text(src) + " ".join(NVCC_FLAGS)).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every kernel source that has no up-to-date library (all
    ``nvcc`` processes run concurrently), then load them all. Returns
    ``{source stem: CDLL}``. Raises with the compiler's output on failure."""
    with _lock:
        sources = sorted(CSRC.glob("*.cu"))
        todo = {s: _lib_path(s) for s in sources
                if s.stem not in _libs and not _lib_path(s).is_file()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for src, out in todo.items():
                tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True),
                              tmp, out)
            failed = []
            for src, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                build_logs[src.stem] = log
                if proc.returncode != 0:
                    failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, out)
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for src in sources:
            if src.stem not in _libs:
                _libs[src.stem] = ctypes.CDLL(str(_lib_path(src)))
        return dict(_libs)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on demand)."""
    lib = _libs.get(stem)
    if lib is None:
        lib = build_all()[stem]
    return lib
