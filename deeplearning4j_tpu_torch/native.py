"""ctypes bindings for libdl4jtpu (native/dl4jtpu_native.cpp), the port's
own copy of ``deeplearning4j_tpu/native.py``.

The host library is shared source: both packages bind the same C file in
``native/``, which lies outside either package. The port keeps the JAX
package's binding as it is — the same functions, the same pure-NumPy
fallbacks, :func:`available` reporting which path is active, and
``DL4J_TPU_DISABLE_NATIVE=1`` forcing the fallback (the reference's
"helpers allowed" knob, SURVEY.md §5.6). Only the build differs: on first
use, when no library is found, the loader compiles ``native/dl4jtpu_native.cpp``
with ``g++`` (no cmake needed) into the git-ignored
``deeplearning4j_tpu_torch/_build/``; a library that ``native/build.sh`` left
in ``native/build/`` is used as well. ``DL4J_TPU_AUTOBUILD=0`` skips the
build.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_log = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
_SOURCE = os.path.join(_REPO_ROOT, "native", "dl4jtpu_native.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATHS = [
    os.path.join(_BUILD_DIR, "libdl4jtpu.so"),
    os.path.join(_REPO_ROOT, "native", "build", "libdl4jtpu.so"),
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _try_build() -> None:
    """Compile the host library into ``_build/`` (atomically: a temporary
    file renamed onto the target, so a concurrent loader never sees half a
    library)."""
    if not os.path.exists(_SOURCE):
        return
    if os.environ.get("DL4J_TPU_AUTOBUILD", "1") == "0":
        _log.info("libdl4jtpu not built and DL4J_TPU_AUTOBUILD=0; "
                  "using NumPy fallbacks")
        return
    _log.warning("libdl4jtpu not found; compiling %s with g++ (set "
                 "DL4J_TPU_AUTOBUILD=0 to skip)", _SOURCE)
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, prefix=".tmp-", suffix=".so")
        os.close(fd)
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++14", "-o", tmp, _SOURCE],
            capture_output=True, timeout=120, check=False, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            _log.warning("native build failed (rc=%d), using NumPy "
                         "fallbacks:\n%s", proc.returncode,
                         (proc.stderr or "")[-2000:])
            return
        os.replace(tmp, _LIB_PATHS[0])
    except Exception as e:
        _log.warning("native build errored (%s), using NumPy fallbacks", e)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    # Lock-free fast path once the load decision is final — codec calls run
    # per gradient-sync step / per image and must not serialize on a mutex.
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        try:
            if os.environ.get("DL4J_TPU_DISABLE_NATIVE") == "1":
                return None
            for attempt in range(2):
                for p in _LIB_PATHS:
                    if os.path.exists(p):
                        try:
                            lib = ctypes.CDLL(p)
                        except OSError:
                            continue
                        _declare(lib)
                        _lib = lib
                        return _lib
                if attempt == 0:
                    _try_build()
            return None
        finally:
            # only now is the decision final — setting _tried earlier would
            # let lock-free readers fall back mid-load/build
            _tried = True


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.dl4j_threshold_encode.restype = c.c_int64
    lib.dl4j_threshold_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_float, c.POINTER(c.c_int32),
        c.c_int64]
    lib.dl4j_threshold_decode.restype = None
    lib.dl4j_threshold_decode.argtypes = [
        c.POINTER(c.c_int32), c.c_int64, c.c_float, c.POINTER(c.c_float),
        c.c_int64]
    lib.dl4j_bitmap_encode.restype = c.c_int64
    lib.dl4j_bitmap_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_float, c.POINTER(c.c_uint8)]
    lib.dl4j_bitmap_decode.restype = None
    lib.dl4j_bitmap_decode.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, c.c_float, c.POINTER(c.c_float)]
    lib.dl4j_parse_csv_f32.restype = c.c_int32
    lib.dl4j_parse_csv_f32.argtypes = [
        c.c_char_p, c.c_int64, c.c_char, c.c_int32, c.POINTER(c.c_float),
        c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
    lib.dl4j_parse_idx.restype = c.c_int32
    lib.dl4j_parse_idx.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, c.c_float, c.POINTER(c.c_float),
        c.c_int64, c.POINTER(c.c_int64)]
    lib.dl4j_decode_netpbm.restype = c.c_int32
    lib.dl4j_decode_netpbm.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, c.POINTER(c.c_float), c.c_int64,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
    lib.dl4j_resize_bilinear_f32.restype = None
    lib.dl4j_resize_bilinear_f32.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_int64, c.c_int64,
        c.POINTER(c.c_float), c.c_int64, c.c_int64]
    lib.dl4j_normalize_hwc_f32.restype = None
    lib.dl4j_normalize_hwc_f32.argtypes = [
        c.POINTER(c.c_float), c.c_int64, c.c_int64, c.c_int64,
        c.POINTER(c.c_float), c.POINTER(c.c_float)]
    lib.dl4j_native_version.restype = c.c_int32
    lib.dl4j_native_version.argtypes = []


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _flat_f32_view(a: np.ndarray, what: str) -> np.ndarray:
    """A mutation-safe flat view. reshape(-1) on a non-contiguous array
    would COPY, making the in-place residual/decode semantics silently
    no-ops on the caller's array — reject instead."""
    if a.dtype != np.float32:
        raise ValueError(f"{what} must be float32, got {a.dtype}")
    if not a.flags.c_contiguous or not a.flags.writeable:
        raise ValueError(f"{what} must be a writeable C-contiguous array "
                         "(in-place semantics)")
    return a.reshape(-1)  # guaranteed view for contiguous arrays


# ---------------------------------------------------------------------------
# Threshold / bitmap codecs (reference: encodeThresholdP1-P3, encodeBitmap —
# the gradient-sharing wire format, SURVEY.md §2.4)
# ---------------------------------------------------------------------------


def threshold_encode(grad: np.ndarray, threshold: float,
                     max_elements: Optional[int] = None
                     ) -> Optional[np.ndarray]:
    """Encode |g|>threshold entries as a sparse int32 stream, subtracting
    the threshold in place (residual / error feedback). Returns None when
    the encoding would exceed ``max_elements`` (fall back to bitmap) or when
    the buffer is too large for the int32 +/-(index+1) wire format
    (>= 2^31-1 elements; the gradient is left untouched either way)."""
    flat = _flat_f32_view(grad, "grad")
    if flat.size >= 2**31 - 1:
        return None  # mirrors the C guard (returns -2)
    cap = int(max_elements) if max_elements is not None else flat.size
    lib = _load()
    if lib is not None:
        out = np.empty(cap, np.int32)
        n = lib.dl4j_threshold_encode(
            _fptr(flat), flat.size, ctypes.c_float(threshold),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        return None if n < 0 else out[:n].copy()
    idx = np.nonzero(np.abs(flat) > threshold)[0]
    if idx.size > cap:
        return None
    signs = np.sign(flat[idx])
    enc = ((idx + 1) * signs).astype(np.int32)
    flat[idx] -= signs.astype(np.float32) * threshold
    return enc


def threshold_decode(encoded: np.ndarray, threshold: float,
                     target: np.ndarray) -> None:
    """target[|e|-1] += sign(e) * threshold for each encoded entry."""
    flat = _flat_f32_view(target, "target")
    lib = _load()
    if lib is not None:
        enc = np.ascontiguousarray(encoded, np.int32)
        lib.dl4j_threshold_decode(
            enc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), enc.size,
            ctypes.c_float(threshold), _fptr(flat), flat.size)
        return
    idx = np.abs(encoded).astype(np.int64) - 1
    valid = (idx >= 0) & (idx < flat.size)  # skip corrupt entries (as in C)
    np.add.at(flat, idx[valid],
              np.sign(encoded[valid]).astype(np.float32) * threshold)


def bitmap_encode(grad: np.ndarray, threshold: float
                  ) -> Tuple[np.ndarray, int]:
    """Dense 2-bit codec (00 zero / 01 +thr / 10 -thr), residual in place.
    Returns (bitmap bytes, count of non-zero codes). The count is
    informational (compression-ratio accounting) — bitmap_decode takes the
    TOTAL element count of the tensor, not this value."""
    flat = _flat_f32_view(grad, "grad")
    bitmap = np.zeros((flat.size + 3) // 4, np.uint8)
    lib = _load()
    if lib is not None:
        n = lib.dl4j_bitmap_encode(
            _fptr(flat), flat.size, ctypes.c_float(threshold),
            bitmap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return bitmap, int(n)
    pos = flat > threshold
    neg = flat < -threshold
    codes = np.zeros(flat.size, np.uint8)
    codes[pos] = 1
    codes[neg] = 2
    flat[pos] -= threshold
    flat[neg] += threshold
    pad = (-codes.size) % 4
    c4 = np.pad(codes, (0, pad)).reshape(-1, 4)
    bitmap[:] = (c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4)
                 | (c4[:, 3] << 6)).astype(np.uint8)
    return bitmap, int(pos.sum() + neg.sum())


def bitmap_decode(bitmap: np.ndarray, n: int, threshold: float,
                  target: np.ndarray) -> None:
    """Apply a bitmap-encoded update to ``target``. ``n`` is the TOTAL
    element count of the encoded tensor (4 codes per bitmap byte, the last
    byte may be padding) — NOT the non-zero count bitmap_encode returns;
    passing that would silently decode only a prefix."""
    flat = _flat_f32_view(target, "target")
    lib = _load()
    if lib is not None:
        bm = np.ascontiguousarray(bitmap, np.uint8)
        lib.dl4j_bitmap_decode(
            bm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            ctypes.c_float(threshold), _fptr(flat))
        return
    codes = np.repeat(bitmap, 4)
    shifts = np.tile(np.arange(4) * 2, bitmap.size)
    codes = (codes >> shifts) & 3
    codes = codes[:n]
    flat[:n][codes == 1] += threshold
    flat[:n][codes == 2] -= threshold


# ---------------------------------------------------------------------------
# Data pipeline primitives (reference: DataVec native loaders)
# ---------------------------------------------------------------------------


def parse_csv(text: bytes, delimiter: str = ",", skip_rows: int = 0
              ) -> np.ndarray:
    """Parse a delimited byte buffer into a float32 [rows, cols] matrix."""
    if isinstance(text, str):
        text = text.encode()
    lib = _load()
    if lib is not None:
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        rc = lib.dl4j_parse_csv_f32(text, len(text), delimiter.encode(),
                                    skip_rows, None, 0,
                                    ctypes.byref(rows), ctypes.byref(cols))
        if rc != 0:
            raise ValueError(f"CSV probe failed (code {rc})")
        out = np.empty(rows.value * cols.value, np.float32)
        rc = lib.dl4j_parse_csv_f32(text, len(text), delimiter.encode(),
                                    skip_rows, _fptr(out), out.size,
                                    ctypes.byref(rows), ctypes.byref(cols))
        if rc != 0:
            raise ValueError(f"CSV parse failed (code {rc})")
        return out.reshape(rows.value, cols.value)
    lines = [ln for ln in text.decode().splitlines() if ln.strip()]
    lines = lines[skip_rows:]
    data = [[float(x) for x in ln.split(delimiter)] for ln in lines]
    if data and any(len(r) != len(data[0]) for r in data):
        raise ValueError("CSV probe failed (code -1)")
    return np.asarray(data, np.float32)


def parse_idx(buf: bytes, scale: float = 1.0) -> np.ndarray:
    """Parse an IDX (MNIST ubyte) buffer into float32 * scale."""
    raw = np.frombuffer(buf, np.uint8)
    lib = _load()
    if lib is not None:
        shape = np.zeros(8, np.int64)
        rank = lib.dl4j_parse_idx(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), raw.size,
            ctypes.c_float(scale), None, 0,
            shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rank < 0:
            raise ValueError(f"bad IDX buffer (code {rank})")
        dims = tuple(int(d) for d in shape[:rank])
        out = np.empty(int(np.prod(dims)), np.float32)
        lib.dl4j_parse_idx(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), raw.size,
            ctypes.c_float(scale), _fptr(out), out.size,
            shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out.reshape(dims)
    if raw.size < 4 or raw[0] != 0 or raw[1] != 0 or raw[2] != 0x08:
        raise ValueError("bad IDX buffer (code -1)")
    rank = int(raw[3])
    if rank < 1 or rank > 8 or raw.size < 4 + 4 * rank:
        raise ValueError("bad IDX buffer (code -1)")
    dims = tuple(int.from_bytes(buf[4 + 4 * d:8 + 4 * d], "big")
                 for d in range(rank))
    total = int(np.prod(dims))
    if raw.size < 4 + 4 * rank + total:
        raise ValueError("bad IDX buffer (code -1)")
    data = raw[4 + 4 * rank:4 + 4 * rank + total]
    return (data.astype(np.float32) * scale).reshape(dims)


def parse_netpbm_header(buf: bytes):
    """Front-anchored P5/P6 header parse shared by the float decoder's
    numpy fallback and the uint8 fast path (data.records): returns
    (width, height, channels, maxval, raster_offset). Handles '#'
    comments (to LF or CR) and enforces the single whitespace byte
    between maxval and the raster."""
    if not buf.startswith(b"P5") and not buf.startswith(b"P6"):
        raise ValueError("bad netpbm data (code -1)")
    channels = 1 if buf[:2] == b"P5" else 3
    pos = 2
    fields = []
    while len(fields) < 3:
        while pos < len(buf) and buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":
            while pos < len(buf) and buf[pos] not in (0x0A, 0x0D):
                pos += 1
            continue
        start = pos
        while pos < len(buf) and not buf[pos:pos + 1].isspace():
            pos += 1
        fields.append(int(buf[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = fields
    return w, h, channels, maxval, pos


def decode_netpbm(buf: bytes) -> np.ndarray:
    """Decode P5 (gray) / P6 (RGB) netpbm into float32 HWC in [0, 1]."""
    raw = np.frombuffer(buf, np.uint8)
    lib = _load()
    if lib is not None:
        h = ctypes.c_int64()
        w = ctypes.c_int64()
        c = ctypes.c_int64()
        ptr = raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        rc = lib.dl4j_decode_netpbm(ptr, raw.size, None, 0, ctypes.byref(h),
                                    ctypes.byref(w), ctypes.byref(c))
        if rc != 0:
            raise ValueError(f"bad netpbm data (code {rc})")
        out = np.empty(h.value * w.value * c.value, np.float32)
        lib.dl4j_decode_netpbm(ptr, raw.size, _fptr(out), out.size,
                               ctypes.byref(h), ctypes.byref(w),
                               ctypes.byref(c))
        return out.reshape(h.value, w.value, c.value)
    # numpy fallback
    w, h, channels, maxval, pos = parse_netpbm_header(buf)
    if maxval <= 0 or maxval > 255:  # 16-bit netpbm unsupported (as in C)
        raise ValueError("bad netpbm data (code -1)")
    total = h * w * channels
    data = np.frombuffer(buf, np.uint8, count=total, offset=pos)
    return (data.astype(np.float32) / maxval).reshape(h, w, channels)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of float32 HWC (half-pixel centers)."""
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    lib = _load()
    if lib is not None:
        out = np.empty((out_h, out_w, c), np.float32)
        lib.dl4j_resize_bilinear_f32(_fptr(img), h, w, c, _fptr(out),
                                     out_h, out_w)
        return out
    sy = ((np.arange(out_h) + 0.5) * h / out_h - 0.5)
    sx = ((np.arange(out_w) + 0.5) * w / out_w - 0.5)
    y0u = np.floor(sy).astype(np.int64)
    x0u = np.floor(sx).astype(np.int64)
    y0 = np.clip(y0u, 0, h - 1)
    x0 = np.clip(x0u, 0, w - 1)
    y1 = np.clip(y0u + 1, 0, h - 1)  # from the UNCLAMPED floor (as in C)
    x1 = np.clip(x0u + 1, 0, w - 1)
    # fractional parts use the unclamped floor, matching the C loop
    fy = (sy - np.floor(sy))[:, None, None]
    fx = (sx - np.floor(sx))[None, :, None]
    v00 = img[y0][:, x0]
    v01 = img[y0][:, x1]
    v10 = img[y1][:, x0]
    v11 = img[y1][:, x1]
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return (top + (bot - top) * fy).astype(np.float32)


def normalize_hwc(img: np.ndarray, mean, std) -> np.ndarray:
    """(x - mean[c]) / std[c] in place; returns the array."""
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    mean = np.ascontiguousarray(np.broadcast_to(mean, (c,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (c,)), np.float32)
    lib = _load()
    if lib is not None:
        lib.dl4j_normalize_hwc_f32(_fptr(img), h, w, c, _fptr(mean),
                                   _fptr(std))
        return img
    img -= mean
    img /= std
    return img
