"""ctypes bindings for the native C++ runtime (native/gbtpu_native.cpp).

Auto-builds the shared library on first use (make, ~2s) and falls back to
pure-numpy implementations when no compiler is available, so the package
never hard-requires the native layer (the reference similarly makes its
factory kernels optional via GRAPHBLAS_COMPACT, CMakeLists.txt:210)."""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgbtpu_native.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _LIB_PATH.exists():
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.gbtpu_radix_sort_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.gbtpu_delta_encode_i64.restype = ctypes.c_int64
        lib.gbtpu_delta_encode_i64.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.gbtpu_delta_decode_i64.restype = ctypes.c_int64
        lib.gbtpu_delta_decode_i64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.gbtpu_byteshuffle.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.gbtpu_byteunshuffle.argtypes = lib.gbtpu_byteshuffle.argtypes
        lib.gbtpu_mtx_header.restype = ctypes.c_int
        lib.gbtpu_mtx_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.gbtpu_mtx_read.restype = ctypes.c_int
        lib.gbtpu_mtx_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def radix_argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Permutation sorting uint64 keys ascending (stable)."""
    keys = np.ascontiguousarray(keys, np.uint64)
    lib = _load()
    if lib is None:
        return np.argsort(keys, kind="stable")
    perm = np.empty(keys.shape[0], np.int64)
    lib.gbtpu_radix_sort_u64(_ptr(keys, ctypes.c_uint64),
                             len(keys), _ptr(perm, ctypes.c_int64))
    return perm


def delta_encode(arr: np.ndarray) -> bytes:
    a = np.ascontiguousarray(arr, np.int64)
    lib = _load()
    if lib is None:
        # numpy fallback: plain delta, no varint
        d = np.diff(a, prepend=np.int64(0))
        return b"raw0" + d.tobytes()
    out = np.empty(10 * len(a) + 16, np.uint8)
    n = lib.gbtpu_delta_encode_i64(_ptr(a, ctypes.c_int64), len(a),
                                   _ptr(out, ctypes.c_uint8))
    return b"gbd1" + bytes(out[:n])


def delta_decode(blob: bytes, n: int) -> np.ndarray:
    tag, body = blob[:4], blob[4:]
    if tag == b"raw0":
        d = np.frombuffer(body, np.int64, n)
        return np.cumsum(d).astype(np.int64)
    lib = _load()
    if lib is None:
        raise RuntimeError("gbd1 blob needs the native library")
    out = np.empty(n, np.int64)
    buf = np.frombuffer(body, np.uint8)
    lib.gbtpu_delta_decode_i64(_ptr(buf, ctypes.c_uint8), len(buf),
                               _ptr(out, ctypes.c_int64), n)
    return out


def byteshuffle(arr: np.ndarray) -> bytes:
    a = np.ascontiguousarray(arr)
    raw = a.view(np.uint8).reshape(-1)
    item = a.dtype.itemsize
    n = a.size
    lib = _load()
    if lib is None:
        return raw.reshape(n, item).T.copy().tobytes()
    out = np.empty(raw.size, np.uint8)
    lib.gbtpu_byteshuffle(_ptr(raw, ctypes.c_uint8), n, item,
                          _ptr(out, ctypes.c_uint8))
    return out.tobytes()


def byteunshuffle(blob: bytes, dtype, n: int) -> np.ndarray:
    dt = np.dtype(dtype)
    raw = np.frombuffer(blob, np.uint8)
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(
            raw.reshape(dt.itemsize, n).T).view(dt).reshape(n).copy()
    out = np.empty(raw.size, np.uint8)
    lib.gbtpu_byteunshuffle(_ptr(np.ascontiguousarray(raw), ctypes.c_uint8),
                            n, dt.itemsize, _ptr(out, ctypes.c_uint8))
    return out.view(dt)[:n].copy()


def read_mtx(path: str):
    """(rows, cols, vals, shape) from a Matrix Market file; symmetric
    matrices are expanded.  Uses the native parser when available, else a
    numpy loadtxt fallback."""
    lib = _load()
    if lib is None:
        import scipy.io as sio
        m = sio.mmread(path).tocoo()
        return (m.row.astype(np.int32), m.col.astype(np.int32),
                m.data.astype(np.float64), m.shape)
    nr = ctypes.c_int64()
    nc = ctypes.c_int64()
    nnz = ctypes.c_int64()
    sym = ctypes.c_int()
    pat = ctypes.c_int()
    rc = lib.gbtpu_mtx_header(path.encode(), ctypes.byref(nr),
                              ctypes.byref(nc), ctypes.byref(nnz),
                              ctypes.byref(sym), ctypes.byref(pat))
    if rc != 0:
        raise IOError(f"mtx header parse failed ({rc}): {path}")
    n = nnz.value
    rows = np.empty(n, np.int32)
    cols = np.empty(n, np.int32)
    vals = np.empty(n, np.float64)
    rc = lib.gbtpu_mtx_read(path.encode(), _ptr(rows, ctypes.c_int32),
                            _ptr(cols, ctypes.c_int32),
                            _ptr(vals, ctypes.c_double), n, pat.value)
    if rc != 0:
        raise IOError(f"mtx body parse failed ({rc}): {path}")
    if pat.value:
        vals[:] = 1.0
    if sym.value:
        off = rows != cols
        sign = -1.0 if sym.value == 2 else 1.0
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, rows[:n][off]])
        vals = np.concatenate([vals, sign * vals[off]])
    return rows, cols, vals, (nr.value, nc.value)
