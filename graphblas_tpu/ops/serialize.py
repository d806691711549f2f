"""Serialize / deserialize + O(1) pack/unpack move semantics.

Reference: Source/GB_serialize.c (blob with parallel block compression:
LZ4/LZ4HC/ZSTD per descriptor), GxB_Serialized_get (query blob metadata
without deserializing), GxB_Matrix_pack/unpack_* (O(1) array adoption for
all 8 formats).

Redesign: the blob is a self-describing header (JSON, so any tool can
inspect it) + per-array compressed blocks.  Codecs are pluggable; the
native C++ codec module (native/) registers 'xz'-class codecs when built,
and zlib is always available.  Checkpoint/resume for device state =
serialize on host + device_put on restore (the tensorstore-style sharded
path lives in parallel/).
"""

from __future__ import annotations

import json
import struct
import zlib

import jax.numpy as jnp
import numpy as np

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.matrix import BITMAP, FULL, HYPER, SPARSE, Matrix, Scalar, Vector

MAGIC = b"GBTP"
VERSION = 1

_CODECS = {
    "none": (lambda b, level: b, lambda b: b),
    "zlib": (lambda b, level: zlib.compress(b, min(level, 9)),
             zlib.decompress),
}

try:  # zstd levels 1-19 (reference: GxB_COMPRESSION_ZSTD,
    #   Source/GB_serialize.c:133-139); gated — not in every image
    import zstandard as _zstd

    _CODECS["zstd"] = (
        lambda b, level: _zstd.ZstdCompressor(
            level=max(1, min(level, 19))).compress(b),
        lambda b: _zstd.ZstdDecompressor().decompress(b))
except ImportError:  # pragma: no cover
    pass


def _gbz_compress_array(npa: np.ndarray, level: int) -> bytes:
    """Domain-aware codec (the LZ4/ZSTD-analog, native/gbtpu_native.cpp):
    sorted/int index arrays get zig-zag varint delta coding, float values
    get byte-shuffled; zlib finishes both."""
    from ..utils import native as NV
    if np.issubdtype(npa.dtype, np.integer) and npa.ndim == 1:
        body = NV.delta_encode(npa.astype(np.int64))
        return b"D" + zlib.compress(body, min(level + 2, 9))
    body = NV.byteshuffle(npa)
    return b"S" + zlib.compress(body, min(level + 2, 9))


def _gbz_decompress_array(blob: bytes, dtype, shape) -> np.ndarray:
    from ..utils import native as NV
    kind, body = blob[:1], zlib.decompress(blob[1:])
    n = int(np.prod(shape)) if shape else 1
    if kind == b"D":
        return NV.delta_decode(body, n).astype(dtype).reshape(shape)
    return NV.byteunshuffle(body, dtype, n).reshape(shape)


def register_codec(name, compress, decompress):
    """Plug in an external codec (e.g. the native C++ lz4-class codec)."""
    _CODECS[name] = (compress, decompress)


def serialize(A: Matrix, compression=None, level=None, desc=None) -> bytes:
    """Matrix -> blob (GxB_Matrix_serialize).

    Codec resolution: explicit ``compression``/``level`` args win, then the
    descriptor's compression fields (GxB_COMPRESSION analog; Descriptor
    defaults to zstd level 1 like the reference, Source/GB_serialize.c:
    133-139), then zstd (zlib where the module is absent)."""
    if A._pending:
        A.wait()
    if compression is None:
        compression = getattr(desc, "compression", None) or (
            "zstd" if "zstd" in _CODECS else "zlib")
    if level is None:
        level = getattr(desc, "compression_level", None) or 1
    if compression == "zstd" and "zstd" not in _CODECS:
        compression = "zlib"   # image without the zstandard module
    if compression != "gbz" and compression not in _CODECS:
        raise E.InvalidValue(f"unknown codec {compression!r}")
    arrays = {}
    for name in ("indptr", "h", "indices", "values", "bitmap"):
        arr = getattr(A, name)
        if arr is not None:
            npa = np.asarray(arr)
            if compression == "gbz":
                enc = _gbz_compress_array(npa, level)
            else:
                enc = _CODECS[compression][0](npa.tobytes(), level)
            arrays[name] = (str(npa.dtype), list(npa.shape), enc)
    header = {
        "version": VERSION,
        "class": type(A).__name__,
        "shape": list(A.shape),
        "dtype": A.dtype.name,
        "format": A.fmt,
        "orient": A.orient,
        "iso": A.iso,
        "nvals": A.nvals,
        "compression": compression,
        "arrays": {k: {"dtype": v[0], "shape": v[1], "nbytes": len(v[2])}
                   for k, v in arrays.items()},
    }
    hb = json.dumps(header).encode()
    out = [MAGIC, struct.pack("<I", len(hb)), hb]
    for k in header["arrays"]:
        out.append(arrays[k][2])
    blob = b"".join(out)
    CFG.burble("serialize: %d bytes (%s)", len(blob), compression)
    return blob


def serialized_get(blob: bytes) -> dict:
    """Query blob metadata without deserializing (GxB_Serialized_get)."""
    if blob[:4] != MAGIC:
        raise E.InvalidObject("not a graphblas_tpu blob")
    hlen = struct.unpack("<I", blob[4:8])[0]
    return json.loads(blob[8:8 + hlen].decode())


def deserialize(blob: bytes) -> Matrix:
    """Blob -> Matrix (GxB_Matrix_deserialize)."""
    header = serialized_get(blob)
    comp = header["compression"]
    hlen = struct.unpack("<I", blob[4:8])[0]
    pos = 8 + hlen
    arrays = {}
    for name, meta in header["arrays"].items():
        raw = blob[pos:pos + meta["nbytes"]]
        pos += meta["nbytes"]
        if comp == "gbz":
            npa = _gbz_decompress_array(raw, meta["dtype"], meta["shape"])
        else:
            npa = np.frombuffer(_CODECS[comp][1](raw),
                                meta["dtype"]).reshape(meta["shape"])
        arrays[name] = jnp.asarray(npa)
    klass = {"Matrix": Matrix, "Vector": Vector, "Scalar": Scalar}[
        header["class"]]
    obj = object.__new__(klass)
    obj.shape = tuple(header["shape"])
    obj.dtype = T.lookup(header["dtype"])
    obj.fmt = header["format"]
    obj.orient = header["orient"]
    obj.iso = header["iso"]
    obj.indptr = arrays.get("indptr")
    obj.h = arrays.get("h")
    obj.indices = arrays.get("indices")
    obj.values = arrays.get("values")
    obj.bitmap = arrays.get("bitmap")
    obj._pending, obj._nvals_cache, obj.name = [], None, ""
    return obj


# ---------------------------------------------------------------------------
# O(1) pack / unpack (move semantics)
# ---------------------------------------------------------------------------

def pack(shape, dtype, fmt, orient, *, indptr=None, h=None, indices=None,
         values=None, bitmap=None, iso=False, klass=Matrix,
         trusted=False) -> Matrix:
    """Adopt user arrays as a Matrix in O(1) (GxB_Matrix_pack_*).  With
    trusted=False the structure is validated (the import 'secure' mode)."""
    out = object.__new__(klass)
    out.shape = (int(shape[0]), int(shape[1]))
    out.dtype = T.lookup(dtype)
    out.fmt, out.orient, out.iso = fmt, orient, bool(iso)
    out.indptr = None if indptr is None else jnp.asarray(indptr)
    out.h = None if h is None else jnp.asarray(h)
    out.indices = None if indices is None else jnp.asarray(indices)
    out.values = None if values is None else jnp.asarray(values)
    out.bitmap = None if bitmap is None else jnp.asarray(bitmap)
    out._pending, out._nvals_cache, out.name = [], None, ""
    if not trusted:
        out.check()
    return out


def unpack(A: Matrix):
    """Surrender a matrix's arrays in O(1) (GxB_Matrix_unpack_*).  Returns
    (metadata dict, arrays dict); A is cleared."""
    if A._pending:
        A.wait()
    meta = {"shape": A.shape, "dtype": A.dtype, "format": A.fmt,
            "orient": A.orient, "iso": A.iso}
    arrays = {"indptr": A.indptr, "h": A.h, "indices": A.indices,
              "values": A.values, "bitmap": A.bitmap}
    A.clear()
    return meta, arrays
