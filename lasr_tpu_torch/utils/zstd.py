"""ctypes bindings for the port's zstd frame decoder (``csrc/zstd_decode.cc``),
which the orbax checkpoint reader (``utils/ocdbt.py``) needs: orbax writes
its OCDBT nodes and zarr chunks as zstd frames.

A host decoder: the shared library is built with ``g++ -O3`` at first use
into ``lasr_tpu_torch/_build/libzstd_decode.so`` (``utils/native.py``).  A
failed build raises: there is no other decoder to fall back on.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from lasr_tpu_torch.utils.native import build_shared

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_shared("zstd_decode")))
            lib.lasr_zstd_decompress.restype = ctypes.c_int64
            lib.lasr_zstd_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
                ctypes.c_uint64]
            lib.lasr_zstd_decompress_into.restype = ctypes.c_int64
            lib.lasr_zstd_decompress_into.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]
            lib.lasr_zstd_free.restype = None
            lib.lasr_zstd_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def decompress(data) -> bytes:
    """The content of every zstd frame in ``data`` (bytes or any buffer,
    read in place), skippable frames skipped.  Raises ``ValueError`` on
    corrupt or truncated input and on a frame that needs a dictionary."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    n = lib.lasr_zstd_decompress(src.ctypes.data, src.size, ctypes.byref(out),
                                 err, len(err))
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.lasr_zstd_free(out)


def decompress_to(data, out: np.ndarray) -> np.ndarray:
    """``decompress(data)`` decoded straight into ``out``, a contiguous
    uint8 array of the content's size, which the caller knows (a zarr
    chunk's); returns ``out``.  Content of another length raises
    ``ValueError``."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("zstd: the output is not a contiguous uint8 array")
    err = ctypes.create_string_buffer(256)
    n = lib.lasr_zstd_decompress_into(src.ctypes.data, src.size,
                                      out.ctypes.data, out.size, err,
                                      len(err))
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    if n != out.size:
        raise ValueError(f"zstd: {n} bytes of content, expected {out.size}")
    return out
