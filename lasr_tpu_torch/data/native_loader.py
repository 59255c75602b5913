"""ctypes bindings for the native C++ WAV/FLAC batch loader
(``csrc/wavio.cc``; counterpart of ``lasr_tpu/data/native_loader.py``).

A host decoder: the shared library is built with ``g++`` at first use
into ``lasr_tpu_torch/_build/libwavio.so`` (rebuilt when the source is
newer, written through a temporary file and an atomic rename).  Decode
and channel averaging run outside the GIL, so the batch read scales
across cores.  ``available()`` is False when no compiler or library is
there, and callers use the Python readers.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "wavio.cc"
_LIB_PATH = _PKG / "_build" / "libwavio.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[Path]:
    if _LIB_PATH.exists() and \
            _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB_PATH
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.tmp{os.getpid()}")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return _LIB_PATH
    except (OSError, subprocess.CalledProcessError) as e:
        tmp.unlink(missing_ok=True)
        logging.warning("native wavio build failed (%s); using python reader",
                        e)
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.wav_read.restype = ctypes.c_long
        lib.wav_read.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_long,
                                 ctypes.POINTER(ctypes.c_int)]
        lib.wav_info.restype = ctypes.c_long
        lib.wav_info.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
        lib.wav_read_batch.restype = ctypes.c_int
        lib.wav_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def wav_info(path: str) -> Tuple[int, int, int]:
    """(num_frames, sample_rate, channels)."""
    lib = _load()
    sr = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    n = lib.wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise ValueError(f"cannot parse WAV header: {path}")
    return int(n), sr.value, ch.value


def read_wav_mono(path: str, max_samples: Optional[int] = None
                  ) -> Tuple[np.ndarray, int]:
    """Decode + channel-average one file → (float32 (N,), sample_rate)."""
    lib = _load()
    if max_samples is None:
        max_samples, _, _ = wav_info(path)
        max_samples = max(max_samples, 1)
    out = np.zeros(max_samples, dtype=np.float32)
    sr = ctypes.c_int(0)
    got = lib.wav_read(path.encode(),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       max_samples, ctypes.byref(sr))
    if got < 0:
        raise ValueError(f"cannot decode WAV: {path}")
    return out[:got], sr.value


def read_batch(paths: List[str], max_samples: int, n_threads: int = 8
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a batch in parallel → (wav (n, max_samples) float32 zero-padded,
    lengths (n,) int32, sample_rates (n,) int32)."""
    lib = _load()
    n = len(paths)
    out = np.zeros((n, max_samples), dtype=np.float32)
    lengths = np.zeros(n, dtype=np.int32)
    rates = np.zeros(n, dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.wav_read_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    if failures:
        bad = [paths[i] for i in range(n) if lengths[i] < 0]
        raise ValueError(f"failed to decode {failures} files: {bad[:3]}")
    return out, lengths, rates
