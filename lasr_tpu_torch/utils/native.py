"""Build the port's host-native C++ sources (``csrc/<name>.cc``: the WAV /
FLAC batch loader, the zstd decoder) into shared libraries for ``ctypes``.

A library is built with ``g++ -O3`` at first use into
``lasr_tpu_torch/_build/lib<name>.so``, rebuilt when the source is newer,
and written through a temporary file and an atomic rename, so concurrent
first uses never load a half-written library.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Iterable, Tuple

PKG = Path(__file__).resolve().parent.parent


def paths(name: str) -> Tuple[Path, Path]:
    """(``csrc/<name>.cc``, ``_build/lib<name>.so``)."""
    return PKG / "csrc" / f"{name}.cc", PKG / "_build" / f"lib{name}.so"


def build_shared(name: str, extra_flags: Iterable[str] = ()) -> Path:
    """The path of ``_build/lib<name>.so``, built from ``csrc/<name>.cc``
    unless it is newer than the source.  Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    src, lib = paths(name)
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *extra_flags,
           str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        tmp.unlink(missing_ok=True)
        detail = getattr(e, "stderr", None) or e
        raise RuntimeError(f"building {src.name} with g++ failed: "
                           f"{detail}") from e
    os.replace(tmp, lib)
    return lib
