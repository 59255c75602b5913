"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library ``_build/lib<name>.so`` with a plain ``extern "C"``
interface, loaded through ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes).  The build happens at first use, from the sources
in the checkout only; ``build()`` compiles several sources at once, one
``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
KERNEL_SOURCES = ("rot_attention", "rot_attention_bwd", "rel_attention",
                  "rel_attention_bwd", "rot_attention_sm90",
                  "rot_attention_bwd_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels build on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header ``csrc/*.cuh`` (a source may include any of them)."""
    lib = library_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(built < s.stat().st_mtime for s in sources)


def build(names: Iterable[str] = KERNEL_SOURCES,
          force: bool = False) -> Dict[str, str]:
    """Compile the named sources in parallel; returns each one's compiler
    output (``-Xptxas -v``: registers, shared memory and spills per
    kernel).  Raises with the compiler output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = BUILD / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
