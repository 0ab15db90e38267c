"""Build and load the port's native code: CUDA kernels and host C++.

Each ``csrc/<name>.cu`` is compiled by ``nvcc``, and each ``csrc/<name>.cc``
(host code, no CUDA) by ``g++``, on first use into its own shared library
with a plain C interface, under ``teaserpp_tpu_torch/_build/``, and loaded
with ``ctypes``. A library's file name carries a hash of its source, the
shared headers and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. Nothing here runs at import time: only a CUDA tensor
reaching a kernel wrapper, a call into the host library, or :func:`build_all`
starts a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

HOST_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _host_cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if not found:
        raise RuntimeError("no host C++ compiler found: put g++ on PATH or set CXX")
    return found


def sources() -> List[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def host_sources() -> List[str]:
    """Names of the host C++ sources, ``csrc/<name>.cc``."""
    return sorted(p.stem for p in CSRC.glob("*.cc"))


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` if there is one, else the host source ``<name>.cc``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def _library_path(name: str) -> Path:
    src = _source(name)
    is_cuda = src.suffix == ".cu"
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS if is_cuda else HOST_FLAGS).encode())
    for p in [src, *(sorted(CSRC.glob("*.cuh")) if is_cuda else [])]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (``nvcc``) or ``csrc/<name>.cc`` (``g++``)
    unless its current build exists; return the .so.

    The compiler's output (for ``nvcc``, ``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``<library>.log``.
    """
    so = _library_path(name)
    if so.exists():
        return so
    src = _source(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        if src.suffix == ".cu":
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        else:
            cmd = [_host_cxx(), *HOST_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed for {src.name}:\n{proc.stdout}\n{proc.stderr}"
            )
        Path(str(so) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def build_all() -> Dict[str, Path]:
    """Compile every source, one compiler process each, all started together."""
    names = sources() + host_sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cc``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LOADED[name] = lib
        return lib
