"""Build and load the port's hand-written CUDA kernels and its host core.

Each kernel source ``csrc/<name>.cu`` exposes a plain C launch function and
is compiled by ``nvcc`` for Hopper (``sm_90a``); the native host core
``csrc/genomics_native.cpp`` (host C++: the ingest parse, pack and hash
loops) is compiled by ``g++`` (``-O3 -shared -fPIC -std=c++17 -pthread``).
Each source becomes its own shared library under ``_build/`` in this
package, at first use, from the sources in the checkout only. The
library's file name carries a hash of its source and of the compiler
flags, so an edited source is rebuilt and a stale library is never loaded.
Libraries are loaded with ``ctypes``: no PyTorch headers are compiled,
which keeps a build at seconds. The compiler's output for each source (for
a kernel, its ``-Xptxas -v`` report of registers, shared memory and
spills) is kept beside its library and read back with :func:`build_log`.

Nothing here runs at import time; the CPU tests import the package without
a compiler, and build only the host core (``g++``), never a ``.cu``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

__all__ = ["build", "build_log", "cxx_path", "load", "nvcc_path"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location. Raises if none exists."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from csrc/ at first use"
    )


def cxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on PATH. Raises if
    neither exists."""
    for candidate in (os.environ.get("CXX"), "g++"):
        found = candidate and shutil.which(candidate)
        if found:
            return found
    raise RuntimeError(
        "g++ not found (set CXX or put g++ on PATH); the port's native "
        "host core is built from csrc/genomics_native.cpp at first use"
    )


def _source(name: str) -> str:
    """``csrc/<name>.cu`` (a kernel) or ``csrc/<name>.cpp`` (host code)."""
    for ext in (".cu", ".cpp"):
        path = os.path.join(CSRC_DIR, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _flags(src: str) -> tuple:
    return NVCC_FLAGS if src.endswith(".cu") else CXX_FLAGS


def _library_path(name: str) -> str:
    src = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(_flags(src)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that has no current library.

    One compiler (``nvcc`` for a ``.cu``, ``g++`` for a ``.cpp``) per
    source, all started together, so the wall-clock of a build is that of
    the slowest source. Each compiles into a temporary
    file renamed into place when done, so a concurrent or interrupted build
    never leaves a torn library behind. Returns name -> library path;
    raises with the compiler's output if any source fails.
    """
    paths = {name: _library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        src = _source(name)
        compiler = nvcc_path() if src.endswith(".cu") else cxx_path()
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (
            subprocess.Popen(
                [compiler, *_flags(src), "-o", tmp, src],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            ),
            tmp,
            path,
        )
    failures = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(
                f"{os.path.basename(_source(name))}:\n"
                f"{out.decode(errors='replace')}"
            )
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            with open(f"{tmp}.log", "wb") as f:
                f.write(out)
            os.replace(f"{tmp}.log", f"{path}.log")
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("the build failed for " + "\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """The compiler's output for source ``name``'s current library (for a
    kernel, the ``-Xptxas -v`` resource report), building it first if
    needed."""
    with open(f"{build([name])[name]}.log", encoding="utf-8",
              errors="replace") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _loaded[name] = lib
        return lib
