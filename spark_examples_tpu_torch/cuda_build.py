"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``csrc/<name>.cu`` exposes a plain C launch function and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
under ``_build/`` in this package, at first use, from the sources in the
checkout only. The library's file name carries a hash of its source and of
the compiler flags, so an edited source is rebuilt and a stale library is
never loaded. Libraries are loaded with ``ctypes``: no PyTorch headers are
compiled, which keeps a build at seconds. The compiler's report of each
kernel's registers, shared memory and spills (``-Xptxas -v``) is kept
beside its library and read back with :func:`build_log`.

Nothing here runs at import time; the CPU tests import the package without
a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

__all__ = ["build", "build_log", "load", "nvcc_path"]

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


def _library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named kernel source that has no current library.

    One ``nvcc`` per source, all started together, so the wall-clock of a
    build is that of the slowest source. Each compiles into a temporary
    file renamed into place when done, so a concurrent or interrupted build
    never leaves a torn library behind. Returns name -> library path;
    raises with the compiler's output if any source fails.
    """
    paths = {name: _library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC_DIR, f"{name}.cu")],
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
            failures.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            with open(f"{path}.log", "wb") as f:
                f.write(out)
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """The compiler's output for kernel ``name``'s current library (the
    ``-Xptxas -v`` resource report), building it first if needed."""
    with open(f"{build([name])[name]}.log", encoding="utf-8",
              errors="replace") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _loaded[name] = lib
        return lib
