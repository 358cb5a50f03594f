"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` has a plain C interface and compiles, at
first use, into ``_build/lib<name>.so`` next to the package (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

No ``--use_fast_math``: divisions and square roots stay IEEE.  ptxas's
report (registers, spills, stack and shared memory per kernel) is kept in
``_build/lib<name>.ptxas.txt`` (``ptxas_report``).  A library is rebuilt
when it is older than its source.  Builds of different sources may run
concurrently (one nvcc each); loading is serialised.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build(name: str) -> str:
    """Compile csrc/<name>.cu if its library is missing or older than the
    source; returns the library path."""
    src = os.path.join(PKG_DIR, "csrc", f"{name}.cu")
    lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    if (os.path.exists(lib_path)
            and os.path.getmtime(lib_path) >= os.path.getmtime(src)):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    with open(os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt"), "w") as fh:
        fh.write(res.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def ptxas_report(name: str) -> str:
    """ptxas's per-kernel report of the last build of csrc/<name>.cu."""
    with open(os.path.join(BUILD_DIR, f"lib{name}.ptxas.txt")) as fh:
        return fh.read()


def load(name: str, fn: str, argtypes: Sequence) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built if needed), with the C
    entry point ``fn`` typed: ``argtypes`` as given (c_void_p for every
    pointer and the stream), an int return (a cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        entry = getattr(lib, fn)
        entry.argtypes = list(argtypes)
        entry.restype = ctypes.c_int
    return lib
