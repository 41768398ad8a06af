"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library under ``build/torch_kernels/``
(beside the package, listed in ``.gitignore``).  A library's file name
carries a hash of its source and flags, so an edited source is rebuilt.
``build_all`` starts one ``nvcc`` per missing library, all at once.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
``check`` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
KERNELS = ("wire_lookup", "label_counts", "selection_mask", "sw_scores")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_funcs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build_all() -> dict:
    """Compile every kernel library that is missing, in parallel.

    Returns {name: (seconds, compiler report)} for the ones built; the
    report holds ptxas's registers, shared memory and spills per kernel."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = {}
        t0 = time.perf_counter()
        for name in KERNELS:
            so = library_path(name)
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, so)
        built, failed = {}, []
        for name, (proc, tmp, so) in jobs.items():
            report, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{name}:\n{report}")
                continue
            os.replace(tmp, so)
            built[name] = (time.perf_counter() - t0, report)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return built


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of kernel library ``name``, with its
    argument types set; builds the libraries on first use."""
    key = (name, symbol)
    fn = _funcs.get(key)
    if fn is None:
        so = library_path(name)
        if not os.path.exists(so):
            build_all()
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return fn


def check(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
