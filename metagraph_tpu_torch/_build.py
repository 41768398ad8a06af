"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library under ``build/torch_kernels/``
(beside the package, listed in ``.gitignore``).  A library's file name
carries a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt.
``build_all`` starts one ``nvcc`` per missing library, all at once.
A variant (``VARIANTS``) is a source built with extra flags into a library
of its own name, at its first use only: ``row_words_split`` is W1 and W2
with the descent's load-wait counters (scripts/kernel_times.py).

Every C entry point returns ``cudaGetLastError()`` right after its launch;
``check`` raises if that is not 0.  A wrapper adds its launches to its
``launches`` counter through ``count``, under a lock, so that the counts
stay exact when several threads launch (``query -p``).
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
KERNELS = ("wire_lookup", "label_counts", "selection_mask", "sw_scores",
           "gather_rows", "key_lookup", "codes_lookup", "sparse_counts",
           "row_words", "build_windows", "radix_sort", "build_join",
           "build_emit", "wave_dp", "kmer_lookup", "boss_walk")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
VARIANTS = {"row_words_split": ("row_words", ["-DMG_ROW_WORDS_SPLIT"])}

_lock = threading.Lock()
_count_lock = threading.Lock()
_funcs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _source(name: str):
    """-> (source file, flags) of library ``name``."""
    src, extra = VARIANTS.get(name, (name, []))
    return os.path.join(CSRC, src + ".cu"), NVCC_FLAGS + extra


def library_path(name: str) -> str:
    src, flags = _source(name)
    h = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(f, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build_all(names=KERNELS) -> dict:
    """Compile every kernel library of ``names`` that is missing, in
    parallel.

    Returns {name: (seconds, compiler report)} for the ones built; the
    report holds ptxas's registers, shared memory and spills per kernel."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = {}
        t0 = time.perf_counter()
        for name in names:
            so = library_path(name)
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            src, flags = _source(name)
            cmd = [_nvcc(), *flags, "-o", tmp, src]
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


def function(name: str, symbol: str, argtypes: list,
             restype=ctypes.c_int):
    """The C entry point ``symbol`` of kernel library ``name``, with its
    argument and result types set; builds the libraries on first use."""
    key = (name, symbol)
    fn = _funcs.get(key)
    if fn is None:
        so = library_path(name)
        if not os.path.exists(so):
            build_all(KERNELS if name in KERNELS else (name,))
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _funcs[key] = fn
    return fn


def count(wrapper, n: int = 1):
    """Add ``n`` launches to ``wrapper.launches``."""
    with _count_lock:
        wrapper.launches += n


def check(err: int, name: str):
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
