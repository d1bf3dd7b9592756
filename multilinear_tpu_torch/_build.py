"""Build the CUDA kernels under ``csrc/`` with nvcc and load them via ctypes.

Nothing here runs at import.  The first wrapper that needs a kernel calls
:func:`lib`, which compiles every ``csrc/*.cu`` into its own shared library
(one nvcc process per source, all started together) inside
``multilinear_tpu_torch/build/`` and loads them.  Libraries are keyed by a
hash of the sources and flags, so an edited source is rebuilt and a built
one is reused.  A failed build raises with nvcc's output.

Each source exposes plain C functions that enqueue a kernel on the given
stream and return ``cudaGetLastError()``; no PyTorch header is
included, which keeps a cold build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_p = ctypes.c_void_p
_i64 = ctypes.c_int64
_int = ctypes.c_int

_ptr64 = ctypes.POINTER(ctypes.c_int64)
_elementwise = [_p, _p, _p, _i64, _i64, _i64, _ptr64, _int, _p]

# C function -> (source stem, argtypes).  Pointers and the stream are
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int.
KERNELS = {
    "mlt_mul": ("mul", _elementwise),
    "mlt_add": ("addsub", _elementwise),
    "mlt_sub": ("addsub", _elementwise),
    "mlt_sha256_messages": ("sha256_words", [_p, _p, _i64, _int, _int, _p]),
    "mlt_sha256_leaves": ("sha256_leaves", [_p, _i64, _i64, _p, _i64, _int, _int, _p]),
    "mlt_merkle_levels": ("merkle_levels", [_p, _p, _i64, _int, _int, _int, _p]),
    "mlt_butterfly": ("butterfly", [_p, _p, _p, _p, _i64, _i64, _i64, _i64, _int, _p]),
    "mlt_butterfly_notw": ("butterfly", [_p, _p, _p, _i64, _i64, _i64, _i64, _int, _p]),
    "mlt_butterfly2": ("butterfly2", [_p, _p, _p, _i64, _i64, _i64, _int, _i64, _int, _p]),
    "mlt_twiddle_mul3": ("twiddle_mul3", [_p, _p, _p, _p, _i64, _i64, _i64, _int, _int, _p]),
    "mlt_kron_tiles": ("kron", [_p, _p, _p, _i64, _i64, _i64, _int, _p]),
    "mlt_kron_parts": ("kron", [_int, _p, _p, _p, _i64, _i64, _int, _p]),
    "mlt_zm_tiles": ("zm", [_p, _p, _i64, _int, _int, _int, _int, _int, _i64, _int, _int, _p]),
    "mlt_fold": ("fold", [_p, _p, _p, _i64, _i64, _p, _int, _p]),
    "mlt_fold_commit": ("fold_commit", [_p, _p, _p, _p, _i64, _i64, _p, _int, _p]),
    "mlt_round_scalars": ("round_scalars", [_p, _p, _p, _p, _p, _p, _p, _int, _p]),
    "mlt_sumcheck_round_scalars": ("round_scalars", [_p, _p, _p, _int, _p, _p, _p, _p, _int, _p]),
    "mlt_sumcheck_max_degree": ("round_scalars", [_int]),
    "mlt_open_gather": ("open_gather", [_p, _i64, _i64, _p, _int, _p]),
    "mlt_sumcheck_sums": ("sumcheck_round", [_p, _i64, _int, _int, _p, _int, _p, _int, _p, _int, _p]),
    "mlt_sumcheck_fold": ("sumcheck_round", [_p, _p, _i64, _i64, _p, _int, _p]),
    "mlt_sumcheck_max_slots": ("sumcheck_round", [_int]),
}
# Built with the kernels but never loaded: probe kernels whose machine code
# the smoke script reads to count the instructions of each primitive.
PROBES = ("opcount",)
SOURCES = sorted({stem for stem, _ in KERNELS.values()} | set(PROBES))

_lock = threading.Lock()
_fns = None
library_paths: dict = {}  # source stem -> built shared library, set by lib()
build_seconds = None  # wall time of the build+load that populated _fns
build_log = ""  # nvcc's output (ptxas -v: registers, spills) of that build


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of multilinear_tpu_torch cannot be built on this machine"
    )


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _build_missing(paths: dict) -> str:
    missing = [s for s, p in paths.items() if not os.path.exists(p)]
    if not missing:
        return ""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for stem in missing:
        tmp = f"{paths[stem]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, stem + ".cu")]
        procs.append((stem, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for stem, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(stem)
        else:
            os.replace(tmp, paths[stem])
    if failed:
        raise RuntimeError(
            f"nvcc failed for {', '.join(failed)}:\n" + "\n".join(log)
        )
    return "\n".join(log)


def lib() -> dict:
    """{C function name: ctypes function}; builds and loads on first call."""
    global _fns, build_seconds, build_log
    with _lock:
        if _fns is None:
            t0 = time.perf_counter()
            key = _key()
            paths = {s: os.path.join(BUILD_DIR, f"lib{s}-{key}.so") for s in SOURCES}
            build_log = _build_missing(paths)
            library_paths.update(paths)
            libs = {s: ctypes.CDLL(path) for s, path in paths.items() if s not in PROBES}
            fns = {}
            for symbol, (stem, argtypes) in KERNELS.items():
                fn = getattr(libs[stem], symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[symbol] = fn
            _fns = fns
            build_seconds = time.perf_counter() - t0
        return _fns
