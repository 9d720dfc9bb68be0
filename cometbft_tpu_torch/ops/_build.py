"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface and loaded with ctypes -- no PyTorch headers, so a
build takes seconds.  The library's file name carries a hash of the
source, the shared headers (csrc/*.cuh) and the flags, so a stale
build is never loaded.  The build runs at first use (or all at once
through :func:`build_all`, one nvcc process per source, started
together) into ``build/torch_kernels/`` beside the package, a directory
that ``.gitignore`` lists.

A build failure raises with nvcc's stderr.  Nothing here falls back to
a CPU path: a kernel that cannot build is a fault.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "build", "torch_kernels",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: source name -> (file, {C function: argtypes})
SOURCES = {
    "field": (
        "field.cu",
        {
            "fe_mul_launch": (_VP, _VP, _VP, _I64, _VP),
            "fe_sq_launch": (_VP, _VP, _I64, _I32, _VP),
        },
    ),
    "sha512": (
        "sha512.cu",
        {"sha512_padded_launch": (_VP, _I32, _VP, _VP, _I64, _VP)},
    ),
    "verify_keyed": (
        "verify_keyed.cu",
        {
            "verify_keyed_launch": (_VP, _I64, _I32, _VP, _VP, _I64, _VP, _I64,
                                    _VP, _VP, _VP, _I64, _I32, _VP),
            "verify_keyed_smem_bytes": (),
        },
    ),
}

#: kernel name -> launches since the last reset
LAUNCHES: dict[str, int] = {
    "fe_mul": 0, "fe_sq": 0, "sha512_padded": 0, "verify_keyed": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass
class Built:
    name: str
    path: str
    seconds: float   # nvcc wall time (0.0 when the library was already built)
    ptxas: str       # nvcc's -Xptxas -v report (registers, spills)
    lib: ctypes.CDLL


_lock = threading.Lock()
_built: dict[str, Built] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _target(name: str) -> tuple[str, str]:
    """(source path, library path): the library's name carries a hash of
    the source, every shared header (csrc/*.cuh) and the flags."""
    src = os.path.join(CSRC, SOURCES[name][0])
    digest = hashlib.sha256()
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _load(name: str, path: str, seconds: float, ptxas: str) -> Built:
    lib = ctypes.CDLL(path)
    for fn, argtypes in SOURCES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return Built(name, path, seconds, ptxas, lib)


def build_all(names=None) -> dict[str, Built]:
    """Build (if needed) and load the named sources, default all: one
    nvcc per source, all started together.  Raises RuntimeError with
    nvcc's stderr on a failed build."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        todo = {}
        for name in names:
            if name in _built:
                continue
            src, out = _target(name)
            if os.path.exists(out):
                _built[name] = _load(name, out, 0.0, "")
            else:
                todo[name] = (src, out)
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            t0 = time.perf_counter()
            for name, (src, out) in todo.items():
                tmp = f"{out}.{os.getpid()}.tmp"
                procs[name] = (
                    subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True,
                    ),
                    tmp, out,
                )
            failures = []
            results = {}
            for name, (proc, tmp, out) in procs.items():
                stdout, stderr = proc.communicate()
                results[name] = (proc.returncode, stdout + stderr, tmp, out,
                                 time.perf_counter() - t0)
            for name, (rc, log, tmp, out, secs) in results.items():
                if rc != 0:
                    failures.append(f"nvcc failed for {SOURCES[name][0]} "
                                    f"(exit {rc}):\n{log}")
                    continue
                os.replace(tmp, out)
                _built[name] = _load(name, out, secs, log)
            if failures:
                raise RuntimeError("\n".join(failures))
        return {n: _built[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built at first use."""
    built = _built.get(name)
    if built is None:
        built = build_all([name])[name]
    return built.lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launcher reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
