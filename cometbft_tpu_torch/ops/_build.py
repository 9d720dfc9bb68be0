"""Build and load the port's CUDA kernels (csrc/*.cu) and its host
libraries (csrc/host/ed25519_batch.cpp, csrc/host/frame_crypto.cpp).

Each CUDA source is compiled by nvcc for sm_90a into a shared library
with a plain C interface and loaded with ctypes -- no PyTorch headers,
so a build takes seconds.  The host sources (HOST_SOURCES: the native
RLC batch verifier and the secret connection's frame pump, which run
on the CPU) are compiled by g++ with the reference's flags (GXX_FLAGS)
and loaded the same way.  A library's file name carries a hash of its
source, the flags and, for a CUDA source, the shared headers
(csrc/*.cuh), so a stale build is never loaded.  The build runs at first use (or all at once through
:func:`build_all`, one compiler process per source, started together)
into ``build/torch_kernels/`` beside the package, a directory that
``.gitignore`` lists.

A build failure raises with the compiler's stderr.  Nothing here falls
back to another path: a library that cannot build is a fault.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds
one where it launches its kernel and nowhere else.

Each build or first load of a library in the process is noted under
the seam ``build:<source>`` (ops/jitguard.py): once the guard is armed
and sealed, a build raises before the compiler starts.
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

from cometbft_tpu_torch.ops import jitguard as _jitguard

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "build", "torch_kernels",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the reference's g++ flags for its native libraries
#: (cometbft_tpu/utils/native_build.py)
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-std=c++17")

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PI32 = ctypes.POINTER(ctypes.c_int)
_CP, _LONG = ctypes.c_char_p, ctypes.c_long
_U64, _PU8 = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)

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
        {
            "sha512_padded_launch": (_VP, _I32, _VP, _VP, _I64, _VP),
            "sha512_keyed_launch": (_VP, _I64, _I32, _I32, _VP, _I64, _VP, _VP, _VP),
        },
    ),
    "verify_keyed": (
        "verify_keyed.cu",
        {
            "verify_keyed_launch": (_VP, _I64, _I32, _VP, _VP, _I64, _VP, _I64,
                                    _VP, _VP, _VP, _I64, _I32, _I32, _VP, _VP, _VP),
            "verify_keyed_group": (_I64,),
            "verify_keyed_smem_bytes": (_I32,),
        },
    ),
    "verify_generic": (
        "verify_generic.cu",
        {
            "verify_generic_launch": (_VP, _I64, _VP, _VP, _VP, _VP, _VP, _I64, _I32, _I32,
                                      _VP, _VP, _VP),
            "verify_generic_shape": (_I64, _PI32, _PI32),
            "verify_generic_smem_bytes": (_I32, _I32),
        },
    ),
    "build_tables": (
        "build_tables.cu",
        {
            "build_tables_launch": (_VP, _I64, _I32, _VP, _VP, _VP, _I32, _I32, _I32, _I32,
                                    _VP),
            "build_tables_shape": (_I64, _I32, _PI32, _PI32),
            "build_tables_smem_bytes": (_I32, _I32, _I32),
        },
    ),
}

#: host sources, built with g++: name -> (file, {C function: (restype,
#: argtypes)})
HOST_SOURCES = {
    "ed25519_batch": (
        "host/ed25519_batch.cpp",
        {
            "cmt_ed25519_rlc_verify": (_LONG, (_CP, ctypes.POINTER(ctypes.c_int32), _CP, _CP,
                                               _CP, _CP, _CP, _LONG, _LONG)),
        },
    ),
    "frame_crypto": (
        "host/frame_crypto.cpp",
        {
            "cmt_aead_seal": (_LONG, (_CP, _CP, _CP, _U64, _CP, _U64, _PU8, _U64)),
            "cmt_aead_open": (_LONG, (_CP, _CP, _CP, _U64, _CP, _U64, _PU8, _U64)),
            "cmt_frames_seal": (_LONG, (_CP, _U64, _CP, _U64, _PU8, _U64)),
            "cmt_frames_open": (_LONG, (_CP, _U64, _CP, _U64, _PU8, _U64,
                                        ctypes.POINTER(ctypes.c_uint32))),
            "cmt_frame_backend": (ctypes.c_int, ()),
        },
    ),
}

#: kernel name -> launches since the last reset
LAUNCHES: dict[str, int] = {
    "fe_mul": 0, "fe_sq": 0, "sha512_padded": 0, "sha512_keyed": 0,
    "verify_keyed": 0, "verify_generic": 0, "build_tables": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass
class Built:
    name: str
    path: str
    seconds: float   # compiler wall time (0.0 when the library was already built)
    ptxas: str       # nvcc's -Xptxas -v report (registers, spills); g++'s output
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


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the host library cannot be built")
    return found


def _target(name: str) -> tuple[str, str]:
    """(source path, library path): the library's name carries a hash of
    the source, the flags and, for a CUDA source, every shared header
    (csrc/*.cuh)."""
    host = name in HOST_SOURCES
    src = os.path.join(CSRC, (HOST_SOURCES if host else SOURCES)[name][0])
    headers = [] if host else sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    digest = hashlib.sha256()
    for path in [src, *headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest.update(" ".join(GXX_FLAGS if host else NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _load(name: str, path: str, seconds: float, ptxas: str) -> Built:
    lib = ctypes.CDLL(path)
    if name in HOST_SOURCES:
        for fn, (restype, argtypes) in HOST_SOURCES[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = restype
    else:
        for fn, argtypes in SOURCES[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
    return Built(name, path, seconds, ptxas, lib)


def build_all(names=None) -> dict[str, Built]:
    """Build (if needed) and load the named sources, default all (the
    CUDA sources and the host library): one compiler process per
    source, all started together.  Raises RuntimeError with the
    compiler's stderr on a failed build."""
    names = [*SOURCES, *HOST_SOURCES] if names is None else list(names)
    with _lock:
        todo = {}
        for name in names:
            if name in _built:
                continue
            src, out = _target(name)
            _jitguard.note_compile(f"build:{name}", os.path.basename(out))
            if os.path.exists(out):
                _built[name] = _load(name, out, 0.0, "")
            else:
                todo[name] = (src, out)
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = _nvcc() if any(n not in HOST_SOURCES for n in todo) else None
            procs = {}
            t0 = time.perf_counter()
            for name, (src, out) in todo.items():
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = ([_gxx(), *GXX_FLAGS, src, "-o", tmp] if name in HOST_SOURCES
                       else [nvcc, *NVCC_FLAGS, "-o", tmp, src])
                procs[name] = (
                    subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True),
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
                    compiler, table = (("g++", HOST_SOURCES) if name in HOST_SOURCES
                                       else ("nvcc", SOURCES))
                    failures.append(f"{compiler} failed for {table[name][0]} "
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
