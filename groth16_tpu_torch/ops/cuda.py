"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled by nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes.  The build runs at first use, from the
sources in the package, into `groth16_tpu_torch/.build/` (git-ignored),
keyed by a hash of the sources and flags, so a fresh checkout builds once.
A failed build raises: there is no fallback to the plain versions for CUDA
tensors.

`host_shim()` builds csrc/bn254_host_shim.cpp with g++: the kernels'
per-thread arithmetic compiled for the CPU, used by the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, ".build")

KERNEL_SOURCES = ("point.cu", "fold.cu", "ntt.cu", "tree.cu")
HEADERS = ("bn254_field.cuh", "bn254_curve.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
build_seconds = 0.0   # wall time of the nvcc build in this process (0 if cached)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "g16_point_add": [_I] + [_P] * 9 + [_L, _P],
    "g16_point_double": [_I] + [_P] * 6 + [_L, _P],
    "g16_fold": [_I, _I, _P, _P, _P, _P, _I, _L, _P],
    "g16_ntt": [_P, _P, _P, _P, _I, _L, _I, _P],
    "g16_tree_phase_a": [_I, _P, _P, _P, _L, _P],
    "g16_tree_mul_rows": [_I, _P, _P, _P, _L, _P],
    "g16_tree_invert": [_I, _P, _P, _L, _P],
    "g16_tree_phase_b": [_I] + [_P] * 9 + [_L, _P],
}


def _tag(files, flags) -> str:
    h = hashlib.sha256()
    for f in files:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run(cmds) -> None:
    """Run compiler commands in parallel; raise with the output of any that fail."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for c in cmds]
    errors = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode:
            errors.append(f"$ {' '.join(c)}\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def _build() -> str:
    global build_seconds
    tag = _tag(KERNEL_SOURCES + HEADERS, NVCC_FLAGS)
    so = os.path.join(BUILD_DIR, f"libg16kernels-{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [os.path.join(BUILD_DIR, f"{src}.{tag}.{os.getpid()}.o") for src in KERNEL_SOURCES]
    _run([[nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj]
          for src, obj in zip(KERNEL_SOURCES, objs)])
    tmp = f"{so}.tmp{os.getpid()}"
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    os.replace(tmp, so)
    for obj in objs:
        os.remove(obj)
    build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises if it cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            L = ctypes.CDLL(_build())
            for name, args in _SIGNATURES.items():
                fn = getattr(L, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = L
        return _LIB


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def host_shim():
    """g++ build of the kernels' per-thread arithmetic (csrc/bn254_host_shim.cpp),
    or None when g++ is absent."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    flags = ("-O2", "-std=c++17", "-shared", "-fPIC")
    so = os.path.join(BUILD_DIR, f"libbn254shim-{_tag(('bn254_host_shim.cpp',) + HEADERS, flags)}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        _run([[gxx, *flags, "-o", tmp, os.path.join(CSRC, "bn254_host_shim.cpp")]])
        os.replace(tmp, so)
    L = ctypes.CDLL(so)
    L.shim_field.argtypes = [_I, _I, _L, _P, _P, _P]
    L.shim_point.argtypes = [_I, _I, _L, _P, _P]
    L.shim_fold.argtypes = [_I, _I, _P, _P, _P, _P, _I, _L]
    L.shim_tree_phase_a.argtypes = [_I, _P, _P, _P, _L]
    L.shim_tree_invert.argtypes = [_I, _P, _P, _L]
    L.shim_tree_phase_b.argtypes = [_I] + [_P] * 9 + [_L]
    for fn in (L.shim_field, L.shim_point, L.shim_fold, L.shim_tree_phase_a,
               L.shim_tree_invert, L.shim_tree_phase_b):
        fn.restype = None
    return L
