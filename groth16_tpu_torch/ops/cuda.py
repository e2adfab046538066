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

KERNEL_SOURCES = ("point.cu", "fold.cu", "ntt.cu", "tree.cu", "mul_chain.cu", "spmv.cu")
HEADERS = ("bn254_field.cuh", "bn254_curve.cuh", "bn254_ntt.cuh", "bn254_spmv.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
build_seconds = 0.0   # wall time of the nvcc build in this process (0 if cached)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "g16_point_add": [_I] + [_P] * 9 + [_L, _P],
    "g16_point_double_n": [_I] + [_P] * 6 + [_L, _I, _P],
    "g16_horner": [_I] + [_P] * 6 + [_L, _I, _I, _P],
    "g16_fold": [_I, _I] + [_P] * 6 + [_I, _L, _I, _I, _I, _P, _P],
    "g16_ntt_step": [_P] * 6 + [_I, _L, _I, _I, _I, _I, _P],
    "g16_quotient_pointwise": [_P, _L, _P, _I, _P, _P],
    "g16_tree_phase_a": [_I, _P, _P, _P, _L, _P],
    "g16_tree_mul_rows": [_I, _P, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _P],
    "g16_tree_invert": [_I, _P, _P, _L, _P],
    "g16_tree_level": [_I] + [_P] * 8 + [_L, _L, _P],
    "g16_tree_mid": [_I, _P, _P, _P, _P, _L, _P],
    "g16_fp_mul_chain": [_P, _P, _P, _I, _L, _P],
    "g16_issue_rate": [_I, _P, _P, _I, _I, _P],
    "g16_issue_rate_ops": [_I],
    "g16_spmv": [_P] * 8 + [_L, _L, _I, _I, _I, _P, _P, _L, _P, _P],
    "g16_fp_neg": [_P, _P, _L, _P],
}


def _tag(files, flags, csrc=CSRC) -> str:
    """A hash of the files of `csrc` (those it has) and the flags."""
    h = hashlib.sha256()
    for f in files:
        if not os.path.exists(os.path.join(csrc, f)):
            continue
        with open(os.path.join(csrc, f), "rb") as fh:
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


def _run(cmds) -> str:
    """Run compiler commands in parallel; raise with the output of any that
    fail, else return what they printed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for c in cmds]
    errors, log = [], []
    for c, p in zip(cmds, procs):
        out = p.communicate()[0].decode(errors="replace")
        log.append(out)
        if p.returncode:
            errors.append(f"$ {' '.join(c)}\n{out}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return "".join(log)


def compile_library(sources=KERNEL_SOURCES, extra_flags=(), csrc=CSRC,
                    rebuild: bool = False) -> tuple:
    """nvcc build of `sources` in `csrc` (one compiler process each, all
    started together) into one shared library under BUILD_DIR, keyed by a
    hash of the sources, headers and flags.  Returns (path, the compilers'
    output, the seconds the build took); "" and 0.0 when the library was
    already there, unless `rebuild` asks for the compilers to run anyway
    (for their output, e.g. ptxas's register report)."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    tag = _tag(tuple(sources) + HEADERS, flags, csrc)
    so = os.path.join(BUILD_DIR, f"libg16kernels-{tag}.so")
    if os.path.exists(so) and not rebuild:
        return so, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [os.path.join(BUILD_DIR, f"{src}.{tag}.{os.getpid()}.o") for src in sources]
    log = _run([[nvcc, *flags, "-c", os.path.join(csrc, src), "-o", obj]
                for src, obj in zip(sources, objs)])
    tmp = f"{so}.tmp{os.getpid()}"
    _run([[nvcc, *flags, "-shared", "-o", tmp, *objs]])
    os.replace(tmp, so)
    for obj in objs:
        os.remove(obj)
    return so, log, time.perf_counter() - t0


def _build() -> str:
    global build_seconds
    so, _, seconds = compile_library()
    build_seconds = build_seconds or seconds
    return so


def bind(path: str) -> ctypes.CDLL:
    """Load a kernel library and set the signatures of the functions it has."""
    L = ctypes.CDLL(path)
    for name, args in _SIGNATURES.items():
        fn = getattr(L, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return L


def lib_path() -> str:
    """Path of the kernel library, built on first use."""
    with _LOCK:
        return _build()


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises if it cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(_build())
        return _LIB


def use_library(path: str) -> None:
    """Make every wrapper launch from the kernel library at `path` (one that
    `compile_library` built): tools/bench_point_variants.py times builds of
    the same sources under other flags through the package's own wrappers."""
    global _LIB
    with _LOCK:
        _LIB = bind(path)


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
    L.shim_point_double_n.argtypes = [_I, _L, _I, _P, _P]
    L.shim_horner.argtypes = [_I, _L, _I, _I, _P, _P]
    L.shim_field_inv.argtypes = [_I, _L, _P, _P]
    L.shim_fold.argtypes = [_I, _I] + [_P] * 6 + [_I, _L, _I, _I, _I, _P]
    L.shim_tree_phase_a.argtypes = [_I, _P, _P, _P, _L]
    L.shim_tree_mul_rows.argtypes = [_I, _P, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L]
    L.shim_tree_invert.argtypes = [_I, _P, _P, _L]
    L.shim_tree_level.argtypes = [_I] + [_P] * 8 + [_L, _L]
    L.shim_tree_mid.argtypes = [_I, _P, _P, _P, _P, _L]
    L.shim_fp_mul_chain.argtypes = [_P, _P, _P, _I, _L]
    L.shim_ntt_step.argtypes = [_P] * 6 + [_I, _L, _I, _I, _I, _I]
    L.shim_quotient_pointwise.argtypes = [_P, _L, _P, _I, _P]
    L.shim_spmv.argtypes = [_P] * 8 + [_L, _L, _I, _I, _I, _I, _P, _P, _L, _P]
    L.shim_fp_neg.argtypes = [_P, _P, _L]
    for fn in (L.shim_field, L.shim_point, L.shim_fold, L.shim_tree_phase_a,
               L.shim_tree_mul_rows, L.shim_tree_invert, L.shim_tree_level, L.shim_tree_mid,
               L.shim_fp_mul_chain, L.shim_point_double_n, L.shim_horner, L.shim_field_inv,
               L.shim_ntt_step, L.shim_quotient_pointwise, L.shim_fp_neg):
        fn.restype = None
    L.shim_spmv.restype = _I
    return L
