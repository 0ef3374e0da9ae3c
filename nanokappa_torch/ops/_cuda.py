"""Build and load the hand-written CUDA kernels of `nanokappa_torch/csrc`.

Each `csrc/*.cu` file compiles with its own `nvcc`, all started together,
and the objects link into ONE shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so the build takes seconds). The
library is built at first use into `nanokappa_torch/build/` and rebuilt
whenever the hash of the sources or flags changes.

Flags: `sm_90a`, `-O3`, no fast math, no flush-to-zero (the pool's integer
columns are float32 bit patterns that read as denormals), and `--fmad=false`
so every product and sum rounds exactly as the plain torch twin's separate
operations do — the kernels are held bit-for-bit against those twins.

Every C entry takes the current CUDA stream and returns `cudaGetLastError()`;
`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points and their argument types (pointers and the stream are
# c_void_p: a plain int argument would be cut to 32 bits)
_SIGNATURES = {
    "nk_compact_indices": [_P, _L, _I, _P, _P, _P],
    "nk_compact_pool": [_P, _P, _I, _I, _P, _P, _P],
    "nk_event_round": [_P] * 14,
    "nk_megastep": [_P] * 12,
    "nk_raycast_large": [_P, _P, _L, _L, _L, _L, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "nk_scatter_rows": [_P, _P, _P, _I, _I, _I, _P],
}

_LIB = None
build_seconds: float | None = None  # wall time of this process's build


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))) + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def library(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use (`verbose` prints ptxas's
    register and shared-memory report of a fresh build)."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    srcs = _sources()
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    so = os.path.join(BUILD, f"libnk_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all started together, then one link
        objs, procs = [], []
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = os.path.join(BUILD, f"{os.path.basename(src)}.{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", *(["-Xptxas", "-v"] if verbose else []),
                   "-o", obj, src]
            objs.append(obj)
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [(p, *p.communicate()) for p in procs]
        tmp = f"{so}.{os.getpid()}.tmp"
        if all(p.returncode == 0 for p, _, _ in outs):
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs], capture_output=True, text=True
            )
            outs.append((link, link.stdout, link.stderr))
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        for p, out, err in outs:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}\n{err}")
        if verbose:
            print("".join(err for _, _, err in outs), flush=True)
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nk_error_string.argtypes = [ctypes.c_int]
    lib.nk_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = _LIB.nk_error_string(err).decode() if _LIB is not None else ""
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream(t) -> ctypes.c_void_p:
    """The current CUDA stream of t's device, as its raw handle (~0.1 us of
    host time a call, against ~4 us for torch.cuda.current_stream, on the
    host of an H100 machine: PERF.md)."""
    import torch

    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
