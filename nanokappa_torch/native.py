"""ctypes loader for the native host kernels (native/host_kernels.cpp).

Compiled on demand with g++ into the package build directory; each entry point
returns None when the library is missing and its caller takes a NumPy path.
The C++ source is read from the checkout's `native/` folder, which the
package does not ship: an installed nanokappa_torch, or a machine without g++,
always takes the NumPy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "host_kernels.cpp",
)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha1(f.read()).hexdigest()[:16]
        cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
        os.makedirs(cache, exist_ok=True)
        so = os.path.join(cache, f"libnk_host_{tag}.so")
        if not os.path.exists(so):
            # build under a private name, then rename: concurrent test
            # workers never load a half-written library
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        c_dp = ctypes.POINTER(ctypes.c_double)
        c_u8 = ctypes.POINTER(ctypes.c_uint8)
        c_i64 = ctypes.POINTER(ctypes.c_int64)
        c_i32 = ctypes.POINTER(ctypes.c_int32)
        lib.crystal_energy_table.argtypes = [
            c_dp, c_u8, ctypes.c_int64, c_dp, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, c_dp,
        ]
        lib.build_alias.argtypes = [c_dp, ctypes.c_int64, c_dp, c_i64, c_i64]
        lib.count_crossings.argtypes = [
            c_dp, c_dp, ctypes.c_int64, c_dp, c_dp, c_dp, ctypes.c_int64, c_i32,
        ]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):  # no source, g++ or library
        _LIB = None
    return _LIB


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def crystal_energy_sums(
    omega: np.ndarray, active: np.ndarray, T: np.ndarray, hbar: float, kb: float
) -> np.ndarray | None:
    """sum_m hbar*omega_m*n0(T, omega_m) for each T; None if no native lib."""
    lib = _load()
    if lib is None:
        return None
    omega = np.ascontiguousarray(omega.reshape(-1), dtype=np.float64)
    act = np.ascontiguousarray(active.reshape(-1), dtype=np.uint8)
    T = np.ascontiguousarray(T, dtype=np.float64)
    out = np.empty(len(T), dtype=np.float64)
    lib.crystal_energy_table(
        _ptr(omega, ctypes.c_double), _ptr(act, ctypes.c_uint8), len(omega),
        _ptr(T, ctypes.c_double), len(T),
        ctypes.c_double(hbar), ctypes.c_double(kb), _ptr(out, ctypes.c_double),
    )
    return out


def build_alias(weights: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    lib = _load()
    if lib is None:
        return None
    w = np.ascontiguousarray(weights, dtype=np.float64)
    n = len(w)
    prob = np.empty(n, dtype=np.float64)
    alias = np.empty(n, dtype=np.int64)
    work = np.empty(2 * n, dtype=np.int64)
    lib.build_alias(
        _ptr(w, ctypes.c_double), n, _ptr(prob, ctypes.c_double),
        _ptr(alias, ctypes.c_int64), _ptr(work, ctypes.c_int64),
    )
    return prob, alias


def count_crossings(
    origins: np.ndarray, direction: np.ndarray,
    tri_a: np.ndarray, tri_e1: np.ndarray, tri_e2: np.ndarray,
) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    o = np.ascontiguousarray(origins, dtype=np.float64)
    d = np.ascontiguousarray(direction, dtype=np.float64)
    a = np.ascontiguousarray(tri_a, dtype=np.float64)
    e1 = np.ascontiguousarray(tri_e1, dtype=np.float64)
    e2 = np.ascontiguousarray(tri_e2, dtype=np.float64)
    out = np.empty(len(o), dtype=np.int32)
    lib.count_crossings(
        _ptr(o, ctypes.c_double), _ptr(d, ctypes.c_double), len(o),
        _ptr(a, ctypes.c_double), _ptr(e1, ctypes.c_double),
        _ptr(e2, ctypes.c_double), len(a), _ptr(out, ctypes.c_int32),
    )
    return out
