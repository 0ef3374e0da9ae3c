"""ctypes loader for the native host kernels (native/host_kernels.cpp).

Compiled on demand with g++ into the package build directory; each entry point
but `format_particle_rows` returns None when the library is missing and its
caller takes a NumPy path. The C++ source is read from the checkout's
`native/` folder, which the package does not ship: an installed
nanokappa_torch, or a machine without g++, always takes the NumPy path and
cannot write particle_data.txt.
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
        lib.format_particle_rows.argtypes = [
            c_i64, c_i64, c_dp, c_dp, c_dp, c_dp, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.format_particle_rows.restype = ctypes.c_int64
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


def format_particle_rows(
    q: np.ndarray, j: np.ndarray, pos: np.ndarray, occ: np.ndarray
) -> memoryview:
    """particle_data.txt rows, formatted natively (np.savetxt's per-row
    Python formatting costs seconds at 1e6 rows on the driver's 100-step
    checkpoint path). Byte-identical to np.savetxt with
    fmt='%d, %d, %.3f, %.3f, %.3f, %.6e'. Raises without the library."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"the native host library ({_SRC}, built with g++) is required to "
            "write particle_data.txt"
        )
    n = len(q)
    qq = np.ascontiguousarray(q, dtype=np.int64)
    jj = np.ascontiguousarray(j, dtype=np.int64)
    x = np.ascontiguousarray(pos[:, 0], dtype=np.float64)
    y = np.ascontiguousarray(pos[:, 1], dtype=np.float64)
    z = np.ascontiguousarray(pos[:, 2], dtype=np.float64)
    oc = np.ascontiguousarray(occ, dtype=np.float64)
    cap = 96 * max(n, 1) + 256
    buf = np.empty(cap, dtype=np.uint8)  # no zero fill, no copy of the cap
    w = lib.format_particle_rows(
        _ptr(qq, ctypes.c_int64), _ptr(jj, ctypes.c_int64),
        _ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
        _ptr(z, ctypes.c_double), _ptr(oc, ctypes.c_double),
        n, ctypes.cast(buf.ctypes.data, ctypes.c_char_p), cap,
    )
    if w < 0:
        raise RuntimeError(f"format_particle_rows: {n} rows overflow {cap} bytes")
    return memoryview(buf)[: int(w)]
