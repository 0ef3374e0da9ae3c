"""ctypes loaders for the native host code, compiled on demand with g++
into the package build directory under a hash of the source.

`native/host_kernels.cpp` (the checkout's, shared with the JAX package):
each entry point but `format_particle_rows` returns None when the library
is missing and its caller takes a NumPy path. That source is read from the
checkout's `native/` folder, which the package does not ship: an installed
nanokappa_torch, or a machine without g++, always takes the NumPy path.

`nanokappa_torch/csrc/host_checkpoint.cpp` (the port's own): the driver's
particle_data.txt checkpoint, formatted in chunks of pool lanes on the
threads the process can use (`CheckpointFormatter`, `checkpoint_threads`).
Without g++ the driver raises at its first checkpoint.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_LIBS: dict[str, ctypes.CDLL | None] = {}

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "host_kernels.cpp")
_CHECKPOINT_SRC = os.path.join(_HERE, "csrc", "host_checkpoint.cpp")


def _build(src: str, stem: str, declare, flags: tuple = ()) -> ctypes.CDLL | None:
    """The library of `src`, built at first use and loaded once per process,
    its entry points typed by `declare(lib)`; None without the source, g++
    or a loadable library."""
    if src in _LIBS:
        return _LIBS[src]
    lib = None
    try:
        with open(src, "rb") as f:
            tag = hashlib.sha1(f.read()).hexdigest()[:16]
        cache = os.path.join(_HERE, "build")
        os.makedirs(cache, exist_ok=True)
        so = os.path.join(cache, f"{stem}_{tag}.so")
        if not os.path.exists(so):
            # build under a private name, then rename: concurrent test
            # workers never load a half-written library
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", *flags, src, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        declare(lib)
    except (OSError, subprocess.CalledProcessError):  # no source, g++ or library
        lib = None
    _LIBS[src] = lib
    return lib


_c_dp = ctypes.POINTER(ctypes.c_double)
_c_i64 = ctypes.POINTER(ctypes.c_int64)


def _declare_host(lib):
    c_u8 = ctypes.POINTER(ctypes.c_uint8)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    lib.crystal_energy_table.argtypes = [
        _c_dp, c_u8, ctypes.c_int64, _c_dp, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, _c_dp,
    ]
    lib.build_alias.argtypes = [_c_dp, ctypes.c_int64, _c_dp, _c_i64, _c_i64]
    lib.count_crossings.argtypes = [
        _c_dp, _c_dp, ctypes.c_int64, _c_dp, _c_dp, _c_dp, ctypes.c_int64, c_i32,
    ]
    lib.format_particle_rows.argtypes = [
        _c_i64, _c_i64, _c_dp, _c_dp, _c_dp, _c_dp, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.format_particle_rows.restype = ctypes.c_int64


def _load():
    return _build(_SRC, "libnk_host", _declare_host)


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
    """particle_data.txt rows, formatted natively on one thread (np.savetxt's
    per-row Python formatting costs seconds at 1e6 rows). Byte-identical to
    np.savetxt with fmt='%d, %d, %.3f, %.3f, %.3f, %.6e'; the driver's
    checkpoint formats the same bytes through `CheckpointFormatter`.
    Raises without the library."""
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


# ---------------------------------------------------------------------------
# the driver's checkpoint (csrc/host_checkpoint.cpp)
# ---------------------------------------------------------------------------

CHUNK_LANES = 16384  # lanes of one chunk of the pass; threads take chunks in turn
ROW_BYTES = 192  # the most bytes of one row (host_checkpoint.cpp kRowMax)
LANES_PER_THREAD = 65536  # a thread for fewer lanes costs more to start than it saves
MAX_THREADS = 16


def _declare_checkpoint(lib):
    c_f = ctypes.c_void_p
    i64 = ctypes.c_int64
    lib.format_checkpoint_rows.argtypes = [
        c_f, i64, i64, c_f, i64, c_f, i64, c_f, i64,
        _c_dp, ctypes.c_int32, ctypes.c_int32,
        i64, ctypes.c_int32, c_f, i64, _c_i64,
    ]
    lib.format_checkpoint_rows.restype = i64


def _cores_of_quota(quota: str, period: str) -> int | None:
    if quota in ("max", "-1"):
        return None
    return max(1, -(-int(quota) // int(period)))


def _cpu_max(folder: str) -> int | None:
    """cgroup v2: `cpu.max` holds "<quota> <period>" or "max <period>"."""
    with open(os.path.join(folder, "cpu.max")) as f:
        return _cores_of_quota(*f.read().split()[:2])


def _cfs_quota(folder: str) -> int | None:
    """cgroup v1: `cpu.cfs_quota_us` (-1 without a quota) and its period."""
    with open(os.path.join(folder, "cpu.cfs_quota_us")) as f:
        quota = f.read().strip()
    with open(os.path.join(folder, "cpu.cfs_period_us")) as f:
        return _cores_of_quota(quota, f.read().strip())


def _cgroup_cpu_limit() -> int | None:
    """The least CPU quota, rounded up to whole cores, of the cgroups on the
    path from the process's own to the root (v2 `cpu.max`, v1
    `cpu.cfs_quota_us`); None where no quota is set or none is readable."""
    try:
        with open("/proc/self/cgroup") as f:
            entries = [ln.rstrip("\n").split(":", 2) for ln in f if ln.count(":") >= 2]
    except OSError:
        return None
    best = None
    for hid, ctrls, path in entries:
        if hid == "0":
            root, read = "/sys/fs/cgroup", _cpu_max
        elif "cpu" in ctrls.split(","):
            root, read = os.path.join("/sys/fs/cgroup", ctrls), _cfs_quota
        else:
            continue
        parts = [p for p in path.split("/") if p]
        for k in range(len(parts), -1, -1):
            try:
                cores = read(os.path.join(root, *parts[:k]))
            except (OSError, ValueError, TypeError):
                continue
            if cores is not None:
                best = cores if best is None else min(best, cores)
    return best


def usable_cores() -> int:
    """The cores this process may run on: its CPU affinity, capped by its
    cgroup's CPU quota where one is set."""
    n = len(os.sched_getaffinity(0))
    limit = _cgroup_cpu_limit()
    return n if limit is None else max(1, min(n, limit))


def checkpoint_threads(lanes: int, cores: int) -> int:
    """Threads of a checkpoint's pass over `lanes` pool lanes on `cores`
    usable cores: one per LANES_PER_THREAD lanes, at most MAX_THREADS."""
    return max(1, min(cores, -(-int(lanes) // LANES_PER_THREAD), MAX_THREADS))


def _lane_view(a: np.ndarray, dtype) -> np.ndarray:
    """`a` as `dtype` with non-negative strides that are whole elements (a
    copy only where it has not)."""
    a = np.asarray(a)
    if a.dtype != dtype or any(s < 0 or s % a.itemsize for s in a.strides):
        a = np.ascontiguousarray(a, dtype=dtype)
    return a


class CheckpointFormatter:
    """particle_data.txt rows of a host_state()'s lanes (the alive ones, in
    lane order), formatted natively in chunks on `threads` threads: the
    bytes of np.savetxt(fmt='%d, %d, %.3f, %.3f, %.3f, %.6e') over the
    columns [q, branch, x, y, z, occupation], the mode clipped into the
    table and the occupation float64(dev) + be_table[mode]. It keeps its output buffer from call to
    call: the views a call returns hold until the next call."""

    def __init__(self, be_table: np.ndarray, n_branches: int):
        self.be_table = np.ascontiguousarray(be_table, dtype=np.float64)
        self.n_branches = int(n_branches)
        self._out = np.empty(0, np.uint8)

    def __call__(self, mode, pos, dev, alive, threads: int) -> list[memoryview]:
        lib = _build(_CHECKPOINT_SRC, "libnk_checkpoint", _declare_checkpoint, ("-pthread",))
        if lib is None:
            raise RuntimeError(
                f"the checkpoint writer ({_CHECKPOINT_SRC}, built with g++) is "
                "required to write particle_data.txt"
            )
        mode = _lane_view(mode, np.int32)
        pos = _lane_view(pos, np.float32)
        dev = _lane_view(dev, np.float32)
        alive = np.ascontiguousarray(alive, dtype=np.bool_)
        n = len(alive)
        if mode.shape != (n,) or dev.shape != (n,) or pos.shape != (n, 3):
            raise ValueError(
                f"checkpoint rows disagree: mode {mode.shape}, pos {pos.shape}, "
                f"dev {dev.shape}, alive {alive.shape}"
            )
        n_chunks = -(-n // CHUNK_LANES)
        cap = ROW_BYTES * CHUNK_LANES
        if len(self._out) < n_chunks * cap:
            # pages are touched only where rows land
            self._out = np.empty(n_chunks * cap, np.uint8)
        sizes = np.zeros(n_chunks, np.int64)
        err = lib.format_checkpoint_rows(
            pos.ctypes.data, pos.strides[0] // 4, pos.strides[1] // 4,
            mode.ctypes.data, mode.strides[0] // 4,
            dev.ctypes.data, dev.strides[0] // 4,
            alive.ctypes.data, n,
            _ptr(self.be_table, ctypes.c_double), len(self.be_table), self.n_branches,
            CHUNK_LANES, int(threads), self._out.ctypes.data, cap,
            _ptr(sizes, ctypes.c_int64),
        )
        if err < 0:
            raise RuntimeError(f"format_checkpoint_rows: a chunk overflowed {cap} bytes")
        view = memoryview(self._out)
        return [view[c * cap: c * cap + int(w)] for c, w in enumerate(sizes)]
