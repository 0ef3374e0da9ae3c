"""The benchmark's raw material: the synthetic Si-like phonon table.

Both sides get the same raw arrays: the harness hands them to the
program's Material, and the reference derives every table it needs from
them itself (reference/physics.py). The dispersion is a cubic crystal
(simple cubic lattice, two-atom basis: the full O_h point group) with
three acoustic branches (isotropic sine dispersion, TA doubly degenerate)
and three optical branches, and Umklapp-like lifetimes
tau = tau0 (omega_ref / omega)^2 (T_ref / T) on a 10 K grid from 0 to
500 K. It stands in for the phono3py kappa-m313131.hdf5 of the Nano-kappa
Si example, which is not redistributable: the same 31^3 mesh and
178,746 modes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# branch parameters: (type, amplitude rad*THz); acoustic omega = w_max
# sin(pi/2 s), optical omega = w0 - dw s^2, s = |k| / k_max
_BRANCHES = {
    "Si": (("acoustic", 32.0), ("acoustic", 32.0), ("acoustic", 54.0),
           ("optical", (95.0, 20.0)), ("optical", (95.0, 20.0)), ("optical", (98.0, 12.0))),
    "Ge": (("acoustic", 18.0), ("acoustic", 18.0), ("acoustic", 31.0),
           ("optical", (56.0, 12.0)), ("optical", (56.0, 12.0)), ("optical", (58.0, 7.0))),
}
_LATTICE = {"Si": 5.431, "Ge": 5.658}  # angstrom, cubic
_TAU0 = {"Si": 30.0, "Ge": 18.0}  # ps at omega_ref, T_ref
_OMEGA_REF = 30.0  # rad*THz
_T_REF = 300.0  # K


@dataclass
class RawMaterial:
    """The raw arrays of a phonon table, (Q, J) per q-point and branch."""

    name: str
    qpoints: np.ndarray  # (Q, 3) reduced coordinates in [0, 1)
    omega: np.ndarray  # (Q, J) rad*THz
    group_vel: np.ndarray  # (Q, J, 3) A*THz
    wavevectors: np.ndarray  # (Q, 3) rad/A, folded to the first zone
    tau: np.ndarray  # (nT, Q, J) ps, 0 = no scattering
    tau_T: np.ndarray  # (nT,) K
    reciprocal_lattice: np.ndarray  # (3, 3), columns b_i
    volume_unitcell: float  # A^3
    data_mesh: np.ndarray  # (3,)


def fold_to_fbz(k: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Each k translated by reciprocal lattice vectors to its smallest norm
    (ties keep the untranslated k)."""
    a = np.array([-1, 0, 1])
    shifts = np.stack(np.meshgrid(a, a, a, indexing="ij"), axis=-1).reshape(-1, 3)
    shifts_cart = shifts @ B.T
    i0 = int(np.nonzero(np.all(shifts == 0, axis=1))[0][0])
    k = np.array(k, dtype=float)
    active = np.ones(k.shape[0], dtype=bool)
    while np.any(active):
        cand = k[active, None, :] + shifts_cart[None, :, :]
        norm = np.linalg.norm(cand, axis=-1)
        imin = np.argmin(norm, axis=1)
        tied = np.abs(norm[np.arange(len(imin)), imin] - norm[:, i0]) < 1e-12
        imin = np.where(tied, i0, imin)
        k[active] = cand[np.arange(len(imin)), imin]
        active[active.nonzero()[0]] = imin != i0
    return k


def _dispersion(k_cart, k_max, branches, a_lattice):
    """omega (Q, J) and group velocity (Q, J, 3); the velocity component
    normal to a zone face is zero there (omega is periodic in k)."""
    knorm = np.linalg.norm(k_cart, axis=1)
    s = np.clip(knorm / k_max, 0.0, 1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        khat = np.where(knorm[:, None] > 1e-12, k_cart / np.maximum(knorm, 1e-300)[:, None], 0.0)
    k_face = np.pi / a_lattice
    khat = np.where(np.abs(np.abs(k_cart) - k_face) < 1e-9 * k_face, 0.0, khat)
    omegas, vels = [], []
    for kind, par in branches:
        if kind == "acoustic":
            w = par * np.sin(0.5 * np.pi * s)
            dwdk = par * 0.5 * np.pi / k_max * np.cos(0.5 * np.pi * s)
            v = np.where(knorm[:, None] > 1e-12, dwdk[:, None] * khat, 0.0)
        else:
            w0, dw = par
            w = w0 - dw * s**2
            v = (-2.0 * dw * s / k_max)[:, None] * khat
        omegas.append(w)
        vels.append(v)
    return np.stack(omegas, axis=1), np.stack(vels, axis=1)


def synthetic_material(mesh=(8, 8, 8), preset: str = "Si") -> RawMaterial:
    """The full-zone synthetic table on a mesh (no file read)."""
    a_lat = _LATTICE[preset]
    lattice = np.eye(3) * a_lat
    B = np.linalg.inv(lattice) * 2.0 * np.pi
    mesh = np.asarray(mesh, dtype=int)
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in mesh], indexing="ij"), axis=-1).reshape(-1, 3)
    qpoints = grid / mesh
    k_fbz = fold_to_fbz(qpoints @ B.T, B)
    k_max = float(np.linalg.norm(k_fbz, axis=1).max())
    omega, vel = _dispersion(k_fbz, k_max, _BRANCHES[preset], a_lat)
    vel = np.around(vel, decimals=10)
    temperatures = np.arange(0.0, 501.0, 10.0)
    T = temperatures[:, None, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        tau = _TAU0[preset] * (_OMEGA_REF / np.maximum(omega, 1e-12)) ** 2 * (_T_REF / np.maximum(T, 1e-12))
    tau = np.where((omega[None] > 0) & (T > 0), tau, 0.0)
    return RawMaterial(
        name=f"synth{preset}", qpoints=qpoints, omega=omega, group_vel=vel, wavevectors=k_fbz,
        tau=np.broadcast_to(tau, (len(temperatures),) + omega.shape).copy(), tau_T=temperatures,
        reciprocal_lattice=B, volume_unitcell=float(abs(np.linalg.det(lattice))), data_mesh=mesh,
    )
