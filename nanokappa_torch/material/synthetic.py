"""Synthetic silicon-like phonon data for tests and benchmarks.

The reference ships phono3py data files (`test_material/Si/kappa-m313131.hdf5`)
that are not redistributable here, so the framework provides a physically
sensible stand-in: a cubic crystal with three acoustic branches (isotropic
sine dispersion, two of them degenerate) and three optical branches, with
Umklapp-like lifetimes tau ~ omega^-2 T^-1.

Two entry points:
  * `synthetic_material()`   — build a full-BZ `Material` directly (fast path
    for unit tests),
  * `write_synthetic_hdf5()` — emit a POSCAR + phono3py-format `kappa-*.hdf5`
    pair (IBZ-reduced with real symmetry operations) so the production loader
    (material/loader.py) is exercised end-to-end.
"""

from __future__ import annotations

import os

import numpy as np

from nanokappa_torch.material.poscar import Crystal
from nanokappa_torch.material.symmetry import reciprocal_operations, ir_reciprocal_mesh
from nanokappa_torch.material.tables import Material, fold_to_fbz

# branch parameters: (type, amplitude rad*THz)
# acoustic: omega = w_max * sin(pi/2 * s), s = |k| / k_max   (TA doubly degenerate)
# optical : omega = w0 - dw * s^2
_BRANCHES = (
    ("acoustic", 32.0),  # TA1  (~ Si TA: v_s ~ 5000 m/s)
    ("acoustic", 32.0),  # TA2  degenerate with TA1
    ("acoustic", 54.0),  # LA   (~ Si LA: v_s ~ 8400 m/s)
    ("optical", (95.0, 20.0)),  # TO1
    ("optical", (95.0, 20.0)),  # TO2  degenerate with TO1
    ("optical", (98.0, 12.0)),  # LO
)

# Ge-like preset (BASELINE config 2 swap test): heavier atoms -> softer
# branches, bigger cell, shorter lifetimes
_BRANCHES_GE = (
    ("acoustic", 18.0),
    ("acoustic", 18.0),
    ("acoustic", 31.0),
    ("optical", (56.0, 12.0)),
    ("optical", (56.0, 12.0)),
    ("optical", (58.0, 7.0)),
)

_A_LATTICE = 5.431  # angstrom, diamond-Si conventional-ish cubic cell
_A_LATTICE_GE = 5.658
_TAU0 = 30.0  # ps at omega_ref, T_ref
_OMEGA_REF = 30.0  # rad*THz
_T_REF = 300.0  # K

_PRESETS = {
    "Si": (_A_LATTICE, _BRANCHES, 30.0),
    "Ge": (_A_LATTICE_GE, _BRANCHES_GE, 18.0),
}


def _si_like_crystal(a_lattice: float = _A_LATTICE) -> Crystal:
    lattice = np.eye(3) * a_lattice
    # two-atom CsCl-like basis: full cubic point group O_h (48 operations),
    # 6 phonon branches (2 atoms x 3), matching the Si sample's branch count.
    pos = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    return Crystal(lattice=lattice, frac_positions=pos, species=["Si", "Si"])


def _dispersion(k_cart: np.ndarray, k_max: float, branches=_BRANCHES, a_lattice=_A_LATTICE):
    """omega (Q,J) and group velocity (Q,J,3) from folded cartesian k.

    At Brillouin-zone faces the group-velocity component perpendicular to the
    face is zero (omega is periodic in k, so its normal derivative vanishes
    there); without this, time reversal v(-k) = -v(k) breaks for zone-face
    modes and mirror-reflection correspondences would not exist."""
    knorm = np.linalg.norm(k_cart, axis=1)  # (Q,)
    s = np.clip(knorm / k_max, 0.0, 1.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        khat = np.where(knorm[:, None] > 1e-12, k_cart / np.maximum(knorm, 1e-300)[:, None], 0.0)
    k_face = np.pi / a_lattice  # cubic lattice: zone faces at |k_i| = pi/a
    on_face = np.abs(np.abs(k_cart) - k_face) < 1e-9 * k_face  # (Q,3)
    khat = np.where(on_face, 0.0, khat)

    omegas, vels = [], []
    for kind, par in branches:
        if kind == "acoustic":
            wmax = par
            w = wmax * np.sin(0.5 * np.pi * s)
            dwdk = wmax * 0.5 * np.pi / k_max * np.cos(0.5 * np.pi * s)
            v = dwdk[:, None] * khat
            v = np.where(knorm[:, None] > 1e-12, v, 0.0)  # Gamma: inactive
        else:
            w0, dw = par
            w = w0 - dw * s**2
            dwdk = -2.0 * dw * s / k_max
            v = dwdk[:, None] * khat
        omegas.append(w)
        vels.append(v)
    omega = np.stack(omegas, axis=1)  # (Q,J)
    vel = np.stack(vels, axis=1)  # (Q,J,3)
    return omega, vel


def _gamma_of(omega: np.ndarray, temperatures: np.ndarray, tau0=_TAU0) -> np.ndarray:
    """gamma(T,Q,J) in THz such that tau = 1/(4 pi gamma) = tau0 (w_ref/w)^2 (T_ref/T)."""
    T = temperatures[:, None, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        tau = tau0 * (_OMEGA_REF / np.maximum(omega, 1e-12)) ** 2 * (_T_REF / np.maximum(T, 1e-12))
    gamma = 1.0 / (4.0 * np.pi * tau)
    gamma = np.where((omega[None] > 0) & (T > 0), gamma, -1.0)  # -1 = no scattering
    return np.broadcast_to(gamma, (len(temperatures),) + omega.shape).copy()


def synthetic_material(mesh=(8, 8, 8), name: str | None = None, preset: str = "Si") -> Material:
    """Full-BZ synthetic material (no file IO, no IBZ round-trip)."""
    a_lat, branches, tau0 = _PRESETS[preset]
    name = name or f"synth{preset}"
    crystal = _si_like_crystal(a_lat)
    B = crystal.reciprocal_lattice
    mesh = np.asarray(mesh, dtype=int)

    grid = np.stack(
        np.meshgrid(*[np.arange(n) for n in mesh], indexing="ij"), axis=-1
    ).reshape(-1, 3)
    qpoints = grid / mesh  # reduced coords in [0,1)
    k_fbz = fold_to_fbz(qpoints @ B.T, B)
    k_max = float(np.linalg.norm(k_fbz, axis=1).max())

    omega, vel = _dispersion(k_fbz, k_max, branches, a_lat)
    vel = np.around(vel, decimals=10)  # match the loader (classes/Phonon.py:102)
    temperatures = np.arange(0.0, 501.0, 10.0)
    gamma = _gamma_of(omega, temperatures, tau0)
    with np.errstate(divide="ignore"):
        tau = np.where(gamma > 0, 1.0 / (4.0 * np.pi * np.maximum(gamma, 1e-300)), 0.0)

    return Material(
        name=name,
        qpoints=qpoints,
        omega=omega,
        group_vel=vel,
        wavevectors=k_fbz,
        tau=tau,
        tau_T=temperatures,
        reciprocal_lattice=B,
        volume_unitcell=crystal.volume,
        data_mesh=mesh,
    )


def write_synthetic_hdf5(folder: str, mesh=(8, 8, 8), preset: str = "Si") -> tuple[str, str]:
    """Write POSCAR + phono3py-format kappa hdf5 (IBZ-reduced). Returns paths."""
    os.makedirs(folder, exist_ok=True)
    a_lat, branches, tau0 = _PRESETS[preset]
    crystal = _si_like_crystal(a_lat)
    B = crystal.reciprocal_lattice
    mesh = np.asarray(mesh, dtype=int)

    poscar_path = os.path.join(folder, "POSCAR")
    with open(poscar_path, "w") as f:
        f.write(f"synthetic {preset}-like cubic\n1.0\n")
        for row in crystal.lattice:
            f.write("  {:.10f} {:.10f} {:.10f}\n".format(*row))
        f.write(f"{preset}\n2\nDirect\n")
        for row in crystal.frac_positions:
            f.write("  {:.10f} {:.10f} {:.10f}\n".format(*row))

    rec_ops = reciprocal_operations(crystal)
    ir_q, weights = ir_reciprocal_mesh(mesh, rec_ops)

    k_fbz = fold_to_fbz(ir_q @ B.T, B)
    k_max_full = _full_grid_kmax(mesh, B)
    omega, vel = _dispersion(k_fbz, k_max_full, branches, a_lat)
    vel = np.around(vel, decimals=10)
    frequency = omega / (2.0 * np.pi)
    temperatures = np.arange(0.0, 501.0, 10.0)
    gamma = _gamma_of(omega, temperatures, tau0)

    hdf_path = os.path.join(folder, f"kappa-m{mesh[0]}{mesh[1]}{mesh[2]}.hdf5")
    import h5py  # optional: only the hdf5 reader/writer needs it

    with h5py.File(hdf_path, "w") as h:
        h["mesh"] = mesh.astype(np.int64)
        h["qpoint"] = ir_q
        h["weight"] = weights.astype(np.int64)
        h["frequency"] = frequency
        h["group_velocity"] = vel
        h["gamma"] = gamma
        h["gamma_isotope"] = np.where(gamma > 0, gamma * 0.01, -1.0)
        h["temperature"] = temperatures

    return poscar_path, hdf_path


def _full_grid_kmax(mesh: np.ndarray, B: np.ndarray) -> float:
    grid = np.stack(
        np.meshgrid(*[np.arange(n) for n in mesh], indexing="ij"), axis=-1
    ).reshape(-1, 3)
    k = fold_to_fbz((grid / mesh) @ B.T, B)
    return float(np.linalg.norm(k, axis=1).max())
