"""Load phono3py `kappa-*.hdf5` + VASP POSCAR into a `Material`.

Behavioural parity with the reference loader (classes/Phonon.py:66-151):
  * hdf5 fields read: mesh, qpoint, weight, frequency (THz), group_velocity
    (THz*A), gamma (THz), optional gamma_isotope, temperature (K)
  * negative frequencies clamped to 0 (classes/Phonon.py:163)
  * IBZ -> FBZ expansion by the reciprocal point group, with the weight
    consistency check (classes/Phonon.py:515-564)
  * lifetimes tau = 1 / (4*pi*gamma), 0 where gamma <= 0 (classes/Phonon.py:326-336)
  * wavevectors folded to the first Brillouin zone (classes/Phonon.py:189-247)
  * optional crystal rotation of k and v (classes/Phonon.py:284-314)

Symmetry operations come from our own finder (material/symmetry.py) since
phonopy is not a dependency of this framework.
"""

from __future__ import annotations

import os

import numpy as np

from nanokappa_torch.material.poscar import parse_poscar
from nanokappa_torch.material.symmetry import reciprocal_operations
from nanokappa_torch.material.tables import Material, fold_to_fbz


class FBZExpansionError(RuntimeError):
    pass


def expand_fbz(
    qpoints: np.ndarray,
    weights: np.ndarray,
    tensor: np.ndarray,
    rank: int,
    rec_ops: np.ndarray,
    reciprocal_lattice: np.ndarray,
    check_weights: bool = True,
):
    """Expand per-IBZ-qpoint `tensor` (q on axis 0) to the full BZ.

    rank 0: scalar per (q, ...) entries are copied; rank 1: the last axis is a
    cartesian vector rotated with B R B^-1. Returns (qpoints_fbz, tensor_fbz).
    Matches reference classes/Phonon.py:515-564 (including the weight check
    that aborts when the orbit size disagrees with the hdf5 weight).
    """
    B = reciprocal_lattice
    Binv = np.linalg.inv(B)
    r_carts = np.array([B @ R @ Binv for R in rec_ops])  # (n_ops,3,3)

    out_q, out_t = [], []
    for i, q in enumerate(qpoints):
        qbz = np.mod(q, 1.0)
        star = np.mod(rec_ops @ qbz, 1.0)
        star = np.around(star, decimals=6)
        uq, idx = np.unique(star, axis=0, return_index=True)
        if check_weights and weights[i] != len(idx):
            raise FBZExpansionError(
                f"IBZ weight mismatch at q-point {i}: weight {weights[i]} "
                f"!= orbit size {len(idx)}"
            )
        tq = tensor[i]
        if rank == 0:
            tt = np.broadcast_to(tq, (len(idx),) + tq.shape)
        elif rank == 1:
            # rotate the trailing cartesian axis: (J,3) -> R_cart @ v
            tt = np.einsum("nab,jb->nja", r_carts[idx], tq)
        else:
            raise FBZExpansionError("expand_fbz: rank > 1 not supported")
        out_q.append(uq)
        out_t.append(np.asarray(tt))
    return np.concatenate(out_q, axis=0), np.concatenate(out_t, axis=0)


def load_material(
    mat_folder: str,
    hdf_file: str,
    poscar_file: str,
    isotope_scattering: bool = False,
    rotation: tuple | None = None,  # (angles_deg list, order str)
    name: str | None = None,
) -> Material:
    crystal = parse_poscar(os.path.join(mat_folder, poscar_file))
    B = crystal.reciprocal_lattice
    rec_ops = reciprocal_operations(crystal)

    import h5py  # optional: only the hdf5 reader/writer needs it

    with h5py.File(os.path.join(mat_folder, hdf_file), "r") as h:
        data_mesh = np.array(h["mesh"])
        qpoints = np.array(h["qpoint"])
        weights = np.array(h["weight"])
        frequency = np.array(h["frequency"])  # (Qi,J) THz
        group_vel = np.array(h["group_velocity"])  # (Qi,J,3) THz*A
        gamma = np.array(h["gamma"])  # (nT,Qi,J) THz
        temperature = np.array(h["temperature"])  # (nT,)
        if isotope_scattering:
            if "gamma_isotope" not in h:
                raise KeyError('hdf file does not contain the field "gamma_isotope"')
            gamma = gamma + np.array(h["gamma_isotope"])

    frequency = np.where(frequency < 0, 0.0, frequency)

    q_fbz, frequency = expand_fbz(qpoints, weights, frequency, 0, rec_ops, B)
    _, group_vel = expand_fbz(qpoints, weights, group_vel, 1, rec_ops, B)
    group_vel = np.around(group_vel, decimals=10)
    # gamma has q on axis 1 -> move to axis 0 for expansion and back
    _, gamma = expand_fbz(
        qpoints, weights, np.swapaxes(gamma, 0, 1), 0, rec_ops, B
    )
    gamma = np.swapaxes(gamma, 0, 1)  # (nT, Q, J)

    omega = frequency * 2.0 * np.pi
    with np.errstate(divide="ignore"):
        tau = np.where(gamma > 0, 1.0 / (4.0 * np.pi * np.maximum(gamma, 1e-300)), 0.0)

    wavevectors = fold_to_fbz(q_fbz @ B.T, B)

    if rotation is not None:
        from scipy.spatial.transform import Rotation as Rot

        angles, order = rotation
        R = Rot.from_euler(order, angles, degrees=True)
        wavevectors = R.apply(wavevectors)
        group_vel = R.apply(group_vel.reshape(-1, 3)).reshape(group_vel.shape)

    return Material(
        name=name or os.path.basename(os.path.normpath(mat_folder)),
        qpoints=q_fbz,
        omega=omega,
        group_vel=group_vel,
        wavevectors=wavevectors,
        tau=tau,
        tau_T=temperature,
        reciprocal_lattice=B,
        volume_unitcell=crystal.volume,
        data_mesh=data_mesh,
    )
