"""Result file writers with the reference's column layouts.

convergence.txt / residue.txt / particle_data.txt / subvolumes.txt /
subvol_connections.txt match the reference formats
(classes/Population.py:1981-2152) so downstream tooling and golden-file
comparisons keep working.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np


class ConvergenceWriter:
    def __init__(self, folder: str, n_subvols: int, n_reservoirs: int,
                 subvol_type: str, connections: np.ndarray):
        self.path = os.path.join(folder, "convergence.txt")
        self.n_sv = n_subvols
        self.n_res = n_reservoirs
        self.subvol_type = subvol_type
        self.connections = connections
        self._write_header()

    def _write_header(self):
        line = "# "
        line += "Real Time                  "
        line += "Timest. "
        line += "Simul. Time "
        line += "Total Energy "
        for i in range(self.n_res):
            line += "En Bal Res {} ".format(i)
        for i in range(self.n_res):
            line += " Hflux x Res {} ".format(i)
            line += " Hflux y Res {} ".format(i)
            line += " Hflux z Res {} ".format(i)
        line += " No. Part. "
        for i in range(self.n_sv):
            line += " T Sv {:>3d} ".format(i)
        for i in range(self.n_sv):
            line += " Energ Sv {:>2d} ".format(i)
        for i in range(self.n_sv):
            line += " Hflux x Sv {:>2d} ".format(i)
            line += " Hflux y Sv {:>2d} ".format(i)
            line += " Hflux z Sv {:>2d} ".format(i)
        for i in range(self.n_sv):
            line += " Np Sv {:>3d} ".format(i)
        if self.subvol_type == "slice":
            for i in range(self.n_sv):
                line += " Kappa Sv {:>2d} ".format(i)
            line += " Kappa total  "
        else:
            for svc in self.connections:
                line += " K Con {:>3d}-{:>3d} ".format(svc[0], svc[1])
        with open(self.path, "a+") as f:
            f.write(line + "\n")

    def write_row(
        self,
        timestep: int,
        sim_time: float,
        total_energy: float,
        res_energy_balance: np.ndarray,
        res_heat_flux: np.ndarray,
        n_p: int,
        T_sv: np.ndarray,
        E_sv: np.ndarray,
        phi_sv: np.ndarray,
        Np_sv: np.ndarray,
        kappa_sv: np.ndarray | None = None,
        kappa_total: float | None = None,
        kappa_con: np.ndarray | None = None,
    ):
        line = datetime.now().strftime("%Y-%m-%dT%H:%M:%S.%f ")
        line += "{:>8d} ".format(int(timestep))
        line += "{:>12.5e} ".format(sim_time)
        line += "{:>12.5e} ".format(total_energy)
        for v in np.atleast_1d(res_energy_balance):
            line += "{:>12.5e} ".format(v)
        for row in np.atleast_2d(res_heat_flux):
            for v in row:
                line += "{:>14.6e} ".format(v)
        line += "{:>10d} ".format(int(n_p))
        for v in T_sv:
            line += "{:>9.3f} ".format(v)
        for v in E_sv:
            line += "{:>12.5e} ".format(v)
        for row in phi_sv:
            for v in row:
                line += "{:>14.6e} ".format(v)
        for v in Np_sv:
            line += "{:>10d} ".format(int(v))
        if self.subvol_type == "slice":
            for v in kappa_sv:
                line += "{:>12.5e} ".format(v)
            line += "{:>13.6e} ".format(kappa_total)
        else:
            for v in kappa_con:
                line += "{:>14.7e} ".format(v)
        with open(self.path, "a+") as f:
            f.write(line + "\n")


def append_residue(folder: str, residues: np.ndarray):
    with open(os.path.join(folder, "residue.txt"), "a+") as f:
        f.write(" ".join("{:9.3e}".format(r) for r in residues) + "\n")


def write_particle_data(folder: str, body, hdf_file, poscar_file):
    """particle_data.txt (classes/Population.py:2078-2091): its header, then
    `body`, the formatted rows as byte buffers in file order (the bytes of
    np.savetxt(fmt="%d, %d, %.3f, %.3f, %.3f, %.6e", header=header):
    nanokappa_torch/native.py CheckpointFormatter)."""
    path = os.path.join(folder, "particle_data.txt")
    header = (
        "Particles final state data \n"
        "Date and time: {}\n".format(datetime.now().strftime("%Y-%m-%dT%H:%M:%S.%f"))
        + "hdf file = {}, POSCAR file = {}\n".format(hdf_file, poscar_file)
        + "q-point, branch, pos x [angs], pos y [angs], pos z [angs], occupation"
    )
    with open(path, "wb") as f:
        for line in header.split("\n"):
            f.write(b"# " + line.encode() + b"\n")
        for part in body:
            f.write(part)


def read_particle_data(path: str):
    """Load a particle_data.txt for resume (classes/Population.py:283-306)."""
    data = np.loadtxt(path, delimiter=",", comments="#", dtype=float)
    modes_qj = data[:, :2].astype(int)
    positions = data[:, 2:5]
    occupation = data[:, 5]
    return modes_qj, positions, occupation


def write_subvolumes(folder: str, centers, volumes, mean_T, std_T, mean_phi,
                     std_phi, mean_k=None, std_k=None, hdf_file="", poscar_file=""):
    """subvolumes.txt (classes/Population.py:2093-2132)."""
    path = os.path.join(folder, "subvolumes.txt")
    time = datetime.now().strftime("%Y-%m-%dT%H:%M:%S.%f")
    n_sv = len(volumes)
    if mean_k is not None:
        header = (
            "subvols final state data \n"
            f"Date and time: {time}\n"
            f"hdf file = {hdf_file}, POSCAR file = {poscar_file}\n"
            "subvol id, subvol x, subvol y, subvol z, subvol volume, T [K], sigma T [K], "
            "HF x [W/m^2], HF y [W/m^2], HF z [W/m^2], sigma HF x [W/m^2], "
            "sigma HF y [W/m^2], sigma HF z [W/m^2], kappa [W/m K], sigma kappa [W/m K]"
        )
        data = np.hstack(
            (
                np.arange(n_sv).reshape(-1, 1), centers, np.reshape(volumes, (-1, 1)),
                np.reshape(mean_T, (-1, 1)), np.reshape(std_T, (-1, 1)),
                np.reshape(mean_phi, (-1, 3)), np.reshape(std_phi, (-1, 3)),
                np.reshape(mean_k, (-1, 1)), np.reshape(std_k, (-1, 1)),
            )
        )
        fmt = "%d, %.3e, %.3e, %.3e, %.3e, %.3f, %.3e, %.3e, %.3e, %.3e, %.3e, %.3e, %.3e, %.3e, %.3e"
    else:
        header = (
            "subvols final state data \n"
            f"Date and time: {time}\n"
            f"hdf file = {hdf_file}, POSCAR file = {poscar_file}\n"
            "subvol id, subvol position, subvol volume, T [K], sigma T [K], "
            "HF x [W/m^2], HF y [W/m^2], HF z [W/m^2], sigma HF x [W/m^2], "
            "sigma HF y [W/m^2], sigma HF z [W/m^2]"
        )
        data = np.hstack(
            (
                np.arange(n_sv).reshape(-1, 1), centers, np.reshape(volumes, (-1, 1)),
                np.reshape(mean_T, (-1, 1)), np.reshape(std_T, (-1, 1)),
                np.reshape(mean_phi, (-1, 3)), np.reshape(std_phi, (-1, 3)),
            )
        )
        fmt = "%d, %.3e, %.3e, %.3e, %.3e, %.3f, %.3e, %.3e, %.3e, %.3e, %.3e, %.3e, %.3e"
    np.savetxt(path, data, fmt, header=header)


def write_subvol_connections(folder: str, connections, con_vectors, mean_dT,
                             std_dT, mean_phi, std_phi, mean_k, std_k,
                             hdf_file="", poscar_file=""):
    """subvol_connections.txt (classes/Population.py:2134-2151)."""
    path = os.path.join(folder, "subvol_connections.txt")
    time = datetime.now().strftime("%Y-%m-%dT%H:%M:%S.%f")
    header = (
        "connections final state data \n"
        f"Date and time: {time}\n"
        f"hdf file = {hdf_file}, POSCAR file = {poscar_file}\n"
        "connection id, sv 1, sv 2, con dx, con dy, con dz, dT [K], sigma dT [K], "
        "HF [W/m^2], sigma HF [W/m^2], kappa [W/m K], sigma kappa [W/m K]"
    )
    n = len(connections)
    data = np.hstack(
        (
            np.arange(n).reshape(-1, 1), connections, con_vectors,
            np.reshape(mean_dT, (-1, 1)), np.reshape(std_dT, (-1, 1)),
            np.reshape(mean_phi, (-1, 1)), np.reshape(std_phi, (-1, 1)),
            np.reshape(mean_k, (-1, 1)), np.reshape(std_k, (-1, 1)),
        )
    )
    np.savetxt(
        path, data,
        "%d, %d, %d, %.3e, %.3e, %.3e, %.3f, %.3e, %.3e, %.3e, %.3e, %.3e",
        header=header,
    )
