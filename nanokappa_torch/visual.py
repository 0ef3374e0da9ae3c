"""Post-processing plots (host, matplotlib), reference classes/Visualisation.py.

The JAX package's nanokappa_tpu/visual.py on the port: the same figures
and file names, from the same result files. The figures that read the
running simulation take its particles from `Simulation.host_state()` (a
finalised host copy of the pool: the pending deferred RTA applied, the
alive lanes' rows as NumPy arrays), never from the device pool itself.
matplotlib is imported here only; callers import this module inside a
try, so a machine without it still runs (and says "init plots failed" /
"postprocess failed").

Generates the reference's figure set from the result files:
  * convergence of T / heat flux / N_p / energy / kappa per subvolume
    (plot_convergence_general, Visualisation.py:295-591)
  * reservoir energy balance (convergence_energy_balance, :668-717)
  * spectral kappa contribution per frequency band (flux_contribution, :593-666)
  * particle scatter figures colored by property (Population.plot_figures)
"""

from __future__ import annotations

import os

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from nanokappa_torch.constants import HBAR  # noqa: E402


def set_theme(name: str = "white"):
    """Plot theme (reference --theme white|light|dark,
    classes/Visualisation.py:42-96)."""
    if name == "dark":
        plt.style.use("dark_background")
    else:
        plt.style.use("default")
        if name == "light":
            plt.rcParams["figure.facecolor"] = "#f4f4f4"
            plt.rcParams["axes.facecolor"] = "#f4f4f4"


def plot_material(mat, folder: str):
    """Material diagnostic plots at init (reference classes/Phonon.py:195-207,
    433-513): FBZ wavevectors, relaxation times tau(omega) at round-hundred
    temperatures, density of states per branch."""
    # FBZ scatter
    fig = plt.figure(figsize=(6, 5), dpi=120)
    ax = fig.add_subplot(projection="3d")
    k = mat.wavevectors
    ax.scatter(k[:, 0], k[:, 1], k[:, 2], s=1, c=(k**2).sum(axis=1))
    ax.set_xlabel(r"$k_x$"); ax.set_ylabel(r"$k_y$"); ax.set_zlabel(r"$k_z$")
    fig.suptitle(r"Wavevectors in FBZ, coloured by $|k|^2$")
    fig.tight_layout()
    fig.savefig(os.path.join(folder, "FBZ.png"))
    plt.close(fig)

    # relaxation times at multiples of 100 K
    T_all = mat.tau_T[mat.tau_T % 100 == 0]
    T_all = T_all[T_all > 0]
    fig, ax = plt.subplots(figsize=(5, 5), dpi=120)
    cmap = plt.get_cmap("jet")
    omega = mat.omega.reshape(-1)
    for i, T in enumerate(T_all):
        ti = int(np.searchsorted(mat.tau_T, T))
        tau = mat.tau[ti].reshape(-1)
        sel = tau > 0
        ax.scatter(omega[sel], tau[sel], s=1,
                   color=cmap(i / max(len(T_all) - 1, 1)), label=f"{T:.0f} K")
    ax.set_xlabel(r"$\omega$ [rad THz]")
    ax.set_ylabel(r"$\tau$ [ps]")
    ax.set_yscale("log")
    ax.legend(fontsize="small", markerscale=8)
    fig.tight_layout()
    fig.savefig(os.path.join(folder, "relaxation_times.png"))
    plt.close(fig)

    # density of states (stacked per branch, 200 bins)
    n_bins = 200
    intervals = np.linspace(0, mat.omega.max(), n_bins + 1)
    centers = (intervals[1:] + intervals[:-1]) / 2
    dos = np.stack(
        [np.histogram(mat.omega[:, b], bins=intervals)[0] for b in range(mat.n_branches)]
    ) / (intervals[1] - intervals[0])
    fig, ax = plt.subplots(figsize=(5, 5), dpi=120)
    ax.stackplot(centers, dos, labels=[f"Branch {b}" for b in range(mat.n_branches)],
                 step="pre")
    ax.set_xlabel(r"$\omega$ [rad THz]")
    ax.set_ylabel(r"$g(\omega)$ [THz$^{-1}$]")
    ax.legend(fontsize="small")
    fig.tight_layout()
    fig.savefig(os.path.join(folder, "density_of_states.png"))
    plt.close(fig)


_BC_COLORS = {1: "tab:red", 2: "tab:green", 3: "tab:blue", 4: "tab:orange"}
_BC_NAMES = {1: "T", 2: "P", 3: "R", 4: "F"}


def plot_geometry(domain, folder: str):
    """Boundary-condition facet plot + subvolume connection graph
    (reference classes/Geometry.py:768-791, 1054-1068)."""
    mesh = domain.mesh
    fig = plt.figure(figsize=(8, 6), dpi=120)
    ax = fig.add_subplot(projection="3d")
    for fct in range(mesh.n_facets):
        col = _BC_COLORS.get(int(domain.bound_cond[fct]), "gray")
        tris = mesh.tri[mesh.facets[fct]]
        for t in tris:
            loop = np.vstack([t, t[:1]])
            ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], color=col, lw=0.7)
        c = mesh.facet_centroids[fct]
        ax.text(c[0], c[1], c[2],
                f"{fct}:{_BC_NAMES.get(int(domain.bound_cond[fct]), '?')}",
                fontsize=7)
    ax.set_box_aspect(np.ptp(mesh.bounds, axis=0) + 1e-9)
    fig.tight_layout()
    fig.savefig(os.path.join(folder, "BC_plot.png"))
    plt.close(fig)

    fig = plt.figure(figsize=(8, 6), dpi=120)
    ax = fig.add_subplot(projection="3d")
    c = domain.subvol_center
    ax.scatter(c[:, 0], c[:, 1], c[:, 2], s=12, c="k")
    for a, b in domain.subvol_connections:
        ax.plot(c[[a, b], 0], c[[a, b], 1], c[[a, b], 2], "b-", lw=0.8)
    ax.set_box_aspect(np.ptp(mesh.bounds, axis=0) + 1e-9)
    fig.tight_layout()
    fig.savefig(os.path.join(folder, "subvol_connections.png"))
    plt.close(fig)


def read_convergence(path: str, n_sv: int, n_res: int, subvol_type: str, n_con: int):
    """Parse convergence.txt back into arrays (Visualisation.py:122-157)."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            rows.append(line.split())
    data = np.array(rows)
    out = dict(
        datetime=data[:, 0],
        timestep=data[:, 1].astype(int),
        sim_time=data[:, 2].astype(float),
        total_en=data[:, 3].astype(float),
        en_res=data[:, 4 : 4 + n_res].astype(float),
        phi_res=data[:, 4 + n_res : 4 + 4 * n_res].astype(float),
        N_p=data[:, 4 + 4 * n_res].astype(int),
        T=data[:, 5 + 4 * n_res : 5 + 4 * n_res + n_sv].astype(float),
        sv_en=data[:, 5 + 4 * n_res + n_sv : 5 + 4 * n_res + 2 * n_sv].astype(float),
        sv_phi=data[:, 5 + 4 * n_res + 2 * n_sv : 5 + 4 * n_res + 5 * n_sv].astype(float),
        sv_Np=data[:, 5 + 4 * n_res + 5 * n_sv : 5 + 4 * n_res + 6 * n_sv].astype(float),
    )
    base = 5 + 4 * n_res + 6 * n_sv
    if subvol_type == "slice":
        out["sv_k"] = data[:, base : base + n_sv].astype(float)
        out["k"] = data[:, base + n_sv].astype(float)
    else:
        out["con_k"] = data[:, base : base + n_con].astype(float)
    return out


def plot_convergence(folder: str, conv: dict, subvol_type: str, theme: str = "white"):
    t = conv["sim_time"]

    def save(fig, name):
        fig.tight_layout()
        fig.savefig(os.path.join(folder, name))
        plt.close(fig)

    n_sv = conv["T"].shape[1]
    cmap = plt.get_cmap("jet")
    colors = cmap(np.linspace(0, 1, n_sv))

    fig, ax = plt.subplots(figsize=(8, 5), dpi=120)
    for i in range(n_sv):
        ax.plot(t, conv["T"][:, i], color=colors[i], lw=1, label=f"Sv {i}")
    ax.set_xlabel("Simulated time [ps]")
    ax.set_ylabel("Temperature [K]")
    ax.legend(fontsize="x-small", ncol=2)
    save(fig, "convergence_T.png")

    fig, ax = plt.subplots(figsize=(8, 5), dpi=120)
    for i in range(n_sv):
        ax.plot(t, conv["sv_phi"][:, 3 * i], color=colors[i], lw=1, label=f"Sv {i}")
    ax.set_xlabel("Simulated time [ps]")
    ax.set_ylabel("Heat flux x [W/m$^2$]")
    ax.legend(fontsize="x-small", ncol=2)
    save(fig, "convergence_phi.png")

    fig, ax = plt.subplots(figsize=(8, 5), dpi=120)
    ax.plot(t, conv["N_p"], "k-", lw=1)
    ax.set_xlabel("Simulated time [ps]")
    ax.set_ylabel("Number of particles")
    save(fig, "convergence_Np.png")

    fig, ax = plt.subplots(figsize=(8, 5), dpi=120)
    for i in range(n_sv):
        ax.plot(t, conv["sv_en"][:, i], color=colors[i], lw=1, label=f"Sv {i}")
    ax.set_xlabel("Simulated time [ps]")
    ax.set_ylabel("Energy density [eV/$\\AA^3$]")
    ax.legend(fontsize="x-small", ncol=2)
    save(fig, "convergence_e.png")

    fig, ax = plt.subplots(figsize=(8, 5), dpi=120)
    if subvol_type == "slice":
        for i in range(n_sv):
            ax.plot(t, conv["sv_k"][:, i], color=colors[i], lw=0.8, label=f"Sv {i}")
        ax.plot(t, conv["k"], "k-", lw=2, label="total")
        n_mean = min(len(t), 10)
        kmean = conv["k"][-n_mean:].mean()
        kstd = conv["k"][-n_mean:].std()
        ax.axhline(kmean, color="gray", ls="--", lw=1)
        ax.set_title(f"$\\kappa$ = {kmean:.2f} $\\pm$ {kstd:.2f} W/m·K (last {n_mean} pts)")
    else:
        for i in range(conv["con_k"].shape[1]):
            ax.plot(t, conv["con_k"][:, i], lw=0.8, label=f"Con {i}")
    ax.set_xlabel("Simulated time [ps]")
    ax.set_ylabel("$\\kappa$ [W/m·K]")
    ax.legend(fontsize="x-small", ncol=2)
    save(fig, "convergence_kappa.png")


def plot_energy_balance(folder: str, conv: dict):
    fig, ax = plt.subplots(figsize=(8, 5), dpi=120)
    t = conv["sim_time"]
    for i in range(conv["en_res"].shape[1]):
        ax.plot(t, conv["en_res"][:, i], lw=1, label=f"Res {i}")
    ax.plot(t, conv["en_res"].sum(axis=1), "k--", lw=1, label="total")
    ax.axhline(0, color="gray", lw=0.5)
    ax.set_xlabel("Simulated time [ps]")
    ax.set_ylabel("Energy balance [eV/ps]")
    ax.legend(fontsize="small")
    fig.tight_layout()
    fig.savefig(os.path.join(folder, "convergence_en_balance.png"))
    plt.close(fig)


def plot_particles(folder: str, positions: np.ndarray, colors: np.ndarray,
                   label: str, name: str, colormap: str = "jet"):
    fig = plt.figure(figsize=(8, 6), dpi=120)
    ax = fig.add_subplot(projection="3d")
    n = len(positions)
    sel = np.random.default_rng(0).choice(n, size=min(n, 20000), replace=False)
    sc = ax.scatter(
        positions[sel, 0], positions[sel, 1], positions[sel, 2],
        c=colors[sel], s=1, cmap=colormap,
    )
    fig.colorbar(sc, label=label, shrink=0.6)
    ax.set_box_aspect(np.ptp(positions, axis=0) + 1e-9)
    fig.tight_layout()
    fig.savefig(os.path.join(folder, name))
    plt.close(fig)


def spectral_kappa(sim, n_bands: int = 100, T_mean: np.ndarray | None = None):
    """Per-connection spectral kappa contribution (reference
    flux_contribution, Visualisation.py:593-666), for ANY subvolume type.

    For each connection c=(i,j): particles in subvolume i or j contribute
        k_p = -(phi_p . dX_c) / dT_c * n_active_modes / N_c,
    with phi_p = density-normalised hbar*omega*dn*v in W/m^2 and dX_c the
    centre-to-centre vector in meters; contributions are histogrammed over
    `n_bands` frequency bands. Returns (centers (B,), k (C,B), connections
    (C,2)). The per-band rows of k sum to the connection's particle-estimated
    total kappa. `T_mean` overrides the instantaneous subvolume temperatures
    with rolling means (the reference uses its convergence-window means)."""
    s = sim.host_state()
    alive = np.asarray(s.alive)
    modes = np.asarray(s.mode)[alive]
    mat = sim.material
    omega = mat.omega.reshape(-1)[modes]
    vel = mat.group_vel.reshape(-1, 3)[modes]
    occ = sim.occupation_of(s)[alive]
    T_sv = np.asarray(s.T_sv, dtype=float)
    sv = np.asarray(s.sv_col)[alive]
    from nanokappa_torch.material.tables import bose_einstein

    Tm = T_sv if T_mean is None else np.asarray(T_mean, dtype=float)
    dn = occ - bose_einstein(T_sv[sv], omega)
    return spectral_kappa_arrays(mat, sim.domain, omega, vel, dn, sv, Tm, n_bands)


def spectral_kappa_arrays(
    mat,  # host Material (n_qpoints, volume_unitcell, n_active_modes, omega)
    dom,  # Domain (subvol_connections, subvol_center)
    omega: np.ndarray,  # (N,) per-particle frequencies
    vel: np.ndarray,  # (N,3) per-particle group velocities
    dn: np.ndarray,  # (N,) occupation deviation vs the local temperature
    sv: np.ndarray,  # (N,) subvolume ids
    Tm: np.ndarray,  # (SV,) mean subvolume temperatures for the dT
    n_bands: int = 100,
):
    """Array-based core of `spectral_kappa` — shared with the offline
    postprocess entry, which reconstructs the arrays from particle_data.txt
    (reference read_particles + flux_contribution,
    classes/Visualisation.py:98-120, 593-666)."""
    from nanokappa_torch.constants import A_IN_M, EVPSA2_IN_WM2

    # phi per particle, W/m^2 after density normalisation (reference
    # normalise_to_density, classes/Phonon.py:392-401)
    dens = 1.0 / (mat.n_qpoints * mat.volume_unitcell)
    phi_p = (HBAR * omega * dn)[:, None] * vel * dens * EVPSA2_IN_WM2  # (N,3)

    cons = np.atleast_2d(np.asarray(dom.subvol_connections, dtype=int))
    centers_sv = dom.subvol_center

    bands = np.linspace(0, mat.omega.max() * 1.000001, n_bands + 1)
    centers = (bands[:-1] + bands[1:]) / 2
    idx = np.digitize(omega, bands) - 1
    k = np.full((len(cons), n_bands), np.nan)
    for c, (i, j) in enumerate(cons):
        sel = (sv == i) | (sv == j)
        n_c = int(sel.sum())
        dT = Tm[j] - Tm[i]
        if n_c == 0 or dT == 0:
            continue
        dX = (centers_sv[j] - centers_sv[i]) * A_IN_M
        k_p = -(phi_p[sel] @ dX) / dT * (mat.n_active_modes / n_c)
        band = np.zeros(n_bands)
        np.add.at(band, idx[sel], k_p)
        k[c] = band
    return centers, k, cons


def particle_scatters(
    folder: str,
    pos: np.ndarray,  # (N,3) alive positions
    omega: np.ndarray,  # (N,) alive mode frequencies
    dev: np.ndarray,  # (N,) occupation deviations
    sv_id: np.ndarray,  # (N,) subvolume ids
    T_sv: np.ndarray,  # (SV,)
    props,
    cmap: str = "jet",
):
    """One scatter figure per requested property (reference plot_figures,
    classes/Population.py:1841-1979)."""
    for prop in props:
        if prop in ("T", "temperature", "temperatures"):
            colors = np.asarray(T_sv, dtype=float)[sv_id]
            plot_particles(folder, pos, colors, "Temperature [K]",
                           "fig_temperature.png", cmap)
        elif prop in ("omega", "angular_frequency", "frequency"):
            plot_particles(folder, pos, omega, "$\\omega$ [rad THz]",
                           "fig_omega.png", cmap)
        elif prop in ("n", "occupation"):
            plot_particles(folder, pos, dev, "occupation deviation",
                           "fig_occupation.png", cmap)
        elif prop in ("e", "energy"):
            colors = HBAR * omega * dev
            plot_particles(folder, pos, colors, "energy deviation [eV]",
                           "fig_energy.png", cmap)
        elif prop in ("sv", "subvolumes", "subvolume"):
            plot_particles(folder, pos, sv_id.astype(float), "subvolume",
                           "fig_subvol.png", cmap)


def runtime_figures(sim):
    """Particle scatter figures refreshed during the run: EVERY requested
    property each cycle (reference plot_figures every 100 steps,
    classes/Population.py:1729-1735, 1841-1979)."""
    s = sim.host_state()
    alive = np.asarray(s.alive)
    omega = sim.material.omega.reshape(-1)[np.asarray(s.mode)[alive]]
    particle_scatters(
        sim.folder,
        np.asarray(s.pos)[alive],
        omega,
        np.asarray(s.dev)[alive],
        np.asarray(s.sv_col)[alive],
        np.asarray(s.T_sv, dtype=float),
        list(sim.args.fig_plot),
        str(sim.args.colormap[0]),
    )


def plot_kappa_path(sim, folder: str):
    """3-D connection graph coloured by kappa, with the snapped path
    highlighted (reference plot_kappa_path, classes/Visualisation.py:719-765)."""
    W = list(sim.window)
    if not W or "kappa_con" not in W[0]:
        return
    k = np.nanmean(np.stack([w["kappa_con"] for w in W]), axis=0)
    plot_kappa_path_data(sim.domain, k, sim.kappa_path, folder)


def plot_kappa_path_data(dom, k: np.ndarray, kappa_path, folder: str):
    c = dom.subvol_center
    fig = plt.figure(figsize=(8, 6), dpi=120)
    ax = fig.add_subplot(projection="3d")
    km = np.nanmax(np.abs(k)) or 1.0
    cmap = plt.get_cmap("jet")
    for ci, (a, b) in enumerate(dom.subvol_connections):
        ax.plot(
            c[[a, b], 0], c[[a, b], 1], c[[a, b], 2],
            color=cmap(0.5 + 0.5 * np.nan_to_num(k[ci]) / km), lw=1.2,
        )
    if kappa_path is not None:
        p = np.asarray(kappa_path)
        ax.plot(c[p, 0], c[p, 1], c[p, 2], "k-", lw=2.5)
    ax.scatter(c[:, 0], c[:, 1], c[:, 2], s=10, c="k")
    fig.tight_layout()
    fig.savefig(os.path.join(folder, "kappa_con.png"))
    plt.close(fig)


def postprocess(sim, verbose: bool = False):
    set_theme(str(sim.args.theme[0]))
    folder = sim.folder
    dom = sim.domain
    conv = read_convergence(
        os.path.join(folder, "convergence.txt"),
        dom.n_of_subvols, dom.n_of_reservoirs, dom.subvol_type,
        len(dom.subvol_connections),
    )
    plot_convergence(folder, conv, dom.subvol_type)
    if dom.n_of_reservoirs:
        plot_energy_balance(folder, conv)

    # particle scatters
    s = sim.host_state()
    alive = np.asarray(s.alive)
    mat = sim.material
    omega = mat.omega.reshape(-1)[np.asarray(s.mode)[alive]]
    particle_scatters(
        folder,
        np.asarray(s.pos)[alive],
        omega,
        np.asarray(s.dev)[alive],
        np.asarray(s.sv_col)[alive],
        np.asarray(s.T_sv, dtype=float),
        list(sim.args.fig_plot) or ["energy"],
    )

    if dom.subvol_type != "slice":
        plot_kappa_path(sim, folder)

    # spectral kappa per connection (reference k_contribution.png,
    # Visualisation.py:593-666; histogram + cumulative panel per connection).
    # dT uses the convergence-window MEAN temperatures like the reference's
    # flux_contribution (self.mean_T): an instantaneous near-zero dT on a
    # voronoi/grid connection would blow up the per-connection kappa.
    if len(np.atleast_2d(dom.subvol_connections)) and (
        dom.n_of_reservoirs >= 2 or dom.subvol_type != "slice"
    ):
        W = list(getattr(sim, "window", []) or [])
        T_mean = np.stack([w["T"] for w in W]).mean(0) if W else None
        centers, k_band, cons = spectral_kappa(sim, T_mean=T_mean)
        plot_spectral_kappa(folder, centers, k_band, cons)


def plot_spectral_kappa(folder: str, centers, k_band, cons):
    """k_contribution.png: per-band histogram + cumulative panel per
    connection (reference Visualisation.py:593-666)."""
    fig, ax = plt.subplots(nrows=2, figsize=(9, 10), dpi=120, sharex="all")
    for c, (i, j) in enumerate(cons):
        if np.all(np.isnan(k_band[c])):
            continue
        ax[0].step(centers, k_band[c], where="mid", label=f"Con. {i}-{j}")
        ax[1].plot(centers, np.nancumsum(k_band[c]), label=f"Con. {i}-{j}")
    if len(cons) < 25:
        ax[0].legend(fontsize="small")
    ax[0].set_ylabel("$\\kappa(\\omega)$ in band [W/m·K]")
    ax[1].set_ylabel("cumulated $\\kappa(\\omega)$ [W/m·K]")
    ax[1].set_xlabel("$\\omega$ [rad THz]")
    fig.tight_layout()
    fig.savefig(os.path.join(folder, "k_contribution.png"))
    plt.close(fig)


def postprocess_folder(folder: str, verbose: bool = True):
    """Offline postprocess: rebuild every figure a finished results folder
    supports from its FILES alone — no simulation state (reference
    read_particles + postprocess, classes/Visualisation.py:98-120, 214-254).

    Degrades gracefully: skips particle-based figures when particle_data.txt
    is absent and material-based ones when the hdf/poscar files are
    unavailable (e.g. a mirrored reference folder without the data blobs)."""
    from nanokappa_torch.io import writers
    from nanokappa_torch.io.config import read_args
    from nanokappa_torch.driver import domain_from_args, material_from_args
    from nanokappa_torch.geometry.domain import BC
    from nanokappa_torch.material.tables import bose_einstein

    args = read_args(
        ["-ff", os.path.join(folder, "arguments.txt")], tolerant=True
    )
    args.results_folder = folder
    set_theme(str(args.theme[0]))
    dom = domain_from_args(args)
    conv = read_convergence(
        os.path.join(folder, "convergence.txt"),
        dom.n_of_subvols, dom.n_of_reservoirs, dom.subvol_type,
        len(dom.subvol_connections),
    )
    plot_convergence(folder, conv, dom.subvol_type)
    if dom.n_of_reservoirs:
        plot_energy_balance(folder, conv)
    n_mean = max(1, int(args.n_mean[0]))
    T_mean = conv["T"][-n_mean:].mean(axis=0)

    try:
        mat = material_from_args(args)
        plot_material(mat, folder)
    except Exception as e:
        if verbose:
            print(f"offline postprocess: material unavailable ({e}); "
                  "skipping mode-resolved figures", flush=True)
        mat = None
    try:
        plot_geometry(dom, folder)
    except Exception:
        pass

    pfile = os.path.join(folder, "particle_data.txt")
    if os.path.exists(pfile):
        modes_qj, positions, occupation = writers.read_particle_data(pfile)
        d = np.linalg.norm(
            positions[:, None, :] - dom.subvol_center[None], axis=-1
        )
        sv = np.argmin(d, axis=1)
        props = list(args.fig_plot) or ["energy"]
        cmap = str(args.colormap[0])
        if mat is not None:
            modes = mat.mode_index(modes_qj[:, 0], modes_qj[:, 1])
            omega = mat.omega.reshape(-1)[modes]
            res_T = dom.res_values[
                dom.bound_cond[dom.res_facets] == BC.TEMPERATURE
            ]
            rt = str(args.reference_temp[0])
            t_ref = (
                float(res_T.mean()) if rt == "local" and len(res_T)
                else (300.0 if rt == "local" else float(rt))
            )
            dev = occupation - bose_einstein(t_ref, omega)
            particle_scatters(folder, positions, omega, dev, sv, T_mean,
                              props, cmap)
            if len(np.atleast_2d(dom.subvol_connections)) and (
                dom.n_of_reservoirs >= 2 or dom.subvol_type != "slice"
            ):
                vel = mat.group_vel.reshape(-1, 3)[modes]
                dn = occupation - bose_einstein(T_mean[sv], omega)
                centers, k_band, cons = spectral_kappa_arrays(
                    mat, dom, omega, vel, dn, sv, T_mean
                )
                plot_spectral_kappa(folder, centers, k_band, cons)
        else:
            # no material data: only figures that need positions alone
            # ('n' plots the raw occupation instead of the deviation)
            ok = ("n", "occupation", "sv", "subvolumes", "subvolume",
                  "T", "temperature", "temperatures")
            particle_scatters(
                folder, positions, np.zeros(len(positions)), occupation,
                sv, T_mean, [p for p in props if p in ok], cmap,
            )
    elif verbose:
        print("offline postprocess: no particle_data.txt; "
              "skipping particle figures", flush=True)

    if dom.subvol_type != "slice" and "con_k" in conv:
        k_con = np.nanmean(conv["con_k"][-n_mean:], axis=0)
        kappa_path = None
        if len(args.path_points) > 1:
            pts = np.asarray(args.path_points[1:], dtype=float).reshape(-1, 3)
            if args.path_points[0] == "relative":
                pts = pts * np.ptp(dom.bounds, axis=0) + dom.bounds[0]
            kappa_path = dom.find_path(pts)
        plot_kappa_path_data(dom, k_con, kappa_path, folder)
    if verbose:
        print(f"offline postprocess: figures rebuilt in {folder}", flush=True)
