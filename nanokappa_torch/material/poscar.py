"""Minimal VASP POSCAR parser.

The reference delegates this to phonopy
(`read_crystal_structure`, reference classes/Phonon.py:70-72); here we parse
the file directly — we only need the lattice vectors, the unit-cell volume and
the atomic basis (fractional positions + species) for the symmetry search.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Crystal:
    lattice: np.ndarray  # (3,3) rows are lattice vectors a1,a2,a3, in angstrom
    frac_positions: np.ndarray  # (n_atoms, 3) fractional coordinates in [0,1)
    species: list[str] = field(default_factory=list)  # length n_atoms

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.lattice)))

    @property
    def reciprocal_lattice(self) -> np.ndarray:
        """Reciprocal lattice vectors *as columns*, including the 2*pi factor.

        Matches the convention of the reference (classes/Phonon.py:72):
        ``reciprocal_lattice = inv(lattice) * 2*pi`` where ``lattice`` has
        direct vectors as rows, so B[:, i] is the reciprocal vector b_i and
        k_cart = B @ q_reduced.
        """
        return np.linalg.inv(self.lattice) * 2.0 * np.pi

    def species_numbers(self) -> np.ndarray:
        """Integer label per atom (equal label <=> equal species)."""
        uniq = {s: i for i, s in enumerate(dict.fromkeys(self.species))}
        return np.array([uniq[s] for s in self.species], dtype=int)


def parse_poscar(path: str) -> Crystal:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]

    scale = float(lines[1].split()[0])
    lattice = np.array(
        [[float(x) for x in lines[2 + i].split()[:3]] for i in range(3)], dtype=float
    )
    if scale < 0:
        # negative scale = target volume
        vol = abs(np.linalg.det(lattice))
        scale = (-scale / vol) ** (1.0 / 3.0)
    lattice = lattice * scale

    # line 5: either species names (VASP5) or counts (VASP4)
    toks5 = lines[5].split()
    if all(t.lstrip("+-").isdigit() for t in toks5):
        # VASP4: no symbol line; species unknown -> synthesize labels
        counts = [int(t) for t in toks5]
        names = [f"X{i}" for i in range(len(counts))]
        iline = 6
    else:
        names = toks5
        counts = [int(t) for t in lines[6].split()]
        iline = 7

    # optional 'Selective dynamics'
    if lines[iline].strip().lower().startswith("s"):
        iline += 1
    mode = lines[iline].strip().lower()
    cartesian = mode.startswith(("c", "k"))
    iline += 1

    n_atoms = sum(counts)
    pos = np.array(
        [[float(x) for x in lines[iline + i].split()[:3]] for i in range(n_atoms)],
        dtype=float,
    )
    if cartesian:
        pos = pos * scale @ np.linalg.inv(lattice)
    pos = np.mod(pos, 1.0)

    species: list[str] = []
    for name, cnt in zip(names, counts):
        species += [name] * cnt

    return Crystal(lattice=lattice, frac_positions=pos, species=species)
