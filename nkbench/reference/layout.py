"""The rows of the program's particle pool, as its state documents them
(nanokappa_torch/sim/state.py): one (C, N) float32 tensor, a column a
lane, integer rows stored as int32 bits. The reference reads the program's
state and outputs through these indices and derives nothing else from the
pool's format."""

import torch

POS = slice(0, 3)  # position, A
VEL = slice(3, 6)  # the mode's group velocity, A/ps
OMEGA = 6  # the mode's angular frequency, rad THz
DEV = 8  # occupation deviation n - n0(T_ref, omega)
MODE = 9  # mode index (int32 bits)
NEXT_FACET = 10  # the facet the particle's flight ends on (int32 bits; < 0: none cast)
T_NEXT = 11  # the flight time left to that facet, in steps
REM = 13  # the fraction of the step still to fly
ALIVE = 14  # 1.0 alive, 0.0 a dead lane
SLICE = 15  # the subvolume the particle was binned in (int32 bits)
PARTNER = 16  # "slim" layout (18 rows): the mode's specular partner (int32 bits)
INT_ROWS = (9, 10, 12, 15)  # mode, next facet, facet sat on, subvolume
SLIM_ROWS = 18


def ints(row: torch.Tensor) -> torch.Tensor:
    return row.contiguous().view(torch.int32)
