"""One eta of BASELINE config 3's sweep through both packages on the CPU:
tests/test_nanowire.py:22 wire_kappa (the JAX package's v1 step) and its
port counterpart tests/torch_parity.py:wire_kappa, at eta = 10 A (kernel
A's diffuse re-emissions dominate there), from the same initial state
(the same seed's NumPy draws), on the 6^3 synthetic table.

Tolerance: the two kappas agree within 4 standard deviations of their
difference, each run's deviation taken as the larger of its blocks'
standard error and 2% of kappa. The 2% floor is the run-to-run spread
measured on the port: six seeds of this run (100 steps, eta = 10) spread
by 0.26 W/m/K about 16.6 (1.6%), eight at eta = 0 by 0.37 about 22.1
(1.7%), while a run's own block error can read 0.09 (its four blocks are
correlated). One cut: 100 steps instead of the JAX test's 400 (kappa from
the blocks of steps 70-100), so that the two runs fit a file's 30 s.
"""

import numpy as np

from torch_parity import wire12, wire_kappa


ETA = 10.0
STEPS = 100


def test_wire_kappa_matches_jax():
    from nanokappa_tpu.material import synthetic_material as j_mat
    from nanokappa_torch.geometry.domain import build_domain
    from nanokappa_torch.material import synthetic_material
    from test_nanowire import wire_kappa as j_wire_kappa

    k_j, out_j = j_wire_kappa(j_mat(mesh=(6, 6, 6)), eta=ETA, n_steps=STEPS)
    k_t, se_t, out_t = wire_kappa(synthetic_material(mesh=(6, 6, 6)), build_domain(**wire12(ETA)), n_steps=STEPS)
    s = max(se_t, 0.02 * k_t)
    print(f"eta {ETA}: kappa JAX {k_j:.4f}, port {k_t:.4f} +- {se_t:.4f} (deviation taken {s:.4f})")
    assert abs(k_j - k_t) <= 4.0 * np.sqrt(2.0) * s, (k_j, k_t, s)
    assert int(out_j.lost) < 50 and int(out_t.lost) < 50
    T_j, T_t = np.asarray(out_j.T_sv), np.asarray(out_t.T_sv)
    assert np.all(np.diff(T_j) < 0) and np.all(np.diff(T_t) < 0)
