"""nanokappa_torch — the phonon Monte Carlo BTE solver on PyTorch and CUDA.

The port of `nanokappa_tpu` to one NVIDIA H100. Host-side builders (material
synthesis and loading, the mesh engine, the domain, boundary and reservoir
tables) are NumPy and produce bit-identical arrays to the JAX package; the
device side is plain torch around five hand-written CUDA kernels
(`ops/megastep.py`, `ops/compact_pool.py`, `ops/compact.py`,
`ops/scatter_rows.py`, `ops/raycast_large.py`, sources in `csrc/`). On CPU
tensors every kernel wrapper runs its plain torch twin. The figures
(`visual.py`) are host-only NumPy and matplotlib.
"""

from nanokappa_torch import constants  # noqa: F401

__version__ = "0.1.0"
