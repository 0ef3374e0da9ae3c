from nanokappa_torch.material.tables import Material, MaterialTables
from nanokappa_torch.material.loader import load_material
from nanokappa_torch.material.synthetic import synthetic_material, write_synthetic_hdf5

__all__ = [
    "Material",
    "MaterialTables",
    "load_material",
    "synthetic_material",
    "write_synthetic_hdf5",
]
