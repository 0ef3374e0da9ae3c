from nanokappa_torch.geometry.mesh import TriMesh
from nanokappa_torch.geometry.primitives import make_primitive
from nanokappa_torch.geometry.domain import Domain, BC, build_domain
from nanokappa_torch.geometry.device import DeviceGeometry

__all__ = ["TriMesh", "make_primitive", "Domain", "BC", "build_domain", "DeviceGeometry"]
