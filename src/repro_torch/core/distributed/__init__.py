"""The distributed engines of the port (the systolic ring for now)."""
from .device import RingMesh, make_nng_mesh, systolic_run

__all__ = ["RingMesh", "make_nng_mesh", "systolic_run"]
