"""The distributed engines of the port: the systolic ring (tiles and cover
trees) on logical ranks."""
from .device import (DeviceForest, RingMesh, make_nng_mesh,
                     plan_ring_schedule, systolic_run, tree_traverse)

__all__ = ["DeviceForest", "RingMesh", "make_nng_mesh", "plan_ring_schedule",
           "systolic_run", "tree_traverse"]
