"""The distributed engines of the port over a mesh of ranks on one or
more processes: the systolic ring (tiles and cover trees), the landmark
engine (Voronoi cells with ε-ghosts) and the delta traversal of online
inserts; ``comm`` holds the mesh and its exchanges."""
from . import comm
from .comm import RingMesh, make_nng_mesh
from .device import (DeviceForest, LandmarkPlan, delta_bcast_bytes,
                     delta_traverse_run, dfs_row_order, ghost_coll_bytes,
                     ghost_ring_bytes, landmark_run, local_tables,
                     plan_landmark_device, plan_ring_schedule,
                     resolve_ghost_mode, systolic_run, tree_traverse)

__all__ = ["DeviceForest", "LandmarkPlan", "RingMesh", "comm",
           "delta_bcast_bytes", "delta_traverse_run", "dfs_row_order",
           "ghost_coll_bytes", "ghost_ring_bytes", "landmark_run",
           "local_tables", "make_nng_mesh", "plan_landmark_device",
           "plan_ring_schedule", "resolve_ghost_mode", "systolic_run",
           "tree_traverse"]
