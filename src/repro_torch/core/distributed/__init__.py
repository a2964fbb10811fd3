"""The distributed engines of the port on logical ranks: the systolic ring
(tiles and cover trees), the landmark engine (Voronoi cells with
ε-ghosts) and the delta traversal of online inserts."""
from .device import (DeviceForest, LandmarkPlan, RingMesh, delta_bcast_bytes,
                     delta_traverse_run, dfs_row_order, ghost_coll_bytes,
                     ghost_ring_bytes, landmark_run, make_nng_mesh,
                     plan_landmark_device, plan_ring_schedule,
                     resolve_ghost_mode, systolic_run, tree_traverse)

__all__ = ["DeviceForest", "LandmarkPlan", "RingMesh", "delta_bcast_bytes",
           "delta_traverse_run", "dfs_row_order", "ghost_coll_bytes",
           "ghost_ring_bytes", "landmark_run", "make_nng_mesh",
           "plan_landmark_device", "plan_ring_schedule",
           "resolve_ghost_mode", "systolic_run", "tree_traverse"]
