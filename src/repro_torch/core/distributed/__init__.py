"""The distributed engines of the port on logical ranks: the systolic ring
(tiles and cover trees) and the landmark engine (Voronoi cells with
ε-ghosts)."""
from .device import (DeviceForest, LandmarkPlan, RingMesh, dfs_row_order,
                     ghost_coll_bytes, ghost_ring_bytes, landmark_run, make_nng_mesh,
                     plan_landmark_device, plan_ring_schedule,
                     resolve_ghost_mode, systolic_run, tree_traverse)

__all__ = ["DeviceForest", "LandmarkPlan", "RingMesh", "dfs_row_order",
           "ghost_coll_bytes",
           "ghost_ring_bytes", "landmark_run", "make_nng_mesh",
           "plan_landmark_device", "plan_ring_schedule",
           "resolve_ghost_mode", "systolic_run", "tree_traverse"]
