"""Online ε-NNG maintenance: ``OnlineNNG`` — incremental insert / delete
over a built ``NNGraph``, exact at every step.

``build_nng`` is batch-only: one new point means a full ring or landmark
schedule over the corpus again. ``OnlineNNG`` keeps the graph live:

1. **Incremental cover-tree insertion.** The wrapper owns the per-rank
   cover forests. Host backend (default): ``FlatCoverTree.insert_host``
   descends each new point to its covering node and appends it into the
   padded slot ranges (float64 descent, the structure-preserving path),
   then the tables are stacked and copied to the device again
   (``_restack``). Device backend: ``flat_tree_device.insert_stacked_device``
   appends the batch as singleton roots of the stacked tables, as torch
   ops on the tables' device. Deletes tombstone leaves in place
   (``tombstone_host`` / ``tombstone_stacked_device``): ranges never move,
   the masked entries stop being emitted.

2. **Delta traversal.** ``repro_torch.nng.delta_run`` sends ONLY the
   inserted batch to every rank and traverses each rank's forest once (the
   same ``tree_frontier``, ``leaf_range_pack`` and ``bits_to_cols``
   kernels the tree engines use), so update work scales with the batch's
   frontier, not with the corpus.

3. **CSR delta log.** New edges append to ``NNGraph``'s delta log; deletes
   tombstone nodes; every read shows the merged view. ``compact()`` folds
   the log down, driven by the size-ratio policy ``maybe_compact``
   (``compact_ratio``: pending delta edges against base edges).

Exactness: after every operation the merged view equals a brute-force
rebuild over the live points — the delta traversal covers new↔old and
new↔new pairs (the forests partition the corpus; self pairs excluded by
global id), tombstones remove every edge of a deleted node, and ids are
never reused. Distances are the engines' fp32; ε on an fp32 boundary
follows the batch path's tolerance.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.covertree import build_covertree
from repro_torch.core.distributed import make_nng_mesh
from repro_torch.core.flat_tree import (build_cell_forests, flatten_forest,
                                        stack_device_forests)
from repro_torch.core.flat_tree_device import (insert_stacked_device,
                                               tombstone_stacked_device)
from repro_torch.core.graph import NNGraph
from repro_torch.core.landmark import lpt_assignment, select_centers
from repro_torch.core.metrics import get_metric, ieee_fp32
from repro_torch.nng import build_nng, delta_run

__all__ = ["OnlineNNG"]


class OnlineNNG:
    """A live ε-neighbour graph: ``insert(points) -> new_ids``,
    ``delete(ids)``.

    Wraps ``build_nng``'s result (same ``metric`` / ``partition`` /
    ``mesh`` axes) with incrementally maintained per-rank cover forests
    and the CSR delta log. ``graph`` is the current ``NNGraph`` (merged
    view); ``stats`` accumulates ``update_s`` / ``edges_added`` /
    ``edges_removed`` across operations, and ``last_update_stats`` holds
    the last insert's delta traversal (``RunStats``).

    ``mesh`` defaults to ``make_nng_mesh()`` on ``device`` (the CUDA card
    unless ``device="cpu"``), as ``build_nng``'s does. A mesh over more
    than one process is not supported yet (``NotImplementedError``): the
    wrapper keeps every rank's forest in one process. ``insert_backend``:
    "host" (float64 top-down descent into the owning forest, then
    restack) or "device" (batched singleton-root append into the stacked
    tables on the device). ``compact_ratio`` tunes the auto-compaction
    policy (``None`` disables it).

    ``insert`` and ``delete`` run with IEEE fp32 products (``ieee_fp32``,
    as ``build_nng`` does: TF32 would split pairs): the guard sets the
    process-wide float32 matmul precision and TF32 flags and restores them
    on return, so it is not safe against threads that want other settings
    at the same time.
    """

    def __init__(self, points, eps: float, *, metric="euclidean",
                 partition: str = "point", mesh=None, k_cap: int = 64,
                 m_centers: int | None = None, seed: int = 0,
                 compact_ratio: float | None = 0.5,
                 insert_backend: str = "host", leaf_size: int = 10,
                 device=None, **build_kw):
        if insert_backend not in ("host", "device"):
            raise ValueError(f"unknown insert_backend {insert_backend!r}")
        if partition not in ("point", "spatial"):
            raise ValueError(f"unknown partition {partition!r}")
        self.metric = get_metric(metric)
        self.eps = float(eps)
        self.partition = partition
        self.k_cap = int(k_cap)
        self.compact_ratio = compact_ratio
        self.insert_backend = insert_backend
        self.leaf_size = int(leaf_size)
        self.points = np.ascontiguousarray(
            np.asarray(points, self.metric.host.dtype))
        n = len(self.points)
        if n < 1:
            raise ValueError("OnlineNNG needs a non-empty initial corpus")
        if mesh is None:
            mesh = make_nng_mesh(None, device)
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device!r} differs from the mesh's "
                             f"{mesh.device}")
        if mesh.world > 1:
            raise NotImplementedError(
                f"OnlineNNG on a mesh over {mesh.world} processes: its "
                "per-rank forests live in one process; online maintenance "
                "over processes (per-process tables for the host and device "
                "insert backends) is the next slice of the port")
        self.mesh = mesh
        self.nranks = mesh.size
        self.live = np.ones(n, bool)
        self.graph = build_nng(
            self.points, self.eps, metric=self.metric, partition=partition,
            mesh=mesh, k_cap=k_cap, m_centers=m_centers, seed=seed,
            **build_kw)
        self.graph.meta["online"] = {"inserts": 0, "deletes": 0,
                                     "insert_backend": insert_backend}
        self._rr = 0                       # round-robin cursor (point part.)
        self._init_forests(m_centers, seed)
        self._restack()
        self.last_update_stats = None

    # -- forest state --------------------------------------------------------
    def _init_forests(self, m_centers, seed):
        """The wrapper's OWN per-rank host forests (the engines' build
        paths duplicate-pad and re-plan per call; online maintenance needs
        one persistent structure it can mutate).

        Point partition: one tree per ``np.array_split`` block — uneven
        blocks instead of duplicate padding, so every leaf gid is unique
        and tombstones cannot half-delete a point. Spatial partition: the
        landmark cell forests (fixed centres; a new point joins the
        nearest centre's cell, so the Voronoi scoping stays consistent)."""
        n = len(self.points)
        met = self.metric.host
        if self.partition == "spatial":
            rng = np.random.default_rng(seed)
            m = m_centers or max(2 * self.nranks, 32)
            self.centers = self.points[select_centers(n, m, rng)]
            self.cell = np.argmin(
                np.asarray(met.cdist(self.points, self.centers)), axis=1)
            self.f = np.asarray(lpt_assignment(
                np.bincount(self.cell, minlength=len(self.centers)),
                self.nranks), np.int32)
            self.forests = build_cell_forests(
                self.points, self.cell, self.f, self.nranks, met,
                self.leaf_size)
            return
        self.centers = self.cell = self.f = None
        blocks = np.array_split(np.arange(n, dtype=np.int64), self.nranks)
        self.forests = []
        for blk in blocks:
            if len(blk) == 0:   # more ranks than points: placeholder tree
                tree = build_covertree(self.points[:1], met, self.leaf_size)
                self.forests.append(flatten_forest(
                    [tree], cells=[-2], gids=[np.zeros(1, np.int64)],
                    points=self.points))
                continue
            tree = build_covertree(self.points[blk], met, self.leaf_size)
            self.forests.append(flatten_forest(
                [tree], cells=[0], gids=[blk], points=self.points))

    def _restack(self):
        """All ranks' host forests, stacked and copied to the mesh's device
        (the reference's design: every host insert or delete restacks)."""
        dev = self.mesh.device
        self._stacked = {
            k: (self.metric.as_device(v, dev) if k == "coords"
                else torch.as_tensor(v, device=dev))
            for k, v in stack_device_forests(self.forests).items()}

    def _assign(self, new_points, b: int):
        """(ranks, cells) of a new batch under the current partition."""
        if self.partition == "spatial":
            met = self.metric.host
            cells = np.argmin(
                np.asarray(met.cdist(new_points, self.centers)), axis=1)
            return self.f[cells], cells
        ranks = (np.arange(b, dtype=np.int64) + self._rr) % self.nranks
        self._rr = int((self._rr + b) % self.nranks)
        return ranks, np.zeros(b, np.int64)

    # -- public ops ----------------------------------------------------------
    @ieee_fp32()
    def insert(self, new_points) -> np.ndarray:
        """Insert a batch; returns its newly allocated global ids."""
        t0 = time.perf_counter()
        new_points = np.ascontiguousarray(
            np.asarray(new_points, self.points.dtype))
        b = len(new_points)
        if b == 0:
            return np.zeros(0, np.int64)
        gids = self.graph.delta_insert_nodes(b)
        self.points = np.concatenate([self.points, new_points])
        self.live = np.concatenate([self.live, np.ones(b, bool)])
        ranks, cells = self._assign(new_points, b)
        if self.insert_backend == "device":
            self._stacked = insert_stacked_device(
                self._stacked, new_points, gids, ranks, cells)
        else:
            for r in range(self.nranks):
                mine = ranks == r
                if mine.any():
                    self.forests[r].insert_host(
                        gids[mine], cells=cells[mine], points=self.points)
                else:
                    self.forests[r].points = self.points
            self._restack()
        src, dst, stats = delta_run(
            new_points, gids, self._stacked, self.eps, self.mesh,
            metric=self.metric, k_cap=self.k_cap)
        self.graph.delta_add_edges(src, dst)
        self.last_update_stats = stats
        g = self.graph
        g.stats.dists_evaluated += stats.dists_evaluated
        g.stats.nodes_pruned += stats.nodes_pruned
        for k, v in stats.comm_bytes.items():
            g.stats.comm_bytes[k] = g.stats.comm_bytes.get(k, 0.0) + v
        g.meta["online"]["inserts"] += 1
        if self.compact_ratio is not None:
            g.maybe_compact(self.compact_ratio)
        g.stats.update_s += time.perf_counter() - t0
        return gids

    @ieee_fp32()
    def delete(self, ids) -> int:
        """Delete points by id; returns the number of edges removed."""
        t0 = time.perf_counter()
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        ids = ids[(ids >= 0) & (ids < len(self.live))]
        ids = ids[self.live[ids]]
        if not len(ids):
            return 0
        removed = self.graph.delta_delete_nodes(ids)
        self.live[ids] = False
        if self.insert_backend == "device":
            self._stacked = tombstone_stacked_device(self._stacked, ids)
        else:
            for f in self.forests:
                f.tombstone_host(ids)
            self._restack()
        g = self.graph
        g.meta["online"]["deletes"] += 1
        if self.compact_ratio is not None:
            g.maybe_compact(self.compact_ratio)
        g.stats.update_s += time.perf_counter() - t0
        return removed

    def compact(self) -> NNGraph:
        """Force a delta-log compaction; returns the (same) graph."""
        return self.graph.compact()

    # -- views ---------------------------------------------------------------
    @property
    def num_live(self) -> int:
        return int(self.live.sum())

    @property
    def stats(self):
        return self.graph.stats

    def __repr__(self):
        return (f"OnlineNNG({self.graph!r}, live={self.num_live}, "
                f"delta_edges={self.graph.delta_edges})")
