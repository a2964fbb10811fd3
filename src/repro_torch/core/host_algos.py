"""Host-simulated distributed ε-graph algorithms (paper Algorithms 4-6).

These run the *exact* distributed algorithm structure — block partitioning,
per-rank cover trees, ring rotation schedule, Voronoi coalescing, ghost
exchange — with N simulated ranks in one process, in numpy with float64
ground truth, as the JAX package's ``repro.core.host_algos`` does. They
power the paper-table measurements (phase breakdowns, per-rank makespan,
comm-volume accounting, strong scaling, the greedy centre strategy) beside
the engines of ``repro_torch.core.distributed``, which run the same math
over a mesh of ranks on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.ops import grouped_block_active, nng_tile_geometry

from .covertree import build_covertree
from .flat_tree import TraversalStats
from .graph import EpsGraph, RunStats
from .landmark import ghost_membership, lpt_assignment, select_centers
from .metrics_host import get_host_metric


@dataclass
class PhaseStats(RunStats):
    """Host-simulation stats: the normalized ``RunStats`` counters
    (tiles_scheduled / tiles_skipped / dists_evaluated / nodes_pruned /
    comm_bytes — the same names and float convention as the engines) plus
    the simulated phase timings."""

    partition_s: float = 0.0
    tree_s: float = 0.0
    ghost_s: float = 0.0
    per_rank_s: np.ndarray | None = None   # simulated per-rank compute time

    @property
    def total_s(self):
        return self.partition_s + self.tree_s + self.ghost_s

    @property
    def makespan_s(self):
        """Critical-path (max-over-ranks) time — the simulated parallel
        step time when ranks run concurrently (one process runs them in
        turn, so total_s ≈ the sum over ranks)."""
        if self.per_rank_s is None:
            return self.total_s
        return float(np.max(self.per_rank_s))


def _block_partition(n: int, nranks: int):
    """Equal block partition: rank j owns [starts[j], starts[j+1])."""
    base = n // nranks
    rem = n % nranks
    sizes = np.full(nranks, base, dtype=np.int64)
    sizes[:rem] += 1
    starts = np.zeros(nranks + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    return starts


def _block_summaries(points: np.ndarray, starts: np.ndarray, metric: str):
    """Bounding (center distances, radii) per block in TRUE distance
    (float64 host math — the exactness ground truth the engine's fp32
    summaries are slack-guarded against)."""
    met = get_host_metric(metric)
    nranks = len(starts) - 1
    centers, radii = [], np.zeros(nranks)
    for j in range(nranks):
        blk = points[starts[j]:starts[j + 1]]
        if metric == "euclidean":
            c = blk.astype(np.float64).mean(axis=0)
            d = ((blk.astype(np.float64) - c[None, :]) ** 2).sum(axis=-1)
            radii[j] = float(np.sqrt(d.max())) if len(blk) else 0.0
        else:
            c = blk[0]
            radii[j] = float(
                np.asarray(met.true(met.cdist(blk, c[None, :]))).max())
        centers.append(c)
    centers = np.stack(centers)
    if metric == "euclidean":
        diff = centers[:, None, :] - centers[None, :, :]
        dcc = np.sqrt((diff * diff).sum(axis=-1))
    else:
        dcc = np.asarray(met.true(met.cdist(centers, centers)))
    return dcc, radii


def _edges(n: int, src: list, dst: list) -> EpsGraph:
    return EpsGraph(
        n,
        np.concatenate(src) if src else np.zeros(0, np.int64),
        np.concatenate(dst) if dst else np.zeros(0, np.int64),
    )


def systolic_ring_host(
    points: np.ndarray, eps: float, nranks: int, metric: str = "euclidean",
    leaf_size: int = 10, prune: bool = True,
) -> tuple[EpsGraph, PhaseStats]:
    """Algorithm 4: each rank trees its block; blocks rotate around the ring.

    Symmetry halving: round r pairs rank j with block (j + r) mod N; only
    rounds r <= N/2 run, and at r = N/2 (N even) only the lower rank of each
    pair evaluates, so every unordered block pair is evaluated exactly once.

    Block-summary pruning (the engine's schedule): a tile is skipped when
    d(center_j, center_b) > r_j + r_b + eps — by the triangle inequality no
    ε-pair can span the two blocks. The block still rotates (ring bytes
    unchanged); only the query is elided. ``stats.tiles_skipped`` /
    ``stats.tiles_scheduled`` report the pruning rate.
    """
    n = len(points)
    stats = PhaseStats()
    starts = _block_partition(n, nranks)
    t0 = time.perf_counter()
    trees = [
        build_covertree(points[starts[j]:starts[j + 1]], metric, leaf_size)
        for j in range(nranks)
    ]
    stats.tree_s += time.perf_counter() - t0

    t0 = time.perf_counter()
    dcc, radii = _block_summaries(points, starts, metric)
    src, dst = [], []
    point_bytes = points.dtype.itemsize * points.shape[1]
    ring_bytes = 0
    per_rank = np.zeros(nranks)
    for r in range(nranks // 2 + 1):
        for j in range(nranks):
            b = (j + r) % nranks
            if r > 0:
                # every rank receives the visiting block every ring round —
                # including the half of the halving round whose tile is
                # evaluated by the mirror rank below
                ring_bytes += int(starts[b + 1] - starts[b]) * point_bytes
            if r == 0 and b != j:
                continue
            if nranks % 2 == 0 and r == nranks // 2 and j >= b:
                continue  # halving round: evaluate each unordered pair once
            stats.tiles_scheduled += 1
            bound = radii[j] + radii[b] + eps
            # the same scale-relative slack as CoverTree.query's prune
            if prune and dcc[j, b] > bound + 1e-9 + 1e-12 * (dcc[j, b] + bound):
                stats.tiles_skipped += 1
                continue
            tq0 = time.perf_counter()
            ts = TraversalStats()
            qi, pj = trees[j].query(points[starts[b]:starts[b + 1]], eps,
                                    stats=ts)
            per_rank[j] += time.perf_counter() - tq0
            stats.dists_evaluated += ts.dists_evaluated
            stats.nodes_pruned += ts.nodes_pruned
            src.append(qi + starts[b])
            dst.append(pj + starts[j])
    stats.ghost_s += time.perf_counter() - t0  # the "query" phase here
    stats.comm_bytes["ring"] = ring_bytes
    stats.per_rank_s = per_rank
    return _edges(n, src, dst), stats


def grouped_tile_schedule(
    x_groups: np.ndarray, y_groups: np.ndarray, metric: str = "euclidean",
) -> tuple[int, int]:
    """Host mirror of the grouped-tile block schedule.

    Pads the group keys as ``kernels.ops.nng_tile_bits_grouped`` does (-1 =
    invalid row) and runs the same ``ops.grouped_block_active`` rule the
    wrapper's counters use, on CPU tensors, at the reference's block
    geometry (``ops.nng_tile_geometry``, the unit of the counters; the CUDA
    kernels walk 64 x 256 tiles of their own). Returns
    (tiles_scheduled, tiles_skipped).
    """
    def pad(g, t):
        g = torch.as_tensor(np.asarray(g, np.int32))
        return torch.cat([g, g.new_full(((-len(g)) % t,), -1)])

    tq, tp = nng_tile_geometry(len(x_groups), len(y_groups), metric)
    active = grouped_block_active(pad(x_groups, tq), pad(y_groups, tp), tq, tp)
    return int(active.numel()), int(active.numel() - active.sum())


def landmark_host(
    points: np.ndarray,
    eps: float,
    nranks: int,
    m_centers: int | None = None,
    ghost_mode: str = "coll",
    metric: str = "euclidean",
    seed: int = 0,
    center_strategy: str = "random",
    leaf_size: int = 10,
) -> tuple[EpsGraph, PhaseStats]:
    """Algorithms 5 + 6: Voronoi landmark partitioning with ε-ghost queries.

    ghost_mode="coll" → ghosts exchanged via all-to-all (comm volume = total
    ghost copies); "ring" → point blocks rotate and ghost-test against each
    rank's assigned centers (comm volume = (N-1) * n/N points), the paper's
    fix for the all-to-all blowup at scale. ``center_strategy`` is
    ``select_centers``' strategy ("random" or "greedy").
    """
    met = get_host_metric(metric)
    n = len(points)
    if m_centers is None:
        m_centers = max(2 * nranks, 32)
    m_centers = min(m_centers, n)
    rng = np.random.default_rng(seed)
    stats = PhaseStats()
    point_bytes = points.dtype.itemsize * points.shape[1]

    # ---- Phase 1: Voronoi partition (distributed: local cdist vs C) -------
    t0 = time.perf_counter()
    centers = select_centers(n, m_centers, rng, points, met, center_strategy)
    dmat = np.asarray(met.true(met.cdist(points, points[centers])),
                      np.float64)
    cell = np.argmin(dmat, axis=1).astype(np.int64)
    d_pC = dmat[np.arange(n), cell]
    sizes = np.bincount(cell, minlength=m_centers)
    f = lpt_assignment(sizes, nranks)  # cell -> rank (multiway partitioning)
    stats.partition_s += time.perf_counter() - t0
    # coalesce volume: every point moves to its cell's rank (uniform model)
    stats.comm_bytes["coalesce"] = (int(n * (nranks - 1) / max(nranks, 1))
                                    * point_bytes)

    # ---- Phase 2: coalesce cells, build per-cell trees, intra-cell query --
    t0 = time.perf_counter()
    src, dst = [], []
    trees = {}
    cell_members = {}
    per_rank = np.zeros(nranks)
    for ci in range(m_centers):
        members = np.flatnonzero(cell == ci)
        if len(members) == 0:
            continue
        tq0 = time.perf_counter()
        cell_members[ci] = members
        trees[ci] = build_covertree(points[members], metric, leaf_size)
        ts = TraversalStats()
        qi, pj = trees[ci].query(points[members], eps, stats=ts)
        per_rank[f[ci]] += time.perf_counter() - tq0
        stats.dists_evaluated += ts.dists_evaluated
        stats.nodes_pruned += ts.nodes_pruned
        src.append(members[qi])
        dst.append(members[pj])
    stats.tree_s += time.perf_counter() - t0

    # ---- Phase 3: ghost determination + queries (Lemma 1) -----------------
    t0 = time.perf_counter()
    gmask = ghost_membership(dmat, cell, d_pC, eps)
    ghost_copies = int(gmask.sum())
    for ci, members in cell_members.items():
        gpts = np.flatnonzero(gmask[:, ci])
        if len(gpts) == 0:
            continue
        tq0 = time.perf_counter()
        ts = TraversalStats()
        qi, pj = trees[ci].query(points[gpts], eps, stats=ts)
        per_rank[f[ci]] += time.perf_counter() - tq0
        stats.dists_evaluated += ts.dists_evaluated
        stats.nodes_pruned += ts.nodes_pruned
        src.append(gpts[qi])
        dst.append(members[pj])
    stats.ghost_s += time.perf_counter() - t0
    stats.per_rank_s = per_rank
    if ghost_mode == "coll":
        stats.comm_bytes["ghost"] = ghost_copies * point_bytes
    else:  # ring: every block visits every rank once
        stats.comm_bytes["ghost"] = ((nranks - 1) * (n // max(nranks, 1))
                                     * point_bytes)
    return _edges(n, src, dst), stats


ALGORITHMS = {
    "systolic-ring": lambda pts, eps, nranks, **kw: systolic_ring_host(
        pts, eps, nranks, **kw),
    "landmark-coll": lambda pts, eps, nranks, **kw: landmark_host(
        pts, eps, nranks, ghost_mode="coll", **kw),
    "landmark-ring": lambda pts, eps, nranks, **kw: landmark_host(
        pts, eps, nranks, ghost_mode="ring", **kw),
}
