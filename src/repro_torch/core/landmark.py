"""Landmark (spatial-partition) planning primitives — paper §IV-D/E.

Voronoi sites (sampled at random, or a greedy permutation), the nearest-
site assignment, Graham-LPT multiway number partitioning for the
cell→rank assignment, and Lemma-1 ε-ghost determination, all in numpy on
the host: the planning the landmark engine
(``repro_torch.core.distributed.landmark_run``) and the host simulation
(``core.host_algos.landmark_host``) start from. The same rng draws as the
JAX package's ``repro.core.landmark``, so the same seed gives the same
centers and the same assignment.
"""
from __future__ import annotations

import heapq

import numpy as np

from .metrics_host import HostMetric, get_host_metric


def select_centers(
    n: int, m: int, rng: np.random.Generator, points=None, metric=None,
    strategy: str = "random",
) -> np.ndarray:
    """Choose m Voronoi sites: uniformly at random, or (``"greedy"``, with
    ``points`` and ``metric``) a greedy permutation from a random first
    site, each next site the point farthest from those chosen (float64
    true distances). The paper finds random beats greedy on skewed/high-dim
    data; both are provided."""
    if strategy == "random" or points is None:
        return rng.choice(n, size=min(m, n), replace=False)
    if strategy == "greedy":
        met = get_host_metric(metric)
        first = int(rng.integers(n))
        centers = [first]
        D = np.asarray(met.true(met.rowwise(
            points, np.broadcast_to(points[first], points.shape))), np.float64)
        for _ in range(min(m, n) - 1):
            nxt = int(np.argmax(D))
            centers.append(nxt)
            dn = np.asarray(met.true(met.rowwise(
                points, np.broadcast_to(points[nxt], points.shape))), np.float64)
            np.minimum(D, dn, out=D)
        return np.asarray(centers, np.int64)
    raise ValueError(strategy)


def voronoi_assign(points: np.ndarray, centers_pts: np.ndarray,
                   metric: str | HostMetric) -> tuple[np.ndarray, np.ndarray]:
    """Assign each point to its nearest center.

    Returns (cell, dist): cell (n,) int64 index into centers (the argmin of
    the metric's fp32 ``cdist``; ties go to the lowest center index, the
    paper's "only assign one" rule), dist (n,) float64 TRUE distance to the
    chosen center.
    """
    met = get_host_metric(metric)
    d = met.cdist(points, centers_pts)
    cell = np.argmin(d, axis=1).astype(np.int64)
    dist = np.asarray(
        met.true(met.rowwise(points, centers_pts[cell])), np.float64)
    return cell, dist


def lpt_assignment(cell_sizes: np.ndarray, nranks: int) -> np.ndarray:
    """Graham's LPT rule — 4/3-approx multiway number partitioning.

    Returns f: (m,) int64 cell -> rank, minimizing max rank load.
    """
    m = len(cell_sizes)
    f = np.zeros(m, dtype=np.int64)
    heap = [(0, r) for r in range(nranks)]
    heapq.heapify(heap)
    for c in np.argsort(cell_sizes)[::-1]:
        load, r = heapq.heappop(heap)
        f[c] = r
        heapq.heappush(heap, (load + int(cell_sizes[c]), r))
    return f


def ghost_membership(
    dist_to_centers: np.ndarray, cell: np.ndarray, d_pC: np.ndarray, eps: float
) -> np.ndarray:
    """Lemma 1: p is an ε-ghost of V_i iff d(p, c_i) <= d(p, C) + 2ε (i != cell(p)).

    dist_to_centers: (n, m) TRUE distances; returns (n, m) bool.
    """
    g = dist_to_centers <= (d_pC[:, None] + 2.0 * eps)
    g[np.arange(len(cell)), cell] = False
    return g
