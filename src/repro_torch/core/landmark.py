"""Landmark (spatial-partition) planning primitives — paper §IV-D/E.

Voronoi sites sampled at random, Graham-LPT multiway number
partitioning for the cell→rank assignment, and Lemma-1 ε-ghost
determination, all in numpy on the host: the planning the landmark engine
(``repro_torch.core.distributed.landmark_run``) starts from. The same
rng draws as the JAX package's ``repro.core.landmark``, so the same seed
gives the same centers and the same assignment.
"""
from __future__ import annotations

import heapq

import numpy as np


def select_centers(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """Choose m Voronoi sites uniformly at random (the paper finds random
    beats a greedy permutation on skewed/high-dim data)."""
    return rng.choice(n, size=min(m, n), replace=False)


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
