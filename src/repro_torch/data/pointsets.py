"""Point-cloud sources for the ε-NNG engine (numpy, made from a seed).

Synthetic stand-ins matched to the paper's Table I regime: clustered
clouds of low intrinsic dimension, and one tight cluster per index block.
"""
from __future__ import annotations

import numpy as np


def synthetic_pointset(n: int, dim: int, metric: str = "euclidean",
                       seed: int = 0, n_clusters: int | None = None,
                       cluster_std: float = 0.3,
                       intrinsic_dim: int | None = None):
    """Clustered low-intrinsic-dimension cloud (the paper's sparsity
    regime).

    ``metric == "hamming"`` yields packed uint32 bit rows (``dim`` words a
    row): cluster centres of random bits, each point its centre with 3% of
    its bits flipped. Every other metric shares the float32 generator:
    clusters on an ``intrinsic_dim``-dimensional manifold embedded in
    ``dim``."""
    rng = np.random.default_rng(seed)
    n_clusters = n_clusters or max(8, int(np.sqrt(n) / 4))
    if metric == "hamming":
        ctrs = rng.integers(0, 2**32, size=(n_clusters, dim), dtype=np.uint32)
        assign = rng.integers(0, n_clusters, n)
        pts = ctrs[assign].copy()
        for _ in range(max(1, int(dim * 32 * 0.03))):
            word = rng.integers(0, dim, n)
            bit = rng.integers(0, 32, n).astype(np.uint32)
            pts[np.arange(n), word] ^= np.uint32(1) << bit
        return pts
    idim = intrinsic_dim or max(2, dim // 8)
    basis = rng.normal(size=(idim, dim)).astype(np.float32)
    ctrs = rng.normal(size=(n_clusters, idim)).astype(np.float32) * 6.0
    assign = rng.integers(0, n_clusters, n)
    low = (ctrs[assign]
           + rng.normal(size=(n, idim)).astype(np.float32) * cluster_std)
    return (low @ basis / np.sqrt(idim)).astype(np.float32)


def blocked_clusters(n: int, dim: int, nblocks: int, *, spread: float = 0.05,
                     sep: float = 20.0, seed: int = 0) -> np.ndarray:
    """One tight cluster per contiguous index block, centers pairwise
    >= ``sep`` apart (norm laddering). With block-per-rank sharding every
    cross-block systolic tile is prunable by the block-summary test."""
    if n % nblocks != 0:
        raise ValueError(f"n={n} is not a multiple of nblocks={nblocks}")
    rng = np.random.default_rng(seed)
    ctrs = rng.normal(size=(nblocks, dim)).astype(np.float64)
    ctrs = (ctrs / np.linalg.norm(ctrs, axis=1, keepdims=True)) * sep
    ctrs *= (1 + np.arange(nblocks))[:, None]
    reps = n // nblocks
    pts = (np.repeat(ctrs, reps, axis=0)
           + rng.normal(size=(nblocks * reps, dim)) * spread)
    return pts.astype(np.float32)
