"""Point-cloud sources for the ε-NNG engine (numpy).

Real datasets (``.fvecs``, as SIFT ships, or ``.npy``) are read when their
file exists; otherwise synthetic stand-ins matched to the paper's Table I
regime, made from a seed: clustered clouds of low intrinsic dimension, and
one tight cluster per index block.
"""
from __future__ import annotations

import os

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


def _read_fvecs(path: str) -> np.ndarray:
    """An ``.fvecs`` file: each row an int32 dimension d, then d float32."""
    raw = np.fromfile(path, dtype=np.int32)
    d = raw[0]
    return raw.reshape(-1, d + 1)[:, 1:].view(np.float32)


def load_pointset(name: str, n: int, dim: int, metric: str,
                  data_dir: str = "data"):
    """The first ``n`` rows of ``data_dir/name.fvecs`` or ``name.npy`` if
    either exists, else ``synthetic_pointset(n, dim, metric)`` seeded from
    ``hash(name)``: deterministic within one process (Python randomises
    ``str`` hashes per process unless ``PYTHONHASHSEED`` is set)."""
    for ext, reader in ((".fvecs", _read_fvecs), (".npy", np.load)):
        path = os.path.join(data_dir, name + ext)
        if os.path.exists(path):
            return np.ascontiguousarray(reader(path)[:n])
    return synthetic_pointset(n, dim, metric, seed=abs(hash(name)) % 2**31)
