"""ε-graph results: the CSR ``NNGraph`` public result type, normalized
``RunStats`` counters, and the ``EpsGraph`` edge-set oracle representation.

``NNGraph`` is what ``repro_torch.nng.build_nng`` returns: a symmetric CSR
adjacency (``row_ptr`` / ``col_ids``, numpy) built from the engine's padded
``(ids, nbrs)`` neighbour tables, carrying a ``RunStats`` and a provenance
``meta`` dict. The tables are assembled into the CSR with torch on the
device they live on (the GPU on the main path), and only the CSR is
copied to the host. ``EpsGraph`` is the canonical (i < j) edge set the
oracle and the tests use; the two compare equal on equal edge sets.

The online delta log of the reference's ``NNGraph`` comes with the online
slice of the port (ROADMAP item 8).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

SENTINEL = 2**31 - 1     # neighbour-table padding id


@dataclass
class RunStats:
    """Normalized work / communication counters of one graph build, under
    the reference's names. Counters are floats end to end: the engine
    reports float32 (exact below 2^24; int32 would wrap at paper scale)."""

    tiles_scheduled: float = 0.0   # tile blocks the schedule would evaluate
    tiles_skipped: float = 0.0     # blocks pruned (triangle inequality)
    dists_evaluated: float = 0.0   # pair distances actually computed
    nodes_pruned: float = 0.0      # tree frontier pairs discarded
    comm_bytes: dict = field(default_factory=dict)  # channel -> bytes
    overflow: bool = False         # final run overflowed (never via drivers)
    replans: int = 0               # overflow -> grow iterations taken
    elapsed_s: float = 0.0         # wall clock of the final (exact) run
    build_s: float = 0.0           # forest-construction wall clock (tree
                                   # traversal only; 0.0 on tile paths)

    @property
    def total_comm_bytes(self) -> float:
        return float(sum(self.comm_bytes.values()))

    @property
    def tile_skip_rate(self) -> float:
        return self.tiles_skipped / max(self.tiles_scheduled, 1.0)


class NNGraph:
    """Symmetric CSR ε-neighbour graph on ``n`` points.

    ``row_ptr`` (n+1,) int64 and ``col_ids`` (nnz,) int32: row i's
    neighbours are ``col_ids[row_ptr[i]:row_ptr[i+1]]``, sorted ascending.
    Both directions are stored, so ``row_ptr[-1] == 2 * num_edges``. Edge
    keys are int64 (``i * n + j`` overflows int32 from n ≈ 46k).
    """

    def __init__(self, n: int, row_ptr: np.ndarray, col_ids: np.ndarray,
                 stats: RunStats | None = None, meta: dict | None = None):
        self.n = int(n)
        self.row_ptr = np.asarray(row_ptr, np.int64)
        self.col_ids = np.asarray(col_ids, np.int32)
        if self.row_ptr.shape != (self.n + 1,) or \
                self.row_ptr[-1] != len(self.col_ids):
            raise ValueError("row_ptr does not describe col_ids")
        self.stats = stats if stats is not None else RunStats()
        self.meta = dict(meta or {})

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_directed_pairs(cls, n: int, src, dst, stats=None, meta=None
                            ) -> "NNGraph":
        """Build from directed (src, dst) hit pairs (numpy or torch; the
        work runs on their device): drops self loops and out-of-range
        endpoints (duplicate-padding rows), symmetrizes, dedups."""
        src = torch.as_tensor(src).to(torch.int64)
        dst = torch.as_tensor(dst).to(device=src.device, dtype=torch.int64)
        keep = (src < n) & (dst < n) & (src >= 0) & (dst >= 0) & (src != dst)
        src, dst = src[keep], dst[keep]
        key = torch.unique(torch.cat([src * n + dst, dst * n + src]))
        row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
        row_ptr[1:] = torch.cumsum(torch.bincount(key // n, minlength=n), 0)
        return cls(n, row_ptr.cpu().numpy(),
                   (key % n).to(torch.int32).cpu().numpy(), stats, meta)

    @classmethod
    def from_neighbor_tables(cls, n: int, tables, stats=None, meta=None
                             ) -> "NNGraph":
        """Build from engine outputs: ``tables`` is an iterable of
        (ids (m,), nbrs (m, k)) SENTINEL-padded per-row neighbour arrays
        (numpy or torch). Rows with id >= n (duplicate-padding) are
        dropped."""
        src_all, dst_all = [], []
        for ids, nbrs in tables:
            nbrs = torch.as_tensor(nbrs)
            ids = torch.as_tensor(ids).to(nbrs.device)
            valid = (ids != SENTINEL) & (ids < n)
            ii, kk = torch.nonzero((nbrs != SENTINEL) & valid[:, None],
                                   as_tuple=True)
            src_all.append(ids[ii].to(torch.int64))
            dst_all.append(nbrs[ii, kk].to(torch.int64))
        if not src_all:
            return cls.from_directed_pairs(n, np.zeros(0, np.int64),
                                           np.zeros(0, np.int64), stats, meta)
        return cls.from_directed_pairs(n, torch.cat(src_all),
                                       torch.cat(dst_all), stats, meta)

    # -- accessors ----------------------------------------------------------
    @property
    def num_edges(self) -> int:
        """Undirected edge count (the symmetric CSR stores 2 per edge)."""
        return int(self.row_ptr[-1]) // 2

    @property
    def avg_degree(self) -> float:
        return float(self.row_ptr[-1]) / max(self.n, 1)

    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def neighbors(self, i: int) -> np.ndarray:
        return self.col_ids[self.row_ptr[i]:self.row_ptr[i + 1]]

    def edge_key(self) -> np.ndarray:
        """Canonical (i < j) edge keys i * n + j, sorted, int64 — the same
        encoding ``EpsGraph.edge_key`` uses, for direct comparison."""
        rows = np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.row_ptr))
        cols = self.col_ids.astype(np.int64)
        upper = rows < cols
        return np.sort(rows[upper] * self.n + cols[upper])

    def __eq__(self, other) -> bool:
        if isinstance(other, NNGraph):
            return (self.n == other.n
                    and np.array_equal(self.row_ptr, other.row_ptr)
                    and np.array_equal(self.col_ids, other.col_ids))
        if isinstance(other, EpsGraph):
            return (self.n == other.n
                    and np.array_equal(self.edge_key(), other.edge_key()))
        return NotImplemented

    def __repr__(self):
        return (f"NNGraph(n={self.n}, edges={self.num_edges}, "
                f"avg_deg={self.avg_degree:.2f})")


class EpsGraph:
    """An undirected ε-graph on n points, stored as canonical (i < j) edges."""

    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray):
        self.n = int(n)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        keep = lo != hi  # drop self loops
        key = np.unique(lo[keep] * n + hi[keep])
        self.src = (key // n).astype(np.int64)
        self.dst = (key % n).astype(np.int64)

    @property
    def num_edges(self) -> int:
        return len(self.src)

    def edge_key(self) -> np.ndarray:
        return self.src * self.n + self.dst

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, EpsGraph)
            and self.n == other.n
            and bool(np.array_equal(self.edge_key(), other.edge_key()))
        )

    def __repr__(self):
        return (f"EpsGraph(n={self.n}, edges={self.num_edges}, "
                f"avg_deg={self.avg_degree:.2f})")
