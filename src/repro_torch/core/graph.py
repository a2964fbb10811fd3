"""ε-graph results: the CSR ``NNGraph`` public result type, normalized
``RunStats`` counters, and the ``EpsGraph`` edge-set oracle representation.

``NNGraph`` is what ``repro_torch.nng.build_nng`` returns: a symmetric CSR
adjacency (``row_ptr`` / ``col_ids``, numpy) built from the engine's padded
``(ids, nbrs)`` neighbour tables, carrying a ``RunStats`` and a provenance
``meta`` dict. The tables are assembled into the CSR with torch on the
device they live on (the GPU on the main path), and only the CSR is
copied to the host. ``EpsGraph`` is the canonical (i < j) edge set the
oracle and the tests use; the two compare equal on equal edge sets.

On top of the base CSR sits the online delta log (``OnlineNNG``'s edge
layer): appended edges and tombstoned nodes, host numpy as in the
reference, and every reader presents the merged view.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

SENTINEL = 2**31 - 1     # neighbour-table padding id


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` by one sort and a neighbour test. numpy 2.3's
    ``np.unique`` hashes before it sorts, which is many times slower than
    the sort alone on a million int64 edge keys (``chip_smoke.py`` [12b]
    times both on the merged view's keys)."""
    a = np.sort(a)
    if len(a) < 2:
        return a
    keep = np.empty(len(a), bool)
    keep[0] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


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
    kernel_s_est: float = 0.0      # est. wall clock inside distance kernels
                                   # (0.0 when not estimated)
    comm_s_est: float = 0.0        # elapsed_s - kernel_s_est when estimated
    update_s: float = 0.0          # wall clock of online updates (OnlineNNG
                                   # insert / delete, cumulative; apart from
                                   # the batch elapsed_s)
    edges_added: float = 0.0       # undirected edges appended by updates
    edges_removed: float = 0.0     # undirected edges dropped by tombstones

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
    Both directions are stored, so ``row_ptr[-1] == 2 * num_edges``.

    On top of the base CSR sits an optional **delta log** for online
    maintenance: an append-only list of added undirected edges plus a set
    of tombstoned node ids. All readers (``neighbors``, ``degrees``,
    ``edge_key``, ``num_edges``, ``to_eps_graph``, equality) present the
    MERGED view — base + adds − tombstoned — so a graph with a pending
    log is indistinguishable from its compacted form. ``compact()`` folds
    the log into a clean base CSR. Edge keys are int64 (``i * n + j``
    overflows int32 from n ≈ 46k).
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
        # delta log: canonical (lo < hi) added edges, tombstoned node ids
        self._add_lo = np.zeros(0, np.int64)
        self._add_hi = np.zeros(0, np.int64)
        self._dead = np.zeros(0, np.int64)      # sorted tombstoned ids
        self._dead_dirty = False                # base still holds dead edges
        self._tomb_edges = 0                    # edges removed since compact
        self._merged_cache = None

    # -- delta log (online maintenance) -------------------------------------
    @property
    def has_delta(self) -> bool:
        """True when reads must merge (pending adds or un-folded deletes)."""
        return len(self._add_lo) > 0 or self._dead_dirty

    @property
    def delta_edges(self) -> int:
        return len(self._add_lo)

    def _invalidate(self):
        self._merged_cache = None

    def _merged(self):
        """(row_ptr, col_ids) of the merged view (cached until mutated)."""
        if not self.has_delta:
            return self.row_ptr, self.col_ids
        if self._merged_cache is None:
            rows = np.repeat(np.arange(self.n, dtype=np.int64),
                             np.diff(self.row_ptr))
            cols = self.col_ids.astype(np.int64)
            src = np.concatenate([rows, self._add_lo, self._add_hi])
            dst = np.concatenate([cols, self._add_hi, self._add_lo])
            if self._dead_dirty and len(self._dead):
                live = ~(np.isin(src, self._dead) | np.isin(dst, self._dead))
                src, dst = src[live], dst[live]
            key = _sorted_unique(src * self.n + dst)
            rp = np.zeros(self.n + 1, np.int64)
            np.cumsum(np.bincount(key // self.n, minlength=self.n),
                      out=rp[1:])
            self._merged_cache = (rp, (key % self.n).astype(np.int32))
        return self._merged_cache

    def _upper_keys(self, rp, cols) -> np.ndarray:
        """Canonical (i < j) keys i * n + j of a CSR, in row order."""
        rows = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(rp))
        cols = cols.astype(np.int64)
        upper = rows < cols
        return rows[upper] * self.n + cols[upper]

    def delta_insert_nodes(self, k: int) -> np.ndarray:
        """Grow the node set by ``k`` isolated nodes; returns their ids.
        Ids are allocated densely at the end and never reused."""
        ids = np.arange(self.n, self.n + int(k), dtype=np.int64)
        self.row_ptr = np.concatenate(
            [self.row_ptr, np.full(int(k), self.row_ptr[-1], np.int64)])
        self.n += int(k)
        self._invalidate()
        return ids

    def delta_add_edges(self, src, dst) -> int:
        """Append undirected edges to the delta log. Drops self loops,
        out-of-range / SENTINEL endpoints (padding rows), edges touching
        tombstoned nodes, and duplicates (within the batch and against the
        current merged view). Returns the count of genuinely new edges."""
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        keep = (lo != hi) & (lo >= 0) & (hi < self.n)
        if len(self._dead):
            keep &= ~(np.isin(lo, self._dead) | np.isin(hi, self._dead))
        key = _sorted_unique(lo[keep] * self.n + hi[keep])
        if len(key):
            key = np.setdiff1d(key, self._upper_keys(*self._merged()),
                               assume_unique=True)
        if not len(key):
            return 0
        self._add_lo = np.concatenate([self._add_lo, key // self.n])
        self._add_hi = np.concatenate([self._add_hi, key % self.n])
        self.stats.edges_added += float(len(key))
        self._invalidate()
        return len(key)

    def delta_delete_nodes(self, ids) -> int:
        """Tombstone nodes: their edges vanish from the merged view and
        later adds touching them are rejected. Returns the number of
        undirected edges removed."""
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        ids = ids[(ids >= 0) & (ids < self.n)]
        ids = np.setdiff1d(ids, self._dead, assume_unique=True)
        if not len(ids):
            return 0
        rp, cols = self._merged()
        rows = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(rp))
        cols = cols.astype(np.int64)
        hit = np.isin(rows, ids) | np.isin(cols, ids)
        removed = int(np.count_nonzero(hit & (rows < cols)))
        self._dead = np.union1d(self._dead, ids)
        self._dead_dirty = True
        # prune the add-log of edges now dead (keeps the log size honest)
        if len(self._add_lo):
            live = ~(np.isin(self._add_lo, ids) | np.isin(self._add_hi, ids))
            self._add_lo, self._add_hi = self._add_lo[live], self._add_hi[live]
        self._tomb_edges += removed
        self.stats.edges_removed += float(removed)
        self._invalidate()
        return removed

    def compact(self) -> "NNGraph":
        """Fold the delta log into a clean base CSR, in place. Idempotent:
        compacting twice (or reading through a pending log) gives the same
        merged view. Tombstoned ids stay recorded, so later adds touching
        them are still rejected."""
        if self.has_delta:
            rp, cols = self._merged()
            self.row_ptr = np.asarray(rp, np.int64)
            self.col_ids = np.asarray(cols, np.int32)
            self._add_lo = np.zeros(0, np.int64)
            self._add_hi = np.zeros(0, np.int64)
            self._dead_dirty = False
            self._tomb_edges = 0
            self._invalidate()
            self.meta["compactions"] = int(self.meta.get("compactions", 0)) + 1
        return self

    def maybe_compact(self, ratio: float = 0.5) -> bool:
        """Size-ratio auto-compaction: fold once the pending delta (added
        plus tombstone-removed edges) exceeds ``ratio`` × base edges."""
        base = max(len(self.col_ids) // 2, 1)
        if self.delta_edges + self._tomb_edges > ratio * base:
            self.compact()
            return True
        return False

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

    # -- accessors (the merged view) ---------------------------------------
    @property
    def num_nodes(self) -> int:
        return self.n

    @property
    def num_edges(self) -> int:
        """Undirected edge count (the symmetric CSR stores 2 per edge)."""
        return int(self._merged()[0][-1]) // 2

    @property
    def avg_degree(self) -> float:
        return float(self._merged()[0][-1]) / max(self.n, 1)

    def degrees(self) -> np.ndarray:
        return np.diff(self._merged()[0])

    def neighbors(self, i: int) -> np.ndarray:
        base = self.col_ids[self.row_ptr[i]:self.row_ptr[i + 1]]
        if not self.has_delta:
            return base
        # a per-row merge: no full CSR rebuild for point lookups
        if self._dead_dirty and len(self._dead):
            if np.isin(i, self._dead):
                return np.zeros(0, self.col_ids.dtype)
            base = base[~np.isin(base.astype(np.int64), self._dead)]
        add = np.concatenate([self._add_hi[self._add_lo == i],
                              self._add_lo[self._add_hi == i]])
        if not len(add):
            return np.asarray(base)
        return np.unique(np.concatenate(
            [base.astype(np.int64), add])).astype(self.col_ids.dtype)

    def edge_key(self) -> np.ndarray:
        """Canonical (i < j) edge keys i * n + j, sorted, int64 — the same
        encoding ``EpsGraph.edge_key`` uses, for direct comparison."""
        return np.sort(self._upper_keys(*self._merged()))

    def to_eps_graph(self) -> "EpsGraph":
        rp, col = self._merged()
        rows = np.repeat(np.arange(self.n, dtype=np.int64), np.diff(rp))
        return EpsGraph(self.n, rows, col.astype(np.int64))

    def to_scipy_csr(self):
        """The adjacency (merged view) as a ``scipy.sparse.csr_array`` of
        uint8 ones. scipy is an optional dependency, imported here."""
        try:
            from scipy.sparse import csr_array
        except ImportError as e:
            raise ImportError(
                "NNGraph.to_scipy_csr requires the optional dependency "
                "scipy, which is not installed. The raw CSR arrays are "
                "available without scipy as .row_ptr / .col_ids "
                "(merged view via edge_key() / to_eps_graph())."
            ) from e
        rp, col = self._merged()
        data = np.ones(len(col), np.uint8)
        return csr_array((data, col, rp), shape=(self.n, self.n))

    def __eq__(self, other) -> bool:
        if isinstance(other, NNGraph):
            if self.n != other.n:
                return False
            rp_a, col_a = self._merged()
            rp_b, col_b = other._merged()
            return (np.array_equal(rp_a, rp_b)
                    and np.array_equal(col_a, col_b))
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
        key = _sorted_unique(lo[keep] * n + hi[keep])
        self.src = (key // n).astype(np.int64)
        self.dst = (key % n).astype(np.int64)

    @property
    def num_edges(self) -> int:
        return len(self.src)

    @property
    def avg_degree(self) -> float:
        return 2.0 * self.num_edges / max(self.n, 1)

    def degree(self) -> np.ndarray:
        deg = np.zeros(self.n, dtype=np.int64)
        np.add.at(deg, self.src, 1)
        np.add.at(deg, self.dst, 1)
        return deg

    def edge_key(self) -> np.ndarray:
        return self.src * self.n + self.dst

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, EpsGraph)
            and self.n == other.n
            and bool(np.array_equal(self.edge_key(), other.edge_key()))
        )

    def symmetric_difference(self, other: "EpsGraph") -> int:
        """Edges in exactly one of the two graphs (keys are sorted and
        unique by construction)."""
        return int(np.setxor1d(self.edge_key(), other.edge_key(),
                               assume_unique=True).size)

    def __repr__(self):
        return (f"EpsGraph(n={self.n}, edges={self.num_edges}, "
                f"avg_deg={self.avg_degree:.2f})")


def merge_graphs(n: int, graphs) -> EpsGraph:
    """The union of ``graphs``' edge sets on ``n`` nodes."""
    src = (np.concatenate([g.src for g in graphs]) if graphs
           else np.zeros(0, np.int64))
    dst = (np.concatenate([g.dst for g in graphs]) if graphs
           else np.zeros(0, np.int64))
    return EpsGraph(n, src, dst)


def edges_from_pairs(n: int, pairs: np.ndarray) -> EpsGraph:
    """An ``EpsGraph`` from an (m, 2) array of endpoint pairs."""
    if len(pairs) == 0:
        return EpsGraph(n, np.zeros(0, np.int64), np.zeros(0, np.int64))
    pairs = np.asarray(pairs)
    return EpsGraph(n, pairs[:, 0], pairs[:, 1])
