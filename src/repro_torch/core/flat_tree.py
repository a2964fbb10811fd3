"""Levelized structure-of-arrays cover trees (the device-resident layout).

``FlatCoverTree`` re-expresses one or more ``CoverTree``s (a *forest*) as
per-level padded node tables — the array-levelized layout that makes batch
traversal practical (Elkin's compressed cover tree, arXiv:2205.10194, and
the parallel metric skip-list work use the same recasting):

  level l, slot j  ->  node_gid     global point row of the node's point
                       node_radius  true-distance hub radius (float64)
                       node_cell    group id (Voronoi cell; -1 = padding)
                       node_leaf    1 if the node is a leaf
                       parent_pos   slot of the parent in level l-1
                       child_lo/hi  contiguous child slot range in level l+1
                       leaf_lo/hi   DFS leaf range into ``leaf_ids``

Children of level-l nodes are emitted in parent order, so every node's
children occupy a *contiguous* slot range of level l+1 (a per-level CSR
without an indirection list) and the whole structure is eight dense
rectangles — exactly what a level-by-level traversal loop wants.

Consumers:

- host: ``query_host`` is the level-synchronous batch query (Alg. 3) over
  the flat tables; ``CoverTree.query`` is a thin wrapper over it. Distances
  stay float64 (the framework's exactness ground truth) and the expand
  slack is scale-relative.
- device: ``to_device_tables`` / ``stack_device_forests`` export the
  int32/fp32 tables consumed by the level-synchronous traversal on the card
  (``repro_torch.kernels.tree_frontier`` + ``device.tree_traverse``).

- online maintenance: ``insert_host`` descends each new point to its
  covering node and appends it into the padded slot ranges, and
  ``tombstone_host`` masks deleted points in place (float64, as the
  reference's; ``repro_torch.stream.OnlineNNG`` drives both).

This is the port's own copy of the reference's host module.

Counters: every query reports ``dists_evaluated`` (frontier pairs whose
distance was computed) and ``nodes_pruned`` (frontier pairs whose subtree
was discarded after that one distance) via ``TraversalStats`` — the same
definitions the device traversal mirrors, so host/device pruning power is
directly comparable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence

import numpy as np

from .metrics_host import HostMetric, get_host_metric

if TYPE_CHECKING:  # pragma: no cover
    from .covertree import CoverTree

PAD = -1
SENTINEL_ID = 2**31 - 1     # device leaf-id padding (matches device.SENTINEL)


@dataclass
class TraversalStats:
    """Work counters of one (batch) cover-tree traversal."""

    dists_evaluated: int = 0    # frontier (query, node) distance evaluations
    nodes_pruned: int = 0       # frontier pairs discarded after one distance
    levels: int = 0             # deepest level the frontier reached

    def add(self, other: "TraversalStats") -> None:
        self.dists_evaluated += other.dists_evaluated
        self.nodes_pruned += other.nodes_pruned
        self.levels = max(self.levels, other.levels)


@dataclass
class FlatCoverTree:
    """Per-level padded node tables over a (forest of) cover tree(s).

    All (L, N) tables are padded with ``PAD`` cells / zero ranges; ``N`` is
    a multiple of 32 so packed-bitmask consumers need no edge handling.
    ``leaf_ids`` holds GLOBAL point ids in forest DFS order, padded with
    ``SENTINEL_ID`` to a multiple of 32.
    """

    points: np.ndarray          # (n_global, d) backing coordinates
    metric: HostMetric
    node_gid: np.ndarray        # (L, N) int32, PAD on padding slots
    node_radius: np.ndarray     # (L, N) float64 true-distance radius
    node_cell: np.ndarray       # (L, N) int32 group id, PAD = invalid
    node_leaf: np.ndarray       # (L, N) int32 (1 = leaf)
    parent_pos: np.ndarray      # (L, N) int32 slot in level l-1 (0 for roots)
    child_lo: np.ndarray        # (L, N) int32 child slot range in level l+1
    child_hi: np.ndarray
    leaf_lo: np.ndarray         # (L, N) int32 DFS leaf range into leaf_ids
    leaf_hi: np.ndarray
    leaf_ids: np.ndarray        # (n_leaf_padded,) int32 global ids

    @property
    def num_levels(self) -> int:
        return self.node_gid.shape[0]

    @property
    def level_width(self) -> int:
        return self.node_gid.shape[1]

    def __post_init__(self) -> None:
        # packed-bitmask consumers rely on these paddings; check once here
        # instead of per kernel call
        assert self.node_gid.shape[1] % 32 == 0, self.node_gid.shape
        assert self.leaf_ids.shape[0] % 32 == 0, self.leaf_ids.shape
        self._n_leaf = int(np.sum(self.leaf_ids != SENTINEL_ID))

    @property
    def num_leaves(self) -> int:        # true leaf count (un-padded)
        return self._n_leaf

    # -- host query (Alg. 3 over the flat tables) --------------------------
    def query_host(
        self,
        queries: np.ndarray,
        eps: float,
        qcells: np.ndarray | None = None,
        stats: TraversalStats | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """All (query, point) pairs within ``eps``; level-synchronous.

        ``qcells`` scopes each query to trees whose roots carry that cell id
        (the landmark engine's intra-cell semantics); ``None`` queries every
        tree in the forest. Returns (q_idx, gid) arrays with ``gid`` global
        point ids. Semantics (incl. the scale-relative expand slack) are
        identical to the pre-flat ``CoverTree.query``.
        """
        met = self.metric
        nq = len(queries)
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        if nq == 0 or self.num_levels == 0:
            return empty
        q_hits: list[np.ndarray] = []
        p_hits: list[np.ndarray] = []
        root_pos = np.flatnonzero(self.node_cell[0] != PAD)
        if qcells is None:
            fq = np.repeat(np.arange(nq, dtype=np.int64), len(root_pos))
            fv = np.tile(root_pos, nq)
        else:
            qq, rr = np.nonzero(
                np.asarray(qcells)[:, None] == self.node_cell[0][root_pos][None, :])
            fq, fv = qq.astype(np.int64), root_pos[rr]
        for lvl in range(self.num_levels):
            if len(fq) == 0:
                break
            if stats is not None:
                stats.dists_evaluated += len(fq)
                stats.levels = max(stats.levels, lvl + 1)
            gid = self.node_gid[lvl][fv]
            d = np.asarray(met.true(met.rowwise(queries[fq], self.points[gid])),
                           np.float64)
            rad = self.node_radius[lvl][fv]
            # full inclusion: emit the node's DFS leaf range wholesale
            incl = d + rad <= eps
            if incl.any():
                lo = self.leaf_lo[lvl][fv[incl]].astype(np.int64)
                cnt = self.leaf_hi[lvl][fv[incl]].astype(np.int64) - lo
                qe = np.repeat(fq[incl], cnt)
                total = int(cnt.sum())
                offs = np.arange(total) - np.repeat(
                    np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt)
                pe = self.leaf_ids[np.repeat(lo, cnt) + offs].astype(np.int64)
                live = pe != SENTINEL_ID    # skip tombstoned leaf entries
                q_hits.append(qe[live])
                p_hits.append(pe[live])
            leaf = self.node_leaf[lvl][fv] != 0
            hit = (leaf & (~incl) & (d <= eps)
                   & (self.node_cell[lvl][fv] != PAD))   # tombstoned leaves
            if hit.any():
                q_hits.append(fq[hit])
                p_hits.append(gid[hit].astype(np.int64))
            # triangle-inequality prune, scale-relative slack
            bound = rad + eps
            expand = ((~leaf) & (~incl)
                      & (d <= bound + 1e-9 + 1e-12 * (d + bound)))
            if stats is not None:
                stats.nodes_pruned += int(np.sum(~incl & ~hit & ~expand))
            ev, eq = fv[expand], fq[expand]
            lo = self.child_lo[lvl][ev].astype(np.int64)
            counts = self.child_hi[lvl][ev].astype(np.int64) - lo
            fq = np.repeat(eq, counts)
            total = int(counts.sum())
            if total == 0:
                break
            offs = np.arange(total) - np.repeat(
                np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
            fv = np.repeat(lo, counts) + offs
        if not q_hits:
            return empty
        return np.concatenate(q_hits), np.concatenate(p_hits)

    # -- online maintenance (incremental insert / tombstone delete) ---------
    #
    # The padded tables are append-friendly: occupied slots are a prefix of
    # every level row (flatten emits them contiguously and the insert paths
    # below preserve that), so "free space" is just the padded suffix, and
    # regrow-on-overflow is the same doubling the device builder uses.
    #
    # Child ranges keep SUPERSET semantics under slot insertion: a parent
    # range straddling the insertion point absorbs the new (foreign) slot.
    # No child is ever lost, so queries stay exact — a host traversal may
    # visit a stray sibling, costing one extra distance. Structural truth
    # is ``parent_pos`` (what the device traversal propagates on), and the
    # insert descent follows true children only.

    def _occ(self, lvl: int) -> int:
        return int(np.count_nonzero(self.node_gid[lvl] != PAD))

    def _leaf_used(self) -> int:
        """Allocated leaf positions (tombstoned entries keep their slot)."""
        occ = self.node_gid != PAD
        return int(self.leaf_hi[occ].max()) if occ.any() else 0

    def _node_tables(self):
        return (self.node_gid, self.node_radius, self.node_cell,
                self.node_leaf, self.parent_pos, self.child_lo,
                self.child_hi, self.leaf_lo, self.leaf_hi)

    _TABLE_FILL = (PAD, 0.0, PAD, 0, 0, 0, 0, 0, 0)
    _TABLE_KEYS = ("node_gid", "node_radius", "node_cell", "node_leaf",
                   "parent_pos", "child_lo", "child_hi", "leaf_lo",
                   "leaf_hi")

    def _grow_width(self) -> None:
        L, N = self.node_gid.shape
        for key, fill in zip(self._TABLE_KEYS, self._TABLE_FILL):
            a = getattr(self, key)
            out = np.full((L, 2 * N), fill, a.dtype)
            out[:, :N] = a
            setattr(self, key, out)

    def _grow_levels(self) -> None:
        N = self.level_width
        for key, fill in zip(self._TABLE_KEYS, self._TABLE_FILL):
            a = getattr(self, key)
            setattr(self, key, np.concatenate(
                [a, np.full((1, N), fill, a.dtype)]))

    def _grow_leaf_ids(self) -> None:
        old = self.leaf_ids
        self.leaf_ids = np.full(2 * len(old), SENTINEL_ID, old.dtype)
        self.leaf_ids[:len(old)] = old

    def _insert_slot(self, lvl: int, pos: int, vp: int) -> None:
        """Open a node slot at (lvl, pos >= 1 level), shifting the occupied
        suffix right and fixing every reference into / out of the level.
        ``vp`` is the new slot's parent in lvl-1, exempt from the child_lo
        bump so its empty range [pos, pos) opens to [pos, pos+1) instead of
        sliding whole to [pos+1, pos+1)."""
        used = self._occ(lvl)
        if used == self.level_width:
            self._grow_width()
        for a in self._node_tables():
            a[lvl, pos + 1:used + 1] = a[lvl, pos:used]
        occ = self.node_gid[lvl - 1] != PAD
        bump = occ & (self.child_lo[lvl - 1] >= pos)
        bump[vp] = False
        self.child_lo[lvl - 1][bump] += 1
        self.child_hi[lvl - 1][occ & (self.child_hi[lvl - 1] >= pos)] += 1
        if lvl + 1 < self.num_levels:
            occ2 = self.node_gid[lvl + 1] != PAD
            self.parent_pos[lvl + 1][
                occ2 & (self.parent_pos[lvl + 1] >= pos)] += 1

    def _insert_leaf(self, P: int, gid: int, anc: list) -> None:
        """Insert leaf entry ``gid`` at position ``P``, shifting the used
        suffix right. Generic range fixup plus an explicit extension of the
        ancestor chain ``anc`` (the ranges ending exactly at P that must
        absorb the new entry)."""
        A = self._leaf_used()
        if A == len(self.leaf_ids):
            self._grow_leaf_ids()
        self.leaf_ids[P + 1:A + 1] = self.leaf_ids[P:A]
        self.leaf_ids[P] = gid
        occ = self.node_gid != PAD
        self.leaf_lo[occ & (self.leaf_lo >= P)] += 1
        self.leaf_hi[occ & (self.leaf_hi > P)] += 1
        for lvl, v in anc:
            if self.leaf_hi[lvl, v] == P:
                self.leaf_hi[lvl, v] += 1
        self._n_leaf += 1

    def _placeholder_child_ptr(self, lvl: int, pos: int) -> int:
        """An empty child range value for a new leaf at (lvl, pos): any slot
        of lvl+1 consistent with its neighbors (leaves never expand)."""
        if pos < self._occ(lvl):
            return int(self.child_lo[lvl, pos])
        return int(self.child_hi[lvl, pos - 1]) if pos > 0 else 0

    def _write_leaf_slot(self, lvl, pos, gid, rad, cell, parent, cptr,
                         llo, lhi):
        self.node_gid[lvl, pos] = gid
        self.node_radius[lvl, pos] = rad
        self.node_cell[lvl, pos] = cell
        self.node_leaf[lvl, pos] = 1
        self.parent_pos[lvl, pos] = parent
        self.child_lo[lvl, pos] = cptr
        self.child_hi[lvl, pos] = cptr
        self.leaf_lo[lvl, pos] = llo
        self.leaf_hi[lvl, pos] = lhi

    def _leaf_to_internal(self, lvl: int, v: int) -> None:
        """Nesting invariant on conversion: the leaf becomes internal and a
        self-copy leaf child keeps its point + leaf range. A tombstoned
        self-copy stays tombstoned (cell PAD); the caller revives v."""
        if lvl + 1 == self.num_levels:
            self._grow_levels()
        pos = int(self.child_lo[lvl, v])
        cptr = self._placeholder_child_ptr(lvl + 1, pos)
        self._insert_slot(lvl + 1, pos, vp=v)
        self._write_leaf_slot(
            lvl + 1, pos, int(self.node_gid[lvl, v]), 0.0,
            int(self.node_cell[lvl, v]), v, cptr,
            int(self.leaf_lo[lvl, v]), int(self.leaf_hi[lvl, v]))
        self.node_leaf[lvl, v] = 0

    def _attach(self, lvl: int, v: int, g: int, cell: int,
                anc: list) -> None:
        """Append point ``g`` as a new leaf child of internal (lvl, v)."""
        pos = int(self.child_hi[lvl, v])
        P = int(self.leaf_hi[lvl, v])
        cptr = self._placeholder_child_ptr(lvl + 1, pos)
        self._insert_leaf(P, g, anc)
        self._insert_slot(lvl + 1, pos, vp=v)
        self._write_leaf_slot(lvl + 1, pos, g, 0.0, cell, v, cptr, P, P + 1)

    def _append_root(self, g: int, cell: int) -> None:
        slot = self._occ(0)
        if slot == self.level_width:
            self._grow_width()
        P = self._leaf_used()
        if P == len(self.leaf_ids):
            self._grow_leaf_ids()
        self.leaf_ids[P] = g
        self._n_leaf += 1
        cptr = int(self.child_hi[0, slot - 1]) if slot > 0 else 0
        self._write_leaf_slot(0, slot, g, 0.0, cell, 0, cptr, P, P + 1)

    def _true_dist(self, g: int, gid_other) -> np.ndarray:
        met = self.metric
        q = self.points[g][None]
        other = self.points[np.asarray(gid_other, np.int64)]
        return np.asarray(
            met.true(met.rowwise(other, np.broadcast_to(q, other.shape))),
            np.float64)

    def insert_host(self, gids, cells=None, points=None) -> None:
        """Incremental insert: one top-down descent per point.

        Each point descends from its cell's root along TRUE children
        (nearest by float64 distance), max-updating every visited node's
        radius with its own distance — which keeps the covering bound exact
        (separation quality is only an efficiency concern). The point is
        attached as a new single-point leaf child of the deepest internal
        node reached (leaves convert via the nesting self-copy first); a
        point whose cell has no live root starts a new singleton root.

        ``points`` rebinds the global coordinate table (it must contain the
        new rows); ``cells`` defaults to 0 (the block-forest convention).
        """
        if points is not None:
            self.points = np.asarray(points)
        gids = np.asarray(gids, np.int64).ravel()
        cells_arr = np.broadcast_to(
            np.asarray(0 if cells is None else cells, np.int64), gids.shape)
        for g, c in zip(gids, cells_arr):
            self._insert_one(int(g), int(c))

    def _insert_one(self, g: int, cell: int) -> None:
        roots = np.flatnonzero(self.node_gid[0] != PAD)
        roots = roots[self.node_cell[0][roots] == cell]
        if len(roots) == 0:
            self._append_root(g, cell)
            return
        v = int(roots[np.argmin(self._true_dist(g, self.node_gid[0][roots]))])
        lvl = 0
        anc: list[tuple[int, int]] = []
        while True:
            anc.append((lvl, v))
            d = float(self._true_dist(g, [self.node_gid[lvl, v]])[0])
            if d > self.node_radius[lvl, v]:
                self.node_radius[lvl, v] = d
            if self.node_leaf[lvl, v]:
                self._leaf_to_internal(lvl, v)
                self.node_cell[lvl, v] = cell    # revive if tombstoned
                self._attach(lvl, v, g, cell, anc)
                return
            ch = np.arange(self.child_lo[lvl, v], self.child_hi[lvl, v])
            ch = ch[self.parent_pos[lvl + 1][ch] == v]   # true children only
            w = int(ch[np.argmin(
                self._true_dist(g, self.node_gid[lvl + 1][ch]))])
            if self.node_leaf[lvl + 1, w]:
                self._attach(lvl, v, g, cell, anc)
                return
            lvl, v = lvl + 1, w

    def tombstone_host(self, gids) -> None:
        """Mask deleted points. Their ``leaf_ids`` entries become
        ``SENTINEL_ID`` (range emission — host and device — drops them) and
        their leaf slots' cell goes PAD (the host leaf-hit path drops
        them). Slots stay occupied — ``node_gid`` keeps marking them — so
        no range anywhere moves."""
        gids = np.asarray(gids, np.int64).ravel()
        hit = np.isin(self.leaf_ids, gids) & (self.leaf_ids != SENTINEL_ID)
        self.leaf_ids[hit] = SENTINEL_ID
        self._n_leaf -= int(np.count_nonzero(hit))
        dead = ((self.node_leaf != 0) & (self.node_gid != PAD)
                & np.isin(self.node_gid, gids))
        self.node_cell[dead] = PAD

    # -- device export ------------------------------------------------------
    def to_device_tables(self) -> dict[str, np.ndarray]:
        """Gather the device-ready int32/fp32 tables (coords included).

        Coordinates are gathered per level from ``points`` (fp32 for
        euclidean, packed uint32 for hamming); float64 radii round to fp32
        — the device traversal's scale-relative slack covers that rounding.
        """
        gid = np.maximum(self.node_gid, 0)
        coords = self.points[gid]               # (L, N, d), pad slots benign
        coords = np.ascontiguousarray(coords, self.metric.dtype)
        return {
            "coords": coords,
            "radius": self.node_radius.astype(np.float32),
            "cell": self.node_cell.astype(np.int32),
            "leaf": self.node_leaf.astype(np.int32),
            "parent": self.parent_pos.astype(np.int32),
            "leaf_lo": self.leaf_lo.astype(np.int32),
            "leaf_hi": self.leaf_hi.astype(np.int32),
            "leaf_ids": self.leaf_ids.astype(np.int32),
        }


def _round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


def flatten_forest(
    trees: Sequence["CoverTree"],
    cells: Sequence[int] | None = None,
    gids: Sequence[np.ndarray] | None = None,
    points: np.ndarray | None = None,
    *,
    pad_mult: int = 32,
) -> FlatCoverTree:
    """Levelize a forest of cover trees into one ``FlatCoverTree``.

    ``cells[t]`` is the group id stamped on every node of tree ``t``
    (default 0); ``gids[t]`` maps tree-local point rows to global ids
    (default: arange offsets by tree); ``points`` is the global coordinate
    table (default: the single tree's own points).
    """
    assert len(trees) > 0, "empty forest"
    if cells is None:
        cells = [0] * len(trees)
    if gids is None:
        offs = np.cumsum([0] + [len(t.points) for t in trees[:-1]])
        gids = [np.arange(len(t.points), dtype=np.int64) + o
                for t, o in zip(trees, offs)]
    if points is None:
        assert len(trees) == 1, "forest flatten needs an explicit points table"
        points = trees[0].points
    met = trees[0].metric

    leaf_off = np.cumsum([0] + [len(t.leaf_pts) for t in trees])
    n_leaf = int(leaf_off[-1])
    leaf_ids = np.full(_round_up(max(n_leaf, 1), pad_mult), SENTINEL_ID,
                       np.int32)
    for t, tree in enumerate(trees):
        leaf_ids[leaf_off[t]:leaf_off[t + 1]] = np.asarray(
            gids[t])[tree.leaf_pts]

    # level-by-level across ALL trees; children appended in parent order so
    # each node's children are one contiguous slot range of the next level
    levels: list[dict] = []
    frontier = [(t, 0, 0) for t in range(len(trees))]   # (tree, vertex, parent_pos)
    while frontier:
        rec = {k: [] for k in ("gid", "rad", "cell", "leaf", "parent",
                               "clo", "chi", "llo", "lhi")}
        nxt: list[tuple[int, int, int]] = []
        for j, (t, v, ppos) in enumerate(frontier):
            tree = trees[t]
            rec["gid"].append(int(np.asarray(gids[t])[tree.node_pt[v]]))
            rec["rad"].append(float(tree.node_radius[v]))
            rec["cell"].append(int(cells[t]))
            rec["leaf"].append(int(tree.is_leaf[v]))
            rec["parent"].append(ppos)
            rec["llo"].append(int(tree.leaf_lo[v] + leaf_off[t]))
            rec["lhi"].append(int(tree.leaf_hi[v] + leaf_off[t]))
            rec["clo"].append(len(nxt))
            for c in tree.children(v):
                nxt.append((t, int(c), j))
            rec["chi"].append(len(nxt))
        levels.append(rec)
        frontier = nxt

    L = len(levels)
    N = _round_up(max(len(rec["gid"]) for rec in levels), pad_mult)

    def table(key, dtype, fill):
        out = np.full((L, N), fill, dtype)
        for l, rec in enumerate(levels):
            out[l, :len(rec[key])] = rec[key]
        return out

    return FlatCoverTree(
        points=points,
        metric=met,
        node_gid=table("gid", np.int32, PAD),
        node_radius=table("rad", np.float64, 0.0),
        node_cell=table("cell", np.int32, PAD),
        node_leaf=table("leaf", np.int32, 0),
        parent_pos=table("parent", np.int32, 0),
        child_lo=table("clo", np.int32, 0),
        child_hi=table("chi", np.int32, 0),
        leaf_lo=table("llo", np.int32, 0),
        leaf_hi=table("lhi", np.int32, 0),
        leaf_ids=leaf_ids,
    )


def flatten_covertree(tree: "CoverTree") -> FlatCoverTree:
    """Single-tree flatten: global ids are the tree's own point rows."""
    return flatten_forest([tree])


# ---------------------------------------------------------------------------
# forest builders for the two engines
# ---------------------------------------------------------------------------

def build_block_forests(
    points: np.ndarray, nranks: int, metric: str = "euclidean",
    leaf_size: int = 10, *, backend: str = "host", device=None, mesh=None,
):
    """Systolic engine: one flat tree per equal contiguous block (rank).

    Global ids are the block rows' global indices; every node carries cell
    id 0 (no group scoping on the ring path). ``len(points)`` must divide
    evenly (the engine's contract).

    ``backend="host"`` (the float64 oracle) returns the per-rank
    ``FlatCoverTree`` list; ``backend="device"`` runs the torch builder in
    ``flat_tree_device`` on ``device`` (default: the CUDA card) and returns
    the stacked device-tables dict directly (what ``stack_device_forests``
    yields from the host list, as tensors; on a ``mesh`` over processes,
    this process's ranks' rows of it).
    """
    if backend == "device":
        from .flat_tree_device import build_block_forests_device

        return build_block_forests_device(points, nranks, metric, leaf_size,
                                          device=device, mesh=mesh)
    assert backend == "host", backend
    from .covertree import build_covertree

    n = len(points)
    assert n % nranks == 0, (n, nranks)
    n_loc = n // nranks
    out = []
    for r in range(nranks):
        blk = points[r * n_loc:(r + 1) * n_loc]
        tree = build_covertree(blk, metric, leaf_size)
        out.append(flatten_forest(
            [tree], cells=[0],
            gids=[np.arange(n_loc, dtype=np.int64) + r * n_loc],
            points=points))
    return out


def build_cell_forests(
    points: np.ndarray, cell: np.ndarray, f: np.ndarray, nranks: int,
    metric: str = "euclidean", leaf_size: int = 10, *, backend: str = "host",
    device=None, mesh=None,
):
    """Landmark engine: per rank, a forest of per-cell cover trees over the
    cells LPT-assigned to it (``f``: cell -> rank), in ascending cell id.
    Nodes carry their cell id, so a traversal scopes a query to its own
    cell (or, on the ghost ring, to its ghost cells): the cells are the
    level-1 cover and each cell's tree the levels below it. A rank that
    owns no points gets a 1-node placeholder tree with cell -2, which no
    query matches.

    ``backend`` as in ``build_block_forests``: "host" returns the
    ``FlatCoverTree`` list, "device" the stacked device-tables dict as
    tensors on ``device``. On a ``mesh`` over processes each process
    builds its own ranks' forests only: the host list holds
    ``mesh.local_ranks``' forests, in rank order (``stack_device_forests``
    with the same ``mesh`` stacks them to this process's rows of the
    stack of all), and the device dict this process's rows.
    """
    if backend == "device":
        from .flat_tree_device import build_cell_forests_device

        return build_cell_forests_device(points, cell, f, nranks, metric,
                                         leaf_size, device=device, mesh=mesh)
    assert backend == "host", backend
    from .covertree import build_covertree
    from .flat_tree_device import _local_build

    f = np.asarray(f)
    cell = np.asarray(cell)
    out = []
    for r in range(nranks)[_local_build(mesh, nranks)[0]]:
        trees, tcells, tgids = [], [], []
        for ci in np.flatnonzero(f == r):
            members = np.flatnonzero(cell == ci)
            if len(members) == 0:
                continue
            trees.append(build_covertree(points[members], metric, leaf_size))
            tcells.append(int(ci))
            tgids.append(members)
        if not trees:
            trees = [build_covertree(points[:1], metric, leaf_size)]
            tcells = [-2]
            tgids = [np.zeros(1, np.int64)]
        out.append(flatten_forest(trees, cells=tcells, gids=tgids,
                                  points=points))
    return out


def stack_device_forests(forests: Sequence[FlatCoverTree], mesh=None
                         ) -> dict[str, np.ndarray]:
    """Pad per-rank device tables to common (L, N, n_leaf) and stack to a
    leading rank axis — rank r's forest is entry r of every table.

    On a ``mesh`` over processes ``forests`` are this process's ranks'
    (``mesh.local_ranks``) and the common sizes are the largest of every
    process's (one all-reduce), so the stack is this process's rows of the
    stack of every rank's forests, bit for bit.
    """
    tabs = [f.to_device_tables() for f in forests]
    L = max(t["radius"].shape[0] for t in tabs)
    N = max(t["radius"].shape[1] for t in tabs)
    nl = max(t["leaf_ids"].shape[0] for t in tabs)
    if mesh is not None and mesh.world > 1:
        from .distributed import comm
        L, N, nl = comm.all_max(mesh, L, N, nl)

    def pad(a, shape, fill):
        out = np.full(shape, fill, a.dtype)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    stacked = {}
    for key in tabs[0]:
        fill = PAD if key == "cell" else (
            SENTINEL_ID if key == "leaf_ids" else 0)
        arrs = []
        for t in tabs:
            a = t[key]
            shape = ((nl,) if key == "leaf_ids"
                     else (L, N) + a.shape[2:])
            arrs.append(pad(a, shape, fill))
        stacked[key] = np.stack(arrs)
    return stacked
