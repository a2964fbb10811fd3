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

This is the port's own copy of the reference's host module, without the
online-maintenance paths (``insert_host`` / ``tombstone_host``, ROADMAP
item 8) and the landmark engine's ``build_cell_forests`` (ROADMAP item 7).

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

    def __post_init__(self) -> None:
        # packed-bitmask consumers rely on these paddings; check once here
        # instead of per kernel call
        assert self.node_gid.shape[1] % 32 == 0, self.node_gid.shape
        assert self.leaf_ids.shape[0] % 32 == 0, self.leaf_ids.shape

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
# forest builder for the systolic engine
# ---------------------------------------------------------------------------

def build_block_forests(
    points: np.ndarray, nranks: int, metric: str = "euclidean",
    leaf_size: int = 10, *, backend: str = "host", device=None,
):
    """Systolic engine: one flat tree per equal contiguous block (rank).

    Global ids are the block rows' global indices; every node carries cell
    id 0 (no group scoping on the ring path). ``len(points)`` must divide
    evenly (the engine's contract).

    ``backend="host"`` (the float64 oracle) returns the per-rank
    ``FlatCoverTree`` list; ``backend="device"`` runs the torch builder in
    ``flat_tree_device`` on ``device`` (default: the CUDA card) and returns
    the stacked device-tables dict directly (what ``stack_device_forests``
    yields from the host list, as tensors).
    """
    if backend == "device":
        from .flat_tree_device import build_block_forests_device

        return build_block_forests_device(points, nranks, metric, leaf_size,
                                          device=device)
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


def stack_device_forests(forests: Sequence[FlatCoverTree]) -> dict[str, np.ndarray]:
    """Pad per-rank device tables to common (L, N, n_leaf) and stack to a
    leading rank axis — rank r's forest is entry r of every table.
    """
    tabs = [f.to_device_tables() for f in forests]
    L = max(t["radius"].shape[0] for t in tabs)
    N = max(t["radius"].shape[1] for t in tabs)
    nl = max(t["leaf_ids"].shape[0] for t in tabs)

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
