"""Batch cover tree construction and batch fixed-radius queries.

Faithful implementation of the paper's Algorithms 1-3:

- Alg. 1 (SplitVertex): repeated farthest-point (Gonzalez) selection inside a
  hub until the hub radius halves; guarantees the covering (r/2) and
  separating (> r/2) invariants.
- Alg. 2 (BuildLevel): level-synchronous construction. Our implementation
  vectorizes the splits of *all* active hubs simultaneously: each global
  iteration picks one new center per unfinished hub (segmented argmax) and
  updates every affected point's (D, L) with one batched rowwise-distance
  call. This is the shared-memory batch construction recast as data-parallel
  array operations; here it runs in numpy on the host, in float64. The
  on-card builder (``flat_tree_device.py``) makes the same decisions in
  torch.
- Alg. 3 (Query): batched level-synchronous frontier expansion with the
  triangle-inequality prune ``d(q, v) <= radius(v) + eps``, using stored hub
  radii (the paper notes they use vertex-triple radii instead of 2^l).

All radii and thresholds are in TRUE metric distance (sqrt of the squared-L2
comparable form) because cover tree arithmetic is additive.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .metrics_host import HostMetric, get_host_metric

_NEG = -1


@dataclass
class CoverTree:
    """Array-of-structs cover tree over a point set (indices into ``points``)."""

    points: np.ndarray          # (n, d) — owned reference, any metric dtype
    metric: HostMetric
    node_pt: np.ndarray         # (m,) point index of each vertex
    node_radius: np.ndarray     # (m,) float64 true-distance radius (0 => leaf)
    node_parent: np.ndarray     # (m,) parent vertex or -1 for root
    node_level: np.ndarray      # (m,) integer level (root highest)
    is_leaf: np.ndarray         # (m,) bool
    from_split: np.ndarray = field(default=None)   # (m,) bool: Alg-1 center?
    child_start: np.ndarray = field(default=None)  # CSR over children
    child_list: np.ndarray = field(default=None)
    leaf_lo: np.ndarray = field(default=None)      # DFS leaf range per node
    leaf_hi: np.ndarray = field(default=None)
    leaf_pts: np.ndarray = field(default=None)     # point idx by DFS leaf pos

    @property
    def num_nodes(self) -> int:
        return len(self.node_pt)

    def _build_csr(self):
        m = self.num_nodes
        order = np.argsort(self.node_parent[1:], kind="stable")
        kids = np.arange(1, m)[order]
        parents = self.node_parent[1:][order]
        counts = np.bincount(parents, minlength=m)
        self.child_start = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(counts, out=self.child_start[1:])
        self.child_list = kids.astype(np.int64)
        self._build_leaf_ranges()

    def _build_leaf_ranges(self):
        """DFS leaf ordering: each node owns a contiguous leaf range, so a
        fully-included ball (d + radius <= eps) emits its whole subtree as a
        range — no per-leaf distance work for dense graphs."""
        m = self.num_nodes
        self.leaf_lo = np.zeros(m, dtype=np.int64)
        self.leaf_hi = np.zeros(m, dtype=np.int64)
        leaf_pts = []
        stack = [(0, False)]
        while stack:
            v, post = stack.pop()
            if post:
                self.leaf_hi[v] = len(leaf_pts)
                continue
            self.leaf_lo[v] = len(leaf_pts)
            if self.is_leaf[v]:
                leaf_pts.append(self.node_pt[v])
                self.leaf_hi[v] = len(leaf_pts)
            else:
                stack.append((v, True))
                for c in self.children(v)[::-1]:
                    stack.append((c, False))
        self.leaf_pts = np.asarray(leaf_pts, dtype=np.int64)

    # -- invariant checks (used by property tests) -------------------------
    def check_invariants(self) -> None:
        pts, met = self.points, self.metric
        m = self.num_nodes
        assert self.node_parent[0] == _NEG
        # (i) nesting: every internal vertex has a child with the same point
        for v in range(m):
            if self.is_leaf[v]:
                continue
            kids = self.children(v)
            assert len(kids) > 0, f"internal node {v} without children"
            assert any(self.node_pt[k] == self.node_pt[v] for k in kids), (
                f"nesting violated at node {v}"
            )
            # (ii) covering: children within parent ball (radius, not 2^k —
            # vertex-triple radii per the paper's practical variant)
            cpts = pts[self.node_pt[kids]]
            me = np.broadcast_to(pts[self.node_pt[v]], cpts.shape)
            d = met.true(met.rowwise(cpts, me))
            assert np.all(d <= self.node_radius[v] + 1e-5), (
                f"covering violated at node {v}"
            )
            # (iii) separating: applies to SplitVertex centers (Alg. 1),
            # not to leaf-dumped members (Alg. 2 lines 10-12)
            skids = kids[self.from_split[kids]]
            upts = np.unique(self.node_pt[skids])
            if len(upts) > 1 and self.node_radius[v] > 0:
                dd = met.true(met.cdist(pts[upts], pts[upts]))
                iu = np.triu_indices(len(upts), 1)
                assert np.all(dd[iu] > self.node_radius[v] / 2 - 1e-5), (
                    f"separating violated at node {v}"
                )
        # every point appears in exactly one leaf
        leaf_pts = np.sort(self.node_pt[self.is_leaf])
        assert np.array_equal(leaf_pts, np.arange(len(pts))), "leaf coverage"

    def children(self, v: int) -> np.ndarray:
        return self.child_list[self.child_start[v] : self.child_start[v + 1]]

    # -- levelized view -----------------------------------------------------
    def flat(self):
        """The levelized structure-of-arrays view (``FlatCoverTree``) —
        built lazily once; the tree is immutable after ``_freeze``."""
        if getattr(self, "_flat", None) is None:
            from .flat_tree import flatten_covertree
            self._flat = flatten_covertree(self)
        return self._flat

    # -- batch query (Alg. 3, level-synchronous) ---------------------------
    def query(
        self, queries: np.ndarray, eps: float, stats=None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Find all tree points within ``eps`` of each query.

        Thin wrapper over the levelized traversal (``FlatCoverTree.
        query_host``): same float64 distances, full-inclusion leaf-range
        emission, and scale-relative expand slack as always — the flat
        tables are just the array layout both the host and the device
        traversals now share. Returns (q_idx, p_idx) arrays: point
        ``p_idx[k]`` is an ε-neighbor of ``queries[q_idx[k]]``. Pass a
        ``TraversalStats`` as ``stats`` to collect dists_evaluated /
        nodes_pruned counters.
        """
        if len(queries) == 0 or self.num_nodes == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return self.flat().query_host(queries, eps, stats=stats)


def build_covertree(
    points: np.ndarray,
    metric: str | HostMetric = "euclidean",
    leaf_size: int = 10,
    root: int = 0,
) -> CoverTree:
    """Batch construction (Alg. 1 + 2), vectorized across all hubs per level."""
    met = get_host_metric(metric) if isinstance(metric, str) else metric
    pts = np.asarray(points)
    n = len(pts)
    if n == 0:
        raise ValueError("empty point set")

    # tree arrays (grown in python lists, frozen at the end)
    node_pt = [root]
    node_radius = [0.0]
    node_parent = [_NEG]
    node_level = [0]
    is_leaf = [False]
    from_split = [True]

    # point state
    D = met.true(met.rowwise(pts, np.broadcast_to(pts[root], pts.shape)))
    D = np.asarray(D, np.float64)
    L = np.full(n, root, dtype=np.int64)          # closest center (point idx)
    hub_of = np.zeros(n, dtype=np.int64)          # active hub id per point

    # active hubs: parallel lists indexed by hub id
    hub_node = np.array([0], dtype=np.int64)      # tree vertex of hub root
    hub_root = np.array([root], dtype=np.int64)   # point idx of hub root
    hub_r = np.array([D.max()], dtype=np.float64)
    level = 0

    if n == 1:
        is_leaf[0] = True
        t = _freeze(pts, met, node_pt, node_radius, node_parent, node_level,
                    is_leaf, from_split)
        return t
    node_radius[0] = float(hub_r[0])

    while len(hub_node):
        nh = len(hub_node)
        level -= 1
        alive = np.flatnonzero(hub_of >= 0)           # points in active hubs
        # ---- Alg. 1: split every hub simultaneously -----------------------
        done = hub_r <= 0.0  # zero-radius hubs are pure duplicates: no split
        while not done.all():
            # segmented argmax of D per unfinished hub
            hmax = np.full(nh, -1.0)
            np.maximum.at(hmax, hub_of[alive], D[alive])
            newly_done = (~done) & (hmax <= hub_r / 2.0)
            done |= newly_done
            act = ~done
            if not act.any():
                break
            # pick, per unfinished hub, the first point achieving the max
            cand_a = act[hub_of[alive]] & (D[alive] >= hmax[hub_of[alive]])
            cidx = alive[cand_a]
            hubs_c, first = np.unique(hub_of[cidx], return_index=True)
            centers = cidx[first]                      # one per unfinished hub
            cen_of_hub = np.full(nh, _NEG, dtype=np.int64)
            cen_of_hub[hubs_c] = centers
            # batched distance update: every point in an unfinished hub vs its
            # hub's new center (one rowwise kernel call)
            pidx = alive[act[hub_of[alive]]]
            cpts = pts[cen_of_hub[hub_of[pidx]]]
            dnew = np.asarray(met.true(met.rowwise(pts[pidx], cpts)), np.float64)
            upd = dnew < D[pidx]
            D[pidx[upd]] = dnew[upd]
            L[pidx[upd]] = cen_of_hub[hub_of[pidx[upd]]]
            # the center itself: d=0 exactly
            D[centers] = 0.0
            L[centers] = centers

        # ---- Alg. 2: form child vertices & next level's hubs ---------------
        # group points by (hub, L); one child vertex per distinct center
        order = alive[np.lexsort((L[alive], hub_of[alive]))]
        oh, ol = hub_of[order], L[order]
        bound = np.ones(len(order), dtype=bool)
        bound[1:] = (oh[1:] != oh[:-1]) | (ol[1:] != ol[:-1])
        gstart = np.flatnonzero(bound)
        gend = np.append(gstart[1:], len(order))

        new_hub_node, new_hub_root, new_hub_r = [], [], []
        new_hub_of = np.full(n, _NEG, dtype=np.int64)
        for gs, ge in zip(gstart, gend):
            members = order[gs:ge]
            h = hub_of[members[0]]
            c = L[members[0]]
            radius = float(D[members].max())
            size = ge - gs
            vid = len(node_pt)
            node_pt.append(int(c))
            node_radius.append(radius)
            node_parent.append(int(hub_node[h]))
            node_level.append(level)
            from_split.append(True)
            if size == 1:
                is_leaf.append(True)
            elif size > leaf_size and radius > 0.0:
                is_leaf.append(False)
                hid = len(new_hub_node)
                new_hub_node.append(vid)
                new_hub_root.append(int(c))
                new_hub_r.append(radius)
                new_hub_of[members] = hid
            else:
                # small or all-duplicate group: emit every member (incl. the
                # nested center) as a leaf child of this vertex
                is_leaf.append(False)
                for p in members:
                    node_pt.append(int(p))
                    node_radius.append(0.0)
                    node_parent.append(vid)
                    node_level.append(level - 1)
                    is_leaf.append(True)
                    from_split.append(False)

        hub_node = np.asarray(new_hub_node, dtype=np.int64)
        hub_root = np.asarray(new_hub_root, dtype=np.int64)
        hub_r = np.asarray(new_hub_r, dtype=np.float64)
        hub_of = new_hub_of

    return _freeze(pts, met, node_pt, node_radius, node_parent, node_level,
                   is_leaf, from_split)


def _freeze(pts, met, node_pt, node_radius, node_parent, node_level, is_leaf,
            from_split):
    t = CoverTree(
        points=pts,
        metric=met,
        node_pt=np.asarray(node_pt, np.int64),
        node_radius=np.asarray(node_radius, np.float64),
        node_parent=np.asarray(node_parent, np.int64),
        node_level=np.asarray(node_level, np.int64),
        is_leaf=np.asarray(is_leaf, bool),
        from_split=np.asarray(from_split, bool),
    )
    t._build_csr()
    return t
