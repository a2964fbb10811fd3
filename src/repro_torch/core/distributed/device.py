"""The systolic ring (the paper's Algorithm 4), the landmark engine and
the delta traversal, over a mesh of ranks on one or more processes.

A ``RingMesh`` (``comm``) is ``size`` ranks over the ``world`` processes of
a ``torch.distributed`` group, each process owning a run of consecutive
ranks (``local_ranks``) on its device; ``RingMesh(size, device)`` puts
every rank in this process. ``_systolic_local`` is the per-rank body of
the reference's shard_map program, written once over state indexed by
rank (other processes' slots ``None``); the body loops over the local
ranks, and each ``ppermute`` is a ``comm.permute``, which moves a payload
in-process (reassigning a list slot) or to another process (NCCL on the
card, gloo through host memory). The rounds run in round-major order
(every local rank's round r before any rank's round r + 1), so the
symmetric halving, the even-ring boundary round, the mirror accumulator
riding one hop behind its block, and its final shift home are the
reference's own; round r + 1's hop is issued before round r evaluates,
and waited on just before its first read.

Each evaluated ring round runs the fused bitmask tile
(``repro_torch.kernels.ops.nng_tile_bits``) once forward and once for the
mirror; neighbour ids come out of the bitmask epilogue
(``ops.bits_to_ids``). Only the packed hit words and exact counts reach
device memory, never the fp32 distance tile.

Block-summary pruning: each rank's block is summarized as a center and a
radius once up front (one all-gather of the summaries); a round whose
partner block satisfies d(c_me, c_p) > r_me + r_p + eps cannot hold an
ε-pair, so it is skipped.

The landmark engine (Algorithms 5+6, ``landmark_run``) runs on the same
mesh: Voronoi cells over sampled centres, coalesced onto ranks by the
capacity-padded tiled all-to-all (``comm.all_to_all``), and Lemma-1
ε-ghosts either exchanged the same way as copies (``ghost_mode="coll"``)
or found by rotating each rank's compacted block around the ring with its
ghost test as packed cell words (``"ring"``, ``_ghost_ring``). The
cell-sorted queries run through the grouped tile
(``ops.nng_tile_bits_grouped``) and the ghost tile
(``ops.nng_tile_bits_ghost``), or traverse per-cell cover forests
(``traversal="tree"``). Its capacities come from ``plan_landmark_device``,
one counting pass over the ranks and an all-gather of the counts.

The tree flavour (``traversal="tree"``) runs the same ring with each rank's
levelized cover tree (``DeviceForest``): a ring round runs two
level-synchronous traversals (``tree_traverse``, through the
``tree_frontier`` and ``leaf_range_pack`` kernels) instead of two dense
tiles, so the triangle-inequality prune fires inside every round.
``_systolic_local_tree`` is the serial schedule and
``_systolic_local_tree_split`` the double-buffered one, whose rounds rotate
either the forest tables or the raw points as ``plan_ring_schedule``
decides. Each block travels in its own forest's DFS order
(``dfs_row_order``), so the queries of a frontier tile share subtrees and
most tiles hold no active pair; the outputs return in the caller's order.
A forest travels as its builder tables; the receiver derives its child
ranges again.

Every process is handed the whole input, as the reference's single
controller is, and slices its own ranks' blocks. The engines return the
local ranks' neighbour rows and every rank's counters and overflow flags
(all-gathered, so every process reads the same values).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.distributed import comm
from repro_torch.core.distributed.comm import RingMesh
from repro_torch.core.distributed.comm import \
    local_all_to_all as _all_to_all  # noqa: F401 (the in-process forms)
from repro_torch.core.distributed.comm import \
    ring_permute as _ring_permute  # noqa: F401
from repro_torch.core.metrics import get_metric
from repro_torch.kernels.bits_epilogue import SENTINEL
from repro_torch.kernels.nng_tile import (_BIT, pack_words, popcount32,
                                          unpack_words)
from repro_torch.kernels.ops import bits_to_gathered_ids as _bits_to_gathered_ids
from repro_torch.kernels.ops import bits_to_ids as _bits_to_ids
from repro_torch.kernels.ops import leaf_range_pack as _leaf_range_pack
from repro_torch.kernels.ops import (nng_tile_bits, nng_tile_bits_ghost,
                                     nng_tile_bits_grouped,
                                     nng_tile_bits_pair, nng_tile_geometry,
                                     tree_frontier_step)


def tile_cdist(x, y, metric):
    """Comparable distances between tiles — the registered metric's device
    ``cdist`` (sq-L2 fp32 for euclidean, counts for hamming, |diff| sums
    for manhattan, whatever a user metric declares)."""
    return get_metric(metric).cdist(x, y)


def _merge_ids(buf, new_ids):
    """Merge two per-row sorted id sets, keeping the K smallest (dedup-free:
    ids are globally unique per source)."""
    k = buf.shape[-1]
    return torch.sort(torch.cat([buf, new_ids], dim=-1), dim=-1).values[:, :k]


class DeviceForest(NamedTuple):
    """One rank's levelized cover-tree tables on the device (or, with a
    leading rank axis, every rank's: ``flat_tree.stack_device_forests`` and
    ``flat_tree_device.build_block_forests_device`` give that dict).

    Shapes (one rank): coords (L, N, d); radius / cell / leaf / parent /
    leaf_lo / leaf_hi (L, N); leaf_ids (n_leaf,) global point ids in forest
    DFS order, SENTINEL-padded. N and n_leaf are multiples of 32.
    child_lo / child_hi (L, N) are each node's child slot range in level
    l + 1, which ``from_tables`` derives once from the parent slots. They
    are not among the builders' tables, and ``ring_forest`` counts only
    those.
    """

    coords: torch.Tensor
    radius: torch.Tensor
    cell: torch.Tensor
    leaf: torch.Tensor
    parent: torch.Tensor
    leaf_lo: torch.Tensor
    leaf_hi: torch.Tensor
    leaf_ids: torch.Tensor
    child_lo: torch.Tensor
    child_hi: torch.Tensor

    @classmethod
    def from_tables(cls, tables: dict, device=None) -> "DeviceForest":
        """One rank's or every rank's (leading axis) builder tables."""
        t = {k: torch.as_tensor(tables[k], device=device)
             for k in cls._fields[:-2]}
        if t["radius"].dim() == 2:
            t["child_lo"], t["child_hi"] = _child_ranges(t["cell"],
                                                         t["parent"])
        else:
            lo, hi = zip(*(_child_ranges(c, p)
                           for c, p in zip(t["cell"], t["parent"])))
            t["child_lo"], t["child_hi"] = torch.stack(lo), torch.stack(hi)
        return cls(**t)

    def rank(self, r: int) -> "DeviceForest":
        """Rank r's forest out of a rank-stacked one."""
        return DeviceForest(*(a[r] for a in self))


# Device bytes of a pass's temporaries per query row besides its int32
# delta table (4 B a leaf slot), fitted to max_memory_allocated less the
# delta table and the results on one NVIDIA H100 80GB HBM3 (chip_smoke.py
# [6f]: 16384 Gaussian queries against levels of 16384 nodes; [6a] checks
# the model at the smoke forest's 120960). A dense level's active mask
# (the unpacked parent bits, the gathered mask, its packing) peaked at
# 2.26 B a row and node in the shipped passes; every level dense, the
# leaf-range emission (an unpacked _NODE_CHUNK of nodes and its int32
# copy) peaked at 6.21 B a row and node in passes of 4096 rows; per-query
# scopes added 0.88 B. The model charges the mask and the emission both,
# each rounded up. (The 9.1 B a row and node measured before were mostly
# an int64 copy of the mask for its bool sum.)
_MASK_BYTES_PER_NODE = 3
_EMIT_BYTES_PER_NODE = 7
_SCOPE_BYTES_PER_NODE = 1
TRAVERSE_BUDGET = 8 << 30
# A level's masks are walked as (row, node) pair lists while the pairs
# (bounded by 32 per nonzero word) stay within 1/SPARSE_DIV of the pass's
# (rows × nodes) grid, else densely. The list costs up to about 64 bytes a
# pair (int64 rows, nodes, child ranges and scatter indices), so this
# bound keeps it near 4 bytes per grid cell, inside the model above, and
# a level whose active pairs are many goes densely (chip_smoke.py [6f]
# drives one and prints both paths' peaks).
SPARSE_DIV = 16
_NODE_CHUNK = 1 << 14        # node columns per dense emission step


def traverse_pass_bytes(rows: int, n_nodes: int, n_leaf: int,
                        scoped: bool = False) -> int:
    """The device bytes a pass of ``rows`` queries over levels of
    ``n_nodes`` slots allocates above what was resident: the (rows,
    n_leaf + 1) int32 delta table and the level temporaries, with
    ``scoped`` the per-query scopes' too (the results the traversal keeps
    are not counted)."""
    level = ((_MASK_BYTES_PER_NODE + (_SCOPE_BYTES_PER_NODE if scoped
                                      else 0)) * n_nodes
             + _EMIT_BYTES_PER_NODE * min(n_nodes, _NODE_CHUNK))
    return rows * (4 * (n_leaf + 1) + level)


def traverse_q_chunk(n_nodes: int, n_leaf: int,
                     budget: int = TRAVERSE_BUDGET,
                     scoped: bool = False) -> int:
    """Query rows per pass of ``tree_traverse``: the most whose
    ``traverse_pass_bytes`` stay under ``budget``, in multiples of 1024
    (128 below that)."""
    c = max(budget // traverse_pass_bytes(1, n_nodes, n_leaf, scoped), 128)
    return c - c % 1024 if c >= 1024 else c - c % 128


def pair_limit(rows: int, nodes: int) -> int:
    """The most (row, node) pairs a pass of ``rows`` queries over a level
    of ``nodes`` slots walks as a list; past it the level goes densely."""
    return rows * nodes // SPARSE_DIV


def _popcount(words):
    """Set bits of int32 words, summed -> int64 0-d tensor."""
    return popcount32(words).sum()


def _set_bits(words, limit: int):
    """(rows, cols) int64 of every set bit of (m, W) int32 words, or None
    when the nonzero words could hold more than ``limit`` set bits."""
    r, w = words.nonzero(as_tuple=True)
    if 32 * r.numel() > limit:
        return None
    k, b = unpack_words(words[r, w][:, None]).nonzero(as_tuple=True)
    return r[k], w[k] * 32 + b


def _words_from_pairs(rows, cols, keep, m: int, nw: int):
    """Packed (m, nw) int32 words with bit (rows[i], cols[i]) set where
    ``keep[i]``; each (row, col) pair appears at most once, so adding the
    bits' values is their OR. Bit 31 adds -2^31 and the others add their
    positive values, so every partial sum stays in int32's range."""
    val = torch.where(keep, torch.ones_like(cols) << (cols % 32), 0)
    val = (val - ((val >> 31) << 32)).to(torch.int32)
    acc = torch.zeros(m * nw, dtype=torch.int32, device=rows.device)
    acc.index_put_((rows * nw + cols // 32,), val, accumulate=True)
    return acc.view(m, nw)


def _child_ranges(cell, parent):
    """Per level l < L - 1 of one rank's (L, N) cell and parent tables, the
    slot range [lo, hi) from each node's first valid child to its last in
    level l + 1; a node without valid children gets [0, 0). The forest
    builds emit a level's slots in parent order, so there a range holds the
    node's children alone, and invalid slots (cell PAD) that online
    deletes leave. Host inserts (``FlatCoverTree.insert_host``) keep the
    reference's superset ranges and may put a child after another
    parent's children, so a range may also span other nodes' children:
    users of the ranges test validity and the parent slot.
    -> (lo, hi) (L, N) int32."""
    L, N = cell.shape
    lo = torch.zeros((L, N), dtype=torch.int32, device=cell.device)
    hi = torch.zeros_like(lo)
    for lvl in range(1, L):
        slots = (cell[lvl] >= 0).nonzero()[:, 0]
        par = parent[lvl][slots].long()
        first = torch.full((N,), N, dtype=torch.long, device=cell.device)
        last = torch.full((N,), -1, dtype=torch.long, device=cell.device)
        first.scatter_reduce_(0, par, slots, reduce="amin")
        last.scatter_reduce_(0, par, slots, reduce="amax")
        has = last >= 0
        lo[lvl - 1] = torch.where(has, first, 0).to(torch.int32)
        hi[lvl - 1] = torch.where(has, last + 1, 0).to(torch.int32)
    return lo, hi


def _child_pairs(prev, lo_tab, hi_tab, limit: int):
    """The (row, slot) pairs under every expanded (row, node) pair of
    ``prev`` (packed expand words; node v's children lie in the slots
    [lo_tab[v], hi_tab[v])), the expanded node of each pair (a slot is
    v's child iff its parent slot is v) and the count of expanded pairs,
    or None when either list could hold more than ``limit`` pairs."""
    pairs = _set_bits(prev, limit)
    if pairs is None:
        return None
    er, ep = pairs
    lo = lo_tab[ep]
    n_ch = hi_tab[ep] - lo
    total = int(n_ch.sum())
    if total > limit:
        return None
    rows = er.repeat_interleave(n_ch, output_size=total)
    start = torch.cumsum(n_ch, 0) - n_ch
    node = (lo - start).repeat_interleave(n_ch, output_size=total) \
        + torch.arange(total, device=prev.device)
    return rows, node, ep.repeat_interleave(n_ch, output_size=total), \
        er.numel()


def tree_traverse(qp, qids, qcells, forest: DeviceForest, eps, k_cap: int,
                  metric, qghost_bits=None, q_chunk: int | None = None):
    """Level-synchronous batched cover-tree traversal on the device.

    The queries are walked in passes of ``q_chunk`` rows (default
    ``traverse_q_chunk``: the reference's all-queries-at-once tables do not
    fit on a card at paper scale); each pass loops over the forest's
    levels. Each level:

      1. active mask: a node is active for a query iff its parent's expand
         bit survived the previous level, the slot is valid, and the node's
         cell matches the query's cell (``qcells``, one per query: the
         landmark engine's W and G rows come from many cells in one pass).
         With ``qghost_bits`` (the ghost ring: (nq, ceil(m/32)) int32
         words of each query's Lemma-1 ghost cells, the ``pack_words``
         layout) a node is in scope iff its cell's bit is set, and
         ``qcells`` is ignored. While the expanded pairs are few, the mask
         is set from the list of (query, child) pairs (each expanded
         node's children are one slot range; the roots, one per tree,
         pair with every query); else it is gathered densely through the
         parent slots. Both give the same words;
      2. frontier kernel (``ops.tree_frontier_step``): fused distance and
         {emit, expand} decisions as packed words; tiles with no active
         pair skip their distances (rows that share subtrees, as the
         ring's DFS order gives, leave most tiles without one);
      3. leaf-range emission: each emitted node adds +1 at its DFS leaf
         range's start and -1 at its end in the pass's (c, n_leaf + 1)
         int32 delta table (exact integer scatters) — no per-leaf distances
         for fully-included balls.

    ``leaf_range_pack`` then turns the deltas into the cover mask (self
    pairs excluded by global id) and ``bits_to_gathered_ids`` into ids.

    Returns (nbrs (nq, k_cap) sorted SENTINEL-padded ids, cnt (nq,) exact
    counts, dists_evaluated, nodes_pruned) — the counters are int64 0-d
    tensors, exact at any scale: frontier pairs whose distance was
    computed, and frontier pairs whose subtree was discarded after that
    single distance. Chunking changes none of the four.
    """
    nq = qp.shape[0]
    dev = qp.device
    L, N = forest.radius.shape
    nw = N // 32
    n_leaf = forest.leaf_ids.shape[0]
    assert N % 32 == 0 and n_leaf % 32 == 0, (N, n_leaf)
    qids = torch.as_tensor(qids, dtype=torch.int32, device=dev)
    ghost = qghost_bits is not None
    if ghost:
        qghost_bits = torch.as_tensor(qghost_bits, dtype=torch.int32,
                                      device=dev)
    else:
        qcells = torch.as_tensor(qcells, dtype=torch.int32, device=dev)
    # per-query scopes cost a pass more: any query whose cell differs from
    # the first's, or ghost words, give the passes their own scope rows
    scoped = ghost or (nq > 0 and bool((qcells != qcells[0]).any()))
    c = int(q_chunk or traverse_q_chunk(N, n_leaf, scoped=scoped))
    child_lo = forest.child_lo.long()
    child_hi = forest.child_hi.long()
    parent = forest.parent.long()
    leaf_lo = forest.leaf_lo.long()
    leaf_hi = forest.leaf_hi.long()
    valid = forest.cell >= 0
    cell_c = forest.cell.long().clamp_min(0)   # ghost bit of each slot
    # the valid root slots: one per tree of the forest, so few; a pass
    # whose queries have their own scopes tests them as a pair list
    roots = valid[0].nonzero()[:, 0]
    acts = torch.zeros((), dtype=torch.int64, device=dev)
    outs = torch.zeros((), dtype=torch.int64, device=dev)   # emit + expand
    nbrs, cnt = [], []
    for s in range(0, nq, c):
        q = qp[s:s + c]
        m = q.shape[0]
        limit = pair_limit(m, N)
        if ghost:
            gb = unpack_words(qghost_bits[s:s + c])     # (m, 32 mw) bool
            shared = False
        else:
            qc = qcells[s:s + c]
            # one scope row when every query of the pass shares its cell
            # (the ring's block forests), else one per query
            shared = bool((qc == qc[0]).all())
            if shared:
                qc = qc[:1]

        def scope(lvl):
            """(1 or m, N) bool: the slots of level lvl in each query's
            scope."""
            if ghost:
                return valid[lvl][None, :] & gb[:, cell_c[lvl]]
            return valid[lvl][None, :] & (forest.cell[lvl][None, :]
                                          == qc[:, None])

        def pair_scope(lvl, rows, node):
            """Whether valid slot node[i] of level lvl is in the scope of
            query rows[i]."""
            if ghost:
                return gb[rows, cell_c[lvl][node]]
            return forest.cell[lvl][node] == (qc[0] if shared else qc[rows])

        delta = torch.zeros((m, n_leaf + 1), dtype=torch.int32, device=dev)
        prev = None
        for lvl in range(L):
            act = None
            if prev is None:                       # the roots
                if shared:
                    sc = scope(lvl)
                    act = pack_words(sc).expand(m, nw).contiguous()
                    acts += sc.sum() * m
                    del sc
                elif m * roots.numel() <= limit:
                    rows = torch.arange(m, device=dev).repeat_interleave(
                        roots.numel())
                    node = roots.repeat(m)
                    keep = pair_scope(lvl, rows, node)
                    acts += keep.sum()
                    act = _words_from_pairs(rows, node, keep, m, nw)
            else:
                pairs = _child_pairs(prev, child_lo[lvl - 1],
                                     child_hi[lvl - 1], limit)
                if pairs is None:
                    outs += _popcount(prev)
                else:
                    rows, node, par, n_exp = pairs
                    outs += n_exp
                    keep = (valid[lvl][node] & (parent[lvl][node] == par)
                            & pair_scope(lvl, rows, node))
                    acts += keep.sum()
                    act = _words_from_pairs(rows, node, keep, m, nw)
            if act is None:
                if prev is None:
                    prev = torch.full((m, nw), -1, dtype=torch.int32,
                                      device=dev)
                active = unpack_words(prev)[:, parent[lvl]]
                active &= scope(lvl)
                act = pack_words(active)
                # counted from the packed words: a bool sum would first
                # copy the mask to int64, 8 bytes a row and node
                acts += _popcount(act)
                del active
            emit, prev = tree_frontier_step(
                q, forest.coords[lvl], forest.radius[lvl], forest.leaf[lvl],
                act, eps, metric)
            del act
            pairs = _set_bits(emit, limit)
            if pairs is not None:
                rows, node = pairs
                outs += rows.numel()
                one = torch.ones_like(rows, dtype=torch.int32)
                delta.index_put_((rows, leaf_lo[lvl][node]), one,
                                 accumulate=True)
                delta.index_put_((rows, leaf_hi[lvl][node]), -one,
                                 accumulate=True)
            else:
                outs += _popcount(emit)
                for c0 in range(0, N, _NODE_CHUNK):
                    e = unpack_words(emit[:, c0 // 32:(c0 + _NODE_CHUNK) // 32])
                    e = e.to(torch.int32)
                    delta.index_add_(1, leaf_lo[lvl][c0:c0 + e.shape[1]], e)
                    delta.index_add_(1, leaf_hi[lvl][c0:c0 + e.shape[1]], e,
                                     alpha=-1)
        pairs = _set_bits(prev, limit)       # the last level's expand bits
        outs += _popcount(prev) if pairs is None else pairs[0].numel()
        ccnt, bits = _leaf_range_pack(delta, forest.leaf_ids, qids[s:s + c])
        del delta
        nbrs.append(_bits_to_gathered_ids(bits, forest.leaf_ids, k_cap))
        cnt.append(ccnt)
    if not nbrs:
        nbrs = [torch.full((0, k_cap), SENTINEL, dtype=torch.int32,
                           device=dev)]
        cnt = [torch.zeros(0, dtype=torch.int32, device=dev)]
    return torch.cat(nbrs), torch.cat(cnt), acts, acts - outs


def _round_skip_flags(xs, partner, eps, *, mesh, metric, prune):
    """Per-rank, per-round prune decisions from the block summary table.

    ``xs`` holds the local ranks' blocks; the table of every rank's
    summary is one all-gather of the local ranks' (the ``ring_summary``
    channel). ``partner`` (nranks, rounds + 1) is the block each rank
    meets in each round. skip[me, r] is True when no point of my block can
    be within eps of any point of the partner block: d(c_me, c_p) > r_me +
    r_p + eps. Float-metric center distances are fp32, so the bound
    carries a small relative slack — under-pruning is always safe,
    over-pruning never is. Every process computes the whole table."""
    nranks, nrounds = partner.shape
    if not prune:
        return torch.zeros((nranks, nrounds), dtype=torch.bool)
    met = get_metric(metric)
    summ = [met.summary(xs[me]) for me in mesh.local_ranks]
    call = comm.all_gather(mesh, torch.stack([c for c, _ in summ]),
                           channel="ring_summary")          # (nranks, d)
    radall = comm.all_gather(mesh, torch.stack([r for _, r in summ]),
                             channel="ring_summary")        # (nranks,)
    skip = torch.zeros((nranks, nrounds), dtype=torch.bool)
    for me in range(nranks):
        p = torch.as_tensor(partner[me], device=call.device)
        dc = met.summary_dist(call[p], call[me])
        bound = radall[me] + radall[p] + eps
        if not met.exact:
            bound = bound * (1.0 + 1e-5) + 1e-6
        skip[me] = (dc > bound).cpu()
    skip[:, 0] = False                                 # self tile never skipped
    return skip


def _eval_schedule(xs, mesh, eps, *, metric, prune):
    """Which rounds each rank evaluates: (do_eval [me][r] bools for rounds
    r = 0..nranks // 2, tiles_skipped (nranks,) f32), for every rank. The
    boundary round of an even ring is scheduled on the lower rank of each
    pair only, and the block-summary prune skips rounds whose blocks hold
    no ε-pair."""
    nranks = mesh.size
    rounds = nranks // 2
    rr = np.arange(rounds + 1)
    partner = (np.arange(nranks)[:, None] + rr[None, :]) % nranks
    skip = _round_skip_flags(xs, partner, eps, mesh=mesh, metric=metric,
                             prune=prune)
    sched = torch.ones((nranks, rounds + 1), dtype=torch.bool)
    if nranks % 2 == 0 and rounds > 0:
        sched[:, rounds] = torch.from_numpy(
            np.arange(nranks) < partner[:, rounds])
    return (sched & ~skip).tolist(), (sched & skip).to(torch.float32).sum(1)


def _local_list(mesh, make) -> list:
    """A per-rank list: ``make(me)`` in the local ranks' slots, None in the
    other processes'."""
    out = [None] * mesh.size
    for me in mesh.local_ranks:
        out[me] = make(me)
    return out


def _gathered(mesh, vals, dtype) -> torch.Tensor:
    """Every rank's value, from the local ranks' ``vals[me]`` (0-d tensors
    or numbers) -> (nranks,) ``dtype`` on every process."""
    local = torch.stack([torch.as_tensor(vals[me], device=mesh.device)
                         .to(dtype) for me in mesh.local_ranks])
    return comm.all_gather(mesh, local, channel=comm.CONTROL)


def _systolic_local(xs, *, mesh, eps, metric, k_cap, prune, overlap=True):
    """The per-rank body over the local ranks. ``xs[me]`` (n_loc, d) is
    rank me's block; block-contiguous global ids mean a visiting block is
    fully described by its first id ``me * n_loc``, which travels with it
    as an int32 scalar.

    Symmetry halving (paper §IV-C): each (local × visiting) tile emits
    BOTH edge directions — the visiting block carries its own neighbour
    accumulator around the ring and one final permute sends it home. Tiles
    evaluated: nranks // 2 + 1 rounds instead of nranks; in the boundary
    round of an even ring only the lower rank of each pair evaluates.

    ``overlap=True`` is the reference's double-buffered schedule: a priming
    hop is issued before the self tile, then each round issues the hop
    that feeds round r + 1 before it evaluates round r (waited on at the
    start of round r + 1), and the mirror accumulator rides one hop behind
    its block. ``overlap=False`` is the strict rotate-then-evaluate
    schedule. Both give the same graph; they differ in the hops they make
    (one priming hop), which ``comm_bytes`` counts. A round that no local
    rank evaluates still makes its hops.

    Returns (nbrs (n_local, k_cap) int32 SENTINEL-padded and cnt
    (n_local,) int32 exact, the local ranks' rows in rank order; overflow
    (nranks,) bool, tiles_skipped (nranks,) f32, dists_evaluated (nranks,)
    f32, nodes_pruned (nranks,) f32, every rank's)."""
    nranks = mesh.size
    loc = mesh.local_ranks
    n_loc = xs[loc[0]].shape[0]
    dev = mesh.device
    perm = [(i, (i - 1) % nranks) for i in range(nranks)]
    rounds = nranks // 2
    do_eval, tiles_skipped = _eval_schedule(xs, mesh, eps, metric=metric,
                                            prune=prune)
    # float32 counters (the RunStats normalization): int32 wraps at paper
    # scale, fp32 is exact below 2^24 and approximate beyond
    dists = (torch.tensor(do_eval, dtype=torch.float32).sum(1)
             * torch.tensor(float(n_loc) * float(n_loc), dtype=torch.float32))

    ones = torch.ones(n_loc, dtype=torch.int32, device=dev)

    def tile_bits(a, b):
        return nng_tile_bits(a, b, ones, eps, metric=metric)

    id0 = _local_list(mesh, lambda me: torch.tensor(
        me * n_loc, dtype=torch.int32, device=dev))

    def eval_pair(me, y, yid0, nbrs_, cnt_, ynbrs_, ycnt_):
        # forward (visiting points near my rows) then mirror (my points near
        # the visiting rows), one tile alive at a time
        fc, fb = tile_bits(xs[me], y)
        cnt_ = cnt_ + fc
        nbrs_ = _merge_ids(nbrs_, _bits_to_ids(fb, yid0, k_cap))
        del fb
        rc, rb = tile_bits(y, xs[me])
        ycnt_ = ycnt_ + rc
        ynbrs_ = _merge_ids(ynbrs_, _bits_to_ids(rb, id0[me], k_cap))
        return nbrs_, cnt_, ynbrs_, ycnt_

    def hop(blocks):
        return comm.permute(mesh, blocks, perm, channel="ring_points")

    nbrs0 = torch.full((n_loc, k_cap), SENTINEL, dtype=torch.int32, device=dev)
    cnt0 = torch.zeros(n_loc, dtype=torch.int32, device=dev)
    # each visiting block travels with its first id
    ys = _local_list(mesh, lambda me: (xs[me], id0[me]))
    if overlap and rounds > 0:
        # prime the pipeline: hop 1 in flight while the self tile runs below
        pend = hop(ys)

    # self tile (round 0): clear the diagonal bit (row i, column i) and take
    # it off the row's count — structurally excludes self pairs even when
    # fp32 rounding pushes d(x, x) past eps
    rows = torch.arange(n_loc, device=dev)
    wsel = rows // 32
    bit = _BIT.to(dev)[rows % 32]
    nbrs, cnt = [None] * nranks, [None] * nranks
    for me in loc:
        c_self, bits0 = tile_bits(xs[me], xs[me])
        diag = bits0[rows, wsel] & bit
        bits0[rows, wsel] ^= diag
        cnt[me] = c_self - (diag != 0).to(torch.int32)
        nbrs[me] = _merge_ids(nbrs0, _bits_to_ids(bits0, id0[me], k_cap))
        del bits0

    if rounds > 0:
        ymir = _local_list(mesh, lambda me: (nbrs0, cnt0))
        for r in range(1, rounds + 1):
            if overlap:
                # round r's block arrived; hop r + 1 is issued before round
                # r evaluates
                ys = pend.wait()
                pend = hop(ys)
            else:
                ys = hop(ys).wait()
            ymir = comm.permute(mesh, ymir, perm,
                                channel="ring_mirror").wait()
            for me in loc:
                if do_eval[me][r]:
                    nbrs[me], cnt[me], yn, yc = eval_pair(
                        me, *ys[me], nbrs[me], cnt[me], *ymir[me])
                    ymir[me] = (yn, yc)
        if overlap:
            pend.wait()                 # the last hop, made as the reference's
        nbrs, cnt = _return_mirror(nbrs, cnt, ymir, mesh)
    overflow = _gathered(mesh, [None if c is None else (c > k_cap).any()
                                for c in cnt], torch.bool)
    return (torch.cat([nbrs[me] for me in loc]),
            torch.cat([cnt[me] for me in loc]), overflow, tiles_skipped,
            dists, torch.zeros(nranks, dtype=torch.float32))


def dfs_row_order(forest: DeviceForest, id0: int) -> torch.Tensor:
    """A block's rows in its own forest's DFS order: ``forest.leaf_ids``'
    valid entries less the block's first global id ``id0`` -> (n_loc,)
    int64, a permutation of the block's rows (every point is one leaf).
    Rows next to each other in it share subtrees, so the query rows of a
    frontier tile meet few of a level's node tiles."""
    lid = forest.leaf_ids
    return lid[lid != SENTINEL].long() - id0


def _dfs_blocks(xs, forests, mesh):
    """Each local rank's block and its global ids in its forest's DFS
    order, and the orders: (rows, ids, orders), per-rank lists. The ring
    carries these rows and ids in place of the caller's, and
    ``_tree_outputs`` restores the caller's order once at the end."""
    n_loc = xs[mesh.local_ranks[0]].shape[0]
    orders = _local_list(mesh, lambda me: dfs_row_order(forests[me],
                                                        me * n_loc))
    rows = _local_list(mesh, lambda me: xs[me][orders[me]])
    ids = _local_list(mesh, lambda me: (orders[me] + me * n_loc)
                      .to(torch.int32))
    return rows, ids, orders


_N_TABLES = len(DeviceForest._fields) - 2      # the builder tables


class _ForestHop:
    """A permute of forests in flight: their builder tables travel (the
    ``ring_forest`` channel, as the reference's do), and a forest that
    arrives from another process derives its child ranges again."""

    def __init__(self, mesh, forests, perm):
        self._mesh, self._forests, self._perm = mesh, forests, perm
        self._pend = comm.permute(
            mesh, [None if f is None else tuple(f[:_N_TABLES])
                   for f in forests], perm, channel="ring_forest")

    def wait(self) -> list:
        moved = self._pend.wait()
        mesh, out = self._mesh, [None] * self._mesh.size
        for src, dst in self._perm:
            if mesh.owner(dst) != mesh.rank:
                continue
            out[dst] = (self._forests[src] if mesh.owner(src) == mesh.rank
                        else DeviceForest.from_tables(dict(zip(
                            DeviceForest._fields, moved[dst]))))
        return out


def _systolic_local_tree(xs, forests, *, mesh, eps, metric, k_cap, prune):
    """The per-rank body, cover-tree flavour, SERIAL schedule
    (``overlap=False``; ``_systolic_local_tree_split`` is the
    double-buffered production body).

    ``forests[me]`` is rank me's block tree. It rotates around the ring
    with its block: each evaluated round runs two traversals instead of two
    dense tiles — my points query the visiting block's tree (forward edges)
    and the visiting points query my tree (the mirror accumulator) — so the
    in-tree triangle prune fires inside every round. The block-summary
    prune still skips whole rounds above it. Every hop is made before its
    round evaluates. Each block travels in its forest's DFS order
    (``_dfs_blocks``; the block summaries are taken in the caller's).
    Returns what ``_systolic_local`` returns."""
    nranks = mesh.size
    loc = mesh.local_ranks
    n_loc = xs[loc[0]].shape[0]
    dev = mesh.device
    perm = [(i, (i - 1) % nranks) for i in range(nranks)]
    rounds = nranks // 2
    qcells = torch.zeros(n_loc, dtype=torch.int32, device=dev)
    do_eval, tiles_skipped = _eval_schedule(xs, mesh, eps, metric=metric,
                                            prune=prune)
    xs, ids, orders = _dfs_blocks(xs, forests, mesh)

    def trav(qp, qids, fr):
        return tree_traverse(qp, qids, qcells, fr, eps, k_cap, metric)

    # round 0 (self tile): one traversal of my own tree; the global-id test
    # inside tree_traverse excludes self pairs structurally
    nbrs, cnt, dists, pruned = ([None] * nranks for _ in range(4))
    for me in loc:
        nbrs[me], cnt[me], dists[me], pruned[me] = trav(xs[me], ids[me],
                                                        forests[me])
    if rounds > 0:
        nbrs0 = torch.full((n_loc, k_cap), SENTINEL, dtype=torch.int32,
                           device=dev)
        cnt0 = torch.zeros(n_loc, dtype=torch.int32, device=dev)
        ys = _local_list(mesh, lambda me: (xs[me], ids[me]))
        yforests = list(forests)
        ymir = _local_list(mesh, lambda me: (nbrs0, cnt0))
        for r in range(1, rounds + 1):
            pts_hop = comm.permute(mesh, ys, perm, channel="ring_points")
            forest_hop = _ForestHop(mesh, yforests, perm)
            mir_hop = comm.permute(mesh, ymir, perm, channel="ring_mirror")
            ys, yforests, ymir = (pts_hop.wait(), forest_hop.wait(),
                                  mir_hop.wait())
            for me in loc:
                if not do_eval[me][r]:
                    continue
                fn, fc, fd, fp = trav(xs[me], ids[me], yforests[me])
                rn, rc, rd, rp = trav(*ys[me], forests[me])
                nbrs[me] = _merge_ids(nbrs[me], fn)
                cnt[me] = cnt[me] + fc
                ymir[me] = (_merge_ids(ymir[me][0], rn), ymir[me][1] + rc)
                dists[me] = dists[me] + fd + rd
                pruned[me] = pruned[me] + fp + rp
        nbrs, cnt = _return_mirror(nbrs, cnt, ymir, mesh)
    return _tree_outputs(nbrs, cnt, orders, k_cap, tiles_skipped, dists,
                         pruned, mesh)


def _systolic_local_tree_split(xs, forests, *, mesh, eps, metric, k_cap,
                               prune, ring_modes):
    """The per-rank body, tree flavour: the double-buffered ring with the
    SPLIT schedule (``overlap=True``, the production tree body).

    ``ring_modes[r - 1]`` selects what round r rotates; it is planned once
    (``plan_ring_schedule``) and is the same on every rank, because a hop is
    a collective step that every rank makes alike:

    - ``"forest"``: the visiting block's forest tables jump to their round-r
      position in ONE permute (a multi-hop shift, to a rank that need not
      be a neighbour, when the rounds between rotated points only, so
      skipped rounds never pay forest bytes) and the forward direction
      traverses them.
    - ``"points"``: only the raw point block and its ids rotate, and an
      evaluated round runs the dense tile pair (``nng_tile_bits_pair``).

    Round r + 1's hops are issued before round r evaluates, as in the tiles
    flavour, and waited on at the start of round r + 1. The mirror
    traversal always queries the LOCAL forest, so only the forward
    direction needs the rotated tables. The mode moves bytes and work,
    never edges: tiles and traversal emit the same edge set. Blocks travel
    in their forests' DFS order, as in the serial body."""
    nranks = mesh.size
    loc = mesh.local_ranks
    n_loc = xs[loc[0]].shape[0]
    dev = mesh.device
    perm = [(i, (i - 1) % nranks) for i in range(nranks)]
    rounds = nranks // 2
    assert len(ring_modes) == rounds, (ring_modes, rounds)
    qcells = torch.zeros(n_loc, dtype=torch.int32, device=dev)
    do_eval, tiles_skipped = _eval_schedule(xs, mesh, eps, metric=metric,
                                            prune=prune)
    xs, ids, orders = _dfs_blocks(xs, forests, mesh)

    def trav(qp, qids, fr):
        return tree_traverse(qp, qids, qcells, fr, eps, k_cap, metric)

    if rounds > 0:
        # prime round 1's payloads; the round-0 self traversals overlap them
        pts_hop = comm.permute(mesh, _local_list(mesh, lambda me: (
            xs[me], ids[me])), perm, channel="ring_points")
        vforests, vpos, forest_hop = list(forests), 0, None
        if ring_modes[0] == "forest":
            forest_hop, vpos = _ForestHop(mesh, vforests, perm), 1
    nbrs, cnt, dists, pruned = ([None] * nranks for _ in range(4))
    for me in loc:
        nbrs[me], cnt[me], dists[me], pruned[me] = trav(xs[me], ids[me],
                                                        forests[me])
    if rounds > 0:
        nbrs0 = torch.full((n_loc, k_cap), SENTINEL, dtype=torch.int32,
                           device=dev)
        cnt0 = torch.zeros(n_loc, dtype=torch.int32, device=dev)
        ymir = _local_list(mesh, lambda me: (nbrs0, cnt0))
        for r in range(1, rounds + 1):
            y_cur = pts_hop.wait()
            if forest_hop is not None:
                vforests, forest_hop = forest_hop.wait(), None
            vf_cur = vforests
            if r < rounds:
                # issue round r + 1's payloads before this round evaluates
                pts_hop = comm.permute(mesh, y_cur, perm,
                                       channel="ring_points")
                if ring_modes[r] == "forest":
                    # jump the forest from its last position straight to
                    # round r + 1: one permute, one hop's bytes
                    jump = r + 1 - vpos
                    forest_hop = _ForestHop(mesh, vforests, [
                        (i, (i - jump) % nranks) for i in range(nranks)])
                    vpos = r + 1
            # the mirror accumulator rides one hop behind the block
            ymir = comm.permute(mesh, ymir, perm,
                                channel="ring_mirror").wait()
            for me in loc:
                if not do_eval[me][r]:
                    continue
                yp, yid = y_cur[me]
                if ring_modes[r - 1] == "forest":
                    fn, fc, fd, fp = trav(xs[me], ids[me], vf_cur[me])
                    rn, rc, rd, rp = trav(yp, yid, forests[me])
                    dists[me] = dists[me] + fd + rd
                    pruned[me] = pruned[me] + fp + rp
                else:
                    fc, fb, rc, rb = nng_tile_bits_pair(
                        xs[me], yp, eps, metric=metric)
                    fn = _bits_to_gathered_ids(fb, yid, k_cap)
                    del fb
                    rn = _bits_to_gathered_ids(rb, ids[me], k_cap)
                    del rb
                    dists[me] = dists[me] + n_loc * n_loc
                nbrs[me] = _merge_ids(nbrs[me], fn)
                cnt[me] = cnt[me] + fc
                ymir[me] = (_merge_ids(ymir[me][0], rn), ymir[me][1] + rc)
        nbrs, cnt = _return_mirror(nbrs, cnt, ymir, mesh)
    return _tree_outputs(nbrs, cnt, orders, k_cap, tiles_skipped, dists,
                         pruned, mesh)


def _return_mirror(nbrs, cnt, ymir, mesh):
    """Each block's mirror accumulator (nbrs, cnt) sits ``nranks // 2``
    hops downstream of its home rank: one permute returns it, and it
    merges in."""
    nranks = mesh.size
    rounds = nranks // 2
    perm_home = [(i, (i + rounds) % nranks) for i in range(nranks)]
    ymir = comm.permute(mesh, ymir, perm_home, channel="ring_mirror").wait()
    for me in mesh.local_ranks:
        nbrs[me] = _merge_ids(nbrs[me], ymir[me][0])
        cnt[me] = cnt[me] + ymir[me][1]
    return nbrs, cnt


def _tree_outputs(nbrs, cnt, orders, k_cap, tiles_skipped, dists, pruned,
                  mesh):
    """The tree bodies' outputs in ``_systolic_local``'s form: each local
    rank's rows back in the caller's order (row i of a block's DFS order
    is its row ``orders[me][i]``), and every rank's exact int64 counters
    as the float32 the RunStats normalization uses."""
    loc = mesh.local_ranks
    nbrs = [torch.empty_like(nbrs[me]).index_copy_(0, orders[me], nbrs[me])
            for me in loc]
    cnt = [torch.empty_like(cnt[me]).index_copy_(0, orders[me], cnt[me])
           for me in loc]
    overflow = comm.all_gather(mesh, torch.stack([(c > k_cap).any()
                                                  for c in cnt]),
                               channel=comm.CONTROL)
    counts = [_gathered(mesh, vals, torch.int64).to(torch.float32)
              for vals in (dists, pruned)]
    return (torch.cat(nbrs), torch.cat(cnt), overflow, tiles_skipped,
            counts[0], counts[1])


def plan_ring_schedule(points, nranks: int, eps: float, *,
                       metric="euclidean", prune: bool = True,
                       dense_frac: float = 0.5) -> tuple:
    """The split ring's plan: one ``"forest"`` / ``"points"`` mode per ring
    round (length nranks // 2), from the same block summaries the device
    prune uses.

    For each round r it replays the ring's schedule in float64 — partner =
    (me + r) % nranks, the even ring's boundary round evaluated only by the
    lower rank of each pair, the summary-distance skip test with the same
    inexact-metric slack — and counts the ranks that would evaluate. If
    more than ``dense_frac`` of the scheduled rounds evaluate, the round is
    dense and rotating the forest tables pays for itself (``"forest"``);
    otherwise only raw points rotate and the few evaluating ranks run the
    dense tile (``"points"``). The ring's own skip flags stay authoritative,
    so a knife-edge disagreement with this replay only mis-costs a round.
    With ``prune=False`` every round evaluates: all ``"forest"``."""
    met = get_metric(metric)
    rounds = nranks // 2
    if rounds == 0:
        return ()
    pts = met.as_device(points)
    n = pts.shape[0]
    assert n % nranks == 0, (n, nranks)
    n_loc = n // nranks
    summaries = [met.summary(pts[j * n_loc:(j + 1) * n_loc])
                 for j in range(nranks)]
    call = torch.stack([c for c, _ in summaries])
    radall = torch.stack([r for _, r in summaries]).double().cpu().numpy()
    # dcc[j, p] = summary distance from block j's center to block p's
    dcc = np.stack([met.summary_dist(call, call[j]).double().cpu().numpy()
                    for j in range(nranks)])
    modes = []
    for r in range(1, rounds + 1):
        evals = scheduled = 0
        for j in range(nranks):
            p = (j + r) % nranks
            if nranks % 2 == 0 and r == rounds and not j < p:
                continue                      # boundary round: upper half idle
            scheduled += 1
            if prune:
                bound = radall[j] + radall[p] + eps
                if not met.exact:
                    bound = bound * (1.0 + 1e-5) + 1e-6
                if dcc[j, p] > bound:
                    continue
            evals += 1
        modes.append("forest" if evals > dense_frac * scheduled
                     else "points")
    return tuple(modes)


def local_tables(tables: dict, mesh: RingMesh) -> dict:
    """The local ranks' rows of rank-stacked tables (a leading axis of
    every rank, which is sliced, or of the local ranks alone, which is
    kept)."""
    loc = mesh.local_ranks
    lead = tables["cell"].shape[0]
    if lead == len(loc):
        return tables
    if lead != mesh.size:
        raise ValueError(f"tables of {lead} ranks on a mesh of {mesh.size} "
                         f"({len(loc)} in this process)")
    return {k: v[loc.start:loc.stop] for k, v in tables.items()}


def _rank_forests(forest, mesh: RingMesh) -> list:
    """Per-rank list of the local ranks' ``DeviceForest`` from rank-stacked
    tables (a dict or a ``DeviceForest``, of every rank or of the local
    ranks)."""
    if isinstance(forest, DeviceForest):
        f = DeviceForest(**local_tables(forest._asdict(), mesh))
    else:
        f = DeviceForest.from_tables(local_tables(forest, mesh),
                                     device=mesh.device)
    return _local_list(mesh, lambda me: f.rank(me - mesh.local_ranks[0]))


def systolic_run(points, eps: float, mesh: RingMesh, *, metric="euclidean",
                 k_cap: int = 64, prune: bool = True, overlap: bool = True,
                 traversal: str = "tiles", forest=None,
                 ring_schedule: tuple | None = None):
    """Exact ε-NNG via the sparsity-aware systolic ring over ``mesh``.

    ``points`` (n, d), the whole input on every process, n a multiple of
    the ring size (``build_nng`` pads); each process takes its local
    ranks' blocks. ``traversal="tiles"`` evaluates each round with the
    fused bitmask tile; ``traversal="tree"`` traverses per-block cover
    trees (``forest``: the rank-stacked tables of
    ``flat_tree.build_block_forests``, of every rank or of the local ranks,
    as a dict or a ``DeviceForest``). The tree flavour with
    ``overlap=True`` runs the split schedule ``ring_schedule`` (planned by
    ``plan_ring_schedule`` when None). Returns (nbrs, cnt, overflow,
    tiles_skipped, dists_evaluated, nodes_pruned) as ``_systolic_local``
    describes (the local ranks' rows; every rank's flags and counters),
    on the mesh device; grow ``k_cap`` and re-run if any overflow flag is
    set."""
    met = get_metric(metric)
    nranks = mesh.size
    n = points.shape[0]
    if n % nranks != 0:
        raise ValueError(f"n={n} is not a multiple of the ring size {nranks}")
    x = met.as_device(points, mesh.device)
    blocks = x.contiguous().chunk(nranks)
    xs = _local_list(mesh, lambda me: blocks[me])
    kw = dict(mesh=mesh, eps=float(eps), metric=met, k_cap=int(k_cap),
              prune=prune)
    if traversal == "tiles":
        return _systolic_local(xs, overlap=overlap, **kw)
    if traversal != "tree":
        raise ValueError(f"unknown traversal {traversal!r}")
    if forest is None:
        raise ValueError("traversal='tree' needs the stacked forest tables")
    forests = _rank_forests(forest, mesh)
    if not overlap:
        return _systolic_local_tree(xs, forests, **kw)
    if ring_schedule is None:
        ring_schedule = plan_ring_schedule(x, nranks, float(eps), metric=met,
                                           prune=prune)
    return _systolic_local_tree_split(xs, forests,
                                      ring_modes=tuple(ring_schedule), **kw)


def systolic_nng(points, eps, mesh, **kw):
    """Deprecated alias of ``systolic_run`` (the tuple API). Use
    ``repro_torch.nng.build_nng(points, eps, partition="point", ...)``
    instead — same engine, CSR ``NNGraph`` result, the shared re-plan
    loop (``drive``)."""
    warnings.warn(
        "systolic_nng is deprecated; use repro_torch.nng.build_nng(..., "
        "partition='point') or repro_torch.core.distributed.systolic_run",
        DeprecationWarning, stacklevel=2)
    return systolic_run(points, eps, mesh, **kw)


# ---------------------------------------------------------------------------
# delta traversal — the online-maintenance entry point (repro_torch.stream)
# ---------------------------------------------------------------------------

def _delta_local(qp, qids, qbits, forest_r: DeviceForest, *, eps, metric,
                 k_cap):
    """One rank's delta body: the (broadcast) inserted batch traverses
    this rank's forest once. ``qbits`` are all-ones cell words, so every
    tree of every cell is in scope: an inserted point is checked against
    the whole local forest, whichever cell it lands in (the batch is
    small, so the wider scope costs frontier work at the roots only).
    Returns (nbrs, cnt, dists_evaluated, nodes_pruned), the counters as
    fp32 0-d tensors."""
    nbrs, cnt, dists, pruned = tree_traverse(
        qp, qids, None, forest_r, eps, k_cap, metric, qghost_bits=qbits)
    return nbrs, cnt, dists.to(torch.float32), pruned.to(torch.float32)


def delta_traverse_run(qp, qids, forest, eps: float, mesh: RingMesh, *,
                       metric="euclidean", k_cap: int = 64):
    """Query ONLY the batch ``qp`` against every rank's forest: the online
    insert path. Instead of a full ring or landmark schedule, rank 0's
    batch (points and int32 ids) is broadcast to every process (the
    ``delta_bcast`` channel; ``delta_bcast_bytes`` is its byte model), and
    each process runs one level-synchronous traversal of each local rank's
    forest, rank after rank. The all-ones cell words are as wide as the
    largest cell id of any rank's forest (one all-reduce). The union of
    the ranks' hits is the new-edge set (the forests partition the
    corpus).

    ``forest`` holds the rank-stacked tables (a dict or a ``DeviceForest``,
    of every rank or of the local ranks). Returns (nbrs (n_local·nq,
    k_cap) SENTINEL-padded, cnt (n_local·nq,), dists (nranks,) fp32,
    pruned (nranks,) fp32): row j·nq + i holds the j-th local rank's
    neighbours of query i, so pairing with ``qids`` repeated once a local
    rank recovers directed (src, dst) pairs. Self pairs are excluded by
    global id inside ``tree_traverse``."""
    met = get_metric(metric)
    qp = met.as_device(qp, mesh.device)
    qids = torch.as_tensor(qids, device=mesh.device).to(torch.int32)
    qp, qids = comm.broadcast(mesh, (qp, qids), channel="delta_bcast")
    forests = _rank_forests(forest, mesh)
    # all-ones cell words, wide enough for every cell id present
    max_cell = comm.all_max(mesh, max(max(int(forests[me].cell.max())
                                          for me in mesh.local_ranks), 0))
    qbits = torch.full((qp.shape[0], max_cell // 32 + 1), -1,
                       dtype=torch.int32, device=mesh.device)
    outs = _local_list(mesh, lambda me: _delta_local(
        qp, qids, qbits, forests[me], eps=float(eps), metric=met,
        k_cap=int(k_cap)))
    loc = mesh.local_ranks
    return (torch.cat([outs[me][0] for me in loc]),
            torch.cat([outs[me][1] for me in loc]),
            _gathered(mesh, [o and o[2] for o in outs], torch.float32),
            _gathered(mesh, [o and o[3] for o in outs], torch.float32))


def delta_bcast_bytes(nranks: int, nq: int, dim: int, itemsize: int) -> int:
    """Comm model of the delta broadcast: every other rank receives the
    batch's coordinates and int32 ids once."""
    return (nranks - 1) * nq * (dim * itemsize + 4)


# ---------------------------------------------------------------------------
# Algorithms 5 + 6 — landmark partitioning with ε-ghosts
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LandmarkPlan:
    """Static capacities for the landmark engine (host planning output)."""
    m_centers: int      # Voronoi sites
    cap_coal: int       # per (src, dst) rank-pair coalesce capacity (points)
    cap_ghost: int      # per (src, dst) rank-pair ghost capacity (copies)
    g_per_pt: int       # max cells one point may ghost into
    k_cap: int          # neighbor-list capacity
    cap_rank: int = 0   # max coalesced points on any ONE rank (ring ghost
    #                     block height; 0 = unplanned, coll-only plan)


def ghost_coll_bytes(nranks: int, cap_ghost: int, dim: int,
                     itemsize: int) -> int:
    """Exact planned bytes of the collective (all_to_all) ghost exchange:
    every rank ships nranks × cap_ghost capacity-padded rows of
    (point, id, cell) regardless of how many ghosts actually exist."""
    row = itemsize * dim + 4 + 4            # pts + int32 id + int32 cell
    return nranks * nranks * cap_ghost * row


def ghost_ring_bytes(nranks: int, cap_rank: int, dim: int, itemsize: int,
                     m_centers: int) -> int:
    """Exact planned bytes of the ring ghost exchange: nranks // 2 hops of
    the compacted (cap_rank, dim) block + ids + packed Lemma-1 ghost bits
    (ceil(m/32) uint32 words per row), per rank. Eps-independent — the
    ghost TEST travels as bits instead of materialized ghost copies."""
    mw = (m_centers + 31) // 32
    row = itemsize * dim + 4 + mw * 4       # pts + int32 id + gbits words
    return nranks * (nranks // 2) * cap_rank * row


def resolve_ghost_mode(ghost_mode: str, plan: LandmarkPlan, dim: int,
                       itemsize: int, nranks: int) -> str:
    """Resolve ``"auto"`` to ``"coll"`` / ``"ring"`` from the exact byte
    models above (ring wins iff it moves strictly fewer planned bytes).
    Plans without ``cap_rank`` (hand-built) stay ``"coll"``."""
    if ghost_mode != "auto":
        return ghost_mode
    if plan.cap_rank <= 0:
        return "coll"
    ring = ghost_ring_bytes(nranks, plan.cap_rank, dim, itemsize,
                            plan.m_centers)
    coll = ghost_coll_bytes(nranks, plan.cap_ghost, dim, itemsize)
    return "ring" if ring < coll else "coll"


def plan_landmark(n: int, nranks: int, *, m_centers: int | None = None,
                  avg_degree_hint: float = 64.0,
                  skew: float = 2.0) -> LandmarkPlan:
    """Heuristic capacity planning from workload stats (no ``cap_rank``:
    a collective-exchange plan). ``plan_landmark_device`` counts the
    exact capacities instead."""
    m = m_centers or max(2 * nranks, 32)
    per_pair = int(np.ceil(n / nranks / nranks))
    return LandmarkPlan(
        m_centers=m,
        cap_coal=int(per_pair * skew) + 8,
        cap_ghost=int(per_pair * skew) + 8,
        g_per_pt=8,
        k_cap=int(avg_degree_hint * skew),
    )


def _lemma1_ghost_bound(x, centers, dpc, d_min, two_eps_c, metric):
    """Slacked Lemma-1 ghost bound: (tru, bound) with p a ghost candidate
    of cell i iff ``tru[p, i] <= bound[p]``.

    The raw test is d(p, c_i) <= d(p, C) + 2ε in TRUE distance. Both sides
    come out of fp32 arithmetic (for euclidean the ‖p‖² + ‖c‖² − 2p·c
    expansion, whose cancellation error grows with ‖p‖²), so the bound
    carries the metric's slack (``Metric.lemma1_slack``): over-inclusion
    only costs ghost copies, under-inclusion would lose edges."""
    met = get_metric(metric)
    tru = met.true(dpc)
    bound = met.true(d_min) + two_eps_c
    slack = met.lemma1_slack(x, centers, tru, bound)
    return tru, bound + slack


def _plan_count_local(x, centers, f, *, nranks, two_eps_c, metric):
    """One rank's capacity counts: EXACT per-destination coalesce and ghost
    copy counts plus its max ghost fanout, from the SAME Voronoi assignment
    and slacked Lemma-1 bound the engine applies. Returns (coal (nranks,),
    ghost (nranks,), g_per_pt 0-d)."""
    m = centers.shape[0]
    dpc = metric.cdist(x, centers)
    cell = torch.argmin(dpc, dim=1)
    d_min = dpc.amin(1)
    coal = torch.bincount(f[cell], minlength=nranks)
    tru, gbound = _lemma1_ghost_bound(x, centers, dpc, d_min, two_eps_c,
                                      metric)
    gmask = (tru <= gbound[:, None]) & (
        torch.arange(m, device=x.device)[None, :] != cell[:, None])
    g_per_pt = gmask.sum(1).max()
    # ghosts into cell c land on rank f[c]: sum the per-cell ghost column
    # counts by destination rank
    ghost = torch.zeros(nranks, dtype=torch.int64, device=x.device)
    ghost.index_add_(0, f, gmask.sum(0))
    return coal, ghost, g_per_pt


def plan_landmark_device(points, centers, f, eps: float, mesh: RingMesh, *,
                         metric="euclidean", k_cap: int = 128,
                         pad: int = 8) -> LandmarkPlan:
    """EXACT landmark capacity planning as one counting pass over the
    ranks: each local rank bincounts its coalesce destinations and its
    slacked Lemma-1 ghost copies per destination rank (the tests the
    engine applies); an all-gather of the counts (the reference's) gives
    every process every rank's, and their maxima capacities that are
    exact (+``pad`` slop), the same ints on every process. Only ``k_cap``
    stays a guess that the overflow loop may grow."""
    met = get_metric(metric)
    nranks = mesh.size
    x = met.as_device(points, mesh.device)
    assert x.shape[0] % nranks == 0, (x.shape[0], nranks)
    c = met.as_device(centers, mesh.device)
    ft = torch.as_tensor(np.asarray(f), dtype=torch.int64, device=mesh.device)
    blocks = x.chunk(nranks)
    coal, ghost, gpp = zip(*(
        _plan_count_local(blocks[me], c, ft, nranks=nranks,
                          two_eps_c=2.0 * eps, metric=met)
        for me in mesh.local_ranks))
    # (src, dst) coalesce counts, every rank's
    coal_all = comm.all_gather(mesh, torch.stack(coal), channel=comm.CONTROL)
    ghost_all = comm.all_gather(mesh, torch.stack(ghost),
                                channel=comm.CONTROL)
    gpp_all = comm.all_gather(mesh, torch.stack(gpp), channel=comm.CONTROL)
    # total rows any ONE rank receives in coalesce = the compacted block
    # height the ring ghost path rotates (column sums of the src×dst table)
    rank_tot = int(coal_all.sum(0).max())
    return LandmarkPlan(
        m_centers=int(c.shape[0]),
        cap_coal=int(coal_all.max()) + pad,
        cap_ghost=max(int(ghost_all.max()), 1) + pad,
        g_per_pt=max(int(gpp_all.max()), 1),
        k_cap=k_cap,
        cap_rank=rank_tot + pad,
    )


def _pack_by_dest(dest, valid, payload: dict, nranks: int, cap: int):
    """Pack rows of each ``payload`` entry ((L, ...) tensor, fill value)
    into (nranks, cap, ...) send buffers by destination rank, in stable
    row order within a destination. Returns (buffers, dropped): dropped
    counts the valid rows past ``cap``. Invalid and overflow rows go to a
    trash row that is sliced away."""
    L = dest.shape[0]
    key = torch.where(valid, dest.to(torch.int64), nranks)
    order = torch.argsort(key, stable=True)
    ks = key[order]
    pos = (torch.arange(L, device=ks.device)
           - torch.searchsorted(ks, ks, right=False))
    ok = (ks < nranks) & (pos < cap)
    row = torch.where(ok, ks, nranks)
    col = torch.where(ok, pos, 0)
    dropped = valid.sum() - (ok & (ks < nranks)).sum()
    out = {}
    for name, (x, fill) in payload.items():
        buf = torch.full((nranks + 1, cap) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        buf[row, col] = x[order]
        out[name] = buf[:nranks]
    return out, dropped


def _cell_sort(key_cell, valid, m, *arrays):
    """Cell-sorted compaction: stable-sort rows so cells are contiguous and
    padding rows (key m) cluster at the end — the layout that makes the
    grouped tile's per-block group ranges tight enough to skip whole
    all-padding / cross-cell blocks."""
    order = torch.argsort(torch.where(valid, key_cell, m), stable=True)
    return tuple(a[order] for a in arrays)


def _exchange(sends: list, m: int, mesh: RingMesh, channel: str):
    """One capacity-padded exchange: every local rank's packed (pts, ids,
    cell) buffers through the tiled all-to-all, then each receiver's rows
    cell-sorted. Returns per rank (rows, ids, group), group -1 on padding
    rows (local ranks only)."""
    keys = ("pts", "ids", "cell")
    recv = {k: comm.all_to_all(mesh, [s and s[k] for s in sends],
                               channel=channel) for k in keys}

    def sort(r):
        pts, ids, cell = (recv[k][r] for k in keys)
        valid = ids != SENTINEL
        pts, ids, cell, valid = _cell_sort(cell, valid, m, pts, ids, cell,
                                           valid)
        return pts, ids, torch.where(valid, cell, -1)
    return _local_list(mesh, sort)


def _landmark_exchange(xs, ids, centers, f, *, mesh, two_eps_c, metric,
                       plan, cells=None, ghost_mode="coll"):
    """Phases 1, 2 and (for ``ghost_mode="coll"``) 4's exchange over the
    local ranks.

    Phase 1: each rank's Voronoi cells — ``cells[r]`` where given (the tree
    flavour passes the host assignment its forests were built from), else
    the argmin of ``metric.cdist`` to the replicated centres. Phase 2: rows
    coalesce onto their cell's rank through the capacity-padded
    all-to-all (the ``coalesce`` channel). Phase 4 (coll): each point's
    slacked Lemma-1 ghost cells, at most ``g_per_pt`` of them (the nearest
    first, a stable sort), travel as ghost copies that carry their TARGET
    cell (the ``ghost`` channel); d(p, C) is the fp32 min over ALL
    centres, so with a given assignment the slack absorbs a near-tie's
    gap. Returns (per rank (W, Wids, Wgrp, G, Gids, Ggrp), or (W, Wids,
    Wgrp) for the ring; dropped per rank: a coalesce row, a ghost copy or
    a ghost cell did not fit)."""
    m = centers.shape[0]
    nranks = mesh.size
    dev = mesh.device
    cell_ids = torch.arange(m, device=dev)
    csend, gsend, dropped = ([None] * nranks for _ in range(3))
    for r in mesh.local_ranks:
        x, xid = xs[r], ids[r]
        n_loc = x.shape[0]
        dpc = metric.cdist(x, centers)
        cell = (torch.argmin(dpc, dim=1) if cells is None
                else cells[r].long())
        d_min = dpc.amin(1)
        csend[r], dropped_c = _pack_by_dest(
            f[cell], torch.ones(n_loc, dtype=torch.bool, device=dev),
            {"pts": (x, 0), "ids": (xid, SENTINEL),
             "cell": (cell.to(torch.int32), -1)}, nranks, plan.cap_coal)
        if ghost_mode == "ring":
            dropped[r] = dropped_c > 0
            continue
        tru, gbound = _lemma1_ghost_bound(x, centers, dpc, d_min, two_eps_c,
                                          metric)
        gmask = (tru <= gbound[:, None]) & (cell_ids[None, :]
                                            != cell[:, None])
        # cap the ghost fanout: keep each point's g_per_pt nearest cells
        gscore = torch.where(gmask, tru, 3e38)
        gcells = torch.argsort(gscore, dim=1, stable=True)[:, :plan.g_per_pt]
        gvalid = torch.gather(gmask, 1, gcells)
        g_dropped = gmask.sum() - gvalid.sum()
        gp = torch.arange(n_loc, device=dev).repeat_interleave(plan.g_per_pt)
        gc = gcells.reshape(-1)
        gsend[r], dropped_g = _pack_by_dest(
            f[gc], gvalid.reshape(-1),
            {"pts": (x[gp], 0), "ids": (xid[gp], SENTINEL),
             "cell": (gc.to(torch.int32), -1)}, nranks, plan.cap_ghost)
        dropped[r] = (dropped_c > 0) | (dropped_g > 0) | (g_dropped > 0)
    W = _exchange(csend, m, mesh, "coalesce")
    del csend
    if ghost_mode == "ring":
        return W, dropped
    G = _exchange(gsend, m, mesh, "ghost")
    return [w and w + g for w, g in zip(W, G)], dropped


class _Queries:
    """One landmark query set's neighbour tables and counters, per rank:
    the tile counters (int64, the reference's blocks) and the distances
    evaluated (fp32, the reference's sum) and nodes pruned (int64) over
    the set's launches."""

    def __init__(self, dev):
        z = torch.zeros((), dtype=torch.int64, device=dev)
        self.ids, self.nbrs, self.cnt = [], [], []
        self.sched, self.skip, self.pruned = z, z, z
        self.dists = torch.zeros((), dtype=torch.float32, device=dev)

    def add(self, ids, nbrs, cnt, sched, skip, dists, pruned):
        self.ids.append(ids)
        self.nbrs.append(nbrs)
        self.cnt.append(cnt)
        self.sched = self.sched + sched
        self.skip = self.skip + skip
        self.dists = self.dists + dists
        self.pruned = self.pruned + pruned


def _query_tiles(kernel, ids, Wids, geometry, k_cap, metric):
    """Run one ghost or grouped tile launch ``kernel()`` -> (cnt, bits,
    sched, skip) of the rows ``ids`` against W, turn its mask into
    neighbour ids through ``Wids`` and free it -> the ``_Queries.add``
    arguments: ``dists`` = the reference's live blocks x tq·tp in fp32
    (``geometry`` is the (q, p) tile it counts), no prunes."""
    cnt, bits, sched, skip = kernel()
    nbrs = _bits_to_gathered_ids(bits, Wids, k_cap)
    del bits
    tq, tp = nng_tile_geometry(*geometry, metric)
    dists = (sched - skip).to(torch.float32) * float(tq * tp)
    zero = torch.zeros((), dtype=torch.int64, device=ids.device)
    return ids, nbrs, cnt, sched, skip, dists, zero


def _query_tree(q, ids, groups, forest_r, eps, k_cap, metric, ghost=None):
    """One traversal of a rank's cell forest -> the ``_Queries.add``
    arguments: no tile counters, the traversal's exact distances (fp32)
    and prunes."""
    nbrs, cnt, dists, pruned = tree_traverse(q, ids, groups, forest_r, eps,
                                             k_cap, metric,
                                             qghost_bits=ghost)
    zero = torch.zeros((), dtype=torch.int64, device=q.device)
    return ids, nbrs, cnt, zero, zero, dists.to(torch.float32), pruned


def ring_block(W, Wids, Wgrp, centers, *, eps, metric, cap_rank):
    """One rank's ring payload: its cell-sorted coalesce rows compacted to
    ``cap_rank`` (valid rows first), their ids, and their slacked Lemma-1
    ghost cells as packed words ((cap_rank, ceil(m/32)) int32, the
    ``pack_words`` layout): own cell cleared, padding rows zero. Computed
    once, at home."""
    m = centers.shape[0]
    Wb, Wbgrp = W[:cap_rank], Wgrp[:cap_rank]
    dpc = metric.cdist(Wb, centers)
    tru, gbound = _lemma1_ghost_bound(Wb, centers, dpc, dpc.amin(1),
                                      2.0 * eps, metric)
    gmask = ((tru <= gbound[:, None])
             & (torch.arange(m, device=W.device)[None, :]
                != Wbgrp[:, None].long())
             & (Wbgrp >= 0)[:, None])
    return Wb, Wids[:cap_rank], pack_words(
        torch.nn.functional.pad(gmask, (0, -m % 32)))


def _ghost_ring(bufs, centers, forests, *, mesh, eps, metric, plan,
                traversal):
    """The ring ghost phase (``ghost_mode="ring"``) over the local ranks:
    the ε-ghost exchange as a rotation of each rank's COMPACTED coalesce
    block instead of an all-to-all of ghost copies.

    Each rank compacts its cell-sorted W to ``plan.cap_rank`` rows (valid
    rows first: the cell sort puts padding last; more valid rows than that
    overflow) and computes the slacked Lemma-1 ghost test ONCE at home as
    packed per-row cell words (``ring_block``), and the (block, ids,
    words) triple rotates by ``comm.permute`` (the ``ghost_ring`` channel)
    with the reference's hop (i -> i - 1): at round r rank me holds rank
    (me + r) % R's block. The words travel with the block, also to another
    process or card: recomputing them on arrival would let an fp32 argmin
    near-tie differ between ranks and drop edges. Round r + 1's hop is
    issued before round r evaluates and waited on at the start of round
    r + 1.

    Each round the visiting rows query the LOCAL cells within their ghost
    sets: tiles through ``nng_tile_bits_ghost`` against the rank's W (each
    round's mask freed before the next launch), the tree through
    ``tree_traverse(..., qghost_bits=words)`` over the rank's cell forest.
    Hits stay local (the visiting ids came with the block, so there is no
    mirror accumulator); the CSR assembly symmetrises. Rounds 0..R // 2
    cover every rank pair since Lemma 1 holds in both directions of an
    ε-pair; on an even ring the boundary round's pair {me, me + R/2} is
    evaluated by the lower rank only, and the other rank adds no table.
    Returns per rank a ``_Queries`` and the overflow flags, local ranks
    only."""
    B = plan.cap_rank
    k_cap = plan.k_cap
    nranks = mesh.size
    dev = centers.device
    perm = [(i, (i - 1) % nranks) for i in range(nranks)]
    rounds = nranks // 2
    blks = _local_list(mesh, lambda me: ring_block(
        *bufs[me], centers, eps=eps, metric=metric, cap_rank=B))
    over = _local_list(mesh, lambda me: (bufs[me][2] >= 0).sum() > B)
    outs = _local_list(mesh, lambda me: _Queries(dev))
    for r in range(rounds + 1):
        if r < rounds:                          # round r + 1's hop first
            nxt = comm.permute(mesh, blks, perm, channel="ghost_ring")
        for me in mesh.local_ranks:
            if (r == rounds and rounds > 0 and nranks % 2 == 0
                    and not me < (me + rounds) % nranks):
                continue
            bp, bi, bg = blks[me]
            W, Wids, Wgrp = bufs[me]
            if traversal == "tree":
                res = _query_tree(bp, bi, None, forests[me], eps, k_cap,
                                  metric, ghost=bg)
            else:
                res = _query_tiles(
                    lambda: nng_tile_bits_ghost(bp, W, bg, Wgrp, eps,
                                                metric=metric),
                    bi, Wids, (B, W.shape[0]), k_cap, metric)
            outs[me].add(*res)
        if r < rounds:
            blks = nxt.wait()
    return outs, over


def _landmark_local(xs, ids, centers, f, *, mesh, eps, metric, plan,
                    traversal="tiles", ghost_mode="coll", forests=None,
                    cells=None):
    """The per-rank landmark body over the local ranks.

    The exchange of ``_landmark_exchange``, then per rank the intra-cell
    W x W queries (Phase 3) and the ghost queries (Phase 4): G x W under
    ``ghost_mode="coll"`` (a ghost copy carries its target cell, so the
    group test scopes it there; its own W row sits in another cell), the
    rotating blocks of ``_ghost_ring`` under ``"ring"``.
    ``traversal="tiles"`` runs the grouped tile (and the ghost tile on the
    ring), each hit mask turned into neighbour ids (``bits_to_gathered_ids``
    through the cell-sorted id table) and freed before the next launch;
    ``"tree"`` traverses the rank's cell forest (``forests[r]``), whose
    cells are the host assignment ``cells`` it was built from.

    The counters are the reference's: the tile counters its blocks at its
    geometry (``nng_tile_geometry``), ``dists_evaluated`` = live blocks x
    tq·tp in float32 on tiles and the traversal's frontier pairs on the
    tree, ``nodes_pruned`` the traversal's. Returns (Wids, nbrs, cnt, Gids,
    gnbrs, gcnt, overflow, tiles_skipped, tiles_scheduled, dists_evaluated,
    nodes_pruned): the local ranks' neighbour tables as lists of per-launch
    parts, rank by rank (never concatenated: on the card the ring's tables
    alone take tens of GB, and a copy would double them), and every rank's
    (nranks,) flags and counters."""
    bufs, dropped = _landmark_exchange(
        xs, ids, centers, f, mesh=mesh, two_eps_c=2.0 * eps,
        metric=metric, plan=plan, cells=cells, ghost_mode=ghost_mode)
    k_cap = plan.k_cap
    loc = mesh.local_ranks

    def cell_queries(r, X, Xids, Xgrp):
        """Rank r's rows X (cells Xgrp) against its own cells."""
        W, Wids, Wgrp = bufs[r][:3]
        q = _Queries(X.device)
        if traversal == "tree":
            q.add(*_query_tree(X, Xids, Xgrp, forests[r], eps, k_cap,
                               metric))
        else:
            q.add(*_query_tiles(
                lambda: nng_tile_bits_grouped(X, W, Xgrp, Wgrp, Xids, Wids,
                                              eps, metric=metric),
                Xids, Wids, (X.shape[0], W.shape[0]), k_cap, metric))
        return q

    wq = _local_list(mesh, lambda r: cell_queries(r, *bufs[r][:3]))
    if ghost_mode == "ring":
        gq, over = _ghost_ring(bufs, centers, forests, mesh=mesh, eps=eps,
                               metric=metric, plan=plan, traversal=traversal)
        dropped = [None if d is None else d | o
                   for d, o in zip(dropped, over)]
    else:
        gq = [None] * mesh.size
        for r in loc:
            gq[r] = cell_queries(r, *bufs[r][3:])
            bufs[r] = bufs[r][:3]               # free G before the next
    del bufs
    flags = _gathered(mesh, [
        None if wq[r] is None else
        dropped[r] | any((c > k_cap).any() for c in wq[r].cnt + gq[r].cnt)
        for r in range(mesh.size)], torch.bool)
    counters = [_gathered(mesh, [q and get(q, g) for q, g in zip(wq, gq)],
                          torch.float32)
                for get in (lambda w, g: (w.skip + g.skip).to(torch.float32),
                            lambda w, g: (w.sched + g.sched).to(torch.float32),
                            lambda w, g: w.dists + g.dists,
                            lambda w, g: (w.pruned + g.pruned)
                            .to(torch.float32))]
    tables = [[part for r in loc for part in getattr(qs[r], name)]
              for qs in (wq, gq) for name in ("ids", "nbrs", "cnt")]
    return (*tables, flags, *counters)


def landmark_run(points, eps: float, centers, f, mesh: RingMesh,
                 plan: LandmarkPlan, *, metric="euclidean",
                 traversal: str = "tiles", forest=None, cell=None,
                 ghost_mode: str = "coll"):
    """Distributed landmark ε-NNG (Algorithms 5+6) over ``mesh``.

    ``points`` (n, d), the whole input on every process, n a multiple of
    the ring size (``build_nng`` pads); ``centers`` (m, d) the Voronoi
    sites; ``f`` (m,) the cell -> rank assignment (LPT, planned on the
    host); ``plan`` the capacities. ``ghost_mode`` is the Phase 4
    schedule: ``"coll"`` (capacity-padded all-to-all of ghost copies) or
    ``"ring"`` (rotation of the compacted coalesce block with the Lemma-1
    test as packed cell words; needs ``plan.cap_rank``); ``"auto"`` is
    resolved upstream (``resolve_ghost_mode``). ``traversal="tree"`` needs
    ``forest`` (the rank-stacked cell-forest tables of
    ``flat_tree.build_cell_forests``, of every rank or of the local ranks,
    a dict or a ``DeviceForest``) and ``cell`` (the (n,) Voronoi
    assignment they were built from, so Phase 1 cannot differ from the
    forests' scope on an argmin near-tie). Returns (Wids, nbrs, cnt, Gids,
    gnbrs, gcnt, overflow, tiles_skipped, tiles_scheduled,
    dists_evaluated, nodes_pruned) as ``_landmark_local`` describes (the
    local ranks' tables as lists of parts, every rank's flags and
    counters), on the mesh device: the union over the processes of the
    (Wids → nbrs) and (Gids → gnbrs) edges is the exact ε-graph when no
    overflow flag is set."""
    if ghost_mode not in ("coll", "ring"):
        raise ValueError(f"ghost_mode={ghost_mode!r}: 'auto' is resolved "
                         "upstream (resolve_ghost_mode)")
    if ghost_mode == "ring" and plan.cap_rank <= 0:
        raise ValueError("ghost_mode='ring' needs plan.cap_rank (use "
                         "plan_landmark_device, or set cap_rank)")
    if traversal not in ("tiles", "tree"):
        raise ValueError(f"unknown traversal {traversal!r}")
    met = get_metric(metric)
    nranks = mesh.size
    x = met.as_device(points, mesh.device)
    n = x.shape[0]
    if n % nranks != 0:
        raise ValueError(f"n={n} is not a multiple of the ring size {nranks}")
    blocks = x.contiguous().chunk(nranks)
    id_blocks = torch.arange(n, dtype=torch.int32,
                             device=mesh.device).chunk(nranks)
    xs = _local_list(mesh, lambda me: blocks[me])
    ids = _local_list(mesh, lambda me: id_blocks[me])
    forests = cells = None
    if traversal == "tree":
        if forest is None or cell is None:
            raise ValueError("traversal='tree' needs the stacked cell "
                             "forests and the cell assignment they were "
                             "built from")
        forests = _rank_forests(forest, mesh)
        cell_blocks = torch.as_tensor(np.asarray(cell), dtype=torch.int64,
                                      device=mesh.device).chunk(nranks)
        cells = _local_list(mesh, lambda me: cell_blocks[me])
    return _landmark_local(
        xs, ids, met.as_device(centers, mesh.device),
        torch.as_tensor(np.asarray(f), dtype=torch.int64,
                        device=mesh.device),
        mesh=mesh, eps=float(eps), metric=met, plan=plan,
        traversal=traversal, ghost_mode=ghost_mode, forests=forests,
        cells=cells)


def landmark_nng(points, eps, centers, f, mesh, plan, **kw):
    """Deprecated alias of ``landmark_run`` (the tuple API). Use
    ``repro_torch.nng.build_nng(points, eps, partition="spatial", ...)``
    instead — same engine, CSR ``NNGraph`` result, the shared re-plan
    loop (``drive``)."""
    warnings.warn(
        "landmark_nng is deprecated; use repro_torch.nng.build_nng(..., "
        "partition='spatial') or repro_torch.core.distributed.landmark_run",
        DeprecationWarning, stacklevel=2)
    return landmark_run(points, eps, centers, f, mesh, plan, **kw)
