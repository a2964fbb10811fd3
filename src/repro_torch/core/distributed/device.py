"""The systolic ring (the paper's Algorithm 4) on logical ranks.

``RingMesh(size, device)`` holds ``size`` logical ranks that all live on
one device. ``_systolic_local`` is the per-rank body of the reference's
shard_map program, written once over state indexed by rank; each
``ppermute`` becomes ``_ring_permute``, which reassigns which rank holds
which block — no copy on one device, but the same hop schedule. The rounds
run in round-major order (every rank's round r before any rank's round
r + 1), so the symmetric halving, the even-ring boundary round, the mirror
accumulator riding one hop behind its block, and its final shift home are
the reference's own. One process per GPU over NCCL (ROADMAP item 3) will
drive the same body.

Each evaluated ring round runs the fused bitmask tile
(``repro_torch.kernels.ops.nng_tile_bits``) once forward and once for the
mirror; neighbour ids come out of the bitmask epilogue
(``ops.bits_to_ids``). Only the packed hit words and exact counts reach
device memory, never the fp32 distance tile.

Block-summary pruning: each rank's block is summarized as a center and a
radius once up front; a round whose partner block satisfies
d(c_me, c_p) > r_me + r_p + eps cannot hold an ε-pair, so it is skipped.

The tree flavour (``traversal="tree"``) runs the same ring with each rank's
levelized cover tree (``DeviceForest``): a ring round runs two
level-synchronous traversals (``tree_traverse``, through the
``tree_frontier`` and ``leaf_range_pack`` kernels) instead of two dense
tiles, so the triangle-inequality prune fires inside every round.
``_systolic_local_tree`` is the serial schedule and
``_systolic_local_tree_split`` the double-buffered one, whose rounds rotate
either the forest tables or the raw points as ``plan_ring_schedule``
decides.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.metrics import get_metric
from repro_torch.kernels.bits_epilogue import SENTINEL
from repro_torch.kernels.nng_tile import _BIT, pack_words, unpack_words
from repro_torch.kernels.ops import bits_to_gathered_ids as _bits_to_gathered_ids
from repro_torch.kernels.ops import bits_to_ids as _bits_to_ids
from repro_torch.kernels.ops import leaf_range_pack as _leaf_range_pack
from repro_torch.kernels.ops import (nng_tile_bits, nng_tile_bits_pair,
                                     tree_frontier_step)


@dataclass(frozen=True)
class RingMesh:
    """``size`` logical ranks on one ``device`` (a ``torch.device``)."""

    size: int
    device: torch.device


def make_nng_mesh(nranks: int = 1, device=None) -> RingMesh:
    """A ring of ``nranks`` logical ranks on one device. ``device=None``
    means the CUDA card; a CUDA device on a machine without one raises
    instead of running on the CPU."""
    if nranks < 1:
        raise ValueError(f"nranks must be >= 1 (got {nranks})")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch versions")
    return RingMesh(int(nranks), dev)


def _ring_permute(blocks: list, perm) -> list:
    """The one-device ``ppermute``: ``perm`` is [(src, dst), ...]; rank dst
    now holds what rank src held."""
    out = list(blocks)
    for src, dst in perm:
        out[dst] = blocks[src]
    return out


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


# bytes of a pass's temporaries per query row and node on the dense path
# (the unpacked parent bits, the gathered active mask and the packing
# temporaries, a byte each); the delta table adds 4 bytes per row and leaf
# slot.
_TRAVERSE_BYTES_PER_NODE = 4
TRAVERSE_BUDGET = 8 << 30
# A level's masks are walked as (row, node) pair lists while the pairs
# (bounded by 32 per nonzero word) stay within 1/SPARSE_DIV of the pass's
# (rows × nodes) grid, else densely. The list costs up to about 64 bytes a
# pair (int64 rows, nodes, child ranges and scatter indices), so this
# bound keeps it near the dense path's modelled 4 bytes per grid cell,
# and a level whose active pairs are many goes densely (chip_smoke.py
# [6f] drives one and prints both paths' peaks).
SPARSE_DIV = 16
_NODE_CHUNK = 1 << 14        # node columns per dense emission step


def traverse_q_chunk(n_nodes: int, n_leaf: int,
                     budget: int = TRAVERSE_BUDGET) -> int:
    """Query rows per pass of ``tree_traverse``: the most that keep the
    pass's temporaries (the (c, n_leaf + 1) int32 delta and the (c, N)
    byte masks) under ``budget`` bytes, in multiples of 1024 (128 below
    that)."""
    per_row = 4 * (n_leaf + 1) + _TRAVERSE_BYTES_PER_NODE * n_nodes
    c = max(budget // per_row, 128)
    return c - c % 1024 if c >= 1024 else c - c % 128


def pair_limit(rows: int, nodes: int) -> int:
    """The most (row, node) pairs a pass of ``rows`` queries over a level
    of ``nodes`` slots walks as a list; past it the level goes densely."""
    return rows * nodes // SPARSE_DIV


def _popcount(words):
    """Set bits of int32 words, summed -> int64 0-d tensor."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum()


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
    slot range [lo, hi) of each node's children in level l + 1: the
    builders emit a level's valid slots as a prefix, in parent order, so a
    node's children (the valid slots whose parent it is) are contiguous.
    Raises on a forest laid out otherwise. -> (lo, hi) (L, N) int32."""
    L, N = cell.shape
    lo = torch.zeros((L, N), dtype=torch.int32, device=cell.device)
    hi = torch.zeros_like(lo)
    for lvl in range(1, L):
        v = cell[lvl] >= 0
        nv = int(v.sum())
        par = parent[lvl][:nv].long()
        if not bool(v[:nv].all()) or bool((par[1:] < par[:-1]).any()):
            raise ValueError(f"forest level {lvl}: valid slots are not a "
                             "prefix in parent order")
        cnt = torch.bincount(par, minlength=N)[:N]
        hi[lvl - 1] = torch.cumsum(cnt, 0)
        lo[lvl - 1] = hi[lvl - 1] - cnt
    return lo, hi


def _child_pairs(prev, lo_tab, hi_tab, limit: int):
    """The (row, child slot) pairs under every expanded (row, node) pair of
    ``prev`` (packed expand words; node v's children are the slots
    [lo_tab[v], hi_tab[v])) and the count of expanded pairs, or None when
    either list could hold more than ``limit`` pairs."""
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
    return rows, node, er.numel()


def tree_traverse(qp, qids, qcells, forest: DeviceForest, eps, k_cap: int,
                  metric, qghost_bits=None, q_chunk: int | None = None):
    """Level-synchronous batched cover-tree traversal on the device.

    The queries are walked in passes of ``q_chunk`` rows (default
    ``traverse_q_chunk``: the reference's all-queries-at-once tables do not
    fit on a card at paper scale); each pass loops over the forest's
    levels. Each level:

      1. active mask: a node is active for a query iff its parent's expand
         bit survived the previous level, the slot is valid, and the node's
         cell matches the query's cell (``qcells``). While the expanded
         pairs are few, the mask is set from the list of (query, child)
         pairs (each expanded node's children are one slot range); else it
         is gathered densely through the parent slots. Both give the same
         words;
      2. frontier kernel (``ops.tree_frontier_step``): fused distance and
         {emit, expand} decisions as packed words; blocks with no active
         pair skip their distances;
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
    if qghost_bits is not None:
        raise NotImplementedError(
            "tree_traverse(qghost_bits=...) (the landmark engine's ghost "
            "ring) is not ported to PyTorch yet: ROADMAP item 7")
    nq = qp.shape[0]
    dev = qp.device
    L, N = forest.radius.shape
    nw = N // 32
    n_leaf = forest.leaf_ids.shape[0]
    assert N % 32 == 0 and n_leaf % 32 == 0, (N, n_leaf)
    qids = torch.as_tensor(qids, dtype=torch.int32, device=dev)
    qcells = torch.as_tensor(qcells, dtype=torch.int32, device=dev)
    c = int(q_chunk or traverse_q_chunk(N, n_leaf))
    child_lo = forest.child_lo.long()
    child_hi = forest.child_hi.long()
    parent = forest.parent.long()
    leaf_lo = forest.leaf_lo.long()
    leaf_hi = forest.leaf_hi.long()
    valid = forest.cell >= 0
    acts = torch.zeros((), dtype=torch.int64, device=dev)
    outs = torch.zeros((), dtype=torch.int64, device=dev)   # emit + expand
    nbrs, cnt = [], []
    for s in range(0, nq, c):
        q = qp[s:s + c]
        qc = qcells[s:s + c]
        m = q.shape[0]
        limit = pair_limit(m, N)
        # one scope row when every query of the pass shares its cell (the
        # ring's block forests), else one per query
        if bool((qc == qc[0]).all()):
            qc = qc[:1]
        delta = torch.zeros((m, n_leaf + 1), dtype=torch.int32, device=dev)
        prev = None
        for lvl in range(L):
            scope = valid[lvl][None, :] & (forest.cell[lvl][None, :]
                                           == qc[:, None])
            act = None
            if prev is None:                       # the roots
                if qc.shape[0] == 1:
                    act = pack_words(scope).expand(m, nw).contiguous()
                    acts += scope.sum() * m
            else:
                pairs = _child_pairs(prev, child_lo[lvl - 1],
                                     child_hi[lvl - 1], limit)
                if pairs is None:
                    outs += _popcount(prev)
                else:
                    rows, node, n_exp = pairs
                    outs += n_exp
                    keep = forest.cell[lvl][node] == (
                        qc[0] if qc.shape[0] == 1 else qc[rows])
                    acts += keep.sum()
                    act = _words_from_pairs(rows, node, keep, m, nw)
            if act is None:
                if prev is None:
                    prev = torch.full((m, nw), -1, dtype=torch.int32,
                                      device=dev)
                active = unpack_words(prev)[:, parent[lvl]]
                active &= scope
                acts += active.sum()
                act = pack_words(active)
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
                    delta.index_add_(1, leaf_hi[lvl][c0:c0 + e.shape[1]], -e)
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


def _round_skip_flags(xs, partner, eps, *, metric, prune):
    """Per-rank, per-round prune decisions from the block summary table.

    ``xs`` is every rank's block (the all-gather of the summaries is a
    stack on one device), ``partner`` (nranks, rounds + 1) the block each
    rank meets in each round. skip[me, r] is True when no point of my
    block can be within eps of any point of the partner block:
    d(c_me, c_p) > r_me + r_p + eps. Float-metric center distances are
    fp32, so the bound carries a small relative slack — under-pruning is
    always safe, over-pruning never is."""
    nranks, nrounds = partner.shape
    if not prune:
        return torch.zeros((nranks, nrounds), dtype=torch.bool)
    met = get_metric(metric)
    summ = [met.summary(x) for x in xs]
    call = torch.stack([c for c, _ in summ])           # (nranks, d)
    radall = torch.stack([r for _, r in summ])         # (nranks,)
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


def _eval_schedule(xs, nranks, eps, *, metric, prune):
    """Which rounds each rank evaluates: (do_eval [me][r] bools for rounds
    r = 0..nranks // 2, tiles_skipped (nranks,) f32). The boundary round of
    an even ring is scheduled on the lower rank of each pair only, and the
    block-summary prune skips rounds whose blocks hold no ε-pair."""
    rounds = nranks // 2
    rr = np.arange(rounds + 1)
    partner = (np.arange(nranks)[:, None] + rr[None, :]) % nranks
    skip = _round_skip_flags(xs, partner, eps, metric=metric, prune=prune)
    sched = torch.ones((nranks, rounds + 1), dtype=torch.bool)
    if nranks % 2 == 0 and rounds > 0:
        sched[:, rounds] = torch.from_numpy(
            np.arange(nranks) < partner[:, rounds])
    return (sched & ~skip).tolist(), (sched & skip).to(torch.float32).sum(1)


def _systolic_local(xs, *, nranks, eps, metric, k_cap, prune, overlap=True):
    """The per-rank body over all ranks. ``xs[me]`` (n_loc, d) is rank
    me's block; block-contiguous global ids mean a visiting block is fully
    described by its first id ``me * n_loc``.

    Symmetry halving (paper §IV-C): each (local × visiting) tile emits
    BOTH edge directions — the visiting block carries its own neighbour
    accumulator around the ring and one final permute sends it home. Tiles
    evaluated: nranks // 2 + 1 rounds instead of nranks; in the boundary
    round of an even ring only the lower rank of each pair evaluates.

    ``overlap=True`` is the reference's double-buffered schedule: a priming
    hop before the self tile, then each round issues the hop that feeds
    round r + 1 before it evaluates round r, and the mirror accumulator
    rides one hop behind its block. ``overlap=False`` is the strict
    rotate-then-evaluate schedule. Both give the same graph; they differ in
    the hops they make (one priming hop), which ``comm_bytes`` counts.

    Returns (nbrs (n, k_cap) int32 SENTINEL-padded, cnt (n,) int32 exact,
    overflow (nranks,) bool, tiles_skipped (nranks,) f32, dists_evaluated
    (nranks,) f32, nodes_pruned (nranks,) f32)."""
    n_loc = xs[0].shape[0]
    dev = xs[0].device
    perm = [(i, (i - 1) % nranks) for i in range(nranks)]
    rounds = nranks // 2
    id0 = [me * n_loc for me in range(nranks)]
    do_eval, tiles_skipped = _eval_schedule(xs, nranks, eps, metric=metric,
                                            prune=prune)
    # float32 counters (the RunStats normalization): int32 wraps at paper
    # scale, fp32 is exact below 2^24 and approximate beyond
    dists = (torch.tensor(do_eval, dtype=torch.float32).sum(1)
             * torch.tensor(float(n_loc) * float(n_loc), dtype=torch.float32))

    ones = torch.ones(n_loc, dtype=torch.int32, device=dev)

    def tile_bits(a, b):
        return nng_tile_bits(a, b, ones, eps, metric=metric)

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

    nbrs0 = torch.full((n_loc, k_cap), SENTINEL, dtype=torch.int32, device=dev)
    cnt0 = torch.zeros(n_loc, dtype=torch.int32, device=dev)
    ys, yid = list(xs), list(id0)
    if overlap and rounds > 0:
        # prime the pipeline: hop 1 in flight while the self tile runs below
        ys, yid = _ring_permute(ys, perm), _ring_permute(yid, perm)

    # self tile (round 0): clear the diagonal bit (row i, column i) and take
    # it off the row's count — structurally excludes self pairs even when
    # fp32 rounding pushes d(x, x) past eps
    rows = torch.arange(n_loc, device=dev)
    wsel = rows // 32
    bit = _BIT.to(dev)[rows % 32]
    nbrs, cnt = [], []
    for me in range(nranks):
        c_self, bits0 = tile_bits(xs[me], xs[me])
        diag = bits0[rows, wsel] & bit
        bits0[rows, wsel] ^= diag
        cnt.append(c_self - (diag != 0).to(torch.int32))
        nbrs.append(_merge_ids(nbrs0, _bits_to_ids(bits0, id0[me], k_cap)))
        del bits0

    if rounds > 0:
        ynbrs, ycnt = [nbrs0] * nranks, [cnt0] * nranks
        for r in range(1, rounds + 1):
            if overlap:
                # hop r + 1 issued before round r evaluates
                y_next, yid_next = _ring_permute(ys, perm), _ring_permute(yid, perm)
            else:
                ys, yid = _ring_permute(ys, perm), _ring_permute(yid, perm)
            ynbrs, ycnt = _ring_permute(ynbrs, perm), _ring_permute(ycnt, perm)
            for me in range(nranks):
                if do_eval[me][r]:
                    nbrs[me], cnt[me], ynbrs[me], ycnt[me] = eval_pair(
                        me, ys[me], yid[me], nbrs[me], cnt[me], ynbrs[me],
                        ycnt[me])
            if overlap:
                ys, yid = y_next, yid_next
        # each block's mirror accumulator sits `rounds` hops downstream of
        # its home rank; one permute returns it
        perm_home = [(i, (i + rounds) % nranks) for i in range(nranks)]
        ynbrs, ycnt = _ring_permute(ynbrs, perm_home), _ring_permute(ycnt, perm_home)
        for me in range(nranks):
            nbrs[me] = _merge_ids(nbrs[me], ynbrs[me])
            cnt[me] = cnt[me] + ycnt[me]
    overflow = torch.stack([(c > k_cap).any() for c in cnt])
    return (torch.cat(nbrs), torch.cat(cnt), overflow, tiles_skipped, dists,
            torch.zeros(nranks, dtype=torch.float32))


def _systolic_local_tree(xs, forests, *, nranks, eps, metric, k_cap,
                         prune):
    """The per-rank body, cover-tree flavour, SERIAL schedule
    (``overlap=False``; ``_systolic_local_tree_split`` is the
    double-buffered production body).

    ``forests[me]`` is rank me's block tree. It rotates around the ring
    with its block: each evaluated round runs two traversals instead of two
    dense tiles — my points query the visiting block's tree (forward edges)
    and the visiting points query my tree (the mirror accumulator) — so the
    in-tree triangle prune fires inside every round. The block-summary
    prune still skips whole rounds above it. Every hop is made before its
    round evaluates. Returns what ``_systolic_local`` returns."""
    n_loc = xs[0].shape[0]
    dev = xs[0].device
    perm = [(i, (i - 1) % nranks) for i in range(nranks)]
    rounds = nranks // 2
    ids = [torch.arange(me * n_loc, (me + 1) * n_loc, dtype=torch.int32,
                        device=dev) for me in range(nranks)]
    qcells = torch.zeros(n_loc, dtype=torch.int32, device=dev)
    do_eval, tiles_skipped = _eval_schedule(xs, nranks, eps, metric=metric,
                                            prune=prune)

    def trav(qp, qids, fr):
        return tree_traverse(qp, qids, qcells, fr, eps, k_cap, metric)

    # round 0 (self tile): one traversal of my own tree; the global-id test
    # inside tree_traverse excludes self pairs structurally
    nbrs, cnt, dists, pruned = map(list, zip(*(
        trav(xs[me], ids[me], forests[me]) for me in range(nranks))))
    if rounds > 0:
        nbrs0 = torch.full((n_loc, k_cap), SENTINEL, dtype=torch.int32,
                           device=dev)
        cnt0 = torch.zeros(n_loc, dtype=torch.int32, device=dev)
        ys, yids, yforests = list(xs), list(ids), list(forests)
        ynbrs, ycnt = [nbrs0] * nranks, [cnt0] * nranks
        for r in range(1, rounds + 1):
            ys, yids = _ring_permute(ys, perm), _ring_permute(yids, perm)
            yforests = _ring_permute(yforests, perm)
            ynbrs, ycnt = _ring_permute(ynbrs, perm), _ring_permute(ycnt, perm)
            for me in range(nranks):
                if not do_eval[me][r]:
                    continue
                fn, fc, fd, fp = trav(xs[me], ids[me], yforests[me])
                rn, rc, rd, rp = trav(ys[me], yids[me], forests[me])
                nbrs[me] = _merge_ids(nbrs[me], fn)
                cnt[me] = cnt[me] + fc
                ynbrs[me] = _merge_ids(ynbrs[me], rn)
                ycnt[me] = ycnt[me] + rc
                dists[me] = dists[me] + fd + rd
                pruned[me] = pruned[me] + fp + rp
        nbrs, cnt = _return_mirror(nbrs, cnt, ynbrs, ycnt, nranks)
    return _tree_outputs(nbrs, cnt, k_cap, tiles_skipped, dists, pruned)


def _systolic_local_tree_split(xs, forests, *, nranks, eps, metric, k_cap,
                               prune, ring_modes):
    """The per-rank body, tree flavour: the double-buffered ring with the
    SPLIT schedule (``overlap=True``, the production tree body).

    ``ring_modes[r - 1]`` selects what round r rotates; it is planned once
    (``plan_ring_schedule``) and is the same on every rank, because a hop is
    a collective step that every rank makes alike:

    - ``"forest"``: the visiting block's forest tables jump to their round-r
      position in ONE permute (a multi-hop shift when the rounds between
      rotated points only, so skipped rounds never pay forest bytes) and
      the forward direction traverses them.
    - ``"points"``: only the raw point block and its ids rotate, and an
      evaluated round runs the dense tile pair (``nng_tile_bits_pair``).

    Round r + 1's hops are issued before round r evaluates, as in the tiles
    flavour. The mirror traversal always queries the LOCAL forest, so only
    the forward direction needs the rotated tables. The mode moves bytes
    and work, never edges: tiles and traversal emit the same edge set."""
    n_loc = xs[0].shape[0]
    dev = xs[0].device
    perm = [(i, (i - 1) % nranks) for i in range(nranks)]
    rounds = nranks // 2
    assert len(ring_modes) == rounds, (ring_modes, rounds)
    ids = [torch.arange(me * n_loc, (me + 1) * n_loc, dtype=torch.int32,
                        device=dev) for me in range(nranks)]
    qcells = torch.zeros(n_loc, dtype=torch.int32, device=dev)
    do_eval, tiles_skipped = _eval_schedule(xs, nranks, eps, metric=metric,
                                            prune=prune)

    def trav(qp, qids, fr):
        return tree_traverse(qp, qids, qcells, fr, eps, k_cap, metric)

    if rounds > 0:
        # prime round 1's payloads; the round-0 self traversals overlap them
        ys, yids = _ring_permute(list(xs), perm), _ring_permute(ids, perm)
        vforests, vpos = list(forests), 0
        if ring_modes[0] == "forest":
            vforests, vpos = _ring_permute(vforests, perm), 1
    nbrs, cnt, dists, pruned = map(list, zip(*(
        trav(xs[me], ids[me], forests[me]) for me in range(nranks))))
    if rounds > 0:
        nbrs0 = torch.full((n_loc, k_cap), SENTINEL, dtype=torch.int32,
                           device=dev)
        cnt0 = torch.zeros(n_loc, dtype=torch.int32, device=dev)
        ynbrs, ycnt = [nbrs0] * nranks, [cnt0] * nranks
        for r in range(1, rounds + 1):
            y_cur, yids_cur, vf_cur = ys, yids, vforests
            if r < rounds:
                # issue round r + 1's payloads before this round evaluates
                ys, yids = _ring_permute(ys, perm), _ring_permute(yids, perm)
                if ring_modes[r] == "forest":
                    # jump the forest from its last position straight to
                    # round r + 1: one permute, one hop's bytes
                    jump = r + 1 - vpos
                    vforests = _ring_permute(
                        vforests, [(i, (i - jump) % nranks)
                                   for i in range(nranks)])
                    vpos = r + 1
            # the mirror accumulator rides one hop behind the block
            ynbrs, ycnt = _ring_permute(ynbrs, perm), _ring_permute(ycnt, perm)
            for me in range(nranks):
                if not do_eval[me][r]:
                    continue
                if ring_modes[r - 1] == "forest":
                    fn, fc, fd, fp = trav(xs[me], ids[me], vf_cur[me])
                    rn, rc, rd, rp = trav(y_cur[me], yids_cur[me],
                                          forests[me])
                    dists[me] = dists[me] + fd + rd
                    pruned[me] = pruned[me] + fp + rp
                else:
                    fc, fb, rc, rb = nng_tile_bits_pair(
                        xs[me], y_cur[me], eps, metric=metric)
                    fn = _bits_to_ids(fb, (me + r) % nranks * n_loc, k_cap)
                    del fb
                    rn = _bits_to_ids(rb, me * n_loc, k_cap)
                    del rb
                    dists[me] = dists[me] + n_loc * n_loc
                nbrs[me] = _merge_ids(nbrs[me], fn)
                cnt[me] = cnt[me] + fc
                ynbrs[me] = _merge_ids(ynbrs[me], rn)
                ycnt[me] = ycnt[me] + rc
        nbrs, cnt = _return_mirror(nbrs, cnt, ynbrs, ycnt, nranks)
    return _tree_outputs(nbrs, cnt, k_cap, tiles_skipped, dists, pruned)


def _return_mirror(nbrs, cnt, ynbrs, ycnt, nranks):
    """Each block's mirror accumulator sits ``nranks // 2`` hops downstream
    of its home rank: one permute returns it, and it merges in."""
    rounds = nranks // 2
    perm_home = [(i, (i + rounds) % nranks) for i in range(nranks)]
    ynbrs, ycnt = _ring_permute(ynbrs, perm_home), _ring_permute(ycnt, perm_home)
    return ([_merge_ids(a, b) for a, b in zip(nbrs, ynbrs)],
            [a + b for a, b in zip(cnt, ycnt)])


def _tree_outputs(nbrs, cnt, k_cap, tiles_skipped, dists, pruned):
    """The tree bodies' outputs in ``_systolic_local``'s form: the exact
    int64 counters become the float32 the RunStats normalization uses."""
    dev = nbrs[0].device
    overflow = torch.stack([(c > k_cap).any() for c in cnt])
    counts = [torch.stack([torch.as_tensor(v, dtype=torch.int64, device=dev)
                           for v in vals]).to(torch.float32)
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
    pts = torch.as_tensor(points).to(met.dtype)
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


def systolic_run(points, eps: float, mesh: RingMesh, *, metric="euclidean",
                 k_cap: int = 64, prune: bool = True, overlap: bool = True,
                 traversal: str = "tiles", forest=None,
                 ring_schedule: tuple | None = None):
    """Exact ε-NNG via the sparsity-aware systolic ring over ``mesh``.

    ``points`` (n, d), n a multiple of the ring size (``build_nng`` pads).
    ``traversal="tiles"`` evaluates each round with the fused bitmask tile;
    ``traversal="tree"`` traverses per-block cover trees (``forest``: the
    rank-stacked tables of ``flat_tree.build_block_forests``, as a dict or
    a ``DeviceForest``). The tree flavour with ``overlap=True`` runs the
    split schedule ``ring_schedule`` (planned by ``plan_ring_schedule``
    when None). Returns (nbrs, cnt, overflow, tiles_skipped,
    dists_evaluated, nodes_pruned) as ``_systolic_local`` describes, on the
    mesh device; grow ``k_cap`` and re-run if any overflow flag is set."""
    met = get_metric(metric)
    nranks = mesh.size
    n = points.shape[0]
    if n % nranks != 0:
        raise ValueError(f"n={n} is not a multiple of the ring size {nranks}")
    x = torch.as_tensor(points).to(device=mesh.device, dtype=met.dtype)
    xs = list(x.contiguous().chunk(nranks))
    kw = dict(nranks=nranks, eps=float(eps), metric=met, k_cap=int(k_cap),
              prune=prune)
    if traversal == "tiles":
        return _systolic_local(xs, overlap=overlap, **kw)
    if traversal != "tree":
        raise ValueError(f"unknown traversal {traversal!r}")
    if forest is None:
        raise ValueError("traversal='tree' needs the stacked forest tables")
    if not isinstance(forest, DeviceForest):
        forest = DeviceForest.from_tables(forest, device=mesh.device)
    forests = [forest.rank(r) for r in range(nranks)]
    if not overlap:
        return _systolic_local_tree(xs, forests, **kw)
    if ring_schedule is None:
        ring_schedule = plan_ring_schedule(x, nranks, float(eps), metric=met,
                                           prune=prune)
    return _systolic_local_tree_split(xs, forests,
                                      ring_modes=tuple(ring_schedule), **kw)
