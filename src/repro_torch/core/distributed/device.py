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
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.metrics import get_metric
from repro_torch.kernels.bits_epilogue import SENTINEL
from repro_torch.kernels.nng_tile import _BIT
from repro_torch.kernels.ops import bits_to_ids as _bits_to_ids
from repro_torch.kernels.ops import nng_tile_bits


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

    # prune schedule: skip / sched / do_eval [me, r] for rounds r = 0..rounds
    rr = np.arange(rounds + 1)
    partner = (np.arange(nranks)[:, None] + rr[None, :]) % nranks
    skip = _round_skip_flags(xs, partner, eps, metric=metric, prune=prune)
    sched = torch.ones((nranks, rounds + 1), dtype=torch.bool)
    if nranks % 2 == 0 and rounds > 0:
        sched[:, rounds] = torch.from_numpy(
            np.arange(nranks) < partner[:, rounds])
    do_eval = (sched & ~skip).tolist()
    # float32 counters (the RunStats normalization): int32 wraps at paper
    # scale, fp32 is exact below 2^24 and approximate beyond
    tiles_skipped = (sched & skip).to(torch.float32).sum(1)
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


def systolic_run(points, eps: float, mesh: RingMesh, *, metric="euclidean",
                 k_cap: int = 64, prune: bool = True, overlap: bool = True):
    """Exact ε-NNG via the sparsity-aware systolic ring over ``mesh``.

    ``points`` (n, d), n a multiple of the ring size (``build_nng`` pads).
    Returns (nbrs, cnt, overflow, tiles_skipped, dists_evaluated,
    nodes_pruned) as ``_systolic_local`` describes, on the mesh device;
    grow ``k_cap`` and re-run if any overflow flag is set."""
    met = get_metric(metric)
    nranks = mesh.size
    n = points.shape[0]
    if n % nranks != 0:
        raise ValueError(f"n={n} is not a multiple of the ring size {nranks}")
    x = torch.as_tensor(points).to(device=mesh.device, dtype=met.dtype)
    xs = list(x.contiguous().chunk(nranks))
    return _systolic_local(xs, nranks=nranks, eps=float(eps), metric=met,
                           k_cap=int(k_cap), prune=prune, overlap=overlap)
