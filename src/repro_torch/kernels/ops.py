"""Device-dispatching wrappers around the tile kernels.

Each wrapper follows the device of its tensors: on a CUDA tensor it
launches the hand-written kernel (which raises rather than fall back), on
a CPU tensor it runs the kernel's plain PyTorch version. A metric that has
no kernel runs its plain version, or the generic ``cdist`` path, on either
device.

The distance-kernel API (``pairwise_sqdist``, ``pairwise_hamming``,
``eps_count``, and the row-aligned ``rowwise_sqdist`` and
``rowwise_hamming``) takes numpy arrays or tensors: a tensor stays where it
is unless ``device`` says otherwise, and a numpy array goes to ``device``,
by default the CUDA card. The reference's ``pallas_mode`` (compiled,
interpret or pure-jnp) has no counterpart: the tensor's device decides.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ref
from .bits_epilogue import (NOCOL, SENTINEL, bits_to_cols_cuda,
                            bits_to_cols_ref, leaf_range_pack_cuda,
                            leaf_range_pack_ref)
from .eps_count import eps_count_cuda, eps_count_plain
from .nng_tile import (GBIG, ghost_hit, grouped_hit, pack_words, popcount32,
                       unpack_words)
from .pairwise_hamming import pairwise_hamming_cuda
from .pairwise_l2 import pairwise_sqdist_cuda
from .tree_frontier import _frontier_masks_float


def _resolve_metric(metric):
    """str | Metric -> the registry Metric (lazy import: the registry in
    ``repro_torch.core.metrics`` imports this package's kernels)."""
    from repro_torch.core.metrics import get_metric
    return get_metric(metric)


def _pad_rows(a: torch.Tensor, mult: int, value=0):
    """Pad the leading axis up to a multiple of ``mult`` -> (padded, n)."""
    n = a.shape[0]
    rem = (-n) % mult
    if rem == 0:
        return a, n
    pad = a.new_full((rem,) + tuple(a.shape[1:]), value)
    return torch.cat([a, pad]), n


def _pad_cols(a: torch.Tensor, mult: int, value=0):
    """Pad the second axis up to a multiple of ``mult``."""
    rem = (-a.shape[1]) % mult
    if rem == 0:
        return a
    return torch.cat([a, a.new_full((a.shape[0], rem), value)], dim=1)


# ---------------------------------------------------------------------------
# the distance-kernel API
# ---------------------------------------------------------------------------

def _operand(a, device, words: bool = False) -> torch.Tensor:
    """numpy or torch -> a tensor on ``device`` (None: a tensor's own
    device, the CUDA card for numpy): fp32 (float16 and other floats
    converted by value) or, with ``words``, int32 words (uint32 taken as a
    bit view, other integers by value)."""
    if isinstance(a, np.ndarray) and a.dtype == np.uint32:
        a = a.view(np.int32)
    if device is None and not torch.is_tensor(a):
        device = "cuda"
    t = torch.as_tensor(a)
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    dev = torch.device(device) if device is not None else t.device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "or CPU tensors to run the plain versions")
    return t.to(device=dev, dtype=torch.int32 if words else torch.float32)


def _ieee_fp32():
    """The port's fp32 product guard (lazy import: ``core.metrics`` imports
    this package)."""
    from repro_torch.core.metrics import ieee_fp32
    return ieee_fp32()


def pairwise_sqdist(x, y, device=None) -> torch.Tensor:
    """Squared L2 distances: x (q, d), y (p, d) -> (q, p) fp32, the
    expansion (‖x‖² + ‖y‖²) − 2x·y clamped to >= 0, in IEEE fp32. The
    kernel on the card, ``ref.pairwise_sqdist_blas3_ref`` on the CPU."""
    x = _operand(x, device)
    y = _operand(y, x.device)
    with _ieee_fp32():
        if x.is_cuda:
            return pairwise_sqdist_cuda(x.contiguous(), y.contiguous())
        return ref.pairwise_sqdist_blas3_ref(x, y)


def pairwise_hamming(x, y, device=None) -> torch.Tensor:
    """Hamming distances between rows of packed 32-bit words: x (q, w),
    y (p, w) -> (q, p) int32, exact. The kernel on the card,
    ``ref.pairwise_hamming_ref`` on the CPU."""
    x = _operand(x, device, words=True)
    y = _operand(y, x.device, words=True)
    if x.is_cuda:
        return pairwise_hamming_cuda(x.contiguous(), y.contiguous())
    return ref.pairwise_hamming_ref(x, y)


def eps_count(x, y, eps: float, device=None) -> torch.Tensor:
    """Per-query L2 ε-counts against y: (q,) int32 counts of the fp32
    expansion's d² <= ``eps2_f32(eps)``, fused (no (q, p) matrix in device
    memory). The kernel on the card, ``eps_count_plain`` on the CPU."""
    x = _operand(x, device)
    y = _operand(y, x.device)
    with _ieee_fp32():
        if x.is_cuda:
            return eps_count_cuda(x.contiguous(), y.contiguous(), eps)
        return eps_count_plain(x, y, eps)


def rowwise_sqdist(x, y, device=None) -> torch.Tensor:
    """Row-aligned squared L2: x (n, d), y (n, d) -> (n,) fp32."""
    x = _operand(x, device)
    diff = x - _operand(y, x.device)
    return (diff * diff).sum(-1)


def rowwise_hamming(x, y, device=None) -> torch.Tensor:
    """Row-aligned Hamming over packed words: x (n, w), y (n, w) -> (n,)
    int32."""
    x = _operand(x, device, words=True)
    return popcount32(x ^ _operand(y, x.device, words=True)).sum(
        -1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the engines' tiles
# ---------------------------------------------------------------------------

def nng_tile_bits(x, y, y_valid, eps: float, metric="euclidean"):
    """Fused ε-NNG tile: (cnt (q,) int32, bits (q, ceil(p/32)) int32 words).

    cnt[i] = |{j : y_valid[j] and d(x_i, y_j) <= eps}|; bits packs the hit
    mask little-endian (column j -> word j // 32, bit j % 32), and bits
    past column p - 1 are zero. ``metric`` is a registry name or ``Metric``;
    a metric with neither kernel nor plain tile runs the generic path over
    ``metric.cdist`` (slower, same edge set)."""
    met = _resolve_metric(metric)
    p = y.shape[0]
    nw = -(-p // 32)
    yv = torch.as_tensor(y_valid, dtype=torch.int32, device=x.device)
    x = x.to(met.dtype)
    y = y.to(met.dtype)
    if x.is_cuda and met.tile_kernel is not None:
        return met.tile_kernel(x.contiguous(), y.contiguous(),
                               yv.contiguous(), eps)
    if met.tile_ref is not None:
        yp, _ = _pad_rows(y, 32)
        yvp, _ = _pad_rows(yv, 32)
        cnt, bits = met.tile_ref(x, yp, yvp, eps)
        return cnt, bits[:, :nw]
    hit = (met.cdist(x, y) <= met.comparable(eps)) & (yv != 0)[None, :]
    cnt = hit.sum(1, dtype=torch.int32)
    return cnt, pack_words(_pad_cols(hit, 32, False))


def nng_tile_bits_pair(x, y, eps: float, metric="euclidean"):
    """Forward + mirror ε-tiles of one ring round, every row valid:
    ``(fcnt, fbits, rcnt, rbits)`` = ``nng_tile_bits(x, y)`` and
    ``nng_tile_bits(y, x)``. The tree flavour's "points" rounds use it."""
    fcnt, fbits = nng_tile_bits(
        x, y, torch.ones(y.shape[0], dtype=torch.int32, device=x.device),
        eps, metric=metric)
    rcnt, rbits = nng_tile_bits(
        y, x, torch.ones(x.shape[0], dtype=torch.int32, device=x.device),
        eps, metric=metric)
    return fcnt, fbits, rcnt, rbits


def grouped_block_active(x_group, y_group, tq: int, tp: int):
    """The block-skip rule of the grouped tiles at a (tq, tp) block shape:
    each block's valid-group (>= 0) [min, max] ranges on both sides, and a
    (nqb, npb) bool map of the blocks whose ranges intersect. At the
    reference's geometry (``nng_tile_geometry``) it is the reference's own
    schedule, so it gives the tiles_scheduled / tiles_skipped counters.
    Rows are tile-padded (group -1) by the caller."""
    q = x_group.shape[0]
    p = y_group.shape[0]
    assert q % tq == 0 and p % tp == 0, (q, tq, p, tp)
    xg = x_group.reshape(q // tq, tq)
    yg = y_group.reshape(p // tp, tp)
    xmin = torch.where(xg >= 0, xg, GBIG).amin(1)
    xmax = torch.where(xg >= 0, xg, -1).amax(1)
    ymin = torch.where(yg >= 0, yg, GBIG).amin(1)
    ymax = torch.where(yg >= 0, yg, -1).amax(1)
    return ((xmin[:, None] <= ymax[None, :])
            & (ymin[None, :] <= xmax[:, None]))


def nng_tile_geometry(q: int, p: int, metric) -> tuple[int, int]:
    """The (tq, tp) block shape of a (q, p) tile in the reference's
    geometry (``Metric.tile_shape``): the unit of the landmark engine's
    tile counters. The CUDA kernels use their own 128 x 128 blocks."""
    return _resolve_metric(metric).tile_shape(q, p)


def nng_tile_bits_grouped(x, y, x_group, y_group, x_ids, y_ids, eps: float,
                          metric="euclidean"):
    """Group-aware fused ε-tile of the landmark engine.

    hit(i, j) = d(x_i, y_j) <= eps and x_group[i] == y_group[j] >= 0 and
    x_ids[i] != y_ids[j]. Returns (cnt (q,) int32, bits (q, ceil(p/32))
    int32 words, tiles_scheduled, tiles_skipped): the counters are 0-d
    int64 tensors, the reference's block schedule at its own geometry
    (``grouped_block_active``). Callers cell-sort rows so that whole blocks
    skip; the result never depends on the row order.

    The metric's grouped kernel on a CUDA tensor, its plain version on a
    CPU one; a metric with neither runs the generic path over
    ``metric.cdist``."""
    met = _resolve_metric(metric)
    q = x.shape[0]
    p = y.shape[0]
    nw = -(-p // 32)
    dev = x.device
    xg, yg, xid, yid = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                        for a in (x_group, y_group, x_ids, y_ids))
    tq, tp = met.tile_shape(q, p)
    active = grouped_block_active(_pad_rows(xg, tq, -1)[0],
                                  _pad_rows(yg, tp, -1)[0], tq, tp)
    scheduled = torch.tensor(active.numel(), device=dev)
    skipped = scheduled - active.sum()
    x = x.to(met.dtype)
    y = y.to(met.dtype)
    if x.is_cuda and met.grouped_kernel is not None:
        cnt, bits = met.grouped_kernel(
            x.contiguous(), y.contiguous(), xg.contiguous(), yg.contiguous(),
            xid.contiguous(), yid.contiguous(), eps)
    elif met.grouped_ref is not None:
        yp, ygp, yidp = (_pad_rows(a, 32, v)[0]
                         for a, v in ((y, 0), (yg, -1), (yid, -1)))
        cnt, bits = met.grouped_ref(x, yp, xg, ygp, xid, yidp, eps)
        bits = bits[:, :nw]
    else:
        hit = grouped_hit(met.cdist(x, y) <= met.comparable(eps), xg, yg,
                          xid, yid)
        cnt = hit.sum(1, dtype=torch.int32)
        bits = pack_words(_pad_cols(hit, 32, False))
    return cnt, bits, scheduled, skipped


def ghost_block_active(x_gbits, y_group, tq: int, tp: int):
    """The block-skip rule of the ghost tiles at a (tq, tp) block shape: a
    block is live iff some row of it has a ghost bit (``x_gbits`` (q, mw)
    int32 words) inside the valid cells' (>= 0) [min, max] range of its y
    rows. Returns the (nqb, npb) bool map; at the reference's geometry
    (``nng_tile_geometry``) it is the reference's own schedule
    (``ghost_block_active`` there), so it gives the ghost ring's
    tiles_scheduled / tiles_skipped. Rows are tile-padded by the caller
    (zero words, group -1)."""
    q = x_gbits.shape[0]
    p = y_group.shape[0]
    assert q % tq == 0 and p % tp == 0, (q, tq, p, tp)
    xb = unpack_words(x_gbits)                           # (q, mw * 32)
    xany = xb.reshape(q // tq, tq, -1).any(1)            # (nqb, m_pad)
    # ghost bits of each row block at or below each cell: a prefix count
    # answers "any bit in [ymin, ymax]" for every y block at once
    pre = torch.nn.functional.pad(xany.to(torch.int32).cumsum(1), (1, 0))
    yg = y_group.reshape(p // tp, tp)
    ymin = torch.where(yg >= 0, yg, GBIG).amin(1)
    ymax = torch.where(yg >= 0, yg, -1).amax(1)
    ok = ymin <= ymax
    lo = torch.where(ok, ymin, 0).long()
    hi = torch.where(ok, ymax + 1, 0).long()
    return (pre[:, hi] - pre[:, lo] > 0) & ok[None, :]


def nng_tile_bits_ghost(x, y, x_gbits, y_group, eps: float,
                        metric="euclidean"):
    """Ghost-aware fused ε-tile of the landmark engine's ghost ring.

    hit(i, j) = d(x_i, y_j) <= eps and y_group[j] >= 0 and bit y_group[j]
    of x_gbits[i] is set: the slacked Lemma-1 test travels with the
    visiting block as packed per-row cell words ((q, ceil(m/32)) int32, the
    ``pack_words`` layout) instead of ghost copies. A row's own cell bit is
    never set, so same-cell (and self) pairs are excluded without an id
    test. Returns (cnt (q,) int32, bits (q, ceil(p/32)) int32 words,
    tiles_scheduled, tiles_skipped): the counters are 0-d int64 tensors,
    the reference's block schedule at its own geometry
    (``ghost_block_active``). Callers cell-sort y so that whole blocks
    skip; the result never depends on the row order.

    The metric's ghost kernel on a CUDA tensor, its plain version on a CPU
    one; a metric with neither runs the generic path over
    ``metric.cdist``."""
    met = _resolve_metric(metric)
    q = x.shape[0]
    p = y.shape[0]
    nw = -(-p // 32)
    dev = x.device
    gb = torch.as_tensor(x_gbits, dtype=torch.int32, device=dev)
    yg = torch.as_tensor(y_group, dtype=torch.int32, device=dev)
    tq, tp = met.tile_shape(q, p)
    active = ghost_block_active(_pad_rows(gb, tq)[0],
                                _pad_rows(yg, tp, -1)[0], tq, tp)
    scheduled = torch.tensor(active.numel(), device=dev)
    skipped = scheduled - active.sum()
    x = x.to(met.dtype)
    y = y.to(met.dtype)
    if x.is_cuda and met.ghost_kernel is not None:
        cnt, bits = met.ghost_kernel(x.contiguous(), y.contiguous(),
                                     gb.contiguous(), yg.contiguous(), eps)
    elif met.ghost_ref is not None:
        yp, ygp = (_pad_rows(a, 32, v)[0] for a, v in ((y, 0), (yg, -1)))
        cnt, bits = met.ghost_ref(x, yp, gb, ygp, eps)
        bits = bits[:, :nw]
    else:
        hit = ghost_hit(met.cdist(x, y) <= met.comparable(eps), gb, yg)
        cnt = hit.sum(1, dtype=torch.int32)
        bits = pack_words(_pad_cols(hit, 32, False))
    return cnt, bits, scheduled, skipped


def tree_frontier_step(q, c, rad, leaf, act_bits, eps: float,
                       metric="euclidean"):
    """One level of the batched cover-tree traversal, fused.

    q (nq, d) queries; c (N, d) level-node coords; rad (N,) fp32 radii;
    leaf (N,) int32 leaf flags; act_bits (nq, ceil(N/32)) int32 packed
    active mask. Returns (emit_bits, expand_bits), each (nq, ceil(N/32))
    int32: nodes whose DFS leaf range joins the query's neighbour set, and
    nodes whose children enter the next level's frontier (the rules and the
    fp32 slack are in ``repro_torch.kernels.tree_frontier``). Node-axis
    padding up to a multiple of 32 is inactive and emits nothing.

    A metric with a frontier kernel launches it on a CUDA tensor and runs
    its plain version on a CPU one; a metric with neither runs the generic
    path: true distances over ``metric.cdist`` and the shared float
    decision epilogue (conservative slack, exact at the leaves)."""
    met = _resolve_metric(metric)
    n = c.shape[0]
    nw = -(-n // 32)
    rad = torch.as_tensor(rad, dtype=torch.float32, device=q.device)
    leaf = torch.as_tensor(leaf, dtype=torch.int32, device=q.device)
    act_bits = torch.as_tensor(act_bits, dtype=torch.int32, device=q.device)
    assert act_bits.shape == (q.shape[0], nw), (act_bits.shape, n)
    q = q.to(met.dtype)
    c = c.to(met.dtype)
    if q.is_cuda and met.frontier_kernel is not None:
        return met.frontier_kernel(q.contiguous(), c.contiguous(),
                                   rad.contiguous(), leaf.contiguous(),
                                   act_bits.contiguous(), eps)
    if n % 32:
        # pad nodes are inactive: zero their bits in the last word
        keep = pack_words(_pad_cols(torch.ones((1, n), dtype=torch.bool,
                                               device=q.device), 32, False))
        act_bits = act_bits & keep
        c, _ = _pad_rows(c, 32)
        rad, _ = _pad_rows(rad, 32)
        leaf, _ = _pad_rows(leaf, 32)
    if met.frontier_ref is not None:
        return met.frontier_ref(q, c, rad, leaf, act_bits, eps)
    active = unpack_words(act_bits)
    d = met.true(met.cdist(q, c))
    emit, expand = _frontier_masks_float(d, rad, leaf, active, eps)
    return pack_words(emit), pack_words(expand)


def bits_to_cols(bits, k: int) -> torch.Tensor:
    """(m, W) int32 hit words -> (m, k) int32: each row's k lowest set
    column indices, ascending, ``NOCOL``-padded. The kernel on a CUDA
    tensor, the plain version on a CPU one; the two are bit-identical."""
    if bits.is_cuda:
        return bits_to_cols_cuda(bits.contiguous(), k)
    return bits_to_cols_ref(bits, k)


def bits_to_ids(bits, id0: int, k: int) -> torch.Tensor:
    """Hit words over a CONTIGUOUS id block starting at ``id0`` -> (m, k)
    int32 neighbour ids, ascending, SENTINEL-padded."""
    cols = bits_to_cols(bits, k)
    return torch.where(cols < NOCOL, cols + id0,
                       torch.full_like(cols, SENTINEL))


def bits_to_gathered_ids(bits, ids_row, k: int) -> torch.Tensor:
    """Hit words whose columns index an arbitrary id row -> (m, k) int32
    neighbour ids, ascending, SENTINEL-padded. The gather can permute id
    order, so a small (m, k) sort restores it — k, not the tile width."""
    cols = bits_to_cols(bits, k)
    p = ids_row.shape[0]
    ids = torch.where(cols < p, ids_row[torch.clamp_max(cols, p - 1)],
                      torch.full_like(cols, SENTINEL))
    return torch.sort(ids, dim=-1).values


def leaf_range_pack(delta, leaf_ids, qids):
    """Tree-traversal leaf epilogue: ±1 range deltas over DFS leaf slots ->
    (cnt (nq,), bits (nq, NL/32) int32) packed cover mask, with leaf-slot
    validity and structural self-pair exclusion applied. ``delta`` may
    carry trailing overflow columns (the traversal scatters hi = NL
    there); only the first ``len(leaf_ids)`` columns take part.
    ``len(leaf_ids)`` % 32 == 0 (the flat-tree padding invariant). The
    kernel on CUDA tensors, the plain version on CPU ones; the two are
    bit-identical."""
    nl = leaf_ids.shape[0]
    assert nl % 32 == 0, nl
    if delta.is_cuda:
        return leaf_range_pack_cuda(delta, leaf_ids.contiguous(),
                                    qids.contiguous())
    return leaf_range_pack_ref(delta[:, :nl], leaf_ids, qids)
