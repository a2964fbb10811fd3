"""Device-dispatching wrappers around the tile kernels.

Each wrapper follows the device of its tensors: on a CUDA tensor it
launches the hand-written kernel (which raises rather than fall back), on
a CPU tensor it runs the kernel's plain PyTorch version. A metric that has
no kernel runs its plain version, or the generic ``cdist`` path, on either
device.
"""
from __future__ import annotations

import torch

from .bits_epilogue import (NOCOL, SENTINEL, bits_to_cols_cuda,
                            bits_to_cols_ref, leaf_range_pack_cuda,
                            leaf_range_pack_ref)
from .nng_tile import pack_words, unpack_words
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
