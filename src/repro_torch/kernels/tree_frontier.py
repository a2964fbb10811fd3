"""Level-synchronous cover-tree frontier: one traversal level, fused.

One level of the batched cover-tree query (Alg. 3) is a dense (queries ×
level nodes) decision tile. The kernel fuses the distance with the per-pair
decisions and returns only two packed survivor bitmasks:

  emit[q, v]    the node's whole DFS leaf range joins q's neighbour set:
                  leaf node:     d(q, v) <= eps   (exact: d² <= eps², the
                                 fused tile's own fp32 arithmetic and test)
                  internal node: d(q, v) + radius(v) <= eps - slack
                                 (full inclusion, shrunk by a scale-relative
                                 fp32 slack; a borderline inclusion demotes
                                 to expansion and is decided at the leaves)
  expand[q, v]  the node's children enter the next level's frontier:
                  d(q, v) <= radius(v) + eps + slack   (triangle prune;
                                 over-expansion is always safe)

with slack = (d + radius + eps)·1e-5 + 1e-6. ``active`` (packed, built by
the traversal from the previous level's expand mask and the cell scope)
gates everything. Hamming distances are exact integers: the thresholds
are integers (``int(eps)``, radii truncated to int32) and both slacks are
zero, so every decision is exact at every level.

Words are int32 tensors holding the uint32 bit pattern (node j is word
j // 32, bit j % 32), as in ``nng_tile``.

Three metrics, each a hand-written CUDA kernel that takes CUDA tensors
only and its plain PyTorch version, with the distances of the metric's
ε-tile (``nng_tile``), so a leaf's test is the tile's own:

  - L2: ``tree_frontier_cuda`` (``csrc/tree_frontier.cu`` on the pipelined
    core ``csrc/l2_pipe.cuh``) / ``tree_frontier_ref``;
  - Hamming: ``tree_frontier_hamming_cuda``
    (``csrc/tree_frontier_hamming.cu`` on ``csrc/hamming_pipe.cuh``)
    / ``tree_frontier_hamming_ref``;
  - L1: ``tree_frontier_l1_cuda`` (``csrc/tree_frontier_l1.cu`` on
    ``csrc/l1_pipe.cuh``) / ``tree_frontier_l1_ref``.

The three kernels compute only the live ``PIPE_TILE`` tiles, those with
an active word: a plan pass on the card lists them (no host sync) and
writes zero words for the others, by the rule of ``frontier_tile_plan``,
its plain version (``csrc/frontier_pipe.cuh``). The engine hands each
block's queries in its forest's DFS order, which makes most tiles dead.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .nng_tile import (PIPE_TILE, check_operands, eps2_f32, eps_int,
                       hamming_dist, l1_dist, live_tiles_first, pack_words,
                       row_norm_scratch, sm_count, unpack_words)

# the old one-block-a-tile frontier kernels' block (query rows × level
# nodes), which live-block counts still compare against
TQ = TN = 128


def _frontier_masks_float(d, rad, leaf, active, eps, leaf_hit=None):
    """Shared float-metric decision epilogue over TRUE distances d (q, N)
    -> (emit, expand) bool. ``leaf_hit`` overrides the leaf test when the
    caller has a sharper form (L2 compares d² with eps², no sqrt). Every
    operation rounds to fp32 in the order the kernel uses."""
    eps_f = float(np.float32(eps))
    radr = rad[None, :]
    slack = (d + radr + eps_f) * 1e-5 + 1e-6
    leafb = (leaf != 0)[None, :]
    if leaf_hit is None:
        leaf_hit = d <= eps_f
    incl = d + radr <= eps_f - slack
    emit = active & torch.where(leafb, leaf_hit, incl)
    expand = active & ~leafb & ~emit & (d <= radr + eps_f + slack)
    return emit, expand


def _frontier_masks_l2(d2, rad, leaf, active, eps):
    """L2 decision epilogue over a squared-distance tile."""
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    return _frontier_masks_float(d, rad, leaf, active, eps,
                                 leaf_hit=d2 <= eps2_f32(eps))


def _frontier_masks_hamming(d, rad, leaf, active, eps):
    """Hamming decision epilogue over exact int32 distances: integer
    thresholds, zero slack."""
    eps_i = eps_int(eps)
    radr = rad.to(torch.int32)[None, :]
    leafb = (leaf != 0)[None, :]
    incl = d + radr <= eps_i
    emit = active & torch.where(leafb, d <= eps_i, incl)
    expand = active & ~leafb & ~emit & (d <= radr + eps_i)
    return emit, expand


def tree_frontier_ref(q, c, rad, leaf, act_bits, eps: float):
    """Plain PyTorch version: q (nq, d), c (N, d), rad (N,) fp32, leaf (N,)
    int32, act_bits (nq, N/32) int32 words, N % 32 == 0 -> (emit, expand)
    (nq, N/32) int32 words. The same ‖q‖² + ‖c‖² − 2q·c expansion as
    ``nng_tile_ref``."""
    active = unpack_words(act_bits)
    x = q.to(torch.float32)
    y = c.to(torch.float32)
    d2 = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
          - 2.0 * x @ y.T)
    emit, expand = _frontier_masks_l2(d2, rad.to(torch.float32), leaf,
                                      active, eps)
    return pack_words(emit), pack_words(expand)


def tree_frontier_hamming_ref(q, c, rad, leaf, act_bits, eps: float):
    """Plain PyTorch version of the Hamming frontier: q (nq, w), c (N, w)
    int32 words, the rest as ``tree_frontier_ref``."""
    emit, expand = _frontier_masks_hamming(hamming_dist(q, c), rad, leaf,
                                           unpack_words(act_bits), eps)
    return pack_words(emit), pack_words(expand)


def tree_frontier_l1_ref(q, c, rad, leaf, act_bits, eps: float):
    """Plain PyTorch version of the L1 frontier: q (nq, d), c (N, d) fp32,
    the rest as ``tree_frontier_ref``; the leaf test is d <= fp32 eps on
    the tile's own d."""
    emit, expand = _frontier_masks_float(l1_dist(q, c), rad.to(torch.float32),
                                         leaf, unpack_words(act_bits), eps)
    return pack_words(emit), pack_words(expand)


def frontier_tile_plan(act_bits, tile_rows: int, tile_words: int):
    """The live-tile list of a frontier launch on packed active words
    act_bits (nq, nw) int32: the (tile_rows × tile_words) blocks of words,
    numbered row after row, a block live iff one of its words is nonzero
    (padding past nq and nw is zero). Returns (tiles (T,) int32, the live
    ones first, each part in ascending order; count (1,) int32, the live
    ones), on act_bits' device with no host sync. The plain version of the
    pipelined frontier kernels' plan pass (``csrc/frontier_pipe.cuh``),
    which lists the same live tiles (in the order of its atomics) at
    ``PIPE_TILE``; the tests, ``chip_smoke.py`` and ``tree_ab.py --ratios``
    count live tiles with it."""
    nq, nw = act_bits.shape
    nz = (act_bits != 0).view(torch.uint8)
    if nq % tile_rows:
        nz = torch.nn.functional.pad(nz, (0, 0, 0, -nq % tile_rows))
    rows = nz.view(-1, tile_rows, nw).amax(1)              # (mt, nw)
    if nw % tile_words:
        rows = torch.nn.functional.pad(rows, (0, -nw % tile_words))
    live = rows.view(rows.shape[0], -1, tile_words).amax(2) != 0
    return live_tiles_first(live.reshape(-1))


def _check_frontier(lib: str, q, c, rad, leaf, act_bits, dtype):
    """Check the operands of frontier kernel ``lib`` -> (nq, n, d, nw)."""
    check_operands(f"{lib}_cuda", ("q", q, dtype, 2), ("c", c, dtype, 2),
                   ("rad", rad, torch.float32, 1),
                   ("leaf", leaf, torch.int32, 1),
                   ("act_bits", act_bits, torch.int32, 2))
    nq, d = q.shape
    n = c.shape[0]
    nw = -(-n // 32)
    if (c.shape[1] != d or rad.shape[0] != n or leaf.shape[0] != n
            or act_bits.shape != (nq, nw)):
        raise ValueError(f"{lib}_cuda: shapes q {tuple(q.shape)}, "
                         f"c {tuple(c.shape)}, rad {tuple(rad.shape)}, "
                         f"leaf {tuple(leaf.shape)}, act_bits "
                         f"{tuple(act_bits.shape)}")
    return nq, n, d, nw


def _launch_pipe_frontier(lib: str, q, c, rad, leaf, act_bits, thr,
                          norms: bool, dtype=torch.float32):
    """Check the operands of pipelined frontier kernel ``lib`` (q and c of
    ``dtype``) and launch it once (its plan pass, then its walk over the
    live tiles) with thresholds ``thr``, int32 scratch for the tile list
    and its count and, with ``norms``, fp32 scratch for the rows' squared
    norms -> (emit, expand, launched)."""
    nq, n, d, nw = _check_frontier(lib, q, c, rad, leaf, act_bits, dtype)
    emit = torch.empty((nq, nw), dtype=torch.int32, device=q.device)
    expand = torch.empty_like(emit)
    if nq == 0 or nw == 0:
        return emit, expand, False
    tq, tn = PIPE_TILE
    tiles = torch.empty(-(-nq // tq) * -(-n // tn), dtype=torch.int32,
                        device=q.device)
    count = torch.empty(1, dtype=torch.int32, device=q.device)
    scratch = row_norm_scratch(nq, n, q.device) if norms else ()
    launch = _build.entry(lib)
    with torch.cuda.device(q.device):
        code = launch(q.data_ptr(), c.data_ptr(), rad.data_ptr(),
                      leaf.data_ptr(), act_bits.data_ptr(), tiles.data_ptr(),
                      count.data_ptr(), emit.data_ptr(), expand.data_ptr(),
                      *(t.data_ptr() for t in scratch), nq, n, d, *thr,
                      sm_count(q.device.index),
                      torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    return emit, expand, True


def tree_frontier_cuda(q, c, rad, leaf, act_bits, eps: float):
    """The L2 CUDA kernel: q (nq, d), c (N, d), rad (N,) fp32, leaf (N,)
    int32, act_bits (nq, ceil(N/32)) int32, all contiguous on one CUDA
    device -> (emit, expand), each (nq, ceil(N/32)) int32. Any nq, N and d:
    the kernel masks ragged edges, and nodes past N - 1 are never active.

    A plan pass and a persistent grid (``csrc/l2_pipe.cuh``) over the live
    tiles (``csrc/frontier_pipe.cuh``); a leaf's d² is ``nng_tile_cuda``'s
    bit for bit."""
    emit, expand, launched = _launch_pipe_frontier(
        "tree_frontier", q, c, rad, leaf, act_bits,
        (float(np.float32(eps)), eps2_f32(eps)), norms=True)
    tree_frontier_cuda.launches += launched
    return emit, expand


def tree_frontier_hamming_cuda(q, c, rad, leaf, act_bits, eps: float):
    """The Hamming CUDA kernel: q (nq, w), c (N, w) int32 words, the rest
    as ``tree_frontier_cuda``; one launch over the live tiles on
    ``csrc/hamming_pipe.cuh``, whose integer distances are
    ``nng_tile_hamming_cuda``'s, with the integer threshold
    ``eps_int(eps)``."""
    emit, expand, launched = _launch_pipe_frontier(
        "tree_frontier_hamming", q, c, rad, leaf, act_bits, (eps_int(eps),),
        norms=False, dtype=torch.int32)
    tree_frontier_hamming_cuda.launches += launched
    return emit, expand


def tree_frontier_l1_cuda(q, c, rad, leaf, act_bits, eps: float):
    """The L1 CUDA kernel: q (nq, d), c (N, d) fp32, the rest as
    ``tree_frontier_cuda``; one launch over the live tiles on
    ``csrc/l1_pipe.cuh``, whose d is ``nng_tile_l1_cuda``'s bit for bit."""
    emit, expand, launched = _launch_pipe_frontier(
        "tree_frontier_l1", q, c, rad, leaf, act_bits,
        (float(np.float32(eps)),), norms=False)
    tree_frontier_l1_cuda.launches += launched
    return emit, expand


tree_frontier_cuda.launches = 0
tree_frontier_hamming_cuda.launches = 0
tree_frontier_l1_cuda.launches = 0
