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
only (a (128 × 128) block with no active pair skips its distances) and its
plain PyTorch version, with the distances of the metric's ε-tile
(``nng_tile``), so a leaf's test is the tile's own:

  - L2: ``tree_frontier_cuda`` (``csrc/tree_frontier.cu``) /
    ``tree_frontier_ref``;
  - Hamming: ``tree_frontier_hamming_cuda`` (``csrc/tree_frontier_hamming.cu``)
    / ``tree_frontier_hamming_ref``;
  - L1: ``tree_frontier_l1_cuda`` (``csrc/tree_frontier_l1.cu``) /
    ``tree_frontier_l1_ref``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .nng_tile import (check_operands, eps2_f32, eps_int, hamming_dist,
                       l1_dist, pack_words, unpack_words)

TQ = TN = 128        # the kernel's block: query rows × level nodes


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


def _launch_frontier(lib: str, q, c, rad, leaf, act_bits, dtype, *thr):
    """Check the operands of frontier kernel ``lib`` and launch it with
    thresholds ``thr`` -> (emit, expand, launched)."""
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
    emit = torch.empty((nq, nw), dtype=torch.int32, device=q.device)
    expand = torch.empty_like(emit)
    if nq == 0 or nw == 0:
        return emit, expand, False
    launch = _build.entry(lib)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(q.data_ptr(), c.data_ptr(), rad.data_ptr(),
                      leaf.data_ptr(), act_bits.data_ptr(), emit.data_ptr(),
                      expand.data_ptr(), nq, n, d, *thr, stream)
    _build.check(lib, code)
    return emit, expand, True


def tree_frontier_cuda(q, c, rad, leaf, act_bits, eps: float):
    """The L2 CUDA kernel: q (nq, d), c (N, d), rad (N,) fp32, leaf (N,)
    int32, act_bits (nq, ceil(N/32)) int32, all contiguous on one CUDA
    device -> (emit, expand), each (nq, ceil(N/32)) int32. Any nq, N and d:
    the kernel masks ragged edges, and nodes past N - 1 are never active."""
    emit, expand, launched = _launch_frontier(
        "tree_frontier", q, c, rad, leaf, act_bits, torch.float32,
        float(np.float32(eps)), eps2_f32(eps))
    tree_frontier_cuda.launches += launched
    return emit, expand


def tree_frontier_hamming_cuda(q, c, rad, leaf, act_bits, eps: float):
    """The Hamming CUDA kernel: q (nq, w), c (N, w) int32 words, the rest
    as ``tree_frontier_cuda``."""
    emit, expand, launched = _launch_frontier(
        "tree_frontier_hamming", q, c, rad, leaf, act_bits, torch.int32,
        eps_int(eps))
    tree_frontier_hamming_cuda.launches += launched
    return emit, expand


def tree_frontier_l1_cuda(q, c, rad, leaf, act_bits, eps: float):
    """The L1 CUDA kernel: q (nq, d), c (N, d) fp32, the rest as
    ``tree_frontier_cuda``."""
    emit, expand, launched = _launch_frontier(
        "tree_frontier_l1", q, c, rad, leaf, act_bits, torch.float32,
        float(np.float32(eps)))
    tree_frontier_l1_cuda.launches += launched
    return emit, expand


tree_frontier_cuda.launches = 0
tree_frontier_hamming_cuda.launches = 0
tree_frontier_l1_cuda.launches = 0
