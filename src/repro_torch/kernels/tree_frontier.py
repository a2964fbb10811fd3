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
gates everything.

Words are int32 tensors holding the uint32 bit pattern (node j is word
j // 32, bit j % 32), as in ``nng_tile``.

``tree_frontier_cuda`` launches the hand-written kernel in
``csrc/tree_frontier.cu`` and takes CUDA tensors only; a (128 × 128) block
with no active pair skips its distances. ``tree_frontier_ref`` is its plain
PyTorch version.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .nng_tile import eps2_f32, pack_words, unpack_words

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


def tree_frontier_cuda(q, c, rad, leaf, act_bits, eps: float):
    """The CUDA kernel: q (nq, d), c (N, d), rad (N,) fp32, leaf (N,) int32,
    act_bits (nq, ceil(N/32)) int32, all contiguous on one CUDA device ->
    (emit, expand), each (nq, ceil(N/32)) int32. Any nq, N and d: the kernel
    masks ragged edges, and nodes past N - 1 are never active."""
    for name, t, dt, nd in (("q", q, torch.float32, 2),
                            ("c", c, torch.float32, 2),
                            ("rad", rad, torch.float32, 1),
                            ("leaf", leaf, torch.int32, 1),
                            ("act_bits", act_bits, torch.int32, 2)):
        if not t.is_cuda:
            raise ValueError(f"tree_frontier_cuda: {name} must be a CUDA "
                             f"tensor (got {t.device})")
        if t.dtype != dt or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"tree_frontier_cuda: {name} must be a "
                             f"contiguous {nd}-d {dt} tensor (got {t.dtype}, "
                             f"shape {tuple(t.shape)})")
    nq, d = q.shape
    n = c.shape[0]
    nw = -(-n // 32)
    if (c.shape[1] != d or rad.shape[0] != n or leaf.shape[0] != n
            or act_bits.shape != (nq, nw)):
        raise ValueError(f"tree_frontier_cuda: shapes q {tuple(q.shape)}, "
                         f"c {tuple(c.shape)}, rad {tuple(rad.shape)}, "
                         f"leaf {tuple(leaf.shape)}, act_bits "
                         f"{tuple(act_bits.shape)}")
    if len({t.device for t in (q, c, rad, leaf, act_bits)}) != 1:
        raise ValueError("tree_frontier_cuda: operands on different devices")
    emit = torch.empty((nq, nw), dtype=torch.int32, device=q.device)
    expand = torch.empty_like(emit)
    if nq == 0 or nw == 0:
        return emit, expand
    launch = _build.entry("tree_frontier")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(q.data_ptr(), c.data_ptr(), rad.data_ptr(),
                      leaf.data_ptr(), act_bits.data_ptr(), emit.data_ptr(),
                      expand.data_ptr(), nq, n, d, float(np.float32(eps)),
                      eps2_f32(eps), stream)
    _build.check("tree_frontier", code)
    tree_frontier_cuda.launches += 1
    return emit, expand


tree_frontier_cuda.launches = 0
