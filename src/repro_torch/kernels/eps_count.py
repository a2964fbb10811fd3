"""Fused L2 ε-counts on the card.

``eps_count_cuda`` (``csrc/eps_count.cu``) is the hand-written CUDA kernel
that replaces the reference's ``eps_count_pallas``: for x (q, d) and
y (p, d) fp32 it counts, per query row, the y rows with
(‖x‖² + ‖y‖²) − 2x·y <= ``eps2_f32(eps)``, and never writes the (q, p)
distances out. It is ``nng_tile``'s L2 tile with no words stored, on the
same pipelined core (``csrc/l2_pipe.cuh``), so its counts equal
``nng_tile_cuda(x, y, ones, eps)``'s ``cnt`` bit for bit, the row sums of
``pairwise_sqdist_cuda(x, y) <= eps2_f32(eps)`` (the same core) and those
of the plain chain anchor's ``l2_chain_d2_cuda(x, y) <= eps2_f32(eps)``.

Its plain version, ``eps_count_plain``, is the same expansion
(``nng_tile_ref``'s arithmetic, counts only). The direct-form oracle
``ref.eps_count_ref`` agrees with both off the knife edge of eps.
"""
from __future__ import annotations

import torch

from . import _build
from .nng_tile import check_operands, eps2_f32, row_norm_scratch, sm_count

# elements of the plain version's (rows, p) d² per row chunk
_TILE = 1 << 28


def eps_count_plain(x, y, eps: float) -> torch.Tensor:
    """Plain PyTorch version: x (q, d), y (p, d) -> (q,) int32 counts of
    the fp32 expansion's d² <= eps2_f32(eps), in row chunks that keep the
    (rows, p) d² near ``_TILE`` elements."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    e2 = eps2_f32(eps)
    yn = (y * y).sum(1)[None, :]
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    step = max(1, _TILE // max(y.shape[0], 1))
    for i in range(0, x.shape[0], step):
        xs = x[i:i + step]
        d2 = (xs * xs).sum(1)[:, None] + yn - 2.0 * xs @ y.T
        out[i:i + step] = (d2 <= e2).sum(1, dtype=torch.int32)
    return out


def eps_count_cuda(x, y, eps: float) -> torch.Tensor:
    """The CUDA kernel: x (q, d), y (p, d) contiguous fp32 on one CUDA
    device -> (q,) int32 counts. Any q, p and d, and any 4-byte aligned x
    and y: the kernel masks the ragged edge itself, so no y_mask operand is
    needed. One launch of a persistent grid (``csrc/l2_pipe.cuh``) for any
    q."""
    check_operands("eps_count_cuda", ("x", x, torch.float32, 2),
                   ("y", y, torch.float32, 2))
    (q, d), p = x.shape, y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"eps_count_cuda: shapes x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}")
    cnt = torch.zeros(q, dtype=torch.int32, device=x.device)
    if q == 0 or p == 0:
        return cnt
    launch = _build.entry("eps_count")
    xsq, ysq = row_norm_scratch(q, p, x.device)
    with torch.cuda.device(x.device):
        code = launch(x.data_ptr(), y.data_ptr(), cnt.data_ptr(),
                      xsq.data_ptr(), ysq.data_ptr(), q, p, d,
                      eps2_f32(eps), sm_count(x.device.index),
                      torch.cuda.current_stream().cuda_stream)
    _build.check("eps_count", code)
    eps_count_cuda.launches += 1
    return cnt


eps_count_cuda.launches = 0
