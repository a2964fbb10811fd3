"""Dense pairwise squared L2 distances on the card.

``pairwise_sqdist_cuda`` (``csrc/pairwise_sqdist.cu``) is the hand-written
CUDA kernel that replaces the reference's ``pairwise_sqdist_pallas``: for
x (q, d) and y (p, d) fp32 it writes the (q, p) fp32 matrix
max((‖x‖² + ‖y‖²) − 2x·y, 0). Its plain version is
``ref.pairwise_sqdist_blas3_ref``, the same expansion summed in torch's
order.

The kernel runs on the pipelined core of ``nng_tile`` (``l2_pipe.cuh``),
so its d² are the values that tile thresholds. The TPU kernel's
512-feature steps, which added each step's partial norms after its
product, are not carried over: for d <= 512 the two agree up to the order
of the product's and the norms' sums, and past 512 the partial norms
round differently too. Either way two evaluations of an element differ by
at most about 2·(d + 2)·u·(‖x‖² + ‖y‖²), u = 2⁻²⁴.

``l2_chain_d2_cuda`` (``csrc/l2_chain.cu``) is the anchor the tests and
``chip_smoke.py`` hold the L2 cores to: a plain kernel that computes each
pair's d² as one fp32 ``fmaf`` chain, the arithmetic that
``csrc/l2_pipe.cuh`` promises, so every kernel on that core must agree
with it bit for bit. No engine or public call runs it.
"""
from __future__ import annotations

import torch

from . import _build
from .nng_tile import check_operands, row_norm_scratch, sm_count


def pairwise_sqdist_cuda(x, y) -> torch.Tensor:
    """The CUDA kernel: x (q, d), y (p, d) contiguous fp32 on one CUDA
    device -> (q, p) fp32 squared distances, clamped to >= 0. Any q, p
    and d, and any 4-byte aligned x and y: the kernel masks ragged edges.
    One launch of a persistent grid (``csrc/l2_pipe.cuh``) for any q."""
    check_operands("pairwise_sqdist_cuda", ("x", x, torch.float32, 2),
                   ("y", y, torch.float32, 2))
    (q, d), p = x.shape, y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"pairwise_sqdist_cuda: shapes x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}")
    out = torch.empty((q, p), dtype=torch.float32, device=x.device)
    if q == 0 or p == 0:
        return out
    launch = _build.entry("pairwise_sqdist")
    xsq, ysq = row_norm_scratch(q, p, x.device)
    with torch.cuda.device(x.device):
        code = launch(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                      xsq.data_ptr(), ysq.data_ptr(), q, p, d,
                      sm_count(x.device.index),
                      torch.cuda.current_stream().cuda_stream)
    _build.check("pairwise_sqdist", code)
    pairwise_sqdist_cuda.launches += 1
    return out


def l2_chain_d2_cuda(x, y) -> torch.Tensor:
    """The plain fp32 chain kernel, a test and smoke anchor (no engine or
    public API calls it): x (q, d), y (p, d) contiguous fp32 on one CUDA
    device -> (q, p) fp32 d², unclamped: each row norm one ``fmaf(v, v,
    .)`` chain and each product one ``fmaf`` chain over k = 0 .. d - 1
    ascending from 0, d² = (‖x‖² + ‖y‖²) − 2x·y (``l2tile::d2``). The
    kernels on ``csrc/l2_pipe.cuh`` compute the same d² bit for bit."""
    check_operands("l2_chain_d2_cuda", ("x", x, torch.float32, 2),
                   ("y", y, torch.float32, 2))
    (q, d), p = x.shape, y.shape[0]
    if y.shape[1] != d:
        raise ValueError(f"l2_chain_d2_cuda: shapes x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}")
    out = torch.empty((q, p), dtype=torch.float32, device=x.device)
    if q == 0 or p == 0:
        return out
    launch = _build.entry("l2_chain")
    xn, yn = row_norm_scratch(q, p, x.device)
    with torch.cuda.device(x.device):
        code = launch(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                      xn.data_ptr(), yn.data_ptr(), q, p, d,
                      torch.cuda.current_stream().cuda_stream)
    _build.check("l2_chain", code)
    l2_chain_d2_cuda.launches += 1
    return out


pairwise_sqdist_cuda.launches = 0
l2_chain_d2_cuda.launches = 0
