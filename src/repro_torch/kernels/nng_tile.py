"""Fused ε-NNG tile: fp32 L2 distances, threshold and bit-packed adjacency.

The systolic ring evaluates each (local × visiting) block pair through this
tile. It returns

  - cnt  (q,)          exact per-row ε-neighbour counts, int32,
  - bits (q, p / 32)   the hit mask packed 32 columns per word,

and the fp32 distance tile never reaches device memory on the kernel path.

Words are int32 tensors holding the uint32 bit pattern (column j is word
j // 32, bit j % 32, little-endian), because torch's uint32 lacks shifts.

``nng_tile_cuda`` launches the hand-written kernel in ``csrc/nng_tile.cu``
and takes CUDA tensors only; ``nng_tile_ref`` is its plain PyTorch version
with the same ‖x‖² + ‖y‖² − 2x·y expansion and threshold.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

# bit b of a word as an int32 (bit 31 is the sign bit)
_BIT = torch.from_numpy(
    (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32))


def eps2_f32(eps: float) -> float:
    """The canonical L2 threshold: eps rounded to fp32, squared in fp32.
    Every tile path embeds this value, so a pair whose fp32 d² lands on
    the threshold classifies the same way on all of them."""
    return float(np.float32(eps) ** 2)


def pack_words(hit: torch.Tensor) -> torch.Tensor:
    """(q, p) bool, p % 32 == 0 -> (q, p / 32) int32 words, little-endian
    (column j lands in word j // 32, bit j % 32)."""
    q, p = hit.shape
    assert p % 32 == 0, p
    bit = _BIT.to(device=hit.device, dtype=torch.int64)
    s = (hit.reshape(q, p // 32, 32).to(torch.int64) * bit).sum(-1)
    # s is the unsigned word in [0, 2^32); fold into int32's range exactly
    return (s - ((s >> 31) << 32)).to(torch.int32)


def unpack_words(bits: torch.Tensor) -> torch.Tensor:
    """(q, W) int32 words -> (q, 32 W) bool, the inverse of ``pack_words``."""
    bit = _BIT.to(bits.device)
    return ((bits[:, :, None] & bit) != 0).reshape(bits.shape[0], -1)


def nng_tile_ref(x, y, y_valid, eps: float):
    """Plain PyTorch version: x (q, d), y (p, d), y_valid (p,) with
    p % 32 == 0 -> (cnt (q,) int32, bits (q, p / 32) int32)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    d2 = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
          - 2.0 * x @ y.T)
    hit = (d2 <= eps2_f32(eps)) & (y_valid != 0)[None, :]
    cnt = hit.sum(1, dtype=torch.int32)
    return cnt, pack_words(hit)


def nng_tile_cuda(x, y, y_valid, eps: float):
    """The CUDA kernel: x (q, d), y (p, d) fp32, y_valid (p,) int32, all
    contiguous on one CUDA device -> (cnt (q,) int32, bits (q, ceil(p/32))
    int32). Any q, p and d: the kernel masks ragged edges, and bits past
    column p - 1 are zero."""
    for name, t, dt, nd in (("x", x, torch.float32, 2), ("y", y, torch.float32, 2),
                            ("y_valid", y_valid, torch.int32, 1)):
        if not t.is_cuda:
            raise ValueError(f"nng_tile_cuda: {name} must be a CUDA tensor "
                             f"(got {t.device})")
        if t.dtype != dt or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"nng_tile_cuda: {name} must be a contiguous "
                             f"{nd}-d {dt} tensor (got {t.dtype}, "
                             f"shape {tuple(t.shape)})")
    q, d = x.shape
    p = y.shape[0]
    if y.shape[1] != d or y_valid.shape[0] != p:
        raise ValueError(f"nng_tile_cuda: shapes x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}, y_valid {tuple(y_valid.shape)}")
    if not (x.device == y.device == y_valid.device):
        raise ValueError("nng_tile_cuda: operands on different devices")
    nw = -(-p // 32)
    cnt = torch.zeros(q, dtype=torch.int32, device=x.device)
    bits = torch.empty((q, nw), dtype=torch.int32, device=x.device)
    if q == 0 or p == 0:
        bits.zero_()
        return cnt, bits
    launch = _build.entry("nng_tile")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(x.data_ptr(), y.data_ptr(), y_valid.data_ptr(),
                      cnt.data_ptr(), bits.data_ptr(), q, p, d,
                      eps2_f32(eps), stream)
    _build.check("nng_tile", code)
    nng_tile_cuda.launches += 1
    return cnt, bits


nng_tile_cuda.launches = 0
