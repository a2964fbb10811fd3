"""Bitmask epilogue: packed hit words -> each row's lowest set columns.

``bits_to_cols``  (m, W) int32 words -> (m, k) int32: the k lowest set
    column indices of each row, ascending, ``NOCOL``-padded. The output
    slot of a set column is its rank (the count of set columns below it),
    so no value is ever sorted.

``bits_to_cols_cuda`` launches the hand-written kernel in
``csrc/bits_to_cols.cu`` and takes CUDA tensors only; ``bits_to_cols_ref``
is its plain PyTorch version. Both are deterministic functions of the
words, so they agree bit for bit on every input.
"""
from __future__ import annotations

import torch

from . import _build
from .nng_tile import unpack_words

NOCOL = 2**30        # "no more hit columns" padding
SENTINEL = 2**31 - 1  # neighbour-table padding id


def bits_to_cols_ref(bits, k: int):
    """Plain PyTorch version: (m, W) int32 words -> (m, k) int32 lowest set
    columns, ascending, NOCOL-padded. The exclusive rank of a set column
    (cumulative popcount of all lower columns) is its output slot; ranks
    >= k land in a spare slot that is cut off."""
    m = bits.shape[0]
    cols = unpack_words(bits)                          # (m, 32 W) bool
    ci = cols.to(torch.int32)
    rank = torch.cumsum(ci, dim=1, dtype=torch.int32) - ci
    slot = torch.where(cols & (rank < k), rank, k).to(torch.int64)
    col = torch.arange(cols.shape[1], dtype=torch.int32, device=bits.device)
    out = torch.full((m, k + 1), NOCOL, dtype=torch.int32, device=bits.device)
    out.scatter_(1, slot, col.expand(m, -1))
    # slot k collected every dropped column; slots < k got exactly one each
    return out[:, :k].contiguous()


def bits_to_cols_cuda(bits, k: int):
    """The CUDA kernel: (m, W) contiguous int32 words on a CUDA device ->
    (m, k) int32, the same function as ``bits_to_cols_ref``."""
    if not bits.is_cuda:
        raise ValueError(f"bits_to_cols_cuda: bits must be a CUDA tensor "
                         f"(got {bits.device})")
    if bits.dtype != torch.int32 or bits.dim() != 2 or not bits.is_contiguous():
        raise ValueError(f"bits_to_cols_cuda: bits must be a contiguous 2-d "
                         f"int32 tensor (got {bits.dtype}, "
                         f"shape {tuple(bits.shape)})")
    if k < 0:
        raise ValueError(f"bits_to_cols_cuda: k must be >= 0 (got {k})")
    m, w = bits.shape
    out = torch.empty((m, k), dtype=torch.int32, device=bits.device)
    if m == 0 or k == 0:
        return out
    launch = _build.entry("bits_to_cols")
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(bits.data_ptr(), out.data_ptr(), m, w, k, stream)
    _build.check("bits_to_cols", code)
    bits_to_cols_cuda.launches += 1
    return out


bits_to_cols_cuda.launches = 0
