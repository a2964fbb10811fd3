"""Bitmask epilogues: packed words -> neighbour columns and cover masks.

``bits_to_cols``  (m, W) int32 words -> (m, k) int32: the k lowest set
    column indices of each row, ascending, ``NOCOL``-padded. The output
    slot of a set column is its rank (the count of set columns below it),
    so no value is ever sorted.

``leaf_range_pack``  (delta (nq, NL) int32 ±1 range deltas over DFS leaf
    slots, leaf_ids (NL,), qids (nq,)) -> (cnt (nq,), bits (nq, NL/32)):
    the tree traversal's leaf epilogue — running prefix sum of the deltas,
    the > 0 cover test, leaf-slot validity and structural self-pair
    exclusion, packed to words with per-row counts.

``*_cuda`` launch the hand-written kernels in ``csrc/bits_to_cols.cu`` and
``csrc/leaf_range_pack.cu`` and take CUDA tensors only; ``*_ref`` are their
plain PyTorch versions. All are deterministic integer functions of their
inputs, so each kernel agrees with its plain version bit for bit on every
input.
"""
from __future__ import annotations

import torch

from . import _build
from .nng_tile import pack_words, unpack_words

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


def leaf_range_pack_ref(delta, leaf_ids, qids, sentinel=SENTINEL):
    """Plain PyTorch version: delta (nq, NL) int32 ±1 range deltas, leaf_ids
    (NL,) int32 global ids (``sentinel`` = padding), qids (nq,) int32, NL %
    32 == 0 -> (cnt (nq,) int32, bits (nq, NL/32) int32 words)."""
    cover = torch.cumsum(delta, dim=1, dtype=torch.int32) > 0
    cover &= (leaf_ids != sentinel)[None, :]
    cover &= qids[:, None] != leaf_ids[None, :]
    cnt = cover.sum(1, dtype=torch.int32)
    return cnt, pack_words(cover)


def leaf_range_pack_cuda(delta, leaf_ids, qids):
    """The CUDA kernel: delta (nq, >= NL) int32 with unit column stride (a
    column slice of a wider table is fine: columns past NL are never read),
    leaf_ids (NL,) and qids (nq,) contiguous int32, all on one CUDA device
    -> (cnt (nq,) int32, bits (nq, ceil(NL/32)) int32), the same function
    as ``leaf_range_pack_ref``."""
    for name, t, nd in (("delta", delta, 2), ("leaf_ids", leaf_ids, 1),
                        ("qids", qids, 1)):
        if not t.is_cuda:
            raise ValueError(f"leaf_range_pack_cuda: {name} must be a CUDA "
                             f"tensor (got {t.device})")
        if t.dtype != torch.int32 or t.dim() != nd:
            raise ValueError(f"leaf_range_pack_cuda: {name} must be a {nd}-d "
                             f"int32 tensor (got {t.dtype}, shape "
                             f"{tuple(t.shape)})")
    nq = delta.shape[0]
    nl = leaf_ids.shape[0]
    if (delta.shape[1] < nl or qids.shape[0] != nq or delta.stride(1) != 1
            or not (leaf_ids.is_contiguous() and qids.is_contiguous())):
        raise ValueError(f"leaf_range_pack_cuda: delta {tuple(delta.shape)} "
                         f"(strides {delta.stride()}), leaf_ids "
                         f"{tuple(leaf_ids.shape)}, qids {tuple(qids.shape)}")
    if len({t.device for t in (delta, leaf_ids, qids)}) != 1:
        raise ValueError("leaf_range_pack_cuda: operands on different devices")
    cnt = torch.empty(nq, dtype=torch.int32, device=delta.device)
    bits = torch.empty((nq, -(-nl // 32)), dtype=torch.int32,
                       device=delta.device)
    if nq == 0:
        return cnt, bits
    ld = delta.stride(0) if nq > 1 else delta.shape[1]
    launch = _build.entry("leaf_range_pack")
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(delta.data_ptr(), ld, leaf_ids.data_ptr(),
                      qids.data_ptr(), cnt.data_ptr(), bits.data_ptr(), nq,
                      nl, stream)
    _build.check("leaf_range_pack", code)
    leaf_range_pack_cuda.launches += 1
    return cnt, bits


leaf_range_pack_cuda.launches = 0
