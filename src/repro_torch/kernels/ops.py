"""Device-dispatching wrappers around the tile kernels.

Each wrapper follows the device of its tensors: on a CUDA tensor it
launches the hand-written kernel (which raises rather than fall back), on
a CPU tensor it runs the kernel's plain PyTorch version. A metric that has
no kernel runs its plain version, or the generic ``cdist`` path, on either
device.
"""
from __future__ import annotations

import torch

from .bits_epilogue import NOCOL, SENTINEL, bits_to_cols_cuda, bits_to_cols_ref
from .nng_tile import pack_words


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
