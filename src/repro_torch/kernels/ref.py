"""Plain PyTorch oracles of the distance-kernel API.

The counterparts of the reference's ``kernels/ref.py``, with the same
names and semantics, on torch tensors of any device:

  - ``pairwise_sqdist_ref``: squared L2 in the direct (x − y)² form, the
    numerical reference;
  - ``pairwise_sqdist_blas3_ref``: the ‖x‖² + ‖y‖² − 2x·y expansion
    clamped to >= 0, the arithmetic of ``csrc/pairwise_sqdist.cu``;
  - ``pairwise_hamming_ref``: popcount(x ⊕ y) summed over packed words
    (int32 bit patterns, as everywhere in the port);
  - ``eps_count_ref``: per-query counts of the direct form's d² <=
    float32(eps)².

The direct forms build (rows, p, d) temporaries, so they walk the rows in
chunks that keep those near ``_CUBE`` elements.
"""
from __future__ import annotations

import torch

from .nng_tile import eps2_f32, popcount32

# elements of a direct form's (rows, p, d) temporaries per row chunk
_CUBE = 1 << 26


def _row_chunks(q: int, p: int, d: int):
    """Row slices whose (rows, p, d) cube stays near ``_CUBE`` elements."""
    step = max(1, _CUBE // max(p * d, 1))
    return (slice(i, i + step) for i in range(0, q, step))


def pairwise_sqdist_ref(x, y) -> torch.Tensor:
    """Squared Euclidean distances in the direct (x − y)² form: x (q, d),
    y (p, d) -> (q, p) fp32."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32,
                      device=x.device)
    for sl in _row_chunks(x.shape[0], y.shape[0], x.shape[1]):
        diff = x[sl, None, :] - y[None, :, :]
        out[sl] = (diff * diff).sum(-1)
    return out


def pairwise_sqdist_blas3_ref(x, y) -> torch.Tensor:
    """The expansion (‖x‖² + ‖y‖²) − 2x·y, clamped to >= 0: x (q, d),
    y (p, d) -> (q, p) fp32. Scaling the product by −2 is exact, so adding
    it is the subtraction."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xn = (x * x).sum(-1)[:, None]
    yn = (y * y).sum(-1)[None, :]
    d = (x @ y.T).mul_(-2.0)
    return d.add_(xn + yn).clamp_min_(0.0)


def pairwise_hamming_ref(x, y) -> torch.Tensor:
    """Hamming distances over packed words: x (q, w), y (p, w) int32 bit
    patterns -> (q, p) int32 popcount(x ^ y) summed over the words."""
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.int32,
                      device=x.device)
    for sl in _row_chunks(x.shape[0], y.shape[0], x.shape[1]):
        out[sl] = popcount32(x[sl, None, :] ^ y[None, :, :]).sum(-1)
    return out


def eps_count_ref(x, y, eps: float) -> torch.Tensor:
    """Per-query count of y rows within L2 distance eps, by the direct
    form's d² against float32(eps)²: x (q, d), y (p, d) -> (q,) int32."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    e2 = eps2_f32(eps)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for sl in _row_chunks(x.shape[0], y.shape[0], x.shape[1]):
        diff = x[sl, None, :] - y[None, :, :]
        out[sl] = ((diff * diff).sum(-1) <= e2).sum(1, dtype=torch.int32)
    return out
