"""Host-side (numpy) metric helpers: the float64 ground truth.

"Comparable" distances are any monotone transform of the true distance
(squared L2 for euclidean); ``true`` maps them back, because cover-tree
arithmetic is additive. The brute-force oracle, the metric registry and the
float64 cover-tree builder (``covertree.py``, ``flat_tree.py``) read them
from here.

Hamming points are packed 32-bit words. The port's device tensors hold
them as int32 (torch's uint32 lacks the bit operations), so ``HostHamming``
takes either dtype and reads int32 words as a uint32 bit view.
"""
from __future__ import annotations

import numpy as np


class HostMetric:
    name: str
    dtype = np.float32      # point-array dtype (device tables use it too)

    def cdist(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def rowwise(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def band_slack(self, x, y, ceps) -> float:
        raise NotImplementedError

    def comparable(self, eps: float) -> float:
        raise NotImplementedError

    def true(self, c):
        raise NotImplementedError


class HostEuclidean(HostMetric):
    name = "euclidean"

    def cdist(self, x, y):
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        xn = np.einsum("ij,ij->i", x, x)[:, None]
        yn = np.einsum("ij,ij->i", y, y)[None, :]
        d = xn + yn - 2.0 * (x @ y.T)
        return np.maximum(d, 0.0, out=d)

    def rowwise(self, x, y):
        # float64 diff form — the framework's exactness ground truth
        diff = np.asarray(x, np.float64) - np.asarray(y, np.float64)
        return np.einsum("ij,ij->i", diff, diff)

    def band_slack(self, x, y, ceps):
        # BLAS3 fp32 cancellation error bound for the candidate band
        xn = float(np.max(np.einsum("ij,ij->i", x, x))) if len(x) else 0.0
        yn = float(np.max(np.einsum("ij,ij->i", y, y))) if len(y) else 0.0
        return (xn + yn + ceps) * 1e-5 + 1e-9

    def comparable(self, eps):
        return float(eps) ** 2

    def true(self, c):
        return np.sqrt(np.maximum(np.asarray(c, np.float64), 0.0))


class HostManhattan(HostMetric):
    """L1 / city-block distance over float rows.

    Comparable distance IS the true distance (no monotone transform):
    cover-tree radii arithmetic is additive, so true == comparable keeps
    every slack formula in one unit. fp32 L1 has no cancellation blow-up
    (the terms are non-negative), only ~d·ulp accumulation error, which the
    relative band slack covers before the float64 recheck."""

    name = "manhattan"

    def cdist(self, x, y):
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        q = x.shape[0]
        out = np.empty((q, y.shape[0]), np.float32)
        step = max(1, (1 << 24) // max(y.size, 1))
        for i in range(0, q, step):
            out[i:i + step] = np.abs(
                x[i:i + step, None, :] - y[None, :, :]).sum(axis=-1)
        return out

    def rowwise(self, x, y):
        # float64 — the framework's exactness ground truth
        diff = np.asarray(x, np.float64) - np.asarray(y, np.float64)
        return np.abs(diff).sum(axis=-1)

    def band_slack(self, x, y, ceps):
        xn = float(np.max(np.abs(x).sum(axis=-1))) if len(x) else 0.0
        yn = float(np.max(np.abs(y).sum(axis=-1))) if len(y) else 0.0
        return (xn + yn + ceps) * 1e-6 + 1e-9

    def comparable(self, eps):
        return float(eps)

    def true(self, c):
        return np.asarray(c, np.float64)


# set bits of each byte value
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _as_words(x) -> np.ndarray:
    """Packed words as uint32: int32 words (the port's device layout) are
    viewed, never value-cast."""
    x = np.asarray(x)
    if x.dtype == np.int32:
        return x.view(np.uint32)
    return np.asarray(x, np.uint32)


def _popcount_sum(xor: np.ndarray) -> np.ndarray:
    """(..., w) uint32 -> (...,) int64 set bits per row."""
    b = np.ascontiguousarray(xor).view(np.uint8)
    return _POP8[b].sum(axis=-1, dtype=np.int64)


class HostHamming(HostMetric):
    name = "hamming"
    dtype = np.uint32

    def cdist(self, x, y):
        # (q, w) x (p, w) words -> float32 counts. Chunked to bound memory.
        x = _as_words(x)
        y = _as_words(y)
        q = x.shape[0]
        out = np.empty((q, y.shape[0]), np.float32)
        step = max(1, (1 << 24) // max(y.size, 1))
        for i in range(0, q, step):
            xor = np.bitwise_xor(x[i:i + step, None, :], y[None, :, :])
            out[i:i + step] = _popcount_sum(xor)
        return out

    def rowwise(self, x, y):
        xor = np.bitwise_xor(_as_words(x), _as_words(y))
        return _popcount_sum(xor).astype(np.float64)

    def band_slack(self, x, y, ceps):
        return 0.0  # integer distances are exact

    def comparable(self, eps):
        return float(eps)

    def true(self, c):
        return np.asarray(c, np.float64)


HOST_METRICS = {
    "euclidean": HostEuclidean(),
    "hamming": HostHamming(),
    "manhattan": HostManhattan(),
}


def get_host_metric(name) -> HostMetric:
    if isinstance(name, HostMetric):
        return name
    return HOST_METRICS[name]
