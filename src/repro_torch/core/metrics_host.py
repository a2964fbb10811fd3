"""Host-side (numpy) metric helpers: the float64 ground truth.

"Comparable" distances are any monotone transform of the true distance
(squared L2 for euclidean); ``true`` maps them back, because cover-tree
arithmetic is additive. The brute-force oracle, the metric registry and the
float64 cover-tree builder (``covertree.py``, ``flat_tree.py``) read them
from here. The hamming and manhattan host metrics come with their device
metrics (ROADMAP item 4).
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


HOST_METRICS = {"euclidean": HostEuclidean()}


def get_host_metric(name) -> HostMetric:
    if isinstance(name, HostMetric):
        return name
    return HOST_METRICS[name]
