"""Brute-force ε-graph oracle (tiled, exact in float64)."""
from __future__ import annotations

import numpy as np

from .graph import EpsGraph
from .metrics_host import get_host_metric


def brute_force_graph(
    points: np.ndarray, eps: float, metric="euclidean", tile: int = 4096
) -> EpsGraph:
    """All pairs with true distance <= eps: an fp32 candidate band with a
    slack, then float64 re-verification of every candidate."""
    met = get_host_metric(metric)
    n = len(points)
    ceps = met.comparable(eps)
    src, dst = [], []
    for i0 in range(0, n, tile):
        xi = points[i0 : i0 + tile]
        for j0 in range(i0, n, tile):
            yj = points[j0 : j0 + tile]
            d = met.cdist(xi, yj)
            slack = met.band_slack(xi, yj, ceps)
            ii, jj = np.nonzero(d <= ceps + slack)
            if slack > 0.0 and len(ii):
                exact = met.rowwise(xi[ii], yj[jj])
                keep_b = exact <= ceps
                ii, jj = ii[keep_b], jj[keep_b]
            ii = ii + i0
            jj = jj + j0
            keep = ii < jj
            src.append(ii[keep])
            dst.append(jj[keep])
    return EpsGraph(
        n,
        np.concatenate(src) if src else np.zeros(0, np.int64),
        np.concatenate(dst) if dst else np.zeros(0, np.int64),
    )
