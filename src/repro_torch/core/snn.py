"""SNN baseline (Chen & Güttel, 2024) — the paper's sequential SOTA.

Exact fixed-radius search for EUCLIDEAN data: index = sort points by their
projection onto the first principal component; query = binary-search the
score window [s(q) - eps, s(q) + eps] (a 1-Lipschitz lower bound on true
distance), then verify candidates exactly with BLAS3 distances and a
float64 recheck of the band. numpy on the host, as in the JAX package's
``repro.core.snn``: the baseline the paper's speed-ups are measured
against, not a path of the engines.
"""
from __future__ import annotations

import numpy as np

from .graph import EpsGraph
from .metrics_host import get_host_metric


class SNNIndex:
    def __init__(self, points: np.ndarray):
        x = np.asarray(points, np.float32)
        self.mu = x.mean(axis=0)
        xc = x - self.mu
        # first right singular vector via covariance eigh (d x d)
        cov = (xc.T @ xc).astype(np.float64)
        _, v = np.linalg.eigh(cov)
        self.pc = v[:, -1].astype(np.float32)
        self.scores = xc @ self.pc
        self.order = np.argsort(self.scores, kind="stable")
        self.sorted_scores = self.scores[self.order]
        self.points = x
        self.met = get_host_metric("euclidean")

    def query_batch(self, queries: np.ndarray, eps: float, tile: int = 1024):
        """Return (q_idx, p_idx) neighbor pairs for a query batch."""
        q = np.asarray(queries, np.float32)
        qs = (q - self.mu) @ self.pc
        # fp32 score-noise slack on the window; the float64 recheck below
        # restores exactness
        wpad = eps * 1e-4 + 1e-6
        lo = np.searchsorted(self.sorted_scores, qs - eps - wpad, side="left")
        hi = np.searchsorted(self.sorted_scores, qs + eps + wpad, side="right")
        ceps = self.met.comparable(eps)
        out_q, out_p = [], []
        for i0 in range(0, len(q), tile):
            i1 = min(i0 + tile, len(q))
            span_lo, span_hi = lo[i0:i1].min(), hi[i0:i1].max()
            cand = self.order[span_lo:span_hi]
            if len(cand) == 0:
                continue
            qt = q[i0:i1]
            d = self.met.cdist(qt, self.points[cand])
            slack = self.met.band_slack(qt, self.points[cand], ceps)
            # mask out candidates outside each query's own window
            cs = self.sorted_scores[span_lo:span_hi][None, :]
            win = (cs >= (qs[i0:i1, None] - eps - wpad)) & (
                cs <= (qs[i0:i1, None] + eps + wpad))
            ii, jj = np.nonzero((d <= ceps + slack) & win)
            if len(ii):
                exact = self.met.rowwise(qt[ii], self.points[cand[jj]])
                keep = exact <= ceps
                ii, jj = ii[keep], jj[keep]
            out_q.append(ii + i0)
            out_p.append(cand[jj])
        if not out_q:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(out_q), np.concatenate(out_p)


def snn_graph(points: np.ndarray, eps: float, tile: int = 1024) -> EpsGraph:
    """The exact ε-graph of ``points`` (euclidean) by the SNN index."""
    idx = SNNIndex(points)
    qi, pj = idx.query_batch(points, eps, tile=tile)
    return EpsGraph(len(points), qi, pj)
