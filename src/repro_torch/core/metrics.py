"""The metric registry: one object per metric, every hookup in one place.

A ``Metric`` bundles the float64 host reference (``HostMetric``), the
device comparable-distance function ``cdist`` (torch), the row-aligned true
distance the on-card forest builder uses (``rowwise``), the fused tile's and
the tree frontier's CUDA kernels and plain versions, and the systolic
engine's geometry hooks (block summary and centre distance for the
triangle-inequality prune).

Kernel hookups are optional: a metric registered with only ``cdist`` and
its host reference runs end to end through the generic path in
``repro_torch.kernels.ops`` — slower, but exact. Adding a metric is
``register_metric(Metric(...))``, never an engine edit.

"Comparable" distances are any monotone transform of the true distance
(squared L2 for euclidean); ``true_device`` maps them back. ``exact``
marks integer-valued metrics whose comparisons need no fp32 slack.

Metrics are identity-hashed (``eq=False``): the registry returns the same
object every call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.kernels import nng_tile as _nt
from repro_torch.kernels import tree_frontier as _tf

from .metrics_host import HostMetric, get_host_metric


@dataclass(frozen=True, eq=False)
class Metric:
    """A registered metric: host reference + device hookups. Only ``name``,
    ``host`` and ``cdist`` are required."""

    name: str
    host: HostMetric                 # float64 host reference
    cdist: Callable                  # (x, y) -> (q, p) comparable dists, torch
    dtype: Any = torch.float32       # device point dtype
    exact: bool = False              # integer distances: zero-slack compares
    # comparable -> true distance on device (None = identity fp32 cast)
    true_device: Callable | None = None
    # row-aligned TRUE distance, (n, d), (n, d) -> (n,) fp32 — the on-card
    # forest builder's distance primitive. Diff-form arithmetic where the
    # metric allows it (no cancellation: builder radii stay ulp-exact at any
    # coordinate scale); None = generic per-row cdist path
    rowwise: Callable | None = None
    # fused bitmask tile (systolic): CUDA kernel + plain version, both
    # (x, y, y_valid, eps) -> (cnt, bits)
    tile_kernel: Callable | None = None
    tile_ref: Callable | None = None
    # level-synchronous tree frontier (traversal="tree"): CUDA kernel +
    # plain version, both (q, c, rad, leaf, act_bits, eps) -> (emit, expand)
    frontier_kernel: Callable | None = None
    frontier_ref: Callable | None = None
    # block summary: x -> (center, fp32 true radius); None = first-point
    # center (valid in ANY metric)
    block_summary: Callable | None = None
    # accurate center-pair true distances for the prune bound:
    # (partner_centers (r, d), my_center (d,)) -> (r,) fp32
    center_dist: Callable | None = None

    # -- derived helpers (metric-generic) -----------------------------------
    def comparable(self, eps: float) -> float:
        return self.host.comparable(eps)

    def true(self, c):
        if self.true_device is not None:
            return self.true_device(c)
        return torch.as_tensor(c).to(torch.float32)

    def rowwise_true(self, x, y):
        """Row-aligned true distances (the builder primitive); the generic
        path takes the diagonal of ``cdist`` over blocks of aligned rows."""
        if self.rowwise is not None:
            return self.rowwise(x, y)
        out = [self.true(self.cdist(x[i:i + 256], y[i:i + 256])).diagonal()
               for i in range(0, x.shape[0], 256)]
        if not out:
            return torch.zeros(0, dtype=torch.float32, device=x.device)
        return torch.cat(out).to(torch.float32)

    def summary(self, x):
        if self.block_summary is not None:
            return self.block_summary(x)
        c = x[0]
        r = torch.max(self.true(self.cdist(x, c[None, :]))[:, 0])
        return c, r.to(torch.float32)

    def summary_dist(self, pc, c):
        if self.center_dist is not None:
            return self.center_dist(pc, c)
        return self.true(self.cdist(pc, c[None, :]))[:, 0]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Metric] = {}

# reference metrics whose kernels are not ported yet, and where they land
_NOT_PORTED = {
    "hamming": "ROADMAP item 4 (the other metrics on the main path)",
    "manhattan": "ROADMAP item 4 (the other metrics on the main path)",
}


def register_metric(metric: Metric, *, overwrite: bool = False) -> Metric:
    """Register a metric under ``metric.name``; returns it for chaining."""
    if metric.name in _REGISTRY and not overwrite:
        raise ValueError(f"metric {metric.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[metric.name] = metric
    return metric


def get_metric(metric: str | Metric) -> Metric:
    """Resolve a metric name (or pass a ``Metric`` through unchanged)."""
    if isinstance(metric, Metric):
        return metric
    if metric in _REGISTRY:
        return _REGISTRY[metric]
    if metric in _NOT_PORTED:
        raise NotImplementedError(
            f"metric {metric!r} is not ported to PyTorch yet: "
            f"{_NOT_PORTED[metric]}")
    raise ValueError(f"unknown metric {metric!r}; registered: "
                     f"{sorted(_REGISTRY)}")


# ---------------------------------------------------------------------------
# euclidean
# ---------------------------------------------------------------------------

def _euclidean_cdist(x, y):
    """Squared L2 via the fp32 expansion ‖x‖² + ‖y‖² − 2x·y — the SAME
    arithmetic as the tile kernel, so knife-edge pairs classify alike."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xn = (x * x).sum(-1)[:, None]
    yn = (y * y).sum(-1)[None, :]
    return torch.clamp_min(xn + yn - 2.0 * (x @ y.T), 0.0)


def _euclidean_true(c):
    return torch.sqrt(torch.clamp_min(c.to(torch.float32), 0.0))


def _euclidean_rowwise(x, y):
    # diff form: the builder's radii carry no cancellation error
    diff = x.to(torch.float32) - y.to(torch.float32)
    return torch.sqrt((diff * diff).sum(-1))


def _euclidean_block_summary(x):
    xf = x.to(torch.float32)
    c = xf.mean(0)
    r = torch.sqrt(((xf - c[None, :]) ** 2).sum(-1).max())
    return c, r


def _euclidean_center_dist(pc, c):
    # direct diff form: no cancellation on large-offset data, so the prune
    # bound's relative slack is a true error bound
    return torch.sqrt(((pc - c[None, :]) ** 2).sum(-1))


register_metric(Metric(
    name="euclidean",
    host=get_host_metric("euclidean"),
    cdist=_euclidean_cdist,
    true_device=_euclidean_true,
    rowwise=_euclidean_rowwise,
    tile_kernel=_nt.nng_tile_cuda,
    tile_ref=_nt.nng_tile_ref,
    frontier_kernel=_tf.tree_frontier_cuda,
    frontier_ref=_tf.tree_frontier_ref,
    block_summary=_euclidean_block_summary,
    center_dist=_euclidean_center_dist,
))
