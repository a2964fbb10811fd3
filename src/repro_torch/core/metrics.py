"""The metric registry: one object per metric, every hookup in one place.

A ``Metric`` bundles the float64 host reference (``HostMetric``), the
device comparable-distance function ``cdist`` (torch), the row-aligned true
distance the on-card forest builder uses (``rowwise``), the fused tile's,
the grouped tile's, the ghost tile's and the tree frontier's CUDA kernels
and plain versions, and the engines' geometry hooks: the block summary and centre distance for
the systolic triangle-inequality prune, the Lemma-1 ghost slack of the
landmark engine, and the (tile_q, tile_p) block shape its counters are
kept in.

Kernel hookups are optional: a metric registered with only ``cdist`` and
its host reference runs end to end through the generic path in
``repro_torch.kernels.ops`` — slower, but exact. Adding a metric is
``register_metric(Metric(...))``, never an engine edit.

"Comparable" distances are any monotone transform of the true distance
(squared L2 for euclidean); ``true_device`` maps them back. ``exact``
marks integer-valued metrics whose comparisons need no fp32 slack.

Three metrics are built in: ``euclidean`` and ``manhattan`` over fp32 rows,
and ``hamming`` over rows of packed 32-bit words, held on the device as
int32 (the uint32 bit pattern: torch's uint32 lacks the bit operations).
``Metric.as_device`` is the one entry of user points into the engine, and
views uint32 words as int32 rather than converting their values.

Metrics are identity-hashed (``eq=False``): the registry returns the same
object every call.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import nng_tile as _nt
from repro_torch.kernels import tree_frontier as _tf

from .metrics_host import HostMetric, get_host_metric


def _round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


@contextlib.contextmanager
def ieee_fp32():
    """Run the block with IEEE fp32 products: float32 matmul precision
    "highest" and TF32 off for matmuls and cuDNN, whatever the process had
    set; the three settings are restored on exit.

    The port's products (``_euclidean_cdist``, the plain tile versions) sit
    inside fp32 error bounds that a TF32 product (10-bit mantissa) breaks:
    the landmark engine's centre distances feed the Lemma-1 ghost test.
    The settings are process-wide, so two threads that call the port while
    others want TF32 race on them, as they would on the flags themselves.
    The precision is set before the flags and restored after them: torch
    refuses to read a precision that the two APIs set inconsistently."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]
        torch.set_float32_matmul_precision(saved[0])


@dataclass(frozen=True, eq=False)
class Metric:
    """A registered metric: host reference + device hookups. Only ``name``,
    ``host`` and ``cdist`` are required."""

    name: str
    host: HostMetric                 # float64 host reference
    cdist: Callable                  # (x, y) -> (q, p) comparable dists, torch
    dtype: Any = torch.float32       # device point dtype
    exact: bool = False              # integer distances: zero-slack compares
    # the reference's fused-tile block shape: the landmark engine counts
    # tiles_scheduled / tiles_skipped / dists_evaluated in these blocks
    tile_q: int = 256
    tile_p: int = 512
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
    # group-aware tile (the landmark engine's W x W and G x W): CUDA kernel
    # + plain version, both (x, y, xg, yg, xid, yid, eps) -> (cnt, bits)
    grouped_kernel: Callable | None = None
    grouped_ref: Callable | None = None
    # ghost-ring tile (the landmark engine's ghost_mode="ring": visiting
    # rows carry packed Lemma-1 cell words instead of ghost copies): CUDA
    # kernel + plain version, both (x, y, x_gbits, yg, eps) -> (cnt, bits)
    ghost_kernel: Callable | None = None
    ghost_ref: Callable | None = None
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
    # Lemma-1 ghost slack: (x, centers, tru, bound) -> (n,) fp32; None =
    # zero for exact metrics, scale-relative generic slack otherwise
    ghost_slack: Callable | None = None

    # -- derived helpers (metric-generic) -----------------------------------
    def as_device(self, points, device=None) -> torch.Tensor:
        """User points (numpy or torch) -> a ``self.dtype`` tensor on
        ``device`` (None: where they are). A metric over words (int32)
        takes uint32 data as a bit view; float data converts by value."""
        t = torch.as_tensor(points)
        if self.dtype == torch.int32 and t.dtype == torch.uint32:
            t = t.view(torch.int32)
        return t.to(device=device, dtype=self.dtype)

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

    def tile_shape(self, q: int, p: int) -> tuple[int, int]:
        """The (tq, tp) block of a (q, p) tile in the reference's geometry:
        full ``tile_q`` x ``tile_p`` blocks, or the operand rounded up to 8
        rows / 128 columns where it is smaller."""
        tq = self.tile_q if q >= self.tile_q else _round_up(max(q, 1), 8)
        tp = self.tile_p if p >= self.tile_p else _round_up(max(p, 1), 128)
        return tq, tp

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

    def lemma1_slack(self, x, centers, tru, bound):
        """The slack added to each row's Lemma-1 ghost bound (fp32)."""
        if self.ghost_slack is not None:
            return self.ghost_slack(x, centers, tru, bound)
        if self.exact:
            return torch.zeros_like(bound)
        # generic float metric: relative slack on the row's distance scale;
        # over-inclusion only costs ghost copies, never exactness
        scale = tru.amax(1)
        return (scale + bound) * 1e-5 + 1e-6


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Metric] = {}

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
    raise ValueError(f"unknown metric {metric!r}; registered: "
                     f"{sorted(_REGISTRY)}")


def registered_metrics() -> tuple[str, ...]:
    """The registered metric names, sorted (the CLI's ``--metric``
    choices)."""
    return tuple(sorted(_REGISTRY))


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


def _euclidean_ghost_slack(x, centers, tru, bound):
    """The fp32 expansion's cancellation error, O(u·(‖p‖ + ‖c‖)²) in the
    squared distances, carried through the square root at ``bound``: a
    per-row slack that grows with the row's own ‖p‖² and with √d (the
    accumulation length)."""
    xf = x.to(torch.float32)
    cf = centers.to(torch.float32)
    sx = (xf * xf).sum(-1)                      # (n,) per-point ‖p‖²
    sc = (cf * cf).sum(-1).max()                # the farthest centre
    scale2 = sx + sc + 2.0 * torch.sqrt(sx * sc)  # >= (‖p‖ + max‖c‖)²
    coef = float(np.float32((8.0 + 2.0 * float(np.sqrt(x.shape[1]))) * 6e-8))
    return (coef * scale2 / torch.clamp_min(bound, 1e-30)
            + 1e-5 * bound + 1e-6)


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
    grouped_kernel=_nt.nng_tile_grouped_cuda,
    grouped_ref=_nt.nng_tile_grouped_ref,
    ghost_kernel=_nt.nng_tile_ghost_cuda,
    ghost_ref=_nt.nng_tile_ghost_ref,
    frontier_kernel=_tf.tree_frontier_cuda,
    frontier_ref=_tf.tree_frontier_ref,
    block_summary=_euclidean_block_summary,
    center_dist=_euclidean_center_dist,
    ghost_slack=_euclidean_ghost_slack,
))


# ---------------------------------------------------------------------------
# hamming (packed words) and manhattan (L1)
# ---------------------------------------------------------------------------

def _hamming_cdist(x, y):
    return _nt.hamming_dist(x, y).to(torch.float32)


def _hamming_rowwise(x, y):
    return _nt.popcount32(x ^ y).sum(-1).to(torch.float32)


def _l1_rowwise(x, y):
    # diff form, as euclidean's
    return (x.to(torch.float32) - y.to(torch.float32)).abs().sum(-1)


register_metric(Metric(
    name="hamming",
    host=get_host_metric("hamming"),
    cdist=_hamming_cdist,
    rowwise=_hamming_rowwise,
    dtype=torch.int32,
    exact=True,
    tile_q=128, tile_p=256,
    tile_kernel=_nt.nng_tile_hamming_cuda,
    tile_ref=_nt.nng_tile_hamming_ref,
    grouped_kernel=_nt.nng_tile_grouped_hamming_cuda,
    grouped_ref=_nt.nng_tile_grouped_hamming_ref,
    ghost_kernel=_nt.nng_tile_ghost_hamming_cuda,
    ghost_ref=_nt.nng_tile_ghost_hamming_ref,
    frontier_kernel=_tf.tree_frontier_hamming_cuda,
    frontier_ref=_tf.tree_frontier_hamming_ref,
))
register_metric(Metric(
    name="manhattan",
    host=get_host_metric("manhattan"),
    cdist=_nt.l1_dist,
    rowwise=_l1_rowwise,
    dtype=torch.float32,
    tile_q=128, tile_p=256,
    tile_kernel=_nt.nng_tile_l1_cuda,
    tile_ref=_nt.nng_tile_l1_ref,
    grouped_kernel=_nt.nng_tile_grouped_l1_cuda,
    grouped_ref=_nt.nng_tile_grouped_l1_ref,
    ghost_kernel=_nt.nng_tile_ghost_l1_cuda,
    ghost_ref=_nt.nng_tile_ghost_l1_ref,
    frontier_kernel=_tf.tree_frontier_l1_cuda,
    frontier_ref=_tf.tree_frontier_l1_ref,
))
