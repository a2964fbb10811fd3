"""The H100 cost model of each kernel at a launch's shapes.

A launch's least time on one H100 is the larger of two times: the
operations it must do over the card's peak rate for their kind, and the
bytes it must move (each operand read once, each output written once)
over the memory rate. The counts are those ``chip_smoke.py`` prints beside
every kernel's time (it imports them from here):

- L2: the ε-tile family (``nng_tile``, ``pairwise_sqdist``,
  ``eps_count``) (2d + 3) fp32 flops a pair (d multiply-adds of the
  product, the norms' add, the subtraction, the compare) and 2d a row for
  the norms; the grouped, ghost and frontier kernels 2d a pair they need
  (the product), at 67 TFLOP/s (fp32 outside the tensor cores, H100 SXM
  data sheet);
- L1: 2d fp32 instructions a pair (a subtract and an absolute-add a
  feature) at 33.5e12 a second (an instruction is half an FMA's flops);
- bytes at 3.35 TB/s (HBM3, H100 SXM data sheet).

Where a kernel's work depends on the data (a live-tile list, the active
pairs of a frontier level, the words ``bits_to_cols`` reads before a row's
k-th bit), the caller passes the count its launch needs; without it the
model counts every pair or word, an upper bound. ``kernel_costs`` gives
one row for each of the 17 kernels at ``PERF.md`` section 6's shapes.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

__all__ = ["PEAK_FP32", "PEAK_BYTES", "L1_RATE", "POPC_RATE", "Cost",
           "bound", "tile_cost", "grouped_cost", "ghost_cost",
           "frontier_cost", "bits_to_cols_cost", "leaf_range_pack_cost",
           "pairwise_cost", "eps_count_cost", "kernel_cost", "kernel_costs",
           "PERF_SHAPES", "METRIC_OF"]

PEAK_FP32 = 67e12       # fp32 flops a second
PEAK_BYTES = 3.35e12    # bytes a second
L1_RATE = PEAK_FP32 / 2  # fp32 instructions a second
POPC_PER_CLK_SM = 16
POPC_RATE = POPC_PER_CLK_SM * 132 * 1980e6   # 32-bit popcounts a second


@dataclass(frozen=True)
class Cost:
    """One launch's work and least time: ``ops`` at ``rate`` a second,
    ``nbytes`` at PEAK_BYTES; ``bound_ms`` the larger of the two times
    and ``bound_by`` which."""

    ops: float
    nbytes: float
    rate: float
    ops_ms: float
    bytes_ms: float
    bound_ms: float
    bound_by: str

    def to_json(self) -> dict:
        return asdict(self)


def bound(ops: float, nbytes: float, rate: float) -> Cost:
    ops_ms = ops / rate * 1e3 if rate else 0.0
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return Cost(float(ops), float(nbytes), float(rate), ops_ms, bytes_ms,
                max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes")


def _pair_ops(metric: str, d: int, pairs: float) -> float:
    """A pair's distance: 2d fp32 operations (L2, L1), d popcounts
    (Hamming, d the words a row)."""
    return (d if metric == "hamming" else 2 * d) * pairs


def _tile_ops(metric: str, q: int, p: int, d: int, pairs) -> float:
    """The ε-tile family's operations: for L2 each pair's three more
    (the norms' add, the subtraction, the compare) and each row's norm."""
    ops = _pair_ops(metric, d, pairs)
    if metric == "euclidean":
        ops += 3 * pairs + 2 * d * (q + p)
    return ops


def _rate(metric: str, popc_rate: float = POPC_RATE) -> float:
    return {"euclidean": PEAK_FP32, "manhattan": L1_RATE}.get(metric,
                                                              popc_rate)


def _words(p: int) -> int:
    return -(-p // 32)


def tile_cost(metric: str, q: int, p: int, d: int, *, pairs=None,
              popc_rate: float = POPC_RATE) -> Cost:
    """The ε-tile (``nng_tile{,_hamming,_l1}``): x (q, d) and y (p, d)
    read, y_valid (p,); cnt (q,) and the (q, ceil(p/32)) words written."""
    pairs = q * p if pairs is None else pairs
    nbytes = 4 * ((q + p) * d + p + q + q * _words(p))
    return bound(_tile_ops(metric, q, p, d, pairs), nbytes,
                 _rate(metric, popc_rate))


def grouped_cost(metric: str, q: int, p: int, d: int, *, pairs=None,
                 popc_rate: float = POPC_RATE) -> Cost:
    """The grouped tile (#5–#7): the tile's operands with groups and ids
    on both sides; ``pairs`` the same-cell pairs the launch needs."""
    pairs = q * p if pairs is None else pairs
    nbytes = 4 * ((q + p) * d + 2 * (q + p) + q + q * _words(p))
    return bound(_pair_ops(metric, d, pairs), nbytes,
                 _rate(metric, popc_rate))


def ghost_cost(metric: str, q: int, p: int, d: int, mw: int, *, pairs=None,
               popc_rate: float = POPC_RATE) -> Cost:
    """The ghost tile (#8–#10): x with its (q, mw) ghost words, y with its
    groups; ``pairs`` the pairs the ghost test keeps."""
    pairs = q * p if pairs is None else pairs
    nbytes = 4 * ((q + p) * d + q * mw + p + q + q * _words(p))
    return bound(_pair_ops(metric, d, pairs), nbytes,
                 _rate(metric, popc_rate))


def frontier_cost(metric: str, rows: int, nodes: int, d: int, *, pairs=None,
                  popc_rate: float = POPC_RATE) -> Cost:
    """One frontier level (#11–#13): q (rows, d), the level's coordinates
    (nodes, d), radius and leaf flags, the active words read; emit and
    expand written; ``pairs`` the active (query, node) pairs."""
    pairs = rows * nodes if pairs is None else pairs
    words = _words(nodes)
    nbytes = 4 * (rows * d + nodes * d + 2 * nodes + 3 * rows * words)
    return bound(_pair_ops(metric, d, pairs), nbytes,
                 _rate(metric, popc_rate))


def bits_to_cols_cost(m: int, w: int, k: int, *, words_read=None) -> Cost:
    """``bits_to_cols``: the words each row reads up to its k-th set bit
    (``words_read``; all m·w without it), and the (m, k) ids written."""
    words_read = m * w if words_read is None else words_read
    return bound(0.0, 4 * words_read + 4 * m * k, PEAK_FP32)


def leaf_range_pack_cost(nq: int, nl: int) -> Cost:
    """``leaf_range_pack``: the (nq, nl) deltas, leaf ids and query ids
    read; counts and (nq, nl/32) words written."""
    return bound(0.0, 4 * (nq * nl + nl + 2 * nq + nq * nl // 32),
                 PEAK_FP32)


def pairwise_cost(metric: str, q: int, p: int, d: int, *,
                  popc_rate: float = POPC_RATE) -> Cost:
    """``pairwise_sqdist`` / ``pairwise_hamming``: every pair's distance,
    the (q, p) matrix written."""
    return bound(_tile_ops(metric, q, p, d, q * p),
                 4 * (q + p) * d + 4 * q * p, _rate(metric, popc_rate))


def eps_count_cost(q: int, p: int, d: int) -> Cost:
    """``eps_count``: the L2 tile's work, only the (q,) counts written."""
    return bound(_tile_ops("euclidean", q, p, d, q * p),
                 4 * (q + p) * d + 4 * q, PEAK_FP32)


# the metric of each kernel
METRIC_OF = {
    "nng_tile": "euclidean", "nng_tile_hamming": "hamming",
    "nng_tile_l1": "manhattan", "nng_tile_grouped": "euclidean",
    "nng_tile_grouped_hamming": "hamming",
    "nng_tile_grouped_l1": "manhattan", "nng_tile_ghost": "euclidean",
    "nng_tile_ghost_hamming": "hamming", "nng_tile_ghost_l1": "manhattan",
    "tree_frontier": "euclidean", "tree_frontier_hamming": "hamming",
    "tree_frontier_l1": "manhattan", "pairwise_sqdist": "euclidean",
    "pairwise_hamming": "hamming", "eps_count": "euclidean",
}


def kernel_cost(name: str, **shape) -> Cost:
    """The model for kernel ``name`` at a launch's ``shape`` (the keywords
    of its family's function: q, p, d, and mw, pairs, words_read, k, nq,
    nl, rows, nodes where they apply)."""
    metric = METRIC_OF.get(name)
    if name in ("nng_tile", "nng_tile_hamming", "nng_tile_l1"):
        return tile_cost(metric, **shape)
    if name.startswith("nng_tile_grouped"):
        return grouped_cost(metric, **shape)
    if name.startswith("nng_tile_ghost"):
        return ghost_cost(metric, **shape)
    if name.startswith("tree_frontier"):
        return frontier_cost(metric, **shape)
    if name in ("pairwise_sqdist", "pairwise_hamming"):
        return pairwise_cost(metric, **shape)
    if name == "eps_count":
        return eps_count_cost(**shape)
    if name == "bits_to_cols":
        return bits_to_cols_cost(**shape)
    if name == "leaf_range_pack":
        return leaf_range_pack_cost(**shape)
    raise KeyError(f"no cost model for kernel {name!r}")


# PERF.md section 6's shapes, numbered as its kernel table: the main path's
# 131072² x 128 tile (#1, #4, #17; #2 its words at the plan's k = 966), the
# 49920² x 25-word Hamming tile (#3), one frontier level (#11: 8192 x
# 120960 x 128; #12: 18432 x 49920 x 25 words; #13: 15360 x 58624 x 128),
# one leaf_range_pack pass (#14), [11d]'s distance-kernel API shapes (#15,
# #16). The grouped and ghost rows (#5–#10) take their metric's tile (the L1
# one at [8]'s 65536² cut) for the launch, whose rows section 6 bounds over
# the pairs the launch needs. Those counts, the frontiers' active pairs and
# the words bits_to_cols reads are data, not shapes: these rows count every
# pair and word, the upper bound of the work.
PERF_SHAPES = (
    (1, "nng_tile", dict(q=131072, p=131072, d=128)),
    (2, "bits_to_cols", dict(m=131072, w=4096, k=966)),
    (3, "nng_tile_hamming", dict(q=49920, p=49920, d=25)),
    (4, "nng_tile_l1", dict(q=131072, p=131072, d=128)),
    (5, "nng_tile_grouped", dict(q=131072, p=131072, d=128)),
    (6, "nng_tile_grouped_hamming", dict(q=49920, p=49920, d=25)),
    (7, "nng_tile_grouped_l1", dict(q=65536, p=65536, d=128)),
    (8, "nng_tile_ghost", dict(q=131072, p=131072, d=128, mw=1)),
    (9, "nng_tile_ghost_hamming", dict(q=49920, p=49920, d=25, mw=1)),
    (10, "nng_tile_ghost_l1", dict(q=65536, p=65536, d=128, mw=1)),
    (11, "tree_frontier", dict(rows=8192, nodes=120960, d=128)),
    (12, "tree_frontier_hamming", dict(rows=18432, nodes=49920, d=25)),
    (13, "tree_frontier_l1", dict(rows=15360, nodes=58624, d=128)),
    (14, "leaf_range_pack", dict(nq=8192, nl=131072)),
    (15, "pairwise_sqdist", dict(q=8192, p=131072, d=128)),
    (16, "pairwise_hamming", dict(q=8192, p=399360, d=25)),
    (17, "eps_count", dict(q=131072, p=131072, d=128)),
)


def kernel_costs(shapes=PERF_SHAPES) -> list[dict]:
    """One row per (row number, kernel, shape): the shape and its cost."""
    return [dict(row=row, kernel=name, shape=dict(shape),
                 **kernel_cost(name, **shape).to_json())
            for row, name, shape in shapes]
