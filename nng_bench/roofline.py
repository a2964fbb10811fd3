"""The H100's peaks and the least time of the ε-tile over a whole input,
frozen from the port's cost model (``repro_torch/analysis/kernel_cost.py``)
so that a change to the program cannot move the yardstick.

Peaks (NVIDIA H100 SXM data sheet, 700 W): 67e12 fp32 flops a second
outside the tensor cores, 3.35e12 HBM bytes a second; 32-bit popcounts at
16 a clock per SM (CUDA C++ Programming Guide) × 132 SMs × 1980 MHz.

The work is what the input needs, whatever the implementation does: each
unordered pair once, n(n − 1)/2 for one engine run, at (2d + 3) fp32
operations a pair plus 2d a row (L2: the product, the norms' add, the
subtraction, the compare, and each row's norm), or d popcounts a pair
(Hamming, d the words a row); bytes: the points and a validity word a row
read once, a count a row and a bit a pair written once. The larger of the
two times bounds the kernel.
"""
from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
POPC_RATE = 16 * 132 * 1980e6


def tile_bound_s(metric: str, n: int, d: int) -> float:
    """Seconds that one engine run's ε-tiles need at the least on one H100:
    every unordered pair of ``n`` rows of ``d`` features (L2) or words
    (Hamming)."""
    pairs = n * (n - 1) / 2
    if metric == "euclidean":
        ops_s = ((2 * d + 3) * pairs + 2 * d * n) / PEAK_FP32
    elif metric == "hamming":
        ops_s = d * pairs / POPC_RATE
    else:
        raise ValueError(f"no tile bound for metric {metric!r}")
    nbytes = 4 * (n * d + n) + 4 * n + pairs / 8
    return max(ops_s, nbytes / PEAK_BYTES)


def tile_launch_bound_ms(q: int, p: int, d: int) -> float:
    """``kernel_cost.tile_cost("euclidean", q, p, d).bound_ms``: one L2
    tile launch of q × p pairs, as the port's table (``PERF.md`` section 6)
    reports it."""
    ops = (2 * d + 3) * q * p + 2 * d * (q + p)
    nbytes = 4 * ((q + p) * d + p + q + q * -(-p // 32))
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
