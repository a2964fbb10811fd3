"""Three-term roofline of one rank of the ε-NNG engines on H100 clusters.

The counterpart of the reference's TPU model: the same terms and keys, at
NVIDIA H100 SXM constants. Compute and HBM rates are the cost model's
(``analysis/kernel_cost.py``); the collective rate is the link a ring hop
crosses.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.kernel_cost import (L1_RATE, PEAK_BYTES, PEAK_FP32,
                                              POPC_RATE)

from .rank_stats import RankStats


@dataclass(frozen=True)
class HW:
    # fp32 FLOP/s outside the tensor cores (H100 SXM data sheet)
    peak_flops: float = PEAK_FP32
    # 32-bit popcounts a second: 16 a clock an SM (CUDA C++ Programming
    # Guide) x 132 SMs x 1980 MHz (the H100 SXM's maximum SM clock)
    popc_rate: float = POPC_RATE
    # fp32 instructions a second (the L1 distance: half an FMA's flops)
    fp32_instr_rate: float = L1_RATE
    # HBM3, B/s (H100 SXM data sheet)
    hbm_bw: float = PEAK_BYTES
    # NVLink 4 inside a node, B/s a direction per GPU (900 GB/s total,
    # H100 SXM data sheet)
    nvlink_bw: float = 450e9
    # between nodes, B/s a direction per GPU: one ConnectX-7 NDR 400 Gb/s
    # adapter per GPU (DGX H100)
    net_bw: float = 50e9
    gpus_per_node: int = 8

    def ring_bw(self, ranks: int) -> float:
        """The rate of a ring round: the round ends when its slowest hop
        ends, and beyond one node some hop crosses the network."""
        return self.nvlink_bw if ranks <= self.gpus_per_node else self.net_bw


def roofline_terms(stats: RankStats, ranks: int, hw: HW = HW()) -> dict:
    """One step's three terms from ONE rank's counts (every rank runs the
    same schedule in parallel, so nothing is divided by ``ranks``):
    ``t_compute_s`` (fp32 flops at ``peak_flops`` plus each other kind of
    operation in ``stats.ops`` at its own rate), ``t_memory_s`` (HBM
    bytes) and ``t_collective_s`` (the rank's collective bytes over the
    ring's rate: NVLink within a node of ``gpus_per_node``, the network
    between nodes — at more than 8 ranks some hop of every round crosses
    nodes, and a round ends with its slowest hop). The keys are the
    reference's, with ``ops`` (non-fp32 operations by kind) added."""
    rates = {"popcount": hw.popc_rate, "fp32_instructions": hw.fp32_instr_rate}
    t_compute = stats.flops / hw.peak_flops + sum(
        v / rates[k] for k, v in stats.ops.items())
    t_memory = stats.mem_bytes / hw.hbm_bw
    t_coll = stats.total_coll_bytes / hw.ring_bw(ranks)
    dom = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1])
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dom[0],
        "step_lower_bound_s": max(t_compute, t_memory, t_coll),
        "flops": stats.flops,
        "ops": dict(stats.ops),
        "mem_bytes": stats.mem_bytes,
        "coll_bytes": dict(stats.coll_bytes),
    }
