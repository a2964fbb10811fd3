"""One rank's work, HBM bytes, collective bytes and device memory of the
ε-NNG engines, counted in closed form from the shapes.

The counterpart of the reference's ``roofline/hlo_analysis.py``, which
reads them off compiled HLO. The port has no HLO, and the algorithm needs
none: the schedule fixes every launch and every exchange.

- **Compute and HBM bytes**: the H100 cost model of each kernel
  (``analysis/kernel_cost.py``) over every tile the schedule launches,
  counting every pair (no prune: an upper bound, as the reference's
  compile is), plus the engine's own copies (hops, merges, packing).
- **Collective bytes**: the engines' ``comm_bytes`` formulas
  (``repro_torch.nng.ring_comm_bytes``, ``landmark_comm_bytes``) divided
  by the ranks, under the reference's HLO kinds: the ring's points and
  mirror hops are ``collective-permute``, its block summaries
  ``all-gather``, the landmark coalesce and ghost exchanges ``all-to-all``.
- **Memory**, split as XLA's ``memory_analysis`` splits it:
  ``argument_size_bytes`` (what the engine is handed: the whole input,
  which ``build_nng`` moves to every process's device and the engines
  keep, and for the landmark engine its centres), ``output_size_bytes``
  (the neighbour tables, counts and flags the engine returns) and
  ``temp_size_bytes`` (everything else the rank holds at its peak).
  ``peak_bytes`` takes the largest of the engine's moments, each listing
  the buffers alive then as the code allocates them: the operators'
  outputs, and apart from them the CUDA operators' own workspaces (a
  sort's scratch, an int32 index's int64 copy), which no recording of
  operator outputs sees. Every buffer is rounded up as PyTorch's CUDA
  caching allocator rounds it. ``total_bytes`` is the sum of the three:
  the output's final copy is made after the peak, so the sum bounds the
  peak from above by at most the output. XLA's
  ``generated_code_size_bytes`` has no counterpart: the kernels are a
  fixed set of shared libraries loaded once a process, whatever the
  shapes.

The memory model is the production layout's: one rank a GPU, its ring
hops received into device buffers as NCCL receives them (the ring's
prefetched block is resident during a round). The card check
(``launch.dryrun.measure_rank_memory``) runs gloo processes, which stage
a hop through host memory, so it can only read less. The moments'
operator outputs are held to a recording of the engines on the CPU
(``tests/test_torch_rank_memory.py``), so an engine change that moves
them fails there.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.analysis.kernel_cost import (PEAK_FP32, POPC_RATE, Cost,
                                              bits_to_cols_cost,
                                              grouped_cost, pairwise_cost,
                                              tile_cost)
from repro_torch.core.distributed.device import LandmarkPlan, plan_landmark
from repro_torch.core.metrics import get_metric
from repro_torch.nng import landmark_comm_bytes, ring_comm_bytes

# PyTorch's CUDA caching allocator (c10/cuda/CUDACachingAllocator.cpp): every
# block a multiple of 512 B; requests above 1 MiB and below 10 MiB are
# carved from 20 MiB segments, larger ones get a segment rounded up to
# 2 MiB; a block is handed out whole when splitting it would leave 1 MiB
# or less
ALLOC_UNIT = 512
_MIB = 1 << 20
_SMALL, _MIN_LARGE, _LARGE_SEG, _ROUND_LARGE = (_MIB, 10 * _MIB, 20 * _MIB,
                                              2 * _MIB)


@dataclass
class RankStats:
    """One rank's counts for one engine run: fp32 ``flops``, other
    operations by kind (``ops``: ``popcount``, ``fp32_instructions``),
    HBM ``mem_bytes``, collective bytes by HLO kind (``coll_bytes``),
    kernel ``launches`` and the per-rank ``memory`` split."""

    flops: float = 0.0
    ops: dict = field(default_factory=dict)
    mem_bytes: float = 0.0
    coll_bytes: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    memory: dict = field(default_factory=dict)

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def add(self, name: str | None, cost: Cost, times: int = 1) -> None:
        """``times`` launches of kernel ``name`` at ``cost`` (``None``:
        work of library operators, counted but no launch of ours)."""
        work = cost.ops * times
        if cost.rate == PEAK_FP32:
            self.flops += work
        elif work:
            kind = ("popcount" if cost.rate == POPC_RATE
                    else "fp32_instructions")
            self.ops[kind] = self.ops.get(kind, 0.0) + work
        self.mem_bytes += cost.nbytes * times
        if name is not None:
            self.launches[name] = self.launches.get(name, 0) + times


_TILE = {"euclidean": "nng_tile", "hamming": "nng_tile_hamming",
         "manhattan": "nng_tile_l1"}
_GROUPED = {"euclidean": "nng_tile_grouped",
            "hamming": "nng_tile_grouped_hamming",
            "manhattan": "nng_tile_grouped_l1"}


def alloc_bytes(nbytes) -> int:
    """A buffer's size as the caching allocator counts it: rounded to its
    unit, plus the share of a segment's unsplit tail that falls to it
    (between 1 and 10 MiB: the tail of a 20 MiB segment carved into such
    blocks, spread over them; above: the tail of its own segment)."""
    b = -(-int(nbytes) // ALLOC_UNIT) * ALLOC_UNIT if nbytes > 0 else 0
    if b <= _SMALL:
        return b
    if b < _MIN_LARGE:
        per = _LARGE_SEG // b
        tail = _LARGE_SEG - per * b
        return b + (-(-tail // per) if tail <= _SMALL else 0)
    tail = -(-b // _ROUND_LARGE) * _ROUND_LARGE - b
    return b + (tail if tail <= _SMALL else 0)


def peak_bytes(argument: list, moments: dict, *,
               internal: bool = True) -> tuple[str, int]:
    """The moment with the most bytes alive -> (its name, the bytes): the
    argument and the moment's buffers, ``moments`` mapping a name to
    (operator outputs, CUDA workspaces); ``internal=False`` counts the
    outputs only, as a recording of operator outputs sees them."""
    totals = {name: sum(alloc_bytes(b) for b in
                        argument + vis + (inn if internal else []))
              for name, (vis, inn) in moments.items()}
    name = max(totals, key=totals.get)
    return name, totals[name]


def _memory(argument: list, output: list, moments: dict) -> dict:
    arg = sum(alloc_bytes(b) for b in argument)
    out = sum(alloc_bytes(b) for b in output)
    phase, peak = peak_bytes(argument, moments)
    temp = peak - arg
    return {"argument_size_bytes": arg, "output_size_bytes": out,
            "temp_size_bytes": temp, "total_bytes": arg + out + temp,
            "peak_phase": phase}


# ---------------------------------------------------------------------------
# primitives: the buffers one call holds at its own peak, inputs excluded
# (each as the operators allocate them; the workspaces are what PyTorch's
# CUDA operators hold beside their outputs, read off the card's allocator)
# ---------------------------------------------------------------------------

SORT_SCRATCH = 2048     # a CUDA row sort's workspace beside its outputs
ARGSORT_SCRATCH = 4096  # a CUDA stable row argsort's (a 2-D segmented sort)


def _sort_bufs(rows: int, cols: int) -> list:
    """``torch.sort(t, dim=-1)`` of an (rows, cols) int32 tensor: int32
    values and int64 indices."""
    return [4 * rows * cols, 8 * rows * cols]


def _merge_bufs(n: int, k: int) -> list:
    """``_merge_ids`` of two (n, k) int32 tables: the (n, 2k)
    concatenation and its sort."""
    return [8 * n * k] + _sort_bufs(n, 2 * k)


def _gathered_ids_moments(rows: int, k: int) -> dict:
    """``bits_to_gathered_ids`` into (rows, k) ids at its two peaks: the
    gather (the columns, their bool test and clamped copy, the gathered
    ids; the CUDA index's int64 copy of the clamped columns) and the sort
    (the columns, the SENTINEL-filled ids, the sort's outputs)."""
    e = rows * k
    return {"ids": ([4 * e, e, 4 * e, 4 * e], [8 * e]),
            "sort": ([4 * e, 4 * e] + _sort_bufs(rows, k), [SORT_SCRATCH])}


def _tile_bufs(metric: str, q: int, p: int) -> list:
    """One ε-tile launch (``_launch_tile``): the counts and the packed
    words, and on the persistent L2 core its fp32 norm scratch."""
    return [4 * q, 4 * q * -(-p // 32)] + (
        [4 * q, 4 * p] if metric == "euclidean" else [])


def _cdist_moments(metric: str, n: int, m: int, d: int, item: int) -> dict:
    """``metric.cdist`` of n rows against m centres at its peaks."""
    c = 4 * n * m
    if metric == "euclidean":
        # ‖x‖² (the x·x product), then ‖x‖² + ‖c‖² − 2x·c: three (n, m)
        return {"cdist: x*x": ([4 * n * d, 4 * n], []),
                "cdist: expansion": ([c, c, c, 4 * n, 4 * m], [])}
    if metric == "hamming":
        # row chunks of the (rows, m, w) xor and popcount32's int64 SWAR
        # temporaries (four at its widest step) beside the (n, m) result
        rows = min(n, max(1, (1 << 24) // max(m * d, 1)))
        e = rows * m * d
        return {"cdist: popcount": ([c, 4 * e] + [8 * e] * 4, [])}
    # l1_dist: the sum, the chunk's partial sum, a difference and its abs
    return {"cdist: l1": ([c] * 4, [])}


# ---------------------------------------------------------------------------
# the systolic ring (Algorithm 4)
# ---------------------------------------------------------------------------

def systolic_rank_stats(n: int, dim: int, metric: str, ranks: int, *,
                        k_cap: int = 128) -> RankStats:
    """One rank of ``systolic_run`` (tiles, prune and overlap on) over
    ``ranks`` ranks of ``n`` points (a multiple of ``ranks``): the busiest
    rank's work (the self tile, then two tiles a round — forward and
    mirror — for every one of the ``ranks // 2`` rounds, the even ring's
    boundary round included), each tile's ``bits_to_cols``, the hops and
    the id merges."""
    item = get_metric(metric).dtype.itemsize
    n_loc = n // ranks
    rounds = ranks // 2
    tiles = 1 + 2 * rounds
    nw = -(-n_loc // 32)
    st = RankStats()
    st.add(_TILE[metric], tile_cost(metric, n_loc, n_loc, dim), tiles)
    st.add("bits_to_cols", bits_to_cols_cost(n_loc, nw, k_cap), tiles)
    nk = n_loc * k_cap * 4
    block = n_loc * dim * item
    # a hop's payload is written where it lands: rounds + 1 point hops
    # (the priming one) and rounds + 1 mirror hops (the return home)
    st.mem_bytes += (rounds + 1) * (block + nk + 4 * n_loc)
    # each merge: concatenation (read 2, write 2), sort (read 2, write 2
    # values and 4 of int64 indices) in (n_loc, k_cap) int32 tables, and
    # each tile's ids (bits_to_ids' add and select: read 2, write 2)
    st.mem_bytes += (tiles + 1) * 12 * nk + tiles * 4 * nk
    comm = ring_comm_bytes(n, dim, item, ranks, k_cap, prune=True,
                           overlap=True)
    st.coll_bytes = {"collective-permute": (comm["ring_points"]
                                            + comm["ring_mirror"]) / ranks}
    if "ring_summary" in comm:
        st.coll_bytes["all-gather"] = comm["ring_summary"] / ranks
    st.memory = systolic_memory(n_loc, dim, item, k_cap, ranks, metric)
    return st


def systolic_buffers(n_loc: int, dim: int, item: int, k_cap: int,
                     ranks: int, metric: str) -> tuple:
    """The buffers of one rank of ``systolic_run`` (one rank a GPU) ->
    (argument, output, moments), as ``peak_bytes`` takes them. Alive the
    whole run: the rank's ones, its ``id0``, the skip and distance
    counters, the self tile's row, word and bit vectors, its diagonal and
    counts, the SENTINEL table and zero counts. The peak is a round's
    mirror merge (from round 2 on): beside them the visiting block and the
    prefetched next one; the received mirror accumulator; the rank's table
    and counts before and after the forward merge; both tiles' counts and
    the mirror tile's words; the mirror counts; the previous round's
    mirror table and counts, still named by the loop; the new ids and the
    merge's own buffers."""
    n, r = n_loc, ranks
    nk = n * k_cap * 4
    block = n * dim * item
    words = _tile_bufs(metric, n, n)[1]
    keep = [4 * n, 4, 4 * r, 4 * r, 8 * n, 8 * n, 4 * n, 4 * n, 4 * n, nk,
            4 * n]
    merge = [nk] + _merge_bufs(n, k_cap)
    moments = {"self tile merge": (
        keep + [words, 4 * n] + merge + ([block, 4] if r > 1 else []),
        [SORT_SCRATCH])}
    if r > 1:
        rounds = r // 2
        moments["round mirror merge"] = (
            keep + [block, 4] * 2 + [nk, 4 * n] + [2 * nk, 4 * n] * 2
            + [4 * n, 4 * n, words, 4 * n]
            + ([2 * nk, 4 * n] if rounds > 1 else []) + merge,
            [SORT_SCRATCH])
    argument = [n * r * dim * item]
    output = [nk, 4 * n, r, 4 * r, 4 * r, 4 * r]
    return argument, output, moments


def systolic_memory(n_loc: int, dim: int, item: int, k_cap: int,
                    ranks: int, metric: str) -> dict:
    """The per-rank memory of ``systolic_run``, one rank a GPU
    (``systolic_buffers``)."""
    return _memory(*systolic_buffers(n_loc, dim, item, k_cap, ranks,
                                     metric))


# ---------------------------------------------------------------------------
# the landmark engine (Algorithms 5 + 6), ghost_mode="coll", tiles
# ---------------------------------------------------------------------------

def landmark_rank_stats(n: int, dim: int, metric: str, ranks: int, *,
                        m_centers: int | None = None) -> RankStats:
    """One rank of ``landmark_run`` (``ghost_mode="coll"``, tiles) over
    ``ranks`` ranks of ``n`` points under ``plan_landmark(n, ranks,
    m_centers=m_centers)``, as the reference's dry run plans it: the
    Voronoi distances to every centre, the W × W and G × W grouped
    launches over every pair (no block skip) and their ``bits_to_cols``,
    the packing, exchanges and cell sorts."""
    plan = plan_landmark(n, ranks, m_centers=m_centers)
    item = get_metric(metric).dtype.itemsize
    n_loc = n // ranks
    m = plan.m_centers
    lw, lg = ranks * plan.cap_coal, ranks * plan.cap_ghost
    st = RankStats()
    st.add(None, pairwise_cost(metric, n_loc, m, dim))   # the Voronoi cdist
    st.add(_GROUPED[metric], grouped_cost(metric, lw, lw, dim))
    st.add(_GROUPED[metric], grouped_cost(metric, lg, lw, dim))
    nw = -(-lw // 32)
    st.add("bits_to_cols", bits_to_cols_cost(lw, nw, plan.k_cap))
    st.add("bits_to_cols", bits_to_cols_cost(lg, nw, plan.k_cap))
    row = dim * item + 8
    ng = n_loc * plan.g_per_pt
    # packing gathers (read + write), the send buffers, the received
    # rows and their cell-sorted copies (write + read), and each table's
    # gathered ids and their sort
    st.mem_bytes += 2 * (n_loc + ng) * row
    st.mem_bytes += (ranks + 1) * (plan.cap_coal + plan.cap_ghost) * row
    st.mem_bytes += 3 * (lw + lg) * row
    st.mem_bytes += (lw + lg) * plan.k_cap * 4 * 8
    comm = landmark_comm_bytes(n, dim, item, ranks, plan, "coll")
    st.coll_bytes = {"all-to-all": (comm["coalesce"] + comm["ghost"])
                     / ranks}
    st.memory = landmark_memory(n_loc, dim, item, ranks, plan, metric)
    return st


def landmark_buffers(n_loc: int, dim: int, item: int, ranks: int,
                     plan: LandmarkPlan, metric: str) -> tuple:
    """The buffers of one rank of ``landmark_run`` (coll, tiles; one rank
    a GPU) -> (argument, output, moments), as ``peak_bytes`` takes them.
    Alive the whole run: the whole id vector and the int64 cell-to-rank
    map. The moments: the Voronoi distances; the ghost cells' argsort and
    the ghost copies' gather into their send buffer, among the exchange's
    locals (distances, ghost scores, the argsort's indices, the cell ids:
    they live until it returns); the two exchanges; and each of the W x W
    and G x W launches' gathered ids and their sort."""
    n, r, m, g = n_loc, ranks, plan.m_centers, plan.g_per_pt
    block, c = n * dim * item, 4 * n * m
    lw, lg = r * plan.cap_coal, r * plan.cap_ghost
    ng = n * g
    run = [4 * n * r, 8 * m]                      # ids, f (int64)
    # the capacity-padded send buffers: (ranks + 1, cap) rows of points,
    # ids and cells (one trash row per destination)
    csend = [(r + 1) * plan.cap_coal * w for w in (dim * item, 4, 4)]
    gsend = [(r + 1) * plan.cap_ghost * w for w in (dim * item, 4, 4)]
    tru = [c] if metric == "euclidean" else []    # hamming's is dpc itself
    # dpc, cell, d_min, the Lemma-1 distances and bound, the ghost mask,
    # the cell ids, the coalesce's dropped count
    lemma = [c, 8 * n, 4 * n] + tru + [4 * n, n * m, 8 * m, 4]
    # the ghost scores, the argsort's indices (gcells views them), gvalid,
    # the ghosts' dropped counts
    locals_ = lemma + [c, 8 * n * m, ng, 4, 4]
    gidx = [8 * ng, 8 * ng]                       # gp, gc
    payload = [ng * dim * item, 4 * ng, 4 * ng]   # x[gp], ids, cells
    pack_keys = [8 * ng] * 7 + [ng]               # dest, key, order, ks,
    #                                               pos, row, col; ok
    w_sorted = [lw * dim * item, 4 * lw, 4 * lw]
    g_sorted = [lg * dim * item, 4 * lg, 4 * lg]
    recv_g = [lg * dim * item, 4 * lg, 4 * lg]
    nkw = lw * plan.k_cap * 4
    moments = {name: (run + [8 * m] + vis, inn) for name, (vis, inn) in
               _cdist_moments(metric, n, m, dim, item).items()}
    moments.update({
        "ghost argsort": (run + lemma + csend + [c, c, 8 * n * m],
                          [ARGSORT_SCRATCH]),
        "ghost pack: gather": (run + locals_ + csend + gidx + payload
                               + pack_keys + [gsend[0], ng * dim * item],
                               []),
        # after the loop the rank's dropped flag; a payload's stacked copy
        # and its received buffer
        "coalesce exchange": (run + locals_ + [1] + csend + gsend + gidx
                              + [lw * dim * item] * 2, []),
        # W cell-sorted; G's received rows, its valid mask and sort order,
        # and its cell-sorted rows
        "ghost exchange: gather": (run + locals_ + [1] + gsend + gidx
                                   + w_sorted + recv_g + [lg, 8 * lg]
                                   + g_sorted + [lg], []),
    })
    # a launch's counts and words stay alive while its mask becomes ids,
    # beside the query sets' 0-d counters (and the W x W's table)
    for name, rows, before in (("W x W", lw, [4] * 5),
                               ("G x W", lg, [nkw, 4 * lw] + [4] * 9)):
        held = run + w_sorted + g_sorted + before + [
            4 * rows, 4 * rows * -(-lw // 32)]
        for part, (vis, inn) in _gathered_ids_moments(rows,
                                                      plan.k_cap).items():
            moments[f"{name}: {part}"] = (held + vis, inn)
    argument = [block * r, m * dim * item]
    output = [4 * lw, nkw, 4 * lw, 4 * lg, lg * plan.k_cap * 4, 4 * lg, r,
              4 * r, 4 * r, 4 * r, 4 * r]
    return argument, output, moments


def landmark_memory(n_loc: int, dim: int, item: int, ranks: int,
                    plan: LandmarkPlan, metric: str) -> dict:
    """The per-rank memory of ``landmark_run`` (coll, tiles), one rank a
    GPU (``landmark_buffers``)."""
    return _memory(*landmark_buffers(n_loc, dim, item, ranks, plan, metric))
