#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``repro_torch`` from ``src/``
beside this file and never imports JAX or the ``repro`` package). Phases,
each printed as it runs; any failed check raises and exits non-zero:

  1. the card (nvidia-smi name and power limit), torch, the kernels' build
     (nvcc for sm_90a into build/repro_torch/, timed);
  2. each CUDA kernel against its plain PyTorch version on the card:
     ``nng_tile`` at 8192x8192x128 and two ragged shapes (bits equal except
     at pairs whose float64 d² lies within 1e-4·eps² of eps²); the kernels
     on the pipelined core (``csrc/l2_pipe.cuh``) bit for bit against the
     plain fp32 chain anchor (``l2_chain_d2_cuda``, ``csrc/l2_chain.cu``)
     at an eps exactly on a pair's fp32 d²: ``nng_tile``'s words and
     counts, ``nng_tile_grouped``'s under random groups with shared ids and
     under one group, ``eps_count``'s counts and ``pairwise_sqdist``'s d²
     clamped at 0, on ragged shapes, grids of fewer and of more tiles than
     resident blocks, and rows that are not 16-byte aligned;
     ``bits_to_cols`` bit-identical on random and real words at several k;
  3. the main path: ``build_nng`` at the ``nng-sift-1m`` shape (n = 2^20,
     d = 128, euclidean; synthetic stand-in from seed 0) on 8 logical ranks,
     with both kernels' launch counts read from that run alone; then one
     more engine run under torch.profiler (device time by kernel, idle
     share) and the CSR assembly, timed;
  4. exactness of 1024 sampled rows against float64 distances to all n
     points, computed on the card (inside the fp32 band), and against the
     plain fp32 expansion on the card (off the knife edge, below);
  5. each kernel at the main path's inputs: its output against its plain
     version's (``nng_tile`` off the knife edge, and bit for bit equal to
     ``nng_tile_grouped``'s with one group and to the chain anchor's hits,
     ``pairwise_sqdist`` to its d² clamped at 0; ``bits_to_cols``
     bit-identical), and
     its time (CUDA events, median) beside its bound, its plain version's
     time and a library yardstick (the anchor's too);
  6. the tree path on the same points: the forest built on the card, one
     traversal (block 0's points, in their forest's DFS order as the ring
     hands them, against block 1's tree; its live 64 x 256 tiles and
     128 x 128 blocks counted against the same traversal in index order)
     whose kernel inputs feed ``tree_frontier`` (off the knife edge of
     each decision; its leaf decisions bit for bit ``nng_tile``'s hits)
     and ``leaf_range_pack`` (bit-identical) against their plain versions,
     also on one live tile, ragged shapes (TMA and cp.async copies) and
     all-inactive inputs [6a]; ``build_nng(...,
     traversal="tree")`` with its launch counts [6b]; one profiled tree
     engine run [6c]; the tree graph against the tiles graph of [3] (off
     the knife edge) and the sampled rows against float64 [6d]; both
     kernels' times at the path's shapes beside their bounds, each
     bound from the launch's own inputs, the frontier's host and device
     time apart [6e]; a Gaussian block whose
     traversal takes the dense branch, its passes timed dense and from
     pair lists, with shared and per-query scopes, all equal, each
     call's peak memory within the bytes its passes were planned under
     (``traverse_pass_bytes``), and its counts equal to the tile
     kernel's [6f];
  7. Hamming at the ``nng-word2bits`` configuration's full size (399360 x
     25 words, synthetic stand-in from seed 0), eps = 40, 8 logical ranks:
     ``nng_tile_hamming`` and ``tree_frontier_hamming`` (the pipelined
     walk over the live tiles) bit-identical to their plain versions at
     the path's inputs (the frontier's leaf decisions also equal
     ``nng_tile_hamming``'s hits, and on one live tile), at ragged shapes
     with w = 1, 9, 25, 33 (4-byte copies) and 32 (TMA), and on an
     all-inactive mask [7a]; ``build_nng`` with both traversals, each
     kernel's launches from its own call, profiled, their edges, counters
     and comm_bytes equal to the parent's [7b]; the tree graph equal to
     the tiles graph and 1024 sampled rows equal to exact integer
     distances to all n points [7c]; both kernels' times beside their
     bounds, the frontier's beside the parent design's and its live
     64 x 256 tiles beside the old 128 x 128 blocks [7d];
  8. L1 on the first 2^19 of the points of [3] (a depth cut, printed with
     its reason), eps in the widest gap near 26.5 of the sampled rows'
     float64 distances: ``nng_tile_l1``
     and ``tree_frontier_l1`` against their plain versions off the L1
     knife (the frontier's traversal in DFS order, as [6a], its leaf
     decisions bit for bit ``nng_tile_l1``'s, one live tile, ragged shapes
     with TMA and cp.async copies) [8a]; ``build_nng`` with both traversals [8b]; the tree graph
     against the tiles graph off the knife and 1024 sampled rows against
     float64 inside ``HostManhattan.band_slack`` [8c]; times [8d].
  9. the spatial engine (``partition="spatial"``, Algorithms 5+6, the
     collective ghost exchange, the grouped tiles): the plan on the [3]
     points (cells, capacities, ghost copies, W and G rows a rank) and the
     three grouped kernels against their plain versions on ragged,
     all-disjoint and all-padding inputs, one live 64 x 256 tile, rows off
     16-byte alignment (the L2 kernel's 4-byte copies) and on rank 0's
     W x W and G x W [9a]; the call at n = 2^20 with its launches, and one
     profiled engine run [9b]; its graph against [3]'s off the knife and
     the sampled rows against float64 [9c]; the grouped L2 kernel's times
     beside its bound, its live 64 x 256 tiles' pairs beside the 128 x 128
     blocks', and its call's parts (the tile list, the zeroed outputs, the
     launch) timed apart [9d];
     Hamming (the [7] stand-in, a depth cut printed with its reason: the
     ghost fanout) and L1 (the [8] points and eps) through the engine,
     their graphs against the point partition's, their kernels against
     their plain versions and timed [9e];
 10. the ghost ring (``ghost_mode="ring"``: each rank's compacted block
     rotates with its Lemma-1 test as packed cell words) and the spatial
     tree flavour: the three ghost kernels against their plain versions on
     ragged inputs with m = 32, 40 and 70 cells, on disjoint cells and on
     ghost bits only outside y's cells (zero words), on keys that
     interleave in the caller's order, on fewer live tiles than resident
     blocks and on exactly one live tile; the L2 and L1 kernels (ghost row
     order, live-tile list) bit for bit, in the caller's row order,
     against their plain versions (L2 at a gap-safe eps, L1 at any) and
     against the anchors' hits under the ghost test (the chain anchor's
     d², ``nng_tile_l1``'s d) [10a]; the ring call at n = 2^20 with its
     launches and counters
     (equal to those printed before the ghost row order), the live pairs
     of the L2 kernel's tiles beside the old 128 x 128 blocks', the ghost
     kernel against its plain version (off the knife) and against the
     chain anchor's hits (bit for bit) at rank 0's round-1 launch
     of that call (captured from it), a profiled engine run, its graph
     against [3]'s off the knife and the sampled rows against float64
     [10b];
     Hamming at the full [7] stand-in through the ring (or a printed cut
     when its id tables exceed TABLE_BUDGET), its graph equal to [7]'s bit
     for bit, its kernel at its own call's launch [10c]; L1 through the
     ring at [8]'s cut (the call profiled), its graph against [8]'s off
     the knife, its edges, counters and comm_bytes equal to the parent's,
     its kernel bit for bit against its plain version and against
     ``nng_tile_l1``'s hits under the ghost test at its own call's launch
     [10d]; the tree flavour with both ghost modes at 2^20 (the ring's
     run profiled), the Hamming ring and the L1 collective exchange, each
     graph against the point partition's and its edges, counters and
     comm_bytes against the parent's, and the tree kernels against their
     plain versions at a traversal captured from each call [10e]; the
     three ghost kernels' times at their captured launches beside their
     bounds over the pairs the function needs (the live tiles' pairs
     printed beside, and for L2 and L1 the old 128 x 128 blocks' and the
     parent design's time), their plain versions' and the library
     yardstick's, and the L2 and L1 calls' parts (row order and tile
     list, gather, zeroed outputs, the launch) timed apart [10f];
 11. the distance-kernel API (the reference's ``repro.kernels``
     ``pairwise_sqdist``, ``pairwise_hamming``, ``eps_count``; no engine
     calls it): the three kernels against their plain versions and
     float64 on ragged shapes (d up to 700, w in 1, 3, 25, 26, q or p = 1),
     and ``eps_count``, ``nng_tile``, ``nng_tile_grouped`` and
     ``pairwise_sqdist`` bit for bit against the chain anchor at an eps on
     a pair's fp32 d² [11a]; at the
     reference micro-bench's 2048² shapes, timed [11b]; at full width
     through the public calls, with the launches read from those calls
     alone: 8192 of [3]'s points against one rank's block, 8192 of [7]'s
     word rows against all of them (an output past 2^31 elements, bit for
     bit), and [5]'s 131072² block counted (equal to ``nng_tile``'s cnt
     and to the row sums of the chain anchor's hits bit for bit, to
     the plain version off the knife) [11c]; their times beside their bounds,
     plain versions and library yardsticks [11d];
 12. the front end and online maintenance: the ``nng_run`` CLI in process
     at 16384 x 128 on 8 logical ranks, systolic, landmark and a systolic
     ``--updates`` replay, each reporting an exact graph [12a];
     ``OnlineNNG`` on the first 2^17 points of [3] (a printed depth cut:
     its forests are built on the host in float64), 12 operations of 1024
     points (every third a delete) with ``insert_backend="device"`` and
     then on a copy of the same initial state with ``"host"``: each
     operation's update_s, the delta traversal's elapsed_s and counters,
     the kernels' launches and the merged view's time, inserts per second,
     ``_restack``'s time, and the first insert's dists_evaluated at least
     10x below a full rebuild's [12b]; each backend's merged view against
     ``build_nng`` on the live points off the knife, 64 sampled rows
     against float64 inside ``HostEuclidean.band_slack``, and an explicit
     ``compact()`` leaving the edge keys unchanged [12c];
     ``tree_frontier`` (off the knife), ``leaf_range_pack`` and
     ``bits_to_cols`` (bit for bit) against their plain versions at every
     launch of the last device-backend insert [12d];
 13. the engines over ``torch.distributed``: an NCCL process group of one
     process holding the 8 ranks (``make_nng_mesh`` inside a group), the
     point-tiles call at [3]'s shape and arguments and the spatial
     ``coll`` call at [9b]'s, each equal to [3]'s and [9b]'s graph (edge
     keys' sha256 and the CSR), work counters, ``comm_bytes`` and plan,
     with the path's kernels' launches counted from that call alone, and
     ``elapsed_s`` beside [3]'s [13a]; 4 gloo processes on this card, 2
     ranks each (gloo moves the ranks' payloads through host memory), on
     the first 2^17 points of [3]: point tiles (both schedules), the split
     point tree, spatial ``coll`` and ``ring`` tiles, and one delta
     traversal of the next 1024 points against the processes' own block
     forests, each bit for bit the same call on ``RingMesh(8)`` in this
     process, with every process's count of the bytes its ranks moved,
     per channel, summing to ``comm_bytes`` a run, and each call's
     ``elapsed_s`` and host-staging seconds printed [13b]; NCCL across
     cards where the machine has two or more, else a line that says it did
     not run [13c]; ``OnlineNNG`` on [13b]'s processes and points, 6
     operations of 1024 points (every third a delete) with the device
     insert backend and, on a deep copy of its initial state, the host
     one, after every operation each process's new ids, edge keys, delta
     log, ``live``, counters, ``comm_bytes`` and table sizes equal to the
     same schedule on ``RingMesh(8)`` in this process, the bytes the
     processes moved summing to ``delta_bcast`` a run and their launches
     of ``tree_frontier``, ``leaf_range_pack`` and ``bits_to_cols`` to the
     one-process run's, with each operation's update_s, staging seconds
     and ``delta_bcast`` bytes printed [13d]. The kernels are built before
     any process starts.
 14. the analyzer on the card: ``run_analysis(device="cuda")`` launches
     each of the 17 kernels at its contract's probe shapes against its
     plain version (bit for bit on gap-safe inputs; ``pairwise_sqdist``
     within its summation-order bound), checks each wrapper's threshold,
     host reads and float64, runs the comm-byte audit's nine
     configurations on ``RingMesh(8)`` on the card and prints the H100
     cost model at PERF.md section 6's shapes; any fresh diagnostic fails
     the run.
 15. the paper-table modules beside the engines on the card: the
     reference bench's shapes at full width, ``synthetic_pointset(8192,
     128)`` at an eps of mean degree 50-100 (of the widest float64 gaps
     between pair d², the one the fewest pairs' fp32 d² on the card
     straddle; those pairs checked on the knife) and 4096 x 25 Hamming
     words at the integer eps nearest degree 70: ``snn_graph`` (L2),
     ``systolic_ring_host`` and ``landmark_host`` (collective ghosts with
     random centres, the ring with greedy ones) on 8 simulated ranks, the
     host graphs equal to each other and to the card's ``build_nng`` with
     ``partition="point"`` and ``"spatial"`` (L2: but for exactly the
     pairs across eps); each host call's seconds (this machine's CPU),
     phase times and ``makespan_s``, the host ring bytes beside the card's
     ``comm_bytes``, and ``build_nng``'s speed-up over ``snn_graph``.
 16. the production dry run (``repro_torch.launch.dryrun``): the model's
     table of every ``NNG_CONFIGS`` cell on the 256- and 512-rank
     layouts (roofline terms, bottleneck and per-rank memory, no device);
     then each cell's systolic and landmark engine, as ``build_nng``
     runs them from the whole input on every process (``engine_step``),
     at the 256-rank layout's points a rank on 8 gloo processes sharing
     this card, one rank each (``measure_many``), each process's peak
     device memory against the model evaluated at those 8 ranks
     (measured <= model <= MEM_SLACK x measured), the kernels each
     process launched equal to the model's count; and one ``nng_tile`` launch at each L2 cell's points a
     rank, timed, at or above 0.95 x the model's bound for that tile.

Hamming distances are exact integers: no knife. Two fp32 L1 sums in
different orders are each within d·u·D of the float64 sum D (u = 2^-24),
so they may split a pair only on the L1 knife |D − eps| <= d·u·eps.

Two fp32 evaluations of ‖x‖² + ‖y‖² − 2x·y that sum in different orders
may classify a pair differently only on the knife edge: float64
|d² − eps²| within the larger of 1e-4·eps² and KNIFE_ULPS fp32 rounding
units of ‖x‖² + ‖y‖². The second term matters for points far from the
origin, as the main path's are: one rounding unit of ‖x‖² + ‖y‖² then
exceeds 1e-4·eps².

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

CONFIG = "nng-sift-1m"  # 1M x 128 euclidean (configs/paper_nng.py)
NRANKS = 8
SEED = 0               # synthetic_pointset seed of the main path's points
EPS = 2.98             # mean degree ~70 on this point set (the paper's figure)
K_CAP = 256            # below the max degree: exactly one grow
SAMPLE = 1024          # rows checked against float64 in phase 4
SAMPLE_SEED = 1
KNIFE_REL = 1e-4       # knife edge: 1e-4·eps², or KNIFE_ULPS units of
KNIFE_ULPS = 20        # 2^-24·(‖x‖² + ‖y‖²), whichever is wider
U32 = 2.0 ** -24       # fp32 unit roundoff
DENSE_N = 8192         # [6f]: points of the Gaussian block, all queries
DENSE_N_FULL = 32768   # [6f]: its size before [7] and [8] joined the script
DENSE_N_BEFORE = 16384  # [6f]: its size before [13d] and [14] joined it
DENSE_EPS = 13.0       # [6f]: about 19 neighbours a point there
DENSE_CHUNK = 1024     # [6f]: rows a pass where the pair lists fit
HAM_CONFIG = "nng-word2bits"  # [7]: 399360 x 800 bits (configs/paper_nng.py)
HAM_EPS = 40.0         # [7]: the config's 250 links every cluster mate here
L1_TARGET = 26.5       # [8]: eps is taken from the widest gap near here
L1_N = 1 << 19         # [8], [9e]: the L1 depth cut (first rows of [3])
TIME_BUDGET_S = 670    # the whole script's time on an H100 before [9]
METRIC_K_CAP = 1024    # [7], [8]: above the max degree, so no grow
SP_CENTERS = 32        # [9]: the engine's default m for 8 ranks
SP_K_CAP = 1024        # [9]: above [3]'s max degree 966, so no grow (a
                       # grow doubles every capacity of the plan too)
HAM_SP_N = 131072      # [9e]: the Hamming depth cut (first rows of [7])
CLI_N = 16384          # [12a]: nng_run's points (synthetic, d = 128)
CLI_UPDATES = 6        # [12a]: the --updates replay's operations
CLI_BATCH = 256        # [12a]: and their batch
ON_N = 1 << 17         # [12b]: OnlineNNG's corpus (first rows of [3]), a cut
ON_B = 1024            # [12b]: points an insert or delete
ON_OPS = 12            # [12b]: operations (every third a delete)
PHASE12_S = 90         # [12]'s time budget on an H100
DIST_N = 1 << 17       # [13b]: the first rows of [3]'s points (the [12] cut)
DIST_B = 1024          # [13b]: the delta traversal's batch (the next rows)
DIST_PROCS = 4         # [13b]: gloo processes on the card, 2 ranks each
PHASE13_S = 90         # [13]'s time budget on an H100
ON13_OPS = 6           # [13d]: OnlineNNG operations of DIST_B points (every
                       # third a delete) on the processes of [13b]
PHASE13D_14_S = 90     # [13d] and [14] together on an H100
# [13b]'s calls: label, build_nng's keywords (each at eps = EPS and
# k_cap = SP_K_CAP, above every degree: no grow, so a call makes two
# engine runs), then the delta traversal
DIST_CASES = (("point tiles", {}),
              ("point tiles serial", {"overlap": False}),
              ("point tree split", {"traversal": "tree"}),
              ("spatial coll", {"partition": "spatial"}),
              ("spatial ring", {"partition": "spatial",
                                "ghost_mode": "ring"}))
TABLE_BUDGET = 32 << 30  # [9e], [10c]: all ranks' id tables on the card
P15_N = 8192           # [15]: the reference paper-table bench's sift-like
P15_DIM = 128          # shape (benchmarks/tables.py:56; 8000 there), seed 0
P15_DEG = (50, 100)    # [15]: the L2 eps's mean degree lies here (paper: 70)
P15_HAM_N = 4096       # [15]: its word2bits-like shape, 4096 x 25 words
P15_HAM_W = 25
PHASE15_S = 60         # [15]'s time budget on an H100
PHASE16_S = 45         # [16]'s time budget on an H100
MEM_SLACK = 1.25       # [16]: the model's per-rank bytes within this of the
#                        card's (and never below them)
# [10b]: tiles_scheduled, tiles_skipped, dists_evaluated of the ring call as
# the tree before the ghost kernel's row order (commit 5e86e38) printed
# them; the counters come from the reference's block schedule, which no
# kernel's order moves
RING_COUNTERS = ("6083616", "2968997", "4.08239e+11")
# [7b], [10d], [10e]: each call's edges, work counters and comm_bytes as the
# tree before the L1 ghost tile and the Hamming frontier moved onto the
# pipelined cores (commit d884014) printed them (stats_line's format); [9b]
# and [10b]: as the tree before the grouped L2 tile moved onto the pipelined
# core (commit eff1109) printed them; no kernel of this tree may move them
PARENT_STATS = {
    '[9b] spatial':
        '35759614 edges; tiles_scheduled 2703360 tiles_skipped 1855401 '
        'dists_evaluated 1.11144e+11 nodes_pruned 0; comm_bytes '
        '{"coalesce": 560235520.0, "ghost": 801149440.0}',
    '[10b] ring':
        '35759614 edges; tiles_scheduled 6083616 tiles_skipped 2968997 '
        'dists_evaluated 4.08239e+11 nodes_pruned 0; comm_bytes '
        '{"coalesce": 560235520.0, "ghost_ring": 2225184000.0}',
    '[7b] tiles':
        '19770044 edges; tiles_scheduled 36 tiles_skipped 0 '
        'dists_evaluated 8.97122e+10 nodes_pruned 0; comm_bytes '
        '{"ring_mirror": 21373747200.0, "ring_summary": 832.0, '
        '"ring_points": 199680160.0}',
    '[7b] tree':
        '19770044 edges; tiles_scheduled 36 tiles_skipped 0 '
        'dists_evaluated 1.52104e+09 nodes_pruned 1.47471e+09; comm_bytes '
        '{"ring_mirror": 21373747200.0, "ring_summary": 832.0, '
        '"ring_points": 166133760.0, "ring_forest": 600637440.0}',
    '[10d] manhattan':
        '6434535 edges; tiles_scheduled 6327720 tiles_skipped 3361906 '
        'dists_evaluated 9.71838e+10 nodes_pruned 0; comm_bytes '
        '{"coalesce": 287539200.0, "ghost_ring": 1129157120.0}',
    '[10e] tree coll':
        '35759614 edges; tiles_scheduled 0 tiles_skipped 0 dists_evaluated '
        '4.51874e+09 nodes_pruned 4.04824e+09; comm_bytes {"coalesce": '
        '560235520.0, "ghost": 801149440.0}',
    '[10e] tree ring':
        '35759614 edges; tiles_scheduled 0 tiles_skipped 0 dists_evaluated '
        '4.35725e+09 nodes_pruned 3.90251e+09; comm_bytes {"coalesce": '
        '560235520.0, "ghost_ring": 2225184000.0}',
    '[10e] hamming tree ring':
        '19770044 edges; tiles_scheduled 0 tiles_skipped 0 dists_evaluated '
        '1.05329e+09 nodes_pruned 1.01219e+09; comm_bytes {"coalesce": '
        '44886528.0, "ghost_ring": 175958784.0}',
    '[10e] manhattan tree coll':
        '6434535 edges; tiles_scheduled 0 tiles_skipped 0 dists_evaluated '
        '1.12876e+09 nodes_pruned 1.02561e+09; comm_bytes {"coalesce": '
        '287539200.0, "ghost": 372669440.0}',
}
# the parent design's times of the two kernels redesigned since (PERF.md
# section 6, rows 10 and 12: commit ad36c62's chip_smoke.py and commit
# d884014's kernel in tree_ab.py, on an NVIDIA H100 80GB HBM3 at 700.00 W),
# printed beside this run's
PARENT_MS = {"tree_frontier_hamming": "0.624 ms one level; 4.569 ms a warm "
                                      "traversal (tree_ab.py --kernels); "
                                      "128x128 blocks",
             "nng_tile_ghost_l1": "56.924 ms (128x128 blocks in the "
                                  "caller's order)"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(fields: str, fmt: str = "csv,noheader") -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                        f"--format={fmt}"], capture_output=True, text=True,
                       timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


def cuda_ms(torch, fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    each bracketed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def host_device_ms(torch, fn, reps=20):
    """``fn()``'s cost split, after one warm-up: the host's milliseconds a
    call to enqueue it (perf_counter around the calls, no sync), and the
    milliseconds a call of ``reps`` calls back to back between two CUDA
    events (the device's time when the host keeps ahead of it)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    e1.record()
    torch.cuda.synchronize()
    return host, e0.elapsed_time(e1) / reps


def events_ms(torch, fn):
    """(fn()'s result, milliseconds of that one run by CUDA events)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def dist_cases(mesh, pts, batch, eps, k_cap):
    """[13b]'s calls on ``mesh`` -> {label: what [13b] compares and
    prints}: each call's graph as the sha256 of its CSR (one array per
    edge set), counters, ``comm_bytes``, ``meta``, ``elapsed_s``, and the
    comm layer's counts in this process (``mesh.stats``: the bytes its
    ranks moved per channel, the bytes that left the process and the host
    seconds of its exchanges per channel, the host-staging seconds) and
    the kernels' launches in this process."""
    import hashlib

    import numpy as np

    from repro_torch.core.flat_tree import build_block_forests
    from repro_torch.kernels.bits_epilogue import (bits_to_cols_cuda,
                                                   leaf_range_pack_cuda)
    from repro_torch.kernels.nng_tile import (nng_tile_cuda,
                                              nng_tile_ghost_cuda,
                                              nng_tile_grouped_cuda)
    from repro_torch.kernels.tree_frontier import tree_frontier_cuda
    from repro_torch.nng import build_nng, delta_run
    kernels = (nng_tile_cuda, bits_to_cols_cuda, tree_frontier_cuda,
               leaf_range_pack_cuda, nng_tile_grouped_cuda,
               nng_tile_ghost_cuda)

    def start():
        for fn in kernels:
            fn.launches = 0
        mesh.stats.reset()
        return time.perf_counter()

    def finish(res, t0):
        res.update(wall=time.perf_counter() - t0,
                   moved=dict(mesh.stats.moved), sent=dict(mesh.stats.sent),
                   seconds=dict(mesh.stats.seconds),
                   staging_s=mesh.stats.staging_s,
                   launches={fn.__name__[:-5]: fn.launches
                             for fn in kernels if fn.launches})
        return res

    out = {}
    for label, kw in DIST_CASES:
        t0 = start()
        g = build_nng(pts, eps, mesh=mesh, k_cap=k_cap, **kw)
        st = g.stats
        out[label] = finish({
            "sha": hashlib.sha256(g.row_ptr.tobytes()
                                  + g.col_ids.tobytes()).hexdigest(),
            "edges": g.num_edges,
            "counters": {k: getattr(st, k) for k in (
                "tiles_scheduled", "tiles_skipped", "dists_evaluated",
                "nodes_pruned", "replans")},
            "comm_bytes": st.comm_bytes, "meta": g.meta,
            "elapsed_s": st.elapsed_s}, t0)
    tabs = build_block_forests(pts, mesh.size, "euclidean",
                               backend="device", device=mesh.device,
                               mesh=mesh)
    ids = np.arange(len(pts), len(pts) + len(batch))
    t0 = start()
    src, dst, st = delta_run(batch, ids, tabs, eps, mesh, k_cap=k_cap)
    pairs = np.unique(src * (len(pts) + len(batch)) + dst)
    out["delta"] = finish({
        "sha": hashlib.sha256(pairs.tobytes()).hexdigest(),
        "edges": len(pairs),
        "counters": {"dists_evaluated": st.dists_evaluated,
                     "nodes_pruned": st.nodes_pruned,
                     "replans": st.replans},
        "comm_bytes": st.comm_bytes, "meta": {},
        "elapsed_s": st.elapsed_s}, t0)
    return out


def dist_process(pts, batch, eps, k_cap, nranks, device=None):
    """A [13b] or [13c] process's side: ``dist_cases`` on the group's mesh
    of ``nranks`` ranks (on ``cuda:LOCAL_RANK`` unless ``device``)."""
    from repro_torch.core.distributed import make_nng_mesh
    mesh = make_nng_mesh(nranks, device)
    return dict(dist_cases(mesh, pts, batch, eps, k_cap),
                mesh=(mesh.size, mesh.world, mesh.rank, mesh.backend,
                      str(mesh.device)))


def online_records(o, pool, ops, batch, seed):
    """``ops`` operations on the live graph ``o`` (``OnlineNNG``), every
    third a delete of ``batch`` random live ids, the others an insert of
    ``pool``'s next ``batch`` rows -> per operation what every process of
    a mesh must share with the one-process wrapper (the new ids, edge
    keys, the delta log, ``live``, counters, ``comm_bytes``, ``meta``, the
    delta traversal's counters) and, not compared, its costs in this
    process (update_s, the host staging and the bytes this process's
    ranks moved, the delta traversal's kernels' launches)."""
    import hashlib

    import numpy as np

    from repro_torch.kernels.bits_epilogue import (bits_to_cols_cuda,
                                                   leaf_range_pack_cuda)
    from repro_torch.kernels.tree_frontier import tree_frontier_cuda
    kernels = (tree_frontier_cuda, leaf_range_pack_cuda, bits_to_cols_cuda)

    def sha(*arrays):
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    rng = np.random.default_rng(seed)
    mesh, out, cursor = o.mesh, [], 0
    for step in range(ops):
        mesh.stats.reset()
        for fn in kernels:
            fn.launches = 0
        u0 = o.stats.update_s
        if step % 3 == 2:
            ids = np.sort(rng.choice(np.flatnonzero(o.live), batch,
                                     replace=False))
            o.delete(ids)
            kind, d = "delete", None
        else:
            ids = o.insert(pool[cursor:cursor + batch])
            cursor += batch
            kind, d = "insert", o.last_update_stats
        g, st = o.graph, o.stats
        out.append({
            "kind": kind, "ids": sha(ids), "edges": sha(g.edge_key()),
            "log": sha(g.row_ptr, g.col_ids, g._add_lo, g._add_hi, g._dead),
            "live": sha(o.live), "num_edges": g.num_edges,
            "counters": {k: getattr(st, k) for k in (
                "tiles_scheduled", "tiles_skipped", "dists_evaluated",
                "nodes_pruned", "edges_added", "edges_removed")},
            "comm_bytes": dict(st.comm_bytes),
            "meta": {k: g.meta.get(k) for k in ("online", "compactions")},
            "delta": None if d is None else {
                "dists_evaluated": d.dists_evaluated,
                "nodes_pruned": d.nodes_pruned, "replans": d.replans,
                "comm_bytes": dict(d.comm_bytes)},
            "tables": {k: tuple(v.shape[1:]) for k, v in o._stacked.items()},
            # costs in this process, not compared
            "update_s": st.update_s - u0,
            "elapsed_s": None if d is None else d.elapsed_s,
            "staging_s": mesh.stats.staging_s,
            "moved": dict(mesh.stats.moved),
            "launches": {fn.__name__[:-5]: fn.launches for fn in kernels}})
    return out


ONLINE_SHARED = ("kind", "ids", "edges", "log", "live", "num_edges",
                 "counters", "comm_bytes", "meta", "delta", "tables")


def online_both(mesh, pts, pool, eps, k_cap, ops, batch, seed):
    """[13d]'s schedule on ``mesh``: ``OnlineNNG(pts)`` with the device
    insert backend, and on a deep copy of that initial state (one forest
    build serves both, as in [12b]) with the host one -> {"init_s",
    "device": records, "host": records}."""
    import copy

    from repro_torch.stream import OnlineNNG
    t0 = time.perf_counter()
    o = OnlineNNG(pts, eps, mesh=mesh, k_cap=k_cap, insert_backend="device",
                  seed=seed)
    init_s = time.perf_counter() - t0
    h = copy.deepcopy(o, {id(o.metric): o.metric, id(mesh): mesh})
    h.insert_backend = "host"
    h.graph.meta["online"]["insert_backend"] = "host"
    return {"init_s": init_s,
            "device": online_records(o, pool, ops, batch, seed),
            "host": online_records(h, pool, ops, batch, seed)}


def online_process(pts, pool, eps, k_cap, nranks, ops, batch, seed,
                   device=None):
    """A [13d] process's side: ``online_both`` on the group's mesh of
    ``nranks`` ranks (on ``cuda:LOCAL_RANK`` unless ``device``)."""
    from repro_torch.core.distributed import make_nng_mesh
    mesh = make_nng_mesh(nranks, device)
    return dict(online_both(mesh, pts, pool, eps, k_cap, ops, batch, seed),
                mesh=(mesh.size, mesh.world, mesh.rank, mesh.backend,
                      str(mesh.device)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import NNG_CONFIGS
    from repro_torch.core.distributed import (DeviceForest, dfs_row_order,
                                              make_nng_mesh, tree_traverse)
    from repro_torch.core.distributed import device as tdev
    from repro_torch.core.flat_tree import build_block_forests
    from repro_torch.core.graph import NNGraph
    from repro_torch.core.metrics import get_metric
    from repro_torch.data import synthetic_pointset
    from repro_torch import kernels as tk
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels.bits_epilogue import (SENTINEL,
                                                   bits_to_cols_cuda,
                                                   bits_to_cols_ref,
                                                   leaf_range_pack_cuda,
                                                   leaf_range_pack_ref)
    from repro_torch.kernels.nng_tile import (PIPE_TILE, eps2_f32, eps_int,
                                              ghost_hit, ghost_launch,
                                              ghost_tile_plan, grouped_hit,
                                              grouped_launch,
                                              grouped_tile_plan,
                                              hamming_dist, l1_dist,
                                              nng_tile_cuda,
                                              nng_tile_ghost_cuda,
                                              nng_tile_ghost_hamming_cuda,
                                              nng_tile_ghost_hamming_ref,
                                              nng_tile_ghost_l1_cuda,
                                              nng_tile_ghost_l1_ref,
                                              nng_tile_ghost_ref,
                                              nng_tile_grouped_cuda,
                                              nng_tile_grouped_hamming_cuda,
                                              nng_tile_grouped_hamming_ref,
                                              nng_tile_grouped_l1_cuda,
                                              nng_tile_grouped_l1_ref,
                                              nng_tile_grouped_ref,
                                              nng_tile_hamming_cuda,
                                              nng_tile_hamming_ref,
                                              nng_tile_l1_cuda,
                                              nng_tile_l1_ref, nng_tile_ref,
                                              pack_words, popcount32,
                                              unpack_words)
    from repro_torch.kernels.eps_count import eps_count_cuda, eps_count_plain
    from repro_torch.kernels.ops import (_pad_cols, _pad_rows,
                                         ghost_block_active,
                                         grouped_block_active)
    from repro_torch.kernels.pairwise_hamming import pairwise_hamming_cuda
    from repro_torch.kernels.pairwise_l2 import (l2_chain_d2_cuda,
                                                 pairwise_sqdist_cuda)
    from repro_torch.kernels.tree_frontier import (
        TN, TQ, frontier_tile_plan, tree_frontier_cuda, tree_frontier_hamming_cuda,
        tree_frontier_hamming_ref, tree_frontier_l1_cuda,
        tree_frontier_l1_ref, tree_frontier_ref)
    from repro_torch.nng import (PointPartitionEngine,
                                 SpatialPartitionEngine, build_nng)
    # the H100 cost model (the bounds printed beside every kernel's time):
    # fp32 outside the tensor cores and HBM3 bandwidth from the SXM data
    # sheet; popcounts a clock per SM (the card's rate is that times the
    # SMs and clocks.max.sm from nvidia-smi, below)
    from repro_torch.analysis import kernel_cost as kcost
    from repro_torch.analysis.kernel_cost import (PEAK_BYTES, PEAK_FP32,
                                                  POPC_PER_CLK_SM)

    cfg = NNG_CONFIGS[CONFIG]
    check(cfg.metric == "euclidean", f"{CONFIG} is not euclidean")
    N, DIM = cfg.n, cfg.dim
    # the plain versions' products in full fp32, as the kernel computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    eps2 = eps2_f32(EPS)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    def differing_pairs(a, b):
        """(rows, cols) of every bit where two packed bitmasks differ."""
        dw = a ^ b
        r, w = dw.nonzero(as_tuple=True)
        m, bit = unpack_words(dw[r, w][:, None]).nonzero(as_tuple=True)
        return r[m], w[m] * 32 + bit

    def knife_far(xa, yb, i, j, thr):
        """The pairs (xa[i], yb[j]) against the knife edge of ``thr`` in
        float64: (pairs, outside the knife, beyond 1e-4·thr, the farthest
        |d²-thr| in units of thr and in fp32 units of ‖x‖²+‖y‖²)."""
        a, b = xa[i].double(), yb[j].double()
        dev_ = (((a - b) ** 2).sum(1) - thr).abs()
        scale = (a * a).sum(1) + (b * b).sum(1)
        knife = (KNIFE_ULPS * U32 * scale).clamp_min(KNIFE_REL * thr)
        return (len(dev_), int((dev_ > knife).sum()),
                int((dev_ > KNIFE_REL * thr).sum()),
                float((dev_ / thr).max()) if len(dev_) else 0.0,
                float((dev_ / (U32 * scale)).max()) if len(dev_) else 0.0)

    def knife_check(label, xa, yb, i, j, thr):
        """Fail unless every pair (xa[i], yb[j]) lies on the knife edge of
        ``thr``, measured in float64; print how far the farthest lies."""
        n_, outside, past_rel, far_rel, far_u = knife_far(xa, yb, i, j, thr)
        print(f"    {label}: {n_} pairs differ, {past_rel} of them "
              f"beyond 1e-4·eps²; the farthest at |d²-eps²| = "
              f"{far_rel:.4g}·eps² = {far_u:.4g} fp32 units of ‖x‖²+‖y‖²")
        check(outside == 0, f"{label}: {outside} pairs differ off the knife "
                            f"edge (wider of 1e-4·eps² and {KNIFE_ULPS} "
                            "units)")

    def eps_on_pair(d2, quantile):
        """An eps whose eps2_f32(eps) is exactly one pair's fp32 d² (that
        pair on the knife edge): the first positive d² at or above
        ``quantile`` of them that is the fp32 square of an fp32, or None."""
        v = torch.unique(d2[d2 > 0])
        lo = int(quantile * max(len(v) - 1, 0))
        for val in v[lo:lo + 4096].cpu().numpy():
            e = np.float32(np.sqrt(np.float64(val)))
            for cand in (e, np.nextafter(e, np.float32(np.inf)),
                         np.nextafter(e, np.float32(0))):
                if eps2_f32(float(cand)) == float(val):
                    return float(cand)
        return None

    gen_c = torch.Generator(device=dev).manual_seed(SEED + 1)

    def packed(hit):
        """(q, p) bool -> (q, ceil(p/32)) words, the kernels' layout."""
        return pack_words(torch.nn.functional.pad(hit, (0, -hit.shape[1]
                                                        % 32)))

    def chain_check(label, x, y, yv, eps):
        """The kernels on the pipelined core (l2_pipe.cuh) against the
        plain chain anchor's d² (``l2_chain_d2_cuda``), bit for bit at
        ``eps2_f32(eps)``: nng_tile's cnt and words equal its hits with
        y_valid applied; nng_tile_grouped's its hits under the group and
        id test (random groups with padding, shared ids) and, with one
        group and disjoint ids, its hits; eps_count its row sums;
        ``pairwise_sqdist_cuda(x, y)`` its d² clamped at 0. Returns the
        pairs exactly on eps2_f32(eps)."""
        q, p = x.shape[0], y.shape[0]
        e2 = eps2_f32(eps)
        d2 = l2_chain_d2_cuda(x, y)
        hit = d2 <= e2
        i32 = dict(dtype=torch.int32, device=dev)
        xg, yg = (torch.randint(-1, 3, (n_,), generator=gen_c, device=dev)
                  .to(torch.int32) for n_ in (q, p))
        xid, yid = torch.arange(q, **i32), torch.arange(p, **i32)
        cnt_k, bits_k = nng_tile_cuda(x, y, yv, eps)
        valid = hit & (yv != 0)[None, :]
        check(torch.equal(cnt_k, valid.sum(1, dtype=torch.int32))
              and torch.equal(bits_k, packed(valid)),
              f"{label}: nng_tile differs from the chain anchor's hits")
        cnt_g, bits_g = nng_tile_grouped_cuda(x, y, xg, yg, xid, yid, eps)
        ghit = grouped_hit(hit, xg, yg, xid, yid)
        check(torch.equal(cnt_g, ghit.sum(1, dtype=torch.int32))
              and torch.equal(bits_g, packed(ghit)),
              f"{label}: nng_tile_grouped differs from the chain anchor's "
              "hits under the group test")
        cnt_o, bits_o = nng_tile_grouped_cuda(
            x, y, torch.zeros(q, **i32), torch.zeros(p, **i32), xid,
            yid + q, eps)
        check(torch.equal(cnt_o, hit.sum(1, dtype=torch.int32))
              and torch.equal(bits_o, packed(hit)),
              f"{label}: nng_tile_grouped (one group) differs from the "
              "chain anchor's hits")
        check(torch.equal(eps_count_cuda(x, y, eps), cnt_o),
              f"{label}: eps_count differs from the chain anchor's hits")
        check(torch.equal(pairwise_sqdist_cuda(x, y), d2.clamp_min(0)),
              f"{label}: pairwise_sqdist differs from the chain anchor's "
              "d² clamped at 0")
        return int((d2 == e2).sum())

    def profiled_run(label, fn, what="engine run"):
        """Run ``fn()`` once under torch.profiler, tracing the card only
        (recording every host op slowed the tree run by a third); print its
        device busy time and idle share and the top 8 kernels by device
        time, and the pipelined cores' kernels (``*pipe::``) below them.
        Reads the trace's raw events: building the profiler's
        per-event Python objects takes minutes on the tree run's million
        launches. Returns (fn's result, wall seconds)."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        by_name, spans = {}, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s0_, d_ = e.start_ns() / 1e3, e.duration_ns() / 1e3
                by_name[e.name()] = by_name.get(e.name(), 0.0) + d_ / 1e3
                spans.append((s0_, s0_ + d_))
        check(spans, f"{label}: the profiler saw no device time")
        spans.sort()
        busy, (s0, e0) = 0.0, spans[0]
        for s1, e1 in spans[1:]:
            if s1 > e0:
                busy, s0 = busy + (e0 - s0), s1
            e0 = max(e0, e1)
        busy += e0 - s0
        window = spans[-1][1] - spans[0][0]
        print(f"{label} profiled {what} {run_s:.3f} s; device busy "
              f"{busy / 1e3:.1f} ms of {window / 1e3:.1f} ms (idle share "
              f"{1 - busy / window:.4f})")
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
        for rank, (kname, ms) in enumerate(ranked):
            # the top 8, and the pipelined cores' kernels wherever they rank
            if rank < 8 or "pipe::" in kname:
                print(f"{label}   {ms:10.2f} ms  {kname[:90]}")
        return out, run_s

    def sample_check(label, graph, P):
        """The SAMPLE rows' neighbours against float64 distances to all N
        points (differences only inside the fp32 band) and against the
        plain fp32 expansion on the card (differences only on the knife
        edge)."""
        P64 = P.double()
        sq = (P64 * P64).sum(1)
        rows = np.sort(np.random.default_rng(SAMPLE_SEED).choice(
            N, SAMPLE, replace=False))
        ones_n = torch.ones(N, dtype=torch.int32, device=dev)
        mism = knife_mism = band_pairs = pop_rel = pop_knife = 0
        wit_i, wit_j = [], []
        for r0 in range(0, SAMPLE, 64):
            r = torch.from_numpy(rows[r0:r0 + 64]).to(dev)
            d2 = (sq[r][:, None] + sq[None, :]
                  - 2.0 * (P64[r] @ P64.T)).clamp_min(0)
            dist = d2.sqrt()
            truth = dist <= EPS
            truth[torch.arange(len(r), device=dev), r] = False
            got = torch.zeros_like(truth)
            for i, row in enumerate(rows[r0:r0 + 64].tolist()):
                nb = torch.from_numpy(graph.neighbors(row).astype(
                    np.int64)).to(dev)
                got[i, nb] = True
            differ = truth ^ got
            # the fp32 band of the expansion, as the repo's float64 oracle
            # sets it (HostEuclidean.band_slack): (|x|² + |y|² + eps²)·1e-5
            band = ((d2 - EPS ** 2).abs()
                    <= (sq[r][:, None] + sq[None, :] + EPS ** 2) * 1e-5
                    + 1e-9)
            bad = int((differ & ~band).sum())
            check(bad == 0, f"{label} {bad} sampled pairs differ from "
                            "float64 outside the fp32 band")
            mism += int(differ.sum())
            knife_mism += int((differ & ((dist - EPS).abs()
                                         <= 1e-5 * EPS)).sum())
            band_pairs += int(band.sum())
            # the exact witness: the plain fp32 expansion on the same points
            _, wb = nng_tile_ref(P[r], P, ones_n, EPS)
            plain = unpack_words(wb)
            plain[torch.arange(len(r), device=dev), r] = False
            i, j = (plain ^ got).nonzero(as_tuple=True)
            wit_i.append(r[i])
            wit_j.append(j)
            off = (d2 - eps2).abs()
            pop_rel += int((off <= KNIFE_REL * eps2).sum())
            scale = sq[r][:, None] + sq[None, :]
            pop_knife += int((off <= (KNIFE_ULPS * U32 * scale)
                              .clamp_min(KNIFE_REL * eps2)).sum())
            del wb, plain, off, scale, d2, dist, truth, got, differ, band
        print(f"{label} {SAMPLE} sampled rows vs float64 over all {N} "
              f"points: {mism} pairs differ, all inside the fp32 band "
              f"(|d²-eps²| <= (|x|²+|y|²+eps²)·1e-5, {band_pairs} pairs in "
              f"it); {knife_mism} of them within |d-eps| <= 1e-5·eps, "
              f"{mism - knife_mism} outside that")
        print(f"{label} the same rows against the plain fp32 expansion on "
              f"the card (knife-edge pairs: {pop_rel} within 1e-4·eps², "
              f"{pop_knife} within the knife):")
        knife_check(f"{label} graph vs plain fp32", P, P, torch.cat(wit_i),
                    torch.cat(wit_j), eps2)

    def active_blocks(act):
        """The kernel's (TQ × TN) blocks that hold an active pair of the
        packed mask ``act`` (a 0-d device tensor)."""
        m, nw = act.shape
        a = torch.nn.functional.pad((act != 0).to(torch.uint8),
                                    (0, -nw % (TN // 32), 0, -m % TQ))
        return a.view(-(-m // TQ), TQ, -1, TN // 32).amax((1, 3)).sum()

    def live_tiles(act):
        """The pipelined frontiers' live 64 x 256 tiles of the packed mask
        ``act`` (``frontier_tile_plan``'s count, a 1-element tensor)."""
        return frontier_tile_plan(act, PIPE_TILE[0], PIPE_TILE[1] // 32)[1]

    def engine_rows(X, forest0, n_loc):
        """Rank 0's block as the tree ring hands it to its traversals, in
        its own forest's DFS order -> (rows, their global ids)."""
        order = dfs_row_order(forest0, 0)
        return X[:n_loc][order].contiguous(), order.to(torch.int32)

    def traced_traverse(qp, qids, forest_r, eps, k, q_chunk=None,
                        metric="euclidean", qcells=None, ghost=None,
                        keep=True):
        """``tree_traverse`` of ``qp`` against one rank's forest, each
        frontier launch timed in place (CUDA events) and its inputs' sizes,
        active pairs, live 128 x 128 blocks and live 64 x 256 tiles kept;
        also (with ``keep``) the first pass's kernel inputs and outputs per
        level and its ``leaf_range_pack`` inputs. Returns (result, wall s,
        launches (rows, nodes, pairs, blocks, tiles, e0, e1), first pass,
        packs)."""
        launch_in, first, packs = [], [], []
        levels = forest_r.radius.shape[0]
        orig_step, orig_pack = tdev.tree_frontier_step, tdev._leaf_range_pack

        def step_spy(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig_step(*args, **kw)
            e1.record()
            act = args[4]
            launch_in.append((act.shape[0], args[1].shape[0],
                              tdev._popcount(act), active_blocks(act),
                              live_tiles(act), e0, e1))
            if keep and len(first) < levels:
                first.append(tuple(args[:5]) + tuple(out))
            return out

        def pack_spy(delta, leaf_ids, qids_):
            if keep and not packs:
                packs.append((delta, leaf_ids, qids_))
            return orig_pack(delta, leaf_ids, qids_)

        tdev.tree_frontier_step, tdev._leaf_range_pack = step_spy, pack_spy
        try:
            t0 = time.perf_counter()
            res = tree_traverse(
                qp, qids, torch.zeros_like(qids) if qcells is None and
                ghost is None else qcells, forest_r, eps, k, metric,
                qghost_bits=ghost, q_chunk=q_chunk)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tdev.tree_frontier_step, tdev._leaf_range_pack = (orig_step,
                                                              orig_pack)
        return res, wall, launch_in, first, packs

    def timed_traverse(qp, qids, forest_r, eps, k, q_chunk, sparse_div,
                       ghost=None):
        """One untraced ``tree_traverse`` with ``SPARSE_DIV`` set to
        ``sparse_div`` (1: every level from pair lists; huge: every level
        dense), with per-query ``ghost`` scope words if given. Returns
        (result, wall s, peak bytes above what was resident)."""
        keep = tdev.SPARSE_DIV
        tdev.SPARSE_DIV = sparse_div
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = tree_traverse(qp, qids, torch.zeros_like(qids), forest_r,
                                eps, k, "euclidean", qghost_bits=ghost,
                                q_chunk=q_chunk)
            torch.cuda.synchronize()
            return (res, time.perf_counter() - t0,
                    torch.cuda.max_memory_allocated() - base)
        finally:
            tdev.SPARSE_DIV = keep

    def branches(first, forest_r):
        """Per level of a traced first pass: its active pairs, and whether
        ``tree_traverse`` built its active mask and emitted its leaf ranges
        from pair lists ("pairs") or densely ("dense"), by the traversal's
        own tests on the pass's masks."""
        out = []
        for lvl, (q_, c_, _, _, act, emit, _) in enumerate(first):
            limit = tdev.pair_limit(q_.shape[0], c_.shape[0])
            if lvl == 0:
                mask = "roots"
            else:
                mask = "dense" if tdev._child_pairs(
                    first[lvl - 1][6], forest_r.child_lo[lvl - 1].long(),
                    forest_r.child_hi[lvl - 1].long(), limit) is None \
                    else "pairs"
            emission = ("dense" if tdev._set_bits(emit, limit) is None
                        else "pairs")
            out.append((int(tdev._popcount(act)), mask, emission))
        return out

    def order_counts(label, lin, X, n_loc, forest_r, eps, metric, lv):
        """The same traversal with the rows in index order (the order
        before the ring took its forests' DFS order), counted only: prints
        the live 128 x 128 blocks and 64 x 256 tiles of every launch summed,
        and of launch ``lv`` (the first pass's level lv), under both
        orders. Returns {order: (blocks, tiles, launch lv's blocks and
        tiles)}."""
        ids = torch.arange(n_loc, dtype=torch.int32, device=dev)
        blk = traced_traverse(X[:n_loc], ids, forest_r, eps, METRIC_K_CAP,
                              metric=metric, keep=False)[2]
        out = {}
        for name, ls in (("dfs", lin), ("index", blk)):
            out[name] = (sum(int(b) for _, _, _, b, *_ in ls),
                         sum(int(t) for _, _, _, _, t, *_ in ls),
                         int(ls[lv][3]), int(ls[lv][4]))
        blocks = sum(-(-r_ // TQ) * -(-n_ // TN) for r_, n_, *_ in lin)
        tiles = sum(-(-r_ // PIPE_TILE[0]) * -(-n_ // PIPE_TILE[1])
                    for r_, n_, *_ in lin)
        r_, n_ = lin[lv][:2]
        a, b = out["dfs"], out["index"]
        print(f"{label} live blocks and tiles, rows in DFS order (the "
              f"engine's) vs index order: per traversal ({len(lin)} "
              f"launches) 128x128 blocks {a[0]} vs {b[0]} of {blocks}, "
              f"64x256 tiles {a[1]} vs {b[1]} of {tiles}; at level {lv} of "
              f"the first pass ({r_}x{n_}) blocks {a[2]} vs {b[2]} of "
              f"{-(-r_ // TQ) * -(-n_ // TN)}, tiles {a[3]} vs {b[3]} of "
              f"{-(-r_ // PIPE_TILE[0]) * -(-n_ // PIPE_TILE[1])}")
        return out

    def leaf_vs_tile(label, front, tile, q, c, rad, leaf, act, eps):
        """A pipelined frontier's emit words on its active leaf pairs
        against the ε-tile kernel's hit words on the same q and c (every
        column valid), bit for bit: the frontier's leaf test is the tile's
        own (nng_tile's d², nng_tile_l1's d)."""
        emit, _ = front(q, c, rad, leaf, act, eps)
        _, hits = tile(q, c, torch.ones(c.shape[0], dtype=torch.int32,
                                        device=dev), eps)
        mask = act & pack_words(_pad_cols((leaf != 0)[None], 32, False))
        differ = int(popcount32((emit & mask) ^ (hits & mask)).sum())
        pairs = int(popcount32(mask).sum())
        check(differ == 0, f"{label}: {differ} active leaf pairs differ "
                           "from the tile kernel's hits")
        print(f"{label}: emit on the {pairs} active leaf pairs equals the "
              f"tile kernel's hits bit for bit "
              f"({int(popcount32(emit & mask).sum())} emitted)")

    def one_live_tile(act):
        """``act`` with every 64 x 256 tile but its first live one cleared:
        a launch whose plan lists exactly one live tile."""
        tq_, tw_ = PIPE_TILE[0], PIPE_TILE[1] // 32
        tiles_, count_ = frontier_tile_plan(act, tq_, tw_)
        check(int(count_[0]) > 0, "one_live_tile: no live tile")
        t = int(tiles_[0])
        nt_ = -(-act.shape[1] // tw_)
        r0, w0 = t // nt_ * tq_, t % nt_ * tw_
        one = torch.zeros_like(act)
        one[r0:r0 + tq_, w0:w0 + tw_] = act[r0:r0 + tq_, w0:w0 + tw_]
        check(int(frontier_tile_plan(one, tq_, tw_)[1][0]) == 1,
              "one_live_tile: the plan of one tile's words is not one tile")
        return one

    def level_bound(kernel, rows, nodes, pairs, feat, rate):
        """Frontier ``kernel``'s launch's least time in ms and its two
        terms (``kernel_cost.frontier_cost``): each active pair's distance
        (``rate``: the Hamming one's popcounts a second), and q, c (``feat``
        4-byte values a row), rad, leaf and the active words read once and
        the emit and expand words written once."""
        c_ = kcost.kernel_cost(kernel, rows=rows, nodes=nodes, d=feat,
                               pairs=pairs, popc_rate=rate)
        return c_.bound_ms, c_.ops, int(c_.nbytes)

    def front_bound(rows, nodes, pairs):
        """tree_frontier's bound: 2·d fp32 flops a pair at PEAK_FP32."""
        return level_bound("tree_frontier", rows, nodes, pairs, DIM,
                           PEAK_FP32)

    # -- 1. the card and the build -------------------------------------------
    print(f"[1] card: {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    _build.load()
    print(f"[1] kernels built in {_build.build_seconds:.2f} s into "
          f"{_build.BUILD_DIR}")
    for lib, log in _build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   {lib}: {line.strip()}")

    # -- 2. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(SEED)
    tile_err = 0
    real_bits = None
    for q, p, d in ((8192, 8192, 128), (1000, 777, 100), (37, 64, 3)):
        x = torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.normal(size=(p, d)).astype(np.float32)).to(dev)
        yv = torch.from_numpy((rng.random(p) > 0.1).astype(np.int32)).to(dev)
        d2_64 = torch.cdist(x.double(), y.double()) ** 2
        # eps at the 1% quantile of the pair distances
        eps = float(torch.quantile(d2_64.flatten()[:1 << 20].float(),
                                   0.01).sqrt())
        e2 = eps2_f32(eps)
        cnt_k, bits_k = nng_tile_cuda(x, y, yv, eps)
        yp, _ = _pad_rows(y, 32)
        yvp, _ = _pad_rows(yv, 32)
        cnt_p, bits_p = nng_tile_ref(x, yp, yvp, eps)
        torch.cuda.synchronize()
        differ = unpack_words(bits_k ^ bits_p)[:, :p]
        knife = (d2_64 - e2).abs() <= KNIFE_REL * e2
        outside = int((differ & ~knife).sum())
        check(bits_k.shape == (q, -(-p // 32)), f"nng_tile bits shape {bits_k.shape}")
        check(torch.equal(cnt_k, unpack_words(bits_k).sum(1, dtype=torch.int32)),
              f"nng_tile ({q},{p},{d}): cnt is not the popcount of bits")
        check(not unpack_words(bits_k)[:, p:].any(), "bits past column p set")
        check(outside == 0, f"nng_tile ({q},{p},{d}): {outside} pairs differ "
                            "from the plain version off the knife edge")
        err = int((cnt_k - cnt_p).abs().max())
        tile_err = max(tile_err, err)
        print(f"[2] nng_tile ({q},{p},{d}) eps={eps:.6g}: hits "
              f"{int(cnt_p.sum())}, pairs differing {int(differ.sum())} "
              f"(all within the knife edge), knife-edge pairs "
              f"{int(knife.sum())}, max |cnt diff| {err}")
        if real_bits is None:
            real_bits = bits_k
        del d2_64, knife, differ
    # the pipelined core's kernels against the plain chain anchor, bit for
    # bit, at an eps exactly on a pair's fp32 d²: ragged shapes (fewer
    # tiles than resident blocks), grids of more tiles than resident
    # blocks, and rows that are not 16-byte aligned (the 4-byte copy path)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen2 = torch.Generator(device=dev).manual_seed(SEED)
    pipe_cases = ([(q, p, d, None) for q, p in ((1, 1), (1, 300), (127, 129),
                                                (129, 127), (300, 1),
                                                (300, 300))
                   for d in (1, 17, 700)]
                  + [(2100, 4100, 17, None), (4096, 4096, 128, None),
                     (8192, 8192, 128, None), (300, 300, 17, "row"),
                     (1000, 777, 17, "row"), (300, 257, 128, "elem")])
    on_knife = 0
    for q, p, d, shift in pipe_cases:
        eps = None
        while eps is None:          # a tiny draw may hold no such pair
            rows_ = (q + 1, p + 1) if shift == "row" else (q, p)
            a = torch.randn(rows_[0] * d + (shift == "elem"), generator=gen2,
                            device=dev)
            b = torch.randn(rows_[1] * d + (shift == "elem"), generator=gen2,
                            device=dev)
            a = a[d:] if shift == "row" else a[1:] if shift == "elem" else a
            b = b[d:] if shift == "row" else b[1:] if shift == "elem" else b
            a, b = a.view(q, d), b.view(p, d)
            eps = eps_on_pair(l2_chain_d2_cuda(a, b), 0.02)
        check(shift is None or (a.data_ptr() % 16 and b.data_ptr() % 16),
              f"[2] the {shift} case is 16-byte aligned")
        yv = (torch.rand(p, generator=gen2, device=dev) > 0.2).to(torch.int32)
        on_knife += chain_check(f"[2] ({q},{p},{d}, {shift})", a, b, yv,
                                eps)
    print(f"[2] nng_tile, nng_tile_grouped (random groups, and one group), "
          f"eps_count and pairwise_sqdist (l2_pipe.cuh) bit-identical to the "
          f"plain chain anchor l2_chain's d² and hits on {len(pipe_cases)} "
          f"shapes (q, p in 1, 127, 129, 300, d in 1, 17, 700; 1 to 4096 "
          f"tiles against at most {2 * n_sm} resident blocks; rows off "
          f"16-byte alignment), eps on a pair's fp32 d² in each: "
          f"{on_knife} pairs exactly on eps²")
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(5000, 37))
                             .astype(np.int32)).to(dev)
    words[1::3] &= torch.roll(words[1::3], 1, 1) & torch.roll(words[1::3], 2, 1)
    words[::7] = 0
    b2c_err = 0
    for label, b in (("random words", words), ("real tile bits", real_bits)):
        counts = unpack_words(b).sum(1)
        for k in (1, 7, 64, 300):
            got, want = bits_to_cols_cuda(b, k), bits_to_cols_ref(b, k)
            b2c_err = max(b2c_err, int((got - want).abs().max()))
            check(torch.equal(got, want), f"bits_to_cols differs from its "
                                          f"plain version on {label} at k={k}")
        print(f"[2] bits_to_cols bit-identical on {label} {tuple(b.shape)} "
              f"for k in (1, 7, 64, 300); row counts "
              f"{int(counts.min())}..{int(counts.max())}")

    # -- 3. the main path ----------------------------------------------------
    pts = synthetic_pointset(N, DIM, seed=SEED)
    mesh = make_nng_mesh(NRANKS)
    del real_bits, words
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    API_KERNELS = (pairwise_sqdist_cuda, pairwise_hamming_cuda,
                   eps_count_cuda)
    for fn in (nng_tile_cuda, bits_to_cols_cuda, l2_chain_d2_cuda) + \
            API_KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    g = build_nng(pts, EPS, mesh=mesh, k_cap=K_CAP)
    wall = time.perf_counter() - t0
    launches = {"nng_tile": nng_tile_cuda.launches,
                "bits_to_cols": bits_to_cols_cuda.launches}
    chain_on_path = l2_chain_d2_cuda.launches
    api_on_path = {fn.__name__[:-5]: fn.launches for fn in API_KERNELS}
    st = g.stats
    print(f"[3] build_nng(n={N}, d={DIM}, eps={EPS}, nranks={NRANKS}, "
          f"k_cap={K_CAP}): {g.num_edges} edges, mean degree "
          f"{g.avg_degree:.2f}, max degree {int(g.degrees().max())}")
    print(f"[3] elapsed_s {st.elapsed_s:.3f} (steady-state run), call wall "
          f"{wall:.3f} s, replans {st.replans}, plan k_cap {g.meta['plan']}")
    print(f"[3] tiles_scheduled {st.tiles_scheduled:.0f} tiles_skipped "
          f"{st.tiles_skipped:.0f} dists_evaluated {st.dists_evaluated:.6g}")
    print(f"[3] comm_bytes {json.dumps(st.comm_bytes)}")
    print(f"[3] max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    print(f"[3] launches {json.dumps(launches)}; the distance-kernel API's "
          f"kernels (phase 11) on this call {json.dumps(api_on_path)}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(not any(api_on_path.values()),
          f"build_nng launched a distance-API kernel: {api_on_path}")
    check(chain_on_path == 0, f"build_nng launched the chain anchor "
                              f"{chain_on_path} times")
    check(st.replans <= 1, f"{st.replans} grows (expected at most one)")
    check(g.num_edges > 0, "the main path found no edges")

    # -- 3b. where the time goes: one more engine run at the final plan ------
    plan = int(g.meta["plan"])
    eng = PointPartitionEngine(pts, EPS, mesh, "euclidean", k_cap=plan)
    out, run_s = profiled_run("[3b]", lambda: eng.run(plan))
    t0 = time.perf_counter()
    NNGraph.from_neighbor_tables(N, eng.neighbor_tables(out))
    csr_s = time.perf_counter() - t0
    del out, eng
    print(f"[3b] CSR assembly on the card {csr_s:.3f} s")

    # -- 4. exactness on a sample --------------------------------------------
    P = torch.from_numpy(pts).to(dev)
    sample_check("[4]", g, P)

    # -- 5. times at the main path's shapes ----------------------------------
    n_loc = N // NRANKS
    k_path = int(g.meta["plan"])
    x = P[:n_loc].contiguous()
    y = P[n_loc:2 * n_loc].contiguous()
    del P
    ones = torch.ones(n_loc, dtype=torch.int32, device=dev)
    tile_ms = cuda_ms(torch, lambda: nng_tile_cuda(x, y, ones, EPS), 5)
    cnt, bits = nng_tile_cuda(x, y, ones, EPS)
    w = bits.shape[1]
    b2c_ms = cuda_ms(torch, lambda: bits_to_cols_cuda(bits, k_path), 10)
    cols = bits_to_cols_cuda(bits, k_path)

    # the plain versions run in row chunks: the whole tile's temporaries
    # (a 64 GiB d² for nng_tile) do not fit on the card
    def tile_plain():
        for r0 in range(0, n_loc, 8192):
            nng_tile_ref(x[r0:r0 + 8192], y, ones, EPS)
    tile_plain_ms = cuda_ms(torch, tile_plain, 3)

    def b2c_plain():
        for r0 in range(0, n_loc, 4096):
            bits_to_cols_ref(bits[r0:r0 + 4096], k_path)
    b2c_plain_ms = cuda_ms(torch, b2c_plain, 3)

    # each kernel's output on the main path's inputs against its plain
    # version's, chunk by chunk; the float64 d² counts the knife edge
    x64, y64 = x.double(), y.double()
    xn64, yn64 = (x64 * x64).sum(1), (y64 * y64).sum(1)
    tile_i, tile_j = [], []
    pop_rel = pop_knife = 0
    for r0 in range(0, n_loc, 8192):
        sl = slice(r0, r0 + 8192)
        cnt_p, bits_p = nng_tile_ref(x[sl], y, ones, EPS)
        check(torch.equal(cnt[sl], unpack_words(bits[sl]).sum(
            1, dtype=torch.int32)), "nng_tile: cnt is not the popcount of "
                                    "bits on the main path's tile")
        tile_err = max(tile_err, int((cnt[sl] - cnt_p).abs().max()))
        i, j = differing_pairs(bits[sl], bits_p)
        tile_i.append(i + r0)
        tile_j.append(j)
        d2 = x64[sl] @ y64.T
        d2.mul_(-2).add_(xn64[sl, None]).add_(yn64[None, :]).sub_(eps2).abs_()
        pop_rel += int((d2 <= KNIFE_REL * eps2).sum())
        knife = (xn64[sl, None] + yn64[None, :]).mul_(KNIFE_ULPS * U32)
        pop_knife += int((d2 <= knife.clamp_min_(KNIFE_REL * eps2)).sum())
        del cnt_p, bits_p, d2, knife
    print(f"[5] nng_tile on the main path's tile against its plain version "
          f"(knife-edge pairs: {pop_rel} within 1e-4·eps², {pop_knife} "
          f"within the knife):")
    knife_check("[5] nng_tile vs plain", x, y, torch.cat(tile_i),
                torch.cat(tile_j), eps2)
    del x64, y64
    # the pipelined core's kernels against the plain chain anchor on the
    # main path's tile, bit for bit: nng_tile_grouped (one group, disjoint
    # ids) equal to nng_tile; then, in row chunks, nng_tile's words and
    # counts equal to the chain's hits and pairwise_sqdist (the pipelined
    # core's dense store) to its d² clamped at 0; the chain within the
    # expansion bound of its plain version (timed). The row sums are
    # [11c]'s for eps_count on the same inputs.
    i32_5 = dict(dtype=torch.int32, device=dev)
    cnt_g5, bits_g5 = nng_tile_grouped_cuda(
        x, y, torch.zeros(n_loc, **i32_5), torch.zeros(n_loc, **i32_5),
        torch.arange(n_loc, **i32_5), torch.arange(n_loc, 2 * n_loc,
                                                   **i32_5), EPS)
    check(torch.equal(cnt, cnt_g5) and torch.equal(bits, bits_g5),
          "[5] nng_tile_grouped (one group) differs from nng_tile")
    del cnt_g5, bits_g5
    chain_cnt5 = torch.empty(n_loc, dtype=torch.int32, device=dev)
    chain_ms = chain_plain_ms = chain_err = 0.0
    xn5, yn5 = (x * x).sum(1), (y * y).sum(1)
    for r0 in range(0, n_loc, 8192):
        sl = slice(r0, r0 + 8192)
        d2c, ms_ = events_ms(torch, lambda: l2_chain_d2_cuda(x[sl], y))
        chain_ms += ms_
        hit = d2c <= eps2
        chain_cnt5[sl] = hit.sum(1, dtype=torch.int32)
        check(torch.equal(bits[sl], pack_words(hit))
              and torch.equal(cnt[sl], chain_cnt5[sl]),
              f"[5] nng_tile differs from the chain anchor's hits in rows "
              f"{r0}..{r0 + 8191}")
        del hit
        check(torch.equal(pairwise_sqdist_cuda(x[sl], y), d2c.clamp_min(0)),
              f"[5] pairwise_sqdist differs from the chain anchor's d² in "
              f"rows {r0}..{r0 + 8191}")
        plain, ms_ = events_ms(torch, lambda: (
            xn5[sl, None] + yn5[None, :]) - 2.0 * x[sl] @ y.T)
        chain_plain_ms += ms_
        diff = plain.sub_(d2c).abs_()
        del d2c
        bound = (xn5[sl, None] + yn5[None, :]).mul_(2 * (DIM + 2) * U32)
        check(bool((diff <= bound).all()), f"[5] the chain anchor leaves "
              f"the expansion bound of its plain version in rows "
              f"{r0}..{r0 + 8191}")
        chain_err = max(chain_err, float(diff.max()))
        del plain, diff, bound
    print(f"[5] nng_tile and nng_tile_grouped (one group) bit-identical to "
          f"the plain chain anchor l2_chain's hits, and pairwise_sqdist to "
          f"its d² clamped at 0, on the main path's tile: all {n_loc}x{w} "
          f"words, {n_loc} counts and {n_loc * n_loc} distances; l2_chain "
          f"{chain_ms:.3f} ms over the tile in 8192-row chunks, within "
          f"2·(d+2)·u·(‖x‖²+‖y‖²) of its plain version (max |diff| "
          f"{chain_err:.4g}, plain {chain_plain_ms:.3f} ms)")
    for r0 in range(0, n_loc, 4096):
        check(torch.equal(cols[r0:r0 + 4096],
                          bits_to_cols_ref(bits[r0:r0 + 4096], k_path)),
              f"bits_to_cols differs from its plain version on the main "
              f"path's tile at k={k_path} (rows {r0}..{r0 + 4095})")
    print(f"[5] bits_to_cols bit-identical to its plain version on the main "
          f"path's tile ({n_loc}x{w} words, k={k_path})")

    # bits_to_cols stops a row at the word holding its k-th set bit
    words_read = 0
    for r0 in range(0, n_loc, 2048):
        cum = unpack_words(bits[r0:r0 + 2048]).view(-1, w, 32).sum(-1).cumsum(1)
        full = cum[:, -1] < k_path
        first = (cum < k_path).sum(1) + 1
        words_read += int(torch.where(full, w, first).sum())
    b2c_c = kcost.bits_to_cols_cost(n_loc, w, k_path, words_read=words_read)
    b2c_bytes, b2c_bound = int(b2c_c.nbytes), b2c_c.bound_ms

    tile_c = kcost.tile_cost("euclidean", n_loc, n_loc, DIM)
    tile_flops, tile_bytes = tile_c.ops, int(tile_c.nbytes)
    tile_bound_ops, tile_bound_bytes = tile_c.ops_ms, tile_c.bytes_ms
    # the chain anchor on the same tile: the same operations, the (q, p)
    # fp32 d² out
    chain_b_bytes = (4 * 2 * n_loc * DIM + 4 * n_loc * n_loc) / PEAK_BYTES * 1e3
    chain_bound = max(tile_bound_ops, chain_b_bytes)
    chain_by = "operations" if tile_bound_ops >= chain_b_bytes else "bytes"
    del cnt, bits, cols
    torch.cuda.empty_cache()
    # yardstick, product only: the same fp32 product by one torch.mm call
    # (a 64 GiB output); the port never calls it
    lib_ms = cuda_ms(torch, lambda: torch.mm(x, y.T), 3)
    torch.cuda.empty_cache()

    print(f"[5] nng_tile ({n_loc}x{n_loc}x{DIM}): {tile_ms:.3f} ms median; "
          f"bound {max(tile_bound_ops, tile_bound_bytes):.3f} ms "
          f"(operations: {tile_flops:.4g} fp32 flops at {PEAK_FP32 / 1e12:g} "
          f"TFLOP/s = {tile_bound_ops:.3f} ms; bytes {tile_bytes} at "
          f"{PEAK_BYTES / 1e12:g} TB/s = {tile_bound_bytes:.3f} ms); "
          f"{tile_flops / tile_ms / 1e9:.2f} TFLOP/s achieved; plain version "
          f"{tile_plain_ms:.3f} ms ({n_loc // 8192} row chunks); torch.mm "
          f"product only "
          f"{lib_ms:.3f} ms; launches on the path {launches['nng_tile']}")
    print(f"[5] l2_chain, the anchor ({n_loc}x{n_loc}x{DIM} in 8192-row "
          f"chunks): {chain_ms:.3f} ms; bound {chain_bound:.3f} ms "
          f"({chain_by}); plain version {chain_plain_ms:.3f} ms; torch.mm "
          f"product only {lib_ms:.3f} ms; launches on the path "
          f"{chain_on_path}")
    print(f"[5] bits_to_cols ({n_loc}x{w} words, k={k_path}): {b2c_ms:.3f} ms "
          f"median; bound {b2c_bound:.3f} ms (bytes: {b2c_bytes} at "
          f"{PEAK_BYTES / 1e12:g} TB/s); plain version {b2c_plain_ms:.3f} ms "
          f"({n_loc // 4096} row chunks); launches on the path "
          f"{launches['bits_to_cols']}")
    print(f"[5] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 6. the tree path: traversal="tree" on the same points ---------------
    del x, y, ones
    torch.cuda.empty_cache()
    P = torch.from_numpy(pts).to(dev)
    t0 = time.perf_counter()
    forest = build_block_forests(P, NRANKS, "euclidean", backend="device")
    torch.cuda.synchronize()
    forest_s = time.perf_counter() - t0
    L, W = forest["radius"].shape[1:]
    NL = forest["leaf_ids"].shape[1]
    F = DeviceForest.from_tables(forest)
    print(f"[6a] forest built on the card in {forest_s:.3f} s: L {L} levels, "
          f"N {W} slots a level, NL {NL} leaf slots; valid slots per level "
          f"(rank 1) {(forest['cell'][1] >= 0).sum(1).tolist()}")

    # one traversal of the path (block 0's points, in its forest's DFS
    # order as the ring hands them, against block 1's tree), its frontier
    # launches timed in place, and the first query pass's kernel inputs
    # kept for the checks below
    F1 = F.rank(1)
    q0, ids0 = engine_rows(P, F.rank(0), n_loc)
    (_, trav_s, launch_in, first, packs) = traced_traverse(
        q0, ids0, F1, EPS, k_path)
    level_ms = [e0.elapsed_time(e1) for *_, e0, e1 in launch_in]
    trav_frontier_ms = sum(level_ms)
    q_chunk = first[0][0].shape[0]
    n_launch = len(launch_in)
    trav_pairs = sum(int(pr) for _, _, pr, *_ in launch_in)
    trav_blocks = sum(int(b) for _, _, _, b, *_ in launch_in)
    trav_tiles = sum(int(t) for _, _, _, _, t, *_ in launch_in)
    print(f"[6a] one traversal ({n_loc} queries in their forest's DFS order, "
          f"in passes of {q_chunk}, {n_launch} frontier launches): "
          f"{trav_s:.3f} s wall, frontier {trav_frontier_ms:.2f} ms, "
          f"{trav_pairs} active pairs, {trav_tiles} of "
          f"{n_launch * -(-q_chunk // PIPE_TILE[0]) * -(-W // PIPE_TILE[1])}"
          f" 64x256 tiles ({trav_blocks} of "
          f"{n_launch * -(-q_chunk // TQ) * -(-W // TN)} 128x128 blocks) "
          f"have one; first pass per level (ms) "
          f"{[round(v, 2) for v in level_ms[:L]]}")
    print(f"[6a] first pass per level (active pairs, mask, emission): "
          f"{branches(first, F1)}")
    # the first pass's level with the most active pairs ([6e] times it)
    lv_rep = max(range(L), key=lambda lv: int(tdev._popcount(first[lv][4])))
    live6 = order_counts("[6a]", launch_in, P, n_loc, F1, EPS, "euclidean",
                         lv_rep)
    # the same traversal untraced, as shipped and with every level dense
    ship, ship_s, ship_peak = timed_traverse(q0, ids0, F1, EPS, k_path,
                                             None, tdev.SPARSE_DIV)
    dense, dense_s, dense_peak = timed_traverse(q0, ids0, F1, EPS,
                                                k_path, None, 1 << 62)
    check(all(torch.equal(a, b) for a, b in zip(ship, dense)),
          "[6a] the traversal differs when every level goes dense")
    # the pass budget at the smoke forest's level width: each peak within
    # the bytes its passes were planned under plus the results kept (the
    # neighbour and count tables, twice over for their concatenation)
    planned6 = (tdev.traverse_pass_bytes(q_chunk, W, NL)
                + 2 * n_loc * (k_path + 1) * 4)
    print(f"[6a] the same traversal untraced: {ship_s:.3f} s wall, peak "
          f"{ship_peak} B above the resident tensors; with every level "
          f"dense {dense_s:.3f} s, peak {dense_peak} B; the same "
          f"neighbours, counts and counters; planned {planned6} B "
          f"(traverse_pass_bytes of a pass and the results)")
    check(max(ship_peak, dense_peak) <= planned6,
          f"[6a] a traversal's peak passes the {planned6} B its passes were "
          "planned under")
    del ship, dense

    def frontier_diff(q, c, rad, leaf, act):
        """tree_frontier against its plain version: (the largest per-row
        difference in emitted nodes, the (row, node) pairs whose emit or
        expand bit differs, and the threshold in d² units of the decision
        each flips)."""
        e1, x1 = tree_frontier_cuda(q, c, rad, leaf, act, EPS)
        # the plain version takes whole words of nodes: pad nodes inactive
        cp, radp, leafp = (_pad_rows(t, 32)[0] for t in (c, rad, leaf))
        di, dj, err = [], [], 0
        for r0 in range(0, q.shape[0], 1024):
            e0, x0 = tree_frontier_ref(q[r0:r0 + 1024], cp, radp, leafp,
                                       act[r0:r0 + 1024], EPS)
            err = max(err, int((unpack_words(e1[r0:r0 + 1024]).sum(1)
                                - unpack_words(e0).sum(1)).abs().max()))
            dw = (e1[r0:r0 + 1024] ^ e0) | (x1[r0:r0 + 1024] ^ x0)
            i, j = differing_pairs(dw, torch.zeros_like(dw))
            di.append(i + r0)
            dj.append(j)
            del e0, x0
        i, j = torch.cat(di), torch.cat(dj)
        # the threshold each differing pair sits at, in d² units: eps for a
        # leaf; for an internal node the nearer of eps - slack - r
        # (inclusion) and r + eps + slack (expansion)
        d = ((q[i].double() - c[j].double()) ** 2).sum(1).sqrt()
        r = rad[j].double()
        slack = (d + r + EPS) * 1e-5 + 1e-6
        t_in = (EPS - slack - r).clamp_min(0) ** 2
        t_ex = (r + EPS + slack) ** 2
        near = torch.where((d * d - t_in).abs() <= (d * d - t_ex).abs(),
                           t_in, t_ex)
        thr = torch.where(leaf[j] != 0, torch.full_like(near, eps2), near)
        return err, i, j, thr

    def frontier_vs_plain(label, q, c, rad, leaf, act):
        """tree_frontier against its plain version: emit and expand equal
        off the knife edge of the decision each differing pair flips.
        Returns the largest per-row difference in emitted nodes."""
        err, i, j, thr = frontier_diff(q, c, rad, leaf, act)
        knife_check(label, q, c, i, j, thr)
        return err

    # -- 6a. the kernels against their plain versions on the card ------------
    leaf_count = forest["leaf"][1].sum(1)
    lv_mid, lv_leaf = L // 2, int(leaf_count.argmax())
    front_err = 0
    for lv in sorted({lv_mid, lv_leaf}):
        q, c, rad, leaf, act = first[lv][:5]
        front_err = max(front_err, frontier_vs_plain(
            f"[6a] tree_frontier level {lv} ({q.shape[0]}x{c.shape[0]}, "
            f"{int(unpack_words(act).sum())} active pairs)",
            q, c, rad, leaf, act))
    q, c, rad, leaf, act = first[lv_leaf][:5]
    leaf_vs_tile(f"[6a] tree_frontier level {lv_leaf} vs nng_tile",
                 tree_frontier_cuda, nng_tile_cuda, q, c, rad, leaf, act, EPS)
    front_err = max(front_err, frontier_vs_plain(
        f"[6a] tree_frontier level {lv_leaf}, one live 64x256 tile",
        q, c, rad, leaf, one_live_tile(act)))
    gq = torch.from_numpy(rng.normal(size=(1000, 100)).astype(np.float32))
    gc = torch.from_numpy(rng.normal(size=(777, 100)).astype(np.float32))
    grad = torch.from_numpy(np.abs(rng.normal(size=777)).astype(np.float32)
                            * 3)
    gleaf = torch.from_numpy((rng.random(777) < 0.4).astype(np.int32))
    gact = torch.from_numpy(rng.random((1000, 800)) < 0.7)
    gact[:128, :256] = False
    gact[:, 777:] = False
    front_err = max(front_err, frontier_vs_plain(
        "[6a] tree_frontier ragged (1000x777x100)", gq.to(dev), gc.to(dev),
        grad.to(dev), gleaf.to(dev), pack_words(gact).to(dev)))
    # d % 4 != 0: the 4-byte cp.async copies instead of TMA
    front_err = max(front_err, frontier_vs_plain(
        "[6a] tree_frontier ragged (1000x777x99, cp.async copies)",
        gq[:, :99].contiguous().to(dev), gc[:, :99].contiguous().to(dev),
        grad.to(dev), gleaf.to(dev), pack_words(gact).to(dev)))
    zq = torch.randn(300, 16, device=dev)
    ze, zx = tree_frontier_cuda(zq, zq.repeat(2, 1)[:544],
                                torch.ones(544, device=dev),
                                torch.zeros(544, dtype=torch.int32,
                                            device=dev),
                                torch.zeros((300, 17), dtype=torch.int32,
                                            device=dev), EPS)
    check(not ze.any() and not zx.any(),
          "tree_frontier: an all-inactive mask emitted or expanded")
    print("[6a] tree_frontier with an all-inactive mask (a zero live-tile "
          "count): zero words")
    delta = torch.from_numpy(rng.integers(-1, 2, size=(5000, 4097))
                             .astype(np.int32)).to(dev)
    lids = torch.from_numpy(rng.permutation(40960)[:4096].astype(np.int32))
    lids[::7] = SENTINEL
    lids = lids.to(dev)
    qids = lids[torch.from_numpy(rng.integers(0, 4096, 5000)).to(dev)]
    pack_err = 0
    for label, (dl, li, qi) in (("random deltas", (delta, lids, qids)),
                                ("the traversal's delta", packs[0])):
        nl = li.shape[0]
        c1, b1 = leaf_range_pack_cuda(dl, li, qi)
        for r0 in range(0, dl.shape[0], 1024):
            c0, b0 = leaf_range_pack_ref(dl[r0:r0 + 1024, :nl], li,
                                         qi[r0:r0 + 1024])
            pack_err = max(pack_err,
                           int((c1[r0:r0 + 1024] - c0).abs().max()))
            check(torch.equal(c1[r0:r0 + 1024], c0)
                  and torch.equal(b1[r0:r0 + 1024], b0),
                  f"leaf_range_pack differs from its plain version on "
                  f"{label} (rows {r0}..{r0 + 1023})")
        print(f"[6a] leaf_range_pack bit-identical on {label} "
              f"{tuple(dl.shape)}, covered {int(c1.sum())}")
    print(f"[6a] script wall {time.perf_counter() - t_start:.1f} s")
    # [6e]'s kernel inputs wait on the host, so that [6b]'s peak memory is
    # the tree path's own
    first_pass = [tuple(t.cpu() for t in first[lv][:5]) for lv in range(L)]
    pack_in = tuple(t.cpu() for t in packs[0])
    del (delta, ze, zx, zq, first, packs, forest, F, F1, c1, b1, q, c, rad,
         leaf, act, dl, li, qi, q0, ids0)

    # -- 6b. the call ---------------------------------------------------------
    for fn in (nng_tile_cuda, bits_to_cols_cuda, tree_frontier_cuda,
               leaf_range_pack_cuda):
        fn.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gt = build_nng(pts, EPS, mesh=mesh, traversal="tree", k_cap=K_CAP)
    wall_t = time.perf_counter() - t0
    tree_launches = {"tree_frontier": tree_frontier_cuda.launches,
                     "leaf_range_pack": leaf_range_pack_cuda.launches,
                     "bits_to_cols": bits_to_cols_cuda.launches,
                     "nng_tile": nng_tile_cuda.launches}
    st = gt.stats
    schedule = gt.meta["ring_schedule"]
    print(f"[6b] build_nng(traversal='tree', n={N}, eps={EPS}, "
          f"nranks={NRANKS}, k_cap={K_CAP}): {gt.num_edges} edges, max "
          f"degree {int(gt.degrees().max())}; forest_backend "
          f"{gt.meta['forest_backend']}")
    print(f"[6b] build_s {st.build_s:.3f}, elapsed_s {st.elapsed_s:.3f} "
          f"(steady-state run), call wall {wall_t:.3f} s, replans "
          f"{st.replans}, ring_schedule {list(schedule)}")
    print(f"[6b] tiles_scheduled {st.tiles_scheduled:.0f} tiles_skipped "
          f"{st.tiles_skipped:.0f} dists_evaluated {st.dists_evaluated:.6g} "
          f"nodes_pruned {st.nodes_pruned:.6g}")
    print(f"[6b] comm_bytes {json.dumps(st.comm_bytes)}")
    print(f"[6b] forest L {L}, N {W}, NL {NL}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B")
    print(f"[6b] launches {json.dumps(tree_launches)}")
    need = ["tree_frontier", "leaf_range_pack", "bits_to_cols"]
    if "points" in schedule:
        need.append("nng_tile")
    check(all(tree_launches[k] > 0 for k in need),
          f"a kernel of the tree path never launched: {tree_launches}")
    print(f"[6b] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 6c. where the time goes on the tree path ----------------------------
    plan_t = int(gt.meta["plan"])
    eng = PointPartitionEngine(pts, EPS, mesh, "euclidean", k_cap=plan_t,
                               traversal="tree")
    out, _ = profiled_run("[6c]", lambda: eng.run(plan_t))
    del out, eng
    print(f"[6c] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 6d. exactness --------------------------------------------------------
    kt = torch.from_numpy(gt.edge_key()).to(dev)
    kg = torch.from_numpy(g.edge_key()).to(dev)
    only = []
    for a, b in ((kt, kg), (kg, kt)):
        pos = torch.searchsorted(b, a).clamp_max(len(b) - 1)
        only.append(a[b[pos] != a])
    diff_keys = torch.cat(only)
    print(f"[6d] tree graph vs tiles graph: {len(kt)} vs {len(kg)} edges, "
          f"{len(only[0])} only in the tree graph, {len(only[1])} only in "
          f"the tiles graph")
    knife_check("[6d] tree vs tiles", P, P, diff_keys // N, diff_keys % N,
                eps2)
    del kt, kg, diff_keys, only
    sample_check("[6d]", gt, P)
    print(f"[6d] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 6e. times at the tree path's shapes ---------------------------------
    # the first pass's level with the most active pairs, rows in the
    # engine's order
    q, c, rad, leaf, act = (t.to(dev) for t in first_pass[lv_rep])
    cq, cn = q.shape[0], c.shape[0]
    rep_pairs = int(tdev._popcount(act))
    rep_blocks = int(active_blocks(act))
    rep_tiles = int(live_tiles(act)[0])
    front_ms = cuda_ms(torch, lambda: tree_frontier_cuda(
        q, c, rad, leaf, act, EPS), 10)
    front_bound_ms, front_ops, front_nbytes = front_bound(cq, cn, rep_pairs)
    front_by = ("operations" if front_ops / PEAK_FP32
                >= front_nbytes / PEAK_BYTES else "bytes")
    # the same launch with no active pair: every block skips its distances
    zact = torch.zeros_like(act)
    skip_ms = cuda_ms(torch, lambda: tree_frontier_cuda(
        q, c, rad, leaf, zact, EPS), 10)
    skip_bytes = 4 * 3 * cq * -(-cn // 32)
    front_split = host_device_ms(torch, lambda: tree_frontier_cuda(
        q, c, rad, leaf, act, EPS))
    skip_split = host_device_ms(torch, lambda: tree_frontier_cuda(
        q, c, rad, leaf, zact, EPS))
    del zact
    # per traversal: each launch's bound from its own inputs, summed
    trav = [front_bound(r_, n_, int(pr)) for r_, n_, pr, *_ in launch_in]
    trav_bound_ms = sum(b for b, _, _ in trav)
    trav_ops = sum(o for _, o, _ in trav)
    trav_nbytes = sum(nb for _, _, nb in trav)

    def front_plain():
        for r0 in range(0, cq, 1024):
            tree_frontier_ref(q[r0:r0 + 1024], c, rad, leaf,
                              act[r0:r0 + 1024], EPS)
    front_plain_ms = cuda_ms(torch, front_plain, 3)
    front_lib_ms = cuda_ms(torch, lambda: torch.mm(q, c.T), 3)
    dl, li, qi = (t.to(dev) for t in pack_in)
    pack_ms = cuda_ms(torch, lambda: leaf_range_pack_cuda(dl, li, qi), 10)
    pack_c = kcost.leaf_range_pack_cost(dl.shape[0], NL)
    pack_bytes, pack_bound_ms = int(pack_c.nbytes), pack_c.bound_ms

    def pack_plain():
        for r0 in range(0, dl.shape[0], 1024):
            leaf_range_pack_ref(dl[r0:r0 + 1024, :NL], li, qi[r0:r0 + 1024])
    pack_plain_ms = cuda_ms(torch, pack_plain, 3)
    print(f"[6e] tree_frontier at level {lv_rep} ({cq}x{cn}x{DIM}, rows in "
          f"their forest's DFS order: {rep_pairs} active pairs in "
          f"{rep_tiles} of {-(-cq // PIPE_TILE[0]) * -(-cn // PIPE_TILE[1])}"
          f" live 64x256 tiles, {live6['index'][3]} in index order; "
          f"{rep_blocks} vs {live6['index'][2]} of "
          f"{-(-cq // TQ) * -(-cn // TN)} 128x128 blocks): {front_ms:.3f} ms "
          f"median; bound {front_bound_ms:.3f} ms ({front_by}: "
          f"{front_ops:.4g} fp32 flops of the active pairs at "
          f"{PEAK_FP32 / 1e12:g} TFLOP/s, {front_nbytes} bytes at "
          f"{PEAK_BYTES / 1e12:g} TB/s); host enqueue "
          f"{front_split[0]:.3f} ms a call, 20 calls back to back "
          f"{front_split[1]:.3f} ms a call; with no active pair (a zero "
          f"live-tile count: the plan pass and the norms) "
          f"{skip_ms:.3f} ms, host {skip_split[0]:.3f}, back to back "
          f"{skip_split[1]:.3f} (bytes bound "
          f"{skip_bytes / PEAK_BYTES * 1e3:.3f} ms); plain version "
          f"{front_plain_ms:.3f} ms ({-(-cq // 1024)} row chunks); torch.mm "
          f"product only {front_lib_ms:.3f} ms; launches on the path "
          f"{tree_launches['tree_frontier']}")
    print(f"[6e] tree_frontier per traversal: {trav_frontier_ms:.2f} ms over "
          f"{n_launch} launches, bound {trav_bound_ms:.3f} ms (the sum of "
          f"each launch's: {trav_ops:.4g} fp32 flops of {trav_pairs} active "
          f"pairs, {trav_nbytes} bytes); {trav_tiles} live 64x256 tiles "
          f"({live6['index'][1]} with the rows in index order), "
          f"{trav_blocks} 128x128 blocks with an active pair "
          f"({live6['index'][0]})")
    print(f"[6e] leaf_range_pack ({dl.shape[0]}x{NL}): {pack_ms:.3f} ms "
          f"median; bound {pack_bound_ms:.3f} ms (bytes: {pack_bytes} at "
          f"{PEAK_BYTES / 1e12:g} TB/s); plain version {pack_plain_ms:.3f} "
          f"ms ({-(-dl.shape[0] // 1024)} row chunks); launches on the path "
          f"{tree_launches['leaf_range_pack']}")
    print(f"[6e] script wall {time.perf_counter() - t_start:.1f} s")
    del q, c, rad, leaf, act, dl, li, qi

    # -- 6f. an input that takes the traversal's dense branch ----------------
    # Gaussian noise in DIM dimensions has no low-dimensional structure:
    # its cover tree is a root over DENSE_N leaves, so every (query, leaf)
    # pair is active and a pass's pair list would outgrow its budget. (The
    # builder then picks the root's centers one at a time, DENSE_N rounds,
    # which bounds DENSE_N here.)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    G = torch.randn(DENSE_N, DIM, generator=gen, device=dev)
    t0 = time.perf_counter()
    GF = DeviceForest.from_tables(build_block_forests(
        G, 1, "euclidean", backend="device")).rank(0)
    torch.cuda.synchronize()
    g_build_s = time.perf_counter() - t0
    gids = torch.arange(DENSE_N, dtype=torch.int32, device=dev)
    gq = G
    res, g_wall, g_launch, g_first, _ = traced_traverse(gq, gids, GF,
                                                        DENSE_EPS, K_CAP)
    g_br = branches(g_first, GF)
    g_pairs = max(a for a, _, _ in g_br)
    g_rows = g_first[0][0].shape[0]
    print(f"[6f] depth cut: {DENSE_N} Gaussian points, not {DENSE_N_FULL} "
          f"(nor {DENSE_N_BEFORE}, the size before [13d] and [14] joined the "
          f"script), to keep the whole script under 900 s of the 1200 a run "
          f"may take (the forest build's time grows with the square of the "
          f"points)")
    print(f"[6f] Gaussian block ({DENSE_N}x{DIM}, seed {SEED}), eps "
          f"{DENSE_EPS}: forest built in {g_build_s:.3f} s, L "
          f"{GF.radius.shape[0]}, N {GF.radius.shape[1]}; {DENSE_N} "
          f"queries in passes of "
          f"{g_rows}: per level (active pairs, mask, "
          f"emission) {g_br}; traced wall {g_wall:.3f} s, frontier "
          f"{sum(e0.elapsed_time(e1) for *_, e0, e1 in g_launch):.2f} ms")
    check(any("dense" in b for b in g_br),
          "[6f] the dense branch did not run on the Gaussian block")
    del g_first, g_launch
    # the shipped traversal, and the same passes of DENSE_CHUNK rows with
    # every level dense (the default here) and with every level from pair
    # lists (SPARSE_DIV 1: no limit), each timed alone with its peak memory;
    # then the pass budget: the shipped passes and every level dense (mask
    # and leaf-range emission), each with the block forest's one shared
    # scope and with per-query scopes (every query's ghost words hold the
    # forest's one cell: the same graph through the scoped path). Each
    # call's peak must stay within the bytes its passes were planned under
    # (traverse_pass_bytes) plus the results it keeps (the neighbour and
    # count tables, twice over for their final concatenation).
    n_g, nl_g = GF.radius.shape[1], GF.leaf_ids.shape[0]
    every_dense = 1 << 62
    all_cell0 = torch.ones((DENSE_N, 1), dtype=torch.int32, device=dev)
    runs = {}
    for label, chunk, div, gh in (
            ("default passes", None, tdev.SPARSE_DIV, None),
            (f"passes of {DENSE_CHUNK}, dense", DENSE_CHUNK, tdev.SPARSE_DIV,
             None),
            (f"passes of {DENSE_CHUNK}, pair lists", DENSE_CHUNK, 1, None),
            ("default passes, per-query scopes", None, tdev.SPARSE_DIV,
             all_cell0),
            ("default passes, every level dense", None, every_dense, None),
            ("default passes, every level dense, per-query scopes", None,
             every_dense, all_cell0),
            (f"passes of {4 * DENSE_CHUNK}, every level dense",
             4 * DENSE_CHUNK, every_dense, None),
            (f"passes of {4 * DENSE_CHUNK}, every level dense, per-query "
             f"scopes", 4 * DENSE_CHUNK, every_dense, all_cell0)):
        runs[label] = (timed_traverse(gq, gids, GF, DENSE_EPS, K_CAP, chunk,
                                      div, ghost=gh), chunk, div, gh)
    ref_out = runs["default passes"][0][0]
    kept = 2 * DENSE_N * (K_CAP + 1) * 4
    for label, ((out, wall_, peak_), chunk, div, gh) in runs.items():
        check(all(torch.equal(a, b) for a, b in zip(out, ref_out)),
              f"[6f] {label}: neighbours, counts or counters differ from "
              "the default passes")
        scoped = gh is not None
        rows = min(chunk or tdev.traverse_q_chunk(n_g, nl_g, scoped=scoped),
                   DENSE_N)
        planned = tdev.traverse_pass_bytes(rows, n_g, nl_g, scoped) + kept
        per_node = (peak_ - kept - 4 * rows * (nl_g + 1)) / (rows * n_g)
        print(f"[6f] {label}: {wall_:.3f} s wall, peak {peak_} B above the "
              f"resident tensors; passes of {rows} rows; {per_node:.3f} B a "
              f"row and node above the delta table and the results; "
              f"planned {planned} B")
        if div != 1:
            check(peak_ <= planned, f"[6f] {label}: peak {peak_} B above the "
                                    f"{planned} B its passes were planned "
                                    "under")
    # every decision on this tree is a leaf's d² test, which is the tile's
    g_cnt, g_bits = nng_tile_cuda(gq, G, torch.ones(
        DENSE_N, dtype=torch.int32, device=dev), DENSE_EPS)
    r_ = gids.long()
    diag = (g_bits[r_, r_ // 32] >> (r_ % 32)) & 1
    cnt_diff = int(((g_cnt - diag) != ref_out[1]).sum())
    print(f"[6f] {int(ref_out[1].sum())} pairs (mean degree "
          f"{float(ref_out[1].float().mean()):.2f}); counts equal to "
          f"nng_tile's less the self pair on {DENSE_N - cnt_diff} of "
          f"{DENSE_N} rows; dists_evaluated {int(ref_out[2])}; a pass "
          f"of {g_rows} rows as pair lists would list {g_pairs} pairs "
          f"at its busiest level, {64 * g_pairs} B at 64 B a pair against "
          f"the {tdev.TRAVERSE_BUDGET} B pass budget")
    check(cnt_diff == 0, "[6f] the tree's counts differ from the tile's")
    del G, GF, gq, res, runs, ref_out, out, g_bits, g_cnt, all_cell0
    torch.cuda.empty_cache()
    print(f"[6f] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 7, 8. the other metrics: shared checks ------------------------------
    KERNELS = (nng_tile_cuda, bits_to_cols_cuda, tree_frontier_cuda,
               leaf_range_pack_cuda, nng_tile_hamming_cuda, nng_tile_l1_cuda,
               tree_frontier_hamming_cuda, tree_frontier_l1_cuda,
               nng_tile_grouped_cuda, nng_tile_grouped_hamming_cuda,
               nng_tile_grouped_l1_cuda, nng_tile_ghost_cuda,
               nng_tile_ghost_hamming_cuda, nng_tile_ghost_l1_cuda)
    clk_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    popc_rate = POPC_PER_CLK_SM * n_sm * clk_mhz * 1e6
    l1_rate = kcost.L1_RATE     # fp32 instructions a second (FMA = 2 flops)

    def l1_d64(a, b):
        """Row-aligned float64 L1 distances."""
        return (a.double() - b.double()).abs().sum(1)

    def tile_vs_plain(label, kern, plain, x, y, yv, eps, rows=4096):
        """A tile kernel against its plain version (row chunks, timed
        together by CUDA events) on the same inputs. Hamming: bit-identical.
        L1: every differing pair within d·u·eps of eps in float64. Returns
        (cnt, bits, plain ms, max |cnt diff|)."""
        cnt, bits = kern(x, y, yv, eps)
        yp, yvp = _pad_rows(y, 32)[0], _pad_rows(yv, 32)[0]
        nw = bits.shape[1]
        di, dj, err, plain_ms = [], [], 0, 0.0
        for r0 in range(0, x.shape[0], rows):
            sl = slice(r0, r0 + rows)
            (c0, b0), ms = events_ms(torch, lambda: plain(x[sl], yp, yvp, eps))
            plain_ms += ms
            err = max(err, int((cnt[sl] - c0).abs().max()))
            u = unpack_words(bits[sl])
            check(torch.equal(cnt[sl], u.sum(1, dtype=torch.int32)),
                  f"{label}: cnt is not the popcount of bits")
            check(not u[:, y.shape[0]:].any(), f"{label}: bits past column p")
            i, j = differing_pairs(bits[sl], b0[:, :nw])
            di.append(i + r0)
            dj.append(j)
            del c0, b0, u
        i, j = torch.cat(di), torch.cat(dj)
        if x.dtype == torch.int32:
            check(len(i) == 0 and err == 0, f"{label}: {len(i)} pairs differ "
                                            "from the plain version")
            print(f"{label}: bit-identical to its plain version, "
                  f"{int(cnt.sum())} hits, plain version {plain_ms:.3f} ms")
        else:
            off = (l1_d64(x[i], y[j]) - eps).abs() / (U32 * eps)
            far = float(off.max()) if len(off) else 0.0
            print(f"{label}: {int(cnt.sum())} hits; {len(i)} pairs differ "
                  f"from the plain version, the farthest at |d64-eps| = "
                  f"{far:.4g} u·eps (knife {x.shape[1]} u·eps); max |cnt "
                  f"diff| {err}; plain version {plain_ms:.3f} ms")
            check(far <= x.shape[1], f"{label}: pairs differ off the L1 knife")
        return cnt, bits, plain_ms, err

    def frontier_vs_plain_m(label, kern, plain, q, c, rad, leaf, act, eps):
        """A Hamming or L1 frontier kernel against its plain version.
        Hamming: bit-identical. L1: every differing pair within d·u of the
        threshold its decision tests (eps at a leaf; the nearer of
        eps - slack - r and r + eps + slack at an internal node), by its
        float64 distance. Returns the largest per-row emit-count
        difference."""
        e1, x1 = kern(q, c, rad, leaf, act, eps)
        cp, radp, leafp = (_pad_rows(t, 32)[0] for t in (c, rad, leaf))
        di, dj, err = [], [], 0
        for r0 in range(0, q.shape[0], 1024):
            sl = slice(r0, r0 + 1024)
            e0, x0 = plain(q[sl], cp, radp, leafp, act[sl], eps)
            err = max(err, int((unpack_words(e1[sl]).sum(1)
                                - unpack_words(e0).sum(1)).abs().max()))
            i, j = differing_pairs((e1[sl] ^ e0) | (x1[sl] ^ x0),
                                   torch.zeros_like(e0))
            di.append(i + r0)
            dj.append(j)
        i, j = torch.cat(di), torch.cat(dj)
        if q.dtype == torch.int32:
            check(len(i) == 0, f"{label}: {len(i)} pairs differ from the "
                               "plain version")
            print(f"{label}: bit-identical to its plain version (emit "
                  f"{int(unpack_words(e1).sum())}, expand "
                  f"{int(unpack_words(x1).sum())})")
            return err
        d = l1_d64(q[i], c[j])
        r = rad[j].double()
        slack = (d + r + eps) * 1e-5 + 1e-6
        t_in, t_ex = eps - slack - r, r + eps + slack
        thr = torch.where((d - t_in).abs() <= (d - t_ex).abs(), t_in, t_ex)
        thr = torch.where(leaf[j] != 0, torch.full_like(thr, eps), thr)
        off = (d - thr).abs() / (U32 * thr.abs().clamp_min(d))
        far = float(off.max()) if len(off) else 0.0
        print(f"{label}: {len(i)} pairs differ from the plain version, the "
              f"farthest at |d64-threshold| = {far:.4g} u·threshold (knife "
              f"{q.shape[1]} u)")
        check(far <= q.shape[1], f"{label}: pairs differ off the L1 knife")
        return err

    def stats_line(g_):
        """A call's edges, work counters and comm_bytes, as PARENT_STATS
        holds them."""
        st_ = g_.stats
        return (f"{g_.num_edges} edges; tiles_scheduled "
                f"{st_.tiles_scheduled:.0f} tiles_skipped "
                f"{st_.tiles_skipped:.0f} dists_evaluated "
                f"{st_.dists_evaluated:.6g} nodes_pruned "
                f"{st_.nodes_pruned:.6g}; comm_bytes "
                f"{json.dumps(st_.comm_bytes)}")

    def parent_check(label, g_):
        """Fail unless call ``label``'s ``stats_line`` is the parent's."""
        got, want = stats_line(g_), PARENT_STATS[label]
        check(got == want, f"{label}: the graph or the counters moved: "
                           f"{got}, the parent's {want}")
        print(f"{label} edges, counters and comm_bytes equal the parent's "
              f"(PARENT_STATS): {got}")

    def graph_call(label, pts_, eps, metric, traversal):
        """``build_nng`` on the 8 logical ranks under torch.profiler, with
        every kernel's launches counted from this call alone."""
        for fn in KERNELS:
            fn.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g_, wall_ = profiled_run(label, lambda: build_nng(
            pts_, eps, metric=metric, mesh=mesh, traversal=traversal,
            k_cap=METRIC_K_CAP), what="build_nng call")
        st_ = g_.stats
        launches_ = {fn.__name__[:-5]: fn.launches for fn in KERNELS
                     if fn.launches}
        print(f"{label} build_nng(metric={metric!r}, traversal={traversal!r}"
              f", eps={eps:.9g}, nranks={NRANKS}): {g_.num_edges} edges, mean "
              f"degree {g_.avg_degree:.2f}, max degree "
              f"{int(g_.degrees().max())}; elapsed_s {st_.elapsed_s:.3f} "
              f"(steady-state run), build_s {st_.build_s:.3f}, replans "
              f"{st_.replans}, plan {g_.meta['plan']}, ring_schedule "
              f"{list(g_.meta.get('ring_schedule', ()))}")
        print(f"{label} tiles_scheduled {st_.tiles_scheduled:.0f} "
              f"tiles_skipped {st_.tiles_skipped:.0f} dists_evaluated "
              f"{st_.dists_evaluated:.6g} nodes_pruned {st_.nodes_pruned:.6g};"
              f" comm_bytes {json.dumps(st_.comm_bytes)}; "
              f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
        print(f"{label} launches {json.dumps(launches_)}")
        tag = "hamming" if metric == "hamming" else "l1"
        need = ([f"nng_tile_{tag}", "bits_to_cols"] if traversal == "tiles"
                else [f"tree_frontier_{tag}", "leaf_range_pack",
                      "bits_to_cols"])
        if "points" in g_.meta.get("ring_schedule", ()):
            need.append(f"nng_tile_{tag}")
        check(all(launches_.get(k, 0) > 0 for k in need),
              f"{label}: a kernel of the path never launched: {launches_}")
        check(g_.num_edges > 0, f"{label}: no edges")
        return g_, launches_

    def library_rows(fn, x, y, rows=8192):
        """Milliseconds of the library yardstick ``fn(x_rows, y)`` over row
        chunks of x, outputs dropped as they come (torch.cdist refuses a
        whole 49920² tile with cudaErrorInvalidConfiguration, and a
        131072² output would not fit beside the inputs)."""
        def run():
            for r0 in range(0, x.shape[0], rows):
                fn(x[r0:r0 + rows], y)
        return events_ms(torch, run)[1]

    def edge_diff(ga, gb, n):
        """Edges in one graph and not the other, as (i, j) on the card."""
        ka = torch.from_numpy(ga.edge_key()).to(dev)
        kb = torch.from_numpy(gb.edge_key()).to(dev)
        only = []
        for a, b in ((ka, kb), (kb, ka)):
            pos = torch.searchsorted(b, a).clamp_max(len(b) - 1)
            only.append(a[b[pos] != a])
        k = torch.cat(only)
        return k // n, k % n, [len(o) for o in only]

    def traversal_inputs(label, X, n_loc, eps, metric):
        """The forest of X on the card, then one traced traversal (block 0's
        points, in their forest's DFS order as the ring hands them, against
        block 1's tree; after an untimed one), and its live tiles against
        the rows in index order
        (``order_counts``) -> (launch records, first pass's kernel inputs
        per level, forest L, the order counts)."""
        t0 = time.perf_counter()
        fo = build_block_forests(X, NRANKS, metric, backend="device")
        torch.cuda.synchronize()
        build_s_ = time.perf_counter() - t0
        Lm, Wm = fo["radius"].shape[1:]
        Fm = DeviceForest.from_tables(fo)
        F1_ = Fm.rank(1)
        qs, ids = engine_rows(X, Fm.rank(0), n_loc)
        # an untimed traversal first, so that the timed one's launches hold
        # no one-time cost (module loads, the first launches' set-up)
        tree_traverse(qs, ids, torch.zeros_like(ids), F1_, eps, METRIC_K_CAP,
                      metric)
        torch.cuda.synchronize()
        _, wall_, lin, fst, _ = traced_traverse(qs, ids, F1_, eps,
                                                METRIC_K_CAP, metric=metric)
        print(f"{label} forest built on the card in {build_s_:.3f} s: L {Lm},"
              f" N {Wm}, NL {fo['leaf_ids'].shape[1]}; one traversal "
              f"({n_loc} queries in their forest's DFS order, in passes of "
              f"{fst[0][0].shape[0]}, {len(lin)} frontier launches) "
              f"{wall_:.3f} s wall, frontier "
              f"{sum(e0.elapsed_time(e1) for *_, e0, e1 in lin):.2f} ms; "
              f"first pass per level (active pairs, mask, emission) "
              f"{branches(fst, F1_)}")
        busiest = max(range(Lm), key=lambda l: int(tdev._popcount(fst[l][4])))
        live = order_counts(label, lin, X, n_loc, F1_, eps, metric, busiest)
        del fo, Fm, qs
        return lin, fst, Lm, live

    def frontier_times(label, kern, plain, lin, fst, eps, feat, pair_ops,
                       rate, library, live, prep=lambda t: t):
        """The frontier kernel at the first pass's busiest level, its bound
        from that launch's inputs, the plain version (row chunks) and the
        library call ``library(prep(q), prep(c))`` (``prep`` untimed); and
        per traversal, the sum of each launch's bound; with the live tiles
        and blocks under both row orders (``live``, ``order_counts``).
        Returns (ms, plain ms, bound ms, bound_by, library ms)."""
        lv = max(range(len(fst)), key=lambda l: int(tdev._popcount(fst[l][4])))
        q, c, rad, leaf, act = fst[lv][:5]
        pairs = int(tdev._popcount(act))
        ms = cuda_ms(torch, lambda: kern(q, c, rad, leaf, act, eps), 10)
        split = host_device_ms(torch, lambda: kern(q, c, rad, leaf, act,
                                                   eps))
        bound, ops, nbytes = level_bound(kern.__name__[:-5], q.shape[0],
                                         c.shape[0], pairs, feat, rate)
        by = "operations" if ops / rate >= nbytes / PEAK_BYTES else "bytes"

        def run_plain():
            for r0 in range(0, q.shape[0], 1024):
                plain(q[r0:r0 + 1024], c, rad, leaf, act[r0:r0 + 1024], eps)
        plain_ms = events_ms(torch, run_plain)[1]
        lib_ms = library_rows(library, prep(q), prep(c))
        trav = [level_bound(kern.__name__[:-5], r_, n_, int(pr), feat,
                            rate) for r_, n_, pr, *_ in lin]
        trav_ms = sum(e0.elapsed_time(e1) for *_, e0, e1 in lin)
        print(f"{label} level {lv} ({q.shape[0]}x{c.shape[0]}x{feat}, rows "
              f"in their forest's DFS order: {pairs} active pairs in "
              f"{int(live_tiles(act)[0])} of "
              f"{-(-q.shape[0] // PIPE_TILE[0]) * -(-c.shape[0] // PIPE_TILE[1])}"
              f" live 64x256 tiles, {live['index'][3]} in index order; "
              f"{int(active_blocks(act))} vs {live['index'][2]} of "
              f"{-(-q.shape[0] // TQ) * -(-c.shape[0] // TN)} 128x128 "
              f"blocks): "
              f"{ms:.3f} ms median (host enqueue {split[0]:.3f} ms a call, "
              f"20 calls back to back {split[1]:.3f} ms a call); bound "
              f"{bound:.3f} ms ({by}: {ops:.4g} "
              f"operations at {rate:.4g}/s, {nbytes} bytes at "
              f"{PEAK_BYTES / 1e12:g} TB/s); plain version {plain_ms:.3f} ms "
              f"({-(-q.shape[0] // 1024)} row chunks, one run); library "
              f"{lib_ms:.3f} ms (distances only, one run in rows of 8192)")
        print(f"{label} per traversal: {trav_ms:.2f} ms over {len(lin)} "
              f"launches, bound {sum(b for b, _, _ in trav):.3f} ms (the sum "
              f"of each launch's: {sum(o for _, o, _ in trav):.4g} operations"
              f", {sum(nb for _, _, nb in trav)} bytes); live 64x256 tiles "
              f"{live['dfs'][1]} ({live['index'][1]} in index order), "
              f"128x128 blocks {live['dfs'][0]} ({live['index'][0]})")
        if kern.__name__[:-5] in PARENT_MS:
            print(f"{label} the parent design at the same level and "
                  f"traversal: {PARENT_MS[kern.__name__[:-5]]}")
        return ms, plain_ms, bound, by, lib_ms

    print(f"[7] popcount rate {popc_rate:.4g}/s = {POPC_PER_CLK_SM} a clock "
          f"per SM (CUDA C++ Programming Guide, compute capability 9.0) x "
          f"{n_sm} SMs x clocks.max.sm {clk_mhz:g} MHz (nvidia-smi)")

    # -- 7a. Hamming: the kernels against their plain versions ---------------
    hcfg = NNG_CONFIGS[HAM_CONFIG]
    check(hcfg.metric == "hamming", f"{HAM_CONFIG} is not hamming")
    HN, HW = hcfg.n, hcfg.dim
    hn_loc = HN // NRANKS
    t0 = time.perf_counter()
    hpts = synthetic_pointset(HN, HW, "hamming", seed=SEED)
    H = get_metric("hamming").as_device(hpts, dev)
    print(f"[7a] {HAM_CONFIG}: {HN} x {HW} words (synthetic_pointset seed "
          f"{SEED}, {time.perf_counter() - t0:.2f} s), eps {HAM_EPS} (the "
          f"configuration's eps {hcfg.eps} links every cluster mate on this "
          f"stand-in), {NRANKS} ranks of {hn_loc}")
    hx = H[:hn_loc].contiguous()
    hy = H[hn_loc:2 * hn_loc].contiguous()
    hones = torch.ones(hn_loc, dtype=torch.int32, device=dev)
    _, hbits, ham_plain_ms, ham_err = tile_vs_plain(
        f"[7a] nng_tile_hamming ({hn_loc},{hn_loc},{HW}) at the path's "
        f"inputs", nng_tile_hamming_cuda, nng_tile_hamming_ref, hx, hy, hones,
        HAM_EPS)
    del hbits
    for q, p, w in ((1000, 777, 25), (37, 64, 3), (130, 300, 9)):
        x = torch.from_numpy(rng.integers(-2**31, 2**31, size=(q, w))
                             .astype(np.int32)).to(dev)
        y = torch.from_numpy(rng.integers(-2**31, 2**31, size=(p, w))
                             .astype(np.int32)).to(dev)
        x[::7] = -1                       # all ones: 0xFFFFFFFF
        y[::5] = x[0]
        yv = torch.from_numpy((rng.random(p) > 0.1).astype(np.int32)).to(dev)
        eps = float(torch.quantile(hamming_dist(x, y).flatten().float(),
                                   0.05)) + 0.5
        tile_vs_plain(f"[7a] nng_tile_hamming ragged ({q},{p},{w}) eps={eps}",
                      nng_tile_hamming_cuda, nng_tile_hamming_ref, x, y, yv,
                      eps)
    h_launch, h_first, hL, h_live = traversal_inputs("[7a]", H, hn_loc,
                                                     HAM_EPS, "hamming")
    leaf_lv = max(range(hL), key=lambda l: int(h_first[l][3].sum()))
    for lv in sorted({hL // 2, leaf_lv}):
        q, c, rad, leaf, act = h_first[lv][:5]
        ham_err = max(ham_err, frontier_vs_plain_m(
            f"[7a] tree_frontier_hamming level {lv} ({q.shape[0]}x"
            f"{c.shape[0]}, {int(tdev._popcount(act))} active pairs)",
            tree_frontier_hamming_cuda, tree_frontier_hamming_ref, q, c, rad,
            leaf, act, HAM_EPS))
    q, c, rad, leaf, act = h_first[leaf_lv][:5]
    leaf_vs_tile(f"[7a] tree_frontier_hamming level {leaf_lv} vs "
                 f"nng_tile_hamming", tree_frontier_hamming_cuda,
                 nng_tile_hamming_cuda, q, c, rad, leaf, act, HAM_EPS)
    ham_err = max(ham_err, frontier_vs_plain_m(
        f"[7a] tree_frontier_hamming level {leaf_lv}, one live 64x256 tile",
        tree_frontier_hamming_cuda, tree_frontier_hamming_ref, q, c, rad,
        leaf, one_live_tile(act), HAM_EPS))
    grad = torch.from_numpy((rng.random(777) * 150).astype(np.float32)).to(dev)
    gleaf = torch.from_numpy((rng.random(777) < 0.4).astype(np.int32)).to(dev)
    gact = torch.from_numpy(rng.random((1000, 800)) < 0.7)
    gact[:128, :256] = False
    gact[:, 777:] = False
    gact = pack_words(gact).to(dev)
    # w = 9, 1, 25, 33: the 4-byte copies; w = 32: TMA
    for gw in (9, 1, 25, 33, 32):
        gq = torch.from_numpy(rng.integers(-2**31, 2**31, size=(1000, gw))
                              .astype(np.int32)).to(dev)
        gc = torch.cat([gq[:500] ^ 1, torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(277, gw)).astype(np.int32)).to(dev)])
        geps = float(torch.quantile(hamming_dist(gq, gc).flatten().float(),
                                    0.05)) + 0.5
        ham_err = max(ham_err, frontier_vs_plain_m(
            f"[7a] tree_frontier_hamming ragged (1000x777x{gw}) eps={geps}",
            tree_frontier_hamming_cuda, tree_frontier_hamming_ref, gq, gc,
            grad * gw / 9, gleaf, gact, geps))
    ze, zx = tree_frontier_hamming_cuda(gq, gc, grad, gleaf,
                                        torch.zeros_like(gact), 100.0)
    check(not ze.any() and not zx.any(),
          "tree_frontier_hamming: an all-inactive mask emitted or expanded")
    print("[7a] tree_frontier_hamming with an all-inactive mask (a zero "
          "live-tile count): zero words")
    print(f"[7a] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 7b. the calls --------------------------------------------------------
    gh, h_tiles_l = graph_call("[7b] tiles", hpts, HAM_EPS, "hamming",
                               "tiles")
    ght, h_tree_l = graph_call("[7b] tree", hpts, HAM_EPS, "hamming", "tree")
    parent_check("[7b] tiles", gh)
    parent_check("[7b] tree", ght)
    print(f"[7b] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 7c. exactness: tree = tiles, and sampled rows exact ------------------
    check(np.array_equal(ght.edge_key(), gh.edge_key()),
          "[7c] the tree graph differs from the tiles graph")
    print(f"[7c] the tree graph equals the tiles graph ({gh.num_edges} edges,"
          f" mean degree {gh.avg_degree:.2f})")
    # exact integer distances by an independent route: the bits as 0/1 fp32
    # and d = |x| + |y| - 2 x·y (every sum below 2^24, so exact in fp32)
    U = unpack_words(H).to(torch.float32)
    un = U.sum(1)
    hrows = np.sort(np.random.default_rng(SAMPLE_SEED).choice(
        HN, SAMPLE, replace=False))
    for r0 in range(0, SAMPLE, 64):
        r = torch.from_numpy(hrows[r0:r0 + 64]).to(dev)
        dd = un[r][:, None] + un[None, :] - 2.0 * (U[r] @ U.T)
        truth = dd <= eps_int(HAM_EPS)
        truth[torch.arange(len(r), device=dev), r] = False
        got = torch.zeros_like(truth)
        for i, row in enumerate(hrows[r0:r0 + 64].tolist()):
            got[i, torch.from_numpy(gh.neighbors(row).astype(np.int64))
                .to(dev)] = True
        check(torch.equal(truth, got), f"[7c] sampled rows {r0}.. differ "
                                       "from the exact distances")
        del dd, truth, got
    print(f"[7c] {SAMPLE} sampled rows equal the exact integer distances to "
          f"all {HN} points (computed on the card from the unpacked bits)")

    # -- 7d. times at the path's shapes ---------------------------------------
    hnw = -(-hn_loc // 32)
    ham_ms = cuda_ms(torch, lambda: nng_tile_hamming_cuda(hx, hy, hones,
                                                          HAM_EPS), 5)
    ham_c = kcost.tile_cost("hamming", hn_loc, hn_loc, HW,
                            popc_rate=popc_rate)
    ham_pops, ham_bytes = ham_c.ops, int(ham_c.nbytes)
    ham_b_ops, ham_b_bytes = ham_c.ops_ms, ham_c.bytes_ms
    ub = U[:hn_loc]
    vb = U[hn_loc:2 * hn_loc]
    ham_lib_ms = library_rows(lambda a, b: torch.cdist(a, b, p=0), ub, vb)
    print(f"[7d] nng_tile_hamming ({hn_loc}x{hn_loc}x{HW}): {ham_ms:.3f} ms "
          f"median; bound {max(ham_b_ops, ham_b_bytes):.3f} ms (operations: "
          f"{ham_pops:.4g} popcounts at {popc_rate:.4g}/s = {ham_b_ops:.3f} "
          f"ms; bytes {ham_bytes} at {PEAK_BYTES / 1e12:g} TB/s = "
          f"{ham_b_bytes:.3f} ms); {ham_pops / ham_ms / 1e9:.4g} Tpopc/s; "
          f"plain version {ham_plain_ms:.3f} ms (one run, rows of 4096); "
          f"torch.cdist(p=0) on the unpacked fp32 bits, distances only, one "
          f"run in rows of 8192, {ham_lib_ms:.3f} ms; launches on the tiles call "
          f"{h_tiles_l['nng_tile_hamming']}")
    del U, un, ub, vb
    torch.cuda.empty_cache()

    hf_ms, hf_plain_ms, hf_bound, hf_by, hf_lib_ms = frontier_times(
        "[7d] tree_frontier_hamming", tree_frontier_hamming_cuda,
        tree_frontier_hamming_ref, h_launch, h_first, HAM_EPS, HW, HW,
        popc_rate, lambda a, b: torch.cdist(a, b, p=0), h_live,
        prep=lambda t: unpack_words(t).float())
    h_max_deg = int(gh.degrees().max())
    del H, hx, hy, hones, h_first, h_launch, ght      # gh: [10c]
    torch.cuda.empty_cache()
    print(f"[7d] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 8. L1 at a depth cut -------------------------------------------------
    N8 = L1_N
    pts8, n8 = pts[:N8], N8 // NRANKS
    print(f"[8] depth cut: the first {N8} of the {N} [3] points, to keep the "
          f"whole script near {TIME_BUDGET_S} s: [8]'s plain versions, "
          f"library yardsticks and two profiled calls grow with the square "
          f"of the points and took about 280 s at {N}")

    # -- 8a. L1: eps, and the kernels against their plain versions -----------
    P = torch.from_numpy(pts8).to(dev)
    P64 = P.double()
    lrows = np.sort(np.random.default_rng(SAMPLE_SEED).choice(
        N8, SAMPLE, replace=False))
    near = []
    for r0 in range(0, SAMPLE, 64):
        r = torch.from_numpy(lrows[r0:r0 + 64]).to(dev)
        d64 = torch.cdist(P64[r], P64, p=1)
        near.append(d64[(d64 - L1_TARGET).abs() <= 0.5])
        del d64
    vals = torch.sort(torch.cat(near)).values
    j = int(torch.argmax(vals[1:] - vals[:-1]))
    EPS8 = float(0.5 * (vals[j] + vals[j + 1]))
    gap = float(0.5 * (vals[j + 1] - vals[j]))
    print(f"[8a] L1 on the first {N8} of the [3] points: eps {EPS8:.9g}, "
          f"the middle of the widest gap within 0.5 of {L1_TARGET} among the "
          f"{SAMPLE} sampled rows' float64 distances; the nearest sampled "
          f"pair lies {gap / (U32 * EPS8):.4g} u·eps from it (L1 knife "
          f"{DIM} u·eps)")
    lx = P[:n8].contiguous()
    ly = P[n8:2 * n8].contiguous()
    lones = torch.ones(n8, dtype=torch.int32, device=dev)
    _, lbits, l1_plain_ms, l1_err = tile_vs_plain(
        f"[8a] nng_tile_l1 ({n8},{n8},{DIM}) at the path's inputs",
        nng_tile_l1_cuda, nng_tile_l1_ref, lx, ly, lones, EPS8, rows=8192)
    del lbits
    for q, p, d in ((1000, 777, 100), (37, 64, 3)):
        x, y = (torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
                .to(dev) for m in (q, p))
        yv = torch.from_numpy((rng.random(p) > 0.1).astype(np.int32)).to(dev)
        eps = float(torch.quantile(torch.cdist(x, y, p=1).flatten(), 0.01))
        _, _, _, e_ = tile_vs_plain(
            f"[8a] nng_tile_l1 ragged ({q},{p},{d}) eps={eps:.6g}",
            nng_tile_l1_cuda, nng_tile_l1_ref, x, y, yv, eps)
        l1_err = max(l1_err, e_)
    l_launch, l_first, lL, l_live = traversal_inputs("[8a]", P, n8, EPS8,
                                                     "manhattan")
    leaf_lv = max(range(lL), key=lambda l: int(l_first[l][3].sum()))
    for lv in sorted({lL // 2, leaf_lv}):
        q, c, rad, leaf, act = l_first[lv][:5]
        l1_err = max(l1_err, frontier_vs_plain_m(
            f"[8a] tree_frontier_l1 level {lv} ({q.shape[0]}x{c.shape[0]}, "
            f"{int(tdev._popcount(act))} active pairs)", tree_frontier_l1_cuda,
            tree_frontier_l1_ref, q, c, rad, leaf, act, EPS8))
    q, c, rad, leaf, act = l_first[leaf_lv][:5]
    leaf_vs_tile(f"[8a] tree_frontier_l1 level {leaf_lv} vs nng_tile_l1",
                 tree_frontier_l1_cuda, nng_tile_l1_cuda, q, c, rad, leaf,
                 act, EPS8)
    l1_err = max(l1_err, frontier_vs_plain_m(
        f"[8a] tree_frontier_l1 level {leaf_lv}, one live 64x256 tile",
        tree_frontier_l1_cuda, tree_frontier_l1_ref, q, c, rad, leaf,
        one_live_tile(act), EPS8))
    gq = torch.from_numpy(rng.normal(size=(1000, 100)).astype(np.float32))
    gc = torch.from_numpy(rng.normal(size=(777, 100)).astype(np.float32))
    grad = torch.from_numpy(np.abs(rng.normal(size=777)).astype(np.float32)
                            * 20)
    gleaf = torch.from_numpy((rng.random(777) < 0.4).astype(np.int32))
    for gd in (100, 99):           # TMA copies; d % 4 != 0: cp.async
        geps = float(torch.quantile(torch.cdist(gq[:, :gd], gc[:, :gd],
                                                p=1).flatten(), 0.01))
        l1_err = max(l1_err, frontier_vs_plain_m(
            f"[8a] tree_frontier_l1 ragged (1000x777x{gd}) eps={geps:.6g}",
            tree_frontier_l1_cuda, tree_frontier_l1_ref,
            gq[:, :gd].contiguous().to(dev), gc[:, :gd].contiguous().to(dev),
            grad.to(dev), gleaf.to(dev), gact, geps))
    ze, zx = tree_frontier_l1_cuda(gq.to(dev), gc.to(dev), grad.to(dev),
                                   gleaf.to(dev), torch.zeros_like(gact), geps)
    check(not ze.any() and not zx.any(),
          "tree_frontier_l1: an all-inactive mask emitted or expanded")
    print("[8a] tree_frontier_l1 with an all-inactive mask (a zero "
          "live-tile count): zero words")
    print(f"[8a] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 8b. the calls --------------------------------------------------------
    torch.cuda.empty_cache()
    gl, l_tiles_l = graph_call("[8b] tiles", pts8, EPS8, "manhattan", "tiles")
    glt, l_tree_l = graph_call("[8b] tree", pts8, EPS8, "manhattan", "tree")
    print(f"[8b] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 8c. exactness: tree vs tiles off the knife, sampled rows in band -----
    i, j, (n_tree, n_tiles) = edge_diff(glt, gl, N8)
    off = (l1_d64(P[i], P[j]) - EPS8).abs() / (U32 * EPS8)
    far = float(off.max()) if len(off) else 0.0
    print(f"[8c] tree graph vs tiles graph: {glt.num_edges} vs "
          f"{gl.num_edges} edges, {n_tree} only in the tree graph, "
          f"{n_tiles} only in the tiles graph, the farthest at |d64-eps| = "
          f"{far:.4g} u·eps (knife {DIM} u·eps)")
    check(far <= DIM, "[8c] the tree and tiles graphs differ off the knife")
    pn = P.abs().sum(1).double()
    mism = band_pairs = 0
    wit = []
    for r0 in range(0, SAMPLE, 64):
        r = torch.from_numpy(lrows[r0:r0 + 64]).to(dev)
        d64 = torch.cdist(P64[r], P64, p=1)
        truth = d64 <= EPS8
        truth[torch.arange(len(r), device=dev), r] = False
        got = torch.zeros_like(truth)
        for k, row in enumerate(lrows[r0:r0 + 64].tolist()):
            got[k, torch.from_numpy(gl.neighbors(row).astype(np.int64))
                .to(dev)] = True
        band = ((d64 - EPS8).abs()
                <= (pn[r][:, None] + pn[None, :] + EPS8) * 1e-6 + 1e-9)
        check(int(((truth ^ got) & ~band).sum()) == 0,
              "[8c] sampled pairs differ from float64 outside the band")
        mism += int((truth ^ got).sum())
        band_pairs += int(band.sum())
        plain = l1_dist(P[r], P) <= float(np.float32(EPS8))
        plain[torch.arange(len(r), device=dev), r] = False
        wit.append(((plain ^ got) & ~((d64 - EPS8).abs()
                                      <= DIM * U32 * EPS8)).sum())
        del d64, truth, got, band, plain
    check(int(sum(wit)) == 0, "[8c] sampled rows differ from the plain fp32 "
                              "distances off the knife")
    print(f"[8c] {SAMPLE} sampled rows vs float64 over all {N8} points: "
          f"{mism} pairs differ, all inside HostManhattan.band_slack "
          f"((|x|_1+|y|_1+eps)·1e-6, {band_pairs} pairs in it); against the "
          f"plain fp32 distances on the card, none differ off the knife")
    del P64, pn, glt

    # -- 8d. times at the path's shapes ---------------------------------------
    l1_ms = cuda_ms(torch, lambda: nng_tile_l1_cuda(lx, ly, lones, EPS8), 3)
    l1_c = kcost.tile_cost("manhattan", n8, n8, DIM)
    l1_ops, l1_bytes = l1_c.ops, int(l1_c.nbytes)
    l1_b_ops, l1_b_bytes = l1_c.ops_ms, l1_c.bytes_ms
    torch.cuda.empty_cache()
    l1_lib_ms = library_rows(lambda a, b: torch.cdist(a, b, p=1), lx, ly)
    torch.cuda.empty_cache()
    print(f"[8d] nng_tile_l1 ({n8}x{n8}x{DIM}): {l1_ms:.3f} ms median; "
          f"bound {max(l1_b_ops, l1_b_bytes):.3f} ms (operations: {l1_ops:.4g}"
          f" fp32 instructions at {l1_rate:.4g}/s = {l1_b_ops:.3f} ms; bytes "
          f"{l1_bytes} at {PEAK_BYTES / 1e12:g} TB/s = {l1_b_bytes:.3f} ms); "
          f"{l1_ops / l1_ms / 1e9:.4g} T instructions/s; plain version "
          f"{l1_plain_ms:.3f} ms (one run, rows of 8192); torch.cdist(p=1), "
          f"distances only, one run in rows of 8192, {l1_lib_ms:.3f} ms; "
          f"launches on the tiles call {l_tiles_l['nng_tile_l1']}")
    lf_ms, lf_plain_ms, lf_bound, lf_by, lf_lib_ms = frontier_times(
        "[8d] tree_frontier_l1", tree_frontier_l1_cuda, tree_frontier_l1_ref,
        l_launch, l_first, EPS8, DIM, 2 * DIM, l1_rate,
        lambda q, c: torch.cdist(q, c, p=1), l_live)
    del P, lx, ly, lones, l_first, l_launch
    torch.cuda.empty_cache()
    print(f"[8d] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 9. the spatial engine (Algorithms 5+6) -----------------------------
    GROUPED = {"euclidean": (nng_tile_grouped_cuda, nng_tile_grouped_ref),
               "hamming": (nng_tile_grouped_hamming_cuda,
                           nng_tile_grouped_hamming_ref),
               "manhattan": (nng_tile_grouped_l1_cuda,
                             nng_tile_grouped_l1_ref)}
    GHOST = {"euclidean": (nng_tile_ghost_cuda, nng_tile_ghost_ref),
             "hamming": (nng_tile_ghost_hamming_cuda,
                         nng_tile_ghost_hamming_ref),
             "manhattan": (nng_tile_ghost_l1_cuda, nng_tile_ghost_l1_ref)}
    TREE_TAG = {"euclidean": "", "hamming": "_hamming", "manhattan": "_l1"}

    def spatial_setup(label, X, eps, metric, k_cap):
        """The spatial engine on X: the host Voronoi argmin and LPT, the
        device planner, and one exchange (Phases 1, 2 and 4's all-to-alls)
        whose cell-sorted per-rank buffers the kernels are checked on.
        Prints the cells, the plan, the ghost copies and the W and G rows a
        rank. Returns (engine, plan, per-rank (W, Wids, Wgrp, G, Gids,
        Ggrp))."""
        t0 = time.perf_counter()
        eng = SpatialPartitionEngine(X, eps, mesh, metric, k_cap=k_cap)
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = eng.initial_plan()
        plan_s = time.perf_counter() - t0
        n_ = eng.points.shape[0]
        sizes = np.bincount(eng.cell, minlength=plan.m_centers)
        loads = np.bincount(eng.f, weights=sizes, minlength=NRANKS)
        xs = list(eng.points.chunk(NRANKS))
        ids = list(torch.arange(n_, dtype=torch.int32,
                                device=dev).chunk(NRANKS))
        t0 = time.perf_counter()
        bufs, dropped = tdev._landmark_exchange(
            xs, ids, eng.centers, torch.as_tensor(eng.f, dtype=torch.int64,
                                                  device=dev),
            mesh=eng.mesh, two_eps_c=2.0 * eps, metric=get_metric(metric),
            plan=plan)
        torch.cuda.synchronize()
        ex_s = time.perf_counter() - t0
        check(not any(bool(d) for d in dropped),
              f"{label} the exact plan dropped rows")
        w_rows = [int((b[2] >= 0).sum()) for b in bufs]
        g_rows = [int((b[5] >= 0).sum()) for b in bufs]
        tables = (NRANKS * (plan.cap_coal + plan.cap_ghost) * k_cap * 4)
        print(f"{label} {metric}, n {n_}, eps {eps:.9g}, {NRANKS} ranks, "
              f"m {plan.m_centers}: host Voronoi argmin + LPT {host_s:.3f} s, "
              f"device planner {plan_s:.3f} s, one exchange {ex_s:.3f} s")
        print(f"{label} cell sizes {int(sizes.min())}..{int(sizes.max())} "
              f"{sorted(sizes.tolist())}; rank loads (LPT) "
              f"{int(loads.min())}..{int(loads.max())}")
        print(f"{label} plan: cap_coal {plan.cap_coal}, cap_ghost "
              f"{plan.cap_ghost}, g_per_pt {plan.g_per_pt}, k_cap "
              f"{plan.k_cap}, cap_rank {plan.cap_rank}")
        print(f"{label} ghost copies {sum(g_rows)} ({sum(g_rows) / n_:.3f} "
              f"a point); valid W rows a rank {w_rows}, G rows {g_rows}; "
              f"capacity-padded W {NRANKS * plan.cap_coal} and G "
              f"{NRANKS * plan.cap_ghost} rows a rank; W and G id tables at "
              f"k_cap {k_cap}: {tables} B a rank, {NRANKS * tables} B for "
              f"all ranks")
        return eng, plan, bufs

    def grouped_vs_plain(label, metric, x, y, xg, yg, xid, yid, eps,
                         rows=4096, limit=None):
        """A grouped kernel against its plain version (row chunks, the
        first ``limit`` rows where given), on the same inputs. Hamming:
        bit-identical. L2: differing pairs only on the knife. L1: only on
        the L1 knife. Returns (cnt, bits, plain ms of the rows compared,
        max |cnt diff|)."""
        kern, plain = GROUPED[metric]
        cnt, bits = kern(x, y, xg, yg, xid, yid, eps)
        yp, ygp, yidp = (_pad_rows(t, 32, v)[0]
                         for t, v in ((y, 0), (yg, -1), (yid, -1)))
        return vs_plain(label, metric, x, y, cnt, bits, lambda sl: plain(
            x[sl], yp, xg[sl], ygp, xid[sl], yidp, eps), eps, rows, limit)

    def ghost_vs_plain(label, metric, x, y, gb, yg, eps, rows=4096,
                       limit=None):
        """A ghost kernel against its plain version, as
        ``grouped_vs_plain``, but the L1 one bit for bit (it sums in the
        plain version's order)."""
        kern, plain = GHOST[metric]
        cnt, bits = kern(x, y, gb, yg, eps)
        yp, ygp = _pad_rows(y, 32)[0], _pad_rows(yg, 32, -1)[0]
        return vs_plain(label, metric, x, y, cnt, bits, lambda sl: plain(
            x[sl], yp, gb[sl], ygp, eps), eps, rows, limit,
                        exact=metric == "manhattan")

    def vs_plain(label, metric, x, y, cnt, bits, plain_rows, eps, rows,
                 limit, exact=False):
        """A fused kernel's (cnt, bits) against ``plain_rows(rows)``, the
        plain version on a slice of x's rows; with ``exact`` an L1 kernel
        must equal it bit for bit."""
        nw = bits.shape[1]
        q_ = x.shape[0] if limit is None else min(limit, x.shape[0])
        di, dj, err, plain_ms = [], [], 0, 0.0
        for r0 in range(0, q_, rows):
            sl = slice(r0, min(r0 + rows, q_))
            (c0, b0), ms = events_ms(torch, lambda: plain_rows(sl))
            plain_ms += ms
            err = max(err, int((cnt[sl] - c0).abs().max()))
            u = unpack_words(bits[sl])
            check(torch.equal(cnt[sl], u.sum(1, dtype=torch.int32)),
                  f"{label}: cnt is not the popcount of bits")
            check(not u[:, y.shape[0]:].any(), f"{label}: bits past column p")
            i, j = differing_pairs(bits[sl], b0[:, :nw])
            di.append(i + r0)
            dj.append(j)
            del c0, b0, u
        i, j = torch.cat(di), torch.cat(dj)
        what = (f"{label}: {int(cnt[:q_].sum())} hits in {q_} rows, plain "
                f"version {plain_ms:.3f} ms")
        if metric == "hamming":
            check(len(i) == 0 and err == 0,
                  f"{label}: {len(i)} pairs differ from the plain version")
            print(f"{what}; bit-identical")
        elif metric == "manhattan" and exact:
            check(len(i) == 0 and err == 0,
                  f"{label}: {len(i)} pairs differ from the plain version")
            print(f"{what}; bit-identical")
        elif metric == "manhattan":
            off = (l1_d64(x[i], y[j]) - eps).abs() / (U32 * eps)
            far = float(off.max()) if len(off) else 0.0
            print(f"{what}; {len(i)} pairs differ, the farthest at "
                  f"|d64-eps| = {far:.4g} u·eps (knife {x.shape[1]} u·eps)")
            check(far <= x.shape[1], f"{label}: pairs differ off the knife")
        else:
            print(f"{what}; max |cnt diff| {err}")
            knife_check(f"{label} vs plain", x, y, i, j, eps2_f32(eps))
        return cnt, bits, plain_ms, err

    def live_pairs(xg, yg, q_, p_):
        """Pairs in the live 128 x 128 blocks of the grouped kernel (its
        own block geometry and skip rule), and those blocks' count."""
        return live_pairs_of(grouped_block_active(
            _pad_rows(xg, 128, -1)[0], _pad_rows(yg, 128, -1)[0], 128, 128),
            q_, p_)

    def live_pairs_of(live, q_, p_, tq=128, tp=128):
        """Pairs in the live blocks of a (q_, p_) tile's (tq x tp) block
        map, and those blocks' count."""
        rq = torch.full((live.shape[0],), tq, device=dev)
        rp = torch.full((live.shape[1],), tp, device=dev)
        rq[-1] = q_ - tq * (live.shape[0] - 1)
        rp[-1] = p_ - tp * (live.shape[1] - 1)
        return (int((live * rq[:, None] * rp[None, :]).sum()),
                int(live.sum()))

    def same_cell_pairs(xg, yg):
        """The pairs the grouped function needs: same valid cell."""
        cx = torch.bincount(xg[xg >= 0], minlength=SP_CENTERS)
        cy = torch.bincount(yg[yg >= 0], minlength=SP_CENTERS)
        return int((cx.long() * cy.long()).sum())

    def grouped_times(label, metric, x, y, xg, yg, xid, yid, eps, feat,
                      pair_ops, rate, library, plain_ms, prep=lambda t: t):
        """The grouped kernel at one of the path's launches: CUDA-event
        median, bound from the pairs the function needs (same valid cell;
        ``pair_ops`` operations each at ``rate``) and from its bytes (x, y,
        four int32 vectors in; cnt and the words out), the plain version's
        time (measured by the caller), and the library call on the same
        operands in rows of 8192. The live blocks are the kernel's own:
        the L2 one's ``grouped_tile_plan`` 64 x 256 tiles (the 128 x 128
        blocks' counts printed beside), the others' 128 x 128 blocks.
        Returns (ms, bound ms, bound_by, library ms)."""
        kern = GROUPED[metric][0]
        q_, p_ = x.shape[0], y.shape[0]
        ms = cuda_ms(torch, lambda: kern(x, y, xg, yg, xid, yid, eps), 5)
        need = same_cell_pairs(xg, yg)
        pairs, blocks = live_pairs(xg, yg, q_, p_)
        tile = (128, 128)
        if metric == "euclidean":
            tile = PIPE_TILE
            print(f"{label}: the live 128x128 blocks ({blocks}) hold "
                  f"{pairs} pairs, {pairs / max(need, 1):.4f}x the needed")
            pairs, blocks = live_pairs_of(grouped_block_active(
                _pad_rows(xg, tile[0], -1)[0], _pad_rows(yg, tile[1], -1)[0],
                *tile), q_, p_, *tile)
            check(int(grouped_tile_plan(xg, yg)[1][0]) == blocks,
                  f"{label}: grouped_tile_plan's count is not the live "
                  f"tiles'")
        nbytes = int(kcost.grouped_cost(metric, q_, p_, feat).nbytes)
        return fused_times(label, ms, x, y, feat, need, "same-cell", pairs,
                           blocks, nbytes, pair_ops, rate, library, plain_ms,
                           prep, tile=tile)

    def grouped_parts(label, x, y, xg, yg, xid, yid, eps, call):
        """The grouped L2 call's parts, each a CUDA-event median:
        ``grouped_tile_plan``, the zeroed outputs and the launch alone,
        beside the whole call's time and bound (``call``: grouped_times'
        return)."""
        q_, p_ = x.shape[0], y.shape[0]
        plan_ms = cuda_ms(torch, lambda: grouped_tile_plan(xg, yg), 10)
        zero_ms = cuda_ms(torch, lambda: (
            torch.zeros(q_, dtype=torch.int32, device=dev),
            torch.zeros((q_, -(-p_ // 32)), dtype=torch.int32, device=dev)),
            10)
        tiles_, count_ = grouped_tile_plan(xg, yg)
        cnt_ = torch.zeros(q_, dtype=torch.int32, device=dev)
        bits_ = torch.zeros((q_, -(-p_ // 32)), dtype=torch.int32,
                            device=dev)
        launch_ms = cuda_ms(torch, lambda: grouped_launch(
            x, y, xg, yg, xid, yid, tiles_, count_, eps, cnt_, bits_), 5)
        print(f"{label}: grouped_tile_plan {plan_ms:.3f} ms, zeroed outputs "
              f"{zero_ms:.3f} ms ({4 * q_ * -(-p_ // 32)} bytes of words), "
              f"the launch alone {launch_ms:.3f} ms (bound/time "
              f"{call[1] / launch_ms:.1%}); the whole call {call[0]:.3f} ms "
              f"against its bound {call[1]:.3f} ms (bound/time "
              f"{call[1] / call[0]:.1%})")
        del cnt_, bits_
        return plan_ms, zero_ms, launch_ms

    def fused_times(label, ms, x, y, feat, need, what, pairs, blocks,
                    nbytes, pair_ops, rate, library, plain_ms, prep,
                    tile=(128, 128)):
        """Print a grouped or ghost kernel's time ``ms`` beside its bound
        (``pair_ops`` operations for each of the ``need`` pairs the function
        needs at ``rate``, or ``nbytes`` at PEAK_BYTES), the same over the
        ``pairs`` of the kernel's live blocks (of ``tile`` rows x columns),
        its plain version's time and the library call's on x and y in rows
        of 8192. Returns (ms, bound ms, bound_by, library ms)."""
        q_, p_ = x.shape[0], y.shape[0]
        ops = pair_ops * need
        b_ops, b_bytes = ops / rate * 1e3, nbytes / PEAK_BYTES * 1e3
        b_live = pair_ops * pairs / rate * 1e3
        by = "operations" if b_ops >= b_bytes else "bytes"
        lib_ms = library_rows(library, prep(x), prep(y))
        total = -(-q_ // tile[0]) * -(-p_ // tile[1])
        print(f"{label} ({q_}x{p_}x{feat}): {ms:.3f} ms median; bound "
              f"{max(b_ops, b_bytes):.3f} ms ({by}: {ops:.4g} operations of "
              f"the {need} {what} pairs the function needs at {rate:.4g}/s "
              f"= {b_ops:.3f} ms, {nbytes} bytes at {PEAK_BYTES / 1e12:g} "
              f"TB/s = {b_bytes:.3f} ms); {ops / ms / 1e9:.4g} T needed "
              f"operations/s; {blocks} of {total} kernel blocks "
              f"({tile[0]}x{tile[1]}) live, "
              f"{pairs} pairs in them ({pairs / max(need, 1):.3f}x the "
              f"needed pairs; {b_live:.3f} ms at {rate:.4g}/s); plain "
              f"version {plain_ms:.3f} ms (one run, row chunks); library "
              f"{lib_ms:.3f} ms (one run in rows of 8192)")
        return ms, max(b_ops, b_bytes), by, lib_ms

    def spatial_call(label, pts_, eps, metric, k_cap, ghost_mode="coll",
                     traversal="tiles", profiled=False):
        """``build_nng(partition="spatial")`` on the 8 logical ranks, every
        kernel's launches counted from this call alone (with ``profiled``,
        the call under torch.profiler: its device busy time by kernel)."""
        for fn in KERNELS:
            fn.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def call():
            return build_nng(pts_, eps, metric=metric, partition="spatial",
                             mesh=mesh, k_cap=k_cap, ghost_mode=ghost_mode,
                             traversal=traversal)
        t0 = time.perf_counter()
        g_ = (profiled_run(label, call, what="build_nng call")[0]
              if profiled else call())
        wall_ = time.perf_counter() - t0
        st_ = g_.stats
        launches_ = {fn.__name__[:-5]: fn.launches for fn in KERNELS
                     if fn.launches}
        print(f"{label} build_nng(metric={metric!r}, partition='spatial', "
              f"ghost_mode={ghost_mode!r}, traversal={traversal!r}, "
              f"n={len(pts_)}, eps={eps:.9g}, nranks={NRANKS}, "
              f"k_cap={k_cap}): {g_.num_edges} edges, mean degree "
              f"{g_.avg_degree:.2f}, max degree {int(g_.degrees().max())}; "
              f"call wall {wall_:.3f} s, elapsed_s {st_.elapsed_s:.3f} "
              f"(steady-state run), build_s {st_.build_s:.3f}, replans "
              f"{st_.replans}, ghost_mode {g_.meta['ghost_mode']}, planner "
              f"{g_.meta['planner']}")
        print(f"{label} plan {g_.meta['plan']}")
        print(f"{label} tiles_scheduled {st_.tiles_scheduled:.0f} "
              f"tiles_skipped {st_.tiles_skipped:.0f} dists_evaluated "
              f"{st_.dists_evaluated:.6g} nodes_pruned "
              f"{st_.nodes_pruned:.6g}; comm_bytes "
              f"{json.dumps(st_.comm_bytes)}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} B")
        print(f"{label} launches {json.dumps(launches_)}")
        if traversal == "tiles":
            need = [GROUPED[metric][0].__name__[:-5], "bits_to_cols"]
            if ghost_mode == "ring":
                need.append(GHOST[metric][0].__name__[:-5])
        else:
            need = [f"tree_frontier{TREE_TAG[metric]}", "leaf_range_pack",
                    "bits_to_cols"]
        check(g_.meta["ghost_mode"] == ghost_mode,
              f"{label}: ran {g_.meta['ghost_mode']}, not {ghost_mode}")
        check(all(launches_.get(k, 0) > 0 for k in need),
              f"{label}: a kernel of the spatial path never launched: "
              f"{launches_}")
        check(st_.replans == 0, f"{label}: {st_.replans} grows")
        check(g_.num_edges > 0, f"{label}: no edges")
        return g_, launches_

    # -- 9a. the plan, and the grouped kernels against their plain versions
    torch.cuda.empty_cache()
    eng9, plan9, bufs9 = spatial_setup("[9a]", pts, EPS, "euclidean",
                                       SP_K_CAP)
    W0, Wids0, Wgrp0, G0, Gids0, Ggrp0 = bufs9[0]
    del bufs9

    def shifted(t, shift):
        """t's copy on the card, contiguous, at an aligned base (None), in
        rows 1.. of a (rows + 1, d) matrix ("row") or one element past the
        base ("elem"): neither 16-byte aligned, so the L2 kernels on the
        pipelined core take their 4-byte copies."""
        if shift is None:
            return t
        r_, d_ = t.shape
        out = (torch.empty((r_ + 1, d_), dtype=t.dtype, device=dev)[1:]
               if shift == "row" else torch.empty(
                   r_ * d_ + 1, dtype=t.dtype, device=dev)[1:].view(r_, d_))
        check(out.data_ptr() % 16 != 0, f"the {shift} copy is aligned")
        return out.copy_(t)

    grp_err = {"euclidean": 0, "hamming": 0, "manhattan": 0}
    for metric in ("euclidean", "hamming", "manhattan"):
        for q, p, d, pattern, shift in ((37, 64, 3, "random", None),
                                        (1000, 777, 25, "random", None),
                                        (600, 1200, 9, "sorted", None),
                                        (300, 515, 40, "disjoint", None),
                                        (300, 600, 16, "one", None),
                                        (300, 600, 16, "none", None),
                                        (600, 1200, 17, "sorted", "row"),
                                        (512, 1024, 128, "random", "elem")):
            if metric == "hamming":
                x, y = (torch.from_numpy(rng.integers(
                    -2**31, 2**31, size=(m_, d)).astype(np.int32)).to(dev)
                    for m_ in (q, p))
                x[::7] = -1
                y[::5] = x[0]
                eps = float(torch.quantile(hamming_dist(x, y).flatten()
                                           .float(), 0.05)) + 0.5
            else:
                x, y = (torch.from_numpy(rng.normal(size=(m_, d)).astype(
                    np.float32)).to(dev) for m_ in (q, p))
                dd = torch.cdist(x, y, p=1 if metric == "manhattan" else 2)
                eps = float(torch.quantile(dd.flatten(), 0.05))
            if pattern == "random":
                xg = rng.integers(-1, 6, size=q)
                yg = rng.integers(-1, 6, size=p)
            elif pattern == "sorted":
                xg = np.sort(rng.integers(0, 50, size=q))
                yg = np.sort(rng.integers(0, 50, size=p))
                xg[q - q // 15:] = -1
                yg[p - p // 17:] = -1
            elif pattern == "one":
                # one group on x rows [0, 40) and y rows [0, 200), padding
                # elsewhere: one live 64 x 256 tile
                xg, yg = np.full(q, -1), np.full(p, -1)
                xg[:40], yg[:200] = 0, 0
            elif pattern == "none":
                # every x row padding: no live tile
                xg, yg = np.full(q, -1), rng.integers(0, 6, size=p)
            else:
                xg = rng.integers(0, 4, size=q)
                yg = rng.integers(10, 14, size=p)
            xid = np.arange(q)
            yid = np.arange(37, 37 + p)
            xid[:4] = yid[:4]
            xg, yg, xid, yid = (torch.from_numpy(a.astype(np.int32)).to(dev)
                                for a in (xg, yg, xid, yid))
            label = (f"[9a] {GROUPED[metric][0].__name__[:-5]} {pattern} "
                     f"({q},{p},{d})" + (f" {shift}" if shift else ""))
            cnt, bits, _, e_ = grouped_vs_plain(
                label, metric, shifted(x, shift), shifted(y, shift), xg, yg,
                xid, yid, eps)
            grp_err[metric] = max(grp_err[metric], e_)
            if pattern in ("disjoint", "none"):
                check(not bits.any() and not cnt.any(),
                      f"[9a] {metric}: {pattern} groups set a word")
            else:
                check(bool(cnt.any()), f"{label}: no hit")
            if metric == "euclidean":
                live_t = int(grouped_tile_plan(xg, yg)[1][0])
                n_t = -(-q // PIPE_TILE[0]) * -(-p // PIPE_TILE[1])
                print(f"    {label}: {live_t} of {n_t} "
                      f"{PIPE_TILE[0]}x{PIPE_TILE[1]} tiles live")
                want = {"one": 1, "none": 0, "disjoint": 0}.get(pattern)
                check(want is None and live_t > 0 or live_t == want,
                      f"{label}: {live_t} live tiles")
    print("[9a] every all-disjoint and all-padding case stored zero words")
    _, _, w_plain_ms, e_ = grouped_vs_plain(
        "[9a] nng_tile_grouped rank 0 W x W", "euclidean", W0, W0, Wgrp0,
        Wgrp0, Wids0, Wids0, EPS)
    grp_err["euclidean"] = max(grp_err["euclidean"], e_)
    _, _, g_plain_ms, e_ = grouped_vs_plain(
        "[9a] nng_tile_grouped rank 0 G x W", "euclidean", G0, W0, Ggrp0,
        Wgrp0, Gids0, Wids0, EPS)
    grp_err["euclidean"] = max(grp_err["euclidean"], e_)
    torch.cuda.empty_cache()
    print(f"[9a] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 9b. the call, and where its time goes -------------------------------
    gs, sp_launches = spatial_call("[9b]", pts, EPS, "euclidean", SP_K_CAP)
    coll9 = gs                      # [13a] holds its call to this graph
    parent_check("[9b] spatial", gs)
    plan_s = gs.meta["plan"]
    out, _ = profiled_run("[9b]", lambda: eng9.run(plan_s))
    del out
    print(f"[9b] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 9c. exactness: the spatial graph against [3]'s, sampled rows --------
    P = torch.from_numpy(pts).to(dev)
    i, j, (n_sp, n_pt) = edge_diff(gs, g, N)
    print(f"[9c] spatial graph vs [3]'s point-partition graph: "
          f"{gs.num_edges} vs {g.num_edges} edges, {n_sp} only in the "
          f"spatial graph, {n_pt} only in the point graph")
    knife_check("[9c] spatial vs point", P, P, i, j, eps2)
    sample_check("[9c]", gs, P)
    coll_stats = gs.stats           # [10b] sets the ring beside it
    del P, gs
    print(f"[9c] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 9d. the grouped L2 kernel's times at rank 0's launches ---------------
    grp_w = grouped_times(
        "[9d] nng_tile_grouped rank 0 W x W", "euclidean", W0, W0, Wgrp0,
        Wgrp0, Wids0, Wids0, EPS, DIM, 2 * DIM, PEAK_FP32,
        lambda a, b: torch.mm(a, b.T), w_plain_ms)
    grouped_parts("[9d] nng_tile_grouped rank 0 W x W", W0, W0, Wgrp0, Wgrp0,
                  Wids0, Wids0, EPS, grp_w)
    grp_g = grouped_times(
        "[9d] nng_tile_grouped rank 0 G x W", "euclidean", G0, W0, Ggrp0,
        Wgrp0, Gids0, Wids0, EPS, DIM, 2 * DIM, PEAK_FP32,
        lambda a, b: torch.mm(a, b.T), g_plain_ms)
    grouped_parts("[9d] nng_tile_grouped rank 0 G x W", G0, W0, Ggrp0, Wgrp0,
                  Gids0, Wids0, EPS, grp_g)
    print(f"[9d] launches on the [9b] call: nng_tile_grouped "
          f"{sp_launches['nng_tile_grouped']}, bits_to_cols "
          f"{sp_launches['bits_to_cols']}")
    del W0, Wids0, Wgrp0, G0, Gids0, Ggrp0, eng9
    torch.cuda.empty_cache()
    print(f"[9d] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 9e. Hamming and L1 through the spatial engine -----------------------
    # Hamming: the ghost fanout of the full [7] stand-in, which sets the cut
    eng_h = SpatialPartitionEngine(hpts, HAM_EPS, mesh, "hamming")
    plan_h = eng_h.initial_plan()
    xs_h = eng_h.points.chunk(NRANKS)
    ft_h = torch.as_tensor(eng_h.f, dtype=torch.int64, device=dev)
    ghosts = sum(int(tdev._plan_count_local(
        xr, eng_h.centers, ft_h, nranks=NRANKS, two_eps_c=2.0 * HAM_EPS,
        metric=get_metric("hamming"))[1].sum()) for xr in xs_h)
    k_full = 1 << (h_max_deg - 1).bit_length()
    t_full = NRANKS * (plan_h.cap_coal + plan_h.cap_ghost) * k_full * 4
    h_n = HN if NRANKS * t_full <= TABLE_BUDGET else HAM_SP_N
    print(f"[9e] hamming at the full {HN} x {HW} words, eps {HAM_EPS}: "
          f"{ghosts} ghost copies ({ghosts / HN:.2f} a point, g_per_pt "
          f"{plan_h.g_per_pt} of {plan_h.m_centers - 1} other cells), "
          f"cap_ghost {plan_h.cap_ghost}, cap_coal {plan_h.cap_coal}: "
          f"{NRANKS * plan_h.cap_ghost} G rows a rank; at k_cap {k_full} "
          f"(above [7]'s max degree {h_max_deg}) the W and G id tables "
          f"take {t_full} B a rank, {NRANKS * t_full} B for all {NRANKS} "
          f"ranks on one card against a budget of {TABLE_BUDGET} B")
    print(f"[9e] hamming depth cut: the first {h_n} of {HN} points"
          if h_n < HN else "[9e] hamming: no depth cut")
    del eng_h, xs_h, ft_h
    hp = hpts[:h_n]
    gph, _ = graph_call(f"[9e] hamming point partition at n {h_n}", hp,
                        HAM_EPS, "hamming", "tiles")
    k_h = max(METRIC_K_CAP, 1 << int(gph.degrees().max()).bit_length())
    eng_hc, plan_hc, bufs_h = spatial_setup("[9e] hamming", hp, HAM_EPS,
                                            "hamming", k_h)
    check(NRANKS * NRANKS * (plan_hc.cap_coal + plan_hc.cap_ghost) * k_h * 4
          <= TABLE_BUDGET, "[9e] the hamming cut's tables exceed the budget")
    gsh, sh_launches = spatial_call("[9e] hamming", hp, HAM_EPS, "hamming",
                                    k_h)
    check(np.array_equal(gsh.edge_key(), gph.edge_key()),
          "[9e] the hamming spatial graph differs from the point graph")
    print(f"[9e] hamming: the spatial graph equals the point-partition "
          f"graph bit for bit ({gsh.num_edges} edges)")
    hW, hWids, hWgrp, hG, hGids, hGgrp = bufs_h[0]
    coll_h = (h_n, gsh.stats.dists_evaluated)      # [10c] sets the ring
    del bufs_h, gsh, gph, eng_hc
    _, _, hw_plain_ms, e_ = grouped_vs_plain(
        "[9e] nng_tile_grouped_hamming rank 0 W x W", "hamming", hW, hW,
        hWgrp, hWgrp, hWids, hWids, HAM_EPS)
    grp_err["hamming"] = max(grp_err["hamming"], e_)
    _, _, _, e_ = grouped_vs_plain(
        "[9e] nng_tile_grouped_hamming rank 0 G x W", "hamming", hG, hW,
        hGgrp, hWgrp, hGids, hWids, HAM_EPS, limit=16384)
    grp_err["hamming"] = max(grp_err["hamming"], e_)
    grp_h = grouped_times(
        "[9e] nng_tile_grouped_hamming rank 0 W x W", "hamming", hW, hW,
        hWgrp, hWgrp, hWids, hWids, HAM_EPS, HW, HW, popc_rate,
        lambda a, b: torch.cdist(a, b, p=0), hw_plain_ms,
        prep=lambda t: unpack_words(t).float())
    del hW, hWids, hWgrp, hG, hGids, hGgrp
    torch.cuda.empty_cache()
    print(f"[9e] script wall {time.perf_counter() - t_start:.1f} s")

    # L1 on [8]'s points at [8]'s eps
    eng_l, plan_l, bufs_l = spatial_setup("[9e] manhattan", pts8, EPS8,
                                          "manhattan", METRIC_K_CAP)
    check(NRANKS * NRANKS * (plan_l.cap_coal + plan_l.cap_ghost)
          * METRIC_K_CAP * 4 <= TABLE_BUDGET,
          "[9e] the L1 tables exceed the budget")
    print(f"[9e] manhattan: at [8]'s depth cut, n {N8} of {N} (the tables "
          f"fit the {TABLE_BUDGET} B budget)")
    lW, lWids, lWgrp, lG, lGids, lGgrp = bufs_l[0]
    del bufs_l, eng_l
    gsl, sl_launches = spatial_call("[9e] manhattan", pts8, EPS8,
                                    "manhattan", METRIC_K_CAP)
    P = torch.from_numpy(pts8).to(dev)
    i, j, (n_sp, n_pt) = edge_diff(gsl, gl, N8)
    off = (l1_d64(P[i], P[j]) - EPS8).abs() / (U32 * EPS8)
    far = float(off.max()) if len(off) else 0.0
    print(f"[9e] manhattan spatial graph vs [8]'s point-partition graph: "
          f"{gsl.num_edges} vs {gl.num_edges} edges, {n_sp} only in the "
          f"spatial graph, {n_pt} only in the point graph, the farthest at "
          f"|d64-eps| = {far:.4g} u·eps (knife {DIM} u·eps)")
    check(far <= DIM, "[9e] the L1 spatial graph differs off the knife")
    del P, gsl                                       # gl: [10d], [10e]
    _, _, lw_plain_ms, e_ = grouped_vs_plain(
        "[9e] nng_tile_grouped_l1 rank 0 W x W", "manhattan", lW, lW, lWgrp,
        lWgrp, lWids, lWids, EPS8, rows=2048)
    grp_err["manhattan"] = max(grp_err["manhattan"], e_)
    _, _, _, e_ = grouped_vs_plain(
        "[9e] nng_tile_grouped_l1 rank 0 G x W", "manhattan", lG, lW, lGgrp,
        lWgrp, lGids, lWids, EPS8, rows=2048, limit=16384)
    grp_err["manhattan"] = max(grp_err["manhattan"], e_)
    grp_l = grouped_times(
        "[9e] nng_tile_grouped_l1 rank 0 W x W", "manhattan", lW, lW, lWgrp,
        lWgrp, lWids, lWids, EPS8, DIM, 2 * DIM, l1_rate,
        lambda a, b: torch.cdist(a, b, p=1), lw_plain_ms)
    del lW, lWids, lWgrp, lG, lGids, lGgrp
    torch.cuda.empty_cache()
    print(f"[9e] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 10. the ghost ring and the spatial tree flavour ---------------------
    @contextlib.contextmanager
    def rank0_launch(name, at, want=lambda args, kw: True):
        """Spy on ``tdev.<name>`` while the body runs: of its calls that
        ``want``, keep the arguments (args, kwargs) of the first and of the
        next whose argument ``at`` is the first's (rank 0's W or cell
        forest): on the ring, rank 0's round-1 launch; under the collective
        exchange, rank 0's G x W traversal. Yields the list; its last entry
        is the kept launch."""
        kept, orig = [], getattr(tdev, name)

        def spy(*args, **kw):
            if len(kept) < 2 and want(args, kw) and (
                    not kept or args[at] is kept[0][0][at]):
                kept.append((args, kw))
            return orig(*args, **kw)

        setattr(tdev, name, spy)
        try:
            yield kept
        finally:
            setattr(tdev, name, orig)

    def ring_tables(label, plan, k_cap):
        """The id tables the ring's evaluations and W x W keep at ``k_cap``
        under ``plan``, for all ranks on the card (printed, returned)."""
        evals = NRANKS * (NRANKS // 2 + 1) - (
            NRANKS // 2 if NRANKS % 2 == 0 else 0)
        ring_t = evals * plan.cap_rank * k_cap * 4
        w_t = NRANKS * NRANKS * plan.cap_coal * k_cap * 4
        print(f"{label} plan cap_coal {plan.cap_coal}, cap_rank "
              f"{plan.cap_rank}: {evals} ring evaluations of {plan.cap_rank} "
              f"rows at k_cap {k_cap}: id tables {ring_t} B, W x W {w_t} B, "
              f"{ring_t + w_t} B for all ranks")
        return ring_t + w_t

    def ring_launch(label, kept):
        """The ghost launch ``rank0_launch`` kept -> (x, y, words, y cells,
        eps), its ghost cells printed."""
        x, y, gb, yg, eps = kept[-1][0][:5]
        print(f"{label} rank 0's round-1 launch: {x.shape[0]} visiting rows "
              f"against {y.shape[0]}, {int(popcount32(gb).sum())} ghost "
              f"cells set ({gb.shape[1]} words a row)")
        return x, y, gb, yg, eps

    def ghost_live(gb, yg, ordered=False):
        """(pairs, blocks) in a ghost kernel's live blocks, and the pairs
        the function needs: a row against a column of a cell in the row's
        ghost set. The block skip of the Hamming and L1 kernels (128 x 128
        blocks in the caller's row order), or with ``ordered`` the L2
        kernel's (PIPE_TILE tiles of the rows in ``ghost_row_order``, their
        keys restricted to y's cells: ``ghost_tile_plan``'s list)."""
        tq, tp = PIPE_TILE if ordered else (128, 128)
        words = ghost_tile_plan(gb, yg)[1] if ordered else gb
        live = ghost_block_active(_pad_rows(words, tq)[0],
                                  _pad_rows(yg, tp, -1)[0], tq, tp)
        pairs, blocks = live_pairs_of(live, gb.shape[0], yg.shape[0], tq, tp)
        xc = unpack_words(gb).sum(0)
        yc = torch.bincount(yg[yg >= 0].long(), minlength=xc.shape[0])
        return pairs, blocks, int((xc.long() * yc.long()).sum())

    def ghost_times(label, metric, launch, feat, pair_ops, rate, library,
                    plain_ms, prep=lambda t: t):
        """The ghost kernel at one of the path's launches (x, y, words, y
        cells, eps), as ``grouped_times``: the needed pairs are a row
        against a column of a cell in its ghost set; bytes are x, y, the
        ghost words and y's cells in, cnt and the words out."""
        x, y, gb, yg, eps = launch
        kern = GHOST[metric][0]
        q_, p_ = x.shape[0], y.shape[0]
        ms = cuda_ms(torch, lambda: kern(x, y, gb, yg, eps), 5)
        ordered = metric != "hamming"      # the ghost order's live tiles
        pairs, blocks, need = ghost_live(gb, yg, ordered=ordered)
        nbytes = int(kcost.ghost_cost(metric, q_, p_, feat,
                                      gb.shape[1]).nbytes)
        out = fused_times(label, ms, x, y, feat, need, "ghost-cell", pairs,
                          blocks, nbytes, pair_ops, rate, library, plain_ms,
                          prep, tile=PIPE_TILE if ordered else (128, 128))
        if ordered:
            old_p, old_b, _ = ghost_live(gb, yg)
            print(f"{label} the old design's live 128x128 blocks in the "
                  f"caller's order: {old_b} of "
                  f"{-(-q_ // 128) * -(-p_ // 128)}, {old_p} pairs "
                  f"({old_p / max(need, 1):.3f}x the needed pairs)" + (
                      f"; its time (the parent design): "
                      f"{PARENT_MS[kern.__name__[:-5]]}"
                      if kern.__name__[:-5] in PARENT_MS else ""))
        return out

    def ghost_parts(label, launch, lib, whole_ms, launches):
        """A pipelined ghost call's parts at ``launch``: the row order and
        live-tile list, the gathered x, the zeroed outputs, and kernel
        ``lib``'s launch alone (for L2 its norm pre-pass too), each timed
        apart, beside the whole call's ``whole_ms``."""
        x_, y_, gb_, yg_, eps_ = launch
        q_, p_ = x_.shape[0], y_.shape[0]
        plan_ms = cuda_ms(torch, lambda: ghost_tile_plan(gb_, yg_), 5)
        rows_, keys_, tiles_, count_ = ghost_tile_plan(gb_, yg_)
        gather_ms = cuda_ms(torch, lambda: x_[rows_], 5)
        zero_ms = cuda_ms(torch, lambda: (
            torch.zeros(q_, dtype=torch.int32, device=dev),
            torch.zeros((q_, -(-p_ // 32)), dtype=torch.int32, device=dev)),
            5)
        xs_, r32_ = x_[rows_], rows_.to(torch.int32)
        c_ = torch.zeros(q_, dtype=torch.int32, device=dev)
        b_ = torch.zeros((q_, -(-p_ // 32)), dtype=torch.int32, device=dev)
        kern_ms = cuda_ms(torch, lambda: ghost_launch(
            lib, xs_, y_, keys_, yg_, r32_, tiles_, count_, eps_, c_, b_), 5)
        print(f"{label} {lib}'s parts at that launch: row order and "
              f"live-tile list {plan_ms:.3f} ms, x gathered {gather_ms:.3f} "
              f"ms, cnt and bits zeroed {zero_ms:.3f} ms, the kernel's "
              f"launch ({'norm pre-pass and ' if lib == 'nng_tile_ghost' else ''}"
              f"{int(count_[0])} live tiles of {tiles_.numel()}) "
              f"{kern_ms:.3f} ms against {whole_ms:.3f} ms for the call; "
              f"{launches} launches on the ring call, 1 a call")

    def spatial_tree_kernels(label, metric, kept):
        """The spatial tree path's traversal that ``rank0_launch`` kept,
        traced again: its widest frontier level against the metric's plain
        version, and its first leaf_range_pack against the plain version
        (bit-identical). Returns the worst count difference."""
        args, kw = kept[-1]
        qp, qids, qcells, forest_r, eps, k_cap = args[:6]
        ghost = kw.get("ghost")
        _, wall_, lin, fst, packs = traced_traverse(
            qp, qids, forest_r, eps, k_cap, metric=metric, qcells=qcells,
            ghost=ghost)
        lv = max(range(len(fst)), key=lambda l: int(tdev._popcount(fst[l][4])))
        q, c, rad, leaf, act = fst[lv][:5]
        name = f"tree_frontier{TREE_TAG[metric]}"
        what = ("rank 0's round-1 ring traversal" if ghost is not None
                else "rank 0's G x W traversal")
        head = (f"{label} {name} at {what}, level {lv} of {len(fst)} "
                f"({q.shape[0]}x{c.shape[0]}, {int(tdev._popcount(act))} "
                f"active pairs; {len(lin)} launches, {wall_:.3f} s)")
        if metric == "euclidean":
            err = frontier_vs_plain(head, q, c, rad, leaf, act)
        else:
            kern, plain = ((tree_frontier_hamming_cuda,
                            tree_frontier_hamming_ref)
                           if metric == "hamming" else
                           (tree_frontier_l1_cuda, tree_frontier_l1_ref))
            err = frontier_vs_plain_m(head, kern, plain, q, c, rad, leaf, act,
                                      eps)
        dl, li, qi = packs[0]
        nl = li.shape[0]
        c1, b1 = leaf_range_pack_cuda(dl, li, qi)
        c0, b0 = leaf_range_pack_ref(dl[:, :nl], li, qi)
        check(torch.equal(c1, c0) and torch.equal(b1, b0),
              f"{label} leaf_range_pack differs from its plain version")
        print(f"{label} leaf_range_pack at that traversal's first pass "
              f"({dl.shape[0]} rows x {nl} leaf slots): bit-identical")
        del lin, fst, packs
        return err

    def ghost_arg(args, kw):
        return kw.get("ghost") is not None

    print(f"[10] the ghost ring (ghost_mode='ring') and the spatial tree "
          f"flavour; script wall {time.perf_counter() - t_start:.1f} s")
    # -- 10a. the ghost kernels against their plain versions ----------------
    def ghost_anchor_check(label, x, y, gb, yg, eps, cnt, bits, rows=2048,
                           metric="euclidean"):
        """The L2 (L1) ghost kernel's (cnt, bits), in x's row order, bit for
        bit against the anchor's hits (L2: the plain chain kernel's d²,
        ``l2_chain_d2_cuda``; L1: ``nng_tile_l1``'s d on l1_tile.cuh), row
        chunks, under the plain version's ghost test (``ghost_hit``)."""
        p_ = y.shape[0]
        ones_ = torch.ones(p_, dtype=torch.int32, device=dev)
        for r0 in range(0, x.shape[0], rows):
            sl = slice(r0, r0 + rows)
            if metric == "euclidean":
                hb = l2_chain_d2_cuda(x[sl], y) <= eps2_f32(eps)
            else:
                hb = unpack_words(nng_tile_l1_cuda(x[sl], y, ones_, eps)[1])
            hit = ghost_hit(hb[:, :p_], gb[sl], yg)
            del hb
            check(torch.equal(cnt[sl], hit.sum(1, dtype=torch.int32))
                  and torch.equal(bits[sl], pack_words(
                      torch.nn.functional.pad(hit, (0, -p_ % 32)))),
                  f"{label}: differs from the old core's hits under the "
                  f"ghost test in rows {r0}..{r0 + rows - 1}")
            del hit

    def gap_eps(x, y, gb, yg):
        """An L2 eps at least 1e-4·eps from the float64 distance of every
        pair the ghost function needs (no other pair can hit), so that no
        fp32 evaluation order splits a pair: the widest gap within 0.2% of
        those pairs around the first quantile in 0.05, 0.02, ... 0.001
        that has one; any eps where no pair is needed."""
        dd = torch.cdist(x.double(), y.double())
        need = ghost_hit(torch.ones_like(dd, dtype=torch.bool), gb, yg)
        dd = (dd[need] if bool(need.any()) else dd.flatten()).sort().values
        if not bool(need.any()):
            return float(dd[len(dd) // 20])
        for quantile in (0.05, 0.02, 0.01, 0.005, 0.002, 0.001):
            k = int(quantile * (len(dd) - 1))
            w = max(len(dd) // 500, 8)
            lo, hi = max(k - w, 0), min(k + w, len(dd) - 1)
            j = lo + int((dd[lo + 1:hi + 1] - dd[lo:hi]).argmax())
            eps = 0.5 * float(dd[j] + dd[j + 1])
            if float((dd - eps).abs().min()) > 1e-4 * eps:
                return eps
        raise SmokeFailure("no gap-safe eps among the needed pairs")

    ghost_err = {m_: 0 for m_ in GHOST}
    resident = 2 * n_sm
    for metric in GHOST:
        for q, p, d, m_, pattern in ((37, 64, 3, 32, "random"),
                                     (1000, 777, 25, 70, "random"),
                                     (600, 1200, 9, 70, "sorted"),
                                     (300, 515, 40, 32, "disjoint"),
                                     (700, 1500, 32, 32, "interleave"),
                                     (500, 900, 16, 32, "zero"),
                                     (1000, 2000, 24, 40, "sorted"),
                                     (3000, 6000, 16, 32, "sparse"),
                                     (300, 250, 7, 40, "one")):
            if metric == "hamming":
                x, y = (torch.from_numpy(rng.integers(
                    -2**31, 2**31, size=(r_, d)).astype(np.int32)).to(dev)
                    for r_ in (q, p))
                eps = float(torch.quantile(hamming_dist(x, y).flatten()[
                    :1 << 24].float(), 0.05)) + 0.5
            else:
                x, y = (torch.from_numpy(rng.normal(size=(r_, d)).astype(
                    np.float32)).to(dev) for r_ in (q, p))
                eps = float(torch.quantile(torch.cdist(
                    x, y, p=1 if metric == "manhattan" else 2).flatten()[
                        :1 << 24], 0.05))
            sets = np.zeros((q, m_), bool)
            if pattern == "random":
                yg = rng.integers(-1, m_, size=p)
                sets = rng.random((q, m_)) < 0.3
            elif pattern in ("sorted", "interleave", "sparse"):
                # the engine's cell-sorted W, trailing padding
                yg = np.sort(rng.integers(0, m_, size=p))
                yg[p - p // 17:] = -1
                for i_ in range(q):
                    if pattern == "sorted":
                        near = i_ * m_ // q + rng.integers(-2, 3, 3)
                    elif pattern == "interleave":     # keys alternate
                        near = np.array([7 * i_, 7 * i_ + 1]) % m_
                    else:         # a few rows with one cell: few live tiles
                        near = rng.integers(0, m_, 1) if i_ % 150 == 0 \
                            else np.zeros(0, np.int64)
                    sets[i_, np.clip(near, 0, m_ - 1)] = True
            elif pattern == "one":
                # one cell, its columns inside one 256-column tile, on a
                # few rows (every 7th of the first 280): one live tile
                yg = np.sort(rng.integers(0, m_, size=p))
                sets[:280:7, yg[p // 2]] = True
            elif pattern == "zero":
                # ghost bits only on cells y lacks, inside y's cell range:
                # every key is zero, though the words are not
                yg = 2 * rng.integers(0, m_ // 2, size=p)
                sets = rng.random((q, m_)) < 0.3
                sets[:, ::2] = False
            else:
                yg = rng.integers(m_ // 2, m_, size=p)
                sets = rng.random((q, m_)) < 0.3
                sets[:, m_ // 2:] = False
            gb = pack_words(torch.nn.functional.pad(
                torch.from_numpy(sets), (0, -m_ % 32)).to(dev))
            yg = torch.from_numpy(yg.astype(np.int32)).to(dev)
            if metric == "euclidean":
                eps = gap_eps(x, y, gb, yg)
            label = (f"[10a] {GHOST[metric][0].__name__[:-5]} {pattern} "
                     f"({q},{p},{d}) m={m_}")
            cnt, bits, _, e_ = ghost_vs_plain(label, metric, x, y, gb, yg,
                                              eps)
            ghost_err[metric] = max(ghost_err[metric], e_)
            if pattern in ("disjoint", "zero"):
                check(not bits.any() and not cnt.any(),
                      f"[10a] {metric}: {pattern} ghost cells set a word")
            if metric != "hamming":
                # bit for bit: the plain version (L2: a gap-safe eps; L1:
                # the same summation order, any eps), and the old core's
                # hits under the ghost test
                yp, ygp = _pad_rows(y, 32)[0], _pad_rows(yg, 32, -1)[0]
                c0, b0 = GHOST[metric][1](x, yp, gb, ygp, eps)
                check(torch.equal(cnt, c0) and torch.equal(
                    bits, b0[:, :bits.shape[1]]),
                      f"{label}: differs from its plain version")
                ghost_anchor_check(label, x, y, gb, yg, eps, cnt, bits,
                                   metric=metric)
                live_t = int(ghost_tile_plan(gb, yg)[3][0])
                n_t = -(-q // PIPE_TILE[0]) * -(-p // PIPE_TILE[1])
                anchor = ("l2_chain" if metric == "euclidean"
                          else "nng_tile_l1")
                print(f"    {label}: bit-identical to its plain version and "
                      f"to {anchor}'s hits under the ghost test; "
                      f"{live_t} of {n_t} tiles live (the ghost order), "
                      f"{resident} resident blocks")
                if pattern == "sparse":
                    check(0 < live_t < resident, f"{label}: {live_t} live "
                          f"tiles, not fewer than {resident} blocks")
                if pattern in ("disjoint", "zero"):
                    check(live_t == 0, f"{label}: {live_t} live tiles")
                if pattern == "one":
                    check(live_t == 1, f"{label}: {live_t} live tiles")
    print("[10a] every disjoint and zero-key case stored zero words")
    torch.cuda.empty_cache()
    print(f"[10a] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 10b. the ring call at [3]'s shape ------------------------------------
    with rank0_launch("nng_tile_bits_ghost", 1) as kept:
        gr, r_launches = spatial_call("[10b]", pts, EPS, "euclidean",
                                      SP_K_CAP, ghost_mode="ring")
    parent_check("[10b] ring", gr)
    ring_tables("[10b]", gr.meta["plan"], SP_K_CAP)
    l2_launch = ring_launch("[10b] nng_tile_ghost", kept)
    del kept
    counters = (f"{gr.stats.tiles_scheduled:.0f}",
                f"{gr.stats.tiles_skipped:.0f}",
                f"{gr.stats.dists_evaluated:.6g}")
    print(f"[10b] tiles_scheduled, tiles_skipped, dists_evaluated "
          f"{counters}; as printed by the single-tile ghost kernel's tree "
          f"on this call: {RING_COUNTERS}")
    check(counters == RING_COUNTERS, "[10b] the ring's counters moved")
    old_p, old_b, need_p = ghost_live(*l2_launch[2:4])
    new_p, new_b, _ = ghost_live(*l2_launch[2:4], ordered=True)
    print(f"[10b] rank 0's round-1 launch: {need_p} pairs needed; the live "
          f"{PIPE_TILE[0]}x{PIPE_TILE[1]} tiles of the ghost row order "
          f"({new_b} of them) hold {new_p} pairs, {new_p / need_p:.4f}x; "
          f"the live 128x128 blocks of the caller's order ({old_b}) "
          f"{old_p}, {old_p / need_p:.4f}x")
    print(f"[10b] nng_tile_ghost launches on this call: "
          f"{r_launches['nng_tile_ghost']}; dists_evaluated "
          f"{gr.stats.dists_evaluated:.6g} against the collective exchange's "
          f"{coll_stats.dists_evaluated:.6g} ([9b]); comm_bytes ghost_ring "
          f"{gr.stats.comm_bytes['ghost_ring']:.6g} against ghost "
          f"{coll_stats.comm_bytes['ghost']:.6g}")
    gc_, gbits_, gl2_plain_ms, e_ = ghost_vs_plain(
        "[10b] nng_tile_ghost at rank 0's round-1 launch", "euclidean",
        *l2_launch)
    ghost_err["euclidean"] = max(ghost_err["euclidean"], e_)
    ghost_anchor_check("[10b] nng_tile_ghost at rank 0's round-1 launch",
                       *l2_launch, gc_, gbits_)
    print("[10b] nng_tile_ghost at rank 0's round-1 launch bit-identical, "
          "in every count and word, to the chain anchor l2_chain's hits "
          "under the plain version's ghost test")
    del gc_, gbits_
    eng_r = SpatialPartitionEngine(pts, EPS, mesh, "euclidean",
                                   k_cap=SP_K_CAP, ghost_mode="ring")
    out, _ = profiled_run("[10b]", lambda: eng_r.run(gr.meta["plan"]))
    del out, eng_r
    P = torch.from_numpy(pts).to(dev)
    i, j, (n_r, n_pt) = edge_diff(gr, g, N)
    print(f"[10b] ring graph vs [3]'s point-partition graph: "
          f"{gr.num_edges} vs {g.num_edges} edges, {n_r} only in the ring "
          f"graph, {n_pt} only in the point graph")
    knife_check("[10b] ring vs point", P, P, i, j, eps2)
    sample_check("[10b]", gr, P)
    del P, gr
    torch.cuda.empty_cache()
    print(f"[10b] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 10c. Hamming at the full nng-word2bits stand-in through the ring ----
    # sized from [9e]'s device plan of the full stand-in (the same planner
    # the ring runs)
    k_r = max(METRIC_K_CAP, -(-(h_max_deg + 1) // 1024) * 1024)
    h_tables = ring_tables("[10c] hamming ([9e]'s plan of the full points)",
                           plan_h, k_r)
    h_n = HN if h_tables <= TABLE_BUDGET else HAM_SP_N
    print(f"[10c] hamming at the full {HN} x {HW} words, k_cap {k_r} (above "
          f"[7]'s max degree {h_max_deg}): the ring's and W x W's id tables "
          f"take {h_tables} B for all {NRANKS} ranks against a budget of "
          f"{TABLE_BUDGET} B: " + ("no depth cut" if h_n == HN else
                                   f"depth cut to the first {h_n} points"))
    with rank0_launch("nng_tile_bits_ghost", 1) as kept:
        grh, rh_launches = spatial_call("[10c] hamming", hpts[:h_n], HAM_EPS,
                                        "hamming", k_r, ghost_mode="ring")
    h_launch = ring_launch("[10c] nng_tile_ghost_hamming", kept)
    del kept
    gph = gh if h_n == HN else graph_call(
        f"[10c] hamming point partition at n {h_n}", hpts[:h_n], HAM_EPS,
        "hamming", "tiles")[0]
    check(np.array_equal(grh.edge_key(), gph.edge_key()),
          "[10c] the hamming ring graph differs from the point graph")
    print(f"[10c] hamming: the ring graph equals the point-partition graph "
          f"bit for bit ({grh.num_edges} edges); dists_evaluated "
          f"{grh.stats.dists_evaluated:.6g} against the point partition's "
          f"{gh.stats.dists_evaluated:.6g} ([7b], n {HN}) and the collective "
          f"exchange's {coll_h[1]:.6g} ([9e], n {coll_h[0]}); comm_bytes "
          f"{json.dumps(grh.stats.comm_bytes)}")
    _, _, gh_plain_ms, e_ = ghost_vs_plain(
        "[10c] nng_tile_ghost_hamming at rank 0's round-1 launch", "hamming",
        *h_launch)
    ghost_err["hamming"] = max(ghost_err["hamming"], e_)
    del grh                                          # gph: [10e]
    torch.cuda.empty_cache()
    print(f"[10c] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 10d. L1 through the ring at [8]'s cut -------------------------------
    with rank0_launch("nng_tile_bits_ghost", 1) as kept:
        grl, rl_launches = spatial_call("[10d] manhattan", pts8, EPS8,
                                        "manhattan", METRIC_K_CAP,
                                        ghost_mode="ring", profiled=True)
    ring_tables("[10d] manhattan", grl.meta["plan"], METRIC_K_CAP)
    parent_check("[10d] manhattan", grl)
    l1_launch = ring_launch("[10d] nng_tile_ghost_l1", kept)
    del kept
    P = torch.from_numpy(pts8).to(dev)
    i, j, (n_r, n_pt) = edge_diff(grl, gl, N8)
    off = (l1_d64(P[i], P[j]) - EPS8).abs() / (U32 * EPS8)
    far = float(off.max()) if len(off) else 0.0
    print(f"[10d] manhattan ring graph vs [8]'s point-partition graph: "
          f"{grl.num_edges} vs {gl.num_edges} edges, {n_r} only in the ring "
          f"graph, {n_pt} only in the point graph, the farthest at "
          f"|d64-eps| = {far:.4g} u·eps (knife {DIM} u·eps)")
    check(far <= DIM, "[10d] the L1 ring graph differs off the knife")
    del P, grl
    gc_, gbits_, gl1_plain_ms, e_ = ghost_vs_plain(
        "[10d] nng_tile_ghost_l1 at rank 0's round-1 launch", "manhattan",
        *l1_launch, rows=2048)
    ghost_err["manhattan"] = max(ghost_err["manhattan"], e_)
    ghost_anchor_check("[10d] nng_tile_ghost_l1 at rank 0's round-1 launch",
                       *l1_launch, gc_, gbits_, metric="manhattan")
    print("[10d] nng_tile_ghost_l1 at rank 0's round-1 launch bit-identical, "
          "in every count and word, to nng_tile_l1's hits (l1_tile.cuh) "
          "under the plain version's ghost test")
    del gc_, gbits_
    torch.cuda.empty_cache()
    print(f"[10d] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 10e. the spatial tree flavour ---------------------------------------
    P = torch.from_numpy(pts).to(dev)
    for mode in ("coll", "ring"):
        with rank0_launch("_query_tree", 3, ghost_arg) as kept:
            gt_, _ = spatial_call(f"[10e] tree {mode}", pts, EPS,
                                  "euclidean", SP_K_CAP, ghost_mode=mode,
                                  traversal="tree")
        i, j, (n_t, n_pt) = edge_diff(gt_, g, N)
        print(f"[10e] tree {mode} graph vs [3]'s point-partition graph: "
              f"{gt_.num_edges} vs {g.num_edges} edges, {n_t} only in the "
              f"tree graph, {n_pt} only in the point graph")
        parent_check(f"[10e] tree {mode}", gt_)
        knife_check(f"[10e] tree {mode} vs point", P, P, i, j, eps2)
        plan_t = gt_.meta["plan"]
        del gt_
        if mode == "ring":
            eng_t = SpatialPartitionEngine(pts, EPS, mesh, "euclidean",
                                           k_cap=SP_K_CAP, ghost_mode="ring",
                                           traversal="tree")
            out, _ = profiled_run("[10e] tree ring", lambda: eng_t.run(plan_t))
            del out, eng_t
    del P
    torch.cuda.empty_cache()
    front_err = max(front_err, spatial_tree_kernels("[10e]", "euclidean",
                                                    kept))
    with rank0_launch("_query_tree", 3, ghost_arg) as kept:
        gth, _ = spatial_call("[10e] hamming tree ring", hpts[:h_n],
                              HAM_EPS, "hamming", k_r, ghost_mode="ring",
                              traversal="tree")
    check(np.array_equal(gth.edge_key(), gph.edge_key()),
          "[10e] the hamming tree ring graph differs from the point graph")
    print(f"[10e] hamming tree ring graph equals the point-partition graph "
          f"bit for bit ({gth.num_edges} edges)")
    parent_check("[10e] hamming tree ring", gth)
    del gth, gph
    ham_err = max(ham_err, spatial_tree_kernels("[10e] hamming", "hamming",
                                                kept))
    with rank0_launch("_query_tree", 3) as kept:
        gtl, _ = spatial_call("[10e] manhattan tree coll", pts8, EPS8,
                              "manhattan", METRIC_K_CAP, traversal="tree")
    P = torch.from_numpy(pts8).to(dev)
    i, j, (n_t, n_pt) = edge_diff(gtl, gl, N8)
    off = (l1_d64(P[i], P[j]) - EPS8).abs() / (U32 * EPS8)
    far = float(off.max()) if len(off) else 0.0
    print(f"[10e] manhattan tree coll graph vs [8]'s tiles graph: "
          f"{gtl.num_edges} vs {gl.num_edges} edges, {n_t} / {n_pt} only in "
          f"one, the farthest at |d64-eps| = {far:.4g} u·eps (knife {DIM} "
          f"u·eps)")
    check(far <= DIM, "[10e] the L1 tree graph differs off the knife")
    parent_check("[10e] manhattan tree coll", gtl)
    del P, gtl
    l1_err = max(l1_err, spatial_tree_kernels("[10e] manhattan",
                                              "manhattan", kept))
    del kept
    torch.cuda.empty_cache()
    print(f"[10e] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 10f. the ghost kernels' times at the path's launches -----------------
    gt_l2 = ghost_times(
        "[10f] nng_tile_ghost at rank 0's round-1 launch", "euclidean",
        l2_launch, DIM, 2 * DIM, PEAK_FP32, lambda a, b: torch.mm(a, b.T),
        gl2_plain_ms)
    ghost_parts("[10f]", l2_launch, "nng_tile_ghost", gt_l2[0],
                r_launches["nng_tile_ghost"])
    live_p, _, need_p = ghost_live(*l2_launch[2:4], ordered=True)
    print(f"[10f] nng_tile_ghost: bound over the needed pairs "
          f"{gt_l2[1]:.3f} ms, over the live tiles' {live_p} pairs "
          f"({live_p / need_p:.4f}x) {2 * DIM * live_p / PEAK_FP32 * 1e3:.3f}"
          f" ms ({gt_l2[2]}); library {gt_l2[3]:.3f} ms")
    gt_h = ghost_times(
        "[10f] nng_tile_ghost_hamming at rank 0's round-1 launch", "hamming",
        h_launch, HW, HW, popc_rate, lambda a, b: torch.cdist(a, b, p=0),
        gh_plain_ms, prep=lambda t: unpack_words(t).float())
    gt_l1 = ghost_times(
        "[10f] nng_tile_ghost_l1 at rank 0's round-1 launch", "manhattan",
        l1_launch, DIM, 2 * DIM, l1_rate,
        lambda a, b: torch.cdist(a, b, p=1), gl1_plain_ms)
    ghost_parts("[10f]", l1_launch, "nng_tile_ghost_l1", gt_l1[0],
                rl_launches["nng_tile_ghost_l1"])
    print(f"[10f] launches: nng_tile_ghost {r_launches['nng_tile_ghost']} "
          f"([10b]), nng_tile_ghost_hamming "
          f"{rh_launches['nng_tile_ghost_hamming']} ([10c]), "
          f"nng_tile_ghost_l1 {rl_launches['nng_tile_ghost_l1']} ([10d])")
    del l2_launch, h_launch, l1_launch, gh, gl
    torch.cuda.empty_cache()
    print(f"[10f] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 11. the distance-kernel API -----------------------------------------
    # The reference's public kernel API (repro.kernels.pairwise_sqdist,
    # pairwise_hamming, eps_count), which no engine calls: its three kernels
    # against their plain versions and float64 on ragged shapes [11a], at
    # the reference micro-bench's shapes [11b], and at full width through
    # the public calls, each kernel's launches counted from those calls
    # alone [11c]; their times beside their bounds [11d].
    print(f"[11] the distance-kernel API; script wall "
          f"{time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()

    def sq_bound(a, b):
        """(q, p) float64 bound 2·(d + 2)·u·(‖a_i‖² + ‖b_j‖²): two fp32
        evaluations of the expansion, or one and the exact value."""
        a, b = a.double(), b.double()
        return (2 * (a.shape[1] + 2) * U32) * ((a * a).sum(1)[:, None]
                                               + (b * b).sum(1)[None, :])

    def sq64(a, b):
        """(q, p) float64 squared distances by the float64 expansion."""
        a, b = a.double(), b.double()
        return ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
                - 2.0 * a @ b.T).clamp_min_(0)

    def sqdist_within(label, got, want, a, b, rows=1024):
        """Fail unless ``got`` is within ``sq_bound`` of ``want`` (a tensor
        or a function of the row slice) everywhere; returns max |diff|."""
        err = 0.0
        for r0 in range(0, a.shape[0], rows):
            sl = slice(r0, r0 + rows)
            w = want(sl) if callable(want) else want[sl]
            diff = (got[sl].double() - w.double()).abs_()
            bad = int((diff > sq_bound(a[sl], b)).sum())
            check(bad == 0, f"{label}: {bad} elements differ by more than "
                            "2·(d+2)·u·(‖x‖²+‖y‖²)")
            err = max(err, float(diff.max()))
            del w, diff
        return err

    def count_knife_check(label, cnt_a, cnt_b, a, b, thr):
        """Fail unless every row whose two counts differ has at least as
        many pairs on the knife edge of ``thr`` (float64 d²) as the
        counts differ by; returns max |cnt diff|."""
        rows_ = (cnt_a != cnt_b).nonzero()[:, 0]
        bn = (b.double() ** 2).sum(1)
        worst = 0
        for r0 in range(0, len(rows_), 256):
            r = rows_[r0:r0 + 256]
            d2 = sq64(a[r], b)
            scale = (a[r].double() ** 2).sum(1)[:, None] + bn[None, :]
            knife = (KNIFE_ULPS * U32 * scale).clamp_min_(KNIFE_REL * thr)
            on = ((d2 - thr).abs() <= knife).sum(1)
            diff = (cnt_a[r] - cnt_b[r]).abs()
            bad = int((diff > on).sum())
            check(bad == 0, f"{label}: {bad} rows' counts differ by more "
                            "than their knife-edge pairs")
            worst = max(worst, int(diff.max()))
            del d2, scale, knife
        print(f"    {label}: counts differ on {len(rows_)} of {len(cnt_a)} "
              f"rows, each by no more than its knife-edge pairs")
        return worst

    # -- 11a. ragged shapes against the plain versions and float64 ----------
    gen11 = torch.Generator(device=dev).manual_seed(SEED)
    for q, p, d in ((1, 1, 1), (1, 300, 17), (300, 1, 700), (127, 129, 700),
                    (129, 127, 1), (300, 300, 17), (1000, 777, 700)):
        a = torch.randn(q, d, generator=gen11, device=dev)
        b = torch.randn(p, d, generator=gen11, device=dev) + 0.5
        got = pairwise_sqdist_cuda(a, b)
        e_p = sqdist_within(f"[11a] pairwise_sqdist ({q},{p},{d}) vs plain",
                            got, tref.pairwise_sqdist_blas3_ref(a, b), a, b)
        e_64 = sqdist_within(f"[11a] pairwise_sqdist ({q},{p},{d}) vs "
                             f"float64", got, sq64(a, b), a, b)
        check(bool((got >= 0).all()), "[11a] pairwise_sqdist below zero")
        eps_r = float(sq64(a, b).flatten().float().quantile(0.05).sqrt())
        cnt_k = eps_count_cuda(a, b, eps_r)
        cnt_t, _ = nng_tile_cuda(a, b, torch.ones(p, dtype=torch.int32,
                                                  device=dev), eps_r)
        check(torch.equal(cnt_k, cnt_t), f"[11a] eps_count ({q},{p},{d}) "
                                         "differs from nng_tile's cnt")
        # the pipelined core's kernels against the chain anchor, at an eps
        # on a pair's fp32 d² (a tiny draw may hold none: draw again)
        a_k, b_k, eps_k = a, b, eps_on_pair(got, 0.05)
        while eps_k is None:
            a_k = torch.randn(q, d, generator=gen11, device=dev)
            b_k = torch.randn(p, d, generator=gen11, device=dev) + 0.5
            eps_k = eps_on_pair(pairwise_sqdist_cuda(a_k, b_k), 0.05)
        on_k = chain_check(f"[11a] ({q},{p},{d})", a_k, b_k, torch.ones(
            p, dtype=torch.int32, device=dev), eps_k)
        count_knife_check(f"[11a] eps_count ({q},{p},{d}) vs plain", cnt_k,
                          eps_count_plain(a, b, eps_r), a, b,
                          eps2_f32(eps_r))
        print(f"[11a] pairwise_sqdist ({q},{p},{d}): max |diff| {e_p:.4g} "
              f"vs plain, {e_64:.4g} vs float64, within the bound; eps_count "
              f"at eps {eps_r:.6g} equal to nng_tile's cnt; at eps {eps_k:.9g} "
              f"nng_tile, nng_tile_grouped, eps_count and pairwise_sqdist "
              f"equal the chain anchor's (pairs on eps²: {on_k})")
    for q, p, w in ((1, 1, 1), (1, 300, 3), (300, 1, 25), (127, 129, 26),
                    (129, 127, 1), (300, 300, 25), (1000, 777, 26)):
        a = torch.randint(-2**31, 2**31, (q, w), generator=gen11,
                          device=dev, dtype=torch.int64).to(torch.int32)
        b = torch.randint(-2**31, 2**31, (p, w), generator=gen11,
                          device=dev, dtype=torch.int64).to(torch.int32)
        a[::7] = -1
        b[::5] = a[0]
        check(torch.equal(pairwise_hamming_cuda(a, b),
                          tref.pairwise_hamming_ref(a, b)),
              f"[11a] pairwise_hamming ({q},{p},{w}) differs from its plain "
              "version")
    print("[11a] pairwise_hamming bit-identical to its plain version at "
          "w in (1, 3, 25, 26), q or p = 1 among them")

    # -- 11b. the reference micro-bench's shapes -----------------------------
    brng = np.random.default_rng(0)
    bx = torch.from_numpy(brng.normal(size=(2048, 128)).astype(
        np.float32)).to(dev)
    bw = torch.from_numpy(brng.integers(0, 2**32, size=(2048, 25),
                                        dtype=np.uint32).view(np.int32)).to(dev)
    b_eps = DENSE_EPS
    for key, fn, plain, ops_, rate, nbytes in (
            ("kernel/pairwise_sqdist/2048x2048x128",
             lambda: tk.pairwise_sqdist(bx, bx),
             lambda: tref.pairwise_sqdist_blas3_ref(bx, bx),
             2 * 2048 * 2048 * 128, PEAK_FP32, 4 * (2 * 2048 * 128 + 2048**2)),
            ("kernel/pairwise_hamming/2048x2048x800b",
             lambda: tk.pairwise_hamming(bw, bw),
             lambda: tref.pairwise_hamming_ref(bw, bw),
             2048 * 2048 * 25, popc_rate, 4 * (2 * 2048 * 25 + 2048**2)),
            ("kernel/eps_count/2048x2048x128",
             lambda: tk.eps_count(bx, bx, b_eps),
             lambda: eps_count_plain(bx, bx, b_eps),
             2 * 2048 * 2048 * 128, PEAK_FP32, 4 * (2 * 2048 * 128 + 2048))):
        ms = cuda_ms(torch, fn, 20)
        got, want = fn(), plain()
        if "sqdist" in key:
            sqdist_within(f"[11b] {key} vs plain", got, want, bx, bx)
        elif "hamming" in key:
            check(torch.equal(got, want), f"[11b] {key} differs from plain")
        else:
            cnt_t, _ = nng_tile_cuda(bx, bx, torch.ones(
                2048, dtype=torch.int32, device=dev), b_eps)
            check(torch.equal(got, cnt_t), f"[11b] {key} differs from "
                                           "nng_tile's cnt")
            count_knife_check(f"[11b] {key} vs plain", got, want, bx, bx,
                              eps2_f32(b_eps))
        bound = max(ops_ / rate, nbytes / PEAK_BYTES) * 1e3
        print(f"[11b] {key}: {ms:.4f} ms median of 20 (the public call on "
              f"the card's tensors); {ops_ / ms / 1e9:.4g} G"
              f"{'popc' if 'hamming' in key else 'flop'}/s; bound "
              f"{bound:.4f} ms")
    del bx, bw

    # -- 11c. full width through the public calls ----------------------------
    P = torch.from_numpy(pts).to(dev)
    sx = P[:8192].contiguous()              # a chunk of [3]'s points
    ex = P[:n_loc].contiguous()             # rank 0's block, as in [5]
    ey = P[n_loc:2 * n_loc].contiguous()    # one rank's block, as in [5]
    del P
    HX = get_metric("hamming").as_device(hpts, dev)
    hx8 = HX[:8192].contiguous()
    torch.cuda.empty_cache()
    for fn in API_KERNELS:
        fn.launches = 0
    d2_full = tk.pairwise_sqdist(sx, ey)
    ham_full = tk.pairwise_hamming(hx8, HX)
    cnt_full = tk.eps_count(ex, ey, EPS)
    torch.cuda.synchronize()
    api_launches = {fn.__name__[:-5]: fn.launches for fn in API_KERNELS}
    print(f"[11c] public calls: pairwise_sqdist {tuple(sx.shape)} x "
          f"{tuple(ey.shape)}, pairwise_hamming {tuple(hx8.shape)} x "
          f"{tuple(HX.shape)} words ({ham_full.numel()} int32 outputs, "
          f"{ham_full.numel() / 2**31:.3f} x 2^31), eps_count "
          f"{tuple(ex.shape)} x {tuple(ey.shape)} at eps {EPS}; launches "
          f"{json.dumps(api_launches)}")
    check(all(v > 0 for v in api_launches.values()),
          f"a kernel of the distance-kernel API never launched: "
          f"{api_launches}")
    # pairwise_sqdist: against its plain version (one call) and float64 on
    # sampled rows
    sq_plain, sq_plain_ms = events_ms(
        torch, lambda: tref.pairwise_sqdist_blas3_ref(sx, ey))
    sq_err = sqdist_within("[11c] pairwise_sqdist vs plain", d2_full,
                           sq_plain, sx, ey)
    del sq_plain
    rows11 = torch.from_numpy(np.sort(np.random.default_rng(
        SAMPLE_SEED).choice(8192, 64, replace=False))).to(dev)
    sq_err64 = sqdist_within("[11c] pairwise_sqdist sampled rows vs float64",
                             d2_full[rows11], sq64(sx[rows11], ey),
                             sx[rows11], ey)
    print(f"[11c] pairwise_sqdist within 2·(d+2)·u·(‖x‖²+‖y‖²) of its plain "
          f"version everywhere (max |diff| {sq_err:.4g}) and of float64 on "
          f"64 sampled rows (max |diff| {sq_err64:.4g}); min "
          f"{float(d2_full.min()):.6g}")
    del d2_full
    # pairwise_hamming: bit for bit against its plain version, row chunks
    ham_plain_ms11 = 0.0
    for r0 in range(0, 8192, 512):
        want, ms = events_ms(torch, lambda: tref.pairwise_hamming_ref(
            hx8[r0:r0 + 512], HX))
        ham_plain_ms11 += ms
        check(torch.equal(ham_full[r0:r0 + 512], want),
              f"[11c] pairwise_hamming differs from its plain version in "
              f"rows {r0}..{r0 + 511}")
        del want
    print(f"[11c] pairwise_hamming bit-identical to its plain version on "
          f"all {ham_full.numel()} outputs (offsets past 2^31 included)")
    del ham_full
    torch.cuda.empty_cache()
    # eps_count: bit for bit against nng_tile's cnt, off the knife against
    # its plain version
    ones11 = torch.ones(n_loc, dtype=torch.int32, device=dev)
    cnt_tile, bits_tile = nng_tile_cuda(ex, ey, ones11, EPS)
    del bits_tile
    check(torch.equal(cnt_full, cnt_tile), "[11c] eps_count differs from "
                                           "nng_tile's cnt")
    check(torch.equal(cnt_full, chain_cnt5), "[11c] eps_count differs from "
                                             "the chain anchor's hits ([5])")
    cnt_plain, eps_plain_ms = events_ms(
        torch, lambda: eps_count_plain(ex, ey, EPS))
    eps_err = count_knife_check("[11c] eps_count vs plain", cnt_full,
                                cnt_plain, ex, ey, eps2)
    print(f"[11c] eps_count equal to nng_tile's cnt and to the row sums of "
          f"the chain anchor's and pairwise_sqdist's hits on all {n_loc} "
          f"rows "
          f"({int(cnt_full.sum())} pairs)")
    del cnt_tile, cnt_plain, cnt_full, chain_cnt5

    # -- 11d. times at full width --------------------------------------------
    q_, p_, d_ = sx.shape[0], ey.shape[0], DIM
    sq_ms = cuda_ms(torch, lambda: pairwise_sqdist_cuda(sx, ey), 5)
    sq_c = kcost.pairwise_cost("euclidean", q_, p_, d_)
    sq_ops, sq_bytes = sq_c.ops, int(sq_c.nbytes)
    sq_b_ops, sq_b_bytes = sq_c.ops_ms, sq_c.bytes_ms
    sq_lib_ms = cuda_ms(torch, lambda: torch.mm(sx, ey.T), 5)
    torch.cuda.empty_cache()
    hq, hp = hx8.shape[0], HX.shape[0]
    hw_ms = cuda_ms(torch, lambda: pairwise_hamming_cuda(hx8, HX), 3)
    hw_c = kcost.pairwise_cost("hamming", hq, hp, HW, popc_rate=popc_rate)
    hw_pops, hw_bytes = hw_c.ops, int(hw_c.nbytes)
    hw_b_ops, hw_b_bytes = hw_c.ops_ms, hw_c.bytes_ms
    torch.cuda.empty_cache()
    ubits = unpack_words(HX).float()
    hw_lib_ms = library_rows(lambda a, b: torch.cdist(a, b, p=0),
                             ubits[:8192], ubits, rows=1024)
    del ubits
    torch.cuda.empty_cache()
    # eps_count beside nng_tile on the same inputs, in turns, in one window
    ec_tile_ms = cuda_ms(torch, lambda: nng_tile_cuda(ex, ey, ones11, EPS), 3)
    ec_ms = cuda_ms(torch, lambda: eps_count_cuda(ex, ey, EPS), 5)
    ec_tile_ms = min(ec_tile_ms, cuda_ms(
        torch, lambda: nng_tile_cuda(ex, ey, ones11, EPS), 3))
    ec_c = kcost.eps_count_cost(n_loc, n_loc, d_)
    ec_ops, ec_bytes = ec_c.ops, int(ec_c.nbytes)
    ec_b_ops, ec_b_bytes = ec_c.ops_ms, ec_c.bytes_ms
    print(f"[11d] pairwise_sqdist ({q_}x{p_}x{d_}): {sq_ms:.3f} ms median; "
          f"bound {max(sq_b_ops, sq_b_bytes):.3f} ms (operations: "
          f"{sq_ops:.4g} fp32 flops = {sq_b_ops:.3f} ms; bytes {sq_bytes} = "
          f"{sq_b_bytes:.3f} ms); {sq_ops / sq_ms / 1e9:.2f} TFLOP/s; plain "
          f"version {sq_plain_ms:.3f} ms (one call); torch.mm product only "
          f"{sq_lib_ms:.3f} ms; launches {api_launches['pairwise_sqdist']}")
    print(f"[11d] pairwise_hamming ({hq}x{hp}x{HW} words): {hw_ms:.3f} ms "
          f"median; bound {max(hw_b_ops, hw_b_bytes):.3f} ms (operations: "
          f"{hw_pops:.4g} popcounts at {popc_rate:.4g}/s = {hw_b_ops:.3f} "
          f"ms; bytes {hw_bytes} = {hw_b_bytes:.3f} ms); "
          f"{hw_pops / hw_ms / 1e9:.4g} Tpopc/s; plain version "
          f"{ham_plain_ms11:.3f} ms (rows of 512); torch.cdist(p=0) on the "
          f"bits as fp32 {hw_lib_ms:.3f} ms (rows of 1024); launches "
          f"{api_launches['pairwise_hamming']}")
    print(f"[11d] eps_count ({n_loc}x{n_loc}x{d_}): {ec_ms:.3f} ms median; "
          f"bound {max(ec_b_ops, ec_b_bytes):.3f} ms (operations: "
          f"{ec_ops:.4g} fp32 flops = {ec_b_ops:.3f} ms; bytes {ec_bytes} = "
          f"{ec_b_bytes:.3f} ms); {ec_ops / ec_ms / 1e9:.2f} TFLOP/s; plain "
          f"version {eps_plain_ms:.3f} ms (one call, rows of "
          f"{(1 << 28) // n_loc}); torch.mm product only {lib_ms:.3f} ms "
          f"([5], the same inputs); nng_tile {tile_ms:.3f} ms ([5]), "
          f"{ec_tile_ms:.3f} ms here (the better of two runs around "
          f"eps_count's); launches {api_launches['eps_count']}")
    del sx, ex, ey, HX, hx8, ones11
    torch.cuda.empty_cache()
    print(f"[11d] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 12. the front end and online maintenance ----------------------------
    t12 = time.perf_counter()
    from repro_torch.core.graph import _sorted_unique
    from repro_torch.core.metrics_host import HostEuclidean
    from repro_torch.launch import nng_run
    from repro_torch.stream import OnlineNNG
    print(f"[12] the front end (nng_run) and online maintenance (OnlineNNG); "
          f"script wall {t12 - t_start:.1f} s")

    # -- 12a. the CLI on the card, in process ---------------------------------
    for extra in (["--algo", "systolic"], ["--algo", "landmark"],
                  ["--algo", "systolic", "--updates", str(CLI_UPDATES),
                   "--update-batch", str(CLI_BATCH)]):
        argv = ["--n", str(CLI_N), "--dim", str(DIM), "--eps", repr(EPS),
                "--ranks", str(NRANKS), "--verify", *extra]
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                nng_run.main(argv)
        except SystemExit as e:
            raise SmokeFailure(f"[12a] nng_run {' '.join(argv)} exited "
                               f"{e.code}:\n{buf.getvalue()}") from None
        out = buf.getvalue()
        for line in out.splitlines():
            print(f"[12a]   {line}")
        print(f"[12a] python -m repro_torch.launch.nng_run {' '.join(argv)}: "
              f"{time.perf_counter() - t0:.3f} s")
        check("EXACT MATCH" in out or "EXACT up to fp32 boundary" in out,
              f"[12a] nng_run {' '.join(extra)} did not report an exact graph")

    # -- 12b. OnlineNNG at full width -----------------------------------------
    @contextlib.contextmanager
    def delta_spies(on):
        """While the body runs (and ``on``), keep the inputs of every
        tree_frontier, leaf_range_pack and bits_to_cols launch of the
        traversal glue: {"frontier": [(q, c, rad, leaf, act)], "pack":
        [(delta, leaf_ids, qids)], "cols": [(bits, ids_row, k)]}."""
        kept = {"frontier": [], "pack": [], "cols": []}
        if not on:
            yield kept
            return
        orig = (tdev.tree_frontier_step, tdev._leaf_range_pack,
                tdev._bits_to_gathered_ids)

        def step(*a, **kw):
            kept["frontier"].append(a[:5])
            return orig[0](*a, **kw)

        def pack(*a):
            kept["pack"].append(a)
            return orig[1](*a)

        def cols(*a):
            kept["cols"].append(a)
            return orig[2](*a)

        (tdev.tree_frontier_step, tdev._leaf_range_pack,
         tdev._bits_to_gathered_ids) = step, pack, cols
        try:
            yield kept
        finally:
            (tdev.tree_frontier_step, tdev._leaf_range_pack,
             tdev._bits_to_gathered_ids) = orig

    print(f"[12b] depth cut: OnlineNNG on the first {ON_N} rows of [3]'s "
          f"points, not {N}: it builds its per-rank forests on the host in "
          f"float64 (build_covertree), as the reference does, seconds per "
          f"{ON_N // NRANKS}-point block at d = {DIM} (timed below), so the "
          f"full set would take minutes; then {ON_OPS} operations of "
          f"{ON_B} points, every third deleting {ON_B} random live ids")
    delta_kernels = (tree_frontier_cuda, leaf_range_pack_cuda,
                     bits_to_cols_cuda)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o_dev = OnlineNNG(pts[:ON_N], EPS, mesh=mesh, k_cap=K_CAP,
                      insert_backend="device", seed=SEED)
    torch.cuda.synchronize()
    L_, W_ = (int(v) for v in o_dev._stacked["cell"].shape[1:])
    print(f"[12b] OnlineNNG(n={ON_N}, eps={EPS}, nranks={NRANKS}, "
          f"insert_backend='device') {time.perf_counter() - t0:.3f} s "
          f"(build_nng elapsed_s {o_dev.stats.elapsed_s:.3f}, the rest the "
          f"host forests): {o_dev.graph.num_edges} edges; forests {L_} "
          f"levels x {W_} slots a rank")
    t0 = time.perf_counter()
    o_host = copy.deepcopy(o_dev, {id(o_dev.metric): o_dev.metric,
                                   id(mesh): mesh})
    o_host.insert_backend = "host"
    o_host.graph.meta["online"]["insert_backend"] = "host"
    print(f"[12b] insert_backend='host': a deep copy of that initial state "
          f"({time.perf_counter() - t0:.3f} s; one forest build serves both)")

    def online_run(backend, o):
        """The schedule on one insert backend -> (the first insert's
        dists_evaluated, the kernel inputs of the last insert)."""
        restack, merged = [], []
        if backend == "host":
            orig = o._restack

            def timed_restack():
                torch.cuda.synchronize()
                t = time.perf_counter()
                orig()
                torch.cuda.synchronize()
                restack.append(time.perf_counter() - t)
            o._restack = timed_restack
        orig_m = o.graph._merged

        def timed_merged():
            t = time.perf_counter()
            out_ = orig_m()
            merged.append(time.perf_counter() - t)
            return out_
        o.graph._merged = timed_merged
        rng12 = np.random.default_rng(SEED + 12)
        cursor, first, kept = ON_N, None, None
        ins_s = ins_n = 0
        last_insert = max(s_ for s_ in range(ON_OPS) if s_ % 3 != 2)
        for step in range(ON_OPS):
            for fn in delta_kernels:
                fn.launches = 0
            u0, m0, r0 = o.stats.update_s, len(merged), len(restack)
            if step % 3 == 2:
                o.delete(rng12.choice(np.flatnonzero(o.live), ON_B,
                                      replace=False))
                kind, st = "delete", None
            else:
                with delta_spies(backend == "device"
                                 and step == last_insert) as k_:
                    o.insert(pts[cursor:cursor + ON_B])
                cursor += ON_B
                kind, st = "insert", o.last_update_stats
                if step == last_insert:
                    kept = k_
            torch.cuda.synchronize()
            lc = [fn.launches for fn in delta_kernels]
            upd = o.stats.update_s - u0
            line = (f"[12b] {backend} [{step}] {kind}: update_s {upd:.4f}, "
                    f"live {o.num_live}, delta_edges {o.graph.delta_edges}, "
                    f"compactions {o.graph.meta.get('compactions', 0)}, "
                    f"_merged {sum(merged[m0:]):.4f} s "
                    f"({len(merged) - m0} calls)")
            if st is not None:
                ins_s += upd
                ins_n += ON_B
                first = st.dists_evaluated if first is None else first
                line += (f"; delta elapsed_s {st.elapsed_s:.4f}, "
                         f"dists_evaluated {st.dists_evaluated:.0f}, "
                         f"nodes_pruned {st.nodes_pruned:.0f}, replans "
                         f"{st.replans}; launches tree_frontier {lc[0]}, "
                         f"leaf_range_pack {lc[1]}, bits_to_cols {lc[2]}")
                check(min(lc) > 0, f"[12b] {backend} insert {step}: a "
                                   f"kernel of the delta path did not run")
            if len(restack) > r0:
                line += f"; _restack {sum(restack[r0:]):.4f} s"
            print(line)
        del o.graph._merged
        print(f"[12b] {backend}: {ins_n / ins_s:.1f} inserts/s ({ins_n} "
              f"points in {ins_s:.3f} s of update_s); update_s total "
              f"{o.stats.update_s:.3f}, edges_added "
              f"{o.stats.edges_added:.0f}, edges_removed "
              f"{o.stats.edges_removed:.0f}; _merged {np.mean(merged):.4f} s "
              f"a call" + (f"; _restack {np.mean(restack):.4f} s a call"
                           if restack else ""))
        return first, kept

    online = {"device": o_dev, "host": o_host}
    del o_dev, o_host
    first_dev, kept12 = online_run("device", online["device"])
    first_host, _ = online_run("host", online["host"])
    # the merged view's dedup: numpy's hashing unique against one sort
    g12 = online["device"].graph
    rp12, col12 = g12._merged()
    keys12 = np.random.default_rng(SEED).permutation(
        np.repeat(np.arange(g12.n, dtype=np.int64), np.diff(rp12)) * g12.n
        + col12)
    t0 = time.perf_counter()
    u_np = np.unique(keys12)
    np_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    u_sort = _sorted_unique(keys12)
    sort_s = time.perf_counter() - t0
    check(np.array_equal(u_np, u_sort), "[12b] _sorted_unique != np.unique")
    print(f"[12b] the merged view's {len(keys12)} directed keys, shuffled: "
          f"np.unique {np_s:.4f} s, _sorted_unique (one sort) {sort_s:.4f} s "
          f"(numpy {np.__version__})")
    del keys12, u_np, u_sort
    g_full = build_nng(pts[:ON_N + ON_B], EPS, mesh=mesh, k_cap=K_CAP)
    full_d = g_full.stats.dists_evaluated
    print(f"[12b] a full build_nng rebuild on the first insert's corpus "
          f"({ON_N + ON_B} points): dists_evaluated {full_d:.6g}; the first "
          f"insert's {first_dev:.6g} (device), {first_host:.6g} (host): "
          f"{full_d / first_dev:.1f}x, {full_d / first_host:.1f}x fewer")
    check(10 * max(first_dev, first_host) <= full_d,
          "[12b] the first insert's delta traversal evaluated more than a "
          "tenth of a rebuild's distances")
    del g_full

    # -- 12c. exactness on the card ------------------------------------------
    rng12 = np.random.default_rng(SEED + 13)
    for backend, o in online.items():
        live = np.flatnonzero(o.live)
        gl = build_nng(o.points[live], EPS, mesh=mesh, k_cap=K_CAP)
        s_, d_ = np.divmod(gl.edge_key(), len(live))
        bkey = np.sort(live[s_] * o.graph.n + live[d_])
        key = o.graph.edge_key()
        i, j = np.divmod(np.setxor1d(key, bkey), o.graph.n)
        X = torch.from_numpy(o.points).to(dev)
        knife_check(f"[12c] {backend} merged view ({len(key)} edges) vs "
                    f"build_nng tiles on the {len(live)} live points "
                    f"({len(bkey)} edges)", X, X, torch.from_numpy(i).to(dev),
                    torch.from_numpy(j).to(dev), eps2)
        rows = np.sort(rng12.choice(live, 64, replace=False))
        XL = X[torch.from_numpy(live).to(dev)].double()
        d2 = torch.cdist(X[torch.from_numpy(rows).to(dev)].double(),
                         XL) ** 2
        slack = HostEuclidean().band_slack(o.points[rows], o.points[live],
                                           EPS ** 2)
        truth = (d2 <= EPS ** 2).cpu().numpy()
        differ = band = 0
        for r, row in enumerate(rows):
            t_ = set(live[truth[r]].tolist()) - {int(row)}
            g_ = set(o.graph.neighbors(int(row)).tolist())
            off = np.searchsorted(live, np.array(sorted(t_ ^ g_), np.int64))
            differ += len(off)
            band += int(((d2[r, torch.from_numpy(off).to(dev)] - EPS ** 2)
                         .abs() <= slack).sum()) if len(off) else 0
        print(f"[12c] {backend}: 64 sampled live rows vs float64 over the "
              f"{len(live)} live points: {differ} pairs differ, {band} of "
              f"them inside HostEuclidean.band_slack ({slack:.4g})")
        check(differ == band, f"[12c] {backend}: a sampled pair differs "
                              "from float64 outside the fp32 band")
        o.compact()
        check(np.array_equal(o.graph.edge_key(), key) and
              not o.graph.has_delta,
              f"[12c] {backend}: compact() moved the merged view")
        print(f"[12c] {backend}: compact() leaves edge_key() unchanged "
              f"({o.graph.meta['compactions']} compactions)")
    del online, X, XL, d2

    # -- 12d. the delta path's kernels against their plain versions ----------
    fr_n = fr_diff = fr_out = 0
    act_pairs = 0
    for q, c, rad, leaf, act in kept12["frontier"]:
        _, i, j, thr = frontier_diff(q, c, rad, leaf, act)
        n_, outside, _, _, _ = knife_far(q, c, i, j, thr)
        fr_n += 1
        fr_diff += n_
        fr_out += outside
        act_pairs += int(tdev._popcount(act))
    print(f"[12d] tree_frontier at the last device insert's {fr_n} launches "
          f"({kept12['frontier'][0][0].shape[0]} query rows, "
          f"{act_pairs} active pairs, all-ones cell words): {fr_diff} "
          f"(row, node) pairs differ from the plain version, {fr_out} off "
          f"the knife")
    check(fr_n > 0 and fr_out == 0, "[12d] tree_frontier differs from its "
                                    "plain version off the knife")
    holes = 0
    for delta, lid, qids in kept12["pack"]:
        nl = lid.shape[0]
        holes += int((lid == SENTINEL).sum())
        c1, b1 = leaf_range_pack_cuda(delta, lid, qids)
        c0, b0 = leaf_range_pack_ref(delta[:, :nl], lid, qids)
        check(torch.equal(c1, c0) and torch.equal(b1, b0),
              "[12d] leaf_range_pack differs from its plain version")
    print(f"[12d] leaf_range_pack at its {len(kept12['pack'])} launches "
          f"(leaf tables with {holes} SENTINEL slots in all: tombstones "
          f"and padding): bit-identical")
    for bits, _, k in kept12["cols"]:
        check(torch.equal(bits_to_cols_cuda(bits, k), bits_to_cols_ref(bits, k)),
              "[12d] bits_to_cols differs from its plain version")
    print(f"[12d] bits_to_cols at its {len(kept12['cols'])} launches: "
          f"bit-identical")
    del kept12
    torch.cuda.empty_cache()
    print(f"[12] {time.perf_counter() - t12:.1f} s (budget {PHASE12_S} s); "
          f"script wall {time.perf_counter() - t_start:.1f} s")

    # -- 13. the engines over torch.distributed -----------------------------
    t13 = time.perf_counter()
    import hashlib
    import socket

    import torch.distributed as tdist

    from repro_torch.core.distributed import RingMesh
    from repro_torch.launch.dist import init, spawn
    print(f"[13] one process per GPU over torch.distributed; script wall "
          f"{t13 - t_start:.1f} s")

    def edge_sha(g_):
        return hashlib.sha256(g_.edge_key().tobytes()).hexdigest()

    def same_graph(label, g_, ref):
        """Fail unless call ``label``'s graph, counters, comm_bytes and plan
        are ``ref``'s."""
        got = (edge_sha(g_), stats_line(g_), g_.meta["plan"])
        want = (edge_sha(ref), stats_line(ref), ref.meta["plan"])
        print(f"{label} edge-key sha256 {got[0]} ({want[0]} before); "
              f"{got[1]}")
        check(got == want, f"{label} differs from the one-process call: "
                           f"{got} against {want}")
        check(np.array_equal(g_.row_ptr, ref.row_ptr)
              and np.array_equal(g_.col_ids, ref.col_ids),
              f"{label}: the CSR differs")

    # -- 13a. NCCL, a group of one process holding the 8 ranks ---------------
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port13 = s_.getsockname()[1]
    env13 = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
             "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port13)}
    os.environ.update(env13)
    try:
        init("nccl")
        mesh13 = make_nng_mesh(NRANKS)
        check((mesh13.size, mesh13.world, mesh13.backend)
              == (NRANKS, 1, "nccl"), f"[13a] mesh {mesh13}")
        for label, kw, ref, need in (
                ("[13a] point tiles", {"k_cap": K_CAP}, g,
                 ("nng_tile", "bits_to_cols")),
                ("[13a] spatial coll", {"k_cap": SP_K_CAP,
                                        "partition": "spatial"}, coll9,
                 ("nng_tile_grouped", "bits_to_cols"))):
            for fn in KERNELS:
                fn.launches = 0
            t0 = time.perf_counter()
            g13 = build_nng(pts, EPS, mesh=mesh13, **kw)
            wall13 = time.perf_counter() - t0
            launches13 = {fn.__name__[:-5]: fn.launches for fn in KERNELS
                          if fn.launches}
            print(f"{label}: build_nng on {mesh13.size} ranks of a "
                  f"{mesh13.backend} group of {mesh13.world} process on "
                  f"{mesh13.device}: elapsed_s {g13.stats.elapsed_s:.3f} "
                  f"beside the one-process call's {ref.stats.elapsed_s:.3f}; "
                  f"call wall {wall13:.3f} s; launches "
                  f"{json.dumps(launches13)}")
            check(all(launches13.get(k, 0) > 0 for k in need),
                  f"{label}: a kernel of the path never launched: "
                  f"{launches13}")
            same_graph(label, g13, ref)
            del g13
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        for k in env13:
            os.environ.pop(k, None)
    del coll9
    torch.cuda.empty_cache()
    print(f"[13a] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 13b. 4 gloo processes on this card, 2 ranks each ---------------------
    pts13, batch13 = pts[:DIST_N], pts[DIST_N:DIST_N + DIST_B]
    t0 = time.perf_counter()
    kids = spawn(dist_process, DIST_PROCS, backend="gloo", device="cuda",
                 args=(pts13, batch13, EPS, SP_K_CAP, NRANKS), timeout=600)
    spawn_s = time.perf_counter() - t0
    for r, kid in enumerate(kids):
        check(kid["mesh"] == (NRANKS, DIST_PROCS, r, "gloo", "cuda:0"),
              f"[13b] process {r}'s mesh {kid['mesh']}")
    t0 = time.perf_counter()
    want13 = dist_cases(RingMesh(NRANKS, dev), pts13, batch13, EPS,
                        SP_K_CAP)
    print(f"[13b] {DIST_PROCS} gloo processes x {NRANKS // DIST_PROCS} "
          f"ranks on {dev} (gloo moves the payloads through host memory, "
          f"not NCCL), n={DIST_N}, eps={EPS}, k_cap={SP_K_CAP}: the "
          f"processes took {spawn_s:.1f} s from start to exit; the same "
          f"calls on RingMesh({NRANKS}) in this process "
          f"{time.perf_counter() - t0:.1f} s")
    for label, want in want13.items():
        for r, kid in enumerate(kids):
            got = kid[label]
            differ = [(k, got[k], want[k]) for k in (
                "sha", "edges", "counters", "comm_bytes", "meta")
                if got[k] != want[k]]
            check(not differ, f"[13b] {label}: process {r} differs from "
                              f"RingMesh({NRANKS}): {differ}")
        runs = want["counters"]["replans"] + (1 if label == "delta" else 2)
        model = {k: runs * v for k, v in want["comm_bytes"].items() if v}
        moved = {}
        for kid in kids:
            for k, v in kid[label]["moved"].items():
                moved[k] = moved.get(k, 0) + v
        check(moved == model and want["moved"] == model,
              f"[13b] {label}: bytes moved {moved} (processes), "
              f"{want['moved']} (RingMesh) against comm_bytes x {runs} "
              f"runs {model}")
        launches_b = {}
        for kid in kids:
            for k, v in kid[label]["launches"].items():
                launches_b[k] = launches_b.get(k, 0) + v
        check(launches_b == want["launches"],
              f"[13b] {label}: launches {launches_b} in the processes, "
              f"{want['launches']} in RingMesh({NRANKS})")
        staging = ", ".join(f"{k_[label]['staging_s']:.3f}" for k_ in kids)
        sent, secs = {}, {}
        for kid in kids:
            for k, v in kid[label]["sent"].items():
                sent[k] = sent.get(k, 0) + v
            for k, v in kid[label]["seconds"].items():
                secs[k] = max(secs.get(k, 0.0), v)
        print(f"[13b] {label}: {want['edges']} edges (sha256 "
              f"{want['sha'][:16]}), counters and comm_bytes "
              f"{json.dumps(want['comm_bytes'])} equal on every process; "
              f"elapsed_s {max(k_[label]['elapsed_s'] for k_ in kids):.3f} "
              f"(the slowest process; gloo through host memory) against "
              f"RingMesh's {want['elapsed_s']:.3f}; call wall "
              f"{max(k_[label]['wall'] for k_ in kids):.3f} s; host staging "
              f"{staging} s by process; launches {json.dumps(launches_b)}")
        print(f"[13b] {label}: bytes between processes by channel "
              f"{json.dumps(sent)}; host seconds in the exchanges by "
              f"channel (the slowest process) "
              f"{json.dumps({k: round(v, 4) for k, v in secs.items()})}")
    del kids, want13
    torch.cuda.empty_cache()
    print(f"[13b] script wall {time.perf_counter() - t_start:.1f} s")

    # -- 13c. NCCL across cards -----------------------------------------------
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[13c] not run: this machine has {n_cards} card; NCCL across "
              f"cards (the multi-card ring) is unverified")
    else:
        world13 = min(n_cards, NRANKS)
        nranks13 = world13 * (NRANKS // world13)
        kids = spawn(dist_process, world13, backend="nccl",
                     args=(pts13, batch13, EPS, SP_K_CAP, nranks13),
                     timeout=600)
        want13 = dist_cases(RingMesh(nranks13, dev), pts13, batch13, EPS,
                            SP_K_CAP)
        for label, want in want13.items():
            for r, kid in enumerate(kids):
                check(all(kid[label][k] == want[k] for k in (
                    "sha", "edges", "counters", "comm_bytes", "meta")),
                    f"[13c] {label}: process {r} differs from RingMesh")
            print(f"[13c] {label}: {world13} NCCL processes, {nranks13} "
                  f"ranks: equal to RingMesh({nranks13}); elapsed_s "
                  f"{max(k_[label]['elapsed_s'] for k_ in kids):.3f} against "
                  f"{want['elapsed_s']:.3f}")
        del kids, want13
    print(f"[13] {time.perf_counter() - t13:.1f} s (budget {PHASE13_S} s); "
          f"script wall {time.perf_counter() - t_start:.1f} s")

    # -- 13d. OnlineNNG over the processes of [13b] ----------------------------
    # the processes run while this process runs the same schedule on
    # RingMesh(8): the host forests (float64, one rank after another here)
    # take most of either side's time, and the two overlap on the host's
    # cores; the times each side prints include that sharing
    import threading
    t13d = time.perf_counter()
    pool13 = pts[DIST_N:DIST_N + ON13_OPS * DIST_B]
    spawned13d = {}

    def run_kids():
        try:
            spawned13d["kids"] = spawn(
                online_process, DIST_PROCS, backend="gloo", device="cuda",
                args=(pts13, pool13, EPS, SP_K_CAP, NRANKS, ON13_OPS, DIST_B,
                      SEED), timeout=600)
        except Exception as e:  # noqa: BLE001 — raised below
            spawned13d["error"] = e
        spawned13d["s"] = time.perf_counter() - t13d

    kid_thread = threading.Thread(target=run_kids)
    kid_thread.start()
    want13d = online_both(RingMesh(NRANKS, dev), pts13, pool13, EPS,
                          SP_K_CAP, ON13_OPS, DIST_B, SEED)
    want_s = time.perf_counter() - t13d
    kid_thread.join()
    if "error" in spawned13d:
        raise spawned13d["error"]
    kids = spawned13d["kids"]
    for r, kid in enumerate(kids):
        check(kid["mesh"] == (NRANKS, DIST_PROCS, r, "gloo", "cuda:0"),
              f"[13d] process {r}'s mesh {kid['mesh']}")
    print(f"[13d] OnlineNNG on {DIST_PROCS} gloo processes x "
          f"{NRANKS // DIST_PROCS} ranks on {dev}, n={DIST_N}, eps={EPS}, "
          f"k_cap={SP_K_CAP}, {ON13_OPS} operations of {DIST_B} points "
          f"(every third a delete), insert backends device and host (a deep "
          f"copy of the device one's initial state): the processes took "
          f"{spawned13d['s']:.1f} s from start to exit (OnlineNNG(...) "
          f"{max(k_['init_s'] for k_ in kids):.1f} s in the slowest), the "
          f"same schedule on RingMesh({NRANKS}) in this process at the same "
          f"time {want_s:.1f} s (OnlineNNG(...) {want13d['init_s']:.1f} s)")
    for backend in ("device", "host"):
        for i, want in enumerate(want13d[backend]):
            for r, kid in enumerate(kids):
                got = kid[backend][i]
                differ = [(k, got[k], want[k]) for k in ONLINE_SHARED
                          if got[k] != want[k]]
                check(not differ, f"[13d] {backend} [{i}] {want['kind']}: "
                                  f"process {r} differs from "
                                  f"RingMesh({NRANKS}): {differ}")
            moved, launches13d = {}, {}
            for kid in kids:
                for k, v in kid[backend][i]["moved"].items():
                    moved[k] = moved.get(k, 0) + v
                for k, v in kid[backend][i]["launches"].items():
                    launches13d[k] = launches13d.get(k, 0) + v
            d = want["delta"]
            model = ({} if d is None else {
                k: v * (d["replans"] + 1)
                for k, v in d["comm_bytes"].items() if v})
            check(moved == model and want["moved"] == model,
                  f"[13d] {backend} [{i}]: bytes moved {moved} (processes), "
                  f"{want['moved']} (RingMesh) against the model {model}")
            check(launches13d == want["launches"],
                  f"[13d] {backend} [{i}]: launches {launches13d} in the "
                  f"processes, {want['launches']} in RingMesh({NRANKS})")
            if d is not None:
                check(min(launches13d.values()) > 0,
                      f"[13d] {backend} [{i}]: a kernel of the delta path "
                      f"did not run: {launches13d}")
            ups = [k_[backend][i]["update_s"] for k_ in kids]
            stg = [k_[backend][i]["staging_s"] for k_ in kids]
            print(f"[13d] {backend} [{i}] {want['kind']}: "
                  f"{want['num_edges']} edges, delta log, ids, live, "
                  f"counters and comm_bytes equal on every process; "
                  f"update_s {max(ups):.4f} (the slowest process) against "
                  f"RingMesh's {want['update_s']:.4f}"
                  + ("" if d is None else
                     f"; delta elapsed_s "
                     f"{max(k_[backend][i]['elapsed_s'] for k_ in kids):.4f}"
                     f" against {want['elapsed_s']:.4f}, dists_evaluated "
                     f"{d['dists_evaluated']:.0f}, delta_bcast "
                     f"{d['comm_bytes']['delta_bcast']:.0f} bytes a run "
                     f"({moved.get('delta_bcast', 0)} moved)")
                  + f"; host staging {', '.join(f'{x:.4f}' for x in stg)} s "
                  f"by process; launches {json.dumps(launches13d)}")
    del kids, want13d
    torch.cuda.empty_cache()
    t13d_s = time.perf_counter() - t13d
    print(f"[13d] {t13d_s:.1f} s; script wall "
          f"{time.perf_counter() - t_start:.1f} s")

    # -- 14. the analyzer on the card ------------------------------------------
    from repro_torch.analysis.report import run_analysis
    t14 = time.perf_counter()
    ALL_KERNELS = KERNELS + (pairwise_sqdist_cuda, pairwise_hamming_cuda,
                             eps_count_cuda)
    for fn in ALL_KERNELS:
        fn.launches = 0
    report14 = run_analysis(device="cuda")
    launches14 = {fn.__name__[:-5]: fn.launches for fn in ALL_KERNELS}
    print(f"[14] run_analysis(device='cuda') {time.perf_counter() - t14:.1f} "
          f"s: {len(report14['contracts']['checked'])} kernel contracts "
          f"(each kernel launched at its probe shapes against its oracle, "
          f"its wrapper's threshold, host reads and float64 checked), "
          f"{len(report14['traffic'])} audit configurations on "
          f"RingMesh({NRANKS}, 'cuda'); {len(report14['diagnostics'])} "
          f"diagnostic(s), {len(report14['fresh'])} fresh, "
          f"{len(report14['baselined'])} baselined; launches "
          f"{json.dumps(launches14)}")
    for d in report14["diagnostics"]:
        print(f"[14]   {d['code']} [{d['subject']}] {d['message']}")
    check(report14["ok"], f"[14] fresh diagnostics: {report14['fresh']}")
    check(len(report14["contracts"]["checked"]) == 17
          and all(v > 0 for v in launches14.values()),
          f"[14] a kernel did not launch: {launches14}")
    for subject, row in report14["traffic"].items():
        print(f"[14] audit {subject}: {row['runs']} engine runs, moved "
              f"{json.dumps(row['moved'])}, comm_bytes "
              f"{json.dumps(row['comm_bytes'])}")
    print("[14] the H100 cost model at PERF.md section 6's shapes (every "
          "pair and word counted where the work depends on the data):")
    for row in report14["kernel_costs"]:
        print(f"[14]   #{row['row']} {row['kernel']} {row['shape']}: bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}; operations "
              f"{row['ops']:.4g} = {row['ops_ms']:.3f} ms, bytes "
              f"{row['nbytes']:.4g} = {row['bytes_ms']:.3f} ms)")
    del report14
    torch.cuda.empty_cache()
    t14_s = time.perf_counter() - t14
    print(f"[13d]+[14] {t13d_s + t14_s:.1f} s (budget {PHASE13D_14_S} s); "
          f"script wall {time.perf_counter() - t_start:.1f} s")

    # -- 15. the paper-table modules beside the engines on the card ----------
    from repro_torch.core.host_algos import landmark_host, systolic_ring_host
    from repro_torch.core.snn import snn_graph
    t15 = time.perf_counter()
    print(f"[15] host times below are this machine's CPU "
          f"({os.cpu_count()} cores, numpy float64); card times are the "
          f"card's ({smi})")
    # L2 eps: of the 256 widest gaps between consecutive float64 pair d² at
    # a mean degree in P15_DEG, the one that the fewest pairs straddle with
    # their fp32 d² on the card (the L2 cores' d², bit for bit
    # pairwise_sqdist's): those pairs, and only those, may differ between
    # the host's float64 graphs and the card's
    pts15 = synthetic_pointset(P15_N, P15_DIM, seed=SEED)
    x15 = torch.as_tensor(pts15, device=dev)
    x64 = x15.double()
    nrm64 = (x64 * x64).sum(1)
    D64 = nrm64[:, None] + nrm64[None, :] - 2.0 * (x64 @ x64.T)
    D32 = tk.pairwise_sqdist(x15, x15)
    upper = torch.ones(P15_N, P15_N, dtype=torch.bool, device=dev).triu(1)
    v64, order15 = torch.sort(D64[upper])
    v32 = D32[upper][order15]
    knife15 = KNIFE_ULPS * U32 * 2 * float(nrm64.mean())
    del x64, nrm64, order15
    lo15, hi15 = (deg * P15_N // 2 for deg in P15_DEG)
    gaps15 = v64[lo15 + 1:hi15 + 1] - v64[lo15:hi15]
    best15 = None
    for k in torch.topk(gaps15, 256).indices.tolist():
        e = float(torch.sqrt((v64[lo15 + k] + v64[lo15 + k + 1]) / 2))
        split = int(((v64 <= e * e) != (v32 <= eps2_f32(e))).sum())
        if best15 is None or split < best15[0]:
            best15 = (split, e, float(gaps15[k]))
        if split == 0:
            break
    split15, eps15, gap15 = best15
    e15 = int((v64 <= eps15 * eps15).sum())
    si15, sj15 = (((D64 <= eps15 * eps15) != (D32 <= eps2_f32(eps15)))
                  & upper).nonzero(as_tuple=True)
    print(f"[15] L2 points synthetic_pointset({P15_N}, {P15_DIM}, "
          f"seed={SEED}); eps {eps15!r} in a float64 gap of d² width "
          f"{gap15:.6g} ({gap15 / eps15 ** 2:.3g} of eps²; the knife "
          f"{KNIFE_ULPS} fp32 units of ‖x‖²+‖y‖² is "
          f"{knife15:.3g} at the mean ‖x‖²); "
          f"{split15} pairs' fp32 d² on the card across it; {e15} edges, "
          f"mean degree {2 * e15 / P15_N:.4f}")
    knife_check("[15] the pairs across eps", x15, x15, si15, sj15,
                eps2_f32(eps15))
    key15 = torch.sort(si15 * P15_N + sj15).values
    del D64, D32, upper, v64, v32, gaps15, si15, sj15
    # Hamming eps: the integer whose mean degree lies nearest the paper's 70
    ham15 = synthetic_pointset(P15_HAM_N, P15_HAM_W, "hamming", seed=SEED)
    hw15 = torch.as_tensor(ham15.view(np.int32), device=dev)
    hd = tk.pairwise_hamming(hw15, hw15)
    hd = hd[torch.ones_like(hd, dtype=torch.bool).triu(1)].long()
    hdeg = 2.0 * torch.bincount(hd).cumsum(0).double().cpu() / P15_HAM_N
    heps15 = int((hdeg - 70.0).abs().argmin())
    print(f"[15] Hamming points synthetic_pointset({P15_HAM_N}, {P15_HAM_W}, "
          f"'hamming', seed={SEED}); eps {heps15}, mean degree "
          f"{float(hdeg[heps15]):.4f} (degrees by eps from 40: "
          f"{[round(float(v), 2) for v in hdeg[40:48]]})")
    del hd, hw15, hdeg

    def card_call(label, pts_, eps_, **kw):
        for fn in KERNELS:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_ = build_nng(pts_, eps_, mesh=mesh, **kw)
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        launched = {fn.__name__[:-5]: fn.launches for fn in KERNELS
                    if fn.launches}
        print(f"[15] card {label}: build_nng {json.dumps(kw)} on "
              f"{mesh.size} ranks: call wall {wall_:.3f} s, elapsed_s "
              f"{g_.stats.elapsed_s:.3f} s, {g_.num_edges} edges; "
              f"comm_bytes {json.dumps(g_.stats.comm_bytes)}; launches "
              f"{json.dumps(launched)}")
        return g_, wall_, launched

    def phases(st):
        return (f"partition_s {st.partition_s:.3f} tree_s {st.tree_s:.3f} "
                f"ghost_s {st.ghost_s:.3f} total_s {st.total_s:.3f} "
                f"makespan_s {st.makespan_s:.3f}; tiles "
                f"{st.tiles_scheduled:.0f} scheduled {st.tiles_skipped:.0f} "
                f"skipped, dists_evaluated {st.dists_evaluated:.6g}, "
                f"nodes_pruned {st.nodes_pruned:.6g}; comm_bytes "
                f"{json.dumps(st.comm_bytes)}")

    for metric, pts_, eps_, tile_k, grp_k in (
            ("euclidean", pts15, eps15, "nng_tile", "nng_tile_grouped"),
            ("hamming", ham15, heps15, "nng_tile_hamming",
             "nng_tile_grouped_hamming")):
        point15, wall_p, l_p = card_call(f"{metric} point", pts_, eps_,
                                         metric=metric)
        spatial15, wall_s, l_s = card_call(f"{metric} spatial", pts_, eps_,
                                           metric=metric,
                                           partition="spatial")
        check(l_p.get(tile_k, 0) > 0 and l_s.get(grp_k, 0) > 0,
              f"[15] {metric}: a kernel of the path never launched: "
              f"{l_p} {l_s}")
        check(point15 == spatial15, f"[15] {metric}: the card's point and "
                                    f"spatial graphs differ")
        host15 = None
        calls = [("systolic_ring_host", lambda: systolic_ring_host(
                     pts_, eps_, NRANKS, metric=metric)),
                 ("landmark_host coll random", lambda: landmark_host(
                     pts_, eps_, NRANKS, ghost_mode="coll", metric=metric)),
                 ("landmark_host ring greedy", lambda: landmark_host(
                     pts_, eps_, NRANKS, ghost_mode="ring", metric=metric,
                     center_strategy="greedy"))]
        if metric == "euclidean":
            calls.insert(0, ("snn_graph", lambda: (snn_graph(pts_, eps_),
                                                   None)))
        for label, fn in calls:
            t0 = time.perf_counter()
            hg, hst = fn()
            secs = time.perf_counter() - t0
            line = f"[15] host {metric} {label}: {secs:.3f} s"
            if hst is not None:
                line += f"; {phases(hst)}"
            print(line)
            if label == "snn_graph":
                el_p = point15.stats.elapsed_s
                el_s = spatial15.stats.elapsed_s
                print(f"[15] build_nng over snn_graph: point "
                      f"{secs / wall_p:.2f}x, spatial {secs / wall_s:.2f}x "
                      f"(call walls; over elapsed_s {secs / el_p:.2f}x, "
                      f"{secs / el_s:.2f}x)")
            if label == "systolic_ring_host":
                print(f"[15] {metric} ring bytes: host "
                      f"{hst.comm_bytes['ring']} (the blocks' rotation), "
                      f"the card's point call "
                      f"{json.dumps(point15.stats.comm_bytes)}")
            if host15 is None:
                host15 = hg
                i, j, (n_c, n_h) = edge_diff(point15, hg, len(pts_))
                print(f"[15] {metric}: the card's graph {point15.num_edges} "
                      f"edges, the host's {hg.num_edges}: {n_c} only on the "
                      f"card, {n_h} only on the host")
                want = key15 if metric == "euclidean" else key15[:0]
                check(torch.equal(torch.sort(i * len(pts_) + j).values,
                                  want),
                      f"[15] {metric}: the host and card graphs differ "
                      f"elsewhere than at the pairs across eps")
            check(hg == host15, f"[15] {metric} {label}: the host graph "
                                f"differs from the first host call's")
        del point15, spatial15, host15
    torch.cuda.empty_cache()
    t15_s = time.perf_counter() - t15
    print(f"[15] {t15_s:.1f} s (budget {PHASE15_S} s); script wall "
          f"{time.perf_counter() - t_start:.1f} s")

    # -- 16. the production dry run ------------------------------------------
    import tempfile

    from repro_torch.launch.dryrun import (ALGOS, LAYOUTS, MEASURE_EPS,
                                           cell_n, measure_many, run_nng_cell)
    from repro_torch.roofline.report import nng_table
    t16 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out16:
        cells16 = [run_nng_cell(c, m, out16) for c in NNG_CONFIGS
                   for m in LAYOUTS]
    check(all(c["status"] == "OK" for c in cells16),
          f"[16] a dry-run cell failed: {[c.get('error') for c in cells16]}")
    print(f"[16] the dry run's model ({len(cells16)} cells, no device; "
          f"compute at fp32 67 TFLOP/s and popcounts at "
          f"{kcost.POPC_RATE:.4g}/s, HBM at 3.35 TB/s, the ring at NVLink's "
          f"450 GB/s a direction within a node and the network's 50 GB/s "
          f"between nodes):")
    print(nng_table(cells16))
    for c in cells16:
        for algo in ALGOS:
            mem = c[algo]["memory"]
            print(f"[16] {c['arch']} {c['mesh']} ({c['chips']} ranks, n "
                  f"{c['n']}) {algo}: a rank's argument "
                  f"{mem['argument_size_bytes']} output "
                  f"{mem['output_size_bytes']} temp {mem['temp_size_bytes']} "
                  f"B (peak phase {mem['peak_phase']}); collective bytes "
                  f"{json.dumps(c[algo]['roofline']['coll_bytes'])}; "
                  f"launches {json.dumps(c[algo]['launches'])}")
    jobs16 = [(c, "pod1", a) for c in NNG_CONFIGS for a in ALGOS]
    meas16 = measure_many(jobs16)
    for r in meas16:
        ratio = r["model_bytes"] / r["measured_bytes"]
        print(f"[16] {r['name']} {r['algo']} at pod1's {r['n_loc']} points "
              f"a rank, {r['ranks']} gloo processes on this card: eps "
              f"{r['eps']} (mean degree {r['mean_degree']:.4f}, max "
              f"{r['max_cnt']}, overflow {r['overflow']}); peak device "
              f"memory measured {r['measured_bytes']} B (per process "
              f"{r['peak_bytes']}), modelled {r['model_bytes']} B "
              f"(argument {r['model']['argument_size_bytes']}, output "
              f"{r['model']['output_size_bytes']}, temp "
              f"{r['model']['temp_size_bytes']}; peak phase "
              f"{r['model']['peak_phase']}): model / measured "
              f"{ratio:.4f}; launches {json.dumps(r['launches'])} against "
              f"the model's {json.dumps(r['model_launches'])}; "
              f"{r['seconds']:.2f} s")
        check(r["measured_bytes"] <= r["model_bytes"]
              <= MEM_SLACK * r["measured_bytes"],
              f"[16] {r['name']} {r['algo']}: modelled {r['model_bytes']} B "
              f"against {r['measured_bytes']} B measured (want measured <= "
              f"model <= {MEM_SLACK} x measured)")
        check(r["launches"] == r["model_launches"],
              f"[16] {r['name']} {r['algo']}: launches {r['launches']} "
              f"against the model's {r['model_launches']}")
    print(f"[16] the {len(meas16)} runs took {meas16[0]['spawn_wall_s']:.1f} s "
          f"(the processes' start included); MEASURE_EPS {MEASURE_EPS}")
    for c16 in NNG_CONFIGS.values():
        if c16.metric != "euclidean":
            continue
        n16 = cell_n(c16.name, LAYOUTS["pod1"].ranks) // LAYOUTS["pod1"].ranks
        x16 = torch.as_tensor(synthetic_pointset(n16, c16.dim, seed=SEED),
                              device=dev)
        ones16 = torch.ones(n16, dtype=torch.int32, device=dev)
        ms16 = cuda_ms(torch, lambda: nng_tile_cuda(x16, x16, ones16,
                                                    MEASURE_EPS[c16.name]),
                       5)
        b16 = kcost.tile_cost("euclidean", n16, n16, c16.dim)
        print(f"[16] nng_tile at {c16.name}'s {n16} points a rank "
              f"({n16}x{n16}x{c16.dim}): {ms16:.4f} ms median of 5; the "
              f"model's bound {b16.bound_ms:.4f} ms ({b16.bound_by}: "
              f"compute {b16.ops_ms:.4f} ms, bytes {b16.bytes_ms:.4f} ms), "
              f"{b16.bound_ms / ms16:.3f} of it")
        check(ms16 >= 0.95 * b16.bound_ms,
              f"[16] nng_tile ran in {ms16} ms, below 0.95 x its bound "
              f"{b16.bound_ms} ms: the cost model undercounts")
        del x16, ones16
    torch.cuda.empty_cache()
    t16_s = time.perf_counter() - t16
    print(f"[16] {t16_s:.1f} s (budget {PHASE16_S} s); script wall "
          f"{time.perf_counter() - t_start:.1f} s")

    record = {"kernels": [
        {"name": "nng_tile", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile.cu",
         "replaces": "src/repro/kernels/nng_tile.py:139",
         "launches": launches["nng_tile"], "max_abs_err": tile_err,
         "ms": tile_ms, "plain_ms": tile_plain_ms,
         "bound_ms": max(tile_bound_ops, tile_bound_bytes),
         "bound_by": ("operations" if tile_bound_ops >= tile_bound_bytes
                      else "bytes"),
         "library_ms": lib_ms},
        {"name": "bits_to_cols", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bits_to_cols.cu",
         "replaces": "src/repro/kernels/bits_epilogue.py:109",
         "launches": launches["bits_to_cols"], "max_abs_err": b2c_err,
         "ms": b2c_ms, "plain_ms": b2c_plain_ms, "bound_ms": b2c_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "tree_frontier", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/tree_frontier.cu",
         "replaces": "src/repro/kernels/tree_frontier.py:126",
         "launches": tree_launches["tree_frontier"],
         "max_abs_err": front_err, "ms": front_ms,
         "plain_ms": front_plain_ms, "bound_ms": front_bound_ms,
         "bound_by": front_by, "library_ms": front_lib_ms},
        {"name": "leaf_range_pack", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/leaf_range_pack.cu",
         "replaces": "src/repro/kernels/bits_epilogue.py:171",
         "launches": tree_launches["leaf_range_pack"],
         "max_abs_err": pack_err, "ms": pack_ms, "plain_ms": pack_plain_ms,
         "bound_ms": pack_bound_ms, "bound_by": "bytes", "library_ms": None},
        {"name": "nng_tile_hamming", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile_hamming.cu",
         "replaces": "src/repro/kernels/nng_tile.py:202",
         "launches": h_tiles_l["nng_tile_hamming"], "max_abs_err": ham_err,
         "ms": ham_ms, "plain_ms": ham_plain_ms,
         "bound_ms": max(ham_b_ops, ham_b_bytes),
         "bound_by": ("operations" if ham_b_ops >= ham_b_bytes
                      else "bytes"),
         "library_ms": ham_lib_ms},
        {"name": "nng_tile_l1", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile_l1.cu",
         "replaces": "src/repro/kernels/nng_tile.py:265",
         "launches": l_tiles_l["nng_tile_l1"], "max_abs_err": l1_err,
         "ms": l1_ms, "plain_ms": l1_plain_ms,
         "bound_ms": max(l1_b_ops, l1_b_bytes),
         "bound_by": ("operations" if l1_b_ops >= l1_b_bytes else "bytes"),
         "library_ms": l1_lib_ms},
        {"name": "tree_frontier_hamming", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/tree_frontier_hamming.cu",
         "replaces": "src/repro/kernels/tree_frontier.py:196",
         "launches": h_tree_l["tree_frontier_hamming"],
         "max_abs_err": ham_err, "ms": hf_ms, "plain_ms": hf_plain_ms,
         "bound_ms": hf_bound, "bound_by": hf_by, "library_ms": hf_lib_ms},
        {"name": "tree_frontier_l1", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/tree_frontier_l1.cu",
         "replaces": "src/repro/kernels/tree_frontier.py:264",
         "launches": l_tree_l["tree_frontier_l1"], "max_abs_err": l1_err,
         "ms": lf_ms, "plain_ms": lf_plain_ms, "bound_ms": lf_bound,
         "bound_by": lf_by, "library_ms": lf_lib_ms},
        {"name": "nng_tile_grouped", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile_grouped.cu",
         "replaces": "src/repro/kernels/nng_tile.py:376",
         "launches": sp_launches["nng_tile_grouped"],
         "max_abs_err": grp_err["euclidean"], "ms": grp_w[0],
         "plain_ms": w_plain_ms, "bound_ms": grp_w[1], "bound_by": grp_w[2],
         "library_ms": grp_w[3]},
        {"name": "nng_tile_grouped_hamming", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile_grouped_hamming.cu",
         "replaces": "src/repro/kernels/nng_tile.py:449",
         "launches": sh_launches["nng_tile_grouped_hamming"],
         "max_abs_err": grp_err["hamming"], "ms": grp_h[0],
         "plain_ms": hw_plain_ms, "bound_ms": grp_h[1], "bound_by": grp_h[2],
         "library_ms": grp_h[3]},
        {"name": "nng_tile_grouped_l1", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile_grouped_l1.cu",
         "replaces": "src/repro/kernels/nng_tile.py:522",
         "launches": sl_launches["nng_tile_grouped_l1"],
         "max_abs_err": grp_err["manhattan"], "ms": grp_l[0],
         "plain_ms": lw_plain_ms, "bound_ms": grp_l[1], "bound_by": grp_l[2],
         "library_ms": grp_l[3]},
        {"name": "nng_tile_ghost", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile_ghost.cu",
         "replaces": "src/repro/kernels/nng_tile.py:647",
         "launches": r_launches["nng_tile_ghost"],
         "max_abs_err": ghost_err["euclidean"], "ms": gt_l2[0],
         "plain_ms": gl2_plain_ms, "bound_ms": gt_l2[1],
         "bound_by": gt_l2[2], "library_ms": gt_l2[3]},
        {"name": "nng_tile_ghost_hamming", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile_ghost_hamming.cu",
         "replaces": "src/repro/kernels/nng_tile.py:719",
         "launches": rh_launches["nng_tile_ghost_hamming"],
         "max_abs_err": ghost_err["hamming"], "ms": gt_h[0],
         "plain_ms": gh_plain_ms, "bound_ms": gt_h[1], "bound_by": gt_h[2],
         "library_ms": gt_h[3]},
        {"name": "nng_tile_ghost_l1", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile_ghost_l1.cu",
         "replaces": "src/repro/kernels/nng_tile.py:789",
         "launches": rl_launches["nng_tile_ghost_l1"],
         "max_abs_err": ghost_err["manhattan"], "ms": gt_l1[0],
         "plain_ms": gl1_plain_ms, "bound_ms": gt_l1[1],
         "bound_by": gt_l1[2], "library_ms": gt_l1[3]},
        {"name": "pairwise_sqdist", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pairwise_sqdist.cu",
         "replaces": "src/repro/kernels/pairwise_l2.py:69",
         "launches": api_launches["pairwise_sqdist"], "max_abs_err": sq_err,
         "ms": sq_ms, "plain_ms": sq_plain_ms,
         "bound_ms": max(sq_b_ops, sq_b_bytes),
         "bound_by": "operations" if sq_b_ops >= sq_b_bytes else "bytes",
         "library_ms": sq_lib_ms},
        {"name": "pairwise_hamming", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pairwise_hamming.cu",
         "replaces": "src/repro/kernels/pairwise_hamming.py:55",
         "launches": api_launches["pairwise_hamming"], "max_abs_err": 0,
         "ms": hw_ms, "plain_ms": ham_plain_ms11,
         "bound_ms": max(hw_b_ops, hw_b_bytes),
         "bound_by": "operations" if hw_b_ops >= hw_b_bytes else "bytes",
         "library_ms": hw_lib_ms},
        {"name": "eps_count", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/eps_count.cu",
         "replaces": "src/repro/kernels/eps_count.py:62",
         "launches": api_launches["eps_count"], "max_abs_err": eps_err,
         "ms": ec_ms, "plain_ms": eps_plain_ms,
         "bound_ms": max(ec_b_ops, ec_b_bytes),
         "bound_by": "operations" if ec_b_ops >= ec_b_bytes else "bytes",
         "library_ms": lib_ms},
        # the L2 cores' anchor, not a port: it replaces no TPU kernel and
        # is off the main path; [5]'s tile in 8192-row chunks
        {"name": "l2_chain", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/l2_chain.cu",
         "replaces": None, "launches": chain_on_path,
         "max_abs_err": chain_err, "ms": chain_ms,
         "plain_ms": chain_plain_ms, "bound_ms": chain_bound,
         "bound_by": chain_by, "library_ms": lib_ms},
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
