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
     at pairs whose float64 d² lies within 1e-4·eps² of eps²),
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
     version's (``nng_tile`` off the knife edge, ``bits_to_cols``
     bit-identical), and its time (CUDA events, median) beside its bound,
     its plain version's time and a library yardstick;
  6. the tree path on the same points: the forest built on the card, one
     traversal (block 0's points against block 1's tree) whose kernel
     inputs feed ``tree_frontier`` (off the knife edge of each decision)
     and ``leaf_range_pack`` (bit-identical) against their plain versions,
     also on ragged and all-inactive inputs [6a]; ``build_nng(...,
     traversal="tree")`` with its launch counts [6b]; one profiled tree
     engine run [6c]; the tree graph against the tiles graph of [3] (off
     the knife edge) and the sampled rows against float64 [6d]; both
     kernels' times at the path's shapes beside their bounds, each
     bound from the launch's own inputs [6e]; a Gaussian block whose
     traversal takes the dense branch, its passes timed dense and from
     pair lists, all equal, and its counts equal to the tile kernel's [6f].

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
DENSE_N = 32768        # [6f]: points of the Gaussian block, all queries
DENSE_EPS = 13.0       # [6f]: about 36 neighbours a point there
DENSE_CHUNK = 1024     # [6f]: rows a pass where the pair lists fit

# H100 SXM data sheet: fp32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


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
    from repro_torch.core.distributed import (DeviceForest, make_nng_mesh,
                                              tree_traverse)
    from repro_torch.core.distributed import device as tdev
    from repro_torch.core.flat_tree import build_block_forests
    from repro_torch.core.graph import NNGraph
    from repro_torch.data import synthetic_pointset
    from repro_torch.kernels import _build
    from repro_torch.kernels.bits_epilogue import (SENTINEL,
                                                   bits_to_cols_cuda,
                                                   bits_to_cols_ref,
                                                   leaf_range_pack_cuda,
                                                   leaf_range_pack_ref)
    from repro_torch.kernels.nng_tile import (eps2_f32, nng_tile_cuda,
                                              nng_tile_ref, pack_words,
                                              unpack_words)
    from repro_torch.kernels.ops import _pad_rows
    from repro_torch.kernels.tree_frontier import (TN, TQ,
                                                   tree_frontier_cuda,
                                                   tree_frontier_ref)
    from repro_torch.nng import PointPartitionEngine, build_nng

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

    def knife_check(label, xa, yb, i, j, thr):
        """Fail unless every pair (xa[i], yb[j]) lies on the knife edge of
        ``thr``, measured in float64; print how far the farthest lies."""
        a, b = xa[i].double(), yb[j].double()
        dev_ = (((a - b) ** 2).sum(1) - thr).abs()
        scale = (a * a).sum(1) + (b * b).sum(1)
        knife = (KNIFE_ULPS * U32 * scale).clamp_min(KNIFE_REL * thr)
        outside = int((dev_ > knife).sum())
        past_rel = int((dev_ > KNIFE_REL * thr).sum())
        far_rel = float((dev_ / thr).max()) if len(dev_) else 0.0
        far_u = float((dev_ / (U32 * scale)).max()) if len(dev_) else 0.0
        print(f"    {label}: {len(dev_)} pairs differ, {past_rel} of them "
              f"beyond 1e-4·eps²; the farthest at |d²-eps²| = "
              f"{far_rel:.4g}·eps² = {far_u:.4g} fp32 units of ‖x‖²+‖y‖²")
        check(outside == 0, f"{label}: {outside} pairs differ off the knife "
                            f"edge (wider of 1e-4·eps² and {KNIFE_ULPS} "
                            "units)")

    def profiled_run(label, fn):
        """Run ``fn()`` once under torch.profiler, tracing the card only
        (recording every host op slowed the tree run by a third); print its
        device busy time and idle share and the top 8 kernels by device
        time. Reads the trace's raw events: building the profiler's
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
        print(f"{label} profiled engine run {run_s:.3f} s; device busy "
              f"{busy / 1e3:.1f} ms of {window / 1e3:.1f} ms (idle share "
              f"{1 - busy / window:.4f})")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
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

    def traced_traverse(qp, qids, forest_r, eps, k, q_chunk=None):
        """``tree_traverse`` of ``qp`` against one rank's forest, each
        frontier launch timed in place (CUDA events) and its inputs' sizes,
        active pairs and active blocks kept; also the first pass's kernel
        inputs and outputs per level and its ``leaf_range_pack`` inputs.
        Returns (result, wall s, launches, first pass, packs)."""
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
                              e0, e1))
            if len(first) < levels:
                first.append(tuple(args[:5]) + tuple(out))
            return out

        def pack_spy(delta, leaf_ids, qids_):
            if not packs:
                packs.append((delta, leaf_ids, qids_))
            return orig_pack(delta, leaf_ids, qids_)

        tdev.tree_frontier_step, tdev._leaf_range_pack = step_spy, pack_spy
        try:
            t0 = time.perf_counter()
            res = tree_traverse(qp, qids, torch.zeros_like(qids), forest_r,
                                eps, k, "euclidean", q_chunk=q_chunk)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tdev.tree_frontier_step, tdev._leaf_range_pack = (orig_step,
                                                              orig_pack)
        return res, wall, launch_in, first, packs

    def timed_traverse(qp, qids, forest_r, eps, k, q_chunk, sparse_div):
        """One untraced ``tree_traverse`` with ``SPARSE_DIV`` set to
        ``sparse_div`` (1: every level from pair lists; huge: every level
        dense). Returns (result, wall s, peak bytes above what was
        resident)."""
        keep = tdev.SPARSE_DIV
        tdev.SPARSE_DIV = sparse_div
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = tree_traverse(qp, qids, torch.zeros_like(qids), forest_r,
                                eps, k, "euclidean", q_chunk=q_chunk)
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

    def front_bound(rows, nodes, pairs):
        """tree_frontier's least time for one launch, in ms, and its two
        terms: 2·d fp32 flops for each active pair's distance against
        PEAK_FP32, and q, c, rad, leaf and the active words read once and
        the emit and expand words written once against PEAK_BYTES."""
        words = -(-nodes // 32)
        nbytes = 4 * (rows * DIM + nodes * DIM + 2 * nodes
                      + 3 * rows * words)
        ops = 2 * DIM * pairs
        return (max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3, ops,
                nbytes)

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
    nng_tile_cuda.launches = 0
    bits_to_cols_cuda.launches = 0
    t0 = time.perf_counter()
    g = build_nng(pts, EPS, mesh=mesh, k_cap=K_CAP)
    wall = time.perf_counter() - t0
    launches = {"nng_tile": nng_tile_cuda.launches,
                "bits_to_cols": bits_to_cols_cuda.launches}
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
    print(f"[3] launches {json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
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
    b2c_bytes = 4 * words_read + 4 * n_loc * k_path
    b2c_bound = b2c_bytes / PEAK_BYTES * 1e3

    tile_flops = (2 * n_loc * n_loc * DIM + 2 * 2 * n_loc * DIM
                  + 3 * n_loc * n_loc)
    tile_bytes = 4 * 2 * n_loc * DIM + 4 * n_loc * 2 + 4 * n_loc * w
    tile_bound_ops = tile_flops / PEAK_FP32 * 1e3
    tile_bound_bytes = tile_bytes / PEAK_BYTES * 1e3
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

    # one traversal of the path (block 0's points against block 1's tree),
    # its frontier launches timed in place, and the first query pass's
    # kernel inputs kept for the checks below
    F1 = F.rank(1)
    ids0 = torch.arange(n_loc, dtype=torch.int32, device=dev)
    (_, trav_s, launch_in, first, packs) = traced_traverse(
        P[:n_loc], ids0, F1, EPS, k_path)
    level_ms = [e0.elapsed_time(e1) for *_, e0, e1 in launch_in]
    trav_frontier_ms = sum(level_ms)
    q_chunk = first[0][0].shape[0]
    n_launch = len(launch_in)
    trav_pairs = sum(int(pr) for _, _, pr, _, _, _ in launch_in)
    trav_blocks = sum(int(b) for _, _, _, b, _, _ in launch_in)
    print(f"[6a] one traversal ({n_loc} queries in passes of {q_chunk}, "
          f"{n_launch} frontier launches): {trav_s:.3f} s wall, frontier "
          f"{trav_frontier_ms:.2f} ms, {trav_pairs} active pairs, "
          f"{trav_blocks} of {n_launch * -(-q_chunk // TQ) * -(-W // TN)} "
          f"blocks have one; first pass per level (ms) "
          f"{[round(v, 2) for v in level_ms[:L]]}")
    print(f"[6a] first pass per level (active pairs, mask, emission): "
          f"{branches(first, F1)}")
    # the same traversal untraced, as shipped and with every level dense
    ship, ship_s, ship_peak = timed_traverse(P[:n_loc], ids0, F1, EPS, k_path,
                                             None, tdev.SPARSE_DIV)
    dense, dense_s, dense_peak = timed_traverse(P[:n_loc], ids0, F1, EPS,
                                                k_path, None, 1 << 62)
    check(all(torch.equal(a, b) for a, b in zip(ship, dense)),
          "[6a] the traversal differs when every level goes dense")
    print(f"[6a] the same traversal untraced: {ship_s:.3f} s wall, peak "
          f"{ship_peak} B above the resident tensors; with every level "
          f"dense {dense_s:.3f} s, peak {dense_peak} B; the same "
          f"neighbours, counts and counters")
    del ship, dense

    def frontier_vs_plain(label, q, c, rad, leaf, act):
        """tree_frontier against its plain version: emit and expand equal
        off the knife edge of the decision each differing pair flips.
        Returns the largest per-row difference in emitted nodes."""
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
    zq = torch.randn(300, 16, device=dev)
    ze, zx = tree_frontier_cuda(zq, zq.repeat(2, 1)[:544],
                                torch.ones(544, device=dev),
                                torch.zeros(544, dtype=torch.int32,
                                            device=dev),
                                torch.zeros((300, 17), dtype=torch.int32,
                                            device=dev), EPS)
    check(not ze.any() and not zx.any(),
          "tree_frontier: an all-inactive mask emitted or expanded")
    print("[6a] tree_frontier with an all-inactive mask: zero words")
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
         leaf, act, dl, li, qi)

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
    # the first pass's level with the most active pairs
    lv_rep = max(range(L), key=lambda lv: int(unpack_words(
        first_pass[lv][4]).sum()))
    q, c, rad, leaf, act = (t.to(dev) for t in first_pass[lv_rep])
    cq, cn = q.shape[0], c.shape[0]
    rep_pairs = int(tdev._popcount(act))
    rep_blocks = int(active_blocks(act))
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
    del zact
    # per traversal: each launch's bound from its own inputs, summed
    trav = [front_bound(r_, n_, int(pr)) for r_, n_, pr, _, _, _ in launch_in]
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
    pack_bytes = 4 * (dl.shape[0] * NL + NL + 2 * dl.shape[0]
                      + dl.shape[0] * NL // 32)
    pack_bound_ms = pack_bytes / PEAK_BYTES * 1e3

    def pack_plain():
        for r0 in range(0, dl.shape[0], 1024):
            leaf_range_pack_ref(dl[r0:r0 + 1024, :NL], li, qi[r0:r0 + 1024])
    pack_plain_ms = cuda_ms(torch, pack_plain, 3)
    print(f"[6e] tree_frontier at level {lv_rep} ({cq}x{cn}x{DIM}, "
          f"{rep_pairs} active pairs in {rep_blocks} of "
          f"{-(-cq // TQ) * -(-cn // TN)} blocks): {front_ms:.3f} ms "
          f"median; bound {front_bound_ms:.3f} ms ({front_by}: "
          f"{front_ops:.4g} fp32 flops of the active pairs at "
          f"{PEAK_FP32 / 1e12:g} TFLOP/s, {front_nbytes} bytes at "
          f"{PEAK_BYTES / 1e12:g} TB/s); with no active pair "
          f"{skip_ms:.3f} ms (bytes bound "
          f"{skip_bytes / PEAK_BYTES * 1e3:.3f} ms); plain version "
          f"{front_plain_ms:.3f} ms ({-(-cq // 1024)} row chunks); torch.mm "
          f"product only {front_lib_ms:.3f} ms; launches on the path "
          f"{tree_launches['tree_frontier']}")
    print(f"[6e] tree_frontier per traversal: {trav_frontier_ms:.2f} ms over "
          f"{n_launch} launches, bound {trav_bound_ms:.3f} ms (the sum of "
          f"each launch's: {trav_ops:.4g} fp32 flops of {trav_pairs} active "
          f"pairs, {trav_nbytes} bytes); {trav_blocks} blocks with an "
          f"active pair")
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
    # lists (SPARSE_DIV 1: no limit), each timed alone with its peak memory
    runs = {}
    for label, chunk, div in (("default passes", None, tdev.SPARSE_DIV),
                              (f"passes of {DENSE_CHUNK}, dense",
                               DENSE_CHUNK, tdev.SPARSE_DIV),
                              (f"passes of {DENSE_CHUNK}, pair lists",
                               DENSE_CHUNK, 1)):
        runs[label] = timed_traverse(gq, gids, GF, DENSE_EPS, K_CAP, chunk,
                                     div)
    ref_out = runs["default passes"][0]
    for label, (out, wall_, peak_) in runs.items():
        check(all(torch.equal(a, b) for a, b in zip(out, ref_out)),
              f"[6f] {label}: neighbours, counts or counters differ from "
              "the default passes")
        print(f"[6f] {label}: {wall_:.3f} s wall, peak {peak_} B above the "
              f"resident tensors")
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
    del G, GF, gq, res, runs, ref_out, out, g_bits, g_cnt
    torch.cuda.empty_cache()
    print(f"[6f] script wall {time.perf_counter() - t_start:.1f} s")

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
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
