#!/usr/bin/env python3
"""Time build_nng's calls in this checkout against another checkout.

    python3 tree_ab.py OTHER [--rounds 2] [--calls CALL,...] [--kernels]
                       [--profile]
    python3 tree_ab.py --ratios [--device cpu] [--n N] [--metric M]

OTHER is the root of another checkout, or of an unpacked ``git archive``
of one. Each round runs both, each in a fresh process, in the order other,
this, this, other: ``build_nng`` on chip_smoke.py's smoke points (the
``nng-sift-1m`` stand-in, 2^20 x 128, seed 0, eps 2.98, 8 logical ranks,
k_cap 1024 unless a call names its own) in the calls named by ``--calls``
(default: all):
"point tree" and "ring tree" (``traversal="tree"`` through the point
partition and through the spatial partition's ghost ring), "point
tiles" (the main path, ``traversal="tiles"``), "l1 tree" (the point
ring's tree under L1 on the first 2^19 points at eps 26.0194586,
chip_smoke.py [8]'s cut and eps), "hamming tree" (the point ring's
tree under Hamming on the ``nng-word2bits`` stand-in, 399360 x 25 words,
seed 0, eps 40: chip_smoke.py [7b]'s call), "l1 ring" (the spatial
partition's ghost ring with tiles under L1 at [8]'s cut and eps:
chip_smoke.py [10d]'s call) and "hamming ring tree" (the spatial tree
flavour on the ghost ring under Hamming, k_cap 3072: chip_smoke.py
[10e]'s call). With ``--profile`` each process runs each
call once more under torch.profiler (the card's activity only) and
reports its device busy time, idle share and the five kernels with the
most device time; the timed call runs unprofiled. With ``--kernels`` each
process also times its own ``nng_tile_cuda`` and ``eps_count_cuda`` on
rank 0's block against rank 1's (131072 x 131072 x 128; CUDA events,
median of 3 after a warm-up), and the frontier kernels over one
traversal: rank 0's block, in its forest's DFS order (the engine's: the
forest's valid ``leaf_ids``), against rank 1's forest, each launch timed
in place, for L2 on the smoke points, for L1 on their first 2^19 at
eps 26.0194586 ([8]'s cut) and for Hamming on the word2bits stand-in at
eps 40 ([7]'s), with the busiest launch's time. Prints each
run's ``elapsed_s``, call wall, peak device memory and kernel times, the
card's name and power limit, and a last line of JSON; each call's graph,
work counters (tiles_scheduled, tiles_skipped, dists_evaluated,
nodes_pruned) and comm_bytes must be the same in every run. Needs one
CUDA card.

With ``--ratios`` it runs no A/B and builds no kernel: on the first
``--n`` smoke points (default all on the card, 2^17 with ``--device
cpu``; 8 ranks), it runs two traversals, rank 0's block against rank 1's
forest (the first forward round) and against its own (the self round),
once with the rows in index order and once in the forest's DFS order, and
counts in every frontier launch the active pairs, the live 128 x 128
blocks (the old kernels' block) and the live 64 x 256 tiles (the
pipelined core's, ``frontier_tile_plan``). The frontier runs on the card's
kernels, or on their plain versions with ``--device cpu``; the counts
depend only on the masks, which are the same either way. ``--metric
manhattan`` takes eps 26.0194586 ([8]'s) unless ``--eps`` is given;
``--metric hamming`` takes the word2bits stand-in's points (all 399360
by default, 2^16 with ``--device cpu``) and eps 40.
Prints a line a launch, each traversal's sums, the busiest launch, and a
last line of JSON.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N, DIM, SEED, EPS, NRANKS, K_CAP = 1 << 20, 128, 0, 2.98, 8, 1024
CALLS = {"point tree": {"traversal": "tree"},
         "ring tree": {"traversal": "tree", "partition": "spatial",
                       "ghost_mode": "ring"},
         "point tiles": {"traversal": "tiles"},
         "l1 tree": {"traversal": "tree", "metric": "manhattan"},
         "hamming tree": {"traversal": "tree", "metric": "hamming"},
         "l1 ring": {"traversal": "tiles", "partition": "spatial",
                     "ghost_mode": "ring", "metric": "manhattan"},
         "hamming ring tree": {"traversal": "tree", "partition": "spatial",
                               "ghost_mode": "ring", "metric": "hamming",
                               "k_cap": 3072}}
KERNELS = ("nng_tile", "eps_count")
L1_N, L1_EPS = 1 << 19, 26.0194586      # chip_smoke.py [8]'s cut and eps
HAM_N, HAM_W, HAM_EPS = 399360, 25, 40.0  # chip_smoke.py [7]'s stand-in


def points(metric: str):
    """A metric's points and eps: the smoke points (L2), their first L1_N
    (L1), or the word2bits stand-in's uint32 word rows (Hamming)."""
    from repro_torch.data import synthetic_pointset
    if metric == "hamming":
        return synthetic_pointset(HAM_N, HAM_W, "hamming", seed=SEED), HAM_EPS
    pts = synthetic_pointset(N, DIM, seed=SEED)
    return (pts[:L1_N], L1_EPS) if metric == "manhattan" else (pts, EPS)


def median_ms(torch, fn, reps=3):
    """Median milliseconds of ``fn()`` over ``reps`` runs after a warm-up,
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


def dfs_order(forest, id0):
    """Rank rows in the forest's DFS order: its valid leaf ids less id0
    (what the engine does; read from the tables, so any checkout's forest
    serves)."""
    lid = forest.leaf_ids
    return lid[lid != 2**31 - 1].long() - id0


def spy_frontier(tdev, record):
    """Replace ``tdev.tree_frontier_step`` with a wrapper that calls
    ``record(args, out)`` after each launch; returns the original."""
    orig = tdev.tree_frontier_step

    def step(*args, **kw):
        out = orig(*args, **kw)
        record(args, out)
        return out
    tdev.tree_frontier_step = step
    return orig


def frontier_ms(torch, pts, eps, metric, n):
    """One traversal's frontier launches (rank 0's block in DFS order
    against rank 1's forest, on the first n points), each timed in place
    with CUDA events -> (total ms, launches, busiest launch's ms)."""
    from repro_torch.core.distributed import DeviceForest, tree_traverse
    from repro_torch.core.distributed import device as tdev
    from repro_torch.core.flat_tree import build_block_forests
    from repro_torch.core.metrics import get_metric
    P = get_metric(metric).as_device(pts[:n], "cuda")
    F = DeviceForest.from_tables(build_block_forests(
        P, NRANKS, metric, backend="device"))
    n_loc = n // NRANKS
    order = dfs_order(F.rank(0), 0)
    ev = []

    def step(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(*args, **kw)
        e1.record()
        ev.append((e0, e1, tdev._popcount(args[4])))
        return out
    orig = tdev.tree_frontier_step
    runs = []
    for _ in range(2):                 # a warm-up, then the timed run
        ev.clear()
        tdev.tree_frontier_step = step
        try:
            tree_traverse(P[:n_loc][order], order.to(torch.int32),
                          torch.zeros(n_loc, dtype=torch.int32,
                                      device=P.device), F.rank(1), eps,
                          K_CAP, metric)
        finally:
            tdev.tree_frontier_step = orig
        torch.cuda.synchronize()
        runs.append([(a.elapsed_time(b), int(w)) for a, b, w in ev])
    ms = runs[-1]
    busiest = max(ms, key=lambda t: t[1])[0]
    return sum(t for t, _ in ms), len(ms), busiest


def profiled(torch, fn) -> dict:
    """``fn()`` once under torch.profiler (the card's activity only) ->
    {busy_ms, window_ms, idle, top: [[kernel, ms], ...] (five)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            s0, d = e.start_ns() / 1e6, e.duration_ns() / 1e6
            by_name[e.name()] = by_name.get(e.name(), 0.0) + d
            spans.append((s0, s0 + d))
    spans.sort()
    busy, (s0, e0) = 0.0, spans[0]
    for s1, e1 in spans[1:]:
        if s1 > e0:
            busy, s0 = busy + (e0 - s0), s1
        e0 = max(e0, e1)
    busy += e0 - s0
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"busy_ms": busy, "window_ms": window, "idle": 1 - busy / window,
            "top": [[k[:60], ms] for k, ms in top]}


def child(root: Path, calls: list, kernels: bool, prof: bool) -> None:
    """One run of the calls with the sources under ``root``; prints one
    JSON line."""
    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.nng import build_nng
    pts, _ = points("euclidean")
    mesh = make_nng_mesh(NRANKS)
    out = {}
    for label in calls:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pts_, eps_ = points(CALLS[label].get("metric", "euclidean"))
        t0 = time.perf_counter()
        kw = {"k_cap": K_CAP, **CALLS[label]}
        g = build_nng(pts_, eps_, mesh=mesh, **kw)
        wall = time.perf_counter() - t0
        st = g.stats
        out[label] = {
            "elapsed_s": st.elapsed_s, "wall_s": wall,
            "peak_B": torch.cuda.max_memory_allocated(),
            "graph": hashlib.sha256(g.edge_key().tobytes()).hexdigest()[:16],
            "counters": [float(st.tiles_scheduled), float(st.tiles_skipped),
                         float(st.dists_evaluated), float(st.nodes_pruned)],
            "comm_bytes": st.comm_bytes}
        del g
        if prof:
            out[label]["profile"] = profiled(torch, lambda: build_nng(
                pts_, eps_, mesh=mesh, **kw))
    if kernels:
        from repro_torch.kernels.eps_count import eps_count_cuda
        from repro_torch.kernels.nng_tile import nng_tile_cuda
        torch.backends.cuda.matmul.allow_tf32 = False
        n = N // NRANKS
        p = torch.from_numpy(pts[:2 * n]).cuda()
        x, y = p[:n].contiguous(), p[n:].contiguous()
        ones = torch.ones(n, dtype=torch.int32, device=x.device)
        torch.cuda.empty_cache()
        out["kernels"] = {
            "nng_tile": median_ms(torch, lambda: nng_tile_cuda(x, y, ones,
                                                               EPS)),
            "eps_count": median_ms(torch, lambda: eps_count_cuda(x, y,
                                                                 EPS))}
        del p, x, y, ones
        torch.cuda.empty_cache()
        for name, metric in (("tree_frontier", "euclidean"),
                             ("tree_frontier_l1", "manhattan"),
                             ("tree_frontier_hamming", "hamming")):
            pts_, eps_ = points(metric)
            total, launches, busiest = frontier_ms(torch, pts_, eps_, metric,
                                                   len(pts_))
            out["kernels"][name] = total
            out["kernels"][name + " launches"] = launches
            out["kernels"][name + " busiest"] = busiest
            torch.cuda.empty_cache()
    print(json.dumps(out))


def ratios(device: str, n: int | None, metric: str, eps: float | None,
           q_chunk: int | None) -> dict:
    """--ratios: live 128 x 128 blocks and 64 x 256 tiles of every frontier
    launch of two traversals, rows in index order and in DFS order."""
    import torch
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.core.distributed import (DeviceForest, dfs_row_order,
                                              tree_traverse)
    from repro_torch.core.distributed import device as tdev
    from repro_torch.core.flat_tree import build_block_forests
    from repro_torch.core.metrics import get_metric
    from repro_torch.kernels.nng_tile import PIPE_TILE
    from repro_torch.kernels.tree_frontier import TN, TQ, frontier_tile_plan
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tree_ab: no CUDA device (use --device cpu)")
    pts, eps_m = points(metric)
    cpu_n = 1 << 16 if metric == "hamming" else 1 << 17
    n = n or (len(pts) if dev.type == "cuda" else cpu_n)
    eps = eps or eps_m
    pts = pts[:n]
    P = get_metric(metric).as_device(pts, dev)
    t0 = time.perf_counter()
    F = DeviceForest.from_tables(build_block_forests(P, NRANKS, metric,
                                                     backend="device"))
    print(f"forest of the first {n} points, {NRANKS} ranks, {metric},"
          f" eps {eps}: levels {F.radius.shape[1]}, N {F.radius.shape[2]} "
          f"slots, built in {time.perf_counter() - t0:.1f} s on {dev}",
          flush=True)
    n_loc = n // NRANKS
    orders = {"block": torch.arange(n_loc, device=dev),
              "dfs": dfs_row_order(F.rank(0), 0)}
    tq, tn = PIPE_TILE
    out = {}
    for trav, target in (("cross", 1), ("self", 0)):
        for oname, order in orders.items():
            rows = []

            def record(args, _out):
                act = args[4]
                rows.append((act.shape[0], args[1].shape[0],
                             int(tdev._popcount(act)),
                             int(frontier_tile_plan(act, TQ, TN // 32)[1]),
                             int(frontier_tile_plan(act, tq, tn // 32)[1])))
            orig = spy_frontier(tdev, record)
            try:
                tree_traverse(P[:n_loc][order], order.to(torch.int32),
                              torch.zeros(n_loc, dtype=torch.int32,
                                          device=dev), F.rank(target), eps,
                              K_CAP, metric, q_chunk=q_chunk)
            finally:
                tdev.tree_frontier_step = orig
            out[f"{trav} {oname}"] = rows
    summary = {}
    for key, rows in out.items():
        blocks = sum(-(-r // TQ) * -(-c // TN) for r, c, *_ in rows)
        tiles = sum(-(-r // tq) * -(-c // tn) for r, c, *_ in rows)
        big = max(range(len(rows)), key=lambda i: rows[i][2])
        summary[key] = {
            "launches": len(rows), "active_pairs": sum(r[2] for r in rows),
            "live_blocks": sum(r[3] for r in rows), "blocks": blocks,
            "live_tiles": sum(r[4] for r in rows), "tiles": tiles,
            "busiest": dict(zip(("rows", "nodes", "active_pairs",
                                 "live_blocks", "live_tiles"), rows[big]),
                            blocks=-(-rows[big][0] // TQ)
                            * -(-rows[big][1] // TN),
                            tiles=-(-rows[big][0] // tq)
                            * -(-rows[big][1] // tn))}
        for i, (r, c, pr, lb, lt) in enumerate(rows):
            print(f"{key} launch {i}: {r} x {c}, {pr} active pairs, live "
                  f"128x128 blocks {lb} of {-(-r // TQ) * -(-c // TN)}, live "
                  f"64x256 tiles {lt} of {-(-r // tq) * -(-c // tn)}")
        s_ = summary[key]
        print(f"{key}: {s_['launches']} launches, {s_['active_pairs']} "
              f"active pairs; live 128x128 blocks {s_['live_blocks']} of "
              f"{blocks} ({100 * s_['live_blocks'] / blocks:.2f}%); live "
              f"64x256 tiles {s_['live_tiles']} of {tiles} "
              f"({100 * s_['live_tiles'] / tiles:.2f}%); busiest launch "
              f"{json.dumps(s_['busiest'])}", flush=True)
    for trav in ("cross", "self"):
        a, b = summary[f"{trav} block"], summary[f"{trav} dfs"]
        assert a["active_pairs"] == b["active_pairs"], (trav, a, b)
    return {"device": str(dev), "n": n, "metric": metric, "eps": eps,
            "summary": summary}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", default=",".join(CALLS),
                    help="comma-separated calls: " + ", ".join(CALLS))
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--ratios", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int)
    ap.add_argument("--metric", default="euclidean",
                    choices=("euclidean", "manhattan", "hamming"))
    ap.add_argument("--eps", type=float)
    ap.add_argument("--q-chunk", type=int)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ratios:
        print(json.dumps(ratios(args.device, args.n, args.metric, args.eps,
                                args.q_chunk)))
        return 0
    calls = [c.strip() for c in args.calls.split(",") if c.strip()]
    if any(c not in CALLS for c in calls):
        ap.error(f"--calls: not among {', '.join(CALLS)}: {args.calls}")
    if args.child is not None:
        child(args.child, calls, args.kernels, args.profile)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("tree_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.other is None:
        ap.error("OTHER is required")
    roots = {"other": args.other.resolve(), "this": HERE}
    runs = {side: [] for side in roots}
    for rnd in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            r = subprocess.run([sys.executable, str(HERE / "tree_ab.py"),
                                "--child", str(roots[side]), "--calls",
                                ",".join(calls)]
                               + (["--kernels"] if args.kernels else [])
                               + (["--profile"] if args.profile else []),
                               capture_output=True, text=True, cwd=roots[side])
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            res = json.loads(r.stdout.strip().splitlines()[-1])
            runs[side].append(res)
            print(f"round {rnd} {side}: " + "; ".join(
                f"{k} elapsed_s {res[k]['elapsed_s']:.3f} wall "
                f"{res[k]['wall_s']:.3f} peak {res[k]['peak_B']} B" + (
                    f" profile {json.dumps(res[k]['profile'])}"
                    if "profile" in res[k] else "")
                for k in calls) + "".join(
                f"; {k} {ms:.3f} ms" for k, ms in res.get(
                    "kernels", {}).items()), flush=True)
    summary = {side: {label: statistics.median(r[label]["elapsed_s"]
                                               for r in side_runs)
                      for label in calls}
               for side, side_runs in runs.items()}
    kernel_ms = {side: {k: statistics.median(r["kernels"][k]
                                             for r in side_runs)
                        for k in side_runs[0]["kernels"]}
                 for side, side_runs in runs.items() if args.kernels}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"median elapsed_s: {json.dumps(summary)}")
    if kernel_ms:
        print(f"median kernel ms: {json.dumps(kernel_ms)}")
    print(smi)
    ok = all(len({json.dumps([r[label][k] for k in ("graph", "counters",
                                                    "comm_bytes")])
                  for side_runs in runs.values() for r in side_runs}) == 1
             for label in calls)
    for label in calls:
        r = runs["this"][0][label]
        print(f"{label}: tiles_scheduled, tiles_skipped, dists_evaluated, "
              f"nodes_pruned {r['counters']}; comm_bytes "
              f"{json.dumps(r['comm_bytes'])}")
    print(json.dumps({"ok": ok, "median_elapsed_s": summary,
                      "median_kernel_ms": kernel_ms}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
