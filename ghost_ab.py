#!/usr/bin/env python3
"""Time this checkout's ghost tile kernels against the same kernels built
from another source tree, each on one launch of the ghost ring; or its
grouped L2 kernel, on the spatial engine's launches and in its call.

    python3 ghost_ab.py OTHER [--metric all] [--rounds 4] [--reps 9]
    python3 ghost_ab.py OTHER --grouped [--rounds 4] [--reps 9]
    python3 ghost_ab.py --ratios [--device cpu] [--metric euclidean]

OTHER is the root of another checkout, or of an unpacked ``git archive``
of one. Its ``src/repro_torch/kernels/csrc/nng_tile_ghost*.cu`` (with its
own headers) are compiled with this checkout's nvcc flags into
``build/ab/``; their C entry points take this checkout's arguments, or,
for the L2 and L1 kernels, those of the single-tile kernels before the row
order and the live-tile list (x, y, ghost words, y cells, cnt, bits, q, p,
d, mw, the threshold, stream: every tile of the caller's order), which
this script then calls with the launch's own operands.

A metric's launch is rank 0's round-1 block-against-W launch of
``build_nng(partition="spatial", ghost_mode="ring")`` on 8 logical ranks
at chip_smoke.py's shapes (m = 32 cells: one ghost word a row), captured
from the call as the second launch against the first launch's W:

  euclidean  [10b]: the ``nng-sift-1m`` stand-in, 2^20 x 128, eps 2.98;
  hamming    [10c]: the ``nng-word2bits`` stand-in, 399360 x 25 words,
             eps 40, k_cap 3072;
  manhattan  [10d]: the first 2^19 of the euclidean points, eps 26.0194586
             (chip_smoke.py's [8] eps to the digits it prints).

Both builds run on the same inputs, in the order this, other, other, this
each round, and their outputs must be equal. Prints each time (CUDA
events, median of ``--reps`` after a warm-up; this checkout's L2 time is
its wrapper's, the row order, live-tile list and zeroed outputs
included), the card's name and power limit, and a last line of JSON.
Needs one CUDA card.

``--grouped`` builds the other tree's ``nng_tile_grouped.cu`` instead
(its entry point may take this checkout's arguments, or the single-launch
ones: x, y, groups, ids, cnt, bits, q, p, d, eps2, stream, every tile) and
captures rank 0's W x W and G x W launches of chip_smoke.py [9b]'s call
(``build_nng(partition="spatial")`` of the euclidean points above, eps
2.98, k_cap 1024, the collective exchange). On each launch the two builds'
outputs must be equal, and they are timed in turns as above (this
checkout's time is its wrapper's: the tile list and zeroed outputs
included). Then the call itself runs ``--rounds`` times in the order this,
other, other, this, the engine's grouped kernel swapped for the other
build through the metric (``dataclasses.replace`` of its
``grouped_kernel``), and prints each call's ``elapsed_s``; every call's
graph must equal the first's.

``--ratios`` builds no kernel and evaluates no distance: it plans the ring
of ``--metric`` (euclidean: [10b]; manhattan: [10d]; the device planner,
the exchange and each rank's ring block on ``--device``, the card by
default) and, for every launch of one engine run (36 on 8 ranks; the call
runs the engine twice), prints the pairs the function needs (a row
against a column of one of its ghost cells), the pairs of the live
128 x 128 blocks in the caller's row order (the single-tile kernels'
skip) and of the live 64 x 256 tiles in ``ghost_row_order`` (this
checkout's L2 and L1 kernels), for rank 0's round-1 launch and summed
over the run.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
NRANKS, SEED = 8, 0
# the single-tile L2 and L1 ghost kernels' C arguments (x, y, ghost words, y
# cells, cnt, bits, q, p, d, mw, the threshold, stream)
SINGLE = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4 + (ctypes.c_float,
                                                         ctypes.c_void_p)
# metric -> (kernel library, eps, k_cap), as chip_smoke.py's [10b]-[10d]
CASES = {"euclidean": ("nng_tile_ghost", 2.98, 1024),
         "hamming": ("nng_tile_ghost_hamming", 40.0, 3072),
         "manhattan": ("nng_tile_ghost_l1", 26.0194586, 1024)}


def median_ms(torch, fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs after a warm-up."""
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


def live_pairs(torch, live, q, p, tq, tp):
    """Pairs of a (q, p) output in the live blocks of its (tq, tp) block
    map ``live`` (ragged edge blocks count their own rows and columns)."""
    rq = torch.full((live.shape[0],), tq, device=live.device)
    rp = torch.full((live.shape[1],), tp, device=live.device)
    rq[-1] = q - tq * (live.shape[0] - 1)
    rp[-1] = p - tp * (live.shape[1] - 1)
    return int((live * rq[:, None] * rp[None, :]).sum())


def case_points(metric: str):
    """The points of ``metric``'s ring launch (see the module's
    docstring)."""
    from repro_torch.data import synthetic_pointset
    if metric == "hamming":
        return synthetic_pointset(399360, 25, "hamming", seed=SEED)
    sift = synthetic_pointset(1 << 20, 128, seed=SEED)
    return sift[:1 << 19] if metric == "manhattan" else sift


def ratios(device: str, metric: str) -> int:
    """The --ratios mode (see the module's docstring)."""
    import torch
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.core.distributed import device as tdev
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.core.metrics import get_metric
    from repro_torch.kernels import nng_tile as nt
    from repro_torch.kernels.ops import _pad_rows, ghost_block_active
    from repro_torch.nng import SpatialPartitionEngine

    _, eps, k_cap = CASES[metric]
    met = get_metric(metric)
    mesh = make_nng_mesh(NRANKS, device=device)
    pts = case_points(metric)
    t0 = time.perf_counter()
    eng = SpatialPartitionEngine(pts, eps, mesh, metric, k_cap=k_cap,
                                 ghost_mode="ring")
    plan = eng.initial_plan()
    x = eng.points
    bufs, dropped = tdev._landmark_exchange(
        list(x.chunk(NRANKS)), list(torch.arange(
            x.shape[0], dtype=torch.int32, device=x.device).chunk(NRANKS)),
        eng.centers, torch.as_tensor(eng.f, dtype=torch.int64,
                                     device=x.device),
        mesh=mesh, two_eps_c=2.0 * eps, metric=met, plan=plan,
        ghost_mode="ring")
    if any(bool(d) for d in dropped):
        print("ghost_ab: the plan dropped rows", file=sys.stderr)
        return 1
    blks = [tdev.ring_block(W, Wids, Wgrp, eng.centers, eps=eps, metric=met,
                            cap_rank=plan.cap_rank)
            for W, Wids, Wgrp in bufs]
    print(f"ghost_ab: the {metric} ring ({len(pts)} points, eps {eps}) on "
          f"{device}: {plan} planned and exchanged in "
          f"{time.perf_counter() - t0:.3f} s")
    tq, tp = nt.PIPE_TILE
    rounds = NRANKS // 2
    total = {"need": 0, "old": 0, "new": 0}
    launches = 0
    for r in range(rounds + 1):
        for me in range(NRANKS):
            if (r == rounds and rounds > 0 and NRANKS % 2 == 0
                    and not me < (me + rounds) % NRANKS):
                continue
            gb = blks[(me + r) % NRANKS][2]
            yg = bufs[me][2]
            q, p = gb.shape[0], yg.shape[0]
            xc = nt.unpack_words(gb).sum(0).long()
            yc = torch.bincount(yg[yg >= 0].long(), minlength=xc.shape[0])
            need = int((xc * yc).sum())
            old = live_pairs(torch, ghost_block_active(
                _pad_rows(gb, 128)[0], _pad_rows(yg, 128, -1)[0], 128, 128),
                q, p, 128, 128)
            _, keys, _, _ = nt.ghost_tile_plan(gb, yg)
            new = live_pairs(torch, ghost_block_active(
                _pad_rows(keys, tq)[0], _pad_rows(yg, tp, -1)[0], tq, tp),
                q, p, tq, tp)
            for k, v in (("need", need), ("old", old), ("new", new)):
                total[k] += v
            launches += 1
            if (me, r) == (0, 1):
                print(f"ghost_ab: rank 0's round-1 launch ({q} x {p}): "
                      f"{need} needed pairs; live 128 x 128 blocks in the "
                      f"caller's order {old} pairs ({old / need:.4f}x); "
                      f"live {tq} x {tp} tiles in the ghost order {new} "
                      f"pairs ({new / need:.4f}x)")
    print(f"ghost_ab: all {launches} launches of one engine run: "
          f"{total['need']} needed pairs; live 128 x 128 blocks in the "
          f"caller's order {total['old']} pairs "
          f"({total['old'] / total['need']:.4f}x); live {tq} x {tp} tiles "
          f"in the ghost order {total['new']} pairs "
          f"({total['new'] / total['need']:.4f}x)")
    print(json.dumps({"metric": metric, "launches": launches, **total}))
    return 0


def grouped_ab(args) -> int:
    """The --grouped mode (see the module's docstring)."""
    import dataclasses

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ghost_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.core.distributed import device as tdev
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.core.metrics import get_metric
    from repro_torch.kernels import _build
    from repro_torch.kernels import nng_tile as nt
    from repro_torch.nng import build_nng

    lib, eps, k_cap = "nng_tile_grouped", 2.98, 1024
    src = args.other.resolve() / "src/repro_torch/kernels/csrc" / f"{lib}.cu"
    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"other-{lib}-{os.getpid()}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"ghost_ab: nvcc failed for {lib}:\n{proc.stdout}"
              f"{proc.stderr}", file=sys.stderr)
        return 1
    single = "int sms" not in src.read_text()
    fn = getattr(ctypes.CDLL(str(so)), _build._ENTRY[lib][0])
    fn.argtypes = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 3
                   + (ctypes.c_float, ctypes.c_void_p)) if single else \
        _build._ENTRY[lib][1]
    fn.restype = ctypes.c_int
    so.unlink()

    def other(x, y, xg, yg, xid, yid, eps_):
        """The other build on checked operands -> (cnt, bits)."""
        (q, d), p = x.shape, y.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        cnt = torch.zeros(q, dtype=torch.int32, device=x.device)
        bits = (torch.empty if single else torch.zeros)(
            (q, -(-p // 32)), dtype=torch.int32, device=x.device)
        ptrs = [t.data_ptr() for t in (x, y, xg, yg, xid, yid)]
        if single:
            code = fn(*ptrs, cnt.data_ptr(), bits.data_ptr(), q, p, d,
                      nt.eps2_f32(eps_), stream)
        else:
            tiles, count = nt.grouped_tile_plan(xg, yg)
            xsq, ysq = nt.row_norm_scratch(q, p, x.device)
            code = fn(*ptrs, tiles.data_ptr(), count.data_ptr(),
                      cnt.data_ptr(), bits.data_ptr(), xsq.data_ptr(),
                      ysq.data_ptr(), q, p, d, nt.eps2_f32(eps_),
                      nt.sm_count(x.device.index), stream)
        _build.check(f"other {lib}", code)
        return cnt, bits

    mesh = make_nng_mesh(NRANKS)
    pts = case_points("euclidean")
    kept = []
    orig = tdev.nng_tile_bits_grouped

    def spy(*a, **kw):
        kept.append(a[:7])
        return orig(*a, **kw)

    def call(metric):
        return build_nng(pts, eps, metric=metric, partition="spatial",
                         mesh=mesh, k_cap=k_cap)

    tdev.nng_tile_bits_grouped = spy
    t0 = time.perf_counter()
    try:
        g0 = call("euclidean")
    finally:
        tdev.nng_tile_bits_grouped = orig
    print(f"ghost_ab: euclidean build_nng spatial at {pts.shape}, eps {eps}: "
          f"{g0.num_edges} edges in {time.perf_counter() - t0:.3f} s")
    # the engine's first launch is rank 0's W x W, launch NRANKS its G x W
    launches = {"W x W": kept[0], "G x W": kept[NRANKS]}
    del kept
    record = {}
    for label, a in launches.items():
        x, y = (t.to(torch.float32).contiguous() for t in a[:2])
        ints = [torch.as_tensor(t, dtype=torch.int32, device=x.device)
                .contiguous() for t in a[2:6]]
        args_ = (x, y, *ints, a[6])
        mine = nt.nng_tile_grouped_cuda
        a_out, b_out = mine(*args_), other(*args_)
        if not all(torch.equal(u, v) for u, v in zip(a_out, b_out)):
            print(f"ghost_ab: {lib} {label}: the two builds' outputs differ",
                  file=sys.stderr)
            return 1
        del a_out, b_out
        runs = {"this": lambda: mine(*args_), "other": lambda: other(*args_)}
        times = {"this": [], "other": []}
        for _ in range(args.rounds):
            for name in ("this", "other", "other", "this"):
                times[name].append(median_ms(torch, runs[name], args.reps))
        for name, ts in times.items():
            print(f"ghost_ab: {lib} {label} ({x.shape[0]}x{y.shape[0]}x"
                  f"{x.shape[1]}) {name} "
                  f"({HERE if name == 'this' else args.other}): "
                  f"{' '.join(f'{t:.4f}' for t in ts)} ms; median "
                  f"{statistics.median(ts):.4f} ms")
        record[f"{lib} {label}"] = {
            name: {"median_ms": statistics.median(ts), "ms": ts}
            for name, ts in times.items()}
        del x, y, ints, args_, runs
    del launches
    torch.cuda.empty_cache()
    met = get_metric("euclidean")
    metrics = {"this": met,
               "other": dataclasses.replace(met, grouped_kernel=other)}
    elapsed = {"this": [], "other": []}
    for _ in range(args.rounds):
        for name in ("this", "other", "other", "this"):
            g = call(metrics[name])
            if not (np.array_equal(g.row_ptr, g0.row_ptr)
                    and np.array_equal(g.col_ids, g0.col_ids)):
                print(f"ghost_ab: the {name} call's graph differs",
                      file=sys.stderr)
                return 1
            elapsed[name].append(g.stats.elapsed_s)
            del g
    for name, ts in elapsed.items():
        print(f"ghost_ab: spatial-sift elapsed_s {name}: "
              f"{' '.join(f'{t:.4f}' for t in ts)} s; median "
              f"{statistics.median(ts):.4f} s")
    record["elapsed_s"] = {name: {"median_s": statistics.median(ts), "s": ts}
                           for name, ts in elapsed.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps(record))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--metric", choices=[*CASES, "all"], default=None,
                    help="the A/B's metric (default all) or --ratios' ring "
                    "(default euclidean)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--ratios", action="store_true")
    ap.add_argument("--grouped", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.ratios:
        return ratios(args.device, args.metric or "euclidean")
    if args.other is None:
        ap.error("OTHER is required without --ratios")
    if args.grouped:
        return grouped_ab(args)
    import torch
    if not torch.cuda.is_available():
        print("ghost_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    from repro_torch.core.distributed import device as tdev
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels import nng_tile as nt
    from repro_torch.nng import build_nng

    csrc = args.other.resolve() / "src/repro_torch/kernels/csrc"
    thr = {"euclidean": nt.eps2_f32, "hamming": nt.eps_int,
           "manhattan": lambda e: float(np.float32(e))}
    metrics = (list(CASES) if args.metric in (None, "all")
               else [args.metric])
    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for metric in metrics:
        lib = CASES[metric][0]
        so = out_dir / f"other-{lib}-{os.getpid()}.so"
        procs[metric] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(csrc / f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    other_fn = {}
    for metric, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"ghost_ab: nvcc failed for {metric}:\n{log}",
                  file=sys.stderr)
            return 1
        lib = CASES[metric][0]
        symbol, argtypes = _build._ENTRY[lib]
        if metric != "hamming" and "int sms" not in (
                csrc / f"{lib}.cu").read_text():
            argtypes = SINGLE
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        other_fn[metric] = fn
        so.unlink()

    def other(metric, x, y, gb, yg, eps):
        """The other build on the launch's operands: the single-tile
        argument list as it is (it stores every word), the pipelined one
        through this checkout's plan (``_ghost_pipe``'s body; L2 with norm
        scratch)."""
        fn = other_fn[metric]
        q, d = x.shape
        p = y.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        cnt = torch.zeros(q, dtype=torch.int32, device=x.device)
        if tuple(fn.argtypes) == SINGLE or metric == "hamming":
            bits = torch.empty((q, -(-p // 32)), dtype=torch.int32,
                               device=x.device)
            code = fn(x.data_ptr(), y.data_ptr(), gb.data_ptr(),
                      yg.data_ptr(), cnt.data_ptr(), bits.data_ptr(), q, p,
                      d, gb.shape[1], thr[metric](eps), stream)
        else:
            # _ghost_pipe's body, with the other build's entry
            bits = torch.zeros((q, -(-p // 32)), dtype=torch.int32,
                               device=x.device)
            rows, keys, tiles, count = nt.ghost_tile_plan(gb, yg)
            xs, rows32 = x[rows], rows.to(torch.int32)
            norms = (nt.row_norm_scratch(q, p, x.device)
                     if metric == "euclidean" else ())
            code = fn(xs.data_ptr(), y.data_ptr(), keys.data_ptr(),
                      yg.data_ptr(), rows32.data_ptr(), tiles.data_ptr(),
                      count.data_ptr(), cnt.data_ptr(), bits.data_ptr(),
                      *(t.data_ptr() for t in norms), q, p, d,
                      keys.shape[1], thr[metric](eps),
                      nt.sm_count(x.device.index), stream)
        _build.check(f"other {CASES[metric][0]}", code)
        return cnt, bits

    mesh = make_nng_mesh(NRANKS)
    record = {}
    for metric in metrics:
        lib, eps, k_cap = CASES[metric]
        pts = case_points(metric)
        kept = []
        orig = tdev.nng_tile_bits_ghost

        def spy(*a, **kw):
            if len(kept) < 2 and (not kept or a[1] is kept[0][1]):
                kept.append(a)
            return orig(*a, **kw)

        tdev.nng_tile_bits_ghost = spy
        t0 = time.perf_counter()
        try:
            g = build_nng(pts, eps, metric=metric, partition="spatial",
                          ghost_mode="ring", mesh=mesh, k_cap=k_cap)
        finally:
            tdev.nng_tile_bits_ghost = orig
        print(f"ghost_ab: {metric} build_nng ring at {pts.shape}, eps "
              f"{eps}: {g.num_edges} edges in "
              f"{time.perf_counter() - t0:.3f} s")
        del g
        x, y, gb, yg = kept[-1][:4]
        del kept
        print(f"ghost_ab: {lib} launch x {tuple(x.shape)}, y "
              f"{tuple(y.shape)}, ghost words {tuple(gb.shape)}")
        mine = getattr(nt, f"{lib}_cuda")
        a_out, b_out = mine(x, y, gb, yg, eps), other(metric, x, y, gb, yg,
                                                      eps)
        if not all(torch.equal(u, v) for u, v in zip(a_out, b_out)):
            print(f"ghost_ab: {lib}: the two builds' outputs differ",
                  file=sys.stderr)
            return 1
        del a_out, b_out
        runs = {"this": lambda: mine(x, y, gb, yg, eps),
                "other": lambda: other(metric, x, y, gb, yg, eps)}
        times = {"this": [], "other": []}
        for _ in range(args.rounds):
            for name in ("this", "other", "other", "this"):
                times[name].append(median_ms(torch, runs[name], args.reps))
        for name, ts in times.items():
            print(f"ghost_ab: {lib} {name} "
                  f"({HERE if name == 'this' else args.other}): "
                  f"{' '.join(f'{t:.4f}' for t in ts)} ms; median "
                  f"{statistics.median(ts):.4f} ms")
        record[lib] = {name: {"median_ms": statistics.median(ts), "ms": ts}
                       for name, ts in times.items()}
        del x, y, gb, yg, runs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
