#!/usr/bin/env python3
"""Time this checkout's ghost tile kernels against the same kernels built
from another source tree, each on one launch of the ghost ring.

    python3 ghost_ab.py OTHER [--metric all] [--rounds 4] [--reps 9]

OTHER is the root of another checkout, or of an unpacked ``git archive``
of one. Its ``src/repro_torch/kernels/csrc/nng_tile_ghost*.cu`` (with its
own headers) are compiled with this checkout's nvcc flags into
``build/ab/``; their C entry points must take this checkout's arguments.

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
events, median of ``--reps`` after a warm-up), the card's name and power
limit, and a last line of JSON. Needs one CUDA card.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--metric", choices=[*CASES, "all"], default="all")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ghost_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.core.distributed import device as tdev
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.data import synthetic_pointset
    from repro_torch.kernels import _build
    from repro_torch.kernels import nng_tile as nt
    from repro_torch.nng import build_nng

    csrc = args.other.resolve() / "src/repro_torch/kernels/csrc"
    thr = {"euclidean": nt.eps2_f32, "hamming": nt.eps_int,
           "manhattan": float}
    metrics = list(CASES) if args.metric == "all" else [args.metric]
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
        symbol, argtypes = _build._ENTRY[CASES[metric][0]]
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        other_fn[metric] = fn
        so.unlink()

    def other(metric, x, y, gb, yg, eps):
        q, d = x.shape
        p = y.shape[0]
        cnt = torch.zeros(q, dtype=torch.int32, device=x.device)
        bits = torch.empty((q, -(-p // 32)), dtype=torch.int32,
                           device=x.device)
        code = other_fn[metric](
            x.data_ptr(), y.data_ptr(), gb.data_ptr(), yg.data_ptr(),
            cnt.data_ptr(), bits.data_ptr(), q, p, d, gb.shape[1],
            thr[metric](eps), torch.cuda.current_stream().cuda_stream)
        _build.check(f"other {CASES[metric][0]}", code)
        return cnt, bits

    mesh = make_nng_mesh(NRANKS)
    sift = synthetic_pointset(1 << 20, 128, seed=SEED)
    record = {}
    for metric in metrics:
        lib, eps, k_cap = CASES[metric]
        pts = (synthetic_pointset(399360, 25, "hamming", seed=SEED)
               if metric == "hamming" else
               sift[:1 << 19] if metric == "manhattan" else sift)
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
