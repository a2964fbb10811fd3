#!/usr/bin/env python3
"""Time build_nng's calls in this checkout against another checkout.

    python3 tree_ab.py OTHER [--rounds 2] [--calls CALL,...] [--kernels]

OTHER is the root of another checkout, or of an unpacked ``git archive``
of one. Each round runs both, each in a fresh process, in the order other,
this, this, other: ``build_nng`` on chip_smoke.py's smoke points (the
``nng-sift-1m`` stand-in, 2^20 x 128, seed 0, eps 2.98, 8 logical ranks,
k_cap 1024: no grow) in the calls named by ``--calls`` (default: all):
"point tree" and "ring tree" (``traversal="tree"`` through the point
partition and through the spatial partition's ghost ring) and "point
tiles" (the main path, ``traversal="tiles"``). With ``--kernels`` each
process also times its own ``nng_tile_cuda`` and ``eps_count_cuda`` on
rank 0's block against rank 1's (131072 x 131072 x 128; CUDA events,
median of 3 after a warm-up). Prints each run's ``elapsed_s``, call wall,
peak device memory and kernel times, the card's name and power limit, and
a last line of JSON; each call's graph must be the same in every run.
Needs one CUDA card.
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
         "point tiles": {"traversal": "tiles"}}
KERNELS = ("nng_tile", "eps_count")


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


def child(root: Path, calls: list, kernels: bool) -> None:
    """One run of the calls with the sources under ``root``; prints one
    JSON line."""
    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.data import synthetic_pointset
    from repro_torch.nng import build_nng
    pts = synthetic_pointset(N, DIM, seed=SEED)
    mesh = make_nng_mesh(NRANKS)
    out = {}
    for label in calls:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = build_nng(pts, EPS, mesh=mesh, k_cap=K_CAP, **CALLS[label])
        wall = time.perf_counter() - t0
        out[label] = {
            "elapsed_s": g.stats.elapsed_s, "wall_s": wall,
            "peak_B": torch.cuda.max_memory_allocated(),
            "graph": hashlib.sha256(g.edge_key().tobytes()).hexdigest()[:16]}
        del g
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
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", default=",".join(CALLS),
                    help="comma-separated calls: " + ", ".join(CALLS))
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    calls = [c.strip() for c in args.calls.split(",") if c.strip()]
    if any(c not in CALLS for c in calls):
        ap.error(f"--calls: not among {', '.join(CALLS)}: {args.calls}")
    if args.child is not None:
        child(args.child, calls, args.kernels)
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
                               + (["--kernels"] if args.kernels else []),
                               capture_output=True, text=True, cwd=roots[side])
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            res = json.loads(r.stdout.strip().splitlines()[-1])
            runs[side].append(res)
            print(f"round {rnd} {side}: " + "; ".join(
                f"{k} elapsed_s {res[k]['elapsed_s']:.3f} wall "
                f"{res[k]['wall_s']:.3f} peak {res[k]['peak_B']} B"
                for k in calls) + "".join(
                f"; {k} {ms:.3f} ms" for k, ms in res.get(
                    "kernels", {}).items()), flush=True)
    summary = {side: {label: statistics.median(r[label]["elapsed_s"]
                                               for r in side_runs)
                      for label in calls}
               for side, side_runs in runs.items()}
    kernel_ms = {side: {k: statistics.median(r["kernels"][k]
                                             for r in side_runs)
                        for k in KERNELS}
                 for side, side_runs in runs.items() if args.kernels}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"median elapsed_s: {json.dumps(summary)}")
    if kernel_ms:
        print(f"median kernel ms: {json.dumps(kernel_ms)}")
    print(smi)
    ok = all(len({r[label]["graph"] for side_runs in runs.values()
                  for r in side_runs}) == 1 for label in calls)
    print(json.dumps({"ok": ok, "median_elapsed_s": summary,
                      "median_kernel_ms": kernel_ms}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
