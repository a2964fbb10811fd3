#!/usr/bin/env python3
"""Time build_nng's tree calls in this checkout against another checkout.

    python3 tree_ab.py OTHER [--rounds 2]

OTHER is the root of another checkout, or of an unpacked ``git archive``
of one. Each round runs both, each in a fresh process, in the order other,
this, this, other: ``build_nng(traversal="tree")`` on chip_smoke.py's
smoke points (the ``nng-sift-1m`` stand-in, 2^20 x 128, seed 0, eps 2.98,
8 logical ranks, k_cap 1024: no grow) through the point partition and
through the spatial partition's ghost ring. Prints each run's
``elapsed_s``, call wall and peak device memory, the card's name and power
limit, and a last line of JSON; each call's graph must be the same in
every run. Needs one CUDA card.
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
CALLS = {"point tree": {}, "ring tree": {"partition": "spatial",
                                         "ghost_mode": "ring"}}


def child(root: Path) -> None:
    """One run of both calls with the sources under ``root``; prints one
    JSON line."""
    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.data import synthetic_pointset
    from repro_torch.nng import build_nng
    pts = synthetic_pointset(N, DIM, seed=SEED)
    mesh = make_nng_mesh(NRANKS)
    out = {}
    for label, kw in CALLS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g = build_nng(pts, EPS, mesh=mesh, traversal="tree", k_cap=K_CAP,
                      **kw)
        wall = time.perf_counter() - t0
        out[label] = {
            "elapsed_s": g.stats.elapsed_s, "wall_s": wall,
            "peak_B": torch.cuda.max_memory_allocated(),
            "graph": hashlib.sha256(g.edge_key().tobytes()).hexdigest()[:16]}
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child)
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
                                "--child", str(roots[side])],
                               capture_output=True, text=True, cwd=roots[side])
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            res = json.loads(r.stdout.strip().splitlines()[-1])
            runs[side].append(res)
            print(f"round {rnd} {side}: " + "; ".join(
                f"{k} elapsed_s {v['elapsed_s']:.3f} wall {v['wall_s']:.3f} "
                f"peak {v['peak_B']} B" for k, v in res.items()), flush=True)
    summary = {side: {label: statistics.median(r[label]["elapsed_s"]
                                               for r in side_runs)
                      for label in CALLS}
               for side, side_runs in runs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"median elapsed_s: {json.dumps(summary)}")
    print(smi)
    ok = all(len({r[label]["graph"] for side_runs in runs.values()
                  for r in side_runs}) == 1 for label in CALLS)
    print(json.dumps({"ok": ok, "median_elapsed_s": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
