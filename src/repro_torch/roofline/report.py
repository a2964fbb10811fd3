"""Roofline report generator: results/dryrun/*.json -> markdown tables.

    python -m repro_torch.roofline.report [--out-dir results/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(out_dir: str = "results/dryrun"):
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def _fmt_t(x):
    return f"{x*1e3:.2f}ms" if x < 0.1 else f"{x:.3f}s"


def nng_table(cells) -> str:
    lines = [
        "| workload | mesh | algo | t_compute | t_memory | t_collective | "
        "bottleneck |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in cells:
        if r.get("shape") != "nng" or r["status"] != "OK":
            continue
        for algo in ("systolic", "landmark"):
            rf = r[algo]["roofline"]
            lines.append(
                f"| {r['arch']} | {r['mesh']} | {algo} | "
                f"{_fmt_t(rf['t_compute_s'])} | {_fmt_t(rf['t_memory_s'])} | "
                f"{_fmt_t(rf['t_collective_s'])} | **{rf['bottleneck']}** |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.roofline.report")
    ap.add_argument("--out-dir", default="results/dryrun")
    args = ap.parse_args(argv)
    print("## NNG workloads\n")
    print(nng_table(load_cells(args.out_dir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
