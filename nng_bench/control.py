"""Readings that set a configuration's limit: the control's, and the
program's, on seeds of one cell at the cell's own size.

    python nng_bench/control.py --workload <cell> --seeds 11 12 13 \\
        [--program]

For each seed it takes the cell's points under the row permutation of the
window's first call (``points.call_perm``, call 0) and judges, over
every row, the control (the reference one step down in precision, or with
its closed ball broken for Hamming: ``reference.py``) in the program's place
against the reference; with ``--program`` also ``build_nng``'s graph of the
same points. It prints one JSON line a seed, then the largest program
reading and the smallest control reading. The benchmark's own runs do not
run the control. ``tests/test_nngbench_control.py`` runs this at a size the
CPU tests hold.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nng_bench import harness, points, reference, spec  # noqa: E402


def readings(cell: spec.Cell, seeds, program: bool, device="cuda",
             log=print) -> dict:
    """{"program": [...], "control": [...]} readings of the cell's
    configuration's compared number, one a seed."""
    cfg = cell.config
    dev = torch.device(device)
    X = points.make_points(cfg, dev)
    n = len(X)
    rows = np.arange(n)
    out = {"program": [], "control": []}
    build = mesh = None
    if program:
        from repro_torch.core.distributed import make_nng_mesh
        from repro_torch.nng import build_nng as build
        mesh = make_nng_mesh(cfg["nranks"], dev)
    hold = points.held_rows(cfg, cell.traffic)
    for seed in seeds:
        P = X[points.call_perm(n, seed, 0, dev, hold)]
        line = {"seed": seed}
        if program:
            g = build(P, cfg["eps"], metric=cfg["metric"], mesh=mesh,
                      **harness.build_kwargs(cell))
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            ref = reference.Reference(P, cfg["eps"], cfg["metric"])
            res = reference.judge_graph(ref, g.row_ptr, g.col_ids, rows)
            name, value = reference.reading(cfg["metric"], res)
            out["program"].append(value)
            line["program"] = res
            del g
        else:
            ref = reference.Reference(P, cfg["eps"], cfg["metric"])
        res = reference.judge_control(ref, rows)
        name, value = reference.reading(cfg["metric"], res)
        out["control"].append(value)
        line["control"] = res
        line["number"] = name
        log(json.dumps(line))
        del ref, P
        gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.load()
    out = readings(cell, args.seeds, args.program, "cuda")
    print(json.dumps({
        "workload": args.workload,
        "lower": max(out["program"]) if out["program"] else None,
        "upper": min(out["control"]), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
