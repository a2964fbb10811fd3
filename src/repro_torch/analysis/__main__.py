"""CLI: ``python -m repro_torch.analysis [--check] [--out report.json]``.

Report mode prints the full JSON report; ``--check`` exits 1 when any
diagnostic is not covered by the suppression baseline (this package's
``baseline.json`` unless ``--baseline`` names another).
``--write-baseline`` accepts the current findings into a baseline file —
an explicit, reviewed action, never automatic. ``--device`` is where the
kernels and the audit's engines run: ``cuda`` (the default; raises without
a card) or ``cpu`` (the oracles, and the wrappers on a fake card).
"""
import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kernel contracts, wrapper and engine lints, the "
                    "comm-byte audit and the H100 cost model")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any diagnostic not in the baseline")
    ap.add_argument("--out", default=None,
                    help="write the JSON report to this path")
    ap.add_argument("--baseline", default=None,
                    help="suppression baseline path (default: the "
                         "package's baseline.json)")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write the current diagnostics to PATH as a "
                         "baseline")
    ap.add_argument("--no-traffic", action="store_true",
                    help="skip the comm-byte audit")
    ap.add_argument("--no-costs", action="store_true",
                    help="skip the per-kernel cost model")
    ap.add_argument("--nranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from .diagnostics import Diagnostic, write_baseline
    from .report import run_analysis

    report = run_analysis(audit=not args.no_traffic,
                          costs=not args.no_costs, nranks=args.nranks,
                          device=args.device, baseline_path=args.baseline)
    if args.write_baseline:
        diags = [Diagnostic(**d) for d in report["diagnostics"]]
        write_baseline(diags, args.write_baseline)
        print(f"wrote {len(diags)} baseline entries to "
              f"{args.write_baseline}", file=sys.stderr)
    text = json.dumps(report, indent=1, sort_keys=True, default=str)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(f"report written to {args.out}", file=sys.stderr)
    else:
        print(text)
    fresh, known = report["fresh"], report["baselined"]
    print(f"{len(report['diagnostics'])} diagnostic(s): {len(fresh)} fresh, "
          f"{len(known)} baselined", file=sys.stderr)
    for d in fresh:
        print(f"  {d['code']} [{d['subject']}] {d['message']}",
              file=sys.stderr)
    return 1 if args.check and fresh else 0


if __name__ == "__main__":
    sys.exit(main())
