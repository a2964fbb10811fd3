"""The whole analysis: contracts, lints, the comm-byte audit, the
dead-module report and the cost model.

``run_analysis`` assembles the report dict the CLI serializes; every pass
adds to the flat ``diagnostics`` list that ``--check`` gates on (less the
suppression baseline).
"""
from __future__ import annotations

from pathlib import Path

from . import traffic
from .cache_key import cached_modules, lint_cache_keys
from .contracts import check_all
from .diagnostics import Diagnostic, load_baseline, split_baselined
from .kernel_cost import kernel_costs
from .lints import analysis_device
from .modgraph import lint_dead_modules

__all__ = ["run_analysis", "SRC_ROOT"]

SRC_ROOT = Path(__file__).resolve().parents[1]          # src/repro_torch


def run_analysis(*, audit: bool = True, costs: bool = True,
                 nranks: int = 8, device="cuda", baseline_path=None) -> dict:
    """Every pass on ``device`` ("cuda", the default: the kernels launch
    against their oracles and the audit's engines run on the card, and
    without a card it raises; "cpu": the oracles, and the wrappers on the
    fake card) -> the report."""
    device = analysis_device(device)
    diags: list[Diagnostic] = []
    contract_diags, contracts = check_all(device=device)
    diags += contract_diags
    cache_mods = cached_modules(SRC_ROOT)
    for mod in cache_mods:
        diags += lint_cache_keys(mod)
    dead = lint_dead_modules(SRC_ROOT)
    diags += dead
    traffic_table = {}
    if audit:
        traffic_diags, traffic_table = traffic.audit_all(nranks=nranks,
                                                         device=device)
        diags += traffic_diags
    baseline = load_baseline(baseline_path)
    fresh, known = split_baselined(diags, baseline)
    return {
        "device": str(device),
        "contracts": {
            "checked": [c.name for c in contracts],
            "violations": [d.to_json() for d in contract_diags],
        },
        "cache_keys": {"modules": [str(m.relative_to(SRC_ROOT.parent))
                                   for m in cache_mods]},
        "dead_modules": [d.subject for d in dead],
        "traffic": traffic_table,
        "kernel_costs": kernel_costs() if costs else [],
        "diagnostics": [d.to_json() for d in diags],
        "baselined": [d.to_json() for d in known],
        "fresh": [d.to_json() for d in fresh],
        "ok": not fresh,
    }
