"""The port's analyzer: kernel contracts, wrapper and engine lints, the
comm-byte audit, the dead-module report and the H100 cost model.

Run ``python -m repro_torch.analysis --check`` (``--device cpu`` without a
card) or import the passes directly. The names below load their modules
on first use, so importing the package costs nothing.
"""
from __future__ import annotations

_LAZY = {
    "Diagnostic": "diagnostics",
    "CODES": "diagnostics",
    "load_baseline": "diagnostics",
    "split_baselined": "diagnostics",
    "KernelContract": "contracts",
    "check_contract": "contracts",
    "check_all": "contracts",
    "default_contracts": "contracts",
    "lint_threshold": "lints",
    "lint_host_sync": "lints",
    "lint_f64": "lints",
    "lint_int_reductions": "lints",
    "lint_cache_keys": "cache_key",
    "lint_dead_modules": "modgraph",
    "dead_modules": "modgraph",
    "audit_config": "traffic",
    "audit_all": "traffic",
    "kernel_cost": "kernel_cost",
    "kernel_costs": "kernel_cost",
    "run_analysis": "report",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(name)
