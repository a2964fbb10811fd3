"""RA110 — cache-key completeness of cached functions (AST pass).

A ``functools.lru_cache`` / ``functools.cache`` function's parameters ARE
its cache key. If its body reads module-level *mutable* state (a
lowercase module global assigned at module scope), two calls with equal
arguments can observe different results — a stale-cache bug that no
runtime test catches until the global actually changes. In the port that
is ``kernels/nng_tile.py``'s ``sm_count`` (the SM count a persistent
kernel sizes its grid from, per device index).

The pass is purely syntactic: for every cached function in a module,
compute the free names of its body (names read but never bound by
params, local assignments, nested defs/lambdas/comprehensions) and flag
any that resolve to a module-level lowercase assignment. Module-level
UPPER_CASE assignments, defs, classes and imports count as constants —
part of the program text, not runtime state. ``cached_modules`` finds the
modules of a package that hold a cached function.
"""
from __future__ import annotations

import ast
import builtins
from pathlib import Path

from .diagnostics import Diagnostic

__all__ = ["lint_cache_keys", "cached_modules"]


def _is_cache_decorator(dec) -> bool:
    # functools.lru_cache(...), lru_cache, functools.cache, cache
    target = dec.func if isinstance(dec, ast.Call) else dec
    if isinstance(target, ast.Attribute):
        return target.attr in ("lru_cache", "cache")
    if isinstance(target, ast.Name):
        return target.id in ("lru_cache", "cache")
    return False


def _module_bindings(tree: ast.Module):
    """-> (const_names, mutable_names): top-level defs/classes/imports and
    UPPER_CASE assigns are constants; lowercase top-level assigns are the
    mutable-state candidates."""
    const, mutable = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            const.add(node.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                const.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                const.add(a.asname or a.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        (const if n.id.upper() == n.id else mutable).add(n.id)
    return const, mutable


def _bound_names(fn: ast.FunctionDef) -> set:
    bound = set()
    a = fn.args
    for arg in (a.posonlyargs + a.args + a.kwonlyargs
                + ([a.vararg] if a.vararg else [])
                + ([a.kwarg] if a.kwarg else [])):
        bound.add(arg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node is not fn:
                bound.add(node.name)
            na = node.args
            for arg in (na.posonlyargs + na.args + na.kwonlyargs
                        + ([na.vararg] if na.vararg else [])
                        + ([na.kwarg] if na.kwarg else [])):
                bound.add(arg.arg)
        elif isinstance(node, ast.Lambda):
            na = node.args
            for arg in (na.posonlyargs + na.args + na.kwonlyargs
                        + ([na.vararg] if na.vararg else [])
                        + ([na.kwarg] if na.kwarg else [])):
                bound.add(arg.arg)
        elif isinstance(node, ast.comprehension):
            for n in ast.walk(node.target):
                if isinstance(n, ast.Name):
                    bound.add(n.id)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            bound.add(node.name)
    return bound


def _free_names(fn: ast.FunctionDef) -> set:
    bound = _bound_names(fn)
    free = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id not in bound and not hasattr(builtins, node.id):
                free.add(node.id)
    return free


def lint_cache_keys(module_path: str | Path) -> list[Diagnostic]:
    path = Path(module_path)
    tree = ast.parse(path.read_text())
    const, mutable = _module_bindings(tree)
    mutable -= const  # a name both def'd and assigned counts as const
    diags = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not any(_is_cache_decorator(d) for d in node.decorator_list):
            continue
        leaks = sorted(_free_names(node) & mutable)
        if leaks:
            diags.append(Diagnostic(
                "RA110", f"{path.name}:{node.name}",
                f"cached function reads module-level mutable state "
                f"{leaks} that is not part of its cache key — two calls "
                f"with equal arguments can observe different programs"))
    return diags


def cached_modules(src_root: str | Path) -> list[Path]:
    """The modules under ``src_root`` that decorate a function with
    ``lru_cache`` or ``cache``, in path order."""
    out = []
    for path in sorted(Path(src_root).rglob("*.py")):
        tree = ast.parse(path.read_text())
        if any(isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
               and any(_is_cache_decorator(d) for d in node.decorator_list)
               for node in ast.walk(tree)):
            out.append(path)
    return out
