"""RA301 — import-graph reachability over ``src/repro_torch`` (AST pass).

Builds the module-level import graph by parsing every file under the
package (no imports are executed) and reports modules unreachable from
the public entry points:

- ``repro_torch.nng`` (``build_nng``, ``delta_run``),
  ``repro_torch.stream`` (``OnlineNNG``), ``repro_torch.kernels.ops``
  (the distance-kernel API), ``repro_torch.launch.*`` (the CLI and the
  process launcher) and ``repro_torch.analysis.*`` (this analyzer);
- plus pseudo-roots for every ``repro_torch.*`` module that a script
  imports: ``examples/*.py`` and the scripts at the root of the checkout
  (``chip_smoke.py``, ``tree_ab.py``, ``ghost_ab.py``, ``l2_ablate.py``).

Test files are deliberately NOT roots: a module only its own test imports
is dead code. Keeping one anyway is a baseline entry, not a root.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .diagnostics import Diagnostic

__all__ = ["module_imports", "build_import_graph", "reachable",
           "dead_modules", "lint_dead_modules", "ENTRY_POINTS"]

ENTRY_POINTS = ("repro_torch.nng", "repro_torch.stream",
                "repro_torch.kernels.ops", "repro_torch.launch",
                "repro_torch.analysis")


def _module_name(path: Path, src_root: Path) -> str:
    # src_root is the package directory itself
    rel = path.relative_to(src_root).with_suffix("")
    parts = [src_root.name] + list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _longest_known(name: str, known: set) -> str | None:
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        cand = ".".join(parts[:k])
        if cand in known:
            return cand
    return None


def module_imports(path: Path, modname: str, known: set) -> set:
    """Modules from ``known`` that ``path`` imports (module-level or
    function-level; relative imports resolved against ``modname``)."""
    tree = ast.parse(path.read_text())
    pkg_parts = modname.split(".")
    out = set()

    def add(name: str):
        hit = _longest_known(name, known)
        if hit is not None:
            out.add(hit)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                add(a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[:len(pkg_parts) - node.level + 1] \
                    if path.name == "__init__.py" \
                    else pkg_parts[:len(pkg_parts) - node.level]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if mod:
                add(mod)
            # "from pkg import sub" where pkg.sub is itself a module
            for a in node.names:
                if mod:
                    add(f"{mod}.{a.name}")
    return out


def build_import_graph(src_root: Path) -> dict:
    files = {p: _module_name(p, src_root)
             for p in sorted(Path(src_root).rglob("*.py"))}
    known = set(files.values())
    graph = {}
    for p, mod in files.items():
        deps = module_imports(p, mod, known)
        # a module implicitly executes its ancestor packages' __init__
        parts = mod.split(".")
        for k in range(1, len(parts)):
            deps.add(".".join(parts[:k]))
        graph.setdefault(mod, set()).update(deps - {mod})
    # a package __init__ does NOT implicitly import its submodules: only
    # explicit imports count, which is the point of the pass
    return graph


def script_paths(repo_root: Path) -> list[Path]:
    """The scripts whose imports are roots: ``examples/*.py`` and the
    ``*.py`` files at the root of the checkout."""
    repo_root = Path(repo_root)
    ex = repo_root / "examples"
    return (sorted(ex.rglob("*.py")) if ex.is_dir() else []) + sorted(
        repo_root.glob("*.py"))


def _script_roots(repo_root: Path, known: set) -> set:
    roots = set()
    for p in script_paths(repo_root):
        try:
            tree = ast.parse(p.read_text())
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mod = node.module or ""
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            for name in names:
                hit = _longest_known(name, known)
                if hit is not None:
                    roots.add(hit)
    return roots


def reachable(graph: dict, roots: set) -> set:
    seen = set()
    stack = [r for r in roots if r in graph]
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(graph.get(m, set()) - seen)
    return seen


def dead_modules(src_root: Path, repo_root: Path | None = None,
                 entry_points=None) -> list:
    """The modules under ``src_root`` (a package directory) that no entry
    point and no script reaches. ``repo_root`` defaults to two levels up
    (``<repo>/src/<package>``); ``entry_points`` to the package's
    ``ENTRY_POINTS`` under its own name."""
    src_root = Path(src_root)
    repo_root = Path(repo_root) if repo_root else src_root.parent.parent
    graph = build_import_graph(src_root)
    if entry_points is None:
        entry_points = tuple(src_root.name + p[len("repro_torch"):]
                             for p in ENTRY_POINTS)
    roots = {m for m in graph
             if any(m == p or m.startswith(p + ".") for p in entry_points)}
    roots |= _script_roots(repo_root, set(graph))
    live = reachable(graph, roots)
    return sorted(m for m in graph if m not in live and m != src_root.name)


def lint_dead_modules(src_root: Path, repo_root: Path | None = None
                      ) -> list[Diagnostic]:
    return [Diagnostic(
        "RA301", m,
        f"module '{m}' is unreachable from the entry points "
        f"({', '.join(ENTRY_POINTS)}) and no example or root script "
        f"imports it")
        for m in dead_modules(src_root, repo_root)]
