"""The comm-byte audit (RA201/RA202), and RA102 over the same runs.

The reference's audit traces its engines' shard_map programs and derives
each channel's bytes from the collectives' operand shapes. The port's
exchanges run eagerly through ``core/distributed/comm.py``, whose
``mesh.stats`` counts the bytes of every rank-to-rank move per channel,
in-process moves included (a permute's payload a pair, an all-gather's
rows once, an all-to-all's send buffers, a broadcast once a receiving
rank). So the audit runs ``build_nng`` on ``RingMesh(nranks, device)`` for
the reference's nine configurations at its audit shapes (n 1024, dim 8,
eps 0.25, ``k_cap`` 64, the reference's clustered-but-mixed points) and
holds what moved to what ``RunStats.comm_bytes`` reports:

- RA201: bytes moved under no channel, or under a channel that the
  engine's ``comm_bytes`` lacks (traffic no formula models);
- RA202: in one engine run (the first, each grow, the steady re-run), a
  channel whose moved bytes differ from the formula at that run's plan,
  or bytes moved outside the engine runs.

A grow changes the plan (``k_cap``, the landmark capacities) and with it
the bytes, so each run is held to the formula at its own plan (the
engine's ``run_stats``); the call's ``comm_bytes`` is the last run's.
Every operator of a configuration's first engine run goes through
``lints.OpRecorder`` as well, for RA102 (a reduction to one int32 value;
the later runs repeat the first at another plan).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .diagnostics import Diagnostic
from .lints import OpRecorder, analysis_device, lint_int_reductions

__all__ = ["SYSTOLIC_CONFIGS", "LANDMARK_CONFIGS", "AUDIT_SHAPE",
           "audit_points", "audit_config", "audit_all", "classify_moves",
           "cross_check", "config_kwargs", "subject_of"]

AUDIT_SHAPE = dict(n=1024, dim=8, eps=0.25, k_cap=64)

SYSTOLIC_CONFIGS = (
    dict(traversal="tiles", overlap=True, prune=True),
    dict(traversal="tiles", overlap=False, prune=True),
    dict(traversal="tiles", overlap=True, prune=False),
    dict(traversal="tree", overlap=True, prune=True),
    dict(traversal="tree", overlap=False, prune=True),
)
LANDMARK_CONFIGS = (
    dict(traversal="tiles", ghost_mode="coll"),
    dict(traversal="tree", ghost_mode="coll"),
    dict(traversal="tiles", ghost_mode="ring"),
    dict(traversal="tree", ghost_mode="ring"),
)


def audit_points(n, dim, nranks, seed=0):
    """The reference audit's clustered-but-mixed layout: half the blocks
    tight (prunable against far blocks), half diffuse, so the tree's split
    ring gets a mixed forest/points schedule."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 1.0, (nranks, dim))
    spread = np.where(np.arange(nranks) % 2 == 0, 0.02, 0.6)
    pts = np.repeat(centers, n // nranks, axis=0) + \
        rng.normal(0.0, 1.0, (n, dim)) * np.repeat(spread,
                                                   n // nranks)[:, None]
    return pts.astype(np.float32)


def subject_of(cfg: dict) -> str:
    """The reference audit's subject for a configuration."""
    if "ghost_mode" in cfg:
        return (f"landmark[traversal={cfg['traversal']},"
                f"ghost={cfg['ghost_mode']}]")
    return (f"systolic[traversal={cfg['traversal']},"
            f"overlap={cfg['overlap']},prune={cfg['prune']}]")


def config_kwargs(cfg: dict) -> dict:
    """``build_nng``'s keywords for an audit configuration."""
    if "ghost_mode" in cfg:
        return dict(partition="spatial", **cfg)
    return dict(partition="point", **cfg)


def classify_moves(moved: dict, formula: dict, subject: str
                   ) -> list[Diagnostic]:
    """RA201 for every channel of ``moved`` (bytes per channel) that is
    None or that ``formula`` (``RunStats.comm_bytes``) lacks."""
    out = []
    for ch, nbytes in sorted(moved.items(), key=lambda kv: str(kv[0])):
        if ch is None:
            out.append(Diagnostic(
                "RA201", subject,
                f"{nbytes} bytes moved under no channel: traffic that no "
                f"RunStats formula counts"))
        elif ch not in formula:
            out.append(Diagnostic(
                "RA201", subject,
                f"{nbytes} bytes moved on channel '{ch}', which "
                f"RunStats.comm_bytes lacks ({sorted(formula)})"))
    return out


def cross_check(runs: list, subject: str, outside: dict | None = None
                ) -> list[Diagnostic]:
    """RA202: each engine run's (moved, formula) pair must agree on every
    channel the formula counts (zero-byte formula channels need no
    moves); ``outside`` are bytes moved outside the engine runs."""
    diags = []
    for i, (moved, formula) in enumerate(runs):
        chans = {k for k, v in formula.items() if v} | {
            k for k in moved if k in formula}
        for ch in sorted(chans):
            m, f = moved.get(ch, 0), formula.get(ch, 0.0)
            if float(m) != float(f):
                diags.append(Diagnostic(
                    "RA202", subject,
                    f"run {i}, channel '{ch}': moved {m} bytes, RunStats "
                    f"formula {f:.0f}"
                    + (f" (ratio {m / f:.4g})" if f else "")))
    for ch, m in sorted((outside or {}).items(), key=lambda kv: str(kv[0])):
        if m:
            diags.append(Diagnostic(
                "RA202", subject,
                f"{m} bytes moved on channel '{ch}' outside the engine "
                f"runs, where no RunStats formula counts them"))
    return diags


@contextlib.contextmanager
def _engine_runs(mesh, runs: list, recorder: OpRecorder):
    """While the block runs, every ``run`` of the two batch engines
    appends (bytes moved per channel in that run, the formula at that
    run's plan) to ``runs``; the first runs inside ``recorder``."""
    from repro_torch.nng import PointPartitionEngine, SpatialPartitionEngine
    saved = {cls: cls.run for cls in (PointPartitionEngine,
                                      SpatialPartitionEngine)}

    def spy(orig):
        def run(self, plan):
            before = dict(mesh.stats.moved)
            with recorder if not runs else contextlib.nullcontext():
                out = orig(self, plan)
            after = mesh.stats.moved
            moved = {k: v - before.get(k, 0) for k, v in after.items()
                     if v != before.get(k, 0)}
            runs.append((moved, self.run_stats(out, plan).comm_bytes))
            return out
        return run

    for cls, orig in saved.items():
        cls.run = spy(orig)
    try:
        yield runs
    finally:
        for cls, orig in saved.items():
            cls.run = orig


def audit_config(cfg: dict, *, nranks: int = 8, device="cuda",
                 shape: dict | None = None, seed: int = 0):
    """One configuration -> (diagnostics, its table row): ``build_nng`` on
    ``RingMesh(nranks, device)`` at the audit shape; the row holds the
    bytes moved per channel, ``comm_bytes``, the engine runs and each
    run's moved and modelled bytes."""
    from repro_torch.core.distributed import RingMesh
    from repro_torch.nng import build_nng
    sh = dict(AUDIT_SHAPE, **(shape or {}))
    subject = subject_of(cfg)
    mesh = RingMesh(nranks, analysis_device(device))
    pts = audit_points(sh["n"], sh["dim"], nranks, seed)
    runs: list = []
    rec = OpRecorder()
    with _engine_runs(mesh, runs, rec):
        g = build_nng(pts, sh["eps"], mesh=mesh, k_cap=sh["k_cap"],
                      **config_kwargs(cfg))
    moved = dict(mesh.stats.moved)
    in_runs: dict = {}
    for m, _ in runs:
        for k, v in m.items():
            in_runs[k] = in_runs.get(k, 0) + v
    outside = {k: v - in_runs.get(k, 0) for k, v in moved.items()}
    formula = g.stats.comm_bytes
    diags = classify_moves(moved, formula, subject)
    diags += cross_check(runs, subject, outside)
    diags += lint_int_reductions(rec, subject=subject)
    row = {"moved": {str(k): v for k, v in moved.items()},
           "comm_bytes": formula, "runs": len(runs),
           "replans": g.stats.replans, "edges": g.num_edges,
           "per_run": [{"moved": {str(k): v for k, v in m.items()},
                        "formula": f} for m, f in runs]}
    return diags, row


def audit_all(nranks: int = 8, device="cuda"):
    """The nine configurations -> (diagnostics, {subject: row})."""
    device = analysis_device(device)
    diags, table = [], {}
    for cfg in SYSTOLIC_CONFIGS + LANDMARK_CONFIGS:
        d, row = audit_config(cfg, nranks=nranks, device=device)
        diags += d
        table[subject_of(cfg)] = row
    return diags, table
