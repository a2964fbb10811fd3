"""The public NNG front-end: ``build_nng`` — "build me the ε-graph of these
points under this metric on this ring".

The port carries ``partition="point"`` (Algorithm 4, the systolic ring
over point blocks) with both traversals: ``traversal="tiles"`` (fused
bitmask distance tiles) and ``traversal="tree"`` (per-block cover trees,
built on the card by default, traversed level by level). Any registered
metric runs (``euclidean`` has CUDA kernels; a user ``Metric`` with only
``cdist`` runs the generic path). ``partition="spatial"`` raises
``NotImplementedError`` until its ROADMAP item lands.

The engine runs under ONE plan → run → grow-on-overflow driver (``drive``)
behind the small ``Engine`` interface. The result is a CSR ``NNGraph``
(symmetric adjacency + ``RunStats`` + provenance ``meta``).

Point counts that do not divide the ring are handled by duplicate-padding:
the first ``(-n) % nranks`` points are appended again. A duplicate row
changes no true distance, its extra edges reference ids >= n and are
dropped when the CSR is assembled, so exactness holds for ANY metric.

Everything runs on the CUDA card unless the caller passes
``device="cpu"`` (or a CPU mesh); without a card the default raises.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.distributed import (DeviceForest, make_nng_mesh,
                                          plan_ring_schedule, systolic_run)
from repro_torch.core.flat_tree import (build_block_forests,
                                        stack_device_forests)
from repro_torch.core.graph import NNGraph, RunStats
from repro_torch.core.metrics import Metric, get_metric, register_metric  # noqa: F401 (re-export)

__all__ = ["build_nng", "drive", "Engine", "PointPartitionEngine",
           "Metric", "get_metric", "register_metric"]


# ---------------------------------------------------------------------------
# the Engine interface + the ONE re-plan driver
# ---------------------------------------------------------------------------

class Engine:
    """One distributed ε-NNG engine behind the shared driver.

    Implementations hold the problem (points, eps, mesh, metric, options)
    and expose: an initial capacity plan, one exact-or-overflowing run, the
    overflow predicate, the grow step, and result extraction."""

    name: str = "?"
    device: torch.device

    def initial_plan(self):
        raise NotImplementedError

    def run(self, plan):
        """One engine invocation under ``plan``; returns the raw outputs."""
        raise NotImplementedError

    def overflowed(self, out) -> bool:
        raise NotImplementedError

    def grow(self, plan, out):
        """A strictly larger plan after an overflow."""
        raise NotImplementedError

    def neighbor_tables(self, out):
        """[(ids, nbrs), ...] SENTINEL-padded tables for the CSR (tensors
        on the engine's device)."""
        raise NotImplementedError

    def run_stats(self, out, plan) -> RunStats:
        raise NotImplementedError


def _wait(device: torch.device) -> None:
    """Wait for the device's queued work (the reference's
    ``block_until_ready``): CUDA calls return before the card finishes."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(engine: Engine, max_grows: int = 8):
    """THE plan → run → grow-on-overflow loop.

    Returns (out, plan, replans, elapsed_s): the first non-overflowing
    outputs, the plan that produced them, how many grows it took, and the
    STEADY-STATE wall clock of that final configuration: the winner runs
    a second time and THAT wall clock is reported, so
    ``RunStats.elapsed_s`` never includes first-call costs (the kernels'
    build, allocator warm-up)."""
    plan = engine.initial_plan()
    for attempt in range(max_grows):
        t0 = time.perf_counter()
        out = engine.run(plan)
        _wait(engine.device)
        elapsed = time.perf_counter() - t0
        if not engine.overflowed(out):
            del out                # free the first run's tables before the re-run
            t0 = time.perf_counter()
            out = engine.run(plan)
            _wait(engine.device)
            return out, plan, attempt, time.perf_counter() - t0
        plan = engine.grow(plan, out)
    raise RuntimeError(
        f"{engine.name} engine: overflow persists after {max_grows} grows "
        f"(last plan: {plan})")


# ---------------------------------------------------------------------------
# point partitioning (systolic ring, Algorithm 4)
# ---------------------------------------------------------------------------

class PointPartitionEngine(Engine):
    name = "point"

    def __init__(self, points, eps, mesh, metric, *, k_cap: int = 64,
                 prune: bool = True, overlap: bool = True,
                 traversal: str = "tiles", forest: dict | None = None,
                 forest_backend: str = "device"):
        self.metric = get_metric(metric)
        self.mesh = mesh
        self.device = mesh.device
        self.points = torch.as_tensor(points).to(device=mesh.device,
                                                 dtype=self.metric.dtype)
        self.eps = float(eps)
        self.k_cap = int(k_cap)
        self.prune = prune
        self.overlap = bool(overlap)
        self.traversal = traversal
        self.forest_backend = forest_backend
        self.build_s = 0.0
        if traversal == "tree" and forest is None:
            t0 = time.perf_counter()
            if forest_backend == "device":
                forest = build_block_forests(
                    self.points, mesh.size, self.metric, backend="device",
                    device=mesh.device)
            elif forest_backend == "host":
                forest = stack_device_forests(build_block_forests(
                    self.points.cpu().numpy(), mesh.size, self.metric.host))
            else:
                raise ValueError(f"unknown forest_backend {forest_backend!r} "
                                 "(want 'device' or 'host')")
            forest = {k: torch.as_tensor(v, device=mesh.device)
                      for k, v in forest.items()}
            _wait(self.device)
            self.build_s = time.perf_counter() - t0
        self.forest = forest
        # the traversal's tables (with their child ranges) once per engine
        self.device_forest = (None if forest is None else
                              DeviceForest.from_tables(forest, mesh.device))
        # the split ring schedule is planned once per engine: the grow loop
        # changes only k_cap
        self.ring_schedule = None
        if traversal == "tree" and self.overlap:
            self.ring_schedule = plan_ring_schedule(
                self.points, mesh.size, self.eps, metric=self.metric,
                prune=self.prune)

    def initial_plan(self):
        return self.k_cap

    def run(self, k_cap):
        return systolic_run(
            self.points, self.eps, self.mesh, metric=self.metric,
            k_cap=k_cap, prune=self.prune, overlap=self.overlap,
            traversal=self.traversal, forest=self.device_forest,
            ring_schedule=self.ring_schedule)

    def overflowed(self, out):
        return bool(out[2].any())

    def grow(self, k_cap, out):
        # cnt is exact even on overflow: one grow always suffices
        return max(2 * k_cap, int(out[1].max()))

    def neighbor_tables(self, out):
        nbrs = out[0]
        return [(torch.arange(len(nbrs), device=nbrs.device), nbrs)]

    def _ring_comm_bytes(self, k_cap: int) -> dict:
        """Per-channel ring bytes, summed over ranks for the full run (the
        reference's formulas; hop counts follow the ring bodies):

        - ``ring_points``: the visiting block each hop — point rows plus
          the block-id payload (one int32 ``id0`` scalar on the tiles
          flavour, the (n_loc,) id vector on the tree flavour). Double
          buffering pays one extra priming hop on the tiles flavour; the
          tree flavours make exactly ``rounds`` point hops.
        - ``ring_forest`` (tree only): the levelized forest tables — every
          hop on the serial schedule, one jump per "forest" round on the
          split schedule (a jump costs one hop's bytes however far it
          goes).
        - ``ring_mirror``: the visiting block's neighbour accumulator
          ((n_loc, k_cap) ids + (n_loc,) counts) — ``rounds`` in-loop hops
          plus the final shift-``rounds`` return home.
        - ``ring_summary`` (prune only): the one-shot block-summary
          all-gather — each rank contributes its (dim,) center plus the
          scalar radius.
        """
        nranks = self.mesh.size
        rounds = nranks // 2
        if rounds == 0:
            return {"ring_points": 0.0, "ring_mirror": 0.0}
        n, dim = self.points.shape
        n_loc = n // nranks
        item = self.points.element_size()
        mirror_hop = n_loc * k_cap * 4 + n_loc * 4
        bytes_ = {"ring_mirror": float(nranks * (rounds + 1) * mirror_hop)}
        if self.prune:
            bytes_["ring_summary"] = float(nranks * (dim * item + 4))
        if self.traversal == "tree":
            pt_hop = n_loc * dim * item + n_loc * 4
            bytes_["ring_points"] = float(nranks * rounds * pt_hop)
            forest_hop = sum(v.numel() * v.element_size()
                             for v in self.forest.values()) / nranks
            if self.overlap:
                fhops = sum(m == "forest" for m in self.ring_schedule)
            else:
                fhops = rounds
            bytes_["ring_forest"] = float(nranks * fhops * forest_hop)
        else:
            pt_hop = n_loc * dim * item + 4
            hops = rounds + 1 if self.overlap else rounds
            bytes_["ring_points"] = float(nranks * hops * pt_hop)
        return bytes_

    def run_stats(self, out, k_cap) -> RunStats:
        nranks = self.mesh.size
        rounds = nranks // 2
        scheduled = nranks * (rounds + 1)
        if nranks % 2 == 0 and rounds > 0:
            scheduled -= nranks // 2      # halving round: one side per pair
        return RunStats(
            tiles_scheduled=float(scheduled),
            tiles_skipped=float(out[3].sum()),
            dists_evaluated=float(out[4].sum()),
            nodes_pruned=float(out[5].sum()),
            comm_bytes=self._ring_comm_bytes(k_cap),
        )


# ---------------------------------------------------------------------------
# the public entry point
# ---------------------------------------------------------------------------

def build_nng(
    points,
    eps: float,
    *,
    metric="euclidean",
    partition: str = "point",
    traversal: str = "tiles",
    mesh=None,
    k_cap: int | None = None,
    prune: bool = True,
    max_grows: int = 8,
    overlap: bool = True,
    forest_backend: str = "device",
    device=None,
) -> NNGraph:
    """Build the exact ε-neighbour graph of ``points`` (numpy or torch,
    (n, d)) under ``metric`` on ``mesh``. Returns a CSR ``NNGraph``.

    ``mesh`` defaults to one rank on ``device``, which defaults to the CUDA
    card (a ``RuntimeError`` if there is none); pass ``device="cpu"`` for
    the plain PyTorch versions. ``k_cap`` seeds the neighbour-list capacity
    (grown automatically on overflow); any ``n`` is accepted (duplicate
    padding up to the ring size, stripped from the result). ``overlap``
    selects the double-buffered ring schedule — ``False`` is the strict
    rotate-then-evaluate schedule, kept for A/B comparison.
    ``forest_backend`` ("device", the default, or "host") picks who builds
    the cover forest for ``traversal="tree"``: the torch builder on the
    mesh's device (``flat_tree_device``) or the float64 numpy oracle; the
    build is timed apart, in ``RunStats.build_s``."""
    if partition == "spatial":
        raise NotImplementedError(
            "partition='spatial' (the landmark engine, Algorithms 5+6) is "
            "not ported to PyTorch yet: ROADMAP item 7")
    if partition != "point":
        raise ValueError(
            f"unknown partition {partition!r} (want 'point' or 'spatial')")
    if traversal not in ("tiles", "tree"):
        raise ValueError(
            f"unknown traversal {traversal!r} (want 'tiles' or 'tree')")
    met = get_metric(metric)
    if mesh is None:
        mesh = make_nng_mesh(1, device)
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device!r} differs from the mesh's "
                         f"{mesh.device}")
    points = torch.as_tensor(points).to(device=mesh.device, dtype=met.dtype)
    n = len(points)
    if n == 0:
        return NNGraph(0, np.zeros(1, np.int64), np.zeros(0, np.int32),
                       meta={"metric": met.name, "eps": float(eps)})
    pad = (-n) % mesh.size
    if pad:
        # duplicate-pad by cycling the input — works even when pad > n
        # (tiny point sets on wide rings)
        idx = torch.arange(pad, device=points.device) % n
        points = torch.cat([points, points[idx]])

    engine = PointPartitionEngine(points, eps, mesh, met, k_cap=k_cap or 64,
                                  prune=prune, overlap=overlap,
                                  traversal=traversal,
                                  forest_backend=forest_backend)
    out, plan, replans, elapsed = drive(engine, max_grows=max_grows)
    stats = engine.run_stats(out, plan)
    stats.replans = replans
    stats.elapsed_s = elapsed
    stats.build_s = engine.build_s
    meta = {
        "metric": met.name, "eps": float(eps), "partition": partition,
        "traversal": traversal, "nranks": mesh.size, "padded": pad,
        "plan": plan, "overlap": bool(overlap),
    }
    if traversal == "tree":
        meta["forest_backend"] = forest_backend
    if engine.ring_schedule is not None:
        meta["ring_schedule"] = tuple(engine.ring_schedule)
    return NNGraph.from_neighbor_tables(
        n, engine.neighbor_tables(out), stats=stats, meta=meta)
