"""The public NNG front-end: ``build_nng`` — "build me the ε-graph of these
points under this metric on this ring".

Two engines, each with every axis a keyword:

  - ``partition="point"`` (Algorithm 4, the systolic ring over point
    blocks) with both traversals: ``traversal="tiles"`` (fused bitmask
    distance tiles) and ``traversal="tree"`` (per-block cover trees, built
    on the card by default, traversed level by level);
  - ``partition="spatial"`` (Algorithms 5+6, the landmark engine): Voronoi
    cells over sampled centres, LPT-assigned to ranks, ε-ghosts exchanged
    as capacity-padded copies (``ghost_mode="coll"``, the default) or
    found by rotating each rank's compacted block around the ring with
    its Lemma-1 test as packed cell words (``"ring"``; ``"auto"`` picks by
    the exact byte models). Both traversals: ``"tiles"`` runs the cells'
    queries through the grouped tile (and the ghost tile on the ring),
    ``"tree"`` traverses per-cell cover forests (built on the card by
    default). Its capacities come from an exact counting pass
    (``planner="device"``, the default) or the numpy host pass
    (``planner="host"``).

Any registered metric runs: ``euclidean``, ``manhattan`` and ``hamming``
(numpy uint32 or int32 words) have CUDA kernels, and a user ``Metric``
with only ``cdist`` runs the generic path.

Both engines run under ONE plan → run → grow-on-overflow driver
(``drive``) behind the small ``Engine`` interface: the point engine grows
``k_cap``, the spatial engine doubles every ``LandmarkPlan`` capacity
(``grow_plan``). A third engine, ``DeltaEngine`` (``delta_run``), runs an
inserted batch against the per-rank forests for online maintenance
(``repro_torch.stream.OnlineNNG``). The result is a CSR ``NNGraph``
(symmetric adjacency + ``RunStats`` + provenance ``meta``).

Point counts that do not divide the ring are handled by duplicate-padding:
the first ``(-n) % nranks`` points are appended again. A duplicate row
changes no true distance, its extra edges reference ids >= n and are
dropped when the CSR is assembled, so exactness holds for ANY metric.

Everything runs on the CUDA card unless the caller passes
``device="cpu"`` (or a CPU mesh); without a card the default raises.

The mesh's ranks may span the processes of a ``torch.distributed`` group
(``make_nng_mesh``: inside one, the default is the world, one rank a
process). Every process is then handed the whole input, runs its own
ranks, and returns the same ``NNGraph``: the engines all-gather the
counters and overflow flags, ``drive`` decides to grow from them and
reports the slowest process's ``elapsed_s``, and the CSR is assembled on
every process from every rank's (src, dst) pairs.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.distributed import (DeviceForest, LandmarkPlan, comm,
                                          delta_bcast_bytes,
                                          delta_traverse_run,
                                          ghost_coll_bytes, ghost_ring_bytes,
                                          landmark_run, local_tables,
                                          make_nng_mesh,
                                          plan_landmark_device,
                                          plan_ring_schedule,
                                          resolve_ghost_mode, systolic_run)
from repro_torch.core.flat_tree import (build_block_forests,
                                        build_cell_forests,
                                        stack_device_forests)
from repro_torch.core.graph import (SENTINEL, NNGraph, RunStats,
                                    neighbor_pairs)
from repro_torch.core.landmark import (ghost_membership, lpt_assignment,
                                       select_centers)
from repro_torch.core.metrics import (Metric, get_metric,  # noqa: F401 (re-export)
                                      ieee_fp32, register_metric)

__all__ = ["build_nng", "delta_run", "drive", "DeltaEngine", "Engine",
           "PointPartitionEngine", "SpatialPartitionEngine", "grow_plan",
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
    mesh = None              # its RingMesh; None: one process
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
        """[(ids, nbrs), ...] SENTINEL-padded tables of the local ranks'
        rows, for the CSR (tensors on the engine's device)."""
        raise NotImplementedError

    def run_stats(self, out, plan) -> RunStats:
        raise NotImplementedError


def _wait(engine) -> None:
    """Wait for the engine's device's queued work (the reference's
    ``block_until_ready``: CUDA calls return before the card finishes),
    and on a mesh over processes for every process."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    if engine.mesh is not None:
        comm.barrier(engine.mesh)


def _timed_forest(engine: Engine, build, backend: str, *args) -> dict:
    """An engine's rank-stacked forest tables from ``build(points, *args,
    nranks, metric, ...)`` (``build_block_forests`` or
    ``build_cell_forests``): the torch builder on the mesh's device
    (``backend="device"``) or the float64 numpy oracle (``"host"``), as
    tensors on that device: the local ranks' rows (the torch builder
    builds only those; the host one builds every rank's). The build is
    timed into ``engine.build_s``."""
    t0 = time.perf_counter()
    mesh, met = engine.mesh, engine.metric
    if backend == "device":
        tabs = build(engine.points, *args, mesh.size, met, backend="device",
                     device=mesh.device, mesh=mesh)
    elif backend == "host":
        tabs = local_tables(stack_device_forests(build(
            engine.points.cpu().numpy(), *args, mesh.size, met.host)), mesh)
    else:
        raise ValueError(f"unknown forest_backend {backend!r} "
                         "(want 'device' or 'host')")
    tabs = {k: (met.as_device(v, mesh.device) if k == "coords"
                else torch.as_tensor(v, device=mesh.device))
            for k, v in tabs.items()}
    _wait(engine)
    engine.build_s = time.perf_counter() - t0
    return tabs


def drive(engine: Engine, max_grows: int = 8, *, steady_state: bool = True):
    """THE plan → run → grow-on-overflow loop.

    Returns (out, plan, replans, elapsed_s): the first non-overflowing
    outputs, the plan that produced them, how many grows it took, and the
    wall clock of that final configuration (on a mesh over processes, the
    slowest process's: every process returns the same). The overflow test
    reads every rank's flags, so every process grows alike. With
    ``steady_state`` (the default) the winner runs a second time and THAT
    wall clock is reported, so ``RunStats.elapsed_s`` never includes
    first-call costs (the kernels' build, allocator warm-up).

    ``steady_state=False`` skips the timing re-run and reports the first
    non-overflowing run's own wall clock: for callers that consume only
    the tables, or that report update latency (``delta_run``), where a
    second run buys nothing."""
    plan = engine.initial_plan()
    for attempt in range(max_grows):
        t0 = time.perf_counter()
        out = engine.run(plan)
        _wait(engine)
        elapsed = time.perf_counter() - t0
        if not engine.overflowed(out):
            if steady_state:
                del out      # free the first run's tables before the re-run
                t0 = time.perf_counter()
                out = engine.run(plan)
                _wait(engine)
                elapsed = time.perf_counter() - t0
            if engine.mesh is not None:
                elapsed = comm.all_max(engine.mesh, elapsed)
            return out, plan, attempt, elapsed
        plan = engine.grow(plan, out)
    raise RuntimeError(
        f"{engine.name} engine: overflow persists after {max_grows} grows "
        f"(last plan: {plan})")


# ---------------------------------------------------------------------------
# point partitioning (systolic ring, Algorithm 4)
# ---------------------------------------------------------------------------

def ring_comm_bytes(n: int, dim: int, itemsize: int, nranks: int,
                    k_cap: int, *, prune: bool, overlap: bool,
                    traversal: str = "tiles") -> dict:
    """Per-channel bytes of the point ring (Algorithm 4), summed over
    ranks for one run, from shapes alone (the reference's formulas; hop
    counts follow ``_systolic_local`` and, for ``traversal="tree"``, the
    tree flavours):

    - ``ring_mirror``: the visiting block's neighbour accumulator
      ((n_loc, k_cap) int32 ids + (n_loc,) counts) — ``rounds`` in-loop
      hops plus the final shift-``rounds`` return home;
    - ``ring_summary`` (``prune`` only): the one-shot block-summary
      all-gather — each rank contributes its (dim,) center plus the scalar
      radius;
    - ``ring_points``: the visiting block each hop — its point rows plus
      the int32 ``id0`` scalar. The double-buffered schedule
      (``overlap``) pays one extra priming hop. The tree flavour's block
      carries its (n_loc,) id vector instead of ``id0`` and makes exactly
      ``rounds`` hops on either schedule.

    ``n`` is the padded point count (a multiple of ``nranks``). The tree
    flavour's ``ring_forest`` needs the built forest: the engine adds it."""
    if n % nranks:
        raise ValueError(f"n={n} is not a multiple of the ring size "
                         f"{nranks}")
    rounds = nranks // 2
    if rounds == 0:
        return {"ring_points": 0.0, "ring_mirror": 0.0}
    n_loc = n // nranks
    mirror_hop = n_loc * k_cap * 4 + n_loc * 4
    out = {"ring_mirror": float(nranks * (rounds + 1) * mirror_hop)}
    if prune:
        out["ring_summary"] = float(nranks * (dim * itemsize + 4))
    if traversal == "tree":
        hops, id_bytes = rounds, n_loc * 4
    else:
        hops, id_bytes = (rounds + 1 if overlap else rounds), 4
    out["ring_points"] = float(nranks * hops
                               * (n_loc * dim * itemsize + id_bytes))
    return out


def landmark_comm_bytes(n: int, dim: int, itemsize: int, nranks: int,
                        plan: LandmarkPlan, ghost_mode: str) -> dict:
    """Per-channel bytes of the landmark engine's exchanges (Algorithms
    5+6), summed over ranks for one run, from shapes and the plan alone.
    ``coalesce`` moves three (nranks, cap_coal, …) all-to-all operands per
    rank — point rows, global ids, cell assignments. The ghost channel
    follows ``ghost_mode`` as ``resolve_ghost_mode`` resolves it: ``ghost``
    (the capacity-padded all-to-all of ghost copies, ``ghost_coll_bytes``)
    or ``ghost_ring`` (the rotation of the compacted blocks,
    ``ghost_ring_bytes``). ``n`` is the padded point count (a multiple of
    ``nranks``)."""
    if n % nranks:
        raise ValueError(f"n={n} is not a multiple of the ring size "
                         f"{nranks}")
    row_bytes = itemsize * dim + 4 + 4   # pts + id + cell
    out = {"coalesce": float(nranks * nranks * plan.cap_coal * row_bytes)}
    if resolve_ghost_mode(ghost_mode, plan, dim, itemsize, nranks) == "ring":
        out["ghost_ring"] = float(ghost_ring_bytes(
            nranks, plan.cap_rank, dim, itemsize, plan.m_centers))
    else:
        out["ghost"] = float(ghost_coll_bytes(nranks, plan.cap_ghost, dim,
                                              itemsize))
    return out


class PointPartitionEngine(Engine):
    name = "point"

    def __init__(self, points, eps, mesh, metric, *, k_cap: int = 64,
                 prune: bool = True, overlap: bool = True,
                 traversal: str = "tiles", forest: dict | None = None,
                 forest_backend: str = "device"):
        self.metric = get_metric(metric)
        self.mesh = mesh
        self.device = mesh.device
        self.points = self.metric.as_device(points, mesh.device)
        self.eps = float(eps)
        self.k_cap = int(k_cap)
        self.prune = prune
        self.overlap = bool(overlap)
        self.traversal = traversal
        self.forest_backend = forest_backend
        self.build_s = 0.0
        if traversal == "tree":
            forest = (_timed_forest(self, build_block_forests, forest_backend)
                      if forest is None else local_tables(forest, mesh))
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
        return max(2 * k_cap, comm.all_max(self.mesh, int(out[1].max())))

    def neighbor_tables(self, out):
        nbrs = out[0]
        first = self.mesh.local_ranks[0] * (len(self.points) // self.mesh.size)
        return [(torch.arange(first, first + len(nbrs), device=nbrs.device),
                 nbrs)]

    def _ring_comm_bytes(self, k_cap: int) -> dict:
        """Per-channel ring bytes of this engine's run: ``ring_comm_bytes``
        of its shapes, and for the tree flavour ``ring_forest``, the
        levelized forest tables: every hop on the serial schedule, one jump
        per "forest" round on the split schedule (a jump costs one hop's
        bytes however far it goes)."""
        nranks = self.mesh.size
        n, dim = self.points.shape
        bytes_ = ring_comm_bytes(n, dim, self.points.element_size(), nranks,
                                 k_cap, prune=self.prune,
                                 overlap=self.overlap,
                                 traversal=self.traversal)
        rounds = nranks // 2
        if self.traversal != "tree" or rounds == 0:
            return bytes_
        # the tables hold the local ranks', each rank's the same size
        forest_hop = sum(v.numel() * v.element_size()
                         for v in self.forest.values()
                         ) / self.forest["cell"].shape[0]
        if self.overlap:
            fhops = sum(m == "forest" for m in self.ring_schedule)
        else:
            fhops = rounds
        bytes_["ring_forest"] = float(nranks * fhops * forest_hop)
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
# spatial partitioning (Voronoi landmarks + ε-ghosts, Algorithms 5 + 6)
# ---------------------------------------------------------------------------

def grow_plan(plan: LandmarkPlan) -> LandmarkPlan:
    """Double every capacity knob of a LandmarkPlan (overflow re-plan)."""
    return LandmarkPlan(
        m_centers=plan.m_centers,
        cap_coal=2 * plan.cap_coal,
        cap_ghost=2 * plan.cap_ghost,
        g_per_pt=min(2 * plan.g_per_pt, plan.m_centers),
        k_cap=2 * plan.k_cap,
        cap_rank=max(2 * plan.cap_rank, 32) if plan.cap_rank else 0,
    )


class SpatialPartitionEngine(Engine):
    name = "spatial"

    def __init__(self, points, eps, mesh, metric, *, k_cap: int = 128,
                 planner: str = "device", m_centers: int | None = None,
                 traversal: str = "tiles", centers=None, f=None, cell=None,
                 plan: LandmarkPlan | None = None, forest=None,
                 seed: int = 0, ghost_mode: str = "coll",
                 forest_backend: str = "device"):
        if ghost_mode not in ("coll", "ring", "auto"):
            raise ValueError(f"unknown ghost_mode {ghost_mode!r} "
                             "(want 'coll', 'ring' or 'auto')")
        self.metric = get_metric(metric)
        self.mesh = mesh
        self.device = mesh.device
        self.points = self.metric.as_device(points, mesh.device)
        self.eps = float(eps)
        self.k_cap = int(k_cap)
        self.planner = planner
        self.traversal = traversal
        self.plan = plan
        self.ghost_mode = ghost_mode
        self.build_s = 0.0
        nranks = mesh.size
        if centers is None:
            m = m_centers or max(2 * nranks, 32)
            idx = select_centers(len(self.points), m,
                                 np.random.default_rng(seed))
            centers = self.points[torch.as_tensor(idx, device=mesh.device)]
        self.centers = self.metric.as_device(centers, mesh.device)
        self.m_centers = len(self.centers)
        # the host (n x m) Voronoi argmin (the host metric's cdist, as the
        # reference's) feeds the LPT assignment, the host planner and the
        # tree flavour's cell forests; callers that give (f, plan) for the
        # tiles flavour skip it
        if cell is None and (f is None or traversal == "tree"
                             or (plan is None and planner == "host")):
            cell = np.argmin(self.metric.host.cdist(
                self._host_points(), self.centers.cpu().numpy()), axis=1)
        self.cell = None if cell is None else np.asarray(cell)
        if f is None:
            f = lpt_assignment(
                np.bincount(self.cell, minlength=self.m_centers), nranks)
        self.f = np.asarray(f, np.int32)
        if traversal == "tree" and forest is None:
            # the cell forests once per engine: the grow loop changes only
            # capacities
            forest = _timed_forest(self, build_cell_forests, forest_backend,
                                   self.cell, self.f)
        self.forest = (forest if forest is None
                       or isinstance(forest, DeviceForest) else
                       DeviceForest.from_tables(local_tables(forest, mesh),
                                                mesh.device))

    def _host_points(self) -> np.ndarray:
        return self.points.cpu().numpy()

    # -- planning -----------------------------------------------------------
    def _plan_host(self) -> LandmarkPlan:
        """Host numpy pass (float64 ghost bound — may undercount the
        engine's slacked test; the grow loop covers the gap)."""
        met = self.metric.host
        points = self._host_points()
        n = len(points)
        nranks = self.mesh.size
        m = self.m_centers
        if n % nranks != 0:
            raise ValueError(
                f"points are not shardable: n={n} is not divisible by the "
                f"ring size {nranks} — pad to a multiple (build_nng's "
                f"duplicate padding does this automatically)")
        dmat = np.asarray(met.true(met.cdist(points,
                                             self.centers.cpu().numpy())))
        d_pC = dmat[np.arange(n), self.cell]
        gmask = ghost_membership(dmat, self.cell, d_pC, self.eps)
        g_per_pt = int(gmask.sum(axis=1).max())
        # row-to-rank map of the block-sharded input: n // nranks rows each
        src_rank = np.repeat(np.arange(nranks), n // nranks)
        coal = np.zeros((nranks, nranks), np.int64)
        np.add.at(coal, (src_rank, self.f[self.cell]), 1)
        gsrc = np.repeat(src_rank, m).reshape(n, m)[gmask]
        gdst = np.broadcast_to(self.f[None, :], (n, m))[gmask]
        gcnt = np.zeros((nranks, nranks), np.int64)
        np.add.at(gcnt, (gsrc, gdst), 1)
        return LandmarkPlan(
            m_centers=m, cap_coal=int(coal.max()) + 8,
            cap_ghost=int(gcnt.max()) + 8, g_per_pt=max(g_per_pt, 1),
            k_cap=self.k_cap,
            cap_rank=int(coal.sum(axis=0).max()) + 8)

    def initial_plan(self) -> LandmarkPlan:
        if self.plan is not None:
            return self.plan
        if self.planner == "device":
            # one counting pass: exact coalesce / ghost capacities (the
            # tests the engine applies), so the common case never grows
            return plan_landmark_device(
                self.points, self.centers, self.f, self.eps, self.mesh,
                metric=self.metric, k_cap=self.k_cap)
        if self.planner == "host":
            return self._plan_host()
        raise ValueError(f"unknown planner {self.planner!r}")

    # -- engine steps -------------------------------------------------------
    def resolved_ghost_mode(self, plan: LandmarkPlan) -> str:
        """The mode this plan runs: ``"auto"`` resolves per plan from the
        exact byte models (``resolve_ghost_mode``), so a grown plan may
        flip the choice."""
        return resolve_ghost_mode(
            self.ghost_mode, plan, self.points.shape[1],
            self.points.element_size(), self.mesh.size)

    def run(self, plan):
        return landmark_run(
            self.points, self.eps, self.centers, self.f, self.mesh, plan,
            metric=self.metric, traversal=self.traversal,
            forest=self.forest, cell=self.cell,
            ghost_mode=self.resolved_ghost_mode(plan))

    def overflowed(self, out):
        return bool(out[6].any())

    def grow(self, plan, out):
        return grow_plan(plan)

    def neighbor_tables(self, out):
        # the engine's tables come as per-launch parts
        return [*zip(out[0], out[1]), *zip(out[3], out[4])]

    def _landmark_comm_bytes(self, plan: LandmarkPlan) -> dict:
        """Per-channel exchange bytes: ``landmark_comm_bytes`` of this
        engine's shapes and ghost mode."""
        n, dim = self.points.shape
        return landmark_comm_bytes(n, dim, self.points.element_size(),
                                   self.mesh.size, plan, self.ghost_mode)

    def run_stats(self, out, plan: LandmarkPlan) -> RunStats:
        # the (nranks,) fp32 counters summed as the reference sums them
        # (numpy, in fp32)
        total = [float(t.cpu().numpy().sum()) for t in out[7:11]]
        return RunStats(
            tiles_skipped=total[0], tiles_scheduled=total[1],
            dists_evaluated=total[2], nodes_pruned=total[3],
            comm_bytes=self._landmark_comm_bytes(plan),
        )


# ---------------------------------------------------------------------------
# delta traversal (online maintenance — repro_torch.stream's engine)
# ---------------------------------------------------------------------------

class DeltaEngine(Engine):
    """Query ONE inserted batch against the per-rank forests.

    The online-insert engine: instead of re-running a full ring or
    landmark schedule over the corpus, the batch goes to every rank and
    each rank traverses its local forest once, so the work scales with
    the batch's frontier, not with n. It shares ``drive``'s
    grow-on-overflow loop; the only plan knob is ``k_cap``.

    The batch is padded to the next power of two (at least 8) with
    copies of its first row under SENTINEL ids, as the reference pads it
    (there, against a retrace per batch size). The padded rows are
    traversed: they count in ``dists_evaluated`` and ``nodes_pruned``,
    and ``delta_bcast`` is sized by the padded count, so the counters
    equal the reference's; their hits drop with their SENTINEL ids."""

    name = "delta"

    def __init__(self, batch_points, batch_ids, forest, eps, mesh, metric,
                 *, k_cap: int = 64):
        self.metric = get_metric(metric)
        self.mesh = mesh
        self.device = mesh.device
        self.eps = float(eps)
        self.k_cap = int(k_cap)
        self.forest = (forest if isinstance(forest, DeviceForest) else
                       DeviceForest.from_tables(local_tables(forest, mesh),
                                                mesh.device))
        qp = self.metric.as_device(batch_points, mesh.device)
        ids = torch.as_tensor(np.asarray(batch_ids, np.int64),
                              device=mesh.device)
        if len(qp) != len(ids) or len(qp) == 0:
            raise ValueError(f"a batch of {len(qp)} points and {len(ids)} "
                             "ids (want as many, at least one)")
        m = 8
        while m < len(qp):
            m *= 2
        pad = m - len(qp)
        self.qp = torch.cat([qp, qp[:1].expand((pad,) + qp.shape[1:])])
        self.qids = torch.cat([ids, torch.full((pad,), SENTINEL,
                                               dtype=torch.int64,
                                               device=mesh.device)])

    def initial_plan(self):
        return self.k_cap

    def run(self, k_cap):
        return delta_traverse_run(self.qp, self.qids, self.forest, self.eps,
                                  self.mesh, metric=self.metric, k_cap=k_cap)

    def overflowed(self, out):
        # cnt is exact even on overflow (popcount of the full bitmask)
        return bool(comm.all_max(self.mesh, int(
            (out[1] > out[0].shape[1]).any())))

    def grow(self, k_cap, out):
        return max(2 * k_cap, comm.all_max(self.mesh, int(out[1].max())))

    def neighbor_tables(self, out):
        return [(self.qids.repeat(len(self.mesh.local_ranks)), out[0])]

    def run_stats(self, out, k_cap) -> RunStats:
        # the (nranks,) fp32 counters summed as the reference sums them
        # (numpy, in fp32)
        m, dim = self.qp.shape[0], self.qp.shape[1]
        return RunStats(
            dists_evaluated=float(out[2].cpu().numpy().sum()),
            nodes_pruned=float(out[3].cpu().numpy().sum()),
            comm_bytes={"delta_bcast": float(delta_bcast_bytes(
                self.mesh.size, m, dim, self.qp.element_size()))},
        )


@ieee_fp32()
def delta_run(batch_points, batch_ids, forest, eps, mesh, *,
              metric="euclidean", k_cap: int = 64, max_grows: int = 8):
    """Directed new-edge pairs of an inserted batch against the current
    forests (the rank-stacked tables, a dict or a ``DeviceForest``).

    Runs ``DeltaEngine`` under ``drive(..., steady_state=False)`` — the
    update's latency is what the online path reports, so the winner runs
    once — and flattens the rank-stacked neighbour tables to (src, dst)
    directed id pairs (host numpy int64) plus a ``RunStats``. Symmetrize
    downstream (``NNGraph.delta_add_edges`` canonicalizes): a pair inside
    the batch appears from both endpoints. On a mesh over processes the
    batch is rank 0's, and every process returns every rank's pairs.

    The call runs with IEEE fp32 products (``ieee_fp32``): it sets the
    process-wide float32 matmul precision and TF32 flags and restores
    them on return, so it is not safe against threads that want other
    settings at the same time."""
    engine = DeltaEngine(batch_points, batch_ids, forest, eps, mesh, metric,
                         k_cap=k_cap)
    out, plan, replans, elapsed = drive(engine, max_grows=max_grows,
                                        steady_state=False)
    stats = engine.run_stats(out, plan)
    stats.replans = replans
    stats.elapsed_s = elapsed
    [(ids, nbrs)] = engine.neighbor_tables(out)
    ii, kk = torch.nonzero((nbrs != SENTINEL) & (ids != SENTINEL)[:, None],
                           as_tuple=True)
    return (comm.gather_rows(mesh, ids[ii]).cpu().numpy(),
            comm.gather_rows(mesh, nbrs[ii, kk].long()).cpu().numpy(),
            stats)


# ---------------------------------------------------------------------------
# the public entry point
# ---------------------------------------------------------------------------

@ieee_fp32()
def build_nng(
    points,
    eps: float,
    *,
    metric="euclidean",
    partition: str = "point",
    traversal: str = "tiles",
    planner: str = "device",
    mesh=None,
    k_cap: int | None = None,
    prune: bool = True,
    m_centers: int | None = None,
    seed: int = 0,
    max_grows: int = 8,
    overlap: bool = True,
    forest_backend: str = "device",
    ghost_mode: str = "coll",
    device=None,
) -> NNGraph:
    """Build the exact ε-neighbour graph of ``points`` (numpy or torch,
    (n, d)) under ``metric`` on ``mesh``. Returns a CSR ``NNGraph``.

    ``mesh`` defaults to ``make_nng_mesh()`` on ``device``: inside a
    ``torch.distributed`` process group the world, one rank a process
    (every process calls with the same arguments and gets the same
    graph), else one rank. ``device`` defaults to the CUDA card
    (``cuda:LOCAL_RANK`` in a group; a ``RuntimeError`` if there is none);
    pass ``device="cpu"`` for the plain PyTorch versions. ``k_cap`` seeds
    the neighbour-list capacity (grown automatically on overflow); any
    ``n`` is accepted (duplicate padding up to the ring size, stripped
    from the result).

    Point partition: ``overlap`` selects the double-buffered ring schedule
    — ``False`` is the strict rotate-then-evaluate schedule, kept for A/B
    comparison. ``forest_backend`` ("device", the default, or "host") picks
    who builds the cover forest for ``traversal="tree"``: the torch builder
    on the mesh's device (``flat_tree_device``) or the float64 numpy
    oracle; the build is timed apart, in ``RunStats.build_s``.

    Spatial partition (the landmark engine): ``m_centers`` Voronoi sites
    (default max(2·nranks, 32)) drawn from ``seed``; ``planner`` "device"
    (exact counting pass, the default) or "host" (numpy pass); the
    capacities double on overflow. ``ghost_mode`` "coll" (capacity-padded
    all-to-all of ghost copies, the default), "ring" (the compacted block
    rotates with its Lemma-1 test as packed cell words; no ghost copies)
    or "auto" (per plan, from the exact byte models; the resolved mode
    lands in ``meta["ghost_mode"]``). With ``traversal="tree"`` the cells'
    cover forests are built once, on the card or (``forest_backend=
    "host"``) by the float64 numpy oracle, timed in ``RunStats.build_s``.

    The call runs with IEEE fp32 products whatever the process's matmul
    precision (``ieee_fp32``): it sets the process-wide float32 matmul
    precision and TF32 flags and restores them on return, so it is not
    safe against threads that want other settings at the same time.

    ``drive`` re-runs the winning plan (``steady_state=True``), so
    ``RunStats.elapsed_s`` is a steady-state run's wall clock."""
    if partition not in ("point", "spatial"):
        raise ValueError(
            f"unknown partition {partition!r} (want 'point' or 'spatial')")
    if traversal not in ("tiles", "tree"):
        raise ValueError(
            f"unknown traversal {traversal!r} (want 'tiles' or 'tree')")
    met = get_metric(metric)
    if mesh is None:
        mesh = make_nng_mesh(None, device)
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device!r} differs from the mesh's "
                         f"{mesh.device}")
    points = met.as_device(points, mesh.device)
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

    if partition == "point":
        engine = PointPartitionEngine(
            points, eps, mesh, met, k_cap=k_cap or 64, prune=prune,
            overlap=overlap, traversal=traversal,
            forest_backend=forest_backend)
    else:
        engine = SpatialPartitionEngine(
            points, eps, mesh, met, k_cap=k_cap or 128, planner=planner,
            m_centers=m_centers, traversal=traversal, seed=seed,
            ghost_mode=ghost_mode, forest_backend=forest_backend)
    out, plan, replans, elapsed = drive(engine, max_grows=max_grows)
    stats = engine.run_stats(out, plan)
    stats.replans = replans
    stats.elapsed_s = elapsed
    stats.build_s = engine.build_s
    meta = {
        "metric": met.name, "eps": float(eps), "partition": partition,
        "traversal": traversal, "nranks": mesh.size, "padded": pad,
        "plan": plan,
    }
    if traversal == "tree":
        meta["forest_backend"] = forest_backend
    if partition == "point":
        meta["overlap"] = bool(overlap)
        if engine.ring_schedule is not None:
            meta["ring_schedule"] = tuple(engine.ring_schedule)
    else:
        meta["planner"] = planner
        meta["m_centers"] = engine.m_centers
        # the RESOLVED mode, never "auto": what the final plan ran
        meta["ghost_mode"] = engine.resolved_ghost_mode(plan)
    # every rank's pairs, on every process
    src, dst = neighbor_pairs(n, engine.neighbor_tables(out))
    return NNGraph.from_directed_pairs(n, comm.gather_rows(mesh, src),
                                       comm.gather_rows(mesh, dst), stats,
                                       meta)
