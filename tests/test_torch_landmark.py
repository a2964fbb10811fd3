"""The port's landmark engine (``partition="spatial"``) against the JAX
reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference and the
port (``device="cpu"``: the plain PyTorch versions of the grouped tiles):
the host planning primitives, the engine's exchange helpers, the device
planner, and ``build_nng(partition="spatial")`` for all three metrics on
R ∈ {1, 2, 3, 5, 8} logical ranks with both planners.

Tolerances. Hamming is exact integer arithmetic: any eps, everything
equal. For the float metrics eps comes from ``landmark_safe_eps``: every
pair distance, and every Lemma-1 ghost threshold (tru − d(p, C) − slack) / 2
of every point against every centre of every ring size's centre draw, lies
at least 1e-4·eps from it in float64. Two fp32 evaluations (the port's
eager torch and the reference's XLA program) differ by a few rounding
units, far inside that, so the edge sets, the ghost sets, the plans and
the work counters must be equal. The counters, both ``comm_bytes``
channels, the plan and the meta must equal the reference's 8-device run.
"""
import dataclasses
import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import landmark as rland
from repro.core.distributed import device as rdev
from repro.core.distributed import make_nng_mesh as ref_mesh
from repro.nng import build_nng as ref_build_nng
from repro_torch.core import flat_tree as tft
from repro_torch.core import landmark as tland
from repro_torch.core.brute import brute_force_graph
from repro_torch.core.distributed import device as tdev
from repro_torch.core.distributed import make_nng_mesh
from repro_torch.core.graph import EpsGraph, NNGraph
from repro_torch.core.metrics import Metric, get_metric
from repro_torch.core.metrics_host import HostMetric, get_host_metric
from repro_torch.data import synthetic_pointset
from repro_torch.nng import SpatialPartitionEngine, build_nng, drive
from tests.helpers import run_subprocess
from tests.test_torch_kernels_gpu import as_words, pair_dists

METRICS = ["euclidean", "hamming", "manhattan"]
RANKS = [1, 2, 3, 5, 8]
N, SEED = 401, 13
U32 = 2.0 ** -24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engine runs many small torch ops a rank; on shared cores (the
    suite runs files in parallel workers) intra-op threads only add
    contention, so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(nranks):
    return make_nng_mesh(nranks, device="cpu")


def points(metric, n=N, seed=SEED):
    if metric == "hamming":
        return synthetic_pointset(n, 3, "hamming", seed=seed)
    return synthetic_pointset(n, 6, seed=seed)


def padded(pts, nranks):
    """The points as ``build_nng`` pads them for a ring of ``nranks``."""
    return np.concatenate([pts, np.resize(pts, ((-len(pts)) % nranks,)
                                          + pts.shape[1:])])


def landmark_safe_eps(pts, metric, target, ranks, rel=1e-4, knife=4,
                      m=32, seed=0, tree_ranks=()):
    """An eps near ``target`` that no decision of the landmark engine sits
    near, for every ring size in ``ranks``: every float64 pair distance,
    and every Lemma-1 threshold (tru[p, i] − d(p, C) − slack[p]) / 2 of the
    points as padded for that ring against that ring's ``m`` centres
    (``select_centers`` on the padded n; float64 distances, the engine's
    own fp32 slack), at least ``rel``·eps away; for euclidean also
    ``knife`` fp32 rounding units of the expansion's ‖x‖² + ‖y‖² (in d²)
    away. With ``tree_ranks``, also every d ± r of every point against
    every internal node of the cell forests that ring size's engine builds
    (the tree flavour's emit and expand tests; ``tree_safe_eps`` in
    ``test_torch_tree.py``), for euclidean widened by the fp32 error of d
    itself, which near d = 0 is the square root of d²'s. Hamming needs no gap: its distances and its
    zero-slack ghost and tree tests are exact integers."""
    if metric == "hamming":
        return float(target)
    x64 = pts.astype(np.float64)
    sq = (x64 * x64).sum(1)
    d = pair_dists(pts, pts, metric)
    # (value, half-width) of every decision, in distance units
    vals = [(d.ravel(), (sq[:, None] + sq[None, :]).ravel())]
    for r in ranks:
        x = padded(pts, r)
        centers = x[tland.select_centers(len(x), m,
                                         np.random.default_rng(seed))]
        tru = pair_dists(x, centers, metric)
        d_min = tru.min(1)
        bound = torch.from_numpy((d_min + 2 * target).astype(np.float32))
        slack = get_metric(metric).lemma1_slack(
            torch.from_numpy(x), torch.from_numpy(centers),
            torch.from_numpy(tru.astype(np.float32)), bound).double().numpy()
        xs = (x.astype(np.float64) ** 2).sum(1)
        cs = (centers.astype(np.float64) ** 2).sum(1)
        vals.append((((tru - d_min[:, None] - slack[:, None]) / 2).ravel(),
                     (xs[:, None] + cs[None, :]).ravel()))
    tree_vals = []
    for r in tree_ranks:
        x = padded(pts, r)
        eng = SpatialPartitionEngine(x, target, cpu_mesh(r), metric)
        tabs = tft.stack_device_forests(tft.build_cell_forests(
            x, eng.cell, eng.f, r, metric))
        xs = (x.astype(np.float64) ** 2).sum(1)
        for fr in range(r):
            inner = (tabs["cell"][fr] >= 0) & (tabs["leaf"][fr] == 0)
            ctr = tabs["coords"][fr][inner]
            rad = tabs["radius"][fr][inner].astype(np.float64)
            d = pair_dists(x, ctr, metric)
            # an fp32 d² is a few units of ‖x‖² + ‖c‖² off, so an fp32 d
            # is off by that over 2d, or by its square root near d = 0 (a
            # query at its own node's point)
            dd2 = knife * U32 * (xs[:, None]
                                 + (ctr.astype(np.float64) ** 2).sum(1))
            hd = np.minimum(np.sqrt(dd2), dd2 / np.maximum(2 * d, 1e-300))
            for v in (d + rad, d - rad):
                tree_vals.append((v.ravel(), hd.ravel()))
    v = np.concatenate([a for a, _ in vals])
    scale = np.concatenate([b for _, b in vals])
    half = rel * target + (knife * U32 * scale / (2 * target)
                           if metric == "euclidean" else 0.0 * scale)
    if tree_vals:
        v = np.concatenate([v] + [a for a, _ in tree_vals])
        half = np.concatenate([half] + [
            rel * target + (b if metric == "euclidean" else 0.0 * b)
            for _, b in tree_vals])
    near = np.abs(v - target) < 0.5 * target
    lo, hi = np.sort(v[near] - half[near]), np.sort(v[near] + half[near])
    # the uncovered points: a candidate c is safe iff no [lo, hi] holds it
    cand = np.concatenate([hi, lo]) + np.array([1e-12, -1e-12]).repeat(
        len(hi))
    cand = cand[np.abs(cand - target) < 0.5 * target]
    covered = (np.searchsorted(lo, cand, side="right")
               - np.searchsorted(hi, cand, side="left"))
    ok = cand[covered == 0]
    assert len(ok), "no landmark-safe eps near the target"
    return float(ok[np.argmin(np.abs(ok - target))])


TARGET = {"euclidean": 1.2, "manhattan": 2.5, "hamming": 30.0}
AUTO_M = 16     # euclidean at TARGET: with 16 centres the cells are large
               # and the ghosts few, so ghost_mode="auto" resolves to "coll"


def case_eps(metric, pts):
    return landmark_safe_eps(pts, metric, TARGET[metric], RANKS)


# ---------------------------------------------------------------------------
# the host planning primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,seed", [(401, 32, 0), (600, 16, 3), (20, 32, 1)])
def test_select_centers_matches_reference(n, m, seed):
    np.testing.assert_array_equal(
        tland.select_centers(n, m, np.random.default_rng(seed)),
        rland.select_centers(n, m, np.random.default_rng(seed)))


@pytest.mark.parametrize("metric", METRICS)
def test_engine_cells_and_ghosts_match_reference(metric):
    """The engine's host Voronoi cells, centres and LPT assignment equal
    the reference's ``voronoi_assign`` and ``lpt_assignment`` on the same
    seed, and ``ghost_membership`` equals the reference's on them."""
    pts = points(metric)
    eng = SpatialPartitionEngine(pts, 0.7, cpu_mesh(3), metric)
    centers = pts[rland.select_centers(N, 32, np.random.default_rng(0))]
    np.testing.assert_array_equal(eng.centers.numpy().view(centers.dtype),
                                  centers)
    rcell, rdist = rland.voronoi_assign(pts, centers, metric)
    np.testing.assert_array_equal(eng.cell, rcell)
    np.testing.assert_array_equal(
        eng.f, rland.lpt_assignment(np.bincount(rcell, minlength=32), 3))
    met = get_host_metric(metric)
    dmat = np.asarray(met.true(met.cdist(pts, centers)))
    np.testing.assert_array_equal(
        tland.ghost_membership(dmat, eng.cell, rdist, 0.7),
        rland.ghost_membership(dmat, rcell, rdist, 0.7))


@pytest.mark.parametrize("nranks", [1, 3, 8])
def test_lpt_assignment_matches_reference(nranks):
    sizes = np.random.default_rng(nranks).integers(0, 500, size=32)
    sizes[5] = sizes[9]                  # a tie: argsort order decides
    np.testing.assert_array_equal(tland.lpt_assignment(sizes, nranks),
                                  rland.lpt_assignment(sizes, nranks))


# ---------------------------------------------------------------------------
# the engine's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_lemma1_ghost_bound_matches_reference(metric):
    """The same (dpc, d_min) into both: tru and the bound equal for the
    exact metric and for L1 (the same fp32 operations). Euclidean: tru
    within 2 fp32 ulp (XLA's CPU square root is not correctly rounded:
    1 ulp apart on under 1% of these), the bound within 4 (its slack also
    sums ‖p‖² and ‖c‖² over the features, in each package's own order)."""
    pts = points(metric)
    centers = pts[rland.select_centers(N, 32, np.random.default_rng(0))]
    met = get_host_metric(metric)
    dpc = met.cdist(pts, centers).astype(np.float32)
    d_min = dpc.min(1)
    tru, bound = tdev._lemma1_ghost_bound(
        as_words(pts), as_words(centers), torch.from_numpy(dpc),
        torch.from_numpy(d_min), 2 * 0.9, get_metric(metric))
    rtru, rbound = rdev._lemma1_ghost_bound(
        jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(dpc),
        jnp.asarray(d_min), 2 * 0.9, metric)
    if metric == "euclidean":
        np.testing.assert_allclose(tru.numpy(), np.asarray(rtru),
                                   rtol=2 * 2 * U32, atol=0)
        np.testing.assert_allclose(bound.numpy(), np.asarray(rbound),
                                   rtol=4 * 2 * U32, atol=0)
        assert (bound.numpy() > np.asarray(rtru).min(1)).all()
    else:
        np.testing.assert_array_equal(tru.numpy(), np.asarray(rtru))
        np.testing.assert_array_equal(bound.numpy(), np.asarray(rbound))


@pytest.mark.parametrize("nranks,cap", [(1, 50), (3, 7), (8, 2), (5, 40)])
def test_pack_by_dest_matches_reference(nranks, cap):
    """Buffers (stable order within a destination, fills in the padding)
    and the dropped count, with some rows invalid and some past ``cap``."""
    rng = np.random.default_rng(nranks * 100 + cap)
    L = 60
    dest = rng.integers(0, nranks, size=L).astype(np.int32)
    valid = rng.random(L) > 0.2
    pts = rng.normal(size=(L, 4)).astype(np.float32)
    ids = rng.permutation(1000)[:L].astype(np.int32)
    cell = rng.integers(0, 32, size=L).astype(np.int32)
    ours, dropped = tdev._pack_by_dest(
        torch.from_numpy(dest), torch.from_numpy(valid),
        {"pts": (torch.from_numpy(pts), 0), "ids": (torch.from_numpy(ids),
                                                    tdev.SENTINEL),
         "cell": (torch.from_numpy(cell), -1)}, nranks, cap)
    ref, rdropped = rdev._pack_by_dest(
        jnp.asarray(dest), jnp.asarray(valid),
        {"pts": (jnp.asarray(pts), jnp.float32(0)),
         "ids": (jnp.asarray(ids), rdev.SENTINEL),
         "cell": (jnp.asarray(cell), jnp.int32(-1))}, nranks, cap)
    assert int(dropped) == int(rdropped)
    per_dest = np.bincount(dest[valid], minlength=nranks)
    assert int(dropped) == int(np.clip(per_dest - cap, 0, None).sum())
    for k in ("pts", "ids", "cell"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_cell_sort_matches_reference():
    rng = np.random.default_rng(5)
    cell = rng.integers(0, 9, size=300).astype(np.int32)
    cell[::4] = 3                       # many ties: the sort must be stable
    valid = rng.random(300) > 0.3
    ids = np.arange(300, dtype=np.int32)
    ours = tdev._cell_sort(torch.from_numpy(cell), torch.from_numpy(valid),
                           9, torch.from_numpy(ids), torch.from_numpy(cell))
    ref = rdev._cell_sort(jnp.asarray(cell), jnp.asarray(valid), 9,
                          jnp.asarray(ids), jnp.asarray(cell))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_all_to_all_block_order():
    """Rank r receives block r of every sender, in sender order."""
    sends = [torch.arange(3 * 2).reshape(3, 2) + 10 * s for s in range(3)]
    recv = tdev._all_to_all(sends)
    assert [t.tolist() for t in recv] == [
        [0, 1, 10, 11, 20, 21], [2, 3, 12, 13, 22, 23],
        [4, 5, 14, 15, 24, 25]]


@pytest.mark.parametrize("metric", METRICS)
def test_plan_landmark_device_matches_reference(metric):
    """One rank: the port's counting pass gives the reference's plan."""
    pts = points(metric)
    eps = case_eps(metric, pts)
    centers = pts[rland.select_centers(N, 32, np.random.default_rng(0))]
    f = np.zeros(32, np.int32)
    ours = tdev.plan_landmark_device(pts, centers, f, eps, cpu_mesh(1),
                                     metric=metric, k_cap=64)
    ref = rdev.plan_landmark_device(pts, centers, f, eps, ref_mesh(),
                                    metric=metric, k_cap=64)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.g_per_pt >= 1 and ours.cap_ghost > 8


def test_byte_models_and_auto_mode_match_reference():
    for nranks, cap_rank, cap_ghost, m in ((8, 300, 20, 32), (8, 300, 200, 40),
                                           (3, 0, 5, 32), (1, 50, 50, 32)):
        plan = tdev.LandmarkPlan(m, 40, cap_ghost, 4, 64, cap_rank)
        rplan = rdev.LandmarkPlan(m, 40, cap_ghost, 4, 64, cap_rank)
        assert tdev.ghost_coll_bytes(nranks, cap_ghost, 6, 4) == \
            rdev.ghost_coll_bytes(nranks, cap_ghost, 6, 4)
        assert tdev.ghost_ring_bytes(nranks, cap_rank, 6, 4, m) == \
            rdev.ghost_ring_bytes(nranks, cap_rank, 6, 4, m)
        assert tdev.resolve_ghost_mode("auto", plan, 6, 4, nranks) == \
            rdev.resolve_ghost_mode("auto", rplan, 6, 4, nranks)


# ---------------------------------------------------------------------------
# the slice: build_nng(partition="spatial")
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=METRICS)
def case(request):
    """Points, a landmark-safe eps, the float64 oracle, and the
    reference's graphs on one JAX device for both planners."""
    metric = request.param
    pts = points(metric)
    eps = case_eps(metric, pts)
    oracle = brute_force_graph(pts, eps, metric)
    assert oracle.num_edges > 2000
    refs = {pl: ref_build_nng(pts, eps, metric=metric, partition="spatial",
                              planner=pl) for pl in ("device", "host")}
    return metric, pts, eps, oracle, refs


@pytest.mark.parametrize("nranks", RANKS)
@pytest.mark.parametrize("planner", ["device", "host"])
def test_spatial_build_nng_matches_brute_and_reference(case, nranks,
                                                       planner):
    metric, pts, eps, oracle, refs = case
    g = build_nng(pts, eps, metric=metric, partition="spatial",
                  planner=planner, mesh=cpu_mesh(nranks))
    assert g == oracle
    np.testing.assert_array_equal(g.edge_key(), refs[planner].edge_key())
    assert g.meta["partition"] == "spatial" and g.meta["planner"] == planner
    assert g.meta["nranks"] == nranks and g.meta["padded"] == (-N) % nranks
    assert g.meta["m_centers"] == 32 and g.meta["ghost_mode"] == "coll"
    st = g.stats
    assert 0 <= st.tiles_skipped <= st.tiles_scheduled
    assert st.dists_evaluated > 0 and st.nodes_pruned == 0
    assert set(st.comm_bytes) == {"coalesce", "ghost"}
    if nranks == 1:
        # one rank: the reference's own run, counters and plan included
        ref = refs[planner]
        assert dataclasses.asdict(g.meta["plan"]) == \
            dataclasses.asdict(ref.meta["plan"])
        for field in ("tiles_scheduled", "tiles_skipped", "dists_evaluated",
                      "nodes_pruned", "comm_bytes", "replans"):
            assert getattr(st, field) == getattr(ref.stats, field), field


COMBOS = [("coll", "tree"), ("ring", "tiles"), ("ring", "tree")]


@pytest.fixture(scope="module", params=METRICS)
def mode_case(request):
    """Points, an eps that is landmark-safe at every ring size and also
    tree-safe over the one-rank cell forests, the float64 oracle, and the
    reference's one-device graphs for the ghost ring and the tree
    flavour."""
    metric = request.param
    pts = points(metric)
    eps = landmark_safe_eps(pts, metric, TARGET[metric], RANKS,
                            tree_ranks=[1])
    oracle = brute_force_graph(pts, eps, metric)
    refs = {c: ref_build_nng(pts, eps, metric=metric, partition="spatial",
                             ghost_mode=c[0], traversal=c[1])
            for c in COMBOS}
    return metric, pts, eps, oracle, refs


@pytest.mark.parametrize("nranks", RANKS)
@pytest.mark.parametrize("combo", COMBOS)
def test_spatial_ring_and_tree_match_brute_and_reference(mode_case, nranks,
                                                         combo):
    """The ghost ring (both traversals) and the tree flavour of the
    collective exchange: the float64 oracle's and the reference's edges
    at every ring size (even rings evaluate the boundary round on one
    side only); at one rank the reference's plan, counters, comm_bytes
    and meta."""
    metric, pts, eps, oracle, refs = mode_case
    mode, trav = combo
    g = build_nng(pts, eps, metric=metric, partition="spatial",
                  ghost_mode=mode, traversal=trav, mesh=cpu_mesh(nranks))
    ref = refs[combo]
    assert g == oracle
    np.testing.assert_array_equal(g.edge_key(), ref.edge_key())
    assert g.meta["ghost_mode"] == mode and g.meta["traversal"] == trav
    st = g.stats
    assert set(st.comm_bytes) == {"coalesce",
                                  "ghost_ring" if mode == "ring" else "ghost"}
    if trav == "tree":
        assert g.meta["forest_backend"] == "device" and st.build_s > 0
        assert st.tiles_scheduled == 0 and st.nodes_pruned > 0
    else:
        assert 0 < st.tiles_scheduled and st.nodes_pruned == 0
    if nranks == 1:
        assert set(g.meta) == set(ref.meta)
        for key in ref.meta:
            want = ref.meta[key]
            got = g.meta[key]
            if key == "plan":
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, key
        for field in ("tiles_scheduled", "tiles_skipped", "dists_evaluated",
                      "nodes_pruned", "comm_bytes", "replans"):
            assert getattr(st, field) == getattr(ref.stats, field), field


@pytest.mark.parametrize("nranks", [3, 8])
@pytest.mark.parametrize("trav", ["tiles", "tree"])
def test_spatial_ring_host_planner_and_forest(mode_case, nranks, trav):
    """The ghost ring under the host planner (its cap_rank), the tree
    flavour on the float64 host forests: still exact."""
    metric, pts, eps, oracle, refs = mode_case
    g = build_nng(pts, eps, metric=metric, partition="spatial",
                  ghost_mode="ring", traversal=trav, planner="host",
                  forest_backend="host", mesh=cpu_mesh(nranks))
    assert g == oracle
    np.testing.assert_array_equal(g.edge_key(),
                                  refs[("ring", trav)].edge_key())
    assert g.meta["planner"] == "host"
    assert g.meta.get("forest_backend") == ("host" if trav == "tree"
                                            else None)


@pytest.mark.parametrize("trav", ["tiles", "tree"])
@pytest.mark.parametrize("cause", ["cap_rank", "k_cap"])
def test_spatial_ring_overflow_grows(mode_case, cause, trav):
    """On the ring, valid coalesce rows past ``cap_rank`` and a count past
    ``k_cap`` set the flag; one grow doubles the plan and the graph is
    exact."""
    metric, pts, eps, oracle, _ = mode_case
    nranks = 3
    max_deg = int(np.bincount(np.concatenate([oracle.src, oracle.dst]),
                              minlength=N).max())
    run_pts = padded(pts, nranks)
    mesh = cpu_mesh(nranks)
    full = SpatialPartitionEngine(run_pts, eps, mesh, metric).initial_plan()
    small = {"cap_rank": full.cap_rank // 2 + 4,
             "k_cap": max_deg // 2 + 1}[cause]
    eng = SpatialPartitionEngine(run_pts, eps, mesh, metric, traversal=trav,
                                 ghost_mode="ring",
                                 plan=dataclasses.replace(full,
                                                          **{cause: small}))
    out, final, replans, _ = drive(eng)
    assert replans == 1
    assert getattr(final, cause) == 2 * small
    assert NNGraph.from_neighbor_tables(N, eng.neighbor_tables(out)) == oracle


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("cause", ["cap_coal", "cap_ghost", "g_per_pt",
                                   "k_cap"])
def test_spatial_overflow_grows(metric, cause):
    """Each overflow cause — coalesce rows past ``cap_coal``, ghost copies
    past ``cap_ghost``, ghost cells past ``g_per_pt``, a count past
    ``k_cap`` — sets the flag; the driver doubles the plan (one grow: each
    knob starts at half what this run needs, or just over) and the graph
    is still exact."""
    nranks = 3
    pts = points(metric)
    eps = case_eps(metric, pts)
    oracle = brute_force_graph(pts, eps, metric)
    max_deg = int(np.bincount(np.concatenate([oracle.src, oracle.dst]),
                              minlength=N).max())
    run_pts = padded(pts, nranks)
    mesh = cpu_mesh(nranks)
    full = SpatialPartitionEngine(run_pts, eps, mesh, metric).initial_plan()
    small = {"cap_coal": full.cap_coal // 2 + 4,
             "cap_ghost": full.cap_ghost // 2 + 4,
             "g_per_pt": (full.g_per_pt + 1) // 2,
             "k_cap": max_deg // 2 + 1}[cause]
    assert full.g_per_pt > 1 and max_deg > 2
    eng = SpatialPartitionEngine(run_pts, eps, mesh, metric,
                                 plan=dataclasses.replace(full,
                                                          **{cause: small}))
    out, final, replans, _ = drive(eng)
    assert replans == 1
    assert getattr(final, cause) == (min(2 * small, full.m_centers)
                                     if cause == "g_per_pt" else 2 * small)
    assert NNGraph.from_neighbor_tables(N, eng.neighbor_tables(out)) == oracle


def test_spatial_auto_ghost_mode():
    """``ghost_mode="auto"``: where the byte models pick the collective
    exchange it runs and reports "coll"; where they pick the ring (one
    rank: no hops) it runs the ring and reports "ring", with the
    reference's plan, counters and ``comm_bytes`` (the reference's run is
    on one device too). An unknown mode or traversal raises."""
    pts = points("euclidean")
    eps = landmark_safe_eps(pts, "euclidean", TARGET["euclidean"], [1, 8],
                            m=AUTO_M)
    oracle = brute_force_graph(pts, eps)
    g = build_nng(pts, eps, partition="spatial", ghost_mode="auto",
                  m_centers=AUTO_M, mesh=cpu_mesh(8))
    ref = ref_build_nng(pts, eps, partition="spatial", ghost_mode="auto",
                        m_centers=AUTO_M)
    assert g.meta["ghost_mode"] == "coll" and g.meta["m_centers"] == AUTO_M
    assert g == oracle
    np.testing.assert_array_equal(g.edge_key(), ref.edge_key())
    g1 = build_nng(pts, eps, partition="spatial", ghost_mode="auto",
                   m_centers=AUTO_M, mesh=cpu_mesh(1))
    assert g1.meta["ghost_mode"] == ref.meta["ghost_mode"] == "ring"
    assert g1 == oracle
    np.testing.assert_array_equal(g1.edge_key(), ref.edge_key())
    assert dataclasses.asdict(g1.meta["plan"]) == \
        dataclasses.asdict(ref.meta["plan"])
    for field in ("tiles_scheduled", "tiles_skipped", "dists_evaluated",
                  "nodes_pruned", "comm_bytes", "replans"):
        assert getattr(g1.stats, field) == getattr(ref.stats, field), field
    assert set(g1.stats.comm_bytes) == {"coalesce", "ghost_ring"}
    with pytest.raises(ValueError, match="ghost_mode"):
        build_nng(pts, eps, partition="spatial", ghost_mode="bogus",
                  device="cpu")
    with pytest.raises(ValueError, match="traversal"):
        build_nng(pts, eps, partition="spatial", traversal="bogus",
                  device="cpu")


def test_spatial_user_metric_generic_path():
    """A user metric with a host reference and a torch ``cdist`` only (no
    grouped kernel or plain tile, the generic Lemma-1 slack) runs the
    spatial engine through the generic path, exact against float64."""

    class HostChebyshev(HostMetric):
        name = "chebyshev"

        def cdist(self, x, y):
            return np.abs(np.asarray(x, np.float64)[:, None, :]
                          - np.asarray(y, np.float64)[None, :, :]).max(-1)

        def comparable(self, eps):
            return float(eps)

        def true(self, c):
            return np.asarray(c, np.float64)

    met = Metric(name="chebyshev", host=HostChebyshev(),
                 cdist=lambda x, y: (x[:, None, :] - y[None, :, :])
                 .abs().amax(-1))
    pts = points("euclidean", 150, 11)
    d = met.host.cdist(pts, pts)
    vals = np.sort(d[np.triu_indices(len(pts), 1)])
    k = int(len(vals) * 0.03)
    j = k + int(np.argmax(vals[k + 1:k + 800] - vals[k:k + 799]))
    eps = 0.5 * (vals[j] + vals[j + 1])
    ii, jj = np.nonzero(np.triu(d <= eps, 1))
    oracle = EpsGraph(len(pts), ii, jj)
    assert oracle.num_edges > 100
    for nranks in (1, 4):
        g = build_nng(pts, eps, metric=met, partition="spatial",
                      mesh=cpu_mesh(nranks), k_cap=16)
        assert g == oracle, nranks
        assert g.stats.tiles_skipped > 0


REF_8DEV = """
import dataclasses, hashlib, json, sys
import numpy as np
from repro.nng import build_nng
out = []
with np.load(sys.argv[1]) as f:
    for metric, planner, mode, trav in json.loads(sys.argv[2]):
        pts = f[metric]
        eps = float(f[("auto" if mode == "auto" else metric)
                      + ("_tree" if trav == "tree" else "") + "_eps"])
        g = build_nng(pts, eps, metric=metric, partition="spatial",
                      planner=planner, ghost_mode=mode, traversal=trav,
                      m_centers=16 if mode == "auto" else None)
        st = g.stats
        out.append({
            "plan": dataclasses.asdict(g.meta["plan"]), "edges": g.num_edges,
            "edge_sha": hashlib.sha256(g.edge_key().tobytes()).hexdigest(),
            "m_centers": g.meta["m_centers"],
            "ghost_mode": g.meta["ghost_mode"], "replans": st.replans,
            "forest_backend": g.meta.get("forest_backend"),
            "tiles_scheduled": st.tiles_scheduled,
            "tiles_skipped": st.tiles_skipped,
            "dists_evaluated": st.dists_evaluated,
            "nodes_pruned": st.nodes_pruned,
            "comm_bytes": st.comm_bytes})
print(json.dumps(out))
"""

N8 = 600
RUNS_8DEV = [("euclidean", "device", "coll", "tiles"),
             ("hamming", "device", "coll", "tiles"),
             ("manhattan", "device", "coll", "tiles"),
             ("euclidean", "host", "auto", "tiles"),
             ("euclidean", "device", "ring", "tiles"),
             ("hamming", "device", "ring", "tiles"),
             ("manhattan", "device", "ring", "tiles"),
             ("euclidean", "device", "ring", "tree"),
             ("hamming", "device", "ring", "tree"),
             ("euclidean", "device", "coll", "tree"),
             ("manhattan", "device", "coll", "tree")]


def test_spatial_counters_match_reference_8dev(tmp_path):
    """All three metrics (and the host planner under ghost_mode="auto",
    16 centres), the ghost ring on both traversals and the tree flavour of
    the collective exchange, against the reference on 8 devices: edges,
    plan, m_centers, the resolved ghost_mode, forest_backend, replans,
    tiles_scheduled / tiles_skipped / dists_evaluated / nodes_pruned and
    both comm_bytes channels. The tree runs take an eps that is also
    tree-safe over the 8 ranks' cell forests."""
    pts = {m: points(m, N8, SEED) for m in METRICS}
    eps = {m: landmark_safe_eps(pts[m], m, TARGET[m], [8]) for m in METRICS}
    tree_eps = {m: landmark_safe_eps(pts[m], m, TARGET[m], [8],
                                     tree_ranks=[8]) for m in METRICS}
    auto_eps = landmark_safe_eps(pts["euclidean"], "euclidean",
                                 TARGET["euclidean"], [8], m=AUTO_M)
    path = tmp_path / "cases.npz"
    np.savez(path, **pts, **{m + "_eps": v for m, v in eps.items()},
             **{m + "_tree_eps": v for m, v in tree_eps.items()},
             auto_eps=auto_eps)
    code = (f"import sys; sys.argv[1:] = [{str(path)!r}, "
            f"{json.dumps(RUNS_8DEV)!r}]\n" + REF_8DEV)
    refs = json.loads(run_subprocess(code, devices=8).strip()
                      .splitlines()[-1])
    assert len(refs) == len(RUNS_8DEV)
    for (metric, planner, mode, trav), ref in zip(RUNS_8DEV, refs):
        key = (metric, planner, mode, trav)
        e = (auto_eps if mode == "auto" else
             (tree_eps if trav == "tree" else eps)[metric])
        g = build_nng(pts[metric], e, metric=metric, partition="spatial",
                      planner=planner, ghost_mode=mode, traversal=trav,
                      m_centers=AUTO_M if mode == "auto" else None,
                      mesh=cpu_mesh(8))
        st = g.stats
        assert dataclasses.asdict(g.meta["plan"]) == ref["plan"], key
        assert g.num_edges == ref["edges"], key
        assert hashlib.sha256(g.edge_key().tobytes()).hexdigest() == \
            ref["edge_sha"], key
        assert g.meta["m_centers"] == ref["m_centers"], key
        assert g.meta["ghost_mode"] == ref["ghost_mode"] == (
            "coll" if mode == "auto" else mode), key
        assert g.meta.get("forest_backend") == ref["forest_backend"], key
        assert st.replans == ref["replans"], key
        for field in ("tiles_scheduled", "tiles_skipped", "dists_evaluated",
                      "nodes_pruned"):
            assert getattr(st, field) == ref[field], (key, field)
        assert st.comm_bytes == ref["comm_bytes"], key
        if trav == "tiles":
            assert st.tiles_skipped > 0, key
        else:
            assert st.nodes_pruned > 0, key
