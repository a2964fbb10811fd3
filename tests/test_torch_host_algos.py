"""The port's paper-table modules against the JAX reference, on the CPU.

The host simulations of Algorithms 4-6 (``core.host_algos``), the SNN
baseline (``core.snn``), ``load_pointset``, the greedy centres and
``voronoi_assign`` (``core.landmark``), ``TraversalStats.add``, and the
rest of ``core.distributed``'s public names (``plan_landmark``,
``tile_cdist``, the deprecated tuple-API aliases).

The same numpy inputs, made from a seed, go through both packages. Both
run float64 numpy over cover trees that make the same decisions, so the
graphs, the work counters, every ``comm_bytes`` channel, the centres and
the arrays must be EQUAL, not close; the graphs also equal the port's
float64 brute force. Only ``tile_cdist`` compares fp32 results of two
programs: L2 within the knife of PERF.md §2 (20 fp32 rounding units of
‖x‖² + ‖y‖²), L1 within d·u·D, Hamming exact.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.core import host_algos as rha
from repro.core import landmark as rland
from repro.core import snn as rsnn
from repro.core.distributed import device as rdev
from repro.core.flat_tree import TraversalStats as RTraversalStats
from repro.data import pointsets as rpts
from repro_torch.core import host_algos as tha
from repro_torch.core import landmark as tland
from repro_torch.core import snn as tsnn
from repro_torch.core.brute import brute_force_graph
from repro_torch.core.distributed import (landmark_nng, landmark_run,
                                          make_nng_mesh, plan_landmark,
                                          plan_landmark_device, systolic_nng,
                                          systolic_run, tile_cdist)
from repro_torch.core.flat_tree import TraversalStats
from repro_torch.core.graph import RunStats
from repro_torch.data import (blocked_clusters, load_pointset,
                              synthetic_pointset)
from repro_torch.kernels.ops import nng_tile_bits_grouped

U32 = 2.0 ** -24
COUNTERS = ("tiles_scheduled", "tiles_skipped", "dists_evaluated",
            "nodes_pruned")


def clustered(n, d, seed):
    return synthetic_pointset(n, d, "euclidean", seed=seed)


def assert_same_run(port, ref, points, eps, metric="euclidean"):
    """Port and reference (graph, PhaseStats) equal: edges (and equal to
    the float64 brute force), counters, comm_bytes, the ranks' count."""
    (g, s), (rg, rs) = port, ref
    assert g.n == rg.n
    np.testing.assert_array_equal(g.src, rg.src)
    np.testing.assert_array_equal(g.dst, rg.dst)
    assert g == brute_force_graph(points, eps, metric)
    assert isinstance(s, tha.PhaseStats) and isinstance(s, RunStats)
    for k in COUNTERS:
        assert getattr(s, k) == getattr(rs, k), k
    assert s.comm_bytes == rs.comm_bytes
    assert s.per_rank_s.shape == rs.per_rank_s.shape
    assert min(s.partition_s, s.tree_s, s.ghost_s) >= 0.0
    assert s.makespan_s == float(s.per_rank_s.max()) <= s.total_s + 1e-9


@pytest.mark.parametrize("prune", [True, False], ids=["prune", "no-prune"])
@pytest.mark.parametrize("nranks", [1, 2, 5, 8])
def test_systolic_ring_host(nranks, prune):
    pts = clustered(1500, 8, 0)
    assert_same_run(tha.systolic_ring_host(pts, 1.0, nranks, prune=prune),
                    rha.systolic_ring_host(pts, 1.0, nranks, prune=prune),
                    pts, 1.0)


@pytest.mark.parametrize("nranks", [4, 8])
def test_systolic_ring_host_prunes_blocked_clusters(nranks):
    """Tight clusters along index blocks: the block summaries prune cross
    tiles (at 8 ranks, one cluster a block, every one of them), and both
    packages skip the same tiles."""
    pts = blocked_clusters(2048, 4, 8)
    np.testing.assert_array_equal(pts, rpts.blocked_clusters(2048, 4, 8))
    port = tha.systolic_ring_host(pts, 1.0, nranks)
    assert_same_run(port, rha.systolic_ring_host(pts, 1.0, nranks), pts, 1.0)
    s = port[1]
    assert s.tiles_skipped > 0
    if nranks == 8:
        assert s.tiles_skipped == s.tiles_scheduled - nranks


@pytest.mark.parametrize("nranks,ghost_mode,strategy", [
    (1, "coll", "random"), (4, "coll", "random"), (4, "ring", "random"),
    (8, "coll", "greedy"), (7, "ring", "greedy"),
])
def test_landmark_host(nranks, ghost_mode, strategy):
    pts = clustered(1500, 8, 1)
    kw = dict(ghost_mode=ghost_mode, center_strategy=strategy, seed=2)
    assert_same_run(tha.landmark_host(pts, 1.0, nranks, **kw),
                    rha.landmark_host(pts, 1.0, nranks, **kw), pts, 1.0)
    m = max(2 * nranks, 32)
    np.testing.assert_array_equal(
        tland.select_centers(len(pts), m, np.random.default_rng(2), pts,
                             "euclidean", strategy),
        rland.select_centers(len(pts), m, np.random.default_rng(2), pts,
                             "euclidean", strategy))


@pytest.mark.parametrize("algo", ["systolic", "landmark"])
def test_hamming_host_algos(algo):
    pts = synthetic_pointset(800, 8, "hamming", seed=3)
    np.testing.assert_array_equal(pts, rpts.synthetic_pointset(
        800, 8, "hamming", seed=3))
    if algo == "systolic":
        port = tha.systolic_ring_host(pts, 40, 4, metric="hamming")
        ref = rha.systolic_ring_host(pts, 40, 4, metric="hamming")
    else:
        port = tha.landmark_host(pts, 40, 4, metric="hamming", seed=5)
        ref = rha.landmark_host(pts, 40, 4, metric="hamming", seed=5)
    assert_same_run(port, ref, pts, 40, "hamming")


@pytest.mark.parametrize("name", sorted(rha.ALGORITHMS))
def test_algorithms_table(name):
    assert sorted(tha.ALGORITHMS) == sorted(rha.ALGORITHMS)
    pts = clustered(600, 6, 4)
    kw = {} if name == "systolic-ring" else {"seed": 1}
    assert_same_run(tha.ALGORITHMS[name](pts, 1.0, 3, **kw),
                    rha.ALGORITHMS[name](pts, 1.0, 3, **kw), pts, 1.0)


def test_snn_graph():
    pts = clustered(2000, 10, 2)
    idx, ridx = tsnn.SNNIndex(pts), rsnn.SNNIndex(pts)
    np.testing.assert_array_equal(idx.order, ridx.order)
    np.testing.assert_array_equal(idx.scores, ridx.scores)
    g, rg = tsnn.snn_graph(pts, 1.0), rsnn.snn_graph(pts, 1.0)
    np.testing.assert_array_equal(g.src, rg.src)
    np.testing.assert_array_equal(g.dst, rg.dst)
    assert g == brute_force_graph(pts, 1.0) and g.num_edges > 0


@pytest.mark.parametrize("metric", ["euclidean", "hamming", "manhattan"])
def test_grouped_tile_schedule(metric):
    """The host mirror equals the reference's and the port's grouped tile
    counters on the CPU (the reference's block-skip case)."""
    from repro.kernels.ops import nng_tile_geometry as ref_geometry
    rng = np.random.default_rng(0)
    q, p = 600, 1200
    xg = np.sort(rng.integers(0, 50, size=q)).astype(np.int32)
    yg = np.sort(rng.integers(0, 50, size=p)).astype(np.int32)
    xg[q - 40:] = -1   # trailing padding rows (as after the cell sort)
    yg[p - 70:] = -1
    if metric == "hamming":
        x = rng.integers(0, 2**32, size=(q, 5), dtype=np.uint32)
        y = rng.integers(0, 2**32, size=(p, 5), dtype=np.uint32)
        eps = 70
    else:
        x = rng.normal(size=(q, 5)).astype(np.float32)
        y = rng.normal(size=(p, 5)).astype(np.float32)
        eps = 2.0
    want = tha.grouped_tile_schedule(xg, yg, metric)
    assert want == rha.grouped_tile_schedule(xg, yg, metric)
    assert ref_geometry(q, p, metric) == tha.nng_tile_geometry(q, p, metric)
    xid = np.arange(q, dtype=np.int32)
    yid = np.arange(q, q + p, dtype=np.int32)
    xt = torch.as_tensor(x.view(np.int32) if metric == "hamming" else x)
    yt = torch.as_tensor(y.view(np.int32) if metric == "hamming" else y)
    _, _, sched, skip = nng_tile_bits_grouped(xt, yt, xg, yg, xid, yid, eps,
                                              metric=metric)
    assert (int(sched), int(skip)) == want
    assert want[1] > 0, "sorted cells must skip cross-cell blocks"


@pytest.mark.parametrize("strategy", ["random", "greedy"])
@pytest.mark.parametrize("metric", ["euclidean", "hamming", "manhattan"])
def test_centers_and_voronoi_assign(metric, strategy):
    pts = synthetic_pointset(700, 5 if metric == "hamming" else 12, metric,
                             seed=6)
    c = tland.select_centers(len(pts), 24, np.random.default_rng(9), pts,
                             metric, strategy)
    rc = rland.select_centers(len(pts), 24, np.random.default_rng(9), pts,
                              metric, strategy)
    np.testing.assert_array_equal(c, rc)
    assert len(set(c.tolist())) == 24
    cell, dist = tland.voronoi_assign(pts, pts[c], metric)
    rcell, rdist = rland.voronoi_assign(pts, pts[rc], metric)
    assert cell.dtype == np.int64 and dist.dtype == np.float64
    np.testing.assert_array_equal(cell, rcell)
    np.testing.assert_array_equal(dist, rdist)
    assert (dist[c] == 0).all()


def test_voronoi_ties_go_to_the_lowest_centre():
    pts = np.array([[0.0, 0.0], [2.0, 0.0], [1.0, 0.0]], np.float32)
    cell, dist = tland.voronoi_assign(pts, pts[[1, 0]], "euclidean")
    np.testing.assert_array_equal(cell, [1, 0, 0])
    np.testing.assert_array_equal(dist, [0.0, 0.0, 1.0])


def test_random_centres_draw_as_before():
    """The random path draws as ``select_centers(n, m, rng)`` always did:
    the landmark engine's and OnlineNNG's centres do not move."""
    pts = clustered(300, 4, 0)
    a = tland.select_centers(300, 32, np.random.default_rng(4))
    b = tland.select_centers(300, 32, np.random.default_rng(4), pts,
                             "euclidean")
    np.testing.assert_array_equal(a, np.random.default_rng(4).choice(
        300, size=32, replace=False))
    np.testing.assert_array_equal(a, b)


def _write_fvecs(path, x):
    d = x.shape[1]
    rows = np.concatenate([np.full((len(x), 1), d, np.int32),
                           x.view(np.int32)], axis=1)
    rows.tofile(path)


@pytest.mark.parametrize("source", ["fvecs", "npy", "missing"])
def test_load_pointset(tmp_path, source):
    x = clustered(50, 6, 3)
    if source == "fvecs":
        _write_fvecs(tmp_path / "pts.fvecs", x)
    elif source == "npy":
        np.save(tmp_path / "pts.npy", x)
    got = load_pointset("pts", 40, 6, "euclidean", data_dir=str(tmp_path))
    want = rpts.load_pointset("pts", 40, 6, "euclidean",
                              data_dir=str(tmp_path))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    if source == "missing":
        np.testing.assert_array_equal(got, synthetic_pointset(
            40, 6, seed=abs(hash("pts")) % 2**31))
    else:
        np.testing.assert_array_equal(got, x[:40])


@pytest.mark.parametrize("n,nranks,kw", [
    (1500, 8, {}), (1000, 3, {"m_centers": 10}),
    (4096, 4, {"avg_degree_hint": 20.0, "skew": 1.5}),
])
def test_plan_landmark(n, nranks, kw):
    plan = plan_landmark(n, nranks, **kw)
    ref = rdev.plan_landmark(n, nranks, **kw)
    assert {f: getattr(plan, f) for f in ref.__dataclass_fields__} == {
        f: getattr(ref, f) for f in ref.__dataclass_fields__}
    assert plan.cap_rank == 0


@pytest.mark.parametrize("metric", ["euclidean", "hamming", "manhattan"])
def test_tile_cdist(metric):
    words = metric == "hamming"
    x = synthetic_pointset(70, 6 if words else 16, metric, seed=1)
    y = synthetic_pointset(90, 6 if words else 16, metric, seed=2)
    got = tile_cdist(torch.as_tensor(x.view(np.int32) if words else x),
                     torch.as_tensor(y.view(np.int32) if words else y),
                     metric).numpy()
    want = np.asarray(rdev.tile_cdist(x, y, metric))
    assert got.shape == want.shape == (70, 90)
    if words:
        np.testing.assert_array_equal(got, want)
        return
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    if metric == "euclidean":
        knife = 20 * U32 * ((x64 ** 2).sum(1)[:, None]
                            + (y64 ** 2).sum(1)[None, :])
    else:
        exact = np.abs(x64[:, None, :] - y64[None, :, :]).sum(-1)
        knife = 2 * x.shape[1] * U32 * exact
    assert (np.abs(got.astype(np.float64) - want) <= knife).all()


def test_traversal_stats_add():
    a, b = TraversalStats(5, 2, 3), TraversalStats(7, 11, 2)
    ra, rb = RTraversalStats(5, 2, 3), RTraversalStats(7, 11, 2)
    a.add(b)
    ra.add(rb)
    assert (a.dists_evaluated, a.nodes_pruned, a.levels) == (
        ra.dists_evaluated, ra.nodes_pruned, ra.levels) == (12, 13, 3)


def _as_numpy(out):
    return [[v.numpy() for v in o] if isinstance(o, list)
            else (o.numpy() if torch.is_tensor(o) else o) for o in out]


def _assert_same_outputs(a, b):
    assert len(a) == len(b)
    for u, v in zip(_as_numpy(a), _as_numpy(b)):
        if isinstance(u, list):
            assert len(u) == len(v)
            for p, q in zip(u, v):
                np.testing.assert_array_equal(p, q)
        else:
            np.testing.assert_array_equal(u, v)


def test_systolic_nng_alias():
    pts = clustered(256, 4, 5)
    mesh = make_nng_mesh(4, device="cpu")
    with pytest.warns(DeprecationWarning, match="systolic_nng"):
        out = systolic_nng(pts, 1.0, mesh, k_cap=64)
    _assert_same_outputs(out, systolic_run(pts, 1.0, mesh, k_cap=64))


def test_landmark_nng_alias():
    pts = clustered(256, 4, 5)
    mesh = make_nng_mesh(4, device="cpu")
    centers = pts[tland.select_centers(256, 16, np.random.default_rng(0))]
    cell, _ = tland.voronoi_assign(pts, centers, "euclidean")
    f = tland.lpt_assignment(np.bincount(cell, minlength=16), 4)
    plan = plan_landmark_device(pts, centers, f, 1.0, mesh, k_cap=64)
    with pytest.warns(DeprecationWarning, match="landmark_nng"):
        out = landmark_nng(pts, 1.0, centers, f, mesh, plan)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        want = landmark_run(pts, 1.0, centers, f, mesh, plan)
    _assert_same_outputs(out, want)
