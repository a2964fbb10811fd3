"""The port's online maintenance against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference's and
the port's copies of each layer: the ``NNGraph`` delta log, the host
forest's ``insert_host`` / ``tombstone_host``, the stacked tables'
``insert_stacked_device`` / ``tombstone_stacked_device``, ``delta_run``
(the delta traversal through the frontier, ``leaf_range_pack`` and
``bits_to_cols`` plain versions), and ``OnlineNNG``. Tables and counters
must be equal; graphs must equal the float64 brute force after every
operation. The reference's multi-device runs share one subprocess.
"""
import json
import sys

import numpy as np
import pytest
import torch

from repro.core import flat_tree as rft
from repro.core import graph as rgraph
from repro.core.covertree import build_covertree as ref_build_covertree
from repro.core.flat_tree_device import \
    insert_stacked_device as ref_insert_stacked
from repro.core.flat_tree_device import \
    tombstone_stacked_device as ref_tombstone_stacked
from repro_torch.core import flat_tree as tft
from repro_torch.core import graph as tgraph
from repro_torch.core.brute import brute_force_graph
from repro_torch.core.covertree import build_covertree
from repro_torch.core.distributed import make_nng_mesh
from repro_torch.core.flat_tree_device import (_grow_stacked,
                                               insert_stacked_device,
                                               tombstone_stacked_device)
from repro_torch.core.metrics_host import get_host_metric
from repro_torch.data import synthetic_pointset
from repro_torch.nng import delta_run
from repro_torch.stream import OnlineNNG
from tests.helpers import run_subprocess, safe_eps
from tests.test_torch_kernels_gpu import pair_dists
from tests.test_torch_tree import tree_safe_eps

SENTINEL = 2**31 - 1
TABLE_KEYS = ("node_gid", "node_cell", "node_leaf", "parent_pos",
              "child_lo", "child_hi", "leaf_lo", "leaf_hi", "leaf_ids")


def both(n, src, dst):
    """The same directed pairs as the reference's and the port's NNGraph."""
    return (rgraph.NNGraph.from_directed_pairs(n, src, dst),
            tgraph.NNGraph.from_directed_pairs(n, src, dst))


def assert_same_graph(ref, ours, tag=""):
    assert ours.n == ref.n, tag
    np.testing.assert_array_equal(ours.edge_key(), ref.edge_key(),
                                  err_msg=tag)
    assert ours.edge_key().dtype == np.int64
    assert ours.delta_edges == ref.delta_edges, tag
    assert ours.has_delta == ref.has_delta, tag
    assert ours.num_edges == ref.num_edges, tag
    for field in ("edges_added", "edges_removed"):
        assert getattr(ours.stats, field) == getattr(ref.stats, field), tag
    assert ours.meta.get("compactions") == ref.meta.get("compactions"), tag
    np.testing.assert_array_equal(ours.degrees(), ref.degrees(), err_msg=tag)


# ---------------------------------------------------------------------------
# (a) the CSR delta log (host numpy, no engines)
# ---------------------------------------------------------------------------

def test_delta_log_randomized_matches_reference():
    """The reference's 30-step randomized schedule (node inserts, edge adds
    with duplicates, self loops and dead endpoints, node deletes, forced
    and ratio compactions) through both NNGraphs: every reader agrees
    after every step, and with a plain edge-set model."""
    rng = np.random.default_rng(7)
    n = 12
    base = [(0, 1), (1, 2), (2, 3), (0, 4), (5, 6)]
    src = np.array([a for a, b in base], np.int64)
    dst = np.array([b for a, b in base], np.int64)
    ref, g = both(n, np.r_[src, dst], np.r_[dst, src])
    edges, dead = set(base), set()
    for step in range(40):
        op = rng.integers(5)
        if op == 0:                                   # insert nodes
            k = int(rng.integers(1, 4))
            new = g.delta_insert_nodes(k)
            np.testing.assert_array_equal(new, ref.delta_insert_nodes(k))
            assert (new == np.arange(n, n + k)).all()
            n += k
        elif op == 1:                                 # add edges
            m = int(rng.integers(1, 6))
            a = rng.integers(0, n, m)
            b = rng.integers(0, n, m)
            added = g.delta_add_edges(a, b)
            assert added == ref.delta_add_edges(a, b)
            want = {(min(x, y), max(x, y)) for x, y in zip(a, b)
                    if x != y and x not in dead and y not in dead}
            assert added == len(want - edges)
            edges |= want - edges
        elif op == 2 and n - len(dead) > 2:           # delete nodes
            alive = [i for i in range(n) if i not in dead]
            ids = rng.choice(alive, size=min(2, len(alive)), replace=False)
            removed = g.delta_delete_nodes(ids)
            assert removed == ref.delta_delete_nodes(ids)
            killed = {e for e in edges if e[0] in set(ids) or e[1] in set(ids)}
            assert removed == len(killed)
            edges -= killed
            dead |= set(int(i) for i in ids)
        elif op == 3:                                 # the ratio policy
            assert g.maybe_compact(0.3) == ref.maybe_compact(0.3)
        else:                                         # compact (idempotent)
            before = g.edge_key()
            g.compact()
            ref.compact()
            assert not g.has_delta
            np.testing.assert_array_equal(g.edge_key(), before)
            g.compact()                               # a second is a no-op
            np.testing.assert_array_equal(g.edge_key(), before)
        assert_same_graph(ref, g, f"step {step}")
        live = [(a, b) for a, b in edges if a not in dead and b not in dead]
        model = tgraph.EpsGraph(n, np.array([a for a, _ in live], np.int64),
                                np.array([b for _, b in live], np.int64))
        assert g == model, f"step {step}"
        for i in rng.integers(0, n, 3):               # row views
            np.testing.assert_array_equal(g.neighbors(int(i)),
                                          ref.neighbors(int(i)))
    assert g.meta.get("compactions", 0) >= 1
    assert g.stats.edges_added > 0 and g.stats.edges_removed > 0


def test_delta_add_edges_guards():
    """Self loops, out-of-range and SENTINEL endpoints and duplicates drop;
    edges to a dead node are rejected even after compaction."""
    src, dst = np.array([0, 1], np.int64), np.array([1, 0], np.int64)
    for g in both(4, src, dst):
        assert g.delta_add_edges([2, 2, 0, 9, SENTINEL], [2, 3, 1, 1, 2]) == 1
        assert (g.neighbors(2) == [3]).all()
        assert g.delta_delete_nodes([3]) == 1
        assert g.delta_delete_nodes([3]) == 0         # already dead
        g.compact()
        assert g.delta_add_edges([2], [3]) == 0
        assert len(g.neighbors(2)) == 0
        assert g.meta["compactions"] == 1


def test_edge_key_int64_large_n():
    """src * n + dst overflows int32 at this n: the keys are int64 on the
    base CSR and through the delta log."""
    n = 200_000
    src = np.array([0, n - 2], np.int64)
    dst = np.array([n - 1, n - 1], np.int64)
    ref, g = both(n, np.r_[src, dst], np.r_[dst, src])
    key = g.edge_key()
    assert key.dtype == np.int64
    assert (key == np.sort(src * n + dst)).all()
    assert key[1] > np.iinfo(np.int32).max
    for h in (ref, g):
        h.delta_add_edges([1], [n - 1])
    assert g.num_edges == 3
    assert_same_graph(ref, g)


def test_graph_api_matches_reference(monkeypatch):
    """``num_nodes``, ``to_eps_graph``, ``to_scipy_csr`` (and its error
    without scipy), ``EpsGraph.degree`` / ``avg_degree`` /
    ``symmetric_difference``, ``merge_graphs`` and ``edges_from_pairs``:
    the reference's values on the same merged view."""
    rng = np.random.default_rng(3)
    n = 40
    src, dst = rng.integers(0, n, 120), rng.integers(0, n, 120)
    ref, g = both(n, src, dst)
    a, b = rng.integers(0, n, 30), rng.integers(0, n, 30)
    for h in (ref, g):
        h.delta_add_edges(a, b)
        h.delta_delete_nodes([5, 7])
    assert g.num_nodes == ref.num_nodes == n
    e, er = g.to_eps_graph(), ref.to_eps_graph()
    np.testing.assert_array_equal(e.edge_key(), er.edge_key())
    np.testing.assert_array_equal(e.degree(), er.degree())
    np.testing.assert_array_equal(e.degree(), g.degrees())
    assert e.avg_degree == er.avg_degree == g.avg_degree
    csr, csr_r = g.to_scipy_csr(), ref.to_scipy_csr()
    assert (csr != csr_r).nnz == 0 and csr.nnz == 2 * g.num_edges
    pairs = np.stack([rng.integers(0, n, 50), rng.integers(0, n, 50)], 1)
    p = tgraph.edges_from_pairs(n, pairs)
    pr = rgraph.edges_from_pairs(n, pairs)
    np.testing.assert_array_equal(p.edge_key(), pr.edge_key())
    assert tgraph.edges_from_pairs(n, np.zeros((0, 2))).num_edges == 0
    m, mr = tgraph.merge_graphs(n, [e, p]), rgraph.merge_graphs(n, [er, pr])
    np.testing.assert_array_equal(m.edge_key(), mr.edge_key())
    assert e.symmetric_difference(p) == er.symmetric_difference(pr) > 0
    assert tgraph.merge_graphs(n, []).num_edges == 0
    monkeypatch.setitem(sys.modules, "scipy", None)
    monkeypatch.setitem(sys.modules, "scipy.sparse", None)
    with pytest.raises(ImportError, match="optional dependency scipy"):
        g.to_scipy_csr()


# ---------------------------------------------------------------------------
# (b) the host forest's insert_host / tombstone_host (float64)
# ---------------------------------------------------------------------------

def assert_same_tables(ours, ref, tag):
    for key in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(ours, key), getattr(ref, key),
                                      err_msg=f"{tag}: {key}")
    np.testing.assert_array_equal(ours.node_radius, ref.node_radius,
                                  err_msg=f"{tag}: node_radius")
    assert ours.num_leaves == ref.num_leaves, tag
    assert ours.level_width == ref.level_width, tag


@pytest.mark.parametrize("metric,cells", [("euclidean", False),
                                          ("hamming", False),
                                          ("euclidean", True)])
def test_insert_host_and_tombstone_match_reference(metric, cells):
    """Grow one tree (or a two-cell forest, where later inserts also open
    a third cell as a new root) batch by batch, then tombstone: the tables
    equal the reference's after each step — bit for bit on the int
    tables, exactly on the float64 radii — and ``query_host`` equals the
    float64 brute force on the live points."""
    rng = np.random.default_rng(11)
    pts = synthetic_pointset(160, 6, metric, seed=11)
    eps = safe_eps(pts, metric)
    met = get_host_metric(metric)
    n0 = 100
    if cells:
        cell = (np.arange(len(pts)) % 2).astype(np.int64)
        cell[130:] = 5                             # a cell with no root yet
        groups = [np.flatnonzero(cell[:n0] == c) for c in (0, 1)]
        trees = [(build_covertree(pts[g], met, 8),
                  ref_build_covertree(pts[g], metric, 8)) for g in groups]
        kw = dict(cells=[0, 1], gids=groups, points=pts)
        ours = tft.flatten_forest([t for t, _ in trees], **kw)
        ref = rft.flatten_forest([r for _, r in trees], **kw)
    else:
        cell = np.zeros(len(pts), np.int64)
        kw = dict(cells=[0], gids=[np.arange(n0, dtype=np.int64)], points=pts)
        ours = tft.flatten_forest([build_covertree(pts[:n0], met, 8)], **kw)
        ref = rft.flatten_forest([ref_build_covertree(pts[:n0], metric, 8)],
                                 **kw)
    live = np.zeros(len(pts), bool)
    live[:n0] = True

    def check(tag):
        assert_same_tables(ours, ref, tag)
        ids = np.flatnonzero(live)
        d = pair_dists(pts[:12], pts[ids], metric)
        qi, gid = ours.query_host(pts[:12], eps)
        for q in range(12):
            assert set(gid[qi == q].tolist()) == set(
                ids[np.flatnonzero(d[q] <= eps)].tolist()), (tag, q)

    check("built")
    for lo in range(n0, len(pts), 16):
        hi = min(lo + 16, len(pts))
        gids = np.arange(lo, hi, dtype=np.int64)
        for f in (ours, ref):
            f.insert_host(gids, cells=cell[lo:hi] if cells else None,
                          points=pts)
        live[lo:hi] = True
        check(f"insert {lo}")
    for doomed in (rng.choice(np.flatnonzero(live), 30, replace=False),
                   np.arange(130, 140)):
        for f in (ours, ref):
            f.tombstone_host(doomed)
        live[doomed] = False
        check("tombstone")
    # an insert after the deletes revives tombstoned leaves' parents
    extra = synthetic_pointset(20, 6, metric, seed=12)
    pts = np.concatenate([pts, extra])
    cell = np.concatenate([cell, cell[:20]])
    live = np.concatenate([live, np.ones(20, bool)])
    gids = np.arange(160, 180, dtype=np.int64)
    for f in (ours, ref):
        f.insert_host(gids, cells=cell[160:] if cells else None, points=pts)
    check("insert after tombstones")


# ---------------------------------------------------------------------------
# (c) the stacked tables' device insert / tombstone
# ---------------------------------------------------------------------------

def stacked_block_forests(pts, n0, nranks, metric="euclidean"):
    """OnlineNNG's point-partition forests over the first n0 points: one
    tree per ``np.array_split`` block, stacked (numpy)."""
    met = get_host_metric(metric)
    forests = [tft.flatten_forest([build_covertree(pts[blk], met, 6)],
                                  cells=[0], gids=[blk], points=pts)
               for blk in np.array_split(np.arange(n0, dtype=np.int64),
                                         nranks)]
    return tft.stack_device_forests(forests)


def as_numpy(tabs):
    return {k: np.asarray(v) for k, v in tabs.items()}


@pytest.mark.parametrize("batch,grow", [(12, False), (150, True)])
def test_device_insert_and_tombstone_match_reference(batch, grow):
    """Singleton-root inserts into 3 ranks' stacked tables (cells given),
    then tombstones: the port's tables equal the reference's. The larger
    batch overflows a rank's level-0 width and the leaf table, so both
    double (``_grow_stacked``) and the insert retries."""
    rng = np.random.default_rng(5)
    pts = synthetic_pointset(200 + batch, 5, seed=5)
    tabs = stacked_block_forests(pts, 200, 3)
    gids = np.arange(200, 200 + batch, dtype=np.int64)
    ranks = rng.integers(0, 3, batch)
    cells = rng.integers(0, 4, batch)
    ours = insert_stacked_device(tabs, pts[200:], gids, ranks, cells)
    ref = as_numpy(ref_insert_stacked(tabs, pts[200:], gids, ranks, cells))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    assert (ours["cell"].shape[2] > tabs["cell"].shape[2]) == grow
    assert np.array_equal(tabs["cell"], stacked_block_forests(
        pts, 200, 3)["cell"])                      # the input is untouched
    doomed = rng.choice(200 + batch, 40, replace=False)
    ours = tombstone_stacked_device(ours, doomed)
    ref = as_numpy(ref_tombstone_stacked(ref, doomed))
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
    assert not np.isin(ours["leaf_ids"].numpy(), doomed).any()
    grown = _grow_stacked({k: torch.as_tensor(v) for k, v in tabs.items()})
    assert grown["coords"].shape[2] == 2 * tabs["coords"].shape[2]
    assert grown["leaf_ids"].shape[1] == 2 * tabs["leaf_ids"].shape[1]
    assert (grown["cell"][:, :, tabs["cell"].shape[2]:] == -1).all()
    assert (grown["leaf_ids"][:, tabs["leaf_ids"].shape[1]:] == SENTINEL).all()


# ---------------------------------------------------------------------------
# (d) delta_run and the counters against the reference's multi-device runs
# ---------------------------------------------------------------------------

DELTA_CASES = [("euclidean", 1), ("euclidean", 3), ("euclidean", 8),
               ("hamming", 3)]
LADDER_8 = dict(metric="hamming", partition="point", backend="device",
                seed=21, nranks=8)

REF_RUNS = """
import json, sys
import numpy as np
from repro.core.distributed import make_nng_mesh
from repro.data import synthetic_pointset
from repro.nng import delta_run
from repro.stream import OnlineNNG
from tests.helpers import safe_eps
out = {"delta": [], "ladder": None}
with np.load(sys.argv[1]) as f:
    for i, (metric, nranks) in enumerate(json.loads(str(f["cases"]))):
        tabs = {k[len(f"{i}_t_"):]: f[k] for k in f.files
                if k.startswith(f"{i}_t_")}
        src, dst, st = delta_run(f[f"{i}_q"], f[f"{i}_ids"], tabs,
                                 float(f[f"{i}_eps"]), make_nng_mesh(nranks),
                                 metric=metric, k_cap=2)
        out["delta"].append({
            "pairs": sorted(zip(np.asarray(src).tolist(),
                                np.asarray(dst).tolist())),
            "dists": st.dists_evaluated, "pruned": st.nodes_pruned,
            "comm_bytes": st.comm_bytes, "replans": st.replans})
    lad = json.loads(str(f["ladder"]))
rng = np.random.default_rng(lad["seed"])
pool = synthetic_pointset(420, 6, lad["metric"], seed=lad["seed"])
eps = safe_eps(pool, lad["metric"])
o = OnlineNNG(pool[:320], eps, metric=lad["metric"],
              partition=lad["partition"], insert_backend=lad["backend"],
              compact_ratio=0.25, seed=lad["seed"],
              mesh=make_nng_mesh(lad["nranks"]))
cursor = 320
for step in range(5):
    if step % 3 == 2:
        o.delete(rng.choice(np.flatnonzero(o.live), size=20, replace=False))
    else:
        o.insert(pool[cursor:cursor + 20])
        cursor += 20
st = o.stats
out["ladder"] = {
    "edge_key": o.graph.edge_key().tolist(),
    "compactions": o.graph.meta["compactions"],
    "stats": {k: getattr(st, k) for k in (
        "tiles_scheduled", "tiles_skipped", "dists_evaluated",
        "nodes_pruned", "edges_added", "edges_removed", "replans")},
    "comm_bytes": st.comm_bytes}
print(json.dumps(out))
"""


def delta_case(metric, nranks):
    """OnlineNNG's state before a delta traversal: block forests over 300
    points, a batch of 20 (padded to 32 rows) inserted as singleton roots
    round robin, 15 ids tombstoned (the batch's first among them), and a
    tree-safe eps for those tables."""
    rng = np.random.default_rng(40 + nranks)
    pts = synthetic_pointset(320, 6, metric, seed=40 + nranks)
    gids = np.arange(300, 320, dtype=np.int64)
    tabs = stacked_block_forests(pts, 300, nranks, metric)
    tabs = insert_stacked_device(tabs, pts[300:], gids,
                                 np.arange(20) % nranks)
    doomed = np.r_[300, rng.choice(300, 14, replace=False)]
    tabs = as_numpy(tombstone_stacked_device(tabs, doomed))
    if metric == "hamming":
        eps = 40.0
    else:
        eps = tree_safe_eps(pts, nranks, 1.2, tabs=tabs)
    return pts, gids, tabs, eps, doomed


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's delta_run for every DELTA_CASES entry and its
    OnlineNNG schedule LADDER_8, in one 8-device subprocess."""
    arrays = {"cases": json.dumps(DELTA_CASES), "ladder": json.dumps(LADDER_8)}
    for i, (metric, nranks) in enumerate(DELTA_CASES):
        pts, gids, tabs, eps, _ = delta_case(metric, nranks)
        arrays.update({f"{i}_q": pts[300:], f"{i}_ids": gids,
                       f"{i}_eps": eps})
        arrays.update({f"{i}_t_{k}": v for k, v in tabs.items()})
    path = tmp_path_factory.mktemp("stream") / "cases.npz"
    np.savez(path, **arrays)
    code = f"import sys; sys.argv[1:] = [{str(path)!r}]\n" + REF_RUNS
    return json.loads(run_subprocess(code, devices=8, timeout=600)
                      .strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(DELTA_CASES)),
                         ids=[f"{m}-R{r}" for m, r in DELTA_CASES])
def test_delta_run_matches_reference(ref_runs, i):
    """The delta traversal at R ranks against the reference's on the same
    stacked tables (tombstoned SENTINEL leaves, roots appended on level 0,
    a padded batch): the same directed pairs, ``dists_evaluated``,
    ``nodes_pruned`` and ``delta_bcast`` bytes; k_cap 2 grows once. The
    pairs are the float64 brute force's from each batch point to every
    live point (a tombstoned query keeps its pairs: the delta log drops
    them)."""
    metric, nranks = DELTA_CASES[i]
    pts, gids, tabs, eps, doomed = delta_case(metric, nranks)
    src, dst, st = delta_run(pts[300:], gids, tabs, eps,
                             make_nng_mesh(nranks, "cpu"), metric=metric,
                             k_cap=2)
    ref = ref_runs["delta"][i]
    assert sorted(zip(src.tolist(), dst.tolist())) == \
        [tuple(p) for p in ref["pairs"]]
    assert st.dists_evaluated == ref["dists"] > 0
    assert st.nodes_pruned == ref["pruned"]
    assert st.comm_bytes == ref["comm_bytes"]
    assert st.replans == ref["replans"] == 1
    assert st.comm_bytes["delta_bcast"] == (nranks - 1) * 32 * (6 * 4 + 4)
    live = np.setdiff1d(np.arange(320), doomed)
    d = pair_dists(pts[300:], pts[live], metric)
    want = {(int(gids[a]), int(live[b])) for a, b in zip(*np.nonzero(d <= eps))
            if gids[a] != live[b]}
    assert set(zip(src.tolist(), dst.tolist())) == want


def test_online_counters_match_reference_8_ranks(ref_runs):
    """LADDER_8's schedule on 8 logical ranks: the graph, the compactions
    and every counter (the build's and the deltas') equal the reference's
    8-device run."""
    lad = LADDER_8
    o, _ = run_ladder(lad["metric"], lad["partition"], lad["backend"],
                      lad["seed"], lad["nranks"])
    ref = ref_runs["ladder"]
    np.testing.assert_array_equal(o.graph.edge_key(), ref["edge_key"])
    assert o.graph.meta["compactions"] == ref["compactions"]
    for k, v in ref["stats"].items():
        assert getattr(o.stats, k) == v, k
    assert o.stats.comm_bytes == ref["comm_bytes"]


# ---------------------------------------------------------------------------
# (e) OnlineNNG ladders: exact after every operation
# ---------------------------------------------------------------------------

def run_ladder(metric, partition, backend, seed, nranks, check=None):
    """The reference ladder's schedule (tests/test_stream.py): build on 320
    points, then insert, insert, delete, insert, insert in batches of 20,
    ``compact_ratio`` 0.25 so compaction fires."""
    rng = np.random.default_rng(seed)
    pool = synthetic_pointset(420, 6, metric, seed=seed)
    eps = safe_eps(pool, metric)
    o = OnlineNNG(pool[:320], eps, metric=metric, partition=partition,
                  insert_backend=backend, compact_ratio=0.25, seed=seed,
                  mesh=make_nng_mesh(nranks, "cpu"))
    if check:
        check(o, eps, "initial")
    cursor = 320
    for step in range(5):
        if step % 3 == 2:
            o.delete(rng.choice(np.flatnonzero(o.live), size=20,
                                replace=False))
        else:
            new = o.insert(pool[cursor:cursor + 20])
            assert (new == np.arange(cursor, cursor + 20)).all()
            cursor += 20
        if check:
            check(o, eps, f"step {step}")
    return o, eps


def brute_check(o, eps, tag):
    live = np.flatnonzero(o.live)
    gb = brute_force_graph(o.points[live], eps, o.metric.name)
    bkey = np.sort(live[gb.src] * o.graph.n + live[gb.dst])
    np.testing.assert_array_equal(
        o.graph.edge_key(), bkey,
        err_msg=f"{tag}: merged view != float64 brute force on live points")


@pytest.mark.parametrize("nranks,metric,partition,backend", [
    (3, "euclidean", "point", "host"),
    (3, "hamming", "spatial", "device"),
    (8, "euclidean", "spatial", "host"),
    (8, "hamming", "point", "device"),
])
def test_online_nng_ladder(nranks, metric, partition, backend):
    """The reference's four ladder settings on logical rings of 3 and 8
    ranks: the merged view equals the float64 brute force after every
    operation, compaction fires, and an explicit compaction is
    invisible."""
    o, eps = run_ladder(metric, partition, backend, 13 + nranks, nranks,
                        check=brute_check)
    assert o.graph.meta["compactions"] >= 1, "compaction never fired"
    assert o.graph.meta["online"] == {"inserts": 4, "deletes": 1,
                                      "insert_backend": backend}
    assert o.stats.update_s > 0 and o.stats.edges_removed > 0
    assert o.last_update_stats.dists_evaluated > 0
    key = o.graph.edge_key()
    o.compact()
    np.testing.assert_array_equal(o.graph.edge_key(), key)
    brute_check(o, eps, "post-compact")


def test_online_nng_single_rank_delete_all_but_one():
    """Delete down to one live point on one rank, then keep inserting: ids
    are never reused, and deleting a dead id is a no-op."""
    pts = synthetic_pointset(96, 4, "euclidean", seed=5)
    eps = safe_eps(pts, "euclidean")
    o = OnlineNNG(pts[:64], eps, compact_ratio=None, device="cpu")
    o.delete(np.arange(1, 64))
    assert o.num_live == 1 and o.graph.num_edges == 0
    new = o.insert(pts[64:96])
    assert (new == np.arange(64, 96)).all()
    brute_check(o, eps, "after the inserts")
    assert o.delete([3]) == 0
    assert "compactions" not in o.graph.meta
    with pytest.raises(ValueError, match="insert_backend"):
        OnlineNNG(pts, eps, insert_backend="gpu", device="cpu")


def test_host_inserts_out_of_parent_order(monkeypatch):
    """Host inserts keep the reference's superset child ranges, so a new
    child can land after another node's children (``nng_run --algo
    landmark --updates 3`` on 8 ranks does so at its second insert): the
    traversal's child ranges then span other nodes' children, and its
    levels walked from pair lists and densely still give the same pairs
    and counters, and the merged view the float64 brute force."""
    from repro_torch.core.distributed import DeviceForest
    from repro_torch.core.distributed import device as tdev
    pts = synthetic_pointset(256, 6, seed=0)
    o = OnlineNNG(pts[:184], 1.5, partition="spatial", k_cap=256,
                  mesh=make_nng_mesh(8, "cpu"))
    for lo in (184, 208):
        o.insert(pts[lo:lo + 24])
    brute_check(o, 1.5, "after the inserts")
    cell, parent = o._stacked["cell"], o._stacked["parent"]
    unordered = 0
    for r in range(8):
        for lvl in range(1, cell.shape[1]):
            par = parent[r, lvl][cell[r, lvl] >= 0]
            unordered += int((par[1:] < par[:-1]).any())
    assert unordered > 0, "no level out of parent order"
    forest = DeviceForest.from_tables(o._stacked)
    out = {}
    for name, div in (("pairs", 1), ("dense", 1 << 40)):
        monkeypatch.setattr(tdev, "SPARSE_DIV", div)
        src, dst, st = delta_run(pts[232:256], np.arange(232, 256), forest,
                                 1.5, o.mesh, k_cap=256)
        out[name] = (sorted(zip(src.tolist(), dst.tolist())),
                     st.dists_evaluated, st.nodes_pruned)
    assert out["pairs"] == out["dense"]
    assert len(out["pairs"][0]) > 0


@pytest.mark.parametrize("metric,partition", [("euclidean", "spatial"),
                                              ("hamming", "point")])
def test_delta_counters_independent_of_padded_width(metric, partition):
    """The delta traversal's pairs and counters do not depend on how wide
    the stacked tables are padded (the device insert backend doubles them
    on overflow, on every process when any process overflows)."""
    pts = synthetic_pointset(200, 6, metric, seed=3)
    eps = safe_eps(pts, metric)
    o = OnlineNNG(pts[:180], eps, metric=metric, partition=partition,
                  insert_backend="device", k_cap=512,
                  mesh=make_nng_mesh(3, "cpu"))
    o.insert(pts[180:190])
    wide = _grow_stacked(_grow_stacked(o._stacked))
    assert wide["cell"].shape[2] == 4 * o._stacked["cell"].shape[2]
    outs = [delta_run(pts[190:200], np.arange(190, 200), t, eps, o.mesh,
                      metric=metric, k_cap=512)
            for t in (o._stacked, wide)]
    (s0, d0, st0), (s1, d1, st1) = outs
    assert np.array_equal(s0, s1) and np.array_equal(d0, d1)
    assert (st0.dists_evaluated, st0.nodes_pruned) == \
        (st1.dists_evaluated, st1.nodes_pruned)
    assert st0.dists_evaluated > 0
