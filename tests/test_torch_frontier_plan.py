"""The L2 and L1 frontier kernels' live-tile plan and the tree ring's query
order, on the CPU.

``kernels.tree_frontier.frontier_tile_plan`` lists the tiles of a frontier
launch whose active words are not all zero, the live ones first; the
pipelined frontier kernels walk only those. The tree flavour of the ring
hands each block's queries in its forest's DFS order
(``device.dfs_row_order``), which makes most tiles dead. Neither may move a
result: the plain frontier's words are zero on every dead tile, a
traversal of permuted rows gives the same neighbours, counts and counters
once its rows are put back, and the ring gives what it gives with the rows
in the caller's order. Float comparisons use an eps that no tree decision
sits near (``tree_safe_eps``), so a pass's fp32 arithmetic cannot flip a
pair; Hamming is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distributed import DeviceForest as RefForest
from repro.core.distributed import tree_traverse as ref_traverse
from repro_torch.core import flat_tree as tft
from repro_torch.core.distributed import (DeviceForest, dfs_row_order,
                                          make_nng_mesh, systolic_run,
                                          tree_traverse)
from repro_torch.core.distributed import device as tdev
from repro_torch.core.metrics import get_metric
from repro_torch.data import synthetic_pointset
from repro_torch.kernels import ops as tops
from repro_torch.kernels.nng_tile import PIPE_TILE, pack_words, unpack_words
from repro_torch.kernels.tree_frontier import frontier_tile_plan
from tests.test_torch_kernels_gpu import frontier_case
from tests.test_torch_tree import tree_safe_eps

SENTINEL = 2**31 - 1
METRICS = ["euclidean", "manhattan", "hamming"]


def live_np(words, rows, wds):
    """The numpy OR over each (rows x wds) block of a (nq, nw) word array,
    blocks numbered row after row."""
    nq, nw = words.shape
    mt, nt = -(-nq // rows), -(-nw // wds)
    live = np.zeros(mt * nt, bool)
    for t in range(mt * nt):
        r0, w0 = t // nt * rows, t % nt * wds
        live[t] = bool(np.any(words[r0:r0 + rows, w0:w0 + wds] != 0))
    return live


def words_case(kind, nq, nw, seed):
    """(nq, nw) int32 active words: sparse random words with about one
    word in 60 nonzero ("sparse"), none ("dead"), all ("live"), or one bit
    ("one", in the last row's last word, so the ragged corner tile)."""
    rng = np.random.default_rng(seed)
    w = np.zeros((nq, nw), np.int32)
    if kind == "sparse":
        hit = rng.random((nq, nw)) < 1 / 60
        w[hit] = rng.integers(1, 2**31, size=int(hit.sum()))
        w[hit[:, ::-1] & (rng.random((nq, nw)) < 0.5)] = -2**31   # bit 31
    elif kind == "live":
        w[:] = rng.integers(1, 2**31, size=(nq, nw))
    elif kind == "one":
        w[-1, -1] = 1 << 5
    return w


PLAN_CASES = [("sparse", 64, 8), ("sparse", 130, 17), ("sparse", 1000, 9),
              ("sparse", 7, 3), ("sparse", 300, 400), ("dead", 130, 17),
              ("live", 130, 17), ("live", 64, 8), ("one", 130, 17),
              ("one", 64, 8), ("one", 1, 1)]


@pytest.mark.parametrize("kind,nq,nw", PLAN_CASES)
@pytest.mark.parametrize("rows,wds", [PIPE_TILE[:1] + (PIPE_TILE[1] // 32,),
                                      (128, 4)])
def test_frontier_tile_plan_lists_live_tiles_first(kind, nq, nw, rows, wds):
    """The live flags are the numpy OR over each tile's words, ragged nq
    and nw included; the list is a permutation of all tiles, the live ones
    first, each part ascending, and the count is theirs."""
    words = words_case(kind, nq, nw, nq + nw)
    tiles, count = frontier_tile_plan(torch.from_numpy(words), rows, wds)
    want = live_np(words, rows, wds)
    n_live = int(want.sum())
    assert tiles.dtype == torch.int32 and count.dtype == torch.int32
    assert count.shape == (1,) and int(count[0]) == n_live
    t = tiles.numpy()
    assert sorted(t.tolist()) == list(range(len(want)))
    assert (t[:n_live] == np.flatnonzero(want)).all()
    assert (t[n_live:] == np.flatnonzero(~want)).all()
    assert {"dead": 0, "live": len(want), "one": 1}.get(kind, n_live) \
        == n_live


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("nq,n", [(130, 700), (300, 544), (200, 256)])
def test_frontier_dead_tiles_hold_no_decision(metric, nq, n):
    """The plain frontier's emit and expand words are zero on every tile
    that the plan leaves out, so a kernel that stores only the live tiles
    into zeroed words gives the whole function."""
    q, c, rad, leaf, act, eps = frontier_case(nq, n, 9, nq + n,
                                              metric=metric)
    act[:, 300:] = False                     # whole dead tiles
    act[64:128] = False
    tq, tc, trad, tleaf = (torch.from_numpy(a) for a in (q, c, rad, leaf))
    tact = pack_words(torch.from_numpy(np.pad(act, ((0, 0), (0, -n % 32)))))
    e, x = tops.tree_frontier_step(tq, tc, trad, tleaf, tact, eps,
                                   metric=metric)
    rows, wds = PIPE_TILE[0], PIPE_TILE[1] // 32
    tiles, count = frontier_tile_plan(tact, rows, wds)
    dead = tiles[int(count[0]):].numpy()
    assert len(dead) > 0 and int(count[0]) > 0
    assert int(unpack_words(e).sum()) > 0 and int(unpack_words(x).sum()) > 0
    nt = -(-tact.shape[1] // wds)
    for t in dead.tolist():
        r0, w0 = t // nt * rows, t % nt * wds
        assert not e[r0:r0 + rows, w0:w0 + wds].any()
        assert not x[r0:r0 + rows, w0:w0 + wds].any()


def forests(pts, nranks, metric):
    """The port's stacked host-built block forests -> (numpy tables,
    DeviceForest with a rank axis)."""
    tabs = tft.stack_device_forests(tft.build_block_forests(pts, nranks,
                                                            metric))
    met = get_metric(metric)
    dev = {k: (met.as_device(v) if k == "coords" else torch.as_tensor(v))
           for k, v in tabs.items()}
    return tabs, DeviceForest.from_tables(dev)


@pytest.mark.parametrize("metric", METRICS)
def test_dfs_row_order_is_the_forest_leaf_order(metric):
    """Each rank's order is a permutation of its rows equal to its valid
    ``leaf_ids`` less its first id."""
    pts = synthetic_pointset(384, 8, metric, seed=5)
    tabs, F = forests(pts, 3, metric)
    for r in range(3):
        order = dfs_row_order(F.rank(r), r * 128)
        lid = tabs["leaf_ids"][r]
        assert order.dtype == torch.int64
        assert sorted(order.tolist()) == list(range(128))
        np.testing.assert_array_equal(order.numpy(),
                                      lid[lid != SENTINEL] - r * 128)


def traversal_case(metric):
    """512 points in 2 blocks, the 2 block forests, and an eps that no tree
    decision sits near (Hamming: an integer radius plus 0.5 is exact)."""
    pts = synthetic_pointset(512, 8, metric, seed=11)
    eps = (40.0 if metric == "hamming"
           else tree_safe_eps(pts, 2, 3.0, metric=metric))
    return pts, eps, forests(pts, 2, metric)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("q_chunk", [128, None])
@pytest.mark.parametrize("sparse_div", [1, 10**9])
@pytest.mark.parametrize("target", [0, 1])
def test_tree_traverse_permuted_rows_match(monkeypatch, metric, q_chunk,
                                           sparse_div, target):
    """Block 0's rows in its forest's DFS order, against its own forest
    (the self round) and block 1's: the same neighbours and counts once
    put back, and the same dists_evaluated and nodes_pruned, with every
    level's mask and emission from pair lists (``SPARSE_DIV`` 1) or dense
    (a huge one), in passes of 128 rows or one pass."""
    monkeypatch.setattr(tdev, "SPARSE_DIV", sparse_div)
    pts, eps, (_, F) = traversal_case(metric)
    met = get_metric(metric)
    q = met.as_device(pts[:256])
    ids = torch.arange(256, dtype=torch.int32)
    cells = torch.zeros(256, dtype=torch.int32)
    fr = F.rank(target)
    order = dfs_row_order(F.rank(0), 0)
    assert not torch.equal(order, torch.arange(256))
    a = tree_traverse(q, ids, cells, fr, eps, 64, metric, q_chunk=q_chunk)
    b = tree_traverse(q[order], ids[order], cells, fr, eps, 64, metric,
                      q_chunk=q_chunk)
    assert int(a[1].sum()) > 100 and int(a[3]) > 0
    inv = torch.empty_like(order)
    inv[order] = torch.arange(256)
    assert torch.equal(b[0][inv], a[0]) and torch.equal(b[1][inv], a[1])
    assert int(b[2]) == int(a[2]) and int(b[3]) == int(a[3])


@pytest.mark.parametrize("metric", METRICS)
def test_permuted_traversal_matches_reference(metric):
    """The port's traversal of block 0's rows in DFS order, put back,
    equals the reference's traversal of the rows in index order."""
    pts, eps, (tabs, F) = traversal_case(metric)
    met = get_metric(metric)
    one = {k: v[1] for k, v in tabs.items()}
    qids = np.arange(256, dtype=np.int32)
    qcells = np.zeros(256, np.int32)
    rn, rc, rd, rp = ref_traverse(jnp.asarray(pts[:256]), jnp.asarray(qids),
                                  jnp.asarray(qcells),
                                  RefForest.from_tables(one), eps, 64,
                                  metric)
    order = dfs_row_order(F.rank(0), 0)
    tn, tc, td, tp = tree_traverse(met.as_device(pts[:256])[order],
                                   torch.from_numpy(qids)[order],
                                   torch.from_numpy(qcells), F.rank(1), eps,
                                   64, metric)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(256)
    assert int(np.asarray(rc).sum()) > 100
    np.testing.assert_array_equal(tn[inv].numpy(), np.asarray(rn))
    np.testing.assert_array_equal(tc[inv].numpy(), np.asarray(rc))
    assert int(td) == float(rd) and int(tp) == float(rp)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("overlap,schedule", [
    (False, None), (True, ("forest", "forest")), (True, ("points", "forest")),
    (True, ("points", "points"))])
def test_ring_order_moves_no_result(monkeypatch, metric, overlap, schedule):
    """The tree ring with each block in its forest's DFS order gives, in
    the caller's row order, what it gives with the rows left in that
    order: neighbours, counts, overflow flags and the work counters, on
    both schedules, with "forest" and "points" rounds (the dense tile pair
    maps its columns through the visiting block's permuted ids)."""
    pts = synthetic_pointset(480, 8, metric, seed=3)
    eps = (40.0 if metric == "hamming"
           else tree_safe_eps(pts, 4, 3.0, metric=metric))
    _, F = forests(pts, 4, metric)
    mesh = make_nng_mesh(4, device="cpu")
    kw = dict(metric=metric, k_cap=128, overlap=overlap,
              traversal="tree", forest=F, ring_schedule=schedule,
              prune=False)
    got = systolic_run(pts, eps, mesh, **kw)
    monkeypatch.setattr(tdev, "dfs_row_order",
                        lambda f, id0: torch.arange(
                            int((f.leaf_ids != SENTINEL).sum())))
    want = systolic_run(pts, eps, mesh, **kw)
    assert int(want[1].sum()) > 200
    assert not bool(want[2].any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
