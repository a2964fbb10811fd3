"""The port's cover-tree path against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference's host
builder, device builder, traversal, ring planner and ``build_nng(traversal=
"tree")``, and through the port's copies of them (``device="cpu"``, the
plain PyTorch versions of the kernels). Float comparisons use an eps in a
gap between pair distances (none within 1e-4·eps of it), so fp32 summation
order cannot flip a pair; the forest tables must match exactly, radii to
fp32 tolerance. The counters and every ``comm_bytes`` channel must equal
the reference's 8-device run.
"""
import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covertree as rct
from repro.core import flat_tree as rft
from repro.core.distributed import DeviceForest as RefForest
from repro.core.distributed import plan_ring_schedule as ref_plan
from repro.core.distributed import tree_traverse as ref_traverse
from repro.core.flat_tree_device import \
    build_block_forests_device as ref_build_device
from repro.core.flat_tree_device import estimate_max_levels as ref_estimate
from repro.core.metrics import get_metric as ref_get_metric
from repro.nng import build_nng as ref_build_nng
from repro_torch.core import covertree as tct
from repro_torch.core import flat_tree as tft
from repro_torch.core.brute import brute_force_graph
from repro_torch.core.distributed import (DeviceForest, make_nng_mesh,
                                          plan_ring_schedule, tree_traverse)
from repro_torch.core.flat_tree_device import (build_block_forests_device,
                                               estimate_max_levels)
from repro_torch.core.graph import EpsGraph
from repro_torch.core.metrics import Metric, get_metric
from repro_torch.core.metrics_host import HostMetric
from repro_torch.data import blocked_clusters, synthetic_pointset
from repro_torch.nng import build_nng
from tests.helpers import run_subprocess
from tests.test_torch_nng import gap_safe_eps

SENTINEL = 2**31 - 1


def cpu_mesh(nranks):
    return make_nng_mesh(nranks, device="cpu")


def as_numpy(tables):
    return {k: np.asarray(v) for k, v in tables.items()}


# ---------------------------------------------------------------------------
# (c) the host builder: the port's copy gives the reference's tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,leaf_size,seed", [(300, 5, 10, 3),
                                                (129, 2, 4, 8),
                                                (64, 16, 1, 21)])
def test_host_covertree_and_flat_tables_match_reference(n, d, leaf_size,
                                                        seed):
    pts = synthetic_pointset(n, d, seed=seed)
    ours = tct.build_covertree(pts, "euclidean", leaf_size)
    ref = rct.build_covertree(pts, "euclidean", leaf_size)
    for key in ("node_pt", "node_radius", "node_parent", "node_level",
                "is_leaf", "from_split", "child_start", "child_list",
                "leaf_lo", "leaf_hi", "leaf_pts"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(ref, key),
                                      err_msg=key)
    ours.check_invariants()
    flat_o = tft.flatten_forest([ours])
    flat_r = rft.flatten_forest([ref])
    for key in ("node_gid", "node_radius", "node_cell", "node_leaf",
                "parent_pos", "child_lo", "child_hi", "leaf_lo", "leaf_hi",
                "leaf_ids"):
        np.testing.assert_array_equal(getattr(flat_o, key),
                                      getattr(flat_r, key), err_msg=key)
    # the flat host query is the float64 oracle of the traversal
    eps = gap_safe_eps(pts, 0.1)
    qo, po = flat_o.query_host(pts, eps)
    qr, pr = flat_r.query_host(pts, eps)
    np.testing.assert_array_equal(qo, qr)
    np.testing.assert_array_equal(po, pr)


def test_stacked_block_forests_match_reference():
    pts = synthetic_pointset(384, 6, seed=5)
    ours = tft.stack_device_forests(tft.build_block_forests(pts, 3, "euclidean",
                                                            leaf_size=6))
    ref = rft.stack_device_forests(rft.build_block_forests(pts, 3, "euclidean",
                                                           leaf_size=6))
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


# ---------------------------------------------------------------------------
# (d) the on-card builder (torch, here on the CPU) against both references
# ---------------------------------------------------------------------------

def _assert_forest_parity(host_forests, dev, tag):
    """Stacked host tables vs a device dict: same levels, same valid slots,
    identical structure on every valid slot, radii to fp32 tolerance."""
    host = rft.stack_device_forests(host_forests)
    dev = as_numpy(dev)
    Lh, Nh = host["radius"].shape[1:]
    Ld, Nd = dev["radius"].shape[1:]
    assert Ld == Lh, (tag, "levels", Lh, Ld)
    N = min(Nh, Nd)
    vh = host["cell"][:, :, :N] != rft.PAD
    assert np.array_equal(vh, dev["cell"][:, :, :N] != rft.PAD), tag
    assert (dev["cell"][:, :, N:] == rft.PAD).all(), tag
    assert (host["cell"][:, :, N:] == rft.PAD).all(), tag
    for key in ("cell", "leaf", "parent", "leaf_lo", "leaf_hi"):
        assert np.array_equal(host[key][:, :, :N][vh],
                              dev[key][:, :, :N][vh]), (tag, key)
    assert np.array_equal(host["coords"][:, :, :N][vh],
                          dev["coords"][:, :, :N][vh]), tag
    assert np.array_equal(host["leaf_ids"], dev["leaf_ids"]), tag
    rh = host["radius"][:, :, :N][vh]
    rd = dev["radius"][:, :, :N][vh]
    assert np.abs(rh - rd).max() <= 1e-5 * max(1.0, float(np.abs(rh).max()))
    for r, ft in enumerate(host_forests):
        L0, N0 = ft.node_gid.shape
        m = ft.node_cell != rft.PAD
        for key, hostt in (("child_lo", ft.child_lo),
                           ("child_hi", ft.child_hi)):
            assert np.array_equal(hostt[m], dev[key][r, :L0, :N0][m]), (
                tag, r, key)


@pytest.mark.parametrize("n,d,nranks,leaf_size,seed",
                         [(512, 8, 4, 7, 17), (600, 3, 3, 2, 4),
                          (256, 32, 8, 10, 9)])
def test_device_forest_structural_parity(n, d, nranks, leaf_size, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    host = rft.build_block_forests(pts, nranks, "euclidean",
                                   leaf_size=leaf_size)
    ours = build_block_forests_device(pts, nranks, "euclidean",
                                      leaf_size=leaf_size,
                                      include_child_ranges=True,
                                      device="cpu")
    _assert_forest_parity(host, ours, "port vs host")
    # the traversal derives the same child ranges from the parent slots
    fr = DeviceForest.from_tables(ours)
    valid = ours["cell"] != rft.PAD
    n_ch = ours["child_hi"] - ours["child_lo"]
    assert torch.equal((fr.child_hi - fr.child_lo)[valid], n_ch[valid])
    assert torch.equal(fr.child_lo[valid & (n_ch > 0)],
                       ours["child_lo"][valid & (n_ch > 0)])
    ref = as_numpy(ref_build_device(pts, nranks, "euclidean",
                                    leaf_size=leaf_size,
                                    include_child_ranges=True))
    ours = as_numpy(ours)
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        if key != "radius":
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    # radii: fp32 sums in another order, a few rounding units apart
    np.testing.assert_allclose(ours["radius"], ref["radius"], rtol=1e-6,
                               atol=0)


def test_device_forest_regrows_levels():
    """A first table of 2 levels is too shallow; the build regrows it and
    gives the same forest as a deep enough start."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(256, 4)).astype(np.float32)
    a = build_block_forests_device(pts, 2, leaf_size=3, max_levels=2,
                                   device="cpu")
    b = build_block_forests_device(pts, 2, leaf_size=3, max_levels=64,
                                   device="cpu")
    assert a["radius"].shape[1] > 2
    for key in b:
        assert torch.equal(a[key], b[key]), key
    assert estimate_max_levels(pts, get_metric("euclidean")) == \
        ref_estimate(pts, ref_get_metric("euclidean"))


def test_device_build_collinear_scale_regression():
    """Collinear fp32 points at coordinate scale ~1e8: the builder's
    diff-form rowwise distances keep radii exact enough that the traversal
    (fp32 slack) drops no boundary neighbour."""
    S = float(2**17)
    M = 80
    rng = np.random.default_rng(0)
    ms = np.sort(rng.choice(400, size=200, replace=False))
    pts = (ms[:, None] * S * np.ones((1, 2))).astype(np.float32)
    eps = float(np.sqrt(2.0 * (M * S) ** 2))
    want = int((np.abs(ms[:, None] - ms[None, :]) <= M).sum() - len(ms))

    tabs = build_block_forests_device(pts, 1, "euclidean", leaf_size=4,
                                      device="cpu")
    fr = DeviceForest.from_tables(tabs).rank(0)
    n = len(pts)
    nbrs, cnt, _, _ = tree_traverse(
        torch.from_numpy(pts), torch.arange(n, dtype=torch.int32),
        torch.zeros(n, dtype=torch.int32), fr, eps, 256, "euclidean")
    assert int(cnt.sum()) == want
    nbrs = nbrs.numpy()
    ii, kk = np.nonzero(nbrs != SENTINEL)
    assert (np.abs(ms[ii] - ms[nbrs[ii, kk]]) <= M).all()


# ---------------------------------------------------------------------------
# (e) one traversal against the reference's, on one forest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_chunk,sparse_div", [(None, 16), (37, 16),
                                                (None, 1), (64, 10**9)])
def test_tree_traverse_matches_reference(monkeypatch, q_chunk, sparse_div):
    """Also with every level's active mask built from the pair list
    (``SPARSE_DIV`` 1) and with every one built densely (a huge one)."""
    from repro_torch.core.distributed import device
    monkeypatch.setattr(device, "SPARSE_DIV", sparse_div)
    pts = synthetic_pointset(400, 5, seed=31)
    eps = gap_safe_eps(pts, 0.05)
    tabs = rft.stack_device_forests(rft.build_block_forests(pts, 2,
                                                            "euclidean"))
    one = {k: v[1] for k, v in tabs.items()}     # block 1's forest
    q = pts[:200]
    qids = np.arange(200, dtype=np.int32)
    qcells = np.zeros(200, np.int32)
    rn, rc, rd, rp = ref_traverse(jnp.asarray(q), jnp.asarray(qids),
                                  jnp.asarray(qcells),
                                  RefForest.from_tables(one), eps, 32,
                                  "euclidean")
    tn, tc, td, tp = tree_traverse(torch.from_numpy(q),
                                   torch.from_numpy(qids),
                                   torch.from_numpy(qcells),
                                   DeviceForest.from_tables(one), eps, 32,
                                   "euclidean", q_chunk=q_chunk)
    assert int(np.asarray(rc).sum()) > 100
    np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    assert int(td) == float(rd) and int(tp) == float(rp)
    assert int(tp) > 0


def test_tree_traverse_self_pairs_and_ghost_bits():
    pts = synthetic_pointset(96, 3, seed=2)
    tabs = tft.stack_device_forests(tft.build_block_forests(pts, 1))
    fr = DeviceForest.from_tables(tabs).rank(0)
    ids = torch.arange(96, dtype=torch.int32)
    x = torch.from_numpy(pts)
    nbrs, cnt, _, _ = tree_traverse(x, ids, torch.zeros(96, dtype=torch.int32),
                                    fr, 0.0, 8, "euclidean")
    assert int(cnt.sum()) == 0 and bool((nbrs == SENTINEL).all())
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        tree_traverse(x, ids, None, fr, 1.0, 8, "euclidean",
                      qghost_bits=torch.zeros((96, 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# (f) the split ring's planner
# ---------------------------------------------------------------------------

def test_plan_ring_schedule_matches_reference():
    dense = synthetic_pointset(800, 4, seed=1)
    assert plan_ring_schedule(dense, 8, 1.0) == ref_plan(dense, 8, 1.0) == \
        ("forest",) * 4
    far = blocked_clusters(1600, 4, 8, seed=4)
    assert plan_ring_schedule(far, 8, 1.0) == ref_plan(far, 8, 1.0) == \
        ("points",) * 4
    assert plan_ring_schedule(far, 8, 1.0, prune=False) == ("forest",) * 4
    assert plan_ring_schedule(far, 1, 1.0) == ()
    mixed = _mixed_blocks()
    modes = plan_ring_schedule(mixed, 8, 1.0)
    assert modes == ref_plan(mixed, 8, 1.0) == \
        ("forest", "points", "points", "points")


def _mixed_blocks():
    """8 blocks of 64 points on a line: ring neighbours overlap, so round 1
    is dense, and blocks further apart do not — except that block 4 sits on
    block 0 and near block 1, so "points" rounds 3 and 4 each still
    evaluate one tile pair."""
    rng = np.random.default_rng(6)
    ctr = np.zeros((8, 4))
    ctr[:, 0] = [0.0, 1.8, 3.6, 5.4, 0.0, 9.0, 10.8, 12.6]
    pts = np.repeat(ctr, 64, axis=0) + rng.normal(size=(512, 4)) * 0.25
    return pts.astype(np.float32)


def tree_safe_eps(pts, nranks, target, rel=5e-5):
    """An eps near ``target`` that no tree decision of the ring sits near.

    Leaves and dense tiles decide d(q, p) <= eps; an internal node v
    decides d(q, v) + r_v <= eps - slack (emit) and d(q, v) - r_v <= eps +
    slack (expand), slack ~ 2e-5·eps. Two fp32 evaluations of d (the
    port's eager torch and the reference's fused XLA program) differ by a
    few rounding units of ‖q‖² + ‖v‖², which is ~1e-5·eps on these points,
    so a pair whose d ± r_v lies that close to eps may be decided
    differently and move the work counters (not the edges). This eps keeps
    every such value — all pair distances, and d ± r_v for every point
    against every internal node of every rank's forest — at least
    ``rel``·eps away."""
    x = pts.astype(np.float64)
    vals = [np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)).ravel()]
    tabs = tft.stack_device_forests(tft.build_block_forests(pts, nranks))
    for f in range(nranks):
        inner = (tabs["cell"][f] >= 0) & (tabs["leaf"][f] == 0)
        ctr = tabs["coords"][f][inner].astype(np.float64)
        rad = tabs["radius"][f][inner].astype(np.float64)
        d = np.sqrt(((x[:, None, :] - ctr[None, :, :]) ** 2).sum(-1))
        vals += [(d + rad).ravel(), (d - rad).ravel()]
    v = np.unique(np.concatenate(vals))
    i = int(np.searchsorted(v, target))
    lo, hi = max(i - 5000, 0), min(i + 5000, len(v) - 1)
    mid = 0.5 * (v[lo:hi] + v[lo + 1:hi + 1])
    ok = (v[lo + 1:hi + 1] - v[lo:hi]) > 2 * rel * mid
    assert ok.any(), "no tree-safe eps near the target"
    return float(mid[ok][np.argmin(np.abs(mid[ok] - target))])


def eps_near(pts, target):
    """An eps in the widest gap between float64 pair distances near
    ``target``, at least 1e-4·eps away from every pair."""
    x = pts.astype(np.float64)
    d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    return gap_safe_eps(pts, float(np.searchsorted(
        np.sort(d[np.triu_indices(len(x), 1)]), target))
        / (len(x) * (len(x) - 1) // 2))


# ---------------------------------------------------------------------------
# (g) build_nng(traversal="tree") against float64 and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def case():
    pts = synthetic_pointset(203, 6, seed=13)
    eps = gap_safe_eps(pts, 0.08)
    oracle = brute_force_graph(pts, eps)
    assert oracle.num_edges > 500
    ref = ref_build_nng(pts, eps, traversal="tree")
    return pts, eps, oracle, ref


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("nranks", [1, 2, 3, 5, 8])
def test_tree_build_nng_matches_brute_and_reference(case, nranks, backend,
                                                    overlap):
    pts, eps, oracle, ref = case
    g = build_nng(pts, eps, mesh=cpu_mesh(nranks), traversal="tree",
                  forest_backend=backend, overlap=overlap)
    assert g == oracle
    np.testing.assert_array_equal(g.edge_key(), ref.edge_key())
    assert g.meta["traversal"] == "tree"
    assert g.meta["forest_backend"] == backend
    assert ("ring_schedule" in g.meta) == overlap
    assert g.stats.build_s > 0.0
    assert g.stats.dists_evaluated > 0


def test_tree_one_rank_stats_and_meta_match_reference(case):
    pts, eps, _, ref = case
    g = build_nng(pts, eps, device="cpu", traversal="tree")
    assert set(g.meta) == set(ref.meta)
    for key in ref.meta:
        assert g.meta[key] == ref.meta[key], key
    for field in ("tiles_scheduled", "tiles_skipped", "dists_evaluated",
                  "nodes_pruned", "replans"):
        assert getattr(g.stats, field) == getattr(ref.stats, field), field
    assert g.stats.comm_bytes == ref.stats.comm_bytes


def test_tree_k_cap_one_replans_to_exact(case):
    pts, eps, oracle, _ = case
    g = build_nng(pts, eps, mesh=cpu_mesh(3), traversal="tree", k_cap=1)
    assert g == oracle
    assert g.stats.replans == 1


def test_tree_tiles_agree_on_mixed_schedule():
    """A split schedule with "points" rounds that evaluate: the tree graph
    equals the tiles graph and the float64 oracle."""
    pts = _mixed_blocks()
    eps = eps_near(pts, 1.0)
    t = build_nng(pts, eps, mesh=cpu_mesh(8), traversal="tree")
    assert t.meta["ring_schedule"] == ("forest", "points", "points",
                                       "points")
    oracle = brute_force_graph(pts, eps)
    assert t == build_nng(pts, eps, mesh=cpu_mesh(8)) == oracle
    # the "points" rounds evaluate: blocks 0 and 4 share their cluster
    src, dst = np.divmod(oracle.edge_key(), len(pts))
    assert ((src // 64 == 0) & (dst // 64 == 4)).any()


def test_tree_cdist_only_metric_end_to_end():
    """A user metric with only a host reference and a torch ``cdist`` runs
    the tree path through the generic frontier and builder paths."""

    class HostChebyshev(HostMetric):
        name = "chebyshev"

        def cdist(self, x, y):
            return np.abs(np.asarray(x, np.float64)[:, None, :]
                          - np.asarray(y, np.float64)[None, :, :]).max(-1)

        def rowwise(self, x, y):
            return np.abs(np.asarray(x, np.float64)
                          - np.asarray(y, np.float64)).max(-1)

        def true(self, c):
            return np.asarray(c, np.float64)

        def comparable(self, eps):
            return float(eps)

    def cheb_cdist(x, y):
        return (x[:, None, :] - y[None, :, :]).abs().amax(-1)

    met = Metric(name="chebyshev", host=HostChebyshev(), cdist=cheb_cdist)
    pts = synthetic_pointset(150, 5, seed=11)
    d = HostChebyshev().cdist(pts, pts)
    vals = np.sort(d[np.triu_indices(len(pts), 1)])
    k = int(len(vals) * 0.03)
    j = k + int(np.argmax(vals[k + 1:k + 800] - vals[k:k + 799]))
    eps = 0.5 * (vals[j] + vals[j + 1])
    ii, jj = np.nonzero(np.triu(d <= eps, 1))
    oracle = EpsGraph(len(pts), ii, jj)
    assert oracle.num_edges > 100
    for nranks, backend in ((1, "device"), (4, "device"), (4, "host")):
        g = build_nng(pts, eps, metric=met, mesh=cpu_mesh(nranks), k_cap=16,
                      traversal="tree", forest_backend=backend)
        assert g == oracle, (nranks, backend)


# ---------------------------------------------------------------------------
# (h) counter parity with the reference's 8-device run
# ---------------------------------------------------------------------------

REF_8DEV = """
import hashlib, json, sys
import numpy as np
from repro.nng import build_nng
out = []
with np.load(sys.argv[1]) as f:
    for key in ("dense", "mixed"):
        pts, eps = f[key], float(f[key + "_eps"])
        g = build_nng(pts, eps, partition="point", traversal="tree",
                      k_cap=256)
        st = g.stats
        out.append({
            "plan": g.meta["plan"], "edges": g.num_edges,
            "edge_sha": hashlib.sha256(g.edge_key().tobytes()).hexdigest(),
            "ring_schedule": list(g.meta["ring_schedule"]),
            "tiles_scheduled": st.tiles_scheduled,
            "tiles_skipped": st.tiles_skipped,
            "dists_evaluated": st.dists_evaluated,
            "nodes_pruned": st.nodes_pruned,
            "comm_bytes": st.comm_bytes})
print(json.dumps(out))
"""


def test_tree_counters_match_reference_8dev(tmp_path):
    """Dense overlapping blocks (every round "forest") and the mixed layout
    ("points" rounds that evaluate), against the reference on 8 devices."""
    cases = {"dense": synthetic_pointset(800, 4, seed=1),
             "mixed": _mixed_blocks()}
    eps = {k: tree_safe_eps(v, 8, 1.0) for k, v in cases.items()}
    path = tmp_path / "cases.npz"
    np.savez(path, **cases, **{k + "_eps": v for k, v in eps.items()})
    code = f"import sys; sys.argv[1:] = [{str(path)!r}]\n" + REF_8DEV
    refs = json.loads(run_subprocess(code, devices=8).strip()
                      .splitlines()[-1])
    for key, ref in zip(("dense", "mixed"), refs):
        g = build_nng(cases[key], eps[key], mesh=cpu_mesh(8),
                      traversal="tree", k_cap=256)
        st = g.stats
        assert st.nodes_pruned > 0, key
        assert g.meta["plan"] == ref["plan"], key
        assert g.num_edges == ref["edges"], key
        assert hashlib.sha256(g.edge_key().tobytes()).hexdigest() == \
            ref["edge_sha"], key
        assert list(g.meta["ring_schedule"]) == ref["ring_schedule"], key
        for field in ("tiles_scheduled", "tiles_skipped", "dists_evaluated",
                      "nodes_pruned"):
            assert getattr(st, field) == ref[field], (key, field)
        assert st.comm_bytes == ref["comm_bytes"], key
        assert {"ring_forest", "ring_points", "ring_mirror",
                "ring_summary"} == set(st.comm_bytes), key
    assert refs[0]["ring_schedule"] == ["forest"] * 4
    assert "points" in refs[1]["ring_schedule"]
