"""Hamming and Manhattan in the port against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference and the
port (``device="cpu"``: the plain PyTorch versions of the kernels): the
Hamming point sets, the float64 host metrics, the device metric functions,
and ``build_nng`` on both traversals. Hamming distances are exact integers,
so an integer eps needs no gap and everything must be equal. The L1 eps
keeps every pair distance, and every d ± r of a point against an internal
node of each rank's forest, 5e-5·eps away (``tree_safe_eps``): far beyond
the d·u·eps (u = 2^-24) two fp32 summation orders can differ by, so the
edge sets and the work counters must be equal. The counters, every
``comm_bytes`` channel and ``ring_schedule`` must equal the reference's
8-device run.
"""
import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as rmet
from repro.core import metrics_host as rhost
from repro.data import synthetic_pointset as ref_pointset
from repro.nng import build_nng as ref_build_nng
from repro_torch.core import metrics_host as thost
from repro_torch.core.brute import brute_force_graph
from repro_torch.core.distributed import make_nng_mesh
from repro_torch.core.metrics import get_metric
from repro_torch.data import synthetic_pointset
from repro_torch.nng import build_nng
from tests.helpers import run_subprocess
from tests.test_torch_kernels_gpu import hamming_points
from tests.test_torch_tree import tree_safe_eps

METRICS = ["hamming", "manhattan"]
N, DIM, SEED = 1070, 8, 13
U32 = 2.0 ** -24


def cpu_mesh(nranks):
    return make_nng_mesh(nranks, device="cpu")


def case_eps(metric, pts):
    """Hamming: the integer eps of the reference's check (mean degree ~134
    here). L1: a tree-safe eps near 3.0 on the 8-rank forests of the
    points as ``build_nng`` pads them."""
    if metric == "hamming":
        return 40.0
    padded = np.concatenate([pts, pts[:(-len(pts)) % 8]])
    return tree_safe_eps(padded, 8, 3.0, metric="manhattan")


# ---------------------------------------------------------------------------
# data and host metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seed", [0, 5, 13])
def test_pointset_matches_reference(metric, seed):
    """The same rng draws: the reference's exact array, uint32 words for
    hamming."""
    for n, dim in ((N, DIM), (333, 25)):
        ours = synthetic_pointset(n, dim, metric, seed=seed)
        ref = ref_pointset(n, dim, metric, seed=seed)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("metric", METRICS)
def test_host_metric_matches_reference(metric):
    """cdist, rowwise, band_slack, comparable and true equal the
    reference's; HostHamming reads int32 words as a bit view."""
    pts = synthetic_pointset(300, DIM, metric, seed=4)
    x, y = pts[:120], pts[120:]
    ours, ref = thost.get_host_metric(metric), rhost.get_host_metric(metric)
    assert ours.dtype == ref.dtype
    inputs = [(x, y)]
    if metric == "hamming":
        assert (x >= 2**31).any()
        inputs.append((x.view(np.int32), y.view(np.int32)))
    for a, b in inputs:
        np.testing.assert_array_equal(ours.cdist(a, b), ref.cdist(x, y))
        np.testing.assert_array_equal(ours.rowwise(a, b[:120]),
                                      ref.rowwise(x, y[:120]))
        assert ours.band_slack(a, b, 3.0) == ref.band_slack(x, y, 3.0)
    assert ours.comparable(2.5) == ref.comparable(2.5)
    np.testing.assert_array_equal(ours.true(np.arange(5.0)),
                                  ref.true(np.arange(5.0)))


@pytest.mark.parametrize("metric", METRICS)
def test_device_metric_matches_reference(metric):
    """The registry's cdist, rowwise and block summary against the
    reference's: Hamming exact; L1 within d·u of the distance (the port
    sums in the kernels' chunked order, the reference's jnp.sum in its
    own)."""
    pts = synthetic_pointset(300, DIM, metric, seed=4)
    met, ref = get_metric(metric), rmet.get_metric(metric)
    assert met.exact == ref.exact
    xt = met.as_device(pts)
    got = [met.cdist(xt[:100], xt[100:]), met.rowwise(xt[:150], xt[150:]),
           *met.summary(xt)]
    want = [ref.cdist(jnp.asarray(pts[:100]), jnp.asarray(pts[100:])),
            ref.rowwise(jnp.asarray(pts[:150]), jnp.asarray(pts[150:])),
            *ref.summary(jnp.asarray(pts))]
    got[2] = got[2].numpy().view(np.uint32) if metric == "hamming" else got[2]
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if metric == "hamming":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=DIM * U32, atol=0)


def test_metric_as_device_views_words():
    """uint32 words (numpy or torch) enter as their int32 bit view; float
    metrics convert by value."""
    words = np.array([[0xFFFFFFFF, 0x80000000, 7]], np.uint32)
    ham = get_metric("hamming")
    for pts in (words, torch.from_numpy(words), words.view(np.int32)):
        t = ham.as_device(pts, "cpu")
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy().view(np.uint32), words)
    t = get_metric("manhattan").as_device(np.array([[1, 2]], np.int64))
    assert t.dtype == torch.float32 and t.tolist() == [[1.0, 2.0]]


# ---------------------------------------------------------------------------
# the slice: build_nng on both traversals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=METRICS)
def case(request):
    """Points, eps, the float64 oracle and the reference's graphs on one
    JAX device for both traversals."""
    metric = request.param
    pts = synthetic_pointset(N, DIM, metric, seed=SEED)
    eps = case_eps(metric, pts)
    oracle = brute_force_graph(pts, eps, metric)
    assert oracle.num_edges > 10000
    refs = {t: ref_build_nng(pts, eps, metric=metric, traversal=t)
            for t in ("tiles", "tree")}
    return metric, pts, eps, oracle, refs


SLICE_CASES = ([("tiles", r, "device", True) for r in (1, 2, 3, 5, 8)]
               + [("tree", r, "device", True) for r in (1, 2, 3, 5, 8)]
               + [("tree", 3, "host", True), ("tree", 5, "device", False)])


@pytest.mark.parametrize("traversal,nranks,backend,overlap", SLICE_CASES)
def test_metric_build_nng_matches_brute_and_reference(case, traversal,
                                                      nranks, backend,
                                                      overlap):
    metric, pts, eps, oracle, refs = case
    g = build_nng(pts, eps, metric=metric, mesh=cpu_mesh(nranks),
                  traversal=traversal, forest_backend=backend,
                  overlap=overlap)
    assert g == oracle
    np.testing.assert_array_equal(g.edge_key(), refs[traversal].edge_key())
    assert g.meta["metric"] == metric and g.meta["nranks"] == nranks
    assert g.meta["padded"] == (-N) % nranks
    if traversal == "tree":
        assert g.meta["forest_backend"] == backend
        assert ("ring_schedule" in g.meta) == overlap
        assert 0 < g.stats.dists_evaluated < N * N


def test_uint32_points_enter_as_bit_view():
    """numpy uint32 points with the top bit set give the reference's edges,
    as do their int32 view and a torch uint32 tensor."""
    rng = np.random.default_rng(9)
    pts = hamming_points(rng, 400, 3)
    assert (pts == 0xFFFFFFFF).all(1).any() and (pts >= 2**31).any()
    eps = 12.0
    ref = ref_build_nng(pts, eps, metric="hamming")
    oracle = brute_force_graph(pts, eps, "hamming")
    assert ref.num_edges > 1000
    for p in (pts, pts.view(np.int32), torch.from_numpy(pts)):
        for traversal in ("tiles", "tree"):
            g = build_nng(p, eps, metric="hamming", mesh=cpu_mesh(3),
                          traversal=traversal)
            assert g == oracle
            np.testing.assert_array_equal(g.edge_key(), ref.edge_key())


REF_8DEV = """
import hashlib, json, sys
import numpy as np
from repro.nng import build_nng
out = []
with np.load(sys.argv[1]) as f:
    for metric in ("hamming", "manhattan"):
        pts, eps = f[metric], float(f[metric + "_eps"])
        for traversal in ("tiles", "tree"):
            g = build_nng(pts, eps, metric=metric, partition="point",
                          traversal=traversal)
            st = g.stats
            out.append({
                "plan": g.meta["plan"], "edges": g.num_edges,
                "edge_sha": hashlib.sha256(
                    g.edge_key().tobytes()).hexdigest(),
                "ring_schedule": list(g.meta.get("ring_schedule", ())),
                "tiles_scheduled": st.tiles_scheduled,
                "tiles_skipped": st.tiles_skipped,
                "dists_evaluated": st.dists_evaluated,
                "nodes_pruned": st.nodes_pruned,
                "comm_bytes": st.comm_bytes})
print(json.dumps(out))
"""


def test_metric_counters_match_reference_8dev(tmp_path):
    """Both metrics, both traversals, against the reference on 8 devices:
    edges, plan, tiles_scheduled / tiles_skipped / dists_evaluated /
    nodes_pruned, every comm_bytes channel and ring_schedule."""
    pts = {m: synthetic_pointset(N, DIM, m, seed=SEED) for m in METRICS}
    eps = {m: case_eps(m, pts[m]) for m in METRICS}
    path = tmp_path / "cases.npz"
    np.savez(path, **pts, **{m + "_eps": v for m, v in eps.items()})
    code = f"import sys; sys.argv[1:] = [{str(path)!r}]\n" + REF_8DEV
    refs = iter(json.loads(run_subprocess(code, devices=8).strip()
                           .splitlines()[-1]))
    for metric in METRICS:
        for traversal in ("tiles", "tree"):
            ref = next(refs)
            key = (metric, traversal)
            g = build_nng(pts[metric], eps[metric], metric=metric,
                          mesh=cpu_mesh(8), traversal=traversal)
            st = g.stats
            assert g.meta["plan"] == ref["plan"], key
            assert g.num_edges == ref["edges"], key
            assert hashlib.sha256(g.edge_key().tobytes()).hexdigest() == \
                ref["edge_sha"], key
            assert list(g.meta.get("ring_schedule", ())) == \
                ref["ring_schedule"], key
            for field in ("tiles_scheduled", "tiles_skipped",
                          "dists_evaluated", "nodes_pruned"):
                assert getattr(st, field) == ref[field], (key, field)
            assert st.comm_bytes == ref["comm_bytes"], key
            if traversal == "tree":
                assert st.nodes_pruned > 0, key
                assert st.dists_evaluated < N * N / 2, key
