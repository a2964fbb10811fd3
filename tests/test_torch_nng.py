"""The port's ``build_nng`` against the float64 brute force and the JAX
reference, on the CPU.

The same numpy points go through ``repro_torch.nng.build_nng(device="cpu")``
on R logical ranks and through ``repro.nng.build_nng``; eps sits in a gap
between pair distances (none within 1e-4·eps), so fp32 summation order
cannot flip a pair and the edge sets must be equal. The work counters and
every ``comm_bytes`` channel must equal the reference's 8-device run.
"""
import hashlib
import json

import numpy as np
import pytest
import torch

from repro.core.brute import brute_force_graph as ref_brute
from repro.nng import build_nng as ref_build_nng
from repro_torch.core.brute import brute_force_graph
from repro_torch.core.distributed import make_nng_mesh
from repro_torch.core.distributed.device import _ring_permute, systolic_run
from repro_torch.core.graph import EpsGraph, NNGraph
from repro_torch.core.metrics import Metric, get_metric
from repro_torch.core.metrics_host import HostMetric
from repro_torch.data import blocked_clusters, synthetic_pointset
from repro_torch.kernels.bits_epilogue import SENTINEL
from repro_torch.kernels.nng_tile import unpack_words
from repro_torch.kernels.ops import nng_tile_bits
from repro_torch.nng import build_nng
from tests.helpers import run_subprocess


def gap_safe_eps(pts, quantile, rel=1e-4):
    """An eps in the widest gap between float64 pair distances near the
    quantile, at least ``rel``·eps away from every pair."""
    x = pts.astype(np.float64)
    d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    d = np.sort(d[np.triu_indices(len(x), 1)])
    k = int(quantile * len(d))
    lo, hi = max(k - 300, 0), min(k + 300, len(d) - 1)
    j = lo + int(np.argmax(d[lo + 1:hi + 1] - d[lo:hi]))
    eps = 0.5 * float(d[j] + d[j + 1])
    assert np.abs(d - eps).min() > rel * eps, "no gap-safe eps"
    return eps


@pytest.fixture(scope="module")
def case():
    """n = 203 points (divisible by none of 2, 3, 5, 8), a gap-safe eps,
    the float64 oracle, and the reference's graph on one JAX device."""
    pts = synthetic_pointset(203, 6, seed=13)
    eps = gap_safe_eps(pts, 0.08)
    oracle = brute_force_graph(pts, eps)
    assert oracle.num_edges > 500
    ref = ref_build_nng(pts, eps)
    return pts, eps, oracle, ref


def cpu_mesh(nranks):
    return make_nng_mesh(nranks, device="cpu")


@pytest.mark.parametrize("nranks", [1, 2, 3, 5, 8])
def test_build_nng_matches_brute_and_reference(case, nranks):
    pts, eps, oracle, ref = case
    g = build_nng(pts, eps, mesh=cpu_mesh(nranks))
    assert g == oracle
    np.testing.assert_array_equal(g.edge_key(), ref.edge_key())
    assert int(g.row_ptr[-1]) == 2 * oracle.num_edges
    assert (np.diff(g.row_ptr) == g.degrees()).all()
    assert g.meta["nranks"] == nranks
    assert g.meta["padded"] == (-203) % nranks


def test_brute_force_copy_matches_reference(case):
    pts, eps, oracle, _ = case
    np.testing.assert_array_equal(oracle.edge_key(),
                                  ref_brute(pts, eps).edge_key())


def test_one_rank_stats_and_meta_match_reference(case):
    pts, eps, _, ref = case
    g = build_nng(pts, eps, device="cpu")
    assert set(g.meta) == set(ref.meta)
    for key in ("metric", "eps", "partition", "traversal", "nranks",
                "padded", "plan", "overlap"):
        assert g.meta[key] == ref.meta[key], key
    for field in ("tiles_scheduled", "tiles_skipped", "dists_evaluated",
                  "nodes_pruned", "replans"):
        assert getattr(g.stats, field) == getattr(ref.stats, field), field
    assert g.stats.comm_bytes == ref.stats.comm_bytes


def test_tiny_n_below_ring_size():
    pts = synthetic_pointset(3, 4, seed=2)
    eps = gap_safe_eps(pts, 0.5)
    g = build_nng(pts, eps, mesh=cpu_mesh(8))
    assert g == brute_force_graph(pts, eps)
    assert g.meta["padded"] == 5


@pytest.mark.parametrize("nranks", [1, 2])
def test_self_tile_count_excludes_diagonal(nranks):
    # far from the origin the fp32 expansion puts d(x, x) at 0 or below,
    # so the raw self tile hits its diagonal; no row may count itself
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(64, 9)) * 0.1 + 10).astype(np.float32)
    x = torch.from_numpy(pts)
    ones = torch.ones(64, dtype=torch.int32)
    _, bits = nng_tile_bits(x, x, ones, 1e-3)
    assert unpack_words(bits).diagonal().any()
    nbrs, cnt, *_ = systolic_run(pts, 1e-3, cpu_mesh(nranks), k_cap=4)
    assert int(cnt.sum()) == 0
    assert bool((nbrs == SENTINEL).all())


def test_empty_point_set():
    g = build_nng(np.zeros((0, 3), np.float32), 1.0, device="cpu")
    assert g.n == 0 and g.num_edges == 0


@pytest.mark.parametrize("nranks", [5, 8])
def test_overlap_schedules_agree(case, nranks):
    pts, eps, oracle, _ = case
    a = build_nng(pts, eps, mesh=cpu_mesh(nranks), overlap=True)
    b = build_nng(pts, eps, mesh=cpu_mesh(nranks), overlap=False)
    assert a == b == oracle
    for field in ("tiles_scheduled", "tiles_skipped", "dists_evaluated"):
        assert getattr(a.stats, field) == getattr(b.stats, field)
    # the double-buffered ring pays exactly one priming hop per rank
    n_loc = -(-203 // nranks)
    prime = nranks * (n_loc * 6 * 4 + 4)
    assert a.stats.comm_bytes["ring_points"] == \
        b.stats.comm_bytes["ring_points"] + prime
    assert a.stats.comm_bytes["ring_mirror"] == b.stats.comm_bytes["ring_mirror"]


def test_k_cap_one_replans_to_exact(case):
    pts, eps, oracle, _ = case
    g = build_nng(pts, eps, mesh=cpu_mesh(3), k_cap=1)
    assert g == oracle
    assert g.stats.replans == 1
    assert g.meta["plan"] >= int(g.degrees().max())


def test_cdist_only_metric_end_to_end():
    """A user metric with only a host reference and a torch ``cdist`` (no
    kernel, no plain tile) runs through the generic path."""

    class HostChebyshev(HostMetric):
        name = "chebyshev"

        def comparable(self, eps):
            return float(eps)

    def cheb_cdist(x, y):
        return (x[:, None, :] - y[None, :, :]).abs().amax(-1)

    met = Metric(name="chebyshev", host=HostChebyshev(), cdist=cheb_cdist)
    pts = synthetic_pointset(150, 5, seed=11)
    d = np.abs(pts.astype(np.float64)[:, None, :]
               - pts.astype(np.float64)[None, :, :]).max(-1)
    vals = np.sort(d[np.triu_indices(len(pts), 1)])
    k = int(len(vals) * 0.03)
    j = k + int(np.argmax(vals[k + 1:k + 800] - vals[k:k + 799]))
    eps = 0.5 * (vals[j] + vals[j + 1])
    ii, jj = np.nonzero(np.triu(d <= eps, 1))
    oracle = EpsGraph(len(pts), ii, jj)
    assert oracle.num_edges > 100
    for nranks in (1, 4):
        g = build_nng(pts, eps, metric=met, mesh=cpu_mesh(nranks), k_cap=16)
        assert g == oracle, nranks
        assert g.meta["metric"] == "chebyshev"


def test_unported_paths_raise():
    from repro_torch.core.distributed import DeviceForest, tree_traverse
    from repro_torch.core.flat_tree import (build_block_forests,
                                            stack_device_forests)
    pts = synthetic_pointset(16, 3, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        build_nng(pts, 1.0, partition="spatial", device="cpu")
    forest = DeviceForest.from_tables(
        stack_device_forests(build_block_forests(pts, 1))).rank(0)
    x = torch.from_numpy(pts)
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        tree_traverse(x, torch.arange(16, dtype=torch.int32), None, forest,
                      1.0, 4, "euclidean",
                      qghost_bits=torch.zeros((16, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="traversal"):
        build_nng(pts, 1.0, traversal="no-such-traversal", device="cpu")
    for name in ("hamming", "manhattan"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
            get_metric(name)
    with pytest.raises(ValueError):
        get_metric("no-such-metric")


def test_csr_assembly_matches_reference():
    """The torch CSR assembly gives the reference's numpy CSR, with
    padding rows, duplicate-padding ids, self loops and duplicates."""
    from repro.core.graph import NNGraph as RefNNGraph
    sen = 2**31 - 1
    ids = np.array([0, 1, 2, sen, 7])
    nbrs = np.array([[1, 2, sen], [0, sen, sen], [0, sen, sen],
                     [3, 4, 5], [0, 1, 2]], np.int32)
    rng = np.random.default_rng(8)
    src = rng.integers(-2, 60, 500)
    dst = rng.integers(-2, 60, 500)
    for ours, ref in (
            (NNGraph.from_neighbor_tables(6, [(ids, nbrs)]),
             RefNNGraph.from_neighbor_tables(6, [(ids, nbrs)])),
            (NNGraph.from_directed_pairs(55, src, dst),
             RefNNGraph.from_directed_pairs(55, src, dst))):
        np.testing.assert_array_equal(ours.row_ptr, ref.row_ptr)
        np.testing.assert_array_equal(ours.col_ids, ref.col_ids)
        assert ours.col_ids.dtype == ref.col_ids.dtype == np.int32


def test_ring_permute_moves_blocks_one_hop():
    perm = [(i, (i - 1) % 4) for i in range(4)]
    assert _ring_permute(["a", "b", "c", "d"], perm) == ["b", "c", "d", "a"]


# ---------------------------------------------------------------------------
# counter parity with the reference's 8-device run
# ---------------------------------------------------------------------------

REF_8DEV = """
import hashlib, json
import numpy as np
from repro.data import blocked_clusters
from repro.nng import build_nng
pts = blocked_clusters(2048, 8, 8, seed=2)
g = build_nng(pts, 1.0, partition="point", traversal="tiles")
st = g.stats
print(json.dumps({
    "nranks": g.meta["nranks"], "plan": g.meta["plan"],
    "edges": g.num_edges,
    "edge_sha": hashlib.sha256(g.edge_key().tobytes()).hexdigest(),
    "tiles_scheduled": st.tiles_scheduled,
    "tiles_skipped": st.tiles_skipped,
    "dists_evaluated": st.dists_evaluated,
    "comm_bytes": st.comm_bytes}))
"""


def test_counters_match_reference_8dev():
    ref = json.loads(run_subprocess(REF_8DEV, devices=8).strip()
                     .splitlines()[-1])
    assert ref["nranks"] == 8
    pts = blocked_clusters(2048, 8, 8, seed=2)
    g = build_nng(pts, 1.0, mesh=cpu_mesh(8))
    st = g.stats
    assert st.tiles_skipped > 0
    assert g.meta["plan"] == ref["plan"]
    assert g.num_edges == ref["edges"]
    assert hashlib.sha256(g.edge_key().tobytes()).hexdigest() == \
        ref["edge_sha"]
    assert st.tiles_scheduled == ref["tiles_scheduled"]
    assert st.tiles_skipped == ref["tiles_skipped"]
    assert st.dists_evaluated == ref["dists_evaluated"]
    assert st.comm_bytes == ref["comm_bytes"]
    assert set(st.comm_bytes) == {"ring_points", "ring_mirror", "ring_summary"}


def test_block_pruning_skips_only_empty_rounds():
    """prune=False evaluates every scheduled round and finds the same
    graph; the skipped rounds held no pair."""
    pts = blocked_clusters(512, 4, 8, seed=4)
    a = build_nng(pts, 1.0, mesh=cpu_mesh(8))
    b = build_nng(pts, 1.0, mesh=cpu_mesh(8), prune=False)
    assert a == b
    assert a.stats.tiles_skipped > 0 and b.stats.tiles_skipped == 0
    assert "ring_summary" not in b.stats.comm_bytes
    n_loc = 512 // 8
    assert (b.stats.dists_evaluated - a.stats.dists_evaluated
            == a.stats.tiles_skipped * n_loc * n_loc)
