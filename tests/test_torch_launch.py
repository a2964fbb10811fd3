"""The port's front end against the JAX reference, on the CPU: the
``repro_torch.launch.nng_run`` CLI, ``examples/quickstart_torch.py`` and
``drive``'s ``steady_state`` switch."""
import runpy
import time
from pathlib import Path

import numpy as np
import pytest

from repro.launch import nng_run as ref_cli
from repro_torch.data import synthetic_pointset
from repro_torch.launch import nng_run
from repro_torch.nng import (Engine, PointPartitionEngine,
                             SpatialPartitionEngine, build_nng, drive)
from tests.test_torch_nng import gap_safe_eps

ROOT = Path(__file__).resolve().parents[1]
STATS = ("tiles_scheduled", "tiles_skipped", "dists_evaluated",
         "nodes_pruned", "replans")


@pytest.mark.parametrize("algo", ["systolic", "landmark"])
def test_cli_matches_reference_one_rank(algo, capsys):
    """``main`` on one CPU rank against the reference's ``main`` on its one
    in-process device: the same graph, counters, comm_bytes and plan,
    and both report an exact match."""
    eps = gap_safe_eps(synthetic_pointset(400, 5, seed=3), 0.05)
    argv = ["--n", "400", "--dim", "5", "--eps", repr(eps), "--seed", "3",
            "--algo", algo, "--k-cap", "16", "--verify"]
    g = nng_run.main(argv + ["--device", "cpu", "--ranks", "1"])
    ours = capsys.readouterr().out
    ref = ref_cli.main(argv)
    theirs = capsys.readouterr().out
    assert "EXACT MATCH" in ours and "EXACT MATCH" in theirs
    assert "ranks=1 device=cpu" in ours
    np.testing.assert_array_equal(g.edge_key(), ref.edge_key())
    for k in STATS:
        assert getattr(g.stats, k) == getattr(ref.stats, k), k
    assert g.stats.replans >= 1                  # k_cap 16 grows
    assert g.stats.comm_bytes == ref.stats.comm_bytes
    assert repr(g.meta["plan"]) == repr(ref.meta["plan"])


@pytest.mark.parametrize("extra", [
    ["--algo", "systolic", "--traversal", "tree"],
    ["--algo", "landmark", "--ghost-mode", "ring"],
    ["--algo", "systolic", "--updates", "4", "--update-batch", "40"],
    ["--algo", "landmark", "--updates", "4", "--update-batch", "40",
     "--metric", "hamming", "--eps", "40"],
], ids=["systolic-tree", "landmark-ring", "updates", "updates-hamming"])
def test_cli_eight_ranks_verifies(extra, capsys):
    """``--ranks 8 --verify``: the build and the online replay each end
    exact against the float64 brute force."""
    nng_run.main(["--n", "600", "--dim", "6", "--device", "cpu", "--ranks",
                  "8", "--verify", *extra])
    out = capsys.readouterr().out
    assert "ranks=8 device=cpu" in out
    assert "EXACT MATCH" in out or "EXACT up to fp32 boundary" in out
    if "--updates" in extra:
        assert "after updates" in out and "[3] insert" in out


def test_cli_device_flag_without_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nng_run.main(["--n", "64", "--dim", "3"])


def test_quickstart_torch_runs_on_the_cpu(capsys):
    mod = runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"),
                         run_name="quickstart_torch")
    mod["main"](["--device", "cpu", "--n", "500"])
    out = capsys.readouterr().out
    assert "all metrics x partitions x traversals on 8 ranks of cpu" in out
    assert out.count(" OK: ") == 3


class _Counting(Engine):
    """An engine whose run sleeps ``naps[i]`` seconds on its i-th call and
    overflows on the first ``overflows`` calls."""

    name = "counting"

    def __init__(self, naps, overflows=0):
        import torch
        self.device = torch.device("cpu")
        self.naps, self.overflows, self.calls = naps, overflows, 0

    def initial_plan(self):
        return 1

    def run(self, plan):
        time.sleep(self.naps[self.calls])
        self.calls += 1
        return self.calls <= self.overflows

    def overflowed(self, out):
        return out

    def grow(self, plan, out):
        return 2 * plan


@pytest.mark.parametrize("steady,overflows,calls", [
    (False, 0, 1), (True, 0, 2), (False, 1, 2), (True, 1, 3)])
def test_drive_steady_state_switch(steady, overflows, calls):
    """``steady_state=False`` runs the winning plan once and reports that
    run's wall clock; the default re-runs it and reports the re-run's."""
    naps = [0.0] * overflows + [0.15, 0.0]
    eng = _Counting(naps, overflows)
    out, plan, replans, elapsed = drive(eng, steady_state=steady)
    assert eng.calls == calls and replans == overflows
    assert plan == 2 ** overflows and not out
    if steady:
        assert elapsed < 0.1
    else:
        assert elapsed >= 0.15


def test_build_nng_default_reruns_the_winner(monkeypatch):
    calls = []
    orig = PointPartitionEngine.run

    def counted(self, k_cap):
        calls.append(k_cap)
        return orig(self, k_cap)

    monkeypatch.setattr(PointPartitionEngine, "run", counted)
    pts = synthetic_pointset(96, 3, seed=2)
    g = build_nng(pts, 1.0, device="cpu", k_cap=4)
    assert g.stats.replans == 1
    assert calls == [4, calls[1], calls[1]] and calls[1] > 4


def test_run_adapters_match_brute_force():
    """``run_systolic`` and ``run_landmark`` (given centres, assignment and
    a plan too small, so it grows) return tables whose edges
    (``edges_from_neighbor_lists``) are the float64 graph, with the
    reference adapters' overflow contract."""
    from repro_torch.core.brute import brute_force_graph
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.core.graph import EpsGraph

    pts = synthetic_pointset(240, 4, seed=6)
    eps = gap_safe_eps(pts, 0.05)
    oracle = brute_force_graph(pts, eps)
    mesh = make_nng_mesh(3, "cpu")
    nbrs, cnt, (skipped, dists, pruned), k = nng_run.run_systolic(
        pts, eps, mesh, k_cap=4)
    assert k > 4 and int(cnt.max()) <= k
    src, dst = nng_run.edges_from_neighbor_lists(np.arange(240),
                                                 nbrs.numpy())
    assert EpsGraph(240, src, dst) == oracle
    eng = SpatialPartitionEngine(pts, eps, mesh, "euclidean", k_cap=4)
    plan0 = eng.initial_plan()
    out, plan = nng_run.run_landmark(pts, eps, eng.centers, eng.f, mesh,
                                     plan0)
    assert not out[6].any() and plan.k_cap > plan0.k_cap
    assert nng_run.grow_plan(plan0).k_cap == 2 * plan0.k_cap
    parts = [nng_run.edges_from_neighbor_lists(i.numpy(), n.numpy())
             for i, n in [*zip(out[0], out[1]), *zip(out[3], out[4])]]
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    assert EpsGraph(240, src, dst) == oracle
