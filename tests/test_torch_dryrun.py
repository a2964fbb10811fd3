"""The production dry run (``repro_torch.launch.dryrun``,
``repro_torch.roofline``) against the reference's.

The reference's dry run compiles to HLO and reads the collective bytes off
it (``repro.roofline.analyze_hlo``). One 8-device subprocess compiles its
systolic and landmark programs, another runs its ``build_nng`` at R = 2, 5,
8; the port's shape-only counts must equal both, byte for byte. The
reference's ``repro.launch.dryrun`` is never imported here: it sets the
jax device count of the whole process on import.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import NNG_CONFIGS
from repro_torch.core.distributed import make_nng_mesh, plan_landmark
from repro_torch.launch import dryrun
from repro_torch.nng import build_nng, landmark_comm_bytes, ring_comm_bytes
from repro_torch.roofline import (HW, landmark_rank_stats, roofline_terms,
                                  systolic_rank_stats)
from repro_torch.roofline.report import load_cells, nng_table
from tests.helpers import SRC

RANKS = (2, 5, 8)
N_PTS, DIM, EPS = 240, 3, 0.6

_PRELUDE = r"""
import json, warnings
import jax, jax.numpy as jnp, numpy as np
from repro.core.distributed import (landmark_nng, make_nng_mesh,
                                    plan_landmark, systolic_nng)
from repro.nng import build_nng
from repro.roofline import analyze_hlo
warnings.simplefilter("ignore", DeprecationWarning)
out = {}
"""
# (a) the reference's own dry-run arithmetic: compile at 8 devices, read
# the collective bytes off the HLO
REFERENCE_HLO = _PRELUDE + r"""
mesh = make_nng_mesh(8)
pts = jax.ShapeDtypeStruct((1024, 8), jnp.float32)
comp = jax.jit(lambda p: systolic_nng(p, 1.0, mesh, k_cap=64)
               ).lower(pts).compile()
out["systolic"] = analyze_hlo(comp.as_text()).coll_bytes
plan = plan_landmark(1024, 8)
ctr = jax.ShapeDtypeStruct((plan.m_centers, 8), jnp.float32)
fv = jax.ShapeDtypeStruct((plan.m_centers,), jnp.int32)
comp = jax.jit(lambda p, c, f: landmark_nng(p, 1.0, c, f, mesh, plan)
               ).lower(pts, ctr, fv).compile()
out["landmark"] = analyze_hlo(comp.as_text()).coll_bytes
for n, r, m in %r:
    out[f"plan {n} {r} {m}"] = vars(plan_landmark(n, r, m_centers=m))
print("REF" + json.dumps(out))
""" % ([(dryrun.cell_n(c.name, r), r, c.m_centers) for c in
        NNG_CONFIGS.values() for r in (256, 512)],)
# (b) the reference's runs on the first R of the 8 devices
REFERENCE_RUNS = _PRELUDE + r"""
x = np.random.default_rng(0).normal(size=(%d, %d)).astype(np.float32)
for r in %r:
    m = make_nng_mesh(r)
    for ov in (True, False):
        out[f"systolic {r} {ov}"] = build_nng(x, %r, mesh=m,
                                              overlap=ov).stats.comm_bytes
    out[f"landmark {r}"] = build_nng(x, %r, mesh=m, partition="spatial",
                                     planner="host").stats.comm_bytes
print("REF" + json.dumps(out))
""" % (N_PTS, DIM, RANKS, EPS, EPS)


@pytest.fixture(scope="module", autouse=True)
def reference_processes():
    """The reference's two 8-device subprocesses (its HLO, its runs),
    started side by side before the module's first test so that they run
    beside the port's tests."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for code in (REFERENCE_HLO, REFERENCE_RUNS)]
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def reference(reference_processes):
    ref = {}
    for p in reference_processes:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("REF")][-1]
        ref.update(json.loads(line[3:]))
    return ref


def _points():
    return np.random.default_rng(0).normal(size=(N_PTS, DIM)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# (c) every cell on both layouts; one cell worked out by hand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(dryrun.LAYOUTS))
@pytest.mark.parametrize("name", sorted(NNG_CONFIGS))
def test_every_cell_runs(tmp_path, name, mesh_name):
    r = dryrun.run_nng_cell(name, mesh_name, str(tmp_path))
    assert r["status"] == "OK", r.get("traceback")
    assert r["chips"] == dryrun.LAYOUTS[mesh_name].ranks
    assert r["n"] == (NNG_CONFIGS[name].n // r["chips"]) * r["chips"]
    for algo in dryrun.ALGOS:
        rf, mem = r[algo]["roofline"], r[algo]["memory"]
        assert rf["step_lower_bound_s"] == max(
            rf["t_compute_s"], rf["t_memory_s"], rf["t_collective_s"]) > 0
        assert mem["total_bytes"] == (mem["argument_size_bytes"]
                                      + mem["output_size_bytes"]
                                      + mem["temp_size_bytes"])
        assert mem["temp_size_bytes"] > 0


def test_sift_pod1_systolic_by_hand():
    """nng-sift-1m on 256 ranks: 4096 points a rank, 128 rounds of the
    double-buffered ring (129 hops of points and of the mirror), 257 tile
    launches (the self tile, then forward and mirror every round)."""
    st = dryrun.algo_stats("nng-sift-1m", "systolic", 256)
    n, d, k = 4096, 128, 128
    points_hop = n * d * 4 + 4
    mirror_hop = n * k * 4 + n * 4
    assert st.coll_bytes == {"collective-permute": 129 * (points_hop
                                                          + mirror_hop),
                             "all-gather": d * 4 + 4}
    assert st.launches == {"nng_tile": 257, "bits_to_cols": 257}
    flops = 257 * (n * n * (2 * d + 3) + 2 * d * (n + n))
    assert st.flops == flops and st.ops == {}
    rf = roofline_terms(st, 256)
    assert rf["t_compute_s"] == flops / 67e12
    assert rf["t_collective_s"] == (129 * (points_hop + mirror_hop)
                                    + d * 4 + 4) / 50e9
    assert rf["bottleneck"] == "compute"
    # the whole input, which every process holds; the (n, k) ids, the
    # counts, the ranks' overflow flags and three fp32 counters
    assert st.memory["argument_size_bytes"] == 256 * n * d * 4
    assert st.memory["output_size_bytes"] == (n * k * 4 + n * 4 + 512
                                              + 3 * 1024)


def test_ring_rate_crosses_nodes():
    hw = HW()
    assert hw.ring_bw(8) == 450e9 and hw.ring_bw(16) == 50e9
    st = systolic_rank_stats(1024, 8, "euclidean", 8, k_cap=64)
    one_node = roofline_terms(st, 8)["t_collective_s"]
    assert one_node == st.total_coll_bytes / 450e9


def test_hamming_work_is_popcounts():
    st = dryrun.algo_stats("nng-word2bits", "systolic", 256)
    assert st.flops == 0 and st.ops["popcount"] == 257 * 1560 ** 2 * 25
    assert st.launches == {"nng_tile_hamming": 257, "bits_to_cols": 257}


# ---------------------------------------------------------------------------
# (d) the plan the dry run takes is the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [256, 512])
@pytest.mark.parametrize("name", sorted(NNG_CONFIGS))
def test_plan_landmark_matches_reference(reference, name, ranks):
    cfg = NNG_CONFIGS[name]
    n = dryrun.cell_n(name, ranks)
    ours = plan_landmark(n, ranks, m_centers=cfg.m_centers)
    assert vars(ours) == reference[f"plan {n} {ranks} {cfg.m_centers}"]


# ---------------------------------------------------------------------------
# (e) the CLI and the report
# ---------------------------------------------------------------------------

def test_cli_writes_skips_and_forces(tmp_path, capsys):
    out = str(tmp_path / "dryrun")
    assert dryrun.main(["--out", out]) == 0
    files = sorted(os.listdir(out))
    assert len(files) == 6
    stamp = 1_000_000_000
    for f in files:
        os.utime(os.path.join(out, f), (stamp, stamp))
    assert dryrun.main(["--out", out]) == 0
    assert all(os.stat(os.path.join(out, f)).st_mtime == stamp
               for f in files)
    assert dryrun.main(["--out", out, "--arch", "nng-sift-1m", "--mesh",
                        "pod2", "--force"]) == 0
    moved = [f for f in files
             if os.stat(os.path.join(out, f)).st_mtime != stamp]
    assert moved == ["nng-sift-1m__nng__pod2.json"]
    cells = load_cells(out)
    assert {(c["arch"], c["mesh"]) for c in cells} == {
        (a, m) for a in NNG_CONFIGS for m in dryrun.LAYOUTS}
    rows = nng_table(cells).splitlines()[2:]
    assert len(rows) == 12
    assert "nng-synth-16m" in capsys.readouterr().out


def test_failed_cell_is_recorded(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise ValueError("no such shape")
    monkeypatch.setattr(dryrun, "algo_stats", boom)
    r = dryrun.run_nng_cell("nng-sift-1m", "pod1", str(tmp_path))
    assert r["status"] == "FAIL" and "no such shape" in r["error"]
    assert "Traceback" in r["traceback"]
    assert nng_table(load_cells(str(tmp_path))).count("\n") == 1


# ---------------------------------------------------------------------------
# (f) the one function that runs anything needs the card
# ---------------------------------------------------------------------------

def test_measure_rank_memory_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the measurement would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.measure_rank_memory("nng-sift-1m", "pod1", algo="systolic")
    with pytest.raises(ValueError, match="not a CUDA device"):
        dryrun.measure_rank_memory("nng-sift-1m", "pod1", algo="landmark",
                                   device="cpu")


# ---------------------------------------------------------------------------
# (b) the shape-only formulas equal the port's and the reference's runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", RANKS)
def test_formulas_equal_port_and_reference_runs(reference, ranks):
    pts = _points()
    mesh = make_nng_mesh(ranks, device="cpu")
    n = N_PTS + (-N_PTS) % ranks
    for ov in (True, False):
        g = build_nng(pts, EPS, mesh=mesh, overlap=ov)
        want = ring_comm_bytes(n, DIM, 4, ranks, g.meta["plan"], prune=True,
                               overlap=ov)
        assert g.stats.comm_bytes == want
        assert reference[f"systolic {ranks} {ov}"] == want
    g = build_nng(pts, EPS, mesh=mesh, partition="spatial", planner="host")
    want = landmark_comm_bytes(n, DIM, 4, ranks, g.meta["plan"],
                               g.meta["ghost_mode"])
    assert g.stats.comm_bytes == want
    assert reference[f"landmark {ranks}"] == want


# ---------------------------------------------------------------------------
# (a) per-rank collective bytes equal the reference's HLO, kind by kind
# ---------------------------------------------------------------------------

def test_collective_bytes_equal_reference_hlo(reference):
    sy = systolic_rank_stats(1024, 8, "euclidean", 8, k_cap=64)
    lm = landmark_rank_stats(1024, 8, "euclidean", 8)
    assert sy.coll_bytes == reference["systolic"] == {
        "collective-permute": 186900.0, "all-gather": 36.0}
    assert lm.coll_bytes == reference["landmark"] == {"all-to-all": 25600.0}
