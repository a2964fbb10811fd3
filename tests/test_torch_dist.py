"""The port's engines on processes: a mesh of ranks over a
``torch.distributed`` group (gloo on the CPU) against the same mesh size
on logical ranks in one process, and against the reference at 6 ranks.

Each world is one ``spawn`` of gloo processes that runs all of its cases
(``torch_dist_cases``) at once: worlds 3, 5, 6 and 8, one rank a process,
and 2 processes of 4 ranks. Every case must equal the ``RingMesh`` run of
the same size bit for bit: the CSR (the neighbour tables), the edge keys,
the work counters, every ``comm_bytes`` channel, ``meta`` (the plan and
the ring schedule among it), on every process. The bytes the comm layer
moves rank to rank, counted per channel on every process, must sum to
``comm_bytes`` per engine run. The logical ring is held to the reference
by the other port tests; here the process ring at 6 ranks is held to the
reference's 6-device run as well (one JAX subprocess; this file imports
no JAX).

The eps of the float cases comes from the reference's test helpers in
that subprocess: ``landmark_safe_eps`` at 6 ranks for the tiles and the
spatial engine, ``tree_safe_eps`` at 5 and 8 ranks for the point tree.
"""
import json
import time
from pathlib import Path

import pytest
import torch

from repro_torch.core.distributed import comm, make_nng_mesh
from repro_torch.core.distributed.comm import process_device
from repro_torch.launch.dist import spawn
from tests import torch_dist_cases as cases
from tests.helpers import run_subprocess

# world key -> (processes, ranks)
WORLDS = {"w3": (3, 3), "w5": (5, 5), "w6": (6, 6), "w8": (8, 8),
          "2x4": (2, 8)}
BASE = ["tiles", "tiles-serial", "tiles-grow", "default"]
FULL = BASE + ["tree-split", "tree-serial", "coll", "ring", "spatial-tree",
               "l1", "hamming", "delta", "forests"]
CASES = {"w3": BASE + ["online"], "w5": FULL, "w6": BASE + ["coll"],
         "w8": FULL, "2x4": FULL + ["cli"]}
PAIRS = [(w, c) for w, cs in CASES.items() for c in cs if c != "cli"]

REF6 = """
import hashlib, json
import numpy as np
from repro.nng import build_nng
from repro_torch.data import synthetic_pointset
from tests.test_torch_landmark import landmark_safe_eps, padded
from tests.test_torch_nng import gap_safe_eps
from tests.test_torch_tree import tree_safe_eps
pts = synthetic_pointset(203, 6, seed=13)
eps = landmark_safe_eps(pts, "euclidean", gap_safe_eps(pts, 0.08), (6,))
out = {"eps": eps,
       "eps_tree": {r: tree_safe_eps(padded(pts, r), r, eps) for r in (5, 8)}}
for name, kw in (("tiles", {}), ("coll", {"partition": "spatial"})):
    g = build_nng(pts, eps, k_cap=512, **kw)
    st = g.stats
    out[name] = {
        "nranks": g.meta["nranks"],
        "edge_sha": hashlib.sha256(g.edge_key().tobytes()).hexdigest(),
        "counters": {k: getattr(st, k) for k in (
            "tiles_scheduled", "tiles_skipped", "dists_evaluated",
            "nodes_pruned")},
        "comm_bytes": st.comm_bytes}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref6():
    """The reference at 6 devices, and the eps of every case."""
    out = json.loads(run_subprocess(REF6, devices=6, timeout=600)
                     .strip().splitlines()[-1])
    out["eps_tree"] = {int(k): v for k, v in out["eps_tree"].items()}
    out["eps_l1"] = cases.quantile_eps("manhattan")
    out["eps_hamming"] = cases.quantile_eps("hamming")
    return out


def case_eps(ref, nranks, name):
    if name.startswith("tree"):
        return ref["eps_tree"][nranks]
    return {"l1": ref["eps_l1"], "hamming": ref["eps_hamming"]}.get(
        name, ref["eps"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The logical runs use one intra-op thread, as the spawned processes
    do, so both sum every product in the same order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_launches = {}
_logical = {}


def launch(ref, world):
    """One spawn per world, all its cases at once (cached)."""
    if world not in _launches:
        procs, nranks = WORLDS[world]
        t0 = time.perf_counter()
        out = spawn(cases.run_cases, procs, backend="gloo", device="cpu",
                    args=(nranks, [(c, case_eps(ref, nranks, c))
                                   for c in CASES[world]]),
                    timeout=300, threads=1)
        _launches[world] = (out, time.perf_counter() - t0)
    return _launches[world][0]


def logical(ref, nranks, name):
    key = (nranks, name)
    if key not in _logical:
        _logical[key] = cases.logical_case(nranks, name,
                                           case_eps(ref, nranks, name))
    return _logical[key]


def assert_same(got, want):
    """Equal results, but for the byte counts (checked apart)."""
    keys = want.keys() - {"tally", "moved"}
    assert got.keys() - {"tally", "moved"} == keys
    for k in keys:
        if hasattr(want[k], "shape"):
            assert (got[k] == want[k]).all(), k
        else:
            assert got[k] == want[k], k


def runs_of(result):
    """Engine runs of a build: the first, the grows, the steady re-run."""
    return result["counters"]["replans"] + 2


@pytest.mark.parametrize("world,name", PAIRS,
                         ids=[f"{w}-{c}" for w, c in PAIRS])
def test_process_mesh_equals_logical_ring(ref6, world, name):
    procs, nranks = WORLDS[world]
    outs = launch(ref6, world)
    for rank, out in enumerate(outs):
        size, w, r, loc, dev = out["mesh"]
        assert (size, w, r, dev) == (nranks, procs, rank, "cpu")
        per = nranks // procs
        assert loc == tuple(range(rank * per, (rank + 1) * per))
    got = [o["cases"][name] for o in outs]
    if name == "online":
        assert all("next slice" in g["raised"] for g in got)
        return
    if name == "forests":
        for g in got:
            assert g and all(g.values()), [k for k, v in g.items() if not v]
        return
    # "default": build_nng(mesh=None) is the world, one rank a process
    want = logical(ref6, procs if name == "default" else nranks,
                   "tiles" if name == "default" else name)
    for g in got:
        assert_same(g, want)
    if name == "default":
        assert got[0]["meta"]["nranks"] == procs
    if name != "tiles-grow":          # a grow moves the mirror's bytes
        # the bytes every process moved, summed, per engine run: counted
        # around the comm layer, and by the layer itself
        runs = runs_of(want) - (name == "delta")    # no steady re-run
        expect = {k: runs * v for k, v in want["comm_bytes"].items()
                  if v}
        for key in ("tally", "moved") if name != "default" else ("tally",):
            total = {}
            for g in got:
                for k, v in g[key].items():
                    total[k] = total.get(k, 0) + v
            assert total == expect, key
            assert want[key] == expect, key


def test_cli_under_spawn_verifies(ref6):
    """``nng_run.main`` in 2 processes of 4 ranks: the same graph on both
    processes, exact against brute force (rank 0 verifies)."""
    got = [o["cases"]["cli"] for o in launch(ref6, "2x4")]
    assert got[0] == got[1]
    from repro_torch.core.brute import brute_force_graph
    import hashlib
    gb = brute_force_graph(cases.synthetic_pointset(256, 6, seed=0), 1.5)
    assert got[0]["edge_sha"] == hashlib.sha256(
        gb.edge_key().tobytes()).hexdigest()


@pytest.mark.parametrize("name", ["tiles", "coll"])
def test_six_processes_match_reference(ref6, name):
    """The process ring at 6 ranks against the reference's 6-device run:
    edges, counters and every comm_bytes channel."""
    got = launch(ref6, "w6")[0]["cases"][name]
    want = ref6[name]
    assert want["nranks"] == 6 == got["meta"]["nranks"]
    assert got["edge_sha"] == want["edge_sha"]
    assert {k: got["counters"][k] for k in want["counters"]} == \
        want["counters"]
    assert got["comm_bytes"] == want["comm_bytes"]


def test_default_mesh_is_the_world_or_one_rank(ref6):
    for world, (procs, _) in WORLDS.items():
        for out in launch(ref6, world):
            assert out["default_mesh"] == (procs, procs)
    mesh = make_nng_mesh(device="cpu")
    assert (mesh.size, mesh.world, tuple(mesh.local_ranks)) == (1, 1, (0,))


def test_nccl_refuses_two_processes_on_one_card():
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        process_device(1, 2, "nccl", "cuda", device_count=1)
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        process_device(0, 2, "nccl", None, device_count=1)
    assert process_device(1, 2, "nccl", None, device_count=2) == \
        torch.device("cuda", 1)
    # gloo shares the card through host memory
    assert process_device(3, 4, "gloo", "cuda", device_count=1) == \
        torch.device("cuda", 0)
    assert process_device(3, 4, "nccl", "cpu", device_count=0) == \
        torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process_device(0, 1, "gloo", "cuda", device_count=0)


def test_mesh_spreads_ranks_evenly():
    mesh = comm.RingMesh(8, torch.device("cpu"), world=2, rank=1,
                         backend="gloo")
    assert list(mesh.local_ranks) == [4, 5, 6, 7]
    assert [mesh.owner(r) for r in range(8)] == [0] * 4 + [1] * 4
    with pytest.raises(ValueError, match="evenly"):
        comm.RingMesh(6, torch.device("cpu"), world=4)


def test_a_failing_process_fails_the_launch():
    """Rank 1 raises while rank 0 waits in a barrier: the launch raises
    with rank 1's error instead of waiting forever."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(cases.fails_on_rank_one, 2, backend="gloo", device="cpu",
              timeout=120)
    assert time.perf_counter() - t0 < 60


def test_a_hanging_process_times_out():
    with pytest.raises(TimeoutError):
        spawn(cases.sleeps, 1, backend="gloo", device="cpu", args=(600,),
              timeout=5)


LOAD = r"""
import ctypes, sys
from pathlib import Path
from repro_torch.kernels import _build
root = Path(sys.argv[1])
_build.CSRC, _build.BUILD_DIR = root / "csrc", root / "build"
_build._ENTRY = {"a": ("a_launch", ()), "b": ("b_launch", ())}
_build._nvcc = lambda: str(root / "nvcc")


class Library:                  # ctypes.CDLL on the stub compiler's output
    def __init__(self, path):
        text = Path(path).read_text()
        assert text == "library", f"{path} holds {text!r}"

    def __getattr__(self, name):
        return lambda *args: 0


ctypes.CDLL = Library
_build.load()
print(sorted(_build._loaded))
"""

NVCC = """#!{python}
import sys, time
from pathlib import Path
out = Path(sys.argv[sys.argv.index("-o") + 1])
with open(Path(__file__).parent / "calls.txt", "a") as f:
    f.write(sys.argv[-1] + "\\n")
out.write_text("lib")          # half written for a while
time.sleep(1.0)
out.write_text("library")
"""


def test_two_processes_build_each_library_once(tmp_path):
    """Two processes load the kernels at once with a stub compiler: each
    library is compiled once (the build lock), and neither loads a
    half-written one."""
    import os
    import subprocess
    import sys
    (tmp_path / "csrc").mkdir()
    for name in ("a", "b"):
        (tmp_path / "csrc" / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    procs = [subprocess.Popen([sys.executable, "-c", LOAD, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(o.strip().endswith("['a', 'b']") for o, _ in outs), outs
    calls = (tmp_path / "calls.txt").read_text().split()
    assert sorted(Path(c).name for c in calls) == ["a.cu", "b.cu"]
    assert len(list((tmp_path / "build").glob("*.tmp.so"))) == 0
