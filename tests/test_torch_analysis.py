"""The port's analyzer (``repro_torch.analysis``) on the CPU: each
diagnostic code fires on a deliberately broken miniature and on nothing
else, every one of the 17 kernel contracts is clean (the wrappers on the
fake card: their thresholds bit for bit the canonical ones, no host reads,
no float64), the 8-rank comm-byte audit is clean and its bytes equal the
reference's own ``RunStats.comm_bytes`` from its 8-device run (one JAX
subprocess, run while the port's audit runs), and ``--check`` passes.

The cases mirror the reference's ``tests/test_analysis.py`` where a torch
form exists; the AST passes (RA110, RA301) run both packages' copies on
the same modules and must give the same diagnostics. The jaxpr lints have
no torch form: their checks run as the dispatch-mode and fake-card lints.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import traffic
from repro_torch.analysis.cache_key import cached_modules, lint_cache_keys
from repro_torch.analysis.contracts import (KernelContract, check_all,
                                            check_contract, compare_outputs,
                                            default_contracts)
from repro_torch.analysis.diagnostics import (Diagnostic, is_baselined,
                                              load_baseline, split_baselined)
from repro_torch.analysis.kernel_cost import kernel_costs
from repro_torch.analysis.lints import (entry_calls, lint_f64,
                                        lint_host_sync, lint_int_reductions,
                                        lint_threshold, record_ops)
from repro_torch.analysis.modgraph import dead_modules, lint_dead_modules
from repro_torch.kernels.nng_tile import eps2_f32
from tests.helpers import SRC

ROOT = Path(__file__).resolve().parents[1]
PORT_SRC = ROOT / "src" / "repro_torch"
CONTRACTS = {c.name: c for c in default_contracts()}


def _codes(diags):
    return [d.code for d in diags]


# ---------------------------------------------------------------------------
# the reference's own audit bytes (a subprocess) and the port's audit
# ---------------------------------------------------------------------------

REF_AUDIT = r"""
import json
from repro.analysis.traffic import _audit_points
from repro.nng import build_nng
pts = _audit_points(1024, 8, 8)
out = {}
for name, kw in json.loads(%r).items():
    g = build_nng(pts, 0.25, k_cap=64, **kw)
    out[name] = {"comm_bytes": g.stats.comm_bytes, "edges": g.num_edges,
                 "replans": g.stats.replans}
print(json.dumps(out))
"""
REF_CONFIGS = {
    "tiles": traffic.SYSTOLIC_CONFIGS[0],
    "tree": traffic.SYSTOLIC_CONFIGS[3],
    "landmark ring": traffic.LANDMARK_CONFIGS[2],
}


@pytest.fixture(scope="module")
def audit():
    """The port's 8-rank audit, and the reference's comm_bytes for three
    of its configs from its 8-device run (started first, read last)."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    kw = {name: traffic.config_kwargs(cfg)
          for name, cfg in REF_CONFIGS.items()}
    ref = subprocess.Popen([sys.executable, "-c", REF_AUDIT % json.dumps(kw)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))    # the other half: the subprocess
    try:
        diags, table = traffic.audit_all(nranks=8, device="cpu")
        out, err = ref.communicate(timeout=600)
    finally:
        torch.set_num_threads(threads)
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return diags, table, json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# RA101 — the canonical threshold
# ---------------------------------------------------------------------------

def test_ra101_python_float_fold_flagged(monkeypatch):
    """eps_count's wrapper squaring the Python float eps (f64) and letting
    ctypes round it: the reference's eps_count bug class."""
    import importlib
    tec = importlib.import_module("repro_torch.kernels.eps_count")
    monkeypatch.setattr(tec, "eps2_f32",
                        lambda eps: float(np.float32(float(eps) ** 2)))
    diags = lint_threshold(CONTRACTS["eps_count"])
    assert _codes(diags) == ["RA101"]
    assert "near miss" in diags[0].message


def test_ra101_canonical_threshold_clean():
    assert lint_threshold(CONTRACTS["eps_count"]) == []
    assert lint_threshold(CONTRACTS["nng_tile"], eps=2.98) == []


def test_ra101_missing_launch_flagged():
    """A wrapper that never reaches its entry point passes no threshold."""
    broken = dataclasses.replace(CONTRACTS["nng_tile"],
                                 entry="no_such_library")
    diags = lint_threshold(broken)
    assert _codes(diags) == ["RA101"]
    assert "never called" in diags[0].message


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_ra101_every_wrapper_passes_its_canonical_threshold(name):
    """All 17 wrappers on the fake card: one call of their own entry point
    each, the threshold at its declared positions equal to the canonical
    one bit for bit (as ctypes hands it to the C float or int), and no C
    float argument at all where the kernel has no threshold."""
    import ctypes

    from repro_torch.kernels import _build
    c = CONTRACTS[name]
    assert lint_threshold(c) == []
    _, calls = entry_calls(c.kernel, *c.probe(torch.device("cpu")))
    assert [lib for lib, _ in calls] == [c.entry]
    argtypes = _build._ENTRY[c.entry][1]
    floats = [i - len(argtypes) for i, t in enumerate(argtypes)
              if t is ctypes.c_float]
    if c.canonical is None:
        assert floats == []
    else:
        assert set(floats) <= set(c.threshold_args)


def test_eps_count_threshold_regression():
    """The f64 fold of eps² is not the fp32 one at eps = 0.1, and the
    eps_count wrapper passes the fp32 one."""
    eps = 0.1
    assert float(np.float32(float(eps) ** 2)) != eps2_f32(eps)
    c = CONTRACTS["eps_count"]
    args = list(c.probe(torch.device("cpu")))
    args[c.eps_arg] = eps
    _, [(_, call)] = entry_calls(c.kernel, *args)
    assert call[-3] == eps2_f32(eps)


# ---------------------------------------------------------------------------
# RA102 — int32 scalar reductions
# ---------------------------------------------------------------------------

def test_ra102_int32_scalar_reduction_flagged():
    t = torch.arange(64, dtype=torch.int32)
    _, rec = record_ops(lambda a: a.sum(dtype=torch.int32), t)
    assert _codes(lint_int_reductions(rec, subject="fx")) == ["RA102"]


def test_ra102_int64_counters_and_row_counts_clean():
    t = torch.arange(64, dtype=torch.int32).view(8, 8)

    def counters(a):
        total = a.sum()                              # int64
        rows = (a > 3).sum(1, dtype=torch.int32)     # bounded by the row
        return total, rows, a.float().sum()
    _, rec = record_ops(counters, t)
    assert lint_int_reductions(rec, subject="fx") == []


# ---------------------------------------------------------------------------
# RA103 / RA104 — host reads in a wrapper, float64
# ---------------------------------------------------------------------------

def _toy_probe(device):
    return (torch.arange(64, dtype=torch.float32, device=device).view(8, 8),)


def _toy_contract(**kw):
    base = dict(
        name="toy",
        kernel=lambda x: (x.sum(1).to(torch.int32),),
        oracle=lambda x: (x.sum(1).to(torch.int32),),
        probe=_toy_probe, out_dtypes=(torch.int32,))
    base.update(kw)
    return KernelContract(**base)


@pytest.mark.parametrize("read", ["item", "nonzero", "tolist"])
def test_ra103_host_read_flagged(read):
    def kernel(x):
        if read == "item":
            x.max().item()
        elif read == "nonzero":
            x.nonzero()
        else:
            x[0].tolist()
        return (x.sum(1).to(torch.int32),)
    diags = lint_host_sync(_toy_contract(kernel=kernel))
    assert _codes(diags) == ["RA103"]
    assert lint_host_sync(_toy_contract()) == []


def test_ra104_f64_flagged():
    oracle = lambda x: (x.double().sum(1).to(torch.int32),)  # noqa: E731
    assert _codes(lint_f64(_toy_contract(oracle=oracle), "cpu")) == ["RA104"]
    kernel = lambda x: (x.to(torch.float64).sum(1).int(),)  # noqa: E731
    assert _codes(lint_f64(_toy_contract(kernel=kernel), "cpu")) == ["RA104"]
    assert lint_f64(_toy_contract(), "cpu") == []


@pytest.mark.parametrize("entry", ["run_analysis", "check_all",
                                   "check_contract", "lint_f64",
                                   "audit_config", "audit_all"])
def test_default_device_is_the_card(entry):
    """Every Python entry point of the analyzer defaults to the card, as
    the CLI and the engines do: without one it raises before any pass."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from repro_torch.analysis.report import run_analysis
    calls = {"run_analysis": run_analysis, "check_all": check_all,
             "check_contract": lambda: check_contract(_toy_contract()),
             "lint_f64": lambda: lint_f64(_toy_contract()),
             "audit_config": lambda: traffic.audit_config(
                 traffic.SYSTOLIC_CONFIGS[0]),
             "audit_all": traffic.audit_all}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


# ---------------------------------------------------------------------------
# contracts: RA001–RA004 on miniatures, and the registry
# ---------------------------------------------------------------------------

def test_ra004_missing_oracle():
    diags = check_contract(_toy_contract(oracle=None), "cpu")
    assert _codes(diags) == ["RA004"]


def test_ra003_padding_invariant_violation():
    diags = check_contract(
        _toy_contract(shape_invariants=((130, 32, "tp % 32"),)), "cpu")
    assert _codes(diags) == ["RA003"]
    assert "tp % 32" in diags[0].message


def test_ra001_oracle_raises():
    def oracle(x):
        raise ValueError("no such shape")
    diags = check_contract(_toy_contract(oracle=oracle), "cpu")
    assert _codes(diags) == ["RA001"]


def test_ra002_kernel_oracle_mismatch():
    """The card's comparison on the CPU: outputs that differ in bits, or in
    shape, are RA002; equal ones are clean."""
    c = _toy_contract()
    x = _toy_probe("cpu")
    want = c.oracle(*x)
    bad = (want[0] + (torch.arange(8) == 3).to(torch.int32),)
    assert _codes(compare_outputs(c, x, bad, want)) == ["RA002"]
    assert _codes(compare_outputs(c, x, (want[0][:4],), want)) == ["RA002"]
    assert compare_outputs(c, x, want, want) == []


def test_ra002_dtype_policy():
    diags = check_contract(_toy_contract(out_dtypes=(torch.int64,)), "cpu")
    assert _codes(diags) == ["RA002"]


def test_default_contracts_all_clean():
    """All 17 kernels: the oracle runs at the probe shapes within the
    dtype policy, the invariants hold, and the wrapper (on the fake card)
    passes the canonical threshold, reads no value on the host and makes
    no float64."""
    diags, contracts = check_all(device="cpu")
    assert len(contracts) == 17
    assert sorted(c.name for c in contracts) == sorted(
        name for name in __import__(
            "repro_torch.kernels._build", fromlist=["_ENTRY"])._ENTRY
        if name != "l2_chain")
    assert diags == [], [d.render() for d in diags]


# ---------------------------------------------------------------------------
# RA110 — cache-key completeness (both packages' passes)
# ---------------------------------------------------------------------------

LEAKY = """
import functools
_mode = "fast"          # mutable module state
TILE = 128              # const-style, fine

@functools.lru_cache(maxsize=8)
def build(eps):
    local = TILE * 2
    return (eps, local, _mode)
"""


def test_ra110_mutable_global_flagged(tmp_path):
    from repro.analysis.cache_key import lint_cache_keys as ref_lint
    mod = tmp_path / "leaky.py"
    mod.write_text(textwrap.dedent(LEAKY))
    diags = lint_cache_keys(mod)
    assert _codes(diags) == ["RA110"]
    assert "_mode" in diags[0].message and "TILE" not in diags[0].message
    assert [(d.code, d.subject) for d in diags] == \
        [(d.code, d.subject) for d in ref_lint(mod)]
    assert cached_modules(tmp_path) == [mod]


def test_ra110_port_cached_functions_clean():
    mods = cached_modules(PORT_SRC)
    assert PORT_SRC / "kernels" / "nng_tile.py" in mods
    for mod in mods:
        assert lint_cache_keys(mod) == []


# ---------------------------------------------------------------------------
# RA301 — dead modules (both packages' passes)
# ---------------------------------------------------------------------------

def test_ra301_orphan_module(tmp_path):
    from repro.analysis.modgraph import dead_modules as ref_dead
    pkg = tmp_path / "repro"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "nng.py").write_text("from repro import used\n")
    (pkg / "used.py").write_text("X = 1\n")
    (pkg / "orphan.py").write_text("Y = 2\n")
    assert dead_modules(pkg, tmp_path) == ["repro.orphan"] == \
        ref_dead(pkg, tmp_path)
    # a root script's import makes a module live
    (tmp_path / "script.py").write_text("import repro.orphan\n")
    assert dead_modules(pkg, tmp_path) == []


def test_repo_dead_modules_fully_baselined():
    fresh, _ = split_baselined(lint_dead_modules(PORT_SRC), load_baseline())
    assert fresh == [], [d.render() for d in fresh]


# ---------------------------------------------------------------------------
# baseline mechanics
# ---------------------------------------------------------------------------

def test_baseline_matching():
    d1 = Diagnostic("RA301", "repro_torch.sharding", "whatever")
    d2 = Diagnostic("RA301", "repro_torch.other", "whatever")
    base = [{"code": "RA301", "subject": "repro_torch.sharding",
             "reason": "r"}]
    assert is_baselined(d1, base) and not is_baselined(d2, base)
    fresh, known = split_baselined([d1, d2], base)
    assert fresh == [d2] and known == [d1]
    assert all(e.get("reason") for e in load_baseline())


# ---------------------------------------------------------------------------
# RA201 / RA202 — the comm-byte audit
# ---------------------------------------------------------------------------

def test_ra201_uncounted_channels():
    formula = {"ring_points": 10.0}
    diags = traffic.classify_moves({None: 100, "rogue": 5,
                                    "ring_points": 10}, formula, "fx")
    assert _codes(diags) == ["RA201", "RA201"]
    assert traffic.classify_moves({"ring_points": 10}, formula, "fx") == []


def test_ra201_move_without_channel_injected(monkeypatch):
    """A run that moves a payload under no channel: exactly RA201."""
    from repro_torch.core.distributed import comm
    orig = comm.permute

    def permute(mesh, blocks, perm, *, channel=None):
        if channel == "ring_points":
            comm.all_gather(mesh, torch.zeros((len(mesh.local_ranks), 3)))
        return orig(mesh, blocks, perm, channel=channel)
    monkeypatch.setattr(comm, "permute", permute)
    diags, _ = traffic.audit_config(traffic.SYSTOLIC_CONFIGS[0],
                                   device="cpu")
    assert _codes(diags) == ["RA201"]
    assert "no channel" in diags[0].message


def test_ra202_formula_drift_injected(monkeypatch):
    """RunStats reporting twice the ring_points bytes: RA202 in every run
    of the call, and nothing else."""
    from repro_torch.nng import PointPartitionEngine
    orig = PointPartitionEngine._ring_comm_bytes

    def drifted(self, k_cap):
        out = dict(orig(self, k_cap))
        out["ring_points"] *= 2
        return out
    monkeypatch.setattr(PointPartitionEngine, "_ring_comm_bytes", drifted)
    diags, row = traffic.audit_config(traffic.SYSTOLIC_CONFIGS[1],
                                     device="cpu")
    assert set(_codes(diags)) == {"RA202"}
    assert len(diags) == row["runs"]
    assert "ring_points" in diags[0].message


def test_traffic_audit_8_ranks(audit):
    """The nine configurations clean: bytes moved per channel equal
    comm_bytes run by run; the tree ring accounts all four ring channels,
    the ghost ring its rotation and no all-to-all ghosts (and the
    collective exchange the reverse)."""
    diags, table, _ = audit
    assert diags == [], [d.render() for d in diags]
    assert len(table) == 9, sorted(table)
    for subject, row in table.items():
        assert row["runs"] == row["replans"] + 2, subject
        last = row["per_run"][-1]
        assert last["formula"] == row["comm_bytes"], subject
    tree = table["systolic[traversal=tree,overlap=True,prune=True]"]["moved"]
    assert set(tree) == {"ring_points", "ring_mirror", "ring_forest",
                         "ring_summary"}
    ring = table["landmark[traversal=tiles,ghost=ring]"]["moved"]
    assert "ghost_ring" in ring and "ghost" not in ring, sorted(ring)
    coll = table["landmark[traversal=tiles,ghost=coll]"]["moved"]
    assert "ghost" in coll and "ghost_ring" not in coll, sorted(coll)


@pytest.mark.parametrize("name", sorted(REF_CONFIGS))
def test_audit_bytes_equal_reference_run(audit, name):
    """The audit's comm_bytes, grows and edges equal the reference's own
    8-device run of the same configuration (its RunStats.comm_bytes)."""
    _, table, ref = audit
    row = table[traffic.subject_of(REF_CONFIGS[name])]
    assert row["comm_bytes"] == ref[name]["comm_bytes"]
    assert row["replans"] == ref[name]["replans"]
    assert row["edges"] == ref[name]["edges"]


# ---------------------------------------------------------------------------
# the cost model and the CLI
# ---------------------------------------------------------------------------

def test_kernel_costs_reproduce_perf_bounds():
    """PERF.md section 6's bound column for the rows whose work the shape
    fixes."""
    rows = {r["row"]: r for r in kernel_costs()}
    assert len(rows) == 17
    want = {1: 66.413, 3: 14.898, 4: 131.285, 15: 4.151, 16: 19.558,
            17: 66.413, 14: 1.322}
    for row, ms in want.items():
        assert round(rows[row]["bound_ms"], 3) == ms, (row, rows[row])
    assert {r["bound_by"] for r in rows.values()} <= {"operations", "bytes"}


def test_cli_check_passes(audit, monkeypatch, tmp_path):
    """``--check --device cpu`` exits 0 with no fresh diagnostic and writes
    the report (the audit is the fixture's, run once for the file)."""
    from repro_torch.analysis.__main__ import main
    diags, table, _ = audit
    monkeypatch.setattr(traffic, "audit_all",
                        lambda nranks, device: (diags, table))
    out = tmp_path / "report.json"
    assert main(["--check", "--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] is True and report["fresh"] == []
    assert len(report["contracts"]["checked"]) == 17
    assert len(report["kernel_costs"]) == 17
    assert len(report["traffic"]) == 9
    # a fresh diagnostic fails --check
    monkeypatch.setattr(traffic, "audit_all", lambda nranks, device: (
        [Diagnostic("RA202", "fx", "drift")], table))
    assert main(["--check", "--device", "cpu", "--no-costs",
                 "--out", str(out)]) == 1
