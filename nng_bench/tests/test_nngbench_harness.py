"""The benchmark's harness on the CPU at tiny sizes: the cells resolve to
their files, the reference equals the port's graph, the frozen roofline
arithmetic, the result line's keys, the refusal without a card, and the
modules a run loads."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from nng_bench import harness, reference, roofline, spec  # noqa: E402

BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# tiny stand-ins of each configuration: (n, eps) with a few dozen
# neighbours a row
TINY = {"sift1m": (1024, 4.5), "word2bits": (1024, 46.0)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engines run many small torch ops a rank; on shared cores (the
    suite runs files in parallel workers) intra-op threads only add
    contention, so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cell(name):
    cell = spec.resolve(BENCH, name)
    n, eps = TINY[cell.config["name"]]
    cell.config.update(n=n, eps=eps)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(BENCH, name)
    assert NAME.match(name) and NAME.match(cell.traffic["name"])
    assert cell.chips == 1
    for key in ("n", "dim", "metric", "eps", "nranks", "generator",
                "limits", "reduced", "assumed", "source"):
        assert key in cell.config, key
    assert len(cell.config["source"]) <= 200
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in e2e


def test_benchmark_entries_within_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    with pytest.raises(KeyError):
        spec.resolve(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


@pytest.mark.parametrize("config", sorted(TINY))
def test_reference_equals_build_nng_on_cpu(config):
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.nng import build_nng

    from nng_bench import points

    cell = tiny_cell(next(
        w["name"] for w in BENCH["workloads"] if w["config"] == config))
    cfg = cell.config
    X = points.make_points(cfg, "cpu")
    P = X[points.call_perm(len(X), 2**33 + 5, 0, "cpu")]
    g = build_nng(P, cfg["eps"], metric=cfg["metric"],
                  mesh=make_nng_mesh(cfg["nranks"], "cpu"),
                  **harness.build_kwargs(cell))
    ref = reference.Reference(P, cfg["eps"], cfg["metric"])
    res = reference.judge_graph(ref, g.row_ptr, g.col_ids,
                                np.arange(len(P)))
    name, value = reference.reading(cfg["metric"], res)
    assert res["pairs_ref"] > 10 * len(P)          # a few dozen a row
    assert value <= cfg["limits"][name], res
    if cfg["metric"] == "hamming":
        assert res["wrong_pairs"] == 0


def test_spatial_calls_hold_the_centre_rows():
    from repro_torch.core.landmark import select_centers

    from nng_bench import points

    cell = tiny_cell("sift1m.spatial-tiles")
    cfg = cell.config
    hold = points.held_rows(cfg, cell.traffic)
    m = max(2 * cfg["nranks"], 32)
    # the frozen copy draws the rows that build_nng takes for centres
    assert np.array_equal(
        hold, select_centers(cfg["n"], m, np.random.default_rng(0)))
    perms = [points.call_perm(cfg["n"], s, c, "cpu", hold)
             for s, c in ((2**31 + 3, 0), (2**40 + 9, 5))]
    for perm in perms:
        assert torch.equal(perm[torch.as_tensor(hold)], torch.as_tensor(hold))
        assert torch.equal(perm.sort().values, torch.arange(cfg["n"]))
    assert not torch.equal(perms[0], perms[1])
    assert points.held_rows(cfg, tiny_cell("sift1m.point-tiles").traffic) \
        is None


def test_host_spans_leave_out_the_profiled_call():
    from types import SimpleNamespace

    from nng_bench import readers

    def call(profiled, s):
        return {"profiled": profiled, "spans": {"a": s}, "counts": {"a": 1},
                "stats": SimpleNamespace(elapsed_s=s)}
    record = {"calls": [call(True, 10.0), call(False, 1.0),
                        call(False, 3.0)]}
    assert readers.span_s(record, ("a",)) == 2.0
    assert readers.stats_mean(record, "elapsed_s") == 2.0
    record = {"calls": [call(True, 10.0)]}
    assert readers.span_s(record, ("a",)) is None
    assert readers.stats_mean(record, "elapsed_s") is None


def test_frozen_roofline_arithmetic():
    # PERF.md section 6: nng_tile's bound at 131072² x 128
    assert roofline.tile_launch_bound_ms(131072, 131072, 128) == \
        pytest.approx(66.413, abs=5e-4)
    # one engine run's pairs at the configurations' sizes
    assert roofline.tile_bound_s("euclidean", 2**20, 128) == \
        pytest.approx(2.1254, abs=1e-3)
    assert roofline.tile_bound_s("hamming", 399360, 25) == \
        pytest.approx(0.4766, abs=1e-3)


@pytest.mark.parametrize("trace_on", [False, True])
def test_result_line_has_the_contracts_keys(trace_on):
    cell = tiny_cell("sift1m.spatial-tiles")
    res = harness.run_cell(cell, 2**31 + 7, 0.0, trace_on, device="cpu",
                           log=lambda m: None)
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": res["peak_bytes"]}
    line = json.loads(json.dumps(harness.result_line(res, device,
                                                     trace_on)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m["name"] for m in (cell.per_layer if trace_on
                                else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    if trace_on:
        assert {"engine_s", "engine_runs", "plan_s"} <= set(line["metrics"])
        assert "busy_s" in line["device"] and "window_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # the CPU has no allocator peak to read
        assert set(line["metrics"]) == want - {"peak_mem_gib"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_cli_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, str(ROOT / "nng_bench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout


IMPORT_CHECK = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {banned!r}))
"""


@pytest.mark.parametrize("what", ["harness", "reference"])
def test_imports_neither_jax_nor_the_jax_package(what):
    if what == "harness":
        body = ("from nng_bench import harness, spec\n"
                "cell = spec.resolve(spec.load_benchmark({root!r}), "
                "'word2bits.point-tiles')\n"
                "cell.config.update(n=512, eps=46.0)\n"
                "harness.run_cell(cell, 3, 0.0, True, device='cpu', "
                "log=lambda m: None)\n")
        banned = {"jax", "jaxlib", "flax", "repro"}
    else:
        body = ("import torch\nfrom nng_bench import reference\n"
                "x = torch.randn(64, 8)\n"
                "r = reference.Reference(x, 3.0, 'euclidean')\n"
                "reference.judge_control(r, torch.arange(64).numpy())\n")
        banned = {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    code = IMPORT_CHECK.format(root=str(ROOT), src=str(ROOT / "src"),
                               body=body.format(root=str(ROOT)),
                               banned=banned)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": "",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
