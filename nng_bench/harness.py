"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up (``setup_s``): the kernels loaded (compiled into the checkout's
``build/repro_torch/`` on the first run there), the configuration's points
made from its generator seed, the mesh of the traffic's ranks, and one warm
``build_nng`` call at full size (allocator, cub workspaces).

The window is a closed loop of one client that calls
``repro_torch.nng.build_nng`` back to back, each call on the cell's points
under a fresh row permutation drawn from ``--seed`` on the device, each to
its end (its graph on the host). It ends at the end of the first call that
finishes after ``seconds``. ``graph_s`` is the window's wall clock over the
calls it completed; ``peak_mem_gib`` the allocator's peak over the window.

With ``trace`` the same calls run with spans around the program's layers
(``trace.install``), and the window's first call runs under
``torch.profiler`` (CPU and CUDA activities); the per-layer readers in
``metrics/`` take their numbers from that record: the device's from the
profiled call, the host spans' from the other calls, which the profiler
does not slow. A traced window makes two calls at least.

After the window, once the peak has been read and the program's state is
freed, every call's graph is checked against the plain reference
(``reference.py``): the whole graph of one call drawn from the seed, and a
sample of rows drawn from the seed of every other call.
"""
from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np
import torch

from nng_bench import points as pts
from nng_bench import reference, spec, trace

SAMPLE_ROWS = 4096        # rows checked in each call not checked whole
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (a whole name: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def build_kwargs(cell: spec.Cell) -> dict:
    """``build_nng``'s keywords: every key of the traffic mix but its
    ``name`` and ``what``."""
    return {k: v for k, v in cell.traffic.items()
            if k not in ("name", "what")}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace_on: bool, *,
             device="cuda", t_start: float | None = None,
             build=None, log=print) -> dict:
    """Run ``cell`` once; returns the result (see ``run.py``). ``build``
    stands in for ``build_nng`` (the tests' broken programs)."""
    t_start = time.perf_counter() if t_start is None else t_start
    from repro_torch import nng
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.kernels import _build

    dev = torch.device(device)
    cfg = cell.config
    build = build or nng.build_nng
    kernel_load_s = None
    t_import = time.perf_counter()
    if dev.type == "cuda":
        _build.load()
        kernel_load_s = _build.build_seconds
    X = pts.make_points(cfg, dev)
    n = len(X)
    mesh = make_nng_mesh(cfg["nranks"], dev)
    t_points = time.perf_counter()
    kw = build_kwargs(cell)
    eps = cfg["eps"]
    hold = pts.held_rows(cfg, cell.traffic)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def call(i):
        g = build(X[pts.call_perm(n, seed, i, dev, hold)], eps,
                  metric=cfg["metric"], mesh=mesh, **kw)
        sync()
        return g

    warm = call(-1)
    t_warm = time.perf_counter()
    log(f"warm call: {warm.num_edges} edges, mean degree "
        f"{warm.avg_degree:.2f}, replans {warm.stats.replans}; set-up: "
        f"imports {t_import - t_start:.3f} s, kernels {kernel_load_s} s, "
        f"kernels and points {t_points - t_import:.3f} s, warm call "
        f"{t_warm - t_points:.3f} s")
    del warm
    gc.collect()
    if dev.type == "cuda":     # the allocator keeps its warm cache
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    rec = trace.Recorder() if trace_on else None
    restore = trace.install(rec) if trace_on else None
    graphs, spans, failed, profile = [], [], 0, None
    t0 = time.perf_counter()
    try:
        i = 0
        while True:
            try:
                if rec is not None:
                    rec.begin_call()
                if rec is not None and i == 0:
                    profile = _profiled(rec, call, dev)
                    graphs.append((i, profile.pop("graph")))
                else:
                    graphs.append((i, call(i)))
                spans.append(rec.current if rec is not None else None)
            except Exception:          # a failed call counts; the loop goes on
                failed += 1
                traceback.print_exc()
            i += 1
            if (time.perf_counter() - t0 >= seconds
                    and (rec is None or i >= 2)):
                break
    finally:
        if restore is not None:
            restore()
    window_s = time.perf_counter() - t0
    attempted = i
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    result = {"attempted": attempted, "failed": failed}
    metrics = {}
    if not trace_on:
        done = len(graphs)
        values = {"graph_s": window_s / done if done else None,
                  "peak_mem_gib": peak / 2**30 if peak else None,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        record = {
            "config": cfg, "traffic": cell.traffic, "n": n,
            "dim": int(X.shape[1]), "kernel_load_s": kernel_load_s,
            "calls": [{"stats": g.stats, "profiled": i == 0, **c}
                      for (i, g), c in zip(graphs, spans)],
            "profile": profile,
        }
        for m in cell.per_layer:
            value = spec.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if profile is not None:
            result["busy_s"] = profile["busy_s"]
            result["window_s"] = profile["window_s"]
            result["breakdown"] = {
                "device_ops": _top(profile["kernels"]),
                "idle_gaps": _top(profile["idle_gaps"])}
    result["metrics"] = metrics
    result["peak_bytes"] = int(peak)

    # the program's state goes before the reference runs
    del mesh
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = check(cell, X, seed, graphs, dev, log)
    result["correct"] = (failed == 0 and bool(graphs) and all(
        v["value"] <= v["limit"] for v in result["checks"].values()))
    return result


def result_line(res: dict, device: dict, trace_on: bool) -> dict:
    """The run's result line, its keys in the contract's order, ``checks``
    (each number compared, with its limit) last."""
    device = dict(device)
    if trace_on:
        device["busy_s"] = res.get("busy_s")
        device["window_s"] = res.get("window_s")
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def _profiled(rec, call, dev) -> dict:
    """Call 0 under torch.profiler, read into a record."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with rec.span(trace.CALL_SPAN):
            g = call(0)
    names = set(rec.current["spans"])
    out = trace.read_profile(prof, names)
    out["engine_runs"] = rec.current["counts"].get("engine.run", 0)
    out["graph"] = g
    return out


def _top(d: dict, k: int = 10) -> list:
    return [[name[:200], s] for name, s in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def check(cell: spec.Cell, X: torch.Tensor, seed: int, graphs, dev,
          log=print) -> dict:
    """Every call's graph against the plain reference: the whole graph of
    one call drawn from the seed, ``SAMPLE_ROWS`` rows of each other.
    Returns the compared number with its limit; logs each call's detail."""
    cfg = cell.config
    n = len(X)
    metric = cfg["metric"]
    hold = pts.held_rows(cfg, cell.traffic)
    whole = (int(np.random.default_rng([int(seed) % 2**64, 0, 3])
                 .integers(len(graphs))) if graphs else -1)
    name = reference.reading(metric, {"split_u": 0.0, "wrong_pairs": 0})[0]
    worst = 0.0
    for k, (i, g) in enumerate(graphs):
        ref = reference.Reference(X[pts.call_perm(n, seed, i, dev, hold)],
                                  cfg["eps"], metric)
        rows = (np.arange(n) if k == whole
                else pts.sample_rows(n, SAMPLE_ROWS, seed, i))
        res = reference.judge_graph(ref, g.row_ptr, g.col_ids, rows)
        value = reference.reading(metric, res)[1]
        worst = max(worst, value)
        log(f"check call {i}: {res}")
        del ref
    limits = cfg["limits"]
    log(f"check: whole call {whole}, {name} {worst!r}")
    return {name: {"value": worst, "limit": limits[name]}}
