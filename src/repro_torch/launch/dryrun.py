"""Production dry run of the paper's ε-NNG workloads on H100 clusters.

For every ``NNG_CONFIGS`` cell and production layout (``pod1``: 256 ranks
as 32 nodes × 8 GPUs; ``pod2``: 512 ranks as 64 × 8), one rank's work,
collective bytes and memory for both engines — the systolic ring
(``partition="point"``, tiles, prune and overlap on) and the landmark
engine (``ghost_mode="coll"`` with ``plan_landmark(n, ranks,
m_centers=cfg.m_centers)``) — and the three-term roofline they give
(``repro_torch.roofline``), written to ``results/dryrun/<cell>.json``
(cached; re-runs skip). The counts come in closed form from the shapes
(``roofline.rank_stats``): nothing is allocated and no device is needed.

Usage:
  python -m repro_torch.launch.dryrun                    # all NNG cells
  python -m repro_torch.launch.dryrun --arch nng-sift-1m --mesh pod1
  python -m repro_torch.roofline.report                  # the table again

``measure_rank_memory`` is the one function that runs anything: it runs a
cell's engine at the cell's own points a rank on the card, one rank a
process, through the engines ``build_nng`` runs (``engine_step``), and
returns each process's peak device memory beside the model's, evaluated
at the ranks it ran.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import dataclass

from repro_torch.configs import NNG_CONFIGS
from repro_torch.roofline import (HW, landmark_rank_stats, roofline_terms,
                                  systolic_rank_stats)
from repro_torch.roofline.report import load_cells, nng_table

ALGOS = ("systolic", "landmark")


@dataclass(frozen=True)
class Layout:
    """A production layout: ``nodes`` hosts of ``HW.gpus_per_node`` H100s,
    the ring over all of them. A description only: no process group is
    made."""

    name: str
    nodes: int

    @property
    def ranks(self) -> int:
        return self.nodes * HW.gpus_per_node


# the ring of one pod and of two: the reference's make_nng_production_mesh
LAYOUTS = {"pod1": Layout("pod1", 32), "pod2": Layout("pod2", 64)}


def _result_path(out_dir, arch, shape, mesh_name):
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")


def cell_n(name: str, ranks: int) -> int:
    """The cell's point count rounded down to a multiple of the ring."""
    return (NNG_CONFIGS[name].n // ranks) * ranks


def algo_stats(name: str, algo: str, ranks: int, n: int | None = None):
    """One rank's ``RankStats`` of ``algo`` on cell ``name`` over ``ranks``
    ranks (``n`` points; default the cell's, rounded to the ring)."""
    cfg = NNG_CONFIGS[name]
    n = cell_n(name, ranks) if n is None else n
    if algo == "systolic":
        return systolic_rank_stats(n, cfg.dim, cfg.metric, ranks,
                                   k_cap=cfg.k_cap)
    if algo == "landmark":
        return landmark_rank_stats(n, cfg.dim, cfg.metric, ranks,
                                   m_centers=cfg.m_centers)
    raise ValueError(f"unknown algo {algo!r} (want one of {ALGOS})")


def run_nng_cell(name: str, mesh_name: str, out_dir: str,
                 force: bool = False) -> dict:
    """Dry-run the distributed ε-NNG step of one cell on one layout: both
    engines' roofline terms and per-rank memory, written to
    ``out_dir`` (an existing file is returned unless ``force``)."""
    path = _result_path(out_dir, name, "nng", mesh_name)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    try:
        ranks = LAYOUTS[mesh_name].ranks
        results = {}
        for algo in ALGOS:
            stats = algo_stats(name, algo, ranks)
            results[algo] = {"roofline": roofline_terms(stats, ranks),
                             "memory": stats.memory,
                             "launches": stats.launches}
        res = {"arch": name, "shape": "nng", "mesh": mesh_name,
               "status": "OK", "chips": ranks, "n": cell_n(name, ranks),
               "model_s": round(time.time() - t0, 4), **results}
    except Exception as e:
        res = {"arch": name, "shape": "nng", "mesh": mesh_name,
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    _write(path, res)
    return res


def _write(path, res):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)


# ---------------------------------------------------------------------------
# the card's figure: one rank a process
# ---------------------------------------------------------------------------

MEASURE_RANKS = 8      # one node's GPUs: the ranks measure_rank_memory runs
MEASURE_SEED = 0
MEASURE_TIMEOUT_S = 600.0
# an eps at which a config's synthetic stand-in keeps every point under
# k_cap 128 neighbours at MEASURE_RANKS x the layout's points a rank (a
# run's memory is its plan's shapes, whatever it finds)
MEASURE_EPS = {"nng-sift-1m": 2.5, "nng-word2bits": 37.0,
               "nng-synth-16m": 1.0}


def engine_step(algo: str, x, eps: float, mesh, *, metric, k_cap: int,
                m_centers: int | None):
    """One run of ``algo``'s engine on ``mesh`` as ``build_nng`` makes it
    (``PointPartitionEngine`` with tiles, prune and overlap on;
    ``SpatialPartitionEngine`` with ``ghost_mode="coll"``, its centres and
    cell map from ``MEASURE_SEED``), from ``x``, the whole input on this
    process's device — the engines replicate it. The landmark engine runs
    the dry run's plan, ``plan_landmark(n, mesh.size,
    m_centers=m_centers)``, where ``build_nng`` would count one. Returns
    (the engine's output, its per-rank counts, its overflow flags)."""
    from repro_torch.core.distributed import plan_landmark
    from repro_torch.nng import PointPartitionEngine, SpatialPartitionEngine

    if algo == "systolic":
        engine = PointPartitionEngine(x, eps, mesh, metric, k_cap=k_cap)
        out = engine.run(engine.initial_plan())
        return out, out[1], out[2]
    if algo != "landmark":
        raise ValueError(f"unknown algo {algo!r} (want one of {ALGOS})")
    plan = plan_landmark(x.shape[0], mesh.size, m_centers=m_centers)
    engine = SpatialPartitionEngine(x, eps, mesh, metric, plan=plan,
                                    m_centers=plan.m_centers,
                                    seed=MEASURE_SEED, ghost_mode="coll")
    out = engine.run(plan)
    return out, out[2] + out[5], out[6]


def measure_process(jobs: list, device) -> list:
    """One process's side of ``measure_many`` (its rank of a mesh of one
    rank a process over the current process group, on ``device``): for
    each job the whole input, generated on the host from the seed and
    moved to the card as ``build_nng`` moves it, through
    ``engine_step``, and this process's peak device memory over the run."""
    import torch

    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.core.metrics import get_metric
    from repro_torch.data import synthetic_pointset
    from repro_torch.kernels.bits_epilogue import bits_to_cols_cuda

    mesh = make_nng_mesh(device=device)
    dev, ranks = mesh.device, mesh.size
    if mesh.world != ranks:
        raise ValueError("measure_process runs one rank a process")
    # library state outside the engine (the cuBLAS workspace) exists
    # before the first measurement starts
    torch.ones((8, 8), device=dev) @ torch.ones((8, 8), device=dev)
    torch.cuda.synchronize(dev)
    out = []
    for job in jobs:
        cfg = NNG_CONFIGS[job["name"]]
        met = get_metric(cfg.metric)
        pts = synthetic_pointset(job["n_loc"] * ranks, cfg.dim, cfg.metric,
                                 seed=MEASURE_SEED)
        kernels = (met.tile_kernel, met.grouped_kernel, bits_to_cols_cuda)
        before = [fn.launches for fn in kernels]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        x = met.as_device(pts, dev)
        res, cnt, flags = engine_step(job["algo"], x, job["eps"], mesh,
                                      metric=met, k_cap=cfg.k_cap,
                                      m_centers=cfg.m_centers)
        cnt = torch.cat(cnt) if isinstance(cnt, list) else cnt
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        launched = {fn.__name__[:-len("_cuda")]: fn.launches - b
                    for fn, b in zip(kernels, before) if fn.launches > b}
        out.append({"peak_bytes": int(peak), "launches": launched,
                    "seconds": time.perf_counter() - t0,
                    "edges_directed": int(cnt.sum()),
                    "max_cnt": int(cnt.max()) if cnt.numel() else 0,
                    "overflow": bool(flags.any())})
        del res, cnt, flags, x, pts
        torch.cuda.synchronize(dev)
    return out


def measure_many(jobs, *, device="cuda") -> list[dict]:
    """``measure_rank_memory`` for several ``(name, mesh_name, algo)`` jobs
    in one set of ``MEASURE_RANKS`` processes (each process starts
    once)."""
    import torch

    from repro_torch.core.distributed.comm import process_device
    from repro_torch.launch.dist import spawn

    dev = process_device(0, 1, None, device)      # raises without a card
    if dev.type != "cuda":
        raise ValueError(f"measure_rank_memory reads the card's memory: "
                         f"device={device!r} is not a CUDA device")
    ranks = MEASURE_RANKS
    specs = []
    for name, mesh_name, algo in jobs:
        if algo not in ALGOS:
            raise ValueError(f"unknown algo {algo!r} (want one of {ALGOS})")
        layout = LAYOUTS[mesh_name].ranks
        specs.append({"name": name, "mesh": mesh_name, "algo": algo,
                      "n_loc": cell_n(name, layout) // layout,
                      "eps": MEASURE_EPS[name]})
    t0 = time.perf_counter()
    per_proc = spawn(measure_process, ranks, "gloo", dev,
                     args=(specs, str(dev)), timeout=MEASURE_TIMEOUT_S,
                     threads=1)
    wall = time.perf_counter() - t0
    out = []
    for j, spec in enumerate(specs):
        rows = [p[j] for p in per_proc]
        stats = algo_stats(spec["name"], spec["algo"], ranks,
                           n=spec["n_loc"] * ranks)
        model = stats.memory
        out.append({**spec, "ranks": ranks, "n": spec["n_loc"] * ranks,
                    "device": torch.cuda.get_device_name(dev),
                    "peak_bytes": [r["peak_bytes"] for r in rows],
                    "measured_bytes": max(r["peak_bytes"] for r in rows),
                    "model": model, "model_bytes": model["total_bytes"],
                    "launches": {k: max(r["launches"].get(k, 0)
                                        for r in rows)
                                 for k in set().union(*(r["launches"]
                                                        for r in rows))},
                    "model_launches": stats.launches,
                    "max_cnt": max(r["max_cnt"] for r in rows),
                    "mean_degree": sum(r["edges_directed"] for r in rows)
                    / (spec["n_loc"] * ranks),
                    "overflow": any(r["overflow"] for r in rows),
                    "seconds": max(r["seconds"] for r in rows),
                    "spawn_wall_s": wall})
    return out


def measure_rank_memory(name: str, mesh_name: str, *, algo: str,
                        device="cuda") -> dict:
    """Run ``algo`` of cell ``name`` at ``mesh_name``'s points a rank on
    ``MEASURE_RANKS`` gloo processes sharing the card, one rank each (the
    production layout's one rank a GPU, without NCCL's own buffers),
    through ``engine_step`` from the whole input on each process, and
    return each process's peak device memory (``peak_bytes``, their
    maximum ``measured_bytes``; ``torch.cuda.max_memory_allocated`` over
    the run, from the input's move to the card on) beside the model's
    per-rank memory at the ranks it ran (``model``; the landmark plan
    depends on them). Defaults to the card and raises ``RuntimeError``
    without one; a CPU device raises ``ValueError``: the figure is the
    card's."""
    return measure_many([(name, mesh_name, algo)], device=device)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="one rank's roofline and memory of each NNG cell on "
                    "the production layouts (no device needed)")
    ap.add_argument("--arch", default=None, choices=sorted(NNG_CONFIGS))
    ap.add_argument("--mesh", default=None, choices=sorted(LAYOUTS))
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = [args.mesh] if args.mesh else list(LAYOUTS)
    names = [args.arch] if args.arch else list(NNG_CONFIGS)
    ok = True
    for name in names:
        for m in meshes:
            r = run_nng_cell(name, m, args.out, args.force)
            ok &= r["status"] == "OK"
            print(f"{name:16s} nng {m}: {r['status']}", flush=True)
    print("\n" + nng_table(load_cells(args.out)))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
