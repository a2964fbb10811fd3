"""Distributed ε-NNG job driver (the paper's workload, end to end).

A thin CLI over the public front end ``repro_torch.nng.build_nng``: pick a
metric (any registry name), a partition strategy, a traversal flavour and
a planner, get back the CSR ``NNGraph``, optionally verified against the
float64 brute-force oracle. ``--updates`` replays online maintenance
through ``repro_torch.stream.OnlineNNG`` instead. ``--verify`` accepts a
difference from the oracle only on the fp32 boundary (|d - eps| within
fp32 error), after a build as after the replay: the delta traversal
evaluates fp32 distances as the batch engines do.

It runs on a mesh of ``--ranks`` ranks (``make_nng_mesh``): ``--device
cuda`` (the default) launches the CUDA kernels and raises without a card;
``--device cpu`` runs their plain PyTorch versions. Started by torchrun
(or any launcher that sets ``RANK``, ``WORLD_SIZE`` and ``MASTER_PORT``)
it runs one process per card, or per CPU process: ``--backend`` nccl (the
default on the card) or gloo (the default on the CPU, and the way to put
several processes on one card), ``--ranks`` a multiple of the world
(default: the world; one rank without a launcher). Every process builds
the same graph; only rank 0 prints and verifies.

Usage:
  python -m repro_torch.launch.nng_run --n 4096 --dim 8 --eps 1.0 \\
      --algo landmark --verify
  python -m repro_torch.launch.nng_run --n 8192 --dim 16 --ranks 8 \\
      --algo systolic --metric manhattan --device cpu
  python -m repro_torch.launch.nng_run --n 16384 --dim 128 --eps 2.98 \\
      --ranks 8 --algo systolic --updates 6 --update-batch 256 --verify
  python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.nng_run --points 4096 --dim 8 --ranks 8 \\
      --algo systolic --device cpu --verify
  python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.nng_run --points 4096 --dim 8 --ranks 8 \\
      --algo landmark --updates 6 --update-batch 64 --device cpu --verify

``run_systolic`` / ``run_landmark`` are thin adapters over the shared
``repro_torch.nng.drive`` loop that return the reference's tuple shapes
(the engines' raw outputs, tensors on the mesh's device).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

SEN = 2**31 - 1


def run_systolic(pts, eps, mesh, *, metric="euclidean", k_cap=64,
                 prune=True, max_grows=6, traversal="tiles", forest=None):
    """Systolic engine through the shared driver. Returns (nbrs, cnt,
    counters, k_cap) with overflow guaranteed False; ``counters`` =
    (tiles_skipped, dists_evaluated, nodes_pruned) per-rank tensors.
    ``traversal="tree"`` builds per-block cover-tree forests once (or takes
    ``forest``) and traverses them on the device; the re-plan loop reuses
    them."""
    from repro_torch.nng import PointPartitionEngine, drive
    engine = PointPartitionEngine(
        pts, eps, mesh, metric, k_cap=k_cap, prune=prune,
        traversal=traversal, forest=forest)
    # callers consume the tables, not elapsed_s: no timing re-run
    out, k_final, _, _ = drive(engine, max_grows=max_grows,
                               steady_state=False)
    nbrs, cnt, _ovf, skipped, dists, pruned = out
    return nbrs, cnt, (skipped, dists, pruned), k_final


def grow_plan(plan):
    """Double every capacity knob of a LandmarkPlan (overflow re-plan)."""
    from repro_torch.nng import grow_plan as _grow
    return _grow(plan)


def run_landmark(pts, eps, centers, f, mesh, plan, *, metric="euclidean",
                 max_grows=6, traversal="tiles", cell=None, forest=None,
                 ghost_mode="coll"):
    """Landmark engine through the shared driver. Returns (outputs, plan)
    with the overflow flags (outputs[6]) guaranteed False; outputs[7..10]
    are the per-rank tiles_skipped / tiles_scheduled / dists_evaluated /
    nodes_pruned counters of the final, non-overflowing run.
    ``traversal="tree"`` builds the per-cell forests once from ``cell``
    (the Voronoi assignment matching ``centers`` / ``f``); re-plans reuse
    them (capacities do not change the trees)."""
    from repro_torch.nng import SpatialPartitionEngine, drive
    if traversal == "tree" and cell is None:
        raise ValueError("traversal='tree' needs the cell assignment")
    engine = SpatialPartitionEngine(
        pts, eps, mesh, metric, traversal=traversal, centers=centers, f=f,
        cell=cell, plan=plan, forest=forest, ghost_mode=ghost_mode)
    out, plan, _, _ = drive(engine, max_grows=max_grows,
                            steady_state=False)
    return out, plan


def edges_from_neighbor_lists(ids, nbrs):
    """(ids (m,), nbrs (m, k)) SENTINEL-padded -> (src, dst) edge arrays."""
    ids = np.asarray(ids)
    nbrs = np.asarray(nbrs)
    valid = ids != SEN
    ii, kk = np.nonzero((nbrs != SEN) & valid[:, None])
    return ids[ii], nbrs[ii, kk]


def _run_updates(args, pts, mesh, partition, say=print):
    """``--updates`` replay: build on a prefix, stream the reserved points
    in as insert batches interleaved with random deletes, report update
    throughput and delta-log state (through ``say``), optionally verify
    the final view. On a mesh over processes every process replays the
    same operations (``OnlineNNG`` over processes) and rank 0 alone
    verifies."""
    from repro_torch.stream import OnlineNNG

    rng = np.random.default_rng(args.seed)
    b = max(args.update_batch, 1)
    reserve = min(args.updates * b, len(pts) // 2)
    n0 = len(pts) - reserve
    o = OnlineNNG(pts[:n0], args.eps, metric=args.metric,
                  partition=partition, mesh=mesh, k_cap=args.k_cap,
                  seed=args.seed)
    say(f"online: built on {n0}, replaying {args.updates} updates "
        f"(batch {b})")
    cursor = n0
    for step in range(args.updates):
        if step % 3 == 2 and o.num_live > b:     # every third op: delete
            live = np.flatnonzero(o.live)
            o.delete(rng.choice(live, size=min(b, len(live) // 2),
                                replace=False))
            kind = "delete"
        elif cursor < len(pts):
            o.insert(pts[cursor:cursor + b])
            cursor = min(cursor + b, len(pts))
            kind = "insert"
        else:
            break
        st = o.last_update_stats
        say(f"  [{step}] {kind}: live={o.num_live} "
            f"delta_edges={o.graph.delta_edges} "
            f"dists={0 if st is None else st.dists_evaluated:.0f}")
    g = o.graph
    say(f"{g} after updates: update_s={g.stats.update_s:.2f}s "
        f"edges_added={g.stats.edges_added:.0f} "
        f"edges_removed={g.stats.edges_removed:.0f} "
        f"compactions={g.meta.get('compactions', 0)}")
    if args.verify and mesh.rank == 0:
        from repro_torch.core.brute import brute_force_graph
        live = np.flatnonzero(o.live)
        gb = brute_force_graph(o.points[live], args.eps, args.metric)
        # compare on live ids: relabel brute's compact ids back to globals
        key = g.edge_key()
        src, dst = live[gb.src], live[gb.dst]
        bkey = np.sort(src * g.n + dst)
        if np.array_equal(key, bkey):
            print(f"verify vs brute force on live points: EXACT MATCH ({gb})")
        else:
            # the delta traversal evaluates fp32 as the batch engines do:
            # the build's knife-edge tolerance applies
            _verify_boundary(o.points, args.eps, args.metric,
                             np.setxor1d(key, bkey), g.n)
    return g


def _verify_boundary(pts, eps, metric, diff, n):
    """Report the edge keys ``diff`` (i * n + j) on which the graph and the
    float64 brute force disagree: exact up to the fp32 boundary when every
    such pair has |d - eps| within fp32 error (the boundary property of
    the paper's float implementations), else a mismatch (SystemExit)."""
    from repro_torch.core.metrics_host import get_host_metric
    met = get_host_metric(metric)
    ii, jj = diff // n, diff % n
    dd = np.asarray(met.true(met.rowwise(pts[ii], pts[jj])))
    if pts.dtype == np.uint32:
        tol = 0.0            # integer distances: no fp32 boundary
    elif metric == "euclidean":
        scale = float(np.max(np.abs(pts.astype(np.float64)))) ** 2
        tol = 1e-5 * (scale + eps ** 2) / max(eps, 1e-9)
    else:                    # additive float metrics (L1, user)
        scale = float(np.max(np.abs(pts.astype(np.float64))))
        tol = 1e-5 * (scale * pts.shape[1] + eps) + 1e-6
    worst = float(np.max(np.abs(dd - eps)))
    ok = worst <= tol
    print(f"verify: {len(diff)} boundary edges, worst |d-eps|="
          f"{worst:.2e} (tol {tol:.2e}) -> "
          f"{'EXACT up to fp32 boundary' if ok else 'MISMATCH'}")
    if not ok:
        raise SystemExit(1)


def _quiet(*args, **kwargs):
    pass


def main(argv=None):
    import torch.distributed as dist

    from repro_torch.core.metrics import registered_metrics

    ap = argparse.ArgumentParser()
    # --points: --n under torchrun, whose own parser takes "--n" for an
    # abbreviation of its options on some Python versions
    ap.add_argument("--n", "--points", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--eps", type=float, default=1.0)
    ap.add_argument("--metric", default="euclidean",
                    choices=list(registered_metrics()))
    ap.add_argument("--algo", default="landmark",
                    choices=["systolic", "landmark"],
                    help="partition strategy: systolic = point "
                         "partitioning, landmark = spatial partitioning")
    ap.add_argument("--k-cap", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--no-prune", action="store_true",
                    help="disable block-summary tile pruning (systolic)")
    ap.add_argument("--traversal", default="tiles", choices=["tiles", "tree"],
                    help="per-tile evaluation: dense bitmask tiles or "
                         "device-resident cover-tree traversal")
    ap.add_argument("--planner", default="device", choices=["device", "host"],
                    help="landmark capacity planning: one exact counting "
                         "pass over the ranks, or the host numpy pass")
    ap.add_argument("--ghost-mode", default="coll",
                    choices=["coll", "ring", "auto"],
                    help="landmark ε-ghost schedule: capacity-padded "
                         "all-to-all (coll), ghost-free block rotation "
                         "(ring), or the byte-model pick (auto)")
    ap.add_argument("--updates", type=int, default=0,
                    help="online-maintenance replay: reserve part of the "
                         "point set, build the graph on the rest, then run "
                         "this many randomized insert/delete batches "
                         "through repro_torch.stream.OnlineNNG (--verify "
                         "checks the FINAL merged view against brute force)")
    ap.add_argument("--update-batch", type=int, default=32,
                    help="points per online insert/delete batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the ranks: cuda (the kernels; "
                         "raises without a card) or cpu (their plain "
                         "PyTorch versions)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the mesh: a multiple of the processes "
                         "(default: one a process)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend under a launcher "
                         "(default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)

    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.launch.dist import init

    started = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if started:
        init(args.backend, args.device)
    try:
        return _main(args, make_nng_mesh(args.ranks, args.device))
    finally:
        if started:
            dist.destroy_process_group()


def _main(args, mesh):
    from repro_torch.data import synthetic_pointset
    from repro_torch.nng import build_nng

    say = print if mesh.rank == 0 else _quiet
    partition = "point" if args.algo == "systolic" else "spatial"
    pts = synthetic_pointset(args.n, args.dim, args.metric, seed=args.seed)
    say(f"n={args.n} dim={args.dim} metric={args.metric} eps={args.eps} "
        f"ranks={mesh.size} device={mesh.device} partition={partition} "
        f"traversal={args.traversal} processes={mesh.world}")

    if args.updates > 0:
        return _run_updates(args, pts, mesh, partition, say)

    g = build_nng(
        pts, args.eps, metric=args.metric, partition=partition,
        traversal=args.traversal, planner=args.planner, mesh=mesh,
        k_cap=args.k_cap, prune=not args.no_prune, seed=args.seed,
        ghost_mode=args.ghost_mode)
    if partition == "spatial":
        say(f"ghost_mode={g.meta['ghost_mode']}"
            + (" (auto)" if args.ghost_mode == "auto" else ""))
    st = g.stats
    say(f"tiles skipped={st.tiles_skipped:.0f}/{st.tiles_scheduled:.0f} "
        f"dists_evaluated={st.dists_evaluated:.0f} "
        f"nodes_pruned={st.nodes_pruned:.0f} "
        f"comm_bytes={st.total_comm_bytes:.0f} replans={st.replans}")
    say(f"{g} in {st.elapsed_s:.2f}s (plan={g.meta['plan']})")

    if args.verify and mesh.rank == 0:
        from repro_torch.core.brute import brute_force_graph
        gb = brute_force_graph(pts, args.eps, args.metric)
        if g == gb:
            say(f"verify vs brute force: EXACT MATCH ({gb})")
        else:
            # the device evaluates fp32: allow only knife-edge differences
            _verify_boundary(pts, args.eps, args.metric,
                             np.setxor1d(g.edge_key(), gb.edge_key()), g.n)
    return g


if __name__ == "__main__":
    main()
