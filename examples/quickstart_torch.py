"""Quickstart for the port's public API: ``repro_torch.nng.build_nng`` ->
``NNGraph``.

Builds the exact ε-graph of one point set under three metrics, with both
partition strategies and both traversal flavours, on 8 logical ranks of
one device — then checks every result against a brute-force oracle.

Exactness contract (the paper's float implementations have the same): the
edge set is exact with respect to the DECLARED distance function, the
fp32 arithmetic of the device metric. The oracle below uses that
arithmetic (the metric's ``cdist`` on the same device, an fp32
threshold). On the CPU the kernels' plain versions compute exactly that,
so the edges must be bit-identical; on the card a kernel may sum in
another order than the library product, so a pair may differ from the
oracle only on the fp32 knife edge of eps (``off_knife``). Against the
float64 ground truth the script reports how many knife-edge pairs differ
(none for the integer Hamming metric).

Run:
  PYTHONPATH=src python examples/quickstart_torch.py               # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # no card
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.brute import brute_force_graph  # noqa: E402
from repro_torch.core.distributed import make_nng_mesh  # noqa: E402
from repro_torch.core.graph import EpsGraph  # noqa: E402
from repro_torch.core.metrics import get_metric, ieee_fp32  # noqa: E402
from repro_torch.core.metrics_host import get_host_metric  # noqa: E402
from repro_torch.data import synthetic_pointset  # noqa: E402
from repro_torch.nng import build_nng  # noqa: E402


def pick_eps(pts, metric, target_degree=24.0):
    """eps giving roughly the target average degree (sample quantile)."""
    met = get_host_metric(metric)
    sample = pts[:1500]
    d = np.asarray(met.true(met.cdist(sample, sample)))
    vals = d[np.triu_indices(len(sample), 1)]
    eps = float(np.quantile(vals, target_degree / max(len(pts) - 1, 1)))
    return max(1.0, round(eps)) if metric == "hamming" else eps


@ieee_fp32()
def declared_oracle(pts, eps, metric, device):
    """Brute force under the engines' declared distance arithmetic (the
    device metric's fp32 ``cdist`` on ``device``, an fp32 threshold). The
    comparison stays fp32: in float64 a pair whose fp32 distance equals
    the fp32 threshold would flip."""
    met = get_metric(metric)
    x = met.as_device(pts, device)
    d = met.cdist(x, x).cpu().numpy()
    if metric == "euclidean":   # canonical threshold: fp32 eps squared IN fp32
        ceps = np.float32(eps) ** 2
    else:
        ceps = np.float32(met.comparable(eps))
    ii, jj = np.nonzero(d <= ceps)
    keep = ii < jj
    return EpsGraph(len(pts), ii[keep], jj[keep])


U32 = 2.0 ** -24          # fp32 unit roundoff


def off_knife(pts, eps, metric, a: EpsGraph, b: EpsGraph):
    """(pairs in exactly one of ``a`` and ``b``, how many of them lie off
    the fp32 knife edge of eps). Two fp32 evaluations that sum in
    different orders may split a pair only on the knife: for L2, float64
    |d² - eps²| within the wider of 1e-4·eps² and 20 units of
    ‖x‖² + ‖y‖²; for L1, |d - eps| within dim·u·eps; Hamming has none."""
    diff = np.setxor1d(a.edge_key(), b.edge_key(), assume_unique=True)
    if not len(diff):
        return 0, 0
    i, j = np.divmod(diff, len(pts))
    if metric == "hamming":
        return len(diff), len(diff)
    x, y = pts[i].astype(np.float64), pts[j].astype(np.float64)
    if metric == "euclidean":
        off = np.abs(((x - y) ** 2).sum(1) - eps ** 2)
        knife = np.maximum(1e-4 * eps ** 2,
                           20 * U32 * ((x * x).sum(1) + (y * y).sum(1)))
    else:
        off = np.abs(np.abs(x - y).sum(1) - eps)
        knife = pts.shape[1] * U32 * eps
    return len(diff), int((off > knife).sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; raises without a card) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--n", type=int, default=2500,
                    help="points (2500, the default, is deliberately not a "
                         "multiple of 8: it exercises the padding)")
    ap.add_argument("--ranks", type=int, default=8)
    args = ap.parse_args(argv)
    mesh = make_nng_mesh(args.ranks, args.device)
    exact_device = mesh.device.type == "cpu"
    for metric in ("euclidean", "manhattan", "hamming"):
        pts = synthetic_pointset(args.n, 8, metric, seed=7)
        eps = pick_eps(pts, metric)
        oracle = declared_oracle(pts, eps, metric, mesh.device)
        results = {}
        for partition in ("point", "spatial"):
            for traversal in ("tiles", "tree"):
                g = build_nng(pts, eps, metric=metric, partition=partition,
                              traversal=traversal, mesh=mesh, k_cap=256)
                st = g.stats
                print(f"{metric:10s} {partition:7s}/{traversal:5s}: {g}  "
                      f"[{st.elapsed_s:.2f}s, replans={st.replans}, "
                      f"tiles {st.tiles_skipped:.0f}/{st.tiles_scheduled:.0f} "
                      f"skipped, {st.dists_evaluated:.0f} dists]")
                results[(partition, traversal)] = g

        # every engine / traversal combination: the same edge set
        g0 = results[("point", "tiles")]
        assert all(g == g0 for g in results.values()), metric
        diff, off = off_knife(pts, eps, metric, g0.to_eps_graph(), oracle)
        if exact_device:
            assert g0 == oracle, f"{metric}: device graph != declared oracle"
            assert int(g0.row_ptr[-1]) == 2 * oracle.num_edges
        else:
            # another summation order may split a pair on the knife only
            assert off == 0, (f"{metric}: {off} of {diff} pairs that differ "
                              "from the declared oracle lie off the knife")

        # float64 ground truth: only knife-edge pairs may differ
        gb64 = brute_force_graph(pts, eps, metric)
        boundary = g0.to_eps_graph().symmetric_difference(gb64)
        if metric == "hamming":
            assert boundary == 0   # integer distances have no boundary

        # the CSR is a real graph object
        deg = g0.degrees()
        csr = g0.to_scipy_csr()
        assert csr.nnz == int(g0.row_ptr[-1])
        assert (csr.sum(axis=1) == deg).all()
        print(f"{metric:10s} OK: {g0.num_edges} edges ({diff} pairs differ "
              f"from the declared oracle, all on the fp32 knife; {boundary} "
              f"fp32-boundary pairs vs float64), degree min/mean/max = "
              f"{deg.min()}/{deg.mean():.1f}/{deg.max()}")

    print(f"\nall metrics x partitions x traversals on {mesh.size} ranks of "
          f"{mesh.device} ({torch.__version__}) match the declared-"
          "arithmetic oracle")


if __name__ == "__main__":
    main()
