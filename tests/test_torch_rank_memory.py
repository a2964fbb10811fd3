"""The dry run's per-rank memory model against the engines themselves.

``repro_torch.roofline.rank_stats`` lists, moment by moment, the buffers
one rank of ``systolic_run`` and ``landmark_run`` holds. Here the engines
run as ``launch.dryrun.engine_step`` runs them on the card — one rank a
process (4 gloo processes on the CPU), from the whole input — on the fake
card of ``repro_torch.analysis.lints`` (the CUDA wrappers allocate their
outputs and launch nothing), while a ``TorchDispatchMode`` keeps every
operator output's storage until it dies and notes the bytes alive after
every operator. Every moment the model lists (its operator outputs: the
CUDA operators' own workspaces are the card's to check) must be one of
those sums, byte for byte with every buffer rounded as the model rounds
it, and the largest sum must be the model's peak, at the moment named:
the jobs put each moment that decides a production cell's figure on top.
An engine change that adds, drops, resizes or frees later a buffer of a
moment fails here, not only on the card.
"""
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.distributed import plan_landmark
from repro_torch.launch.dist import spawn
from repro_torch.roofline.rank_stats import (alloc_bytes, landmark_buffers,
                                             peak_bytes, systolic_buffers)

RANKS = 4
# (algo, metric, points a rank, dim, k_cap, m_centers, eps, the moment the
# model puts on top); eps is large enough that the block-summary prune
# skips no round (the fake card's tiles find nothing whatever it is)
JOBS = [
    ("systolic", "euclidean", 320, 8, 16, None, 1e3, "round mirror merge"),
    ("systolic", "hamming", 320, 3, 16, None, 96.0, "round mirror merge"),
    ("landmark", "euclidean", 320, 8, None, None, 1e3, "G x W: sort"),
    ("landmark", "euclidean", 320, 8, None, 512, 1e3, "ghost argsort"),
    ("landmark", "euclidean", 320, 128, None, 512, 1e3,
     "ghost pack: gather"),
    ("landmark", "hamming", 320, 3, None, 512, 96.0, "cdist: popcount"),
]
_EMPTY = ("empty", "empty_like", "new_empty", "empty_strided")


class LiveBytes(TorchDispatchMode):
    """The bytes of the operator outputs alive after every operator
    (``seen``) and their maximum (``peak``): each storage counted once,
    rounded as the caching allocator rounds it, until it dies. Empty
    buffers are zeroed (on the fake card no kernel fills them, and the
    engine indexes with them)."""

    def __init__(self):
        super().__init__()
        self.live, self.now, self.peak, self.seen = {}, 0, 0, set()

    def track(self, t):
        s = t.untyped_storage()
        key = s.data_ptr()
        if s.nbytes() and key not in self.live:
            b = alloc_bytes(s.nbytes())
            self.live[key] = (StorageWeakRef(s), b)
            self.now += b

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _EMPTY:
            out.zero_()
        for key in [k for k, (w, _) in self.live.items() if w.expired()]:
            self.now -= self.live.pop(key)[1]
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.track(t)
        self.peak = max(self.peak, self.now)
        self.seen.add(self.now)
        return out


def record_peaks(jobs) -> list:
    """One process's (peak, sums seen) of each job (under ``spawn``)."""
    from repro_torch.analysis.lints import fake_card
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.core.metrics import get_metric
    from repro_torch.data import synthetic_pointset
    from repro_torch.launch.dryrun import engine_step

    mesh = make_nng_mesh(device="cpu")
    peaks = []
    for algo, metric, n_loc, dim, k_cap, m, eps, _ in jobs:
        met = get_metric(metric)
        pts = synthetic_pointset(n_loc * mesh.size, dim, metric, seed=0)
        rec = LiveBytes()
        with fake_card(), rec:
            x = met.as_device(pts, "cpu").clone()
            engine_step(algo, x, eps, mesh, metric=met, k_cap=k_cap,
                        m_centers=m)
        peaks.append((rec.peak, rec.seen))
    return peaks


def model_buffers(algo, metric, n_loc, dim, k_cap, m):
    if algo == "systolic":
        return systolic_buffers(n_loc, dim, 4, k_cap, RANKS, metric)
    return landmark_buffers(n_loc, dim, 4, RANKS,
                            plan_landmark(n_loc * RANKS, RANKS, m_centers=m),
                            metric)


@pytest.fixture(scope="module")
def recorded():
    per_proc = spawn(record_peaks, RANKS, "gloo", "cpu", args=(JOBS,),
                     timeout=300.0, threads=1)
    return [(max(p[j][0] for p in per_proc),
             set().union(*(p[j][1] for p in per_proc)))
            for j in range(len(JOBS))]


@pytest.mark.parametrize("j", range(len(JOBS)),
                         ids=[f"{a}-{mt}-d{d}-m{m}" for a, mt, _, d, _, m, _,
                              _ in JOBS])
def test_model_moments_match_the_engine(recorded, j):
    algo, metric, n_loc, dim, k_cap, m, _, top = JOBS[j]
    argument, _, moments = model_buffers(algo, metric, n_loc, dim, k_cap, m)
    peak, seen = recorded[j]
    for name, moment in moments.items():
        got = peak_bytes(argument, {name: moment}, internal=False)[1]
        assert got in seen, (name, got, min(seen, key=lambda v: abs(v - got)))
    assert peak_bytes(argument, moments, internal=False) == (top, peak)
    # with the CUDA workspaces the model can only read more
    assert peak_bytes(argument, moments)[1] >= peak
