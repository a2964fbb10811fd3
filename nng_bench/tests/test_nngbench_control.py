"""The comparison that decides ``correct`` has to fail what is wrong: the
lower-precision control in the program's place, and a run whose timed path
is broken underneath (the CPU, tiny sizes, the chip's look skipped)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from nng_bench import control, harness, reference, spec  # noqa: E402

BENCH = spec.load_benchmark(ROOT)
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


@pytest.mark.parametrize("name", ["sift1m.point-tiles",
                                  "word2bits.point-tiles"])
def test_control_fails_and_the_program_passes(name):
    cell = tiny_cell(name)
    out = control.readings(cell, [11, 2**32 + 12], True, "cpu",
                           log=lambda m: None)
    limit = next(iter(cell.config["limits"].values()))
    assert max(out["program"]) <= limit
    assert min(out["control"]) > limit


def _control(build):
    """The control in the program's place: each call's graph is the one
    that the reference one step down in precision gives (``build`` runs
    only for the graph's bookkeeping)."""
    from repro_torch.core.graph import NNGraph

    def f(points, eps, metric, **kw):
        g = build(points, eps, metric=metric, **kw)
        ref = reference.Reference(points, eps, metric)
        keys = ref.keys(torch.arange(ref.n), control=True).numpy()
        rows, cols = keys // ref.n, keys % ref.n
        row_ptr = np.zeros(ref.n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=ref.n), out=row_ptr[1:])
        return NNGraph(ref.n, row_ptr, cols, g.stats, g.meta)
    return f


@pytest.mark.parametrize("name", ["sift1m.point-tiles",
                                  "word2bits.point-tiles"])
def test_the_control_in_the_programs_place_is_not_correct(name):
    from repro_torch.nng import build_nng

    cell = tiny_cell(name)
    res = harness.run_cell(cell, 2**31 + 98, 0.0, False, device="cpu",
                           build=_control(build_nng), log=lambda m: None)
    assert res["correct"] is False, res["checks"]


def _stale(build):
    """A call that returns its first result every time."""
    first = []

    def f(*a, **kw):
        if not first:
            first.append(build(*a, **kw))
        return first[0]
    return f


def _csr_edit(build, edit):
    """A call whose graph keeps only the listed pairs (rows, cols) for
    which ``edit(rows, cols, n)`` is true, or whose columns it rewrites
    (an int array)."""
    from repro_torch.core.graph import NNGraph

    def f(*a, **kw):
        g = build(*a, **kw)
        rows = np.repeat(np.arange(g.n), np.diff(g.row_ptr))
        out = edit(rows, g.col_ids.copy(), g.n)
        if out.dtype == bool:
            rows, cols = rows[out], g.col_ids[out]
        else:
            cols = out
        row_ptr = np.zeros(g.n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=g.n), out=row_ptr[1:])
        return NNGraph(g.n, row_ptr, cols, g.stats, g.meta)
    return f


def _half_rows(rows, cols, n):
    # half the batch left out: the second half of the rows lists nothing
    return rows < n // 2


def _local_only(nranks):
    # the ring's exchange left out: each rank's rows keep only the
    # neighbours of its own block
    def edit(rows, cols, n):
        block = n // nranks
        return rows // block == cols // block
    return edit


def _one_edge(rows, cols, n):
    # one answer altered where it is made: the first listed neighbour
    cols[0] = (cols[0] + n // 2) % n
    return cols


@pytest.mark.parametrize("fault", ["stale", "half_rows", "local_only",
                                   "one_edge"])
@pytest.mark.parametrize("name", ["sift1m.point-tiles",
                                  "word2bits.point-tiles"])
def test_a_broken_timed_path_is_not_correct(name, fault):
    from repro_torch.nng import build_nng

    cell = tiny_cell(name)
    broken = {
        "stale": lambda: _stale(build_nng),
        "half_rows": lambda: _csr_edit(build_nng, _half_rows),
        "local_only": lambda: _csr_edit(
            build_nng, _local_only(cell.config["nranks"])),
        "one_edge": lambda: _csr_edit(build_nng, _one_edge),
    }[fault]()
    res = harness.run_cell(cell, 2**31 + 99, 0.0, False, device="cpu",
                           build=broken, log=lambda m: None)
    assert res["correct"] is False, res["checks"]
