"""Spans around the program's layers, and the reading of one call's profile.

``install`` wraps the front end's module globals and the engine classes'
methods (only in a ``--trace 1`` run) so that each layer's host seconds and
engine runs are recorded per call, and so that each span shows in the
profiler's trace as a ``record_function`` range. ``read_profile`` reduces
``torch.profiler``'s raw events over one whole call to: the call's window,
the device's busy time (the union of its operations' intervals), the device
seconds by operation name, and the idle gaps labelled by what the host was
doing: the innermost span open at the gap's middle, with the innermost other
host event there (an operator or a CUDA runtime call), if any.
"""
from __future__ import annotations

import bisect
import functools
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

CALL_SPAN = "nng_bench.call"


class Recorder:
    """Host seconds and counts of each span, per call."""

    def __init__(self):
        self.current = None

    def begin_call(self) -> None:
        self.current = {"spans": defaultdict(float),
                        "counts": defaultdict(int)}

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                if self.current is not None:
                    self.current["spans"][name] += time.perf_counter() - t0
                    self.current["counts"][name] += 1


def _wrap(rec: Recorder, name: str, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with rec.span(name):
            return fn(*args, **kwargs)
    return wrapped


def install(rec: Recorder):
    """Wrap the program's layers in spans; returns the undo function."""
    from repro_torch import nng
    from repro_torch.core.graph import NNGraph

    undo = []

    def patch(owner, attr, name):
        orig = owner.__dict__[attr]
        undo.append((owner, attr, orig))
        if isinstance(orig, classmethod):
            setattr(owner, attr, classmethod(_wrap(rec, name, orig.__func__)))
        else:
            setattr(owner, attr, _wrap(rec, name, orig))

    patch(nng, "drive", "drive")
    patch(nng, "_timed_forest", "forest.build")
    patch(nng, "neighbor_pairs", "csr.pairs")
    patch(NNGraph, "from_directed_pairs", "csr.build")
    for cls, tag in ((nng.PointPartitionEngine, "point"),
                     (nng.SpatialPartitionEngine, "spatial")):
        patch(cls, "__init__", f"{tag}.init")
        patch(cls, "run", "engine.run")
        patch(cls, "grow", "engine.grow")
    patch(nng.SpatialPartitionEngine, "initial_plan", "spatial.initial_plan")

    def restore():
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
    return restore


def _innermost(events, starts, t):
    """The shortest of ``events`` (sorted by start) open at time ``t``."""
    best = None
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(events[max(0, i - 256):i]):
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best


def read_profile(prof, span_names) -> dict:
    """One profiled call's record from ``prof``'s raw events (reading them
    raw: building the profiler's per-event objects takes minutes on a call
    of a million launches)."""
    from torch.autograd import DeviceType

    dev, ours, other = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        item = (s, s + e.duration_ns(), e.name())
        mine = item[2] in span_names or item[2] == CALL_SPAN
        if e.device_type() == DeviceType.CUDA:
            if not mine:      # a span's range on the device is no operation
                dev.append(item)
        elif mine:
            ours.append(item)
        elif not item[2].startswith("Activity Buffer"):   # the profiler's own
            other.append(item)
    calls = [x for x in ours if x[2] == CALL_SPAN]
    if not calls:
        raise RuntimeError("the profile holds no call span")
    w0, w1 = calls[0][0], calls[0][1]
    kernels = defaultdict(float)
    busy, spans = 0.0, []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            kernels[name] += (e - s) / 1e9
            spans.append((s, e))
    spans.sort()
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9
    ours.sort()
    other.sort()
    o_starts = [x[0] for x in ours]
    h_starts = [x[0] for x in other]
    gaps = defaultdict(float)
    edges = [w0] + [t for iv in merged for t in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        span = _innermost(ours, o_starts, mid)
        host = _innermost(other, h_starts, mid)
        label = span[2] if span else "outside any span"
        if host is not None:
            label += " | " + host[2]
        gaps[label] += (g1 - g0) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy,
            "kernels": dict(kernels), "idle_gaps": dict(gaps)}
