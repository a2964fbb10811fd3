"""Helpers of the per-layer readers in ``metrics/``.

A reader's ``read(record)`` returns its number, or None where the traced
run holds nothing for it to read (no matching span, counter or kernel): the
harness then leaves the metric out of the result, never reporting 0.

``record`` holds the configuration and traffic, ``n`` and ``dim``,
``kernel_load_s``, ``calls`` (each traced call's ``stats``, the program's
``RunStats``, the host seconds ``spans`` and ``counts`` of each span name,
and ``profiled``, true for the call run under the profiler) and
``profile`` (the profiled call's ``window_s``, ``busy_s``, device
seconds by operation name in ``kernels``, ``idle_gaps``, ``engine_runs``).
"""
from __future__ import annotations

import re


def kernel_s(record: dict, pattern: str) -> float | None:
    """Device seconds of the profiled call in operations whose name matches
    ``pattern``; None where none does."""
    prof = record.get("profile")
    if not prof:
        return None
    rx = re.compile(pattern)
    hits = [s for name, s in prof["kernels"].items() if rx.search(name)]
    return sum(hits) if hits else None


def unprofiled(record: dict) -> list:
    """The traced calls that ran without the profiler, whose host clocks
    its overhead does not reach."""
    return [c for c in record["calls"] if not c["profiled"]]


def span_s(record: dict, names) -> float | None:
    """Host seconds a call in spans ``names``, the mean over the calls run
    without the profiler; None where none of them entered one."""
    calls = unprofiled(record)
    if not calls or not any(c["counts"].get(n) for c in calls for n in names):
        return None
    return sum(c["spans"].get(n, 0.0) for c in calls for n in names) \
        / len(calls)


def stats_mean(record: dict, field: str) -> float | None:
    """The mean of a ``RunStats`` field over the calls run without the
    profiler; None where there is none."""
    calls = unprofiled(record)
    if not calls:
        return None
    return sum(getattr(c["stats"], field) for c in calls) / len(calls)
