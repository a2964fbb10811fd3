"""forest_build_s: the cover forests' build a call, the program's own
``RunStats.build_s``, where the call built forests (the ``forest.build``
span ran)."""
from nng_bench.readers import span_s, stats_mean

SPANS = ("forest.build",)


def read(record):
    if span_s(record, SPANS) is None:
        return None
    return stats_mean(record, "build_s")
