"""engine_s: the steady-state engine run's wall clock, the program's own
``RunStats.elapsed_s`` (a host clock ending in a sync), the mean over the
traced calls run without the profiler."""
from nng_bench.readers import stats_mean


def read(record):
    return stats_mean(record, "elapsed_s")
