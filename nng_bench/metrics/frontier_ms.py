"""frontier_ms: device milliseconds of the profiled call in the frontier
kernels (``frontier_pipe.cuh``: the plan pass and the walk)."""
from nng_bench.readers import kernel_s

PATTERN = r"\bfpipe::frontier_(plan_)?kernel\b"


def read(record):
    s = kernel_s(record, PATTERN)
    return None if s is None else s * 1e3
