"""grouped_tile_ms: device milliseconds of the profiled call in the grouped
L2 tile (#5, ``nng_tile_grouped.cu``'s ``grouped_kernel``)."""
from nng_bench.readers import kernel_s

PATTERN = r"\bgrouped_kernel\b"


def read(record):
    s = kernel_s(record, PATTERN)
    return None if s is None else s * 1e3
