"""epilogue_ms: device milliseconds of the profiled call in the epilogue
kernels, ``bits_to_cols`` and ``leaf_range_pack``."""
from nng_bench.readers import kernel_s

PATTERN = r"\b(bits_to_cols|leaf_range_pack)_kernel\b"


def read(record):
    s = kernel_s(record, PATTERN)
    return None if s is None else s * 1e3
