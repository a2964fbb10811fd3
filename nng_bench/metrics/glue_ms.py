"""glue_ms: device milliseconds of the profiled call in PyTorch's own
operators, the engines' and the traversal's glue: ATen kernels (sorts,
scatters, fills, cats, gathers), cub's, and copies and fills of memory."""
from nng_bench.readers import kernel_s

PATTERN = r"\bat::|\bat_cuda_detail::|\bcub::|^Memcpy|^Memset"


def read(record):
    s = kernel_s(record, PATTERN)
    return None if s is None else s * 1e3
