"""nng_tile_hamming_roofline: the Hamming eps-tile (#3,
``nng_tile_hamming_kernel``) against its roofline over the profiled call,
in percent: the least time that the input's work needs on one H100 (every
unordered pair once, for each engine run of the call;
``roofline.tile_bound_s``) over the kernel's summed device time."""
from nng_bench.readers import kernel_s
from nng_bench.roofline import tile_bound_s

PATTERN = r"\bnng_tile_hamming_kernel\b"
METRIC = "hamming"


def read(record):
    s = kernel_s(record, PATTERN)
    runs = (record.get("profile") or {}).get("engine_runs", 0)
    if s is None or not runs:
        return None
    bound = runs * tile_bound_s(METRIC, record["n"], record["dim"])
    return 100.0 * bound / s
