"""plan_s: the spatial engine's planning, host seconds a call: its
construction (centre selection, the host Voronoi argmin, the LPT
assignment) and ``initial_plan`` (the device counting pass)."""
from nng_bench.readers import span_s

SPANS = ("spatial.init", "spatial.initial_plan")


def read(record):
    return span_s(record, SPANS)
