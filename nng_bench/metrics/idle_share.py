"""idle_share: the share of the profiled call's window (the whole call, on
the host's clock as the trace has it) in which no operation ran on the
device, in percent."""


def read(record):
    prof = record.get("profile")
    if not prof or not prof["window_s"] or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
