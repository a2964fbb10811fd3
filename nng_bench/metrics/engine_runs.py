"""engine_runs: engine runs a call (the first run, one a grow, the steady
re-run), counted by the span on the engine classes' ``run``; the mean over
the traced run's calls."""


def read(record):
    calls = record["calls"]
    runs = [c["counts"].get("engine.run", 0) for c in calls]
    return sum(runs) / len(runs) if runs and any(runs) else None
