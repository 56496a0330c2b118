"""device_idle_share.serve: % of the wall time of one profiled pass over
the pool in which no operation ran on the card."""


def read(record):
    if record.get("kind") != "serve":
        return None
    trace = record.get("trace") or {}
    if not trace.get("busy_s") or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
