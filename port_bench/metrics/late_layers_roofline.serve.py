"""late_layers_roofline.serve: % of the card's least time for every later
layer (the configuration's range `late_layers`): their frozen bound over
the full forward's device time less the prefix's, both the card's busy
time in the profiler's trace over forwards on request 0's raster, after
the window."""


def read(record):
    if record.get("kind") != "serve":
        return None
    r = record.get("ranges", {}).get("late_layers")
    if not r or r["device_ms"] <= 0:
        return None
    return 100.0 * r["bound_ms"] / r["device_ms"]
