"""early_layers_roofline.serve: % of the card's least time for the layers
through the stride-4 stage (the configuration's range `early_layers`):
their frozen bound over a prefix forward's device time, the card's busy
time in the profiler's trace over prefix forwards (`stop_after`) on
request 0's raster, after the window."""


def read(record):
    if record.get("kind") != "serve":
        return None
    r = record.get("ranges", {}).get("early_layers")
    if not r or r["device_ms"] <= 0:
        return None
    return 100.0 * r["bound_ms"] / r["device_ms"]
