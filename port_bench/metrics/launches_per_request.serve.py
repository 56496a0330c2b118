"""launches_per_request.serve: device kernels the profiler saw over one
served pass of the pool, per request (copies and memsets left out)."""


def read(record):
    if record.get("kind") != "serve":
        return None
    trace = record.get("trace") or {}
    if not trace.get("kernels"):
        return None
    return trace["kernels"] / trace["items"]
