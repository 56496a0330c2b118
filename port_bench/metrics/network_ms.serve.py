"""network_ms.serve: device ms of one request's forward with its decode
(`models/network.py` `Darknet`): the card's busy time in the profiler's
trace inside a range that ends on a synchronize, the mean over the pool's
requests. Read from a synced pass after the window, not from the
window."""


def read(record):
    if record.get("kind") != "serve":
        return None
    return record["spans"].get("network_ms")
