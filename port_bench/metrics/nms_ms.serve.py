"""nms_ms.serve: host ms of one `ops/nms.py` `nms_batch` call on a
request's decoded heads, synced, over at least 250 ms of calls."""


def read(record):
    if record.get("kind") != "serve":
        return None
    return record["spans"].get("nms_ms")
