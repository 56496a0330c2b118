"""raster_ms.serve: device ms of one request's H2D of its COO arrays and
its raster (`data/bev.py` `make_bev_map_from_cells`): the card's busy time
in the profiler's trace inside a range that ends on a synchronize, the
mean over the pool's requests. Read from a synced pass after the window,
not from the window."""


def read(record):
    if record.get("kind") != "serve":
        return None
    return record["spans"].get("raster_ms")
