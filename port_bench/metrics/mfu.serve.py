"""mfu.serve: % of the card's tensor-core peak that the traced run's own
window served: each conv's operations over the peak of its dtype in the
cell, per frame, times the window's frames/s."""


def read(record):
    if record.get("kind") != "serve":
        return None
    rate = record["window"]["items_per_s"]
    return 100.0 * record["peak_s_per_item"] * rate if rate > 0 else None
