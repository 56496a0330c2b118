"""idle_in_nms_share.serve: % of the spans pass's wall time in which the card
idled while the host was in `cyv4.nms`."""

from port_bench import spans


def read(record):
    return spans.idle_share(record, "nms")
