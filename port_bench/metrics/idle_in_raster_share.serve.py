"""idle_in_raster_share.serve: % of the spans pass's wall time in which the
card idled while the host was in the port's `cyv4.raster` span (each idle
gap put down to the layer span open on the host at its start)."""

from port_bench import spans


def read(record):
    return spans.idle_share(record, "raster")
