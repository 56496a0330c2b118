"""raster_span_ms.serve: device ms per request of the ops launched inside
the port's `cyv4.raster` span (the COO's H2D, the scatters, the resize)
in the spans pass: served as in the window, tracing on, profiled. The
served pass's own counterpart of `raster_ms.serve`."""

from port_bench import spans


def read(record):
    return spans.per_request_ms(record, "device_s", "raster")
