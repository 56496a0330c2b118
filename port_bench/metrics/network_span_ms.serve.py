"""network_span_ms.serve: device ms per request of the ops launched inside
the port's `cyv4.network` span (`Darknet.forward` with its decode) in the
spans pass. The served pass's own counterpart of `network_ms.serve`."""

from port_bench import spans


def read(record):
    return spans.per_request_ms(record, "device_s", "network")
