"""network_dispatch_ms.serve: host ms per request of the port's
`cyv4.network` span in the spans pass: the time the host takes to
enqueue the network. Above `network_span_ms.serve`, the network is
launch-bound."""

from port_bench import spans


def read(record):
    return spans.per_request_ms(record, "host_s", "network")
