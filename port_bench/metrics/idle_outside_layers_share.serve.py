"""idle_outside_layers_share.serve: % of the spans pass's wall time in which
the card idled while the host was in no layer span: the entry's own glue
in `cyv4.serve`, the caller's D2H copies and its loop. The four
`idle_*_share.serve` add up to the pass's idle share."""

from port_bench import spans


def read(record):
    return spans.idle_share(record, "outside")
