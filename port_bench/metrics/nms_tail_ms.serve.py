"""nms_tail_ms.serve: ms per request from the end of the last device op
launched inside its `cyv4.network` span to the end of its `cyv4.nms` span,
the mean over the spans pass's requests: how long the answer waits on the
NMS once the network's work is done."""

from port_bench import spans


def read(record):
    sp = spans.spans_pass(record)
    if sp is None or not sp["request_ends_s"]:
        return None
    ends = sp["request_ends_s"]
    return 1e3 * sum(nms - net for net, nms in ends) / len(ends)
