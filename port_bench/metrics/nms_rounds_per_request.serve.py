"""nms_rounds_per_request.serve: the NMS's fixpoint rounds per request (the
port's counter `nms.rounds`, one host read a round), the mean over the
spans pass's requests (a request that counted none ran none)."""

from port_bench import spans


def read(record):
    sp = spans.spans_pass(record)
    if sp is None:
        return None
    rounds = sp.get("counters", {}).get("nms.rounds", [0] * sp["requests"])
    return sum(rounds) / len(rounds)
