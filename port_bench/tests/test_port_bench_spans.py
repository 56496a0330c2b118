"""`spans.span_timeline` and the nine readers of the spans pass, on a
hand-made profiler event list: a device op goes to the range whose host op
launched it (through the CUDA call of its correlation id, not a host op
that repeats the number), not to the one open when it ran; the four idle shares add up
to the window's idle share; `nms_tail_ms` follows its definition; every
reader returns None on a record without a spans pass (the parent's
records, and any checkout whose port has no spans)."""

from types import SimpleNamespace as NS

import pytest

from port_bench import harness, spans

DEV, HOST = "cuda", "cpu"  # two device types, as DeviceType.CUDA and .CPU


class Trace:
    """Events as `torch.profiler`'s `prof.events()` gives them (times in us)."""

    def __init__(self):
        self.events = []
        self.ids = 0

    def host(self, name, start, end, parent=None, id=None):
        self.ids += 1
        e = NS(name=name, device_type=HOST, time_range=NS(start=start, end=end),
               id=self.ids if id is None else id, cpu_parent=parent, is_user_annotation=False)
        self.events.append(e)
        return e

    def device(self, name, start, end, op):
        """A kernel or copy that `op` launched: a runtime call inside `op`
        and the device event carry one correlation id, which a host op's
        own id may repeat (a numbered span of its own)."""
        self.ids += 1
        corr = 1000 + self.ids
        t = op.time_range.start
        self.host("cudaLaunchKernel", t, t + 0.5, op, id=corr)
        self.host("aten::unrelated", t - 0.9, t - 0.8, id=corr)
        self.events.append(NS(name=name, device_type=DEV, time_range=NS(start=start, end=end),
                              id=corr, cpu_parent=None, is_user_annotation=False))

    def request(self, t):
        """One served request at t: raster, network, nms in a serve range,
        then the caller's copy out; the network's first op runs on into the
        NMS's host time."""
        serve = self.host("cyv4.serve", t + 0, t + 60)
        raster = self.host("cyv4.raster", t + 1, t + 10, serve)
        self.device("copy_kernel", t + 5, t + 8, self.host("aten::copy_", t + 2, t + 3, raster))
        net = self.host("cyv4.network", t + 10, t + 30, serve)
        self.device("conv_kernel", t + 12, t + 35, self.host("aten::conv", t + 11, t + 12, net))
        self.device("add_kernel", t + 35, t + 40, self.host("aten::add", t + 29, t + 30, net))
        nms = self.host("cyv4.nms", t + 30, t + 55, serve)
        self.device("sin_kernel", t + 45, t + 50, self.host("aten::sin", t + 31, t + 32, nms))
        # an annotation's device-side range is no device work
        self.events.append(NS(name="cyv4.nms", device_type=DEV,
                              time_range=NS(start=t + 30, end=t + 55), id=0,
                              cpu_parent=None, is_user_annotation=True))
        self.device("Memcpy DtoH", t + 62, t + 66, self.host("aten::copy_", t + 60, t + 70))


@pytest.fixture
def timeline():
    tr = Trace()
    tr.host("outside the window", -50, -10)
    tr.host(spans.SPANS_MARK, 0, 200)
    tr.request(0)
    tr.request(100)
    return spans.span_timeline(tr.events, DEV)


def record(timeline, rounds=(1, 3)):
    return {"kind": "serve", "spans_pass": dict(timeline, counters={"nms.rounds": list(rounds)})}


def test_device_op_goes_to_the_range_that_launched_it(timeline):
    # conv_kernel (12-35) runs while the host is in the NMS: still network
    assert timeline["requests"] == 2 and timeline["unlinked_device_ops"] == 0
    assert timeline["device_s"] == pytest.approx(
        {"raster": 6e-6, "network": 56e-6, "nms": 10e-6, "outside": 8e-6})
    assert timeline["host_s"] == pytest.approx({"raster": 18e-6, "network": 40e-6, "nms": 50e-6})
    assert timeline["busy_s"] == pytest.approx(80e-6) and timeline["window_s"] == 200e-6


def test_idle_shares_add_up(timeline):
    # per request: 0-5 outside, 8-12 raster, 40-45 and 50-62 nms, 66-100 outside
    assert timeline["idle_s"] == pytest.approx(
        {"raster": 8e-6, "network": 0.0, "nms": 34e-6, "outside": 78e-6})
    rec = record(timeline)
    shares = [harness.metric_reader(m)(rec) for m in spans.METRICS if m.startswith("idle_")]
    assert len(shares) == 4
    idle = 100.0 * (1.0 - timeline["busy_s"] / timeline["window_s"])
    assert sum(shares) == pytest.approx(idle, abs=1e-9)


def test_nms_tail_and_the_other_readers(timeline):
    # each request: the network's last device op ends at 40, its NMS range at 55
    ends = [x for pair in timeline["request_ends_s"] for x in pair]
    assert ends == pytest.approx([40e-6, 55e-6, 140e-6, 155e-6])
    got = {m: harness.metric_reader(m)(record(timeline)) for m in spans.METRICS}
    assert got == pytest.approx({
        "raster_span_ms.serve": 3e-3, "network_span_ms.serve": 28e-3,
        "network_dispatch_ms.serve": 20e-3, "nms_tail_ms.serve": 15e-3,
        "nms_rounds_per_request.serve": 2.0, "idle_in_raster_share.serve": 4.0,
        "idle_in_network_share.serve": 0.0, "idle_in_nms_share.serve": 17.0,
        "idle_outside_layers_share.serve": 39.0})


def test_no_mark_or_no_device_op_gives_nothing():
    tr = Trace()
    tr.request(0)
    assert spans.span_timeline(tr.events, DEV) == {}
    tr = Trace()
    tr.host(spans.SPANS_MARK, 0, 100)
    tr.host("cyv4.serve", 1, 50)
    assert spans.span_timeline(tr.events, DEV) == {}
    assert spans.record_of(tr.events, DEV, None) == {}


OLDER_RECORD = {
    "kind": "serve", "spans": {"nms_ms": 4.4, "raster_ms": 1.6, "network_ms": 21.1},
    "ranges": {"early_layers": {"device_ms": 3.0, "bound_ms": 0.2}},
    "window": {"items_per_s": 627.0}, "peak_s_per_item": 1e-4,
    "trace": {"busy_s": 0.1, "window_s": 0.2, "kernels": 5600, "items": 8,
              "device_ops": [], "idle_gaps": []},
    "power_limit": "NVIDIA H100 80GB HBM3, 700.00 W",
}


@pytest.mark.parametrize("name", spans.METRICS)
def test_reader_without_a_spans_pass_gives_none(name, timeline):
    read = harness.metric_reader(name)
    assert read(OLDER_RECORD) is None
    assert read(dict(OLDER_RECORD, spans_pass={})) is None
    assert read({}) is None and read({"kind": "neither"}) is None
    assert read(record(timeline)) is not None
