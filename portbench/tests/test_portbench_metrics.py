"""The benchmark's arithmetic: the rate over the whole window, the p95 over
every call, the trace's union, gaps and rooflines, and the readers."""

import math
import time

import pytest
import torch

from portbench.harness import check, loop, registry, roofline
from portbench.harness.readings import Readings, p95
from portbench.harness.trace import Trace, read, short, union_s


def test_rate_counts_the_images_done_inside_the_window():
    win = loop.Window(starts=[0.0, 0.5, 1.0, 1.9], dones=[0.6, 1.1, 1.95, 2.3],
                      images=[8, 8, 8, 8], t0=0.0, seconds=2.0, kept={})
    assert win.images_done() == 24          # the last call ended late
    assert win.calls == 4


def test_p95_over_every_call():
    lat = [float(i) for i in range(1, 101)]
    assert p95(lat) == pytest.approx(95.05)
    assert p95([3.0]) == 3.0


def test_closed_loop_keeps_the_sampled_calls_and_holds_in_flight():
    seen = []

    def call(k):
        seen.append(k)
        return [torch.full((2,), k)]

    win = loop.run(call, float("inf"), 2, {1: None, 3: None},
                   torch.device("cpu"), max_calls=6)
    assert seen == list(range(6)) and win.calls == 6
    assert sorted(win.kept) == [1, 3]
    assert torch.equal(win.kept[3][0], torch.full((2,), 3))
    assert all(d is not None and d >= s for s, d in zip(win.starts,
                                                         win.dones))


def test_closed_loop_reports_a_failing_call():
    def call(k):
        if k == 2:
            raise ValueError("boom")
        return [torch.zeros(1)]

    win = loop.run(call, 5.0, 2, {}, torch.device("cpu"))
    assert isinstance(win.error, ValueError) and win.calls == 2


def test_sample_takes_an_early_and_a_late_call_per_input():
    import numpy as np
    early, late = check.sample(np.random.default_rng(0), 4, 4)
    assert sorted(early.values()) == [0, 1, 2, 3]
    assert all(k % 4 == g and k < 16 for k, g in early.items())
    assert sorted(late) == [0, 1, 2, 3]
    assert all(check.LATE[0] <= x < check.LATE[1] for x in late.values())


def test_closed_loop_keeps_a_late_call_of_each_input():
    def call(k):
        time.sleep(0.01)
        return [torch.full((2,), k)]

    win = loop.run(call, 1.0, 2, {1: None}, torch.device("cpu"),
                   late={0: (0.5, None), 1: (0.7, None), 2: (5.0, None)},
                   inputs=3)
    assert sorted(win.late) == [0, 1]            # input 2's time never came
    for g, k in win.late.items():
        assert k % 3 == g and win.starts[k] - win.t0 >= (0.5, 0.7)[g]
        assert win.starts[k - 3] - win.t0 < (0.5, 0.7)[g]
        assert torch.equal(win.kept[k][0], torch.full((2,), k))
    assert 1 in win.kept


def test_compare_counts_each_fault():
    pool = [{"v": i} for i in range(4)]

    def expected(item, _dev):
        return torch.full((2, 3), item["v"], dtype=torch.uint8)

    calls = [[0, 1], [2, 3]]
    sampled = [(2, 0), (5, 1)]
    good = {2: [expected(pool[0], 0), expected(pool[1], 0)],
            5: [expected(pool[2], 0), expected(pool[3], 0)]}
    vals = check.compare(good, sampled, calls, pool, expected, "cpu")
    assert check.passed(vals)
    bad = {2: [expected(pool[0], 0)],                       # one missing
           5: [expected(pool[2], 0) + 1, expected(pool[3], 0).int()]}
    vals = check.compare(bad, sampled, calls, pool, expected, "cpu")
    assert vals == {"max_abs_diff": 1, "wrong_images": 2, "missing_images": 1,
                    "uncompared_calls": 0}
    vals = check.compare({}, sampled, calls, pool, expected, "cpu")
    assert vals["uncompared_calls"] == 2 and not check.passed(vals)
    vals = check.compare(good, sampled + [(None, 1)], calls, pool, expected,
                         "cpu")                   # a late call never issued
    assert vals["uncompared_calls"] == 1 and not check.passed(vals)


class _Event:
    def __init__(self, name, start, end, stream, device=True):
        cuda = torch.autograd.DeviceType.CUDA
        self.name, self.device_resource_id = name, stream
        self.device_type = cuda if device else torch.autograd.DeviceType.CPU
        self.time_range = type("R", (), {"start": start, "end": end})


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_read_leaves_out_the_fill_and_the_harness_stream():
    """The fill's spin kernels on the calls' stream (7), the mark's on the
    harness's (9): the window opens at the last spin's end, and what runs
    on the harness's stream is counted apart."""
    events = [_Event("spin_kernel", 0.0, 5.0, 7),
              _Event("spin_kernel", 5.0, 10.0, 7),
              _Event("spin_kernel", 8.0, 12.0, 9),
              _Event("k1_kernel", 14.0, 20.0, 7),
              _Event("Memcpy DtoH (Device -> Pinned)", 18.0, 26.0, 9),
              _Event("t1_kernel", 30.0, 32.0, 3),
              _Event("portbench.wait", 20.0, 30.0, 0, device=False),
              _Event("portbench.wait", 21.0, 29.0, 7)]   # its device range
    tr = read(_Prof(events))
    assert tr.ops == [("k1_kernel", 14.0, 20.0), ("t1_kernel", 30.0, 32.0)]
    assert tr.busy_s == pytest.approx(8e-6)
    assert tr.harness_s == pytest.approx(8e-6)
    assert tr.window_s == pytest.approx(20e-6)
    assert tr.spans == [("portbench.wait", 20.0, 30.0)]
    with pytest.raises(RuntimeError):            # no mark: one stream
        read(_Prof([e for e in events if e.device_resource_id != 9]))


def test_union_gaps_and_top_ops():
    ops = [("void k1_kernel<3>(int*)", 0.0, 100.0), ("copy", 50.0, 150.0),
           ("k1_kernel", 400.0, 500.0), ("copy", 700.0, 800.0)]
    spans = [("h2d_submit", 100.0, 800.0), ("portbench.merge", 160.0, 390.0)]
    tr = Trace(ops, 800e-6, spans)
    assert tr.busy_s == pytest.approx(350e-6)
    assert tr.kernel_s("k1_kernel") == (pytest.approx(200e-6), 2)
    assert tr.top_ops() == [["k1_kernel", pytest.approx(200e-6)],
                            ["copy", pytest.approx(200e-6)]]
    assert tr.idle_gaps() == [["portbench.merge", pytest.approx(250e-6)],
                              ["h2d_submit", pytest.approx(200e-6)]]
    assert union_s([]) == 0.0
    assert short("void a::b_kernel<1, 2>(int)") == "a::b_kernel"
    assert short("(anonymous namespace)::k1_kernel(int const*)") == \
        "k1_kernel"
    assert short("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"


PHOTO_ITEM = {"scan_bytes": 500_000, "blocks": 80_940, "out_bytes": 2268 * 1512 * 3}


def test_roofline_bytes_from_shapes():
    assert roofline.k1_bytes([PHOTO_ITEM] * 8) == 8 * (500_000 + 80_940 * 128)
    assert roofline.decode_bytes([PHOTO_ITEM] * 2) == \
        2 * (500_000 + 2268 * 1512 * 3)
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.hbm_bytes_per_s("cpu") is None


def _readings(trace=None, hbm=3.35e12, **kw):
    base = dict(calls=10, images=80, window_s=2.0, images_done=72,
                latencies=[i / 1e3 for i in range(1, 101)],
                calls_items=[[PHOTO_ITEM] * 8, [PHOTO_ITEM] * 8],
                stages={"h2d_submit": (0.02, 10), "device_dispatch": (0.005, 10)},
                staging=(0.64, 32), merge=(0.012, 10), h2d_bytes=40_000_000,
                captures=0, trace=trace, hbm=hbm)
    base.update(kw)
    return Readings(**base)


def test_readers():
    readers = registry.metric_readers()
    per_call = roofline.k1_bytes([PHOTO_ITEM] * 8)
    k1_s = 10 * per_call / 3.35e12 * 4           # a quarter of the roofline
    tr = Trace([("huffman_decode_kernel", 0.0, k1_s * 1e6),
                ("copy", 0.0, 2 * k1_s * 1e6)], 4 * k1_s, [])
    r = _readings(trace=tr)
    got = {name: mod.read(r) for name, mod in readers.items()}
    assert got["host_images_per_s"] == pytest.approx(36.0)
    assert got["host_call_p95_ms"] == pytest.approx(95.05)
    assert got["stage_ms_per_image"] == pytest.approx(20.0)
    assert got["merge_ms_per_call"] == pytest.approx(1.2)
    assert got["h2d_submit_ms_per_call"] == pytest.approx(2.0)
    assert got["dispatch_ms_per_call"] == pytest.approx(0.5)
    assert got["h2d_mb_per_image"] == pytest.approx(0.5)
    assert got["graph_captures"] == 0
    assert got["k1_roofline"] == pytest.approx(25.0)
    assert got["device_idle_share"] == pytest.approx(50.0)
    dec = 10 * roofline.decode_bytes([PHOTO_ITEM] * 8) / 3.35e12
    assert got["decode_roofline"] == pytest.approx(100 * dec / (2 * k1_s))
    # Untraced, off a card, or a card not in the table: nothing to read.
    r = _readings(merge=None, h2d_bytes=None)
    assert readers["k1_roofline"].read(r) is None
    assert readers["merge_ms_per_call"].read(r) is None
    assert readers["h2d_mb_per_image"].read(r) is None
    assert readers["decode_roofline"].read(_readings(trace=tr, hbm=None)) \
        is None
    assert not any(math.isnan(v) for v in got.values() if v is not None)
