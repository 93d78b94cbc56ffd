"""The port's one tracing mechanism (`utils/timing.py`: `span`, `StageTimer`)
and the stream decoder's sub-stages, on the CPU:
- a `DeviceStreamDecoder` with a `StageTimer` records each path's
  sub-stages exactly as often as its landings and bodies run (a hetero
  group: the merge, five keys, five arenas' tables and landings, five
  bodies; a same-plan group, one image, a prefix and a lossless group: one
  of each, the merge on the bits group only; on the CPU every body runs off
  any graph, "device_dispatch.eager");
- under `torch.profiler.profile` (the host's activity, no subclass of the
  timer) every stage and sub-stage is a range, each sub-stage's inside its
  stage's, as often as the timer counts it; without a timer the ranges are
  there all the same;
- with no profiler running the program enters no `record_function`;
- `BitsGraphs.stats()["eager"]` counts the bodies run off any graph;
- `decode_staged` is `decode_stream` after staging, image for image;
- a wrapper of the module's `_merge` that passes the scans alone (the
  benchmark's merge timing) holds the "h2d_submit.merge" stage.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jpeg_decoder_tpu_torch as jt
from jpeg_decoder_tpu_torch.models import graphs, stream
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

from torch_inputs import fixture

HETERO = ["mixed_500x375.jpg", "mixed_375x500.jpg", "mixed_500x333.jpg",
          "mixed_333x500.jpg"]


@pytest.fixture(autouse=True)
def one_thread():
    """Small images; the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sof3() -> bytes:
    return sof3_jpeg(sof3_samples(9, 11, 1, 16, 0, seed=1), 6, 0, 16)


# path -> (interchange, sources, batch size, the sub-stages' counts)
PATHS = {
    "hetero": ("bits", lambda: [fixture(n) for n in HETERO], 4,
               {"h2d_submit.merge": 1, "h2d_submit.key": 5,
                "h2d_submit.tables": 5, "h2d_submit.land": 5,
                "device_dispatch.eager": 5}),
    "same_plan": ("bits", lambda: [fixture("tower_420.jpg")] * 3, 3,
                  {"h2d_submit.merge": 1, "h2d_submit.key": 1,
                   "h2d_submit.tables": 1, "h2d_submit.land": 1,
                   "device_dispatch.eager": 1}),
    "single": ("bits", lambda: [fixture("small_444.jpg")], 1,
               {"h2d_submit.key": 1, "h2d_submit.tables": 1,
                "h2d_submit.land": 1, "device_dispatch.eager": 1}),
    "prefix": ("prefix", lambda: [fixture("small_444.jpg")] * 3, 3,
               {"h2d_submit.key": 1, "h2d_submit.tables": 1,
                "h2d_submit.land": 1, "device_dispatch.eager": 1}),
    "lossless": ("bits", lambda: [_sof3()] * 2, 2,
                 {"h2d_submit.key": 1, "h2d_submit.tables": 1,
                  "h2d_submit.land": 1, "device_dispatch.eager": 1}),
}


def _decode(path: str, timer):
    """One call of `path` on a decoder with `timer`, staged first: (the
    images, the decoder's graph-cache stats)."""
    interchange, sources, batch, _want = PATHS[path]
    with jt.DeviceStreamDecoder(device="cpu", host_threads=1,
                                interchange=interchange) as dec:
        staged = [dec.stage(s) for s in sources()]
        dec.timer = timer
        out = dec.decode_staged(staged, batch)
        return out, dec._graphs.stats()


@pytest.mark.parametrize("path", list(PATHS))
def test_sub_stages_counted_per_path(path):
    timer = jt.StageTimer()
    _out, stats = _decode(path, timer)
    want = PATHS[path][3]
    assert dict(timer.counts) == {"h2d_submit": 1, "device_dispatch": 1,
                                  **want}
    assert stats["eager"] == want["device_dispatch.eager"]
    assert stats["captures"] == stats["hits"] == 0
    for name in want:
        parent = name.split(".")[0]
        assert timer.totals[name] <= timer.totals[parent]


def _ranges(prof) -> list:
    return [e for e in prof.events()
            if e.name.startswith(("h2d_submit", "device_dispatch"))]


@pytest.mark.parametrize("path,timed", [(p, True) for p in PATHS]
                         + [("hetero", False)])
def test_sub_stages_are_ranges_inside_their_stage(path, timed):
    timer = jt.StageTimer() if timed else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(path, timer)
    ranges = _ranges(prof)
    counts = {}
    for e in ranges:
        counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == {"h2d_submit": 1, "device_dispatch": 1,
                      **PATHS[path][3]}
    if timed:
        assert counts == dict(timer.counts)
    for e in ranges:
        if "." not in e.name:
            continue
        parents = [p for p in ranges if p.name == e.name.split(".")[0]
                   and p.thread == e.thread
                   and p.time_range.start <= e.time_range.start
                   and e.time_range.end <= p.time_range.end]
        assert len(parents) == 1, e.name


class _Counted(torch.profiler.record_function):
    entered = 0

    def __enter__(self):
        type(self).entered += 1
        return super().__enter__()


def test_no_range_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Counted)
    _Counted.entered = 0
    for path in PATHS:
        _decode(path, jt.StageTimer())
        _decode(path, None)
    assert _Counted.entered == 0
    with profile(activities=[ProfilerActivity.CPU]):
        _decode("hetero", jt.StageTimer())
    # the stages, the sub-stages and the bodies' layer spans
    assert _Counted.entered > 2 + sum(PATHS["hetero"][3].values())


def test_span_and_timed_stage_follow_the_profiler():
    assert jt.utils.timing.span("x") is jt.utils.timing.span("y")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with jt.utils.timing.span("x"), \
                jt.utils.timing.timed_stage(None, "y"):
            pass
        assert isinstance(jt.utils.timing.span("z"),
                          torch.profiler.record_function)
    assert [e.name for e in prof.events()
            if e.name in ("x", "y")] == ["x", "y"]


def test_stats_count_bodies_run_off_any_graph():
    """`stats()["eager"]`: a call through its graph's arena on the CPU, the
    same with `eager=True`, and an image and a group's halves dispatched
    off any graph (a key's first sight on a card) each count their
    bodies; the timer counts them as often."""
    timer = jt.StageTimer()
    with jt.DeviceStreamDecoder(device="cpu", host_threads=1,
                                timer=timer) as dec:
        st = dec.stage(fixture("small_444.jpg"))
        one = dec.decode_one(st)
        assert dec._graphs.stats()["eager"] == 1
        assert torch.equal(dec._run_device_eager(st, dec._to_device(st)),
                           one)
        assert dec._graphs.stats()["eager"] == 2
        assert torch.equal(dec._run_device(st, dec._wire_tensors(st)), one)
        assert dec._graphs.stats()["eager"] == 3
        group = [dec.stage(fixture(n)) for n in HETERO[:2]]
        halves = dec._group_halves(group, *dec._bits_merge(group), None,
                                   None)
        dec._run_halves(group, halves)
        stats = dec._graphs.stats()
    assert stats["eager"] == 3 + 1 + 2       # the sweep and two parts
    assert stats["captures"] == stats["hits"] == 0
    assert timer.counts["device_dispatch.eager"] == stats["eager"]


def test_timer_set_later_reaches_the_graph_caches():
    with jt.DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        st = dec.stage(fixture("small_444.jpg"))
        dec.decode_one(st)
        timer = jt.StageTimer()
        dec.timer = timer
        assert all(c.timer is timer for c in dec._caches.values())
        dec.decode_one(st)
        dec.timer = None
        dec.decode_one(st)
    assert timer.counts["h2d_submit.tables"] == 1
    assert timer.counts["device_dispatch.eager"] == 1


def test_device_graphs_have_no_timer():
    cache = graphs.device_graphs("cpu")
    assert cache.timer is None


@pytest.mark.parametrize("batch_size", [1, 3])
def test_decode_staged_equals_decode_stream(batch_size):
    """A mixed list (one-image bits, a same-plan pair, lossless, a hetero
    pair, a source that fails to stage): `decode_staged` of the staged
    images, a None where staging failed, gives `decode_stream`'s tensors
    bit for bit."""
    sources = [fixture("small_444.jpg"), fixture("tower_420.jpg"),
               fixture("tower_420.jpg"), _sof3(), _sof3(),
               fixture(HETERO[0]), fixture(HETERO[1]), b"not a jpeg",
               fixture("small_gray.jpg")]
    with jt.DeviceStreamDecoder(device="cpu", host_threads=2) as dec:
        want = dec.decode_stream(sources, batch_size=batch_size,
                                 on_error="none")
        staged = []
        for s in sources:
            try:
                staged.append(dec.stage(s))
            except jt.JpegError:
                staged.append(None)
        got = dec.decode_staged(staged, batch_size)
    assert len(got) == len(want) == len(sources)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_merge_stage_inside_a_wrapper_of_merge(monkeypatch):
    """A wrapper put in place of the module's `_merge` that passes the
    scans alone (as the benchmark's merge timing does) sees every merge,
    and the program's "h2d_submit.merge" stage times the body inside it."""
    seen = []
    real = stream._merge

    def wrapper(scans):
        t0 = time.perf_counter()
        out = real(scans)
        seen.append(time.perf_counter() - t0)
        return out

    monkeypatch.setattr(stream, "_merge", wrapper)
    timer = jt.StageTimer()
    _decode("hetero", timer)
    assert len(seen) == timer.counts["h2d_submit.merge"] == 1
    assert timer.totals["h2d_submit.merge"] <= seen[0]


def test_hetero_images_unchanged_by_the_timer():
    plain, _ = _decode("hetero", None)
    timed, _ = _decode("hetero", jt.StageTimer())
    for a, b in zip(plain, timed):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
