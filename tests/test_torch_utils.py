"""The port's utilities and host pools against the JAX package's:
- `utils.timing.StageTimer`: the same totals, counts, summary and
  per-call figures as the reference's on one sequence of stages (a fake
  clock drives both); `device_trace` writes a Chrome trace, and is a no-op
  without a directory;
- `utils.link`: `record_transfer`, `link_mb_s` and `degraded` give the
  reference's answers on the same sample sequence, with no probe;
- the host stage's numpy `_BufferPool`: the reference's class, operation
  for operation, and its depth and budget bounds after a mixed-size
  staging soak (the reference's `test_soak_mixed_corpus_bounded_memory`,
  on synthesized inputs);
- `DeviceStreamDecoder(timer=...)` on the CPU records "host_stage",
  "h2d_submit" and "device_dispatch" and leaves every image as it was;
  `stage_host_bits` has the reference's signature.
Tolerance: exact equality throughout (no arithmetic differs).
"""

import inspect
import time

import numpy as np
import pytest
import torch

import jpeg_decoder_tpu.models.stream as ref_stream
import jpeg_decoder_tpu.utils.link as ref_link
import jpeg_decoder_tpu.utils.timing as ref_timing
import jpeg_decoder_tpu_torch as jt
import jpeg_decoder_tpu_torch.host.staging as port_staging
import jpeg_decoder_tpu_torch.utils.link as port_link
import jpeg_decoder_tpu_torch.utils.timing as port_timing
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

from torch_inputs import fixture, synth_jpeg


class _Clock:
    """A fake clock: each call advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps = 0.0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 0.001
        return self.t


STAGES = ["host_stage", "h2d_submit", "host_stage", "device_dispatch",
          "host_stage", "h2d_submit"]


def _drive_timer(module, monkeypatch):
    monkeypatch.setattr(time, "perf_counter",
                        _Clock([0.5, 0.25, 1.0, 0.125, 2.0, 0.0625] * 4))
    timer = module.StageTimer()
    for name in STAGES:
        with timer.stage(name):
            pass
    with pytest.raises(KeyError):
        with timer.stage("failed"):       # a failing stage still counts
            raise KeyError("x")
    out = (dict(timer.totals), dict(timer.counts), timer.summary(),
           timer.per_call_ms())
    timer.reset()
    return out + (dict(timer.totals), dict(timer.counts))


def test_stage_timer_behaves_as_the_reference(monkeypatch):
    got = _drive_timer(port_timing, monkeypatch)
    want = _drive_timer(ref_timing, monkeypatch)
    assert got == want
    assert got[1] == {"host_stage": 3, "h2d_submit": 2,
                      "device_dispatch": 1, "failed": 1}


def test_device_trace(tmp_path):
    with port_timing.device_trace(None):
        pass
    with port_timing.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


SAMPLES = [(8 << 20, 0.5), (512 << 10, 0.001), (4 << 20, 0.0),
           (16 << 20, 0.001), (64 << 20, 2.0), (2 << 20, 0.05),
           (32 << 20, 1.0)]


def _drive_link(module, monkeypatch):
    monkeypatch.setitem(module._state, "mb_s", None)
    monkeypatch.setitem(module._state, "t", 0.0)
    monkeypatch.setattr(time, "monotonic", _Clock([1000.0] + [1.0] * 40))
    seen = [(module.link_mb_s(allow_probe=False), module.degraded())]
    for nbytes, seconds in SAMPLES:
        module.record_transfer(nbytes, seconds)
        seen.append((module._state["mb_s"], module.link_mb_s(False),
                     module.degraded()))
    monkeypatch.setattr(time, "monotonic", _Clock([10_000.0]))
    seen.append((module.link_mb_s(allow_probe=False), module.degraded()))
    return seen


def test_link_state_equal_to_the_reference(monkeypatch):
    monkeypatch.delenv("JPEG_TPU_LINK_MB_S", raising=False)
    got = _drive_link(port_link, monkeypatch)
    want = _drive_link(ref_link, monkeypatch)
    assert got == want
    assert got[0] == (float("inf"), False)      # healthy by default
    assert any(d for *_x, d in got[1:-1])        # the slow samples degrade
    assert (port_link.DEGRADED_MB_S, port_link._TTL_S, port_link._EMA) \
        == (ref_link.DEGRADED_MB_S, ref_link._TTL_S, ref_link._EMA)


def test_link_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py probes it")
    with pytest.raises(Exception):
        port_link.probe()


def _drive_pool(cls):
    pool = cls(depth=2, budget=3000)
    out = []
    arrays = [np.zeros(n, dt) for n, dt in
              [(100, np.int16)] * 3 + [(200, np.int32), (100, np.int16),
                                      (300, np.int8), (500, np.int32)]]
    for a in arrays:
        pool.release(a)
        out.append((pool._bytes, {k: len(v) for k, v in pool._free.items()}))
    for n, dt in ((100, np.int16), (500, np.int32), (7, np.int8)):
        b = pool.acquire(n, dt)
        out.append((b.shape, b.dtype.str, pool._bytes))
    return out


def test_buffer_pool_equal_to_the_reference():
    assert _drive_pool(port_staging._BufferPool) \
        == _drive_pool(ref_stream._BufferPool)


def test_buffer_pool_bounded_after_a_mixed_soak(monkeypatch):
    """Staging over mixed sizes and kinds (baseline, DRI, gray, progressive,
    lossless, a malformed stream) with a small pool: the budget and the
    per-class depth hold, and staging stays deterministic. The budget is
    under half of what these inputs would keep unbounded (1.1 MB), and
    above any one size class (the reference's eviction keeps the class
    just released)."""
    pool = port_staging._BufferPool(depth=2, budget=512 << 10)
    monkeypatch.setattr(port_staging, "_pool", pool)
    datas = [synth_jpeg(w, h, seed=w) for w, h in
             ((48, 32), (64, 40), (32, 56), (80, 24))] + [
        fixture("small_gray.jpg"), fixture("small_dri.jpg"),
        fixture("small_422_progressive.jpg"),
        sof3_jpeg(sof3_samples(12, 9, 1, 8, 0, seed=1), 6, 0, 8),
        b"\xff\xd8 definitely not a jpeg"]
    golden = {}
    rng = np.random.default_rng(7)
    for i in range(60):
        k = int(rng.integers(len(datas)))
        try:
            st = port_staging.stage_host(datas[k])
        except jt.JpegError:
            continue
        key = (getattr(st, "dc", None), getattr(st, "diffs", None))
        digest = b"".join(a.tobytes() for a in key if a is not None)
        assert golden.setdefault(k, digest) == digest
        assert pool._bytes <= pool._budget
        assert all(len(s) <= 2 for s in pool._free.values())
    assert pool._bytes == sum(a.nbytes for s in pool._free.values()
                              for a in s)
    assert pool._free, "the soak never released a buffer to the pool"


def test_stage_host_bits_has_the_reference_signature():
    names = list(inspect.signature(jt.stage_host_bits).parameters)
    assert names == list(inspect.signature(ref_stream.stage_host_bits)
                         .parameters)
    assert names == ["source", "scale_to", "precision", "timer",
                     "pool_width"]


@pytest.mark.parametrize("batch_size", [1, 3])
@pytest.mark.parametrize("interchange", ["bits", "prefix"])
def test_stream_timer_records_the_stages(batch_size, interchange):
    stream = [fixture("small_444.jpg")] * 3 + [
        sof3_jpeg(sof3_samples(9, 11, 1, 16, 0, seed=1), 6, 0, 16)] * 2
    timer = jt.StageTimer()
    with jt.DeviceStreamDecoder(device="cpu", host_threads=2,
                                interchange=interchange, timer=timer) as dec:
        timed = dec.decode_stream(stream, batch_size=batch_size)
    with jt.DeviceStreamDecoder(device="cpu", host_threads=2,
                                interchange=interchange) as dec:
        plain = dec.decode_stream(stream, batch_size=batch_size)
    for a, b in zip(timed, plain):
        assert torch.equal(a, b)
    counts = dict(timer.counts)
    assert counts["host_stage"] == len(stream)
    dispatches = len(stream) if batch_size == 1 else 2
    assert counts["h2d_submit"] == counts["device_dispatch"] == dispatches
