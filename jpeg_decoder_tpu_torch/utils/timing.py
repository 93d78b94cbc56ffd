"""Copy of `jpeg_decoder_tpu/utils/timing.py` at commit 0c2d0ea: per-stage
decode timing, with `torch.profiler` in place of JAX's profiler.

`StageTimer` collects wall times per named stage (the stream decoder's
"host_stage", "h2d_submit" and "device_dispatch" and their sub-stages,
below; the `Decoder`'s "h2d_submit", "device_dispatch" and "d2h");
`timed_stage` is the port's helper for an optional timer. `device_trace`
captures a `torch.profiler` trace of the host and the card around a block
and writes it as a Chrome trace.

`span(name)` is the port's one way to open a profiler range: a
`torch.profiler.record_function(name)` while a profiler records, and
nothing otherwise (entering a `record_function` with no profiler costs
~10 µs of host time; the check ~0.2 µs). Every stage `StageTimer.stage`
times is such a range too, so a decode under `device_trace` (or any
`torch.profiler.profile` that records the host) holds the program's
stages on the trace's clock, beside the card's operations they enqueue.

The stream decoder's sub-stages, each named after the stage it runs in
on the grouped path (`models/stream.py`, `models/graphs.py`), a timer's
stage where the decoder has a timer and a bare `span` otherwise (the
process's graph caches, `graphs.device_graphs`, have no timer):
- "h2d_submit.merge": the host merge of a group's wires (`stream._merge`);
- "h2d_submit.key": a graph's key and its first-sight check;
- "h2d_submit.tables": a call's arena arrays, the tables from the host
  caches by content (`BitsGraphs._arrays`);
- "h2d_submit.land": one H2D submission (an arena's, or a put off any
  graph); inside "device_dispatch" where a call lands its arena again
  because another call refilled it;
- "device_dispatch.replay": a graph's replay (a part's row copy, the
  replay, its tally);
- "device_dispatch.copy_out": the enqueue of the copy of a replay's
  output;
- "device_dispatch.eager": a body run off any graph (a key's first sight
  on a card, `eager=True`, the CPU);
- "device_dispatch.capture": a graph's warm-up and capture.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a profiler is on
    (`torch.autograd.profiler._is_profiler_enabled`), else a context that
    does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulates wall time per stage across repeated decodes.

    Thread-safe: staging runs on a host thread pool, so multiple stages
    report concurrently."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        """Times the block as stage `name`, inside `span(name)`."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:>16}: {total * 1000:9.2f} ms total, "
                         f"{total / n * 1000:8.3f} ms/call x{n}")
        return "\n".join(lines)

    def per_call_ms(self) -> Dict[str, float]:
        """{stage: mean ms per call} — machine-readable summary for bench JSON."""
        with self._lock:
            return {name: round(self.totals[name] / self.counts[name] * 1000, 3)
                    for name in self.totals if self.counts[name]}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


def timed_stage(timer: Optional[StageTimer], name: str):
    """`timer.stage(name)`, or `span(name)` alone when there is no timer."""
    return span(name) if timer is None else timer.stage(name)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a `torch.profiler` trace (host and, where there is one, the
    CUDA device) around a block and write it into `log_dir` as a Chrome
    trace (`trace.json`, readable in Perfetto or chrome://tracing).

    No-op when log_dir is None.
    """
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
