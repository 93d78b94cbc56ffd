"""Copy of `jpeg_decoder_tpu/utils/timing.py` at commit 0c2d0ea: per-stage
decode timing, with `torch.profiler` in place of JAX's profiler.

`StageTimer` collects wall times per named stage (the stream decoder's
"host_stage", "h2d_submit" and "device_dispatch"; the `Decoder`'s
"h2d_submit", "device_dispatch" and "d2h"); `timed_stage` is the port's
helper for an optional timer. `device_trace` captures a `torch.profiler`
trace of the host and the card around a block and writes it as a Chrome
trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


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
        t0 = time.perf_counter()
        try:
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


@contextlib.contextmanager
def timed_stage(timer: Optional[StageTimer], name: str):
    """`timer.stage(name)`, or nothing when there is no timer."""
    if timer is None:
        yield
    else:
        with timer.stage(name):
            yield


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
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
