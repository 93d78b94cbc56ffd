"""The traced run: torch.profiler over the window, and what the benchmark
reads from the trace.

The window opens behind a fill of spin kernels launched back to back, as
`tools/torch_port_profile.py::kernel_device_us` opens its trace (copied):
a trace loses the card's work of the first ms or so after the host's last
wait, so only what follows the last spin kernel the trace holds is
counted. Device operations are the trace's kernels, copies and memsets;
the ranges that `record_function` puts on the device's timeline mirror
host spans and are left out (any device event named as a host event is).
So is the work of the harness's own stream (its copies of the sampled
calls' outputs): one spin kernel put on that stream behind the fill
marks it, and every operation on the marked stream is counted apart.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

# Seconds of spin kernels before the window (`kernel_device_us`'s fill).
SPIN_FILL_S = 0.02
SPIN = "spin_kernel"
# Host spans that label what the host was doing during a device idle gap:
# the benchmark's own and the program's `StageTimer` stages.
HOST_LABELS = ("portbench.", "h2d_submit", "device_dispatch", "host_stage")


def spin_fill(seconds: float = SPIN_FILL_S) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        torch.cuda._sleep(1000)


def mark(stream) -> None:
    """Mark `stream` as the harness's own: one spin kernel on it, behind
    the fill (the fill's kernels run on the stream of the calls)."""
    with torch.cuda.stream(stream):
        torch.cuda._sleep(1000)
    stream.synchronize()


def profile(host: bool = True):
    """The profiler over the device's operations, and over the host's with
    `host` (the traced run's spans and stages)."""
    from torch.profiler import ProfilerActivity, profile as prof
    acts = [ProfilerActivity.CUDA]
    return prof(activities=[ProfilerActivity.CPU] + acts if host else acts)


def span(name: str):
    return torch.profiler.record_function(name)


def short(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace, template and argument lists."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for sep in ("(", "<"):
        name = name.split(sep, 1)[0]
    return name.strip()[:200]


def union_s(intervals) -> float:
    """Seconds covered by (start, end) µs intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e6


@dataclasses.dataclass
class Trace:
    """The window's device operations [(name, start µs, end µs)], its
    length on the device's clock (from the last spin kernel's end to the
    last operation's end) and the host's labelled spans [(label, start,
    end)], all opened by the thread that issues the calls; `harness_s`:
    the seconds of the harness's own stream inside the window, not among
    `ops`."""
    ops: list
    window_s: float
    spans: list
    harness_s: float = 0.0

    @property
    def busy_s(self) -> float:
        return union_s((s, e) for _n, s, e in self.ops)

    def kernel_s(self, symbol: str) -> tuple:
        """(seconds, launches) of the kernels whose name holds `symbol`."""
        mine = [(s, e) for n, s, e in self.ops if symbol in n]
        return sum(e - s for s, e in mine) / 1e6, len(mine)

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.ops:
            by[short(name)] = by.get(short(name), 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The `n` longest gaps between device operations, each labelled
        by the innermost host span open at its middle ("none" if none)."""
        gaps, end = [], None
        for s, e in sorted((s, e) for _n, s, e in self.ops):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            open_ = [sp for sp in self.spans if sp[1] <= mid < sp[2]]
            label = max(open_, key=lambda sp: sp[1])[0] if open_ else "none"
            out.append([label, (e - s) / 1e6])
        return out


def read(prof) -> Trace:
    """The window's `Trace` from a finished profile whose spin kernels
    are the fill's on one stream and the mark's on the harness's
    (`mark`)."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != cuda}
    dev = [(e.name, e.time_range.start, e.time_range.end,
            e.device_resource_id) for e in events
           if e.device_type == cuda and e.name not in host_names]
    spins = [(e, r) for name, _s, e, r in dev if SPIN in name]
    streams = collections.Counter(r for _e, r in spins)
    if len(streams) != 2:
        raise RuntimeError("the trace holds the spin kernels of "
                           f"{len(streams)} streams, not the fill's and the "
                           "mark's")
    own = min(streams, key=streams.get)
    start = max(e for e, _r in spins)
    window = [op for op in dev if op[1] >= start and SPIN not in op[0]]
    ops = [op[:3] for op in window if op[3] != own]
    if not ops:
        raise RuntimeError("the trace holds no device operation after the "
                           "spin fill")
    harness = union_s(op[1:3] for op in window if op[3] == own)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type != cuda and e.name.startswith(HOST_LABELS)]
    return Trace(ops, (max(e for _n, _s, e in ops) - start) / 1e6, spans,
                 harness)
