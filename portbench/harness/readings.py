"""What the per-layer readers (`portbench/metrics/*.py`) read: one run's
spans, counters and trace, and the inputs whose bytes bound its kernels."""

from __future__ import annotations

import dataclasses
import statistics

from . import trace as trace_mod


def p95(values: list) -> float:
    """The 95th percentile of every value (linear between order
    statistics)."""
    return statistics.quantiles(values, n=20, method="inclusive")[-1] \
        if len(values) > 1 else values[0]


@dataclasses.dataclass
class Readings:
    """`calls`: the window's calls, `images` their images, `window_s` its
    length on the host clock; `images_done`: the images whose call
    completed inside it; `latencies`: every call's seconds from its start
    to its completion (host clock); `calls_items`: per distinct call
    input the pool items it decodes (call k takes input k %
    len(calls_items));
    `stages`: the program's `StageTimer` over the window, {stage: (seconds,
    count)}; `staging`: its "host_stage" over the pool in set-up, one
    thread, (seconds, images); `merge`: the benchmark's span around the
    host merge of a group's wires, (seconds, count), None where it did not
    run; `h2d_bytes`: the pinned pool's copied bytes over the window, None
    off a card; `captures`: graphs captured in the window (none on the
    CPU, where every call runs its body eagerly); `trace`: the traced
    window (`trace.Trace`), None in an untraced run; `hbm`: the card's peak
    bytes/s, None for a card not in the table."""
    calls: int
    images: int
    window_s: float
    images_done: int
    latencies: list
    calls_items: list
    stages: dict
    staging: tuple
    merge: tuple
    h2d_bytes: int
    captures: int
    trace: "trace_mod.Trace"
    hbm: float

    def per_call(self, bytes_of) -> float:
        """The mean over the window's calls of `bytes_of(items)`: every
        call input is issued equally often, in turn."""
        return sum(bytes_of(items) for items in self.calls_items) \
            / len(self.calls_items)

    def stage_ms_per_call(self, name: str):
        total, count = self.stages.get(name, (0.0, 0))
        return total / count * 1e3 if count else None

    def roofline_pct(self, bytes_of, seconds: float):
        """100 x the least time the window's calls need at the card's peak
        bandwidth (`bytes_of` per call) over `seconds` of the trace; None
        where there is no time or no peak."""
        if not seconds or self.hbm is None:
            return None
        return 100.0 * self.calls * self.per_call(bytes_of) / self.hbm \
            / seconds
