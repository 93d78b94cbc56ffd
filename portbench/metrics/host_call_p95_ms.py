"""The 95th percentile over every call of the window of its time from its
start (host clock) to its outputs' completion on the card, ms: what a
step that waits on the decoder sees. Kept per layer: runs of one build
spread too widely for any bound (PERF.md section 2)."""

from portbench.harness.readings import p95

LAYER = "host loop"
SOURCE = "host_clock"
UNIT = "ms"
MOVES = "card_ms_per_image"


def read(r):
    return p95(r.latencies) * 1e3 if r.latencies else None
