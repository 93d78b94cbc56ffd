"""Images whose call completed inside the window, over its seconds: the
rate the host's merge, landing and dispatch allow on shared cores. Kept
per layer: runs of one build spread too widely for any bound (PERF.md
section 2)."""

LAYER = "host loop"
SOURCE = "host_clock"
UNIT = "images/s"
MOVES = "card_ms_per_image"


def read(r):
    return r.images_done / r.window_s if r.window_s else None
