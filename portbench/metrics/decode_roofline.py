"""The kernels' share of the whole decode's roofline: the entropy-coded
bytes read once and the output written once (`roofline.decode_bytes`),
whatever kernels implement it, over the card's HBM bandwidth, against the
union of every device operation of the window (kernels, copies, memsets)."""

from portbench.harness import roofline

LAYER = "kernels"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "card_ms_per_image"


def read(r):
    if r.trace is None:
        return None
    return r.roofline_pct(roofline.decode_bytes, r.trace.busy_s)
