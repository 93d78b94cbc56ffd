"""The card's idle share of the traced window: 1 - the union of every
device operation over the window's length on the device's clock, %."""

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "card_ms_per_image"


def read(r):
    if r.trace is None or not r.trace.window_s:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
