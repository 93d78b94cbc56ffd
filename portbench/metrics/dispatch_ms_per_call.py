"""The dispatch's host ms per call: the program's `StageTimer`
"device_dispatch" (the replay's enqueue and the copy-out's; host time, not
device time) over the window."""

LAYER = "dispatch"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "card_ms_per_image"


def read(r):
    return r.stage_ms_per_call("device_dispatch")
