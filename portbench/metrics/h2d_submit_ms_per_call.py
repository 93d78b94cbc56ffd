"""The H2D landing's host ms per call: the program's `StageTimer`
"h2d_submit" (the merge of a group's wires and their landing in the
graph's arena) over the window."""

LAYER = "H2D landing"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "card_ms_per_image"


def read(r):
    return r.stage_ms_per_call("h2d_submit")
