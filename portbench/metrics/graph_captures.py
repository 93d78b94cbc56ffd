"""CUDA graphs captured inside the window (`BitsGraphs.stats()`): every
key is warm after set-up, so none are expected."""

LAYER = "dispatch"
SOURCE = "program_counter"
UNIT = "count"
MOVES = "card_ms_per_image"


def read(r):
    return r.captures
