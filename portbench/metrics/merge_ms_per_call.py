"""The grouping layer's host merge of a group's wires, ms per call: the
benchmark's own span around the function `_group_wires` resolves
(`models/stream.py::_merge`). Nothing where no call merges."""

LAYER = "grouping"
SOURCE = "host_clock"
UNIT = "ms"
MOVES = "card_ms_per_image"


def read(r):
    if r.merge is None:
        return None
    seconds, _count = r.merge
    return seconds / r.calls * 1e3
