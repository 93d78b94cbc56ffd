"""Host staging's ms per image: the program's `StageTimer` "host_stage"
over the pool, staged one image after another on one thread in set-up."""

LAYER = "host staging"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "setup_s"


def read(r):
    seconds, images = r.staging
    return seconds / images * 1e3 if images else None
