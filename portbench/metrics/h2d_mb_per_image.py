"""MB landed per image: the pinned pool's `copied_bytes` over the window
(`transfer.PinnedPool`), over the window's images. Nothing off a card."""

LAYER = "H2D landing"
SOURCE = "program_counter"
UNIT = "MB"
MOVES = "card_ms_per_image"


def read(r):
    if r.h2d_bytes is None or not r.images:
        return None
    return r.h2d_bytes / r.images / 1e6
