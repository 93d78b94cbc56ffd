"""K1's share of its roofline: the least bytes its inputs need (each
image's entropy-coded bytes in, its int16 coefficients out,
`roofline.k1_bytes`) over the card's HBM bandwidth, against K1's device
time by name in the trace, per call. Nothing where K1 does not run."""

from portbench.harness import roofline

LAYER = "entropy decode"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "card_ms_per_image"


def read(r):
    if r.trace is None:
        return None
    seconds, launches = r.trace.kernel_s("huffman_decode_kernel")
    return r.roofline_pct(roofline.k1_bytes, seconds) if launches else None
