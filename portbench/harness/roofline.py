"""The yardstick of the rooflines: the card's peaks and the least bytes a
call's work needs, from the inputs' shapes.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; the time that bytes over the peak give is
the least the call can take on the card.
"""

from __future__ import annotations

# Published HBM bandwidth by `torch.cuda.get_device_name()` (NVIDIA data
# sheets; the rates assume the card's full power limit, which the run
# prints beside its numbers).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str):
    """The card's peak bandwidth, or None for a card not in the table (its
    rooflines are then not reported)."""
    return HBM_BYTES_PER_S.get(kind)


def k1_bytes(images: list) -> int:
    """K1 (Huffman decode): each image's entropy-coded bytes in, its int16
    coefficients out (64 per coded block)."""
    return sum(it["scan_bytes"] + it["blocks"] * 64 * 2 for it in images)


def decode_bytes(images: list) -> int:
    """A whole decode, whatever implements it: the entropy-coded bytes read
    once, the output image written once."""
    return sum(it["scan_bytes"] + it["out_bytes"] for it in images)
