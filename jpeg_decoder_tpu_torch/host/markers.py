"""Copy of `jpeg_decoder_tpu/markers.py` at commit 0c2d0ea.

JPEG marker alphabet (ITU-T T.81 Table B.1).

Capability parity with `src/marker.rs:5-136`, re-expressed as a
flat integer namespace: markers are identified by their second byte (0x01-0xFE),
with small helpers for classification. A flat byte representation keeps the host
pre-scan (segment splitting for parallel entropy decode) branch-free and lets the
C++ kernel share the same constants.
"""

from __future__ import annotations

# Named marker byte values (Table B.1).
TEM = 0x01
SOF0, SOF1, SOF2, SOF3 = 0xC0, 0xC1, 0xC2, 0xC3
DHT = 0xC4
SOF5, SOF6, SOF7 = 0xC5, 0xC6, 0xC7
JPG = 0xC8
SOF9, SOF10, SOF11 = 0xC9, 0xCA, 0xCB
DAC = 0xCC
SOF13, SOF14, SOF15 = 0xCD, 0xCE, 0xCF
RST0 = 0xD0  # RST0..RST7 = 0xD0..0xD7
SOI = 0xD8
EOI = 0xD9
SOS = 0xDA
DQT = 0xDB
DNL = 0xDC
DRI = 0xDD
DHP = 0xDE
EXP = 0xDF
APP0 = 0xE0  # APP0..APP15 = 0xE0..0xEF
JPG0 = 0xF0  # JPG0..JPG13 = 0xF0..0xFD
COM = 0xFE


def is_valid(byte: int) -> bool:
    """True if `byte` names a marker (not a stuffing 0x00 or fill 0xFF).

    Mirrors `Marker::from_u8` returning Some (`src/marker.rs:64-135`):
    every byte except 0x00 and 0xFF is a marker (0x02-0xBF are RES).
    """
    return byte not in (0x00, 0xFF)


def is_sof(byte: int) -> bool:
    """SOF0..SOF15, excluding DHT (0xC4), JPG (0xC8), DAC (0xCC)."""
    return 0xC0 <= byte <= 0xCF and byte not in (DHT, JPG, DAC)


def is_rst(byte: int) -> bool:
    return 0xD0 <= byte <= 0xD7


def rst_index(byte: int) -> int:
    """The modulo-8 restart sequence number n of RSTn."""
    return byte - RST0


def is_app(byte: int) -> bool:
    return 0xE0 <= byte <= 0xEF


def app_index(byte: int) -> int:
    return byte - APP0


def has_length(byte: int) -> bool:
    """True if the marker introduces a segment with a 2-byte length field.

    Mirrors `src/marker.rs:59-62`: everything except RSTn, SOI,
    EOI and TEM. (RES and JPGn markers are treated as having a length so that the
    driver state machine can report them as "found where not allowed" in the same
    way the reference does when it encounters them.)
    """
    return not (is_rst(byte) or byte in (SOI, EOI, TEM))


def name(byte: int) -> str:
    """Human-readable marker name for error messages."""
    if is_sof(byte):
        return f"SOF{byte - 0xC0}"
    if is_rst(byte):
        return f"RST{byte - RST0}"
    if is_app(byte):
        return f"APP{byte - APP0}"
    if 0xF0 <= byte <= 0xFD:
        return f"JPG{byte - JPG0}"
    simple = {
        TEM: "TEM", DHT: "DHT", JPG: "JPG", DAC: "DAC", SOI: "SOI", EOI: "EOI",
        SOS: "SOS", DQT: "DQT", DNL: "DNL", DRI: "DRI", DHP: "DHP", EXP: "EXP",
        COM: "COM",
    }
    if byte in simple:
        return simple[byte]
    return f"RES(0x{byte:02X})"
