"""Copy of `jpeg_decoder_tpu/parser.py` at commit 0c2d0ea.

JPEG syntax parsing: segments -> frame/scan/table descriptors.

Capability parity with `src/parser.rs` (all of SOF/SOS/DQT/DHT/
DRI/COM/APPn parsing plus every validation rule), re-expressed over an in-memory
byte cursor. Keeping the segment layer on the host in plain Python is the right
TPU-native split: it runs once per image in microseconds, while everything
shape-bearing it produces (MCU grids, per-component block geometry) is static
metadata that downstream jit-compiled kernels specialize on.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from . import markers as M
from .errors import FormatError, IoError, UnsupportedError, UnsupportedFeature
from .huffman import HuffmanTable


class ByteCursor:
    """Forward-only cursor over a JPEG byte buffer, optionally fed
    incrementally from a reader.

    Replaces the reference's `io::Read` plumbing (`src/lib.rs:56-66`)
    with an explicit contract: header parsing (`read_info`) consumes a reader
    incrementally in small chunks, while entropy decode requires the full
    remaining stream in memory (`drain()`), because the entropy pre-scan and
    restart-segment splitter index it randomly — that random access is what
    buys the segment/anchor parallelism. `streaming=True` restores the
    reference's bounded-memory reader contract instead: scan decode refills
    on demand and `compact()` discards consumed bytes, so only a small
    window is ever buffered (`Decoder(reader, streaming=True)` selects the
    resumable oracle entropy engine to drive it). `max_bytes` bounds the
    CUMULATIVE bytes a feeder may supply (DoS guard for untrusted readers);
    exceeding it raises FormatError.
    """

    __slots__ = ("data", "pos", "_source", "_max", "streaming", "base",
                 "buffered_hwm", "chunk")

    def __init__(self, data: bytes = b"", pos: int = 0, source=None,
                 max_bytes: "Optional[int]" = None, streaming: bool = False,
                 chunk: int = 65536):
        self.data = data
        self.pos = pos
        self._source = source
        self._max = max_bytes
        self.streaming = streaming
        self.chunk = chunk         # refill granularity (window size bound)
        self.base = 0              # absolute offset of data[0] in the stream
        self.buffered_hwm = len(data)  # high-water mark of the buffer
        if max_bytes is not None and len(data) > max_bytes:
            raise FormatError("input exceeds max_input_bytes")

    def _ensure(self, end: int) -> None:
        while self._source is not None and len(self.data) < end:
            want = max(self.chunk, end - len(self.data))
            chunk = self._source.read(want)
            if not chunk:
                self._source = None
                break
            self.data = self.data + chunk
            if len(self.data) > self.buffered_hwm:
                self.buffered_hwm = len(self.data)
            if self._max is not None and self.base + len(self.data) > self._max:
                self._source = None
                raise FormatError("input exceeds max_input_bytes")

    def compact(self) -> None:
        """Streaming mode: drop consumed bytes so buffered memory stays
        bounded by the refill window. No-op unless streaming (positions in
        `data` are only stable across calls when nobody compacts)."""
        if self.streaming and self.pos > 0:
            self.base += self.pos
            self.data = self.data[self.pos:]
            self.pos = 0

    def drain(self) -> None:
        """Buffer the entire remaining stream (required before scan decode)."""
        while self._source is not None:
            chunk = self._source.read(1 << 20)
            if not chunk:
                self._source = None
                break
            self.data = self.data + chunk
            if len(self.data) > self.buffered_hwm:
                self.buffered_hwm = len(self.data)
            if self._max is not None and self.base + len(self.data) > self._max:
                self._source = None
                raise FormatError("input exceeds max_input_bytes")

    def u8(self) -> int:
        pos = self.pos
        if pos >= len(self.data):
            self._ensure(pos + 1)
            if pos >= len(self.data):
                raise IoError()
        self.pos = pos + 1
        return self.data[pos]

    def u16_be(self) -> int:
        pos = self.pos
        if pos + 2 > len(self.data):
            self._ensure(pos + 2)
            if pos + 2 > len(self.data):
                raise IoError()
        self.pos = pos + 2
        return (self.data[pos] << 8) | self.data[pos + 1]

    def take(self, n: int) -> bytes:
        pos = self.pos
        if pos + n > len(self.data):
            self._ensure(pos + n)
            if pos + n > len(self.data):
                raise IoError()
        self.pos = pos + n
        return self.data[pos:pos + n]

    def skip(self, n: int) -> None:
        if self.pos + n > len(self.data):
            self._ensure(self.pos + n)
        if self.pos + n > len(self.data):
            self.pos = len(self.data)
            raise IoError()
        self.pos += n

    def remaining(self) -> int:
        return len(self.data) - self.pos


class CodingProcess(enum.Enum):
    """Coding process of a frame (`src/parser.rs:26-33`)."""

    DCT_SEQUENTIAL = "DctSequential"
    DCT_PROGRESSIVE = "DctProgressive"
    LOSSLESS = "Lossless"


class Predictor(enum.IntEnum):
    """Lossless predictor selection, Table H.1 (`src/parser.rs:36-46`)."""

    NO_PREDICTION = 0
    RA = 1
    RB = 2
    RC = 3
    RA_RB_RC_1 = 4  # Ra + Rb - Rc
    RA_RB_RC_2 = 5  # Ra + ((Rb - Rc) >> 1)
    RA_RB_RC_3 = 6  # Rb + ((Ra - Rc) >> 1)
    RA_RB = 7       # (Ra + Rb) / 2


class AdobeColorTransform(enum.Enum):
    """APP14 Adobe transform flag (`src/parser.rs:104-111`)."""

    UNKNOWN = 0
    YCBCR = 1
    YCCK = 2


@dataclasses.dataclass(frozen=True)
class Dimensions:
    width: int
    height: int


@dataclasses.dataclass
class Component:
    """One frame component (`src/parser.rs:77-89`).

    ``size`` is the component's real sample extent after IDCT scaling;
    ``block_size`` is the 8x8-block grid padded out to whole MCUs.
    """

    identifier: int
    horizontal_sampling_factor: int
    vertical_sampling_factor: int
    quantization_table_index: int
    dct_scale: int = 8
    size: Dimensions = Dimensions(0, 0)
    block_size: Dimensions = Dimensions(0, 0)


@dataclasses.dataclass
class FrameInfo:
    """Parsed SOF header (`src/parser.rs:50-61`)."""

    is_baseline: bool
    is_differential: bool
    coding_process: CodingProcess
    entropy_coding_arithmetic: bool
    precision: int
    image_size: Dimensions
    output_size: Dimensions
    mcu_size: Dimensions
    components: list  # list[Component]

    def update_idct_size(self, idct_size: int) -> None:
        """Re-derive geometry for IDCT-domain scaling
        (`src/parser.rs:120-133`)."""
        for component in self.components:
            component.dct_scale = idct_size
        self.mcu_size = update_component_sizes(self.image_size, self.components)
        # The reference computes ceil via f32 math; sizes fit far below f32
        # precision limits so integer ceil-div is identical.
        self.output_size = Dimensions(
            width=-(-self.image_size.width * idct_size // 8),
            height=-(-self.image_size.height * idct_size // 8),
        )


@dataclasses.dataclass
class ScanInfo:
    """Parsed SOS header (`src/parser.rs:64-74`)."""

    component_indices: list
    dc_table_indices: list
    ac_table_indices: list
    spectral_selection_start: int  # inclusive
    spectral_selection_end: int    # exclusive, like the reference's Range
    predictor_selection: Predictor
    successive_approximation_high: int
    successive_approximation_low: int
    point_transform: int


@dataclasses.dataclass
class IccChunk:
    num_markers: int
    seq_no: int
    data: bytes


@dataclasses.dataclass(frozen=True)
class JfifInfo:
    """JFIF APP0 header fields (jfif3.pdf §JFIF APP0 marker segment).

    The reference only detects the `JFIF\\0` identifier
    (`src/parser.rs:618-632`); the density/thumbnail fields
    are parsed here as an extension. `density_unit`: 0 = aspect ratio only,
    1 = dots/inch, 2 = dots/cm. `thumbnail` is raw RGB24 bytes (may be empty).
    """
    version_major: int
    version_minor: int
    density_unit: int
    x_density: int
    y_density: int
    thumbnail_width: int
    thumbnail_height: int
    thumbnail: bytes


# AppData variants are returned as (kind, payload) tuples.
APP_ADOBE = "adobe"
APP_JFIF = "jfif"
APP_AVI1 = "avi1"
APP_ICC = "icc"
APP_EXIF = "exif"
APP_XMP = "xmp"
APP_PSIR = "psir"


def read_length(cursor: ByteCursor, marker: int) -> int:
    """Segment length excluding the length field itself
    (`src/parser.rs:136-147`)."""
    assert M.has_length(marker)
    length = cursor.u16_be()
    if length < 2:
        raise FormatError(f"encountered {M.name(marker)} with invalid length {length}")
    return length - 2


def ceil_div(x: int, y: int) -> int:
    """ceil(x/y) with the reference's zero guard (`src/parser.rs:283-290`)."""
    if x == 0 or y == 0:
        raise FormatError("invalid dimensions")
    return 1 + (x - 1) // y


def update_component_sizes(size: Dimensions, components: list) -> Dimensions:
    """Derive per-component sample/block geometry and the MCU grid
    (`src/parser.rs:292-310`)."""
    h_max = max(c.horizontal_sampling_factor for c in components)
    v_max = max(c.vertical_sampling_factor for c in components)

    mcu_size = Dimensions(
        width=ceil_div(size.width, h_max * 8),
        height=ceil_div(size.height, v_max * 8),
    )

    for c in components:
        c.size = Dimensions(
            width=ceil_div(size.width * c.horizontal_sampling_factor * c.dct_scale, h_max * 8),
            height=ceil_div(size.height * c.vertical_sampling_factor * c.dct_scale, v_max * 8),
        )
        c.block_size = Dimensions(
            width=mcu_size.width * c.horizontal_sampling_factor,
            height=mcu_size.height * c.vertical_sampling_factor,
        )

    return mcu_size


def parse_sof(cursor: ByteCursor, marker: int) -> FrameInfo:
    """Section B.2.2 frame header (`src/parser.rs:161-280`)."""
    length = read_length(cursor, marker)
    if length <= 6:
        raise FormatError("invalid length in SOF")

    sof = marker - 0xC0
    is_baseline = sof == 0
    if sof in (0, 1, 2, 3, 9, 10, 11):
        is_differential = False
    elif sof in (5, 6, 7, 13, 14, 15):
        is_differential = True
    else:
        raise FormatError(f"unexpected SOF marker {M.name(marker)}")
    if sof in (0, 1, 5, 9, 13):
        coding_process = CodingProcess.DCT_SEQUENTIAL
    elif sof in (2, 6, 10, 14):
        coding_process = CodingProcess.DCT_PROGRESSIVE
    else:
        coding_process = CodingProcess.LOSSLESS
    entropy_coding_arithmetic = sof >= 9

    precision = cursor.u8()
    if precision == 8:
        pass
    elif precision == 12:
        if is_baseline:
            raise FormatError("12 bit sample precision is not allowed in baseline")
    else:
        if coding_process != CodingProcess.LOSSLESS or precision > 16:
            raise FormatError(f"invalid precision {precision} in frame header")

    height = cursor.u16_be()
    width = cursor.u16_be()

    if height == 0:
        # DNL-deferred height (B.2.5) is typed-unsupported.
        raise UnsupportedError(UnsupportedFeature.DNL)
    if width == 0:
        raise FormatError("zero width in frame header")

    component_count = cursor.u8()
    if component_count == 0:
        raise FormatError("zero component count in frame header")
    if coding_process == CodingProcess.DCT_PROGRESSIVE and component_count > 4:
        raise FormatError("progressive frame with more than 4 components")
    if length != 6 + 3 * component_count:
        raise FormatError("invalid length in SOF")

    components: list = []
    for _ in range(component_count):
        identifier = cursor.u8()
        if any(c.identifier == identifier for c in components):
            raise FormatError(f"duplicate frame component identifier {identifier}")

        byte = cursor.u8()
        h = byte >> 4
        v = byte & 0x0F
        if h == 0 or h > 4:
            raise FormatError(f"invalid horizontal sampling factor {h}")
        if v == 0 or v > 4:
            raise FormatError(f"invalid vertical sampling factor {v}")

        qt_index = cursor.u8()
        if qt_index > 3 or (coding_process == CodingProcess.LOSSLESS and qt_index != 0):
            raise FormatError(f"invalid quantization table index {qt_index}")

        components.append(Component(
            identifier=identifier,
            horizontal_sampling_factor=h,
            vertical_sampling_factor=v,
            quantization_table_index=qt_index,
        ))

    mcu_size = update_component_sizes(Dimensions(width, height), components)

    return FrameInfo(
        is_baseline=is_baseline,
        is_differential=is_differential,
        coding_process=coding_process,
        entropy_coding_arithmetic=entropy_coding_arithmetic,
        precision=precision,
        image_size=Dimensions(width, height),
        output_size=Dimensions(width, height),
        mcu_size=mcu_size,
        components=components,
    )


def parse_sos(cursor: ByteCursor, frame: FrameInfo) -> ScanInfo:
    """Section B.2.3 scan header (`src/parser.rs:332-482`)."""
    length = read_length(cursor, M.SOS)
    if length == 0:
        raise FormatError("zero length in SOS")

    component_count = cursor.u8()
    if component_count == 0 or component_count > 4:
        raise FormatError(f"invalid component count {component_count} in scan header")
    if length != 4 + 2 * component_count:
        raise FormatError("invalid length in SOS")

    component_indices: list = []
    dc_table_indices: list = []
    ac_table_indices: list = []

    for _ in range(component_count):
        identifier = cursor.u8()
        component_index = next(
            (i for i, c in enumerate(frame.components) if c.identifier == identifier), None)
        if component_index is None:
            raise FormatError(
                f"scan component identifier {identifier} does not match any of the "
                "component identifiers defined in the frame")
        if component_index in component_indices:
            raise FormatError(f"duplicate scan component identifier {identifier}")
        if component_indices and component_index < max(component_indices):
            raise FormatError(
                "the scan component order does not follow the order in the frame header")

        byte = cursor.u8()
        dc_table_index = byte >> 4
        ac_table_index = byte & 0x0F
        if dc_table_index > 3 or (frame.is_baseline and dc_table_index > 1):
            raise FormatError(f"invalid dc table index {dc_table_index}")
        if ac_table_index > 3 or (frame.is_baseline and ac_table_index > 1):
            raise FormatError(f"invalid ac table index {ac_table_index}")

        component_indices.append(component_index)
        dc_table_indices.append(dc_table_index)
        ac_table_indices.append(ac_table_index)

    blocks_per_mcu = sum(
        frame.components[i].horizontal_sampling_factor
        * frame.components[i].vertical_sampling_factor
        for i in component_indices)
    if component_count > 1 and blocks_per_mcu > 10:
        raise FormatError("scan with more than one component and more than 10 blocks per MCU")

    spectral_selection_start = cursor.u8()
    spectral_selection_end = cursor.u8()
    byte = cursor.u8()
    successive_approximation_high = byte >> 4
    successive_approximation_low = byte & 0x0F

    predictor_selection = Predictor.NO_PREDICTION
    point_transform = successive_approximation_low
    if point_transform >= frame.precision:
        raise FormatError("invalid point transform, must be less than the frame precision")

    if frame.coding_process == CodingProcess.DCT_PROGRESSIVE:
        if (spectral_selection_end > 63
                or spectral_selection_start > spectral_selection_end
                or (spectral_selection_start == 0 and spectral_selection_end != 0)):
            raise FormatError(
                f"invalid spectral selection parameters: ss={spectral_selection_start}, "
                f"se={spectral_selection_end}")
        if spectral_selection_start != 0 and component_count != 1:
            raise FormatError(
                "spectral selection scan with AC coefficients can't have more than one component")
        if successive_approximation_high > 13 or successive_approximation_low > 13:
            raise FormatError(
                f"invalid successive approximation parameters: "
                f"ah={successive_approximation_high}, al={successive_approximation_low}")
        # G.1.1.1.2: each refinement improves precision by exactly one bit.
        if (successive_approximation_high != 0
                and successive_approximation_high != successive_approximation_low + 1):
            raise FormatError(
                "successive approximation scan with more than one bit of improvement")
    elif frame.coding_process == CodingProcess.LOSSLESS:
        if spectral_selection_end != 0:
            raise FormatError("spectral selection end shall be zero in lossless scan")
        if successive_approximation_high != 0:
            raise FormatError("successive approximation high shall be zero in lossless scan")
        if spectral_selection_start > 7:
            raise FormatError(
                f"invalid predictor selection value: {spectral_selection_start}")
        predictor_selection = Predictor(spectral_selection_start)
    else:
        if spectral_selection_end == 0:
            spectral_selection_end = 63
        if spectral_selection_start != 0 or spectral_selection_end != 63:
            raise FormatError("spectral selection is not allowed in non-progressive scan")
        if successive_approximation_high != 0 or successive_approximation_low != 0:
            raise FormatError("successive approximation is not allowed in non-progressive scan")

    return ScanInfo(
        component_indices=component_indices,
        dc_table_indices=dc_table_indices,
        ac_table_indices=ac_table_indices,
        spectral_selection_start=spectral_selection_start,
        spectral_selection_end=spectral_selection_end + 1,
        predictor_selection=predictor_selection,
        successive_approximation_high=successive_approximation_high,
        successive_approximation_low=successive_approximation_low,
        point_transform=point_transform,
    )


def parse_dqt(cursor: ByteCursor) -> list:
    """Section B.2.4.1 quantization tables (`src/parser.rs:485-532`).

    Returns a 4-slot list of Optional[np.uint16[64]] in zigzag order (the driver
    un-zigzags them, matching `src/decoder.rs:488-498`).
    """
    length = read_length(cursor, M.DQT)
    tables: list = [None, None, None, None]

    while length > 0:
        byte = cursor.u8()
        precision = byte >> 4
        index = byte & 0x0F

        if precision > 1:
            raise FormatError(f"invalid precision {precision} in DQT")
        if index > 3:
            raise FormatError(f"invalid destination identifier {index} in DQT")
        if length < 65 + 64 * precision:
            raise FormatError("invalid length in DQT")

        if precision == 0:
            table = np.frombuffer(cursor.take(64), dtype=np.uint8).astype(np.uint16)
        else:
            table = np.frombuffer(cursor.take(128), dtype=">u2").astype(np.uint16)

        if np.any(table == 0):
            raise FormatError("quantization table contains element with a zero value")

        tables[index] = table
        length -= 65 + 64 * precision

    return tables


def parse_dht(cursor: ByteCursor, is_baseline: Optional[bool]) -> tuple:
    """Section B.2.4.2 Huffman tables (`src/parser.rs:536-589`)."""
    length = read_length(cursor, M.DHT)
    dc_tables: list = [None, None, None, None]
    ac_tables: list = [None, None, None, None]

    while length > 17:
        byte = cursor.u8()
        class_ = byte >> 4
        index = byte & 0x0F

        if class_ not in (0, 1):
            raise FormatError(f"invalid class {class_} in DHT")
        if is_baseline is True and index > 1:
            raise FormatError("a maximum of two huffman tables per class are allowed in baseline")
        if index > 3:
            raise FormatError(f"invalid destination identifier {index} in DHT")

        counts = cursor.take(16)
        size = sum(counts)
        if size == 0:
            raise FormatError("encountered table with zero length in DHT")
        if size > 256:
            raise FormatError("encountered table with excessive length in DHT")
        if size > length - 17:
            raise FormatError("invalid length in DHT")

        values = cursor.take(size)
        table = HuffmanTable.build(list(counts), values, is_ac=(class_ == 1))
        if class_ == 0:
            dc_tables[index] = table
        else:
            ac_tables[index] = table

        length -= 17 + size

    if length != 0:
        raise FormatError("invalid length in DHT")

    return dc_tables, ac_tables


def parse_dri(cursor: ByteCursor) -> int:
    """Section B.2.4.4 restart interval (`src/parser.rs:592-600`)."""
    length = read_length(cursor, M.DRI)
    if length != 2:
        raise FormatError("DRI with invalid length")
    return cursor.u16_be()


def parse_com(cursor: ByteCursor) -> bytes:
    """Section B.2.4.5 comment (`src/parser.rs:603-610`)."""
    length = read_length(cursor, M.COM)
    return cursor.take(length)


def parse_app(cursor: ByteCursor, marker: int) -> Optional[tuple]:
    """Section B.2.4.6 application segments (`src/parser.rs:613-710`).

    Recognizes JFIF/AVI1 (APP0), EXIF/XMP (APP1), ICC (APP2), PSIR (APP13) and
    Adobe (APP14); anything else is skipped. Returns (kind, payload) or None.
    """
    length = read_length(cursor, marker)
    bytes_read = 0
    result: Optional[tuple] = None
    n = M.app_index(marker)

    if n == 0:
        if length >= 5:
            buf = cursor.take(5)
            bytes_read = 5
            if buf == b"JFIF\0":
                result = (APP_JFIF, None)
                # Extension over the reference: parse the version/density/
                # thumbnail fields when present (tolerantly — a short or
                # malformed tail still counts as JFIF-detected).
                if length - bytes_read >= 9:
                    hdr = cursor.take(9)
                    bytes_read += 9
                    tw, th = hdr[7], hdr[8]
                    thumb = b""
                    tn = 3 * tw * th
                    if tn and length - bytes_read >= tn:
                        thumb = cursor.take(tn)
                        bytes_read += tn
                    result = (APP_JFIF, JfifInfo(
                        version_major=hdr[0], version_minor=hdr[1],
                        density_unit=hdr[2],
                        x_density=(hdr[3] << 8) | hdr[4],
                        y_density=(hdr[5] << 8) | hdr[6],
                        thumbnail_width=tw, thumbnail_height=th,
                        thumbnail=thumb))
            elif buf == b"AVI1\0":
                result = (APP_AVI1, None)
    elif n == 1:
        buf = cursor.take(length)
        bytes_read = length
        if length >= 6 and buf[0:6] == b"Exif\x00\x00":
            result = (APP_EXIF, buf[6:])
        elif length >= 29 and buf[0:29] == b"http://ns.adobe.com/xap/1.0/\0":
            result = (APP_XMP, buf[29:])
    elif n == 2:
        if length > 14:
            buf = cursor.take(14)
            bytes_read = 14
            if buf[0:12] == b"ICC_PROFILE\0":
                data = cursor.take(length - bytes_read)
                bytes_read += len(data)
                result = (APP_ICC, IccChunk(seq_no=buf[12], num_markers=buf[13], data=data))
    elif n == 13:
        if length >= 14:
            buf = cursor.take(14)
            bytes_read = 14
            if buf == b"Photoshop 3.0\0":
                data = cursor.take(length - bytes_read)
                bytes_read += len(data)
                result = (APP_PSIR, data)
    elif n == 14:
        if length >= 12:
            buf = cursor.take(12)
            bytes_read = 12
            if buf[0:6] == b"Adobe\0":
                transform_byte = buf[11]
                if transform_byte > 2:
                    raise FormatError("invalid color transform in adobe app segment")
                result = (APP_ADOBE, AdobeColorTransform(transform_byte))

    cursor.skip(length - bytes_read)
    return result
