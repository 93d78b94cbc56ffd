"""Copy of `jpeg_decoder_tpu/decoder.py` at commit 0c2d0ea.

Decoder driver: the JPEG marker state machine and public API.

Capability parity with the reference `Decoder` (`src/decoder.rs`)
— same API surface (decode / read_info / info / scale / set_color_transform /
set_max_decoding_buffer_size / icc_profile / exif_data / xmp_data), same typed
errors, same output byte layouts — restructured for the TPU execution model:

- The reference interleaves entropy decode with per-MCU-row worker dispatch
  (`src/decoder.rs:1018-1060`). Here each scan's entropy stage
  fills a full-image coefficient store, and reconstruction (dequant + IDCT +
  upsample + color) runs as batched array ops over the whole component — the
  shape the TPU pipeline consumes directly.
- Worker selection heuristics (`src/decoder.rs:243-260`) have
  no output-visible effect and are replaced by the backend choice in
  `models/` (host numpy oracle vs jitted device pipeline).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from . import markers as M
from . import parser as P
from .entropy import decode_scan_dct, decode_scan_lossless
from .entropy.scan_python import read_marker as _read_marker
from .errors import FormatError, UnsupportedError, UnsupportedFeature
from .huffman import fill_default_mjpeg_tables
from .ops import upsample as U
from .ops.color import ColorTransform
from .ops.idct import choose_idct_size
from .ops.pipeline import geometry_from_frame, reconstruct_image
from .ops.predictors import reconstruct_lossless
from .parser import (AdobeColorTransform, ByteCursor, CodingProcess, Dimensions)
from .entropy.scan_python import UNZIGZAG

MAX_COMPONENTS = 4
_ALL_64 = (1 << 64) - 1


class PixelFormat(enum.Enum):
    """Output pixel formats (`src/decoder.rs:40-61`)."""

    L8 = "L8"
    L16 = "L16"
    RGB24 = "RGB24"
    CMYK32 = "CMYK32"

    def pixel_bytes(self) -> int:
        return {"L8": 1, "L16": 2, "RGB24": 3, "CMYK32": 4}[self.value]


@dataclasses.dataclass(frozen=True)
class ImageInfo:
    """Image metadata (`src/decoder.rs:63-74`)."""

    width: int
    height: int
    pixel_format: PixelFormat
    coding_process: CodingProcess


def _make_cursor(source, max_input_bytes=None,
                 streaming: bool = False) -> "P.ByteCursor":
    if isinstance(source, (bytes, bytearray, memoryview)):
        return P.ByteCursor(bytes(source), max_bytes=max_input_bytes)
    if hasattr(source, "read"):
        # Reader contract (reference analog: `Decoder<R: io::Read>`,
        # `src/lib.rs:56-66`): headers parse incrementally
        # from the reader; scan decode drains the remainder into memory
        # unless `streaming` keeps it windowed (see Decoder.__init__).
        return P.ByteCursor(b"", source=source, max_bytes=max_input_bytes,
                            streaming=streaming)
    if isinstance(source, str):
        # Paths load eagerly; pass an open file object to stream one
        # (the caller owns the handle's lifetime, like the reference's R).
        with open(source, "rb") as f:
            return P.ByteCursor(f.read(), max_bytes=max_input_bytes)
    raise TypeError(f"unsupported source type {type(source)}")


class Decoder:
    """JPEG decoder over an in-memory buffer, file object, or path.

    Mirrors the reference `Decoder<R>` construction and state
    (`src/decoder.rs:101-154`).
    """

    def __init__(self, source, backend: str = "numpy", precision: str = "exact",
                 max_input_bytes: Optional[int] = None,
                 streaming: bool = False):
        """`backend` selects the reconstruction engine: only "numpy" (the
        host oracle) in this copy; the JAX package's "jax" and "auto"
        backends raise here. The entropy stage always runs on the host.

        `precision`: "exact" reproduces the reference's scalar integer kernels
        bit-for-bit (its `platform_independent` contract); "fast" uses the
        fp32 MXU IDCT, within the reference reftest tolerance but not
        bit-identical (its default-SIMD contract,
        `src/arch/mod.rs:13-57`).

        `streaming=True` (file-like sources only) decodes scans straight off
        the reader with bounded buffering — the reference's `io::Read`
        contract (`src/lib.rs:56-66`) for inputs larger than
        memory (sockets, pipes). Selects the resumable oracle entropy engine
        (bit-identical output); the default drains the stream into memory,
        which is what buys the native/anchored segment parallelism."""
        if backend != "numpy":
            raise ValueError(f"unknown backend {backend!r}; the host copy "
                             "has only 'numpy'")
        if precision not in ("exact", "fast"):
            raise ValueError(f"unknown precision {precision!r}")
        if streaming and not hasattr(source, "read"):
            raise ValueError("streaming=True requires a file-like source")
        self._backend = backend
        self._precision = precision
        self._streaming = streaming
        self._cursor = _make_cursor(source, max_input_bytes, streaming)
        self.frame: Optional[P.FrameInfo] = None
        self._dc_huffman_tables: list = [None, None, None, None]
        self._ac_huffman_tables: list = [None, None, None, None]
        self._quantization_tables: list = [None, None, None, None]
        self._restart_interval = 0
        self._adobe_color_transform: Optional[AdobeColorTransform] = None
        self._color_transform: Optional[ColorTransform] = None
        self._is_jfif = False
        self._jfif: Optional[P.JfifInfo] = None
        self._is_mjpeg = False
        self._icc_markers: list = []
        self._exif_data: Optional[bytes] = None
        self._xmp_data: Optional[bytes] = None
        self._psir_data: Optional[bytes] = None
        self._coefficients: list = []  # progressive full-image stores, per component
        self._coefficients_finished = [0] * MAX_COMPONENTS
        self._decoding_buffer_size_limit: Optional[int] = None
        # Deferred render inputs per component: (coefficient store snapshot,
        # quantization table snapshot), captured at scan-completion time to
        # reproduce the reference's render-during-scan semantics
        # (`src/decoder.rs:847-861,1035-1048`).
        self._pending_render: dict = {}
        # Reconstructed u16 planes for lossless.
        self._planes_u16: list = []
        # Optional pooled allocator for coefficient stores (must return a
        # zeroed int16 array); used by the streaming service to avoid repeated
        # large-page allocation churn.
        self._store_allocator = None
        # Optional streaming capture: when set (and the frame is baseline),
        # the native entropy kernel emits the zigzag-prefix + COO-residual
        # interchange format directly and no dense stores are allocated.
        self._prefix_capture = None
        self._lossless_capture = None

    def _alloc_store(self, size: int) -> np.ndarray:
        if self._store_allocator is not None:
            return self._store_allocator(size)
        return np.zeros(size, dtype=np.int16)

    # -- configuration -------------------------------------------------------

    def set_color_transform(self, transform: ColorTransform) -> None:
        """Override the inferred color transform
        (`src/decoder.rs:156-160`)."""
        self._color_transform = transform

    def set_max_decoding_buffer_size(self, max_bytes: int) -> None:
        """DoS guard on output allocation (`src/decoder.rs:162-165`)."""
        self._decoding_buffer_size_limit = max_bytes

    # -- metadata ------------------------------------------------------------

    def info(self) -> Optional[ImageInfo]:
        """Image metadata; None until read_info()/decode() succeeded
        (`src/decoder.rs:167-194`)."""
        if self.frame is None:
            return None
        frame = self.frame
        n = len(frame.components)
        if n == 1:
            pixel_format = PixelFormat.L8 if 2 <= frame.precision <= 8 else PixelFormat.L16
        elif n == 3:
            pixel_format = PixelFormat.RGB24
        elif n == 4:
            pixel_format = PixelFormat.CMYK32
        else:
            raise AssertionError(n)
        return ImageInfo(
            width=frame.output_size.width,
            height=frame.output_size.height,
            pixel_format=pixel_format,
            coding_process=frame.coding_process,
        )

    def exif_data(self) -> Optional[bytes]:
        """Raw EXIF payload starting at the TIFF header
        (`src/decoder.rs:196-201`)."""
        return self._exif_data

    def xmp_data(self) -> Optional[bytes]:
        """Raw XMP packet (`src/decoder.rs:203-208`)."""
        return self._xmp_data

    def psir_data(self) -> Optional[bytes]:
        """Raw Photoshop PSIR payload (parsed like the reference, which stores
        but does not publicly expose it)."""
        return self._psir_data

    def jfif_info(self) -> Optional["P.JfifInfo"]:
        """Parsed JFIF APP0 version/density/thumbnail fields — an extension:
        the reference only detects the identifier
        (`src/parser.rs:618-632`)."""
        return self._jfif

    def icc_profile(self) -> Optional[bytes]:
        """Reassemble the multi-chunk APP2 ICC profile
        (`src/decoder.rs:210-241`): every chunk must agree on
        the count, seq_nos must be 1..=count and unique; otherwise None."""
        num_markers = len(self._icc_markers)
        if num_markers == 0 or num_markers >= 255:
            return None
        present: dict = {}
        for chunk in self._icc_markers:
            if chunk.num_markers != num_markers:
                return None
            if chunk.seq_no == 0:
                return None
            if chunk.seq_no in present:
                return None
            present[chunk.seq_no] = chunk
        data = bytearray()
        for seq in range(1, num_markers + 1):
            if seq not in present:
                return None
            data.extend(present[seq].data)
        return bytes(data)

    # -- decoding entry points -----------------------------------------------

    def read_info(self) -> None:
        """Parse metadata without decoding pixels
        (`src/decoder.rs:262-267`)."""
        self._decode_internal(stop_after_metadata=True)

    def scale(self, requested_width: int, requested_height: int):
        """Configure IDCT-domain downscaling (1/8, 1/4, 1/2, 1); returns the
        output (width, height) (`src/decoder.rs:269-290`)."""
        self.read_info()
        frame = self.frame
        idct_size = choose_idct_size(
            frame.image_size, Dimensions(requested_width, requested_height))
        frame.update_idct_size(idct_size)
        return frame.output_size.width, frame.output_size.height

    def decode(self) -> bytes:
        """Decode the image to interleaved pixel bytes
        (`src/decoder.rs:292-295`). Layouts match the
        reference: L8/RGB24/CMYK32 are u8 samples; L16 is native-endian u16."""
        return self._decode_internal(stop_after_metadata=False)

    def _decode_entropy_only(self) -> None:
        """Run parse + entropy stages, leaving per-component coefficient
        snapshots in `_pending_render` without touching a device. Used by the
        batch service to separate host work from the device pipeline."""
        self._decode_internal(stop_after_metadata=False, assemble=False)

    def decode_array(self) -> np.ndarray:
        """Convenience: decode to an [H, W] or [H, W, C] numpy array."""
        data = self.decode()
        info = self.info()
        h, w = info.height, info.width
        if info.pixel_format == PixelFormat.L8:
            return np.frombuffer(data, np.uint8).reshape(h, w)
        if info.pixel_format == PixelFormat.L16:
            return np.frombuffer(data, np.uint16).reshape(h, w)
        n = info.pixel_format.pixel_bytes()
        return np.frombuffer(data, np.uint8).reshape(h, w, n)

    # -- driver state machine ------------------------------------------------

    def _decode_internal(self, stop_after_metadata: bool, assemble: bool = True) -> bytes:
        """The marker state machine (`src/decoder.rs:297-615`)."""
        cursor = self._cursor

        if stop_after_metadata and self.frame is not None:
            return b""
        if self.frame is None:
            if cursor.u8() != 0xFF or cursor.u8() != M.SOI:
                raise FormatError("first two bytes are not an SOI marker")

        previous_marker = M.SOI
        pending_marker: Optional[int] = None
        scans_processed = 0
        if self.frame is not None:
            n = len(self.frame.components)
            self._pending_render = {}
            self._planes_u16 = [None] * n

        while True:
            marker = pending_marker if pending_marker is not None else _read_marker(cursor)
            pending_marker = None

            if M.is_sof(marker):
                # Section 4.10: multiple frames => hierarchical, unsupported.
                if self.frame is not None:
                    raise UnsupportedError(UnsupportedFeature.HIERARCHICAL)

                frame = P.parse_sof(cursor, marker)
                component_count = len(frame.components)

                if frame.is_differential:
                    raise UnsupportedError(UnsupportedFeature.HIERARCHICAL)
                if frame.entropy_coding_arithmetic:
                    raise UnsupportedError(UnsupportedFeature.ARITHMETIC_ENTROPY_CODING)
                if frame.precision != 8 and frame.coding_process != CodingProcess.LOSSLESS:
                    raise UnsupportedError(
                        UnsupportedFeature.SAMPLE_PRECISION, frame.precision)
                if not (2 <= frame.precision <= 16):
                    raise UnsupportedError(
                        UnsupportedFeature.SAMPLE_PRECISION, frame.precision)
                if component_count not in (1, 3, 4):
                    raise UnsupportedError(
                        UnsupportedFeature.COMPONENT_COUNT, component_count)

                # Validate subsampling support up front, like the reference's
                # throwaway Upsampler::new (`src/decoder.rs:374-379`).
                self._validate_upsampling(frame)

                self.frame = frame
                if stop_after_metadata:
                    return b""

                self._pending_render = {}
                self._planes_u16 = [None] * component_count

            elif marker == M.SOS:
                if self.frame is None:
                    raise FormatError("scan encountered before frame")
                pending_marker = self._process_scan()
                scans_processed += 1

            elif marker == M.DQT:
                tables = P.parse_dqt(cursor)
                for i, table in enumerate(tables):
                    if table is not None:
                        unzigzagged = np.zeros(64, dtype=np.uint16)
                        unzigzagged[list(UNZIGZAG)] = table
                        self._quantization_tables[i] = unzigzagged

            elif marker == M.DHT:
                is_baseline = self.frame.is_baseline if self.frame is not None else None
                dc_tables, ac_tables = P.parse_dht(cursor, is_baseline)
                for i in range(4):
                    if dc_tables[i] is not None:
                        self._dc_huffman_tables[i] = dc_tables[i]
                    if ac_tables[i] is not None:
                        self._ac_huffman_tables[i] = ac_tables[i]

            elif marker == M.DAC:
                raise UnsupportedError(UnsupportedFeature.ARITHMETIC_ENTROPY_CODING)

            elif marker == M.DRI:
                self._restart_interval = P.parse_dri(cursor)

            elif marker == M.COM:
                P.parse_com(cursor)

            elif M.is_app(marker):
                result = P.parse_app(cursor, marker)
                if result is not None:
                    kind, payload = result
                    if kind == P.APP_ADOBE:
                        self._adobe_color_transform = payload
                    elif kind == P.APP_JFIF:
                        self._is_jfif = True
                        if payload is not None:
                            self._jfif = payload
                    elif kind == P.APP_AVI1:
                        self._is_mjpeg = True
                    elif kind == P.APP_ICC:
                        self._icc_markers.append(payload)
                    elif kind == P.APP_EXIF:
                        self._exif_data = payload
                    elif kind == P.APP_XMP:
                        self._xmp_data = payload
                    elif kind == P.APP_PSIR:
                        self._psir_data = payload

            elif M.is_rst(marker):
                # Some encoders emit a trailing RST after entropy data; ignore it
                # right after a scan (`src/decoder.rs:561-569`).
                if previous_marker != M.SOS:
                    raise FormatError("RST found outside of entropy-coded data")

            elif marker == M.DNL:
                if previous_marker != M.SOS or scans_processed != 1:
                    raise FormatError("DNL is only allowed immediately after the first scan")
                raise UnsupportedError(UnsupportedFeature.DNL)

            elif marker in (M.DHP, M.EXP):
                raise UnsupportedError(UnsupportedFeature.HIERARCHICAL)

            elif marker == M.EOI:
                break

            else:
                raise FormatError(f"{M.name(marker)} marker found where not allowed")

            previous_marker = marker

        if self.frame is None:
            raise FormatError("end of image encountered before frame")

        return self._decode_planes(assemble)

    # -- scan processing -----------------------------------------------------

    def _validate_upsampling(self, frame: P.FrameInfo) -> None:
        h_max = max(c.horizontal_sampling_factor for c in frame.components)
        v_max = max(c.vertical_sampling_factor for c in frame.components)
        for c in frame.components:
            U.choose_upsampler(
                (c.horizontal_sampling_factor, c.vertical_sampling_factor),
                (h_max, v_max), frame.image_size.width, frame.image_size.height)

    def _process_scan(self) -> Optional[int]:
        """Handle one SOS (`src/decoder.rs:392-481,794-1082`)."""
        if not self._streaming:
            self._cursor.drain()
        frame = self.frame
        scan = P.parse_sos(self._cursor, frame)

        if (frame.coding_process == CodingProcess.DCT_PROGRESSIVE
                and not self._coefficients):
            self._coefficients = [
                self._alloc_store(c.block_size.width * c.block_size.height * 64)
                for c in frame.components
            ]

        if frame.coding_process == CodingProcess.LOSSLESS:
            return self._process_scan_lossless(frame, scan)
        return self._process_scan_dct(frame, scan)

    def _process_scan_dct(self, frame: P.FrameInfo, scan: P.ScanInfo) -> Optional[int]:
        is_progressive = frame.coding_process == CodingProcess.DCT_PROGRESSIVE

        # Track which components this scan completes
        # (`src/decoder.rs:426-455`).
        finished = [False] * MAX_COMPONENTS
        if scan.successive_approximation_low == 0:
            for pos, comp_i in enumerate(scan.component_indices):
                if self._coefficients_finished[comp_i] == _ALL_64:
                    continue
                for j in range(scan.spectral_selection_start, scan.spectral_selection_end):
                    self._coefficients_finished[comp_i] |= 1 << j
                if self._coefficients_finished[comp_i] == _ALL_64:
                    finished[pos] = True

        components = [frame.components[i] for i in scan.component_indices]

        # Required-table validation (`src/decoder.rs:809-845`).
        for component in components:
            if self._quantization_tables[component.quantization_table_index] is None:
                raise FormatError("use of unset quantization table")
        if self._is_mjpeg:
            fill_default_mjpeg_tables(scan, self._dc_huffman_tables, self._ac_huffman_tables)
        if scan.spectral_selection_start == 0 and any(
                self._dc_huffman_tables[i] is None for i in scan.dc_table_indices):
            raise FormatError("scan makes use of unset dc huffman table")
        if scan.spectral_selection_end > 1 and any(
                self._ac_huffman_tables[i] is None for i in scan.ac_table_indices):
            raise FormatError("scan makes use of unset ac huffman table")

        # Streaming fast path: baseline scans can emit the device interchange
        # format straight from the entropy kernel (see models/stream.py).
        if (self._prefix_capture is not None and not self._streaming
                and not is_progressive
                and self._prefix_capture.wants(frame)):
            return self._prefix_capture.decode_scan(self, frame, scan, finished)

        # Entropy destination stores.
        stores: list = []
        fresh_stores: dict = {}
        for pos, comp_i in enumerate(scan.component_indices):
            if is_progressive:
                stores.append(self._coefficients[comp_i])
            elif finished[pos]:
                c = frame.components[comp_i]
                store = self._alloc_store(c.block_size.width * c.block_size.height * 64)
                fresh_stores[pos] = store
                stores.append(store)
            else:
                # Reference dummy-block case (`src/decoder.rs:984-986`).
                stores.append(None)

        if self._streaming:
            # Windowed cursor: only the oracle engine can refill/compact
            # mid-scan (native kernels need the whole scan in memory).
            from .entropy.scan_python import decode_scan_dct as _oracle_dct
            marker = _oracle_dct(
                self._cursor, frame, scan,
                self._dc_huffman_tables, self._ac_huffman_tables,
                self._restart_interval, stores)
        else:
            marker = decode_scan_dct(
                self._cursor, frame, scan,
                self._dc_huffman_tables, self._ac_huffman_tables,
                self._restart_interval, stores)

        # Snapshot components completed by this scan (the reference IDCTs them
        # during the scan via workers; a deferred batched render over the
        # snapshot is equivalent — the copy freezes the coefficient state and
        # quantization table as of this scan).
        for pos, comp_i in enumerate(scan.component_indices):
            if finished[pos]:
                store = (self._coefficients[comp_i].copy() if is_progressive
                         else fresh_stores[pos])
                qt = self._quantization_tables[
                    frame.components[comp_i].quantization_table_index]
                self._pending_render[comp_i] = (store, qt.copy())

        return marker

    def _process_scan_lossless(self, frame: P.FrameInfo, scan: P.ScanInfo) -> Optional[int]:
        """Lossless scan (`src/decoder/lossless.rs:11-184`)."""
        if any(self._dc_huffman_tables[i] is None for i in scan.dc_table_indices):
            raise FormatError("scan makes use of unset dc huffman table")

        if self._streaming:
            from .entropy.scan_python import (
                decode_scan_lossless as _oracle_ll)
            marker, diffs, leftover = _oracle_ll(
                self._cursor, frame, scan, self._dc_huffman_tables,
                self._restart_interval)
        else:
            marker, diffs, leftover = decode_scan_lossless(
                self._cursor, frame, scan, self._dc_huffman_tables,
                self._restart_interval)

        # Reference quirk: phase 2 reads the stale phase-1 restart counter
        # (`src/decoder/lossless.rs:168-171`) — see predictors.py.
        restart_all = (self._restart_interval > 0
                       and leftover == self._restart_interval - 1)

        if (self._lossless_capture is not None
                and self._lossless_capture.wants(frame, scan)):
            # Streaming service hook: ship the Huffman-decoded differences
            # (the tiny lossless wire) and run the predictor reconstruction
            # on device (models/stream.py stage_host_lossless).
            return self._lossless_capture.capture_scan(
                self, frame, scan, diffs, restart_all, marker)

        for pos, comp_i in enumerate(scan.component_indices):
            self._planes_u16[comp_i] = self._reconstruct_lossless_plane(
                diffs[pos], scan.predictor_selection, scan.point_transform,
                frame.precision, restart_all)

        return marker

    def _reconstruct_lossless_plane(self, diffs, predictor, pt, precision,
                                    restart_all):
        """One component's predictor reconstruction: the host oracle here;
        the port's device `Decoder` (`jpeg_decoder_tpu_torch/decoder.py`)
        overrides it, where the reference branches on its backend."""
        return reconstruct_lossless(diffs, predictor, pt, precision,
                                    restart_all)

    # -- final assembly ------------------------------------------------------

    def _determine_color_transform(self) -> ColorTransform:
        """Transform inference chain (`src/decoder.rs:698-764`)."""
        if self._color_transform is not None:
            return self._color_transform
        frame = self.frame
        n = len(frame.components)
        if n == 1:
            return ColorTransform.GRAYSCALE
        if n == 3:
            ids = tuple(c.identifier for c in frame.components)
            if ids == (1, 2, 3):
                return ColorTransform.YCBCR
            if ids == (1, 34, 35):
                return ColorTransform.JCS_BG_YCC
            if ids == (82, 71, 66):
                return ColorTransform.RGB
            if ids == (114, 103, 98):
                return ColorTransform.JCS_BG_RGB
            if self._is_jfif:
                return ColorTransform.YCBCR
        if self._adobe_color_transform is not None:
            if self._adobe_color_transform == AdobeColorTransform.UNKNOWN:
                if n == 3:
                    return ColorTransform.RGB
                if n == 4:
                    return ColorTransform.CMYK
            elif self._adobe_color_transform == AdobeColorTransform.YCBCR:
                return ColorTransform.YCBCR
            else:
                return ColorTransform.YCCK
        elif n == 4:
            return ColorTransform.CMYK
        if n == 4:
            return ColorTransform.YCCK
        if n == 3:
            return ColorTransform.YCBCR
        return ColorTransform.UNKNOWN

    def _decode_planes(self, assemble: bool = True) -> bytes:
        """End-of-image assembly (`src/decoder.rs:617-696`)."""
        frame = self.frame
        output_size = frame.output_size

        # Output-size DoS guard — reference compares component*W*H sample count
        # (`src/decoder.rs:631-641`).
        total = len(frame.components) * output_size.width * output_size.height
        if self._decoding_buffer_size_limit is not None and \
                self._decoding_buffer_size_limit < total:
            raise FormatError("size of decoded image exceeds maximum allowed size")

        # Progressive: render whatever exists for unfinished components
        # (`src/decoder.rs:643-684`).
        if (frame.coding_process == CodingProcess.DCT_PROGRESSIVE
                and len(self._coefficients) == len(frame.components)):
            for i, component in enumerate(frame.components):
                if self._coefficients_finished[i] == _ALL_64:
                    continue
                qt = self._quantization_tables[component.quantization_table_index]
                if qt is None:
                    continue
                self._pending_render[i] = (self._coefficients[i], qt)

        if not assemble:
            return b""
        if frame.coding_process == CodingProcess.LOSSLESS:
            return self._compute_image_lossless()
        return self._compute_image()

    def _compute_image(self) -> bytes:
        """DCT-mode image assembly (`src/decoder.rs:1300-1336`)
        via the fused reconstruction pipeline (`ops/pipeline.py`)."""
        frame = self.frame
        n = len(frame.components)
        if any(i not in self._pending_render for i in range(n)):
            raise FormatError("not all components have data")

        # Single component: no color pipeline, just de-stride + crop
        # (`src/decoder.rs:1308-1332`).
        transform = None if n == 1 else self._determine_color_transform()

        geometry = geometry_from_frame(frame, transform, precision=self._precision)
        stores = [self._pending_render[i][0].reshape(-1, 64) for i in range(n)]
        qts = [self._pending_render[i][1] for i in range(n)]
        image = self._reconstruct_image(geometry, stores, qts)
        return np.ascontiguousarray(image).tobytes()

    def _reconstruct_image(self, geometry, stores, qts) -> np.ndarray:
        """Dequant + IDCT + upsample + color of the whole image: the host
        oracle here; the port's device `Decoder` overrides it, where the
        reference picks `reconstruct_image`'s backend."""
        return reconstruct_image(geometry, stores, qts)

    def _compute_image_lossless(self) -> bytes:
        """Lossless assembly (`src/decoder/lossless.rs:228-260`):
        interleave, then u8 narrow (P==8) or native-endian u16 bytes."""
        frame = self.frame
        if any(p is None for p in self._planes_u16) or not self._planes_u16:
            raise FormatError("not all components have data")

        planes = self._planes_u16
        if len(planes) == 1:
            interleaved = planes[0]
        else:
            # Multi-component interleave sized by output_size (a row-major
            # prefix if scaling shrank output_size; lossless has no IDCT so
            # this mirrors the reference's element-count-bound loop,
            # `src/decoder/lossless.rs:240-246`).
            count = frame.output_size.width * frame.output_size.height
            flats = [p.reshape(-1)[:count] for p in planes]
            interleaved = np.stack(flats, axis=-1)

        if frame.precision == 8:
            return interleaved.astype(np.uint8).tobytes()
        return interleaved.astype(np.uint16).tobytes()  # native endian, like the reference
