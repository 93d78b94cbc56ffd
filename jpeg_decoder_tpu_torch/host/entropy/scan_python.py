"""Copy of `jpeg_decoder_tpu/entropy/scan_python.py` at commit 0c2d0ea.

Pure-Python oracle entropy decoders (baseline, progressive, lossless).

Semantics-parity with the reference scan decoders:
- baseline/progressive MCU loop + restart handling: `src/decoder.rs:794-1082`
- `decode_block` (F.2.2): `src/decoder.rs:1086-1172`
- successive approximation + `refine_non_zeroes` (G.1.2):
  `src/decoder.rs:1174-1298`
- lossless difference scan: `src/decoder/lossless.rs:11-106`

Output is re-targeted for the TPU pipeline: instead of shipping MCU rows to
worker threads, coefficients land in full-image per-component stores
(`np.int16[block_h * block_w * 64]`, natural (unzigzagged) order) that feed the
batched dequant+IDCT kernels in `..ops` in one shot.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import markers as M
from ..errors import FormatError, JpegError
from ..parser import CodingProcess
from .bitreader import BitReader

# Zigzag index -> natural (row-major) index (`src/decoder.rs:27-36`).
UNZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
)


def _wrap16(v: int) -> int:
    """Two's-complement i16 wrap (Rust `Wrapping<i16>` / `as i16` semantics)."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def read_marker(cursor) -> int:
    """Tolerant marker scan (`src/decoder.rs:766-791`): skips
    extraneous bytes between segments and fill 0xFFs."""
    while True:
        while cursor.u8() != 0xFF:
            pass
        byte = cursor.u8()
        while byte == 0xFF:
            byte = cursor.u8()
        if byte != 0x00:
            return byte


def _finish_scan(reader: BitReader, cursor) -> Optional[int]:
    """End-of-scan marker recovery incl. trailing-RST skip
    (`src/decoder.rs:1063-1066`, `lossless.rs:179-182`)."""
    marker = reader.take_marker()
    while marker is not None and M.is_rst(marker):
        try:
            marker = read_marker(cursor)
        except JpegError:
            marker = None
    return marker


def _expect_restart(reader: BitReader, expected_rst_num: int) -> None:
    """Validate the next marker is RST(expected) (`src/decoder.rs:920-952`)."""
    marker = reader.take_marker()
    if marker is None:
        raise FormatError(f"no marker found where RST{expected_rst_num} was expected")
    if not M.is_rst(marker):
        raise FormatError(
            f"found marker {M.name(marker)} inside scan where RST{expected_rst_num} was expected")
    n = M.rst_index(marker)
    if n != expected_rst_num:
        raise FormatError(f"found RST{n} where RST{expected_rst_num} was expected")


class _Block:
    """A 64-coefficient destination: either a slice of a component store or a
    throwaway (the reference's `dummy_block`, `src/decoder.rs:865,984-986`)."""

    __slots__ = ("store", "offset")

    def __init__(self, store: Optional[np.ndarray], offset: int):
        self.store = store
        self.offset = offset

    def get(self, idx: int) -> int:
        if self.store is None:
            return 0
        return int(self.store[self.offset + idx])

    def set(self, idx: int, value: int) -> None:
        if self.store is not None:
            self.store[self.offset + idx] = _wrap16(value)


def _decode_block(reader: BitReader, block: _Block, dc_table, ac_table,
                  ss: int, se: int, al: int, state: dict) -> None:
    """F.2.2 sequential / first-pass progressive block decode
    (`src/decoder.rs:1086-1172`). `state` carries eob_run and
    the per-component dc predictor index under key 'dc'."""
    if ss == 0:
        value = reader.decode(dc_table)
        if value == 0:
            diff = 0
        elif value <= 11:
            diff = reader.receive_extend(value)
        else:
            raise FormatError("invalid DC difference magnitude category")

        # Wrapping add (`src/decoder.rs:1115-1118`).
        state["dc"] = _wrap16(state["dc"] + diff)
        block.set(0, state["dc"] << al)

    index = max(ss, 1)

    if index < se and state["eob_run"] > 0:
        state["eob_run"] -= 1
        return

    while index < se:
        fast = reader.decode_fast_ac(ac_table) if ac_table is not None else None
        if fast is not None:
            value, run = fast
            index += run
            if index >= se:
                break
            block.set(UNZIGZAG[index], value << al)
            index += 1
        else:
            byte = reader.decode(ac_table)
            r = byte >> 4
            s = byte & 0x0F

            if s == 0:
                if r == 15:
                    index += 16
                else:
                    eob_run = (1 << r) - 1
                    if r > 0:
                        eob_run += reader.get_bits(r)
                    state["eob_run"] = eob_run
                    break
            else:
                index += r
                if index >= se:
                    break
                block.set(UNZIGZAG[index], reader.receive_extend(s) << al)
                index += 1


def _refine_non_zeroes(reader: BitReader, block: _Block, start: int, end: int,
                       zrl: int, bit: int) -> int:
    """G.1.2.3 correction-bit pass (`src/decoder.rs:1260-1298`)."""
    last = end - 1
    zero_run_length = zrl

    for i in range(start, end):
        index = UNZIGZAG[i]
        coefficient = block.get(index)
        if coefficient == 0:
            if zero_run_length == 0:
                return i
            zero_run_length -= 1
        elif reader.get_bits(1) == 1 and coefficient & bit == 0:
            if coefficient > 0:
                new = coefficient + bit
            else:
                new = coefficient - bit
            if not (-32768 <= new <= 32767):
                raise FormatError("Coefficient overflow")
            block.set(index, new)

    return last


def _decode_block_successive_approximation(reader: BitReader, block: _Block, ac_table,
                                           ss: int, se: int, al: int, state: dict) -> None:
    """G.1.2 refinement-scan block decode (`src/decoder.rs:1174-1258`)."""
    bit = 1 << al

    if ss == 0:
        # G.1.2.1: DC refinement is a single correction bit.
        if reader.get_bits(1) == 1:
            block.set(0, block.get(0) | bit)
        return

    # G.1.2.3: AC refinement.
    if state["eob_run"] > 0:
        state["eob_run"] -= 1
        _refine_non_zeroes(reader, block, ss, se, 64, bit)
        return

    index = ss
    while index < se:
        byte = reader.decode(ac_table)
        r = byte >> 4
        s = byte & 0x0F

        zero_run_length = r
        value = 0
        if s == 0:
            if r == 15:
                pass  # 16-zero run: zrl=15 plus the zero `value` write below.
            else:
                eob_run = (1 << r) - 1
                if r > 0:
                    eob_run += reader.get_bits(r)
                state["eob_run"] = eob_run
                zero_run_length = 64
        elif s == 1:
            value = bit if reader.get_bits(1) == 1 else -bit
        else:
            raise FormatError("unexpected huffman code")

        index = _refine_non_zeroes(reader, block, index, se, zero_run_length, bit)
        if value != 0:
            block.set(UNZIGZAG[index], value)
        index += 1


def decode_scan_dct(cursor, frame, scan, dc_tables, ac_tables, restart_interval: int,
                    stores: list) -> Optional[int]:
    """Decode one baseline/progressive scan into full-image coefficient stores.

    `stores[i]` is the flat `np.int16[block_h*block_w*64]` store for scan
    component i (natural coefficient order), or None to discard that
    component's coefficients (the reference's dummy-block case).

    Returns the pending marker byte terminating the scan (or None), with
    `cursor` advanced past all consumed bytes. MCU geometry and the in-scan
    restart protocol mirror `src/decoder.rs:863-1066`.
    """
    components = [frame.components[i] for i in scan.component_indices]
    is_progressive = frame.coding_process == CodingProcess.DCT_PROGRESSIVE
    is_interleaved = len(components) > 1

    # 4.8.2: non-interleaved scans use 1-block MCUs over the component's own
    # block grid (`src/decoder.rs:883-908`).
    if is_interleaved:
        mcu_horizontal_samples = [c.horizontal_sampling_factor for c in components]
        mcu_vertical_samples = [c.vertical_sampling_factor for c in components]
        max_mcu_x = frame.mcu_size.width
        max_mcu_y = frame.mcu_size.height
    else:
        mcu_horizontal_samples = [1]
        mcu_vertical_samples = [1]
        max_mcu_x = components[0].block_size.width
        max_mcu_y = components[0].block_size.height

    reader = BitReader(cursor)
    # DC predictors are per component; eob_run is shared scan state (one
    # variable across components, `src/decoder.rs:867-870`).
    states = [{"dc": 0, "eob_run": 0} for _ in components]
    shared = {"eob_run": 0}
    mcus_left_until_restart = restart_interval
    expected_rst_num = 0

    ss = scan.spectral_selection_start
    se = scan.spectral_selection_end
    ah = scan.successive_approximation_high
    al = scan.successive_approximation_low

    dc_tbl = [dc_tables[scan.dc_table_indices[i]] for i in range(len(components))]
    ac_tbl = [ac_tables[scan.ac_table_indices[i]] for i in range(len(components))]
    block_widths = [c.block_size.width for c in components]

    image_w = frame.image_size.width
    image_h = frame.image_size.height
    streaming = getattr(cursor, "streaming", False)

    for mcu_y in range(max_mcu_y):
        if mcu_y * 8 >= image_h:
            break
        if streaming:
            # Bounded-memory contract: consumed entropy bytes are dropped at
            # every MCU row (the reference never buffers more than its
            # io::Read window, `src/lib.rs:56-66`).
            reader.compact()
        for mcu_x in range(max_mcu_x):
            if mcu_x * 8 >= image_w:
                break

            if restart_interval > 0:
                if mcus_left_until_restart == 0:
                    _expect_restart(reader, expected_rst_num)
                    reader.reset()
                    # F.2.1.3.1 / G.1.2.2: restart resets predictors + EOB run.
                    for st in states:
                        st["dc"] = 0
                    shared["eob_run"] = 0
                    expected_rst_num = (expected_rst_num + 1) % 8
                    mcus_left_until_restart = restart_interval
                mcus_left_until_restart -= 1

            for i, component in enumerate(components):
                vs = mcu_vertical_samples[i]
                hs = mcu_horizontal_samples[i]
                for v_pos in range(vs):
                    for h_pos in range(hs):
                        block_y = mcu_y * vs + v_pos
                        block_x = mcu_x * hs + h_pos
                        block = _Block(stores[i], (block_y * block_widths[i] + block_x) * 64)

                        st = states[i]
                        st["eob_run"] = shared["eob_run"]
                        if ah == 0:
                            _decode_block(reader, block, dc_tbl[i], ac_tbl[i], ss, se, al, st)
                        else:
                            _decode_block_successive_approximation(
                                reader, block, ac_tbl[i], ss, se, al, st)
                        shared["eob_run"] = st["eob_run"]

    return _finish_scan(reader, cursor)


def decode_scan_lossless(cursor, frame, scan, dc_tables, restart_interval: int):
    """Phase-1 lossless entropy decode: Huffman-coded differences
    (`src/decoder/lossless.rs:49-106`).

    Returns (pending_marker, diffs, leftover_mcus_until_restart) where `diffs`
    is `np.int32[ncomp, height, width]`. The leftover restart counter is needed
    to reproduce the reference's phase-2 restart flag exactly
    (`src/decoder/lossless.rs:168-171`, which reads the counter
    left over from phase 1).
    """
    ncomp = len(scan.component_indices)
    width = frame.image_size.width
    height = frame.image_size.height

    reader = BitReader(cursor)
    mcus_left_until_restart = restart_interval
    expected_rst_num = 0

    dc_tbl = [dc_tables[scan.dc_table_indices[i]] for i in range(ncomp)]
    diffs = np.zeros((ncomp, height, width), dtype=np.int32)
    streaming = getattr(cursor, "streaming", False)

    for y in range(height):
        if streaming:
            reader.compact()
        for x in range(width):
            if restart_interval > 0:
                if mcus_left_until_restart == 0:
                    _expect_restart(reader, expected_rst_num)
                    reader.reset()
                    expected_rst_num = (expected_rst_num + 1) % 8
                    mcus_left_until_restart = restart_interval
                mcus_left_until_restart -= 1

            for i in range(ncomp):
                value = reader.decode(dc_tbl[i])
                if value == 0:
                    diff = 0
                elif value <= 15:
                    diff = reader.receive_extend(value)
                elif value == 16:
                    diff = 32768
                else:
                    raise FormatError("invalid DC difference magnitude category")
                diffs[i, y, x] = diff

    marker = _finish_scan(reader, cursor)
    return marker, diffs, mcus_left_until_restart
